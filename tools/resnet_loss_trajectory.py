#!/usr/bin/env python3
"""A zoo net's training-loss trajectory on one fixed batch, through
``optimize_for("tpu_fused_conv_bn")`` and the Gluon loop, in either
package, from the same numpy-made weights.

This is ``chip_smoke.py``'s train schedule for ResNet-50 v1
(``resnet_train_phase``: batch 128 at 224 x 224 from
``numpy.random.RandomState(0)``, labels in [0, 10), SGD lr 0.005 momentum
0.9 wd 1e-4, fp32) or, with ``--model mobilenetv2_1.0 --wd 4e-5``, for
MobileNetV2 1.0, run step by step, so a trajectory of the JAX package (the
reference) can be set beside the port's:

    # the reference: draws Xavier weights from numpy's global generator
    # (seed 0), saves them, prints one loss per step
    JAX_PLATFORMS=cpu python tools/resnet_loss_trajectory.py --side jax \\
        --weights /tmp/r50_w.npz --steps 12
    # the port, on the CPU (or --device cuda) from the saved weights,
    # carried in with gluon.utils.load_numpy
    python tools/resnet_loss_trajectory.py --side torch \\
        --weights /tmp/r50_w.npz --steps 12

Each side imports only its own package. ``--model`` names any net of the
zoo's registry (1000 classes); ``--batch`` and ``--size`` cut the problem
for a quick run; the losses printed are the mean softmax cross-entropy of
each step's forward, before that step's update. The last line is one JSON
object with the losses, the peak resident memory and the seconds taken.
"""

import argparse
import json
import os
import resource
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SGD = {"learning_rate": 0.005, "momentum": 0.9, "wd": 1e-4}


def batch(n, size):
    """chip_smoke.py's fixed batch: images, then labels, from seed 0."""
    rs = np.random.RandomState(0)
    x = rs.rand(n, 3, size, size).astype(np.float32)
    y = rs.randint(0, 10, (n,)).astype(np.float32)
    return x, y


def run(mx, net, x, y, steps, ctx_kw, lr, wd):
    """``steps`` Gluon-loop steps through optimize_for at learning rate
    ``lr`` and weight decay ``wd``; the mean loss of each step's
    forward."""
    call = net.optimize_for(backend="tpu_fused_conv_bn")
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               dict(SGD, learning_rate=lr, wd=wd))
    sce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    xs, ys = mx.nd.array(x, **ctx_kw), mx.nd.array(y, **ctx_kw)
    losses = []
    for i in range(steps):
        t0 = time.perf_counter()
        with mx.autograd.record():
            loss = sce(call(xs), ys)
        loss.backward()
        trainer.step(x.shape[0])
        losses.append(float(np.array(loss.asnumpy()).mean()))
        print(f"step {i} loss {losses[-1]:.6f} "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    return losses


def side_jax(args, x, y):
    sys.path.insert(0, ROOT)
    import mxnet_tpu as mx
    from mxnet_tpu.gluon.model_zoo import vision

    np.random.seed(0)  # the JAX package's initializers draw from numpy
    net = vision.get_model(args.model, classes=1000)
    net.initialize(init=mx.initializer.Xavier())
    net(mx.nd.array(x[:2]))
    weights = {k: np.array(p.data().asnumpy())
               for k, p in net.collect_params().items()}
    np.savez(args.weights, **weights)
    if args.hybridize:
        net.hybridize()
    return run(mx, net, x, y, args.steps, {}, args.lr, args.wd)


def side_torch(args, x, y):
    sys.path.insert(0, ROOT)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.gluon.utils import load_numpy

    ctx = mx.cpu() if args.device == "cpu" else mx.gpu(0)
    if args.device == "cuda":
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    net = vision.get_model(args.model, classes=1000)
    net.initialize(ctx=ctx)
    net(mx.nd.array(x[:2], ctx=ctx))
    with np.load(args.weights) as f:
        load_numpy(net.collect_params(), {k: f[k] for k in f.files})
    return run(mx, net, x, y, args.steps, {"ctx": ctx}, args.lr, args.wd)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--side", choices=("jax", "torch"), required=True)
    p.add_argument("--weights", required=True,
                   help="npz written by --side jax, read by --side torch")
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--lr", type=float, default=SGD["learning_rate"],
                   help="SGD learning rate (momentum stays 0.9)")
    p.add_argument("--wd", type=float, default=SGD["wd"],
                   help="SGD weight decay")
    p.add_argument("--model", default="resnet50_v1",
                   help="a name of the zoo's registry")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--hybridize", action="store_true",
                   help="the reference as one compiled graph per pass "
                   "(--side jax): the same function in far less host "
                   "memory than its eager path")
    p.add_argument("--device", choices=("cpu", "cuda"), default="cpu",
                   help="the port's device (--side torch)")
    args = p.parse_args()
    x, y = batch(args.batch, args.size)
    t0 = time.perf_counter()
    losses = (side_jax if args.side == "jax" else side_torch)(args, x, y)
    print(json.dumps({
        "side": args.side, "model": args.model,
        "device": args.device if args.side == "torch" else "cpu",
        "lr": args.lr, "wd": args.wd, "batch": args.batch, "size": args.size,
        "losses": losses, "seconds": round(time.perf_counter() - t0, 1),
        "peak_rss_gb": round(resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 2 ** 20, 2)}))


if __name__ == "__main__":
    main()
