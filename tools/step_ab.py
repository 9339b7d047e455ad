#!/usr/bin/env python3
"""Time ResNet-50's and Transformer-base's training steps, eager and
hybridized, with the ``chip_smoke.py`` phases of the tree at ``--root``
(this checkout by default), on one CUDA card.

    python tools/step_ab.py [--root DIR] [--steps 10] [--plain-relu]

To compare two trees, unpack one beside the other and run both on the
same card one after the other, in the order A, B, B, A. Each run prints
the phases' own lines: ``[resnet-train]`` and ``[resnet-step-split]``,
``[resnet-train-hybrid]``, ``[transformer-train]`` and
``[transformer-train-step-split]``, ``[transformer-train-hybrid]``
(host-clock step ms, profiled busy ms, idle share, device time by kind of
kernel). ``--plain-relu`` runs relu's backward as ``torch.relu``'s (0 at
a tie, not the JAX package's 1/2) to tell that rule's cost from the rest
of a difference; the numbers it gives are not the port's.
"""

import argparse
import gc
import os
import sys
import time

import torch


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=here,
                    help="checkout whose chip_smoke.py and package to run")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--plain-relu", action="store_true",
                    help="relu's backward as torch.relu's (0 at a tie)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("step_ab: no CUDA device visible")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import _kernels

    for mod in (cs, mx):
        where = os.path.abspath(mod.__file__)
        if not where.startswith(root + os.sep):
            raise SystemExit(f"step_ab: {mod.__name__} from {where}, not "
                             f"from {root}")
    if args.plain_relu:
        from mxnet_tpu_torch.ops import nn as ops_nn

        if not hasattr(ops_nn, "clip"):
            raise SystemExit("step_ab: --plain-relu needs relu as a clip")
        ops_nn.clip = lambda data, a_min, a_max: torch.relu(data)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _kernels.build_all()
    cs.say("step-ab", root=root, plain_relu=args.plain_relu,
           build_s=f"{time.perf_counter() - t0:.1f}")
    ctx = mx.gpu(0)
    net, fused, x, y, marked, _ = cs.resnet_setup(ctx)
    cs.resnet_train_phase(net, fused, x, y, marked, _kernels.LAUNCHES,
                          steps=args.steps)
    del net, fused, x, y, marked
    gc.collect()
    torch.cuda.empty_cache()
    cs.resnet_train_hybrid_phase(ctx, _kernels.LAUNCHES, steps=args.steps)
    gc.collect()
    torch.cuda.empty_cache()
    for hybrid in (False, True):
        cs.transformer_train_phase(ctx, _kernels.LAUNCHES, steps=args.steps,
                                   hybrid=hybrid)
        gc.collect()
        torch.cuda.empty_cache()
    cs.say("step-ab", done_s=f"{time.perf_counter() - t0:.1f}")


if __name__ == "__main__":
    main()
