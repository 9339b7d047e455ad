"""Port parity: a small ResNet-50-style net (``ResNetV1`` with
``BottleneckV1``, one block per stage, channels 16/32/64/128/256, 10
classes) trained on the CPU through the Gluon loop, with and without
``optimize_for("tpu_fused_conv_bn")``, against the JAX package.

The JAX net is built once per module (its eager CPU path compiles every
operator shape, ~40 s in all); the port's net takes its weights by name
through ``gluon.utils.load_numpy``. Batch 4 at 64 x 64 keeps the last
stage at 2 x 2, so every BatchNorm sees at least 16 values and its batch
variance stays well above eps.

Tolerances (float32; the sides sum in other orders and every BatchNorm
divides by a batch standard deviation, so rounding grows through the five
stages):
- outputs and losses: 1e-4 relative to the largest |value|;
- each gradient: 1e-3 of the largest |grad| of its layer (the weight and
  bias of one block): a conv bias followed by a training-mode BatchNorm
  has a zero gradient in exact arithmetic, so on both sides it is float
  noise, judged against its layer's weight gradient and not against
  itself;
- running statistics and weights after two SGD steps: 1e-4 relative to
  the largest |value| of each parameter (of its layer for a conv bias
  before a BatchNorm, noise as above). The steps use lr 0.005: at
  bench_resnet's lr 0.05 a step on this batch of 4 is chaotic, and even
  two float64 runs whose weights differ by 1e-6 end with gradients far
  apart, so no tolerance could tell a fault from rounding.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import re

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon.utils import load_numpy

OUT_TOL = 1e-4
GRAD_TOL = 1e-3
PARAM_TOL = 1e-4
PREFIX = "resnetv10_"
SGD = {"learning_rate": 0.005, "momentum": 0.9, "wd": 1e-4}
RS = np.random.RandomState(0)
X = RS.rand(4, 3, 64, 64).astype(np.float32)
LABELS = RS.randint(0, 10, (4,)).astype(np.float32)


def _net(mxmod):
    from_zoo = mxmod.gluon.model_zoo.vision.resnet
    return from_zoo.ResNetV1(from_zoo.BottleneckV1, [1, 1, 1, 1],
                             [16, 32, 64, 128, 256], classes=10,
                             prefix=PREFIX)


def _np(a):
    """A host copy (the JAX package's CPU ``asnumpy`` may alias a buffer
    that a later fused update donates and overwrites)."""
    return np.array(a.asnumpy())


def _step(mxmod, call, net, ctx_kw):
    """One recorded forward + backward: the output, the per-sample loss
    and every trainable parameter's gradient."""
    sce = mxmod.gluon.loss.SoftmaxCrossEntropyLoss()
    with mxmod.autograd.record():
        out = call(mxmod.nd.array(X, **ctx_kw))
        loss = sce(out, mxmod.nd.array(LABELS, **ctx_kw))
    loss.backward()
    grads = {k: _np(p.grad()) for k, p in net.collect_params().items()
             if p.grad_req != "null"}
    return _np(out), _np(loss), grads


def _values(net):
    return {k: _np(p.data()) for k, p in net.collect_params().items()}


def _train(mxmod, call, net, ctx_kw):
    """Two SGD-momentum steps: the first step's forward/backward, an
    update, the second step's forward/backward, an update. Returns the
    first step, the second step's loss, the parameters after both updates
    (running statistics included) and the eval-mode output with them."""
    first = _step(mxmod, call, net, ctx_kw)
    trainer = mxmod.gluon.Trainer(net.collect_params(), "sgd", dict(SGD))
    trainer.step(len(X))
    second_loss = _step(mxmod, call, net, ctx_kw)[1]
    trainer.step(len(X))
    eval_out = _np(call(mxmod.nd.array(X, **ctx_kw)))
    return first, second_loss, _values(net), eval_out


@pytest.fixture(scope="module")
def jax_runs():
    # the JAX package's initializers draw from numpy's global generator
    np.random.seed(0)
    init = _net(jmx)
    init.initialize(init=jmx.initializer.Xavier())
    init(jmx.nd.array(X))
    weights = _values(init)
    runs = {"names": list(init.collect_params().keys()),
            "weights": weights}
    for fused in (False, True):
        net = _net(jmx)
        net.initialize()
        net(jmx.nd.array(X))
        for k, p in net.collect_params().items():
            p.set_data(jmx.nd.array(weights[k]))
        call = net.optimize_for(backend="tpu_fused_conv_bn") if fused \
            else net
        runs[fused] = _train(jmx, call, net, {})
    return runs


def _port_net(weights, fused):
    net = _net(mx)
    net.initialize(ctx=mx.cpu())
    net(mx.nd.array(X[:1], ctx=mx.cpu()))
    load_numpy(net.collect_params(), weights)
    return net, (net.optimize_for(backend="tpu_fused_conv_bn") if fused
                 else net)


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _check_grads(got, want):
    assert sorted(got) == sorted(want)
    layer_max = {}
    for k, g in want.items():
        layer = k.rsplit("_", 1)[0]
        layer_max[layer] = max(layer_max.get(layer, 0.0), np.abs(g).max())
    for k in want:
        err = np.abs(got[k] - want[k]).max()
        assert err <= GRAD_TOL * layer_max[k.rsplit("_", 1)[0]], (k, err)


def _fused_convs(net):
    found = []

    def walk(b):
        if getattr(b, "_tpu_fused", False):
            found.append(b)
        for c in b._children.values():
            walk(c)

    walk(net)
    return found


def test_param_names_equal_jax(jax_runs):
    net = _net(mx)
    assert list(net.collect_params().keys()) == jax_runs["names"]
    assert jax_runs["names"][0] == "resnetv10_conv2d0_weight"


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_train_step_matches_jax(jax_runs, fused):
    """Forward (training mode), loss and every gradient of one step."""
    net, call = _port_net(jax_runs["weights"], fused)
    if fused:
        assert len(_fused_convs(net)) == 6
    out, loss, grads = _step(mx, call, net, {"ctx": mx.cpu()})
    jout, jloss, jgrads = jax_runs[fused][0]
    assert _rel(out, jout) <= OUT_TOL
    assert _rel(loss, jloss) <= OUT_TOL
    _check_grads(grads, jgrads)


def test_fused_conv_biases_get_no_gradient(jax_runs):
    """The six fused convs' biases are off the graph (a training-mode
    BatchNorm cancels them): their buffers stay as they were, zero after
    initialisation on both sides; every other gradient is nonzero."""
    net, call = _port_net(jax_runs["weights"], True)
    biases = {c.bias.name for c in _fused_convs(net) if c.bias is not None}
    assert len(biases) == 5  # the stage-1 downsample conv has no bias
    _, _, grads = _step(mx, call, net, {"ctx": mx.cpu()})
    _, _, jgrads = jax_runs[True][0]
    for k in grads:
        if k in biases:
            assert not grads[k].any() and not jgrads[k].any(), k
        else:
            assert np.abs(grads[k]).max() > 0, k


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_sgd_steps_match_jax(jax_runs, fused):
    """Two SGD-momentum steps: the second step's loss, every parameter
    and running statistic after them, and the eval-mode output that uses
    them. The un-fused net's conv biases before a BatchNorm are float
    noise on both sides, judged against their layer's weight."""
    net, call = _port_net(jax_runs["weights"], fused)
    first, loss, values, eval_out = _train(mx, call, net, {"ctx": mx.cpu()})
    jfirst, jloss, jvalues, jeval = jax_runs[fused]
    assert _rel(loss, jloss) <= OUT_TOL
    assert loss.mean() < first[1].mean()  # the loss falls
    layer_max = {}
    for k, v in jvalues.items():
        layer = k.rsplit("_", 1)[0]
        layer_max[layer] = max(layer_max.get(layer, 0.0), np.abs(v).max())
    for k in jvalues:
        err = np.abs(values[k] - jvalues[k]).max()
        scale = layer_max[k.rsplit("_", 1)[0]] if k.endswith("_bias") \
            else np.abs(jvalues[k]).max()
        assert err <= PARAM_TOL * scale, (k, err)
    assert _rel(eval_out, jeval) <= OUT_TOL


def test_fused_matches_plain_in_port(jax_runs):
    """Within the port, the fused pass computes the un-fused net's
    function: outputs, loss and the gradients of every weight (the fused
    convs' biases excepted, which only the un-fused net differentiates,
    as float noise)."""
    steps = []
    for fused in (False, True):
        net, call = _port_net(jax_runs["weights"], fused)
        steps.append(_step(mx, call, net, {"ctx": mx.cpu()}))
        if fused:
            skip = {c.bias.name for c in _fused_convs(net)
                    if c.bias is not None}
    (pout, ploss, pgrads), (fout, floss, fgrads) = steps
    assert _rel(fout, pout) <= OUT_TOL and _rel(floss, ploss) <= OUT_TOL
    _check_grads({k: v for k, v in fgrads.items() if k not in skip},
                 {k: v for k, v in pgrads.items() if k not in skip})


def test_resnet50_fused_marks_thirty_convs():
    """ResNet-50 v1: every stride-1 1x1 conv without a fused activation
    is marked (30), and the bias quirk of BottleneckV1 is kept."""
    net = mx.gluon.model_zoo.vision.get_model("resnet50_v1")
    net.optimize_for(backend="tpu_fused_conv_bn")
    marked = _fused_convs(net)
    assert len(marked) == 30
    # only the stage-1 downsample conv (use_bias=False) lacks a bias
    assert sum(c.bias is not None for c in marked) == 29
    names = list(net.collect_params().keys())
    assert re.match(r"resnetv1\d+_conv2d0_weight", names[0])
    # stem conv + BN (5), 16 bottlenecks of 3 convs (2 with a bias) and 3
    # BNs (17 each), 4 downsample conv + BN pairs (5 each), Dense (2)
    assert len(names) == len(set(names)) == 5 + 16 * 17 + 4 * 5 + 2
