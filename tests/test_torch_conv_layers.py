"""Port parity: convolution, pooling, BatchNorm and Flatten layers of
``mxnet_tpu_torch`` and the ``optimize_for("tpu_fused_conv_bn")`` pass,
against the JAX package.

Each layer is built on both sides, the JAX layer's weights are carried
into the port's by name (``gluon.utils.load_numpy``), and the same numpy
input goes through both under ``autograd.record()`` (training mode); the
backward of the output takes the same random head gradient on both sides
(with ones, BatchNorm's input and gamma gradients would be zero in exact
arithmetic and only float noise would be compared). Outputs and
the gradients of the input and every parameter agree within 1e-5
absolute and relative for convolution, pooling and Flatten (float32; the
sides differ in summation order over at most a few hundred terms) and
within 1e-4 for BatchNorm and the fused pass, whose batch moments divide
by a variance estimated from 50 to 200 values.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import collections
import re

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.utils import load_numpy

TOL = 1e-5
BN_TOL = 1e-4


def _strip(name):
    """A parameter name without its block counters (the two packages'
    global counters run apart across tests)."""
    return re.sub(r"\d+_", "_", name)


def _carry(jblock, tblock):
    """Copy the JAX block's weights (running statistics included) into
    the port's, in order; names must match with counters removed."""
    jp, tp = jblock.collect_params(), tblock.collect_params()
    assert [_strip(k) for k in tp.keys()] == [_strip(k) for k in jp.keys()]
    load_numpy(tp, {k: p.data().asnumpy()
                    for k, p in zip(tp.keys(), jp.values())})


def _run(mxmod, block, x, ctx_kw, call=None):
    """Forward under record(), backward with a seeded random head
    gradient; returns the output, the input gradient, the parameter
    gradients and every parameter's value after the step (running
    statistics included)."""
    xa = mxmod.nd.array(x, **ctx_kw)
    xa.attach_grad()
    with mxmod.autograd.record():
        y = (call or block)(xa)
    head = np.random.RandomState(5).randn(*y.shape).astype(np.float32)
    y.backward(mxmod.nd.array(head, **ctx_kw))
    params = block.collect_params()
    grads = {k.replace(block.prefix, "", 1): p.grad().asnumpy()
             for k, p in params.items() if p.grad_req != "null"}
    values = {k.replace(block.prefix, "", 1): p.data().asnumpy()
              for k, p in params.items()}
    return y.asnumpy(), xa.grad.asnumpy(), grads, values


def _both(factory, x, tol, fused=False):
    """Build, carry, run on both sides; compare everything."""
    jblock, tblock = factory(jmx.gluon.nn), factory(mx.gluon.nn)
    jblock.initialize()
    tblock.initialize(ctx=mx.cpu())
    jblock(jmx.nd.array(x))  # resolve deferred shapes
    tblock(mx.nd.array(x, ctx=mx.cpu()))
    _carry(jblock, tblock)
    jcall = jblock.optimize_for(backend="tpu_fused_conv_bn") \
        if fused else None
    tcall = tblock.optimize_for(backend="tpu_fused_conv_bn") \
        if fused else None
    jy, jgx, jg, jv = _run(jmx, jblock, x, {}, jcall)
    ty, tgx, tg, tv = _run(mx, tblock, x, {"ctx": mx.cpu()}, tcall)
    np.testing.assert_allclose(ty, jy, rtol=tol, atol=tol)
    np.testing.assert_allclose(tgx, jgx, rtol=tol, atol=tol)
    assert sorted(tg) == sorted(jg) and sorted(tv) == sorted(jv)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=tol, atol=tol,
                                   err_msg=k)
    for k in jv:
        np.testing.assert_allclose(tv[k], jv[k], rtol=tol, atol=tol,
                                   err_msg=k)
    return jblock, tblock, (jcall, tcall)


RS = np.random.RandomState(0)
NCHW = RS.randn(2, 4, 9, 9).astype(np.float32)
NHWC = RS.randn(2, 9, 9, 4).astype(np.float32)

CONVS = {
    "nchw_3x3_s2_p1": (lambda nn: nn.Conv2D(8, 3, strides=2, padding=1),
                       NCHW),
    "nchw_1x1_bias": (lambda nn: nn.Conv2D(6, 1), NCHW),
    "nchw_dilated_groups": (
        lambda nn: nn.Conv2D(8, 3, padding=2, dilation=2, groups=2), NCHW),
    "nchw_relu_no_bias": (
        lambda nn: nn.Conv2D(5, (3, 2), activation="relu", use_bias=False),
        NCHW),
    "nhwc_3x3_p1": (lambda nn: nn.Conv2D(8, 3, padding=1, layout="NHWC"),
                    NHWC),
    "nhwc_7x7_s2_p3": (
        lambda nn: nn.Conv2D(8, 7, 2, 3, use_bias=False, layout="NHWC"),
        NHWC),
}


@pytest.mark.parametrize("name", list(CONVS))
def test_conv2d_matches_jax(name):
    factory, x = CONVS[name]
    _both(factory, x, TOL)


POOLS = {
    "max_3_s2_p1": lambda nn: nn.MaxPool2D(3, 2, 1),
    "max_2_ceil": lambda nn: nn.MaxPool2D(2, ceil_mode=True),
    "avg_3_s2_p1": lambda nn: nn.AvgPool2D(3, 2, 1),
    "avg_3_s2_p1_exclude_pad": lambda nn: nn.AvgPool2D(
        3, 2, 1, count_include_pad=False),
    "avg_2_ceil": lambda nn: nn.AvgPool2D(2, ceil_mode=True),
    "avg_3_ceil_exclude_pad": lambda nn: nn.AvgPool2D(
        3, 2, 1, ceil_mode=True, count_include_pad=False),
    "global_avg": lambda nn: nn.GlobalAvgPool2D(),
    "global_max": lambda nn: nn.GlobalMaxPool2D(),
}


@pytest.mark.parametrize("name", list(POOLS))
def test_pooling_layer_matches_jax(name):
    # 10 x 10 so ceil mode adds a partial window at stride 2 and 3
    x = RS.randn(2, 3, 10, 10).astype(np.float32)
    _both(POOLS[name], x, TOL)


OP_POOLS = {
    "sum_full": dict(kernel=(3, 3), stride=(2, 2), pool_type="sum",
                     pooling_convention="full"),
    "lp_2": dict(kernel=(2, 2), stride=(2, 2), pool_type="lp", p_value=2),
    "max_nhwc_p1": dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                        pool_type="max", layout="NHWC"),
    "avg_nhwc_full_exclude": dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                                  pool_type="avg", layout="NHWC",
                                  pooling_convention="full",
                                  count_include_pad=False),
    "global_avg_nhwc": dict(kernel=(1, 1), global_pool=True,
                            pool_type="avg", layout="NHWC"),
    "max_1d": dict(kernel=(3,), stride=(2,), pad=(1,), pool_type="max"),
    "avg_3d_full": dict(kernel=(2, 2, 2), stride=(2, 2, 2),
                        pool_type="avg", pooling_convention="full"),
}


@pytest.mark.parametrize("name", list(OP_POOLS))
def test_pooling_op_matches_jax(name):
    """Every pool type and layout through ``nd.Pooling`` directly, with
    the input's gradient."""
    kw = OP_POOLS[name]
    nd = len(kw["kernel"])
    x = (RS.rand(2, 3, *([7] * nd)) + 0.1).astype(np.float32)
    if kw.get("layout") == "NHWC":
        x = np.ascontiguousarray(np.moveaxis(x, 1, -1))
    out = []
    for mxmod, ctx in ((jmx, {}), (mx, {"ctx": mx.cpu()})):
        xa = mxmod.nd.array(x, **ctx)
        xa.attach_grad()
        with mxmod.autograd.record():
            y = mxmod.nd.Pooling(xa, **kw)
        y.backward()
        out.append((y.asnumpy(), xa.grad.asnumpy()))
    (jy, jg), (ty, tg) = out
    assert ty.shape == jy.shape
    np.testing.assert_allclose(ty, jy, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tg, jg, rtol=TOL, atol=TOL)


BNS = {
    "nchw": (lambda nn: nn.BatchNorm(), RS.randn(4, 6, 5, 5) * 2 + 1),
    "no_scale_center": (lambda nn: nn.BatchNorm(scale=False, center=False,
                                                momentum=0.5),
                        RS.randn(4, 6, 5, 5)),
    "last_axis": (lambda nn: nn.BatchNorm(axis=3, epsilon=1e-3),
                  RS.randn(4, 5, 5, 6) + 3),
    "after_dense": (lambda nn: nn.BatchNorm(), RS.randn(16, 7)),
}


@pytest.mark.parametrize("name", list(BNS))
def test_batchnorm_train_matches_jax(name):
    """Training mode: batch moments, the gradients, and the running
    statistics written back (compared after the step)."""
    factory, x = BNS[name]
    _both(factory, x.astype(np.float32), BN_TOL)


@pytest.mark.parametrize("name", list(BNS))
def test_batchnorm_eval_uses_running_stats(name):
    """After two training steps the running statistics moved on both
    sides alike; eval mode normalises with them."""
    factory, x = BNS[name]
    x = x.astype(np.float32)
    jblock, tblock, _ = _both(factory, x, BN_TOL)
    x2 = (x * 0.5 - 1).astype(np.float32)
    _run(jmx, jblock, x2, {})
    _run(mx, tblock, x2, {"ctx": mx.cpu()})
    jy = jblock(jmx.nd.array(x)).asnumpy()
    ty = tblock(mx.nd.array(x, ctx=mx.cpu())).asnumpy()
    np.testing.assert_allclose(ty, jy, rtol=BN_TOL, atol=BN_TOL)
    rm = tblock.running_mean.data().asnumpy()
    assert not np.allclose(rm, 0.0)
    np.testing.assert_allclose(rm, jblock.running_mean.data().asnumpy(),
                               rtol=BN_TOL, atol=BN_TOL)


def test_flatten_matches_jax():
    _both(lambda nn: nn.Flatten(), RS.randn(3, 2, 4, 5).astype(np.float32),
          TOL)


# ---------------------------------------------------------------------------
# the optimize_for pass
# ---------------------------------------------------------------------------


def _chain(nn):
    """conv1x1 (bias) -> BN -> relu -> conv1x1 (prologue with relu) -> BN
    -> conv1x1 (prologue without relu) -> BN -> relu -> 3x3 conv ->
    BN -> global pool -> Dense: every fused form and its consumers."""
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv2D(8, 1), nn.BatchNorm(), nn.Activation("relu"),
                nn.Conv2D(6, 1, use_bias=False), nn.BatchNorm(),
                nn.Conv2D(10, 1), nn.BatchNorm(), nn.Activation("relu"),
                nn.Conv2D(4, 3, padding=1), nn.BatchNorm(),
                nn.GlobalAvgPool2D(), nn.Dense(3))
    return net


CHAIN_X = RS.randn(4, 5, 6, 6).astype(np.float32)


def test_fused_chain_matches_jax_fused():
    """Training step through the fused pass on both sides: output, every
    gradient (the fused convs' biases get none on either side) and the
    running statistics."""
    _both(_chain, CHAIN_X, BN_TOL, fused=True)


def test_fused_chain_eval_matches_jax_and_unfused():
    jblock, tblock, (jcall, tcall) = _both(_chain, CHAIN_X, BN_TOL,
                                           fused=True)
    jy = jcall(jmx.nd.array(CHAIN_X)).asnumpy()
    ty = tcall(mx.nd.array(CHAIN_X, ctx=mx.cpu())).asnumpy()
    np.testing.assert_allclose(ty, jy, rtol=BN_TOL, atol=BN_TOL)
    # the same weights and running statistics without the pass
    plain = _chain(mx.gluon.nn)
    plain.initialize(ctx=mx.cpu())
    plain(mx.nd.array(CHAIN_X, ctx=mx.cpu()))
    load_numpy(plain.collect_params(), {
        k: v.data().asnumpy() for k, v in zip(
            plain.collect_params().keys(),
            tblock.collect_params().values())})
    np.testing.assert_allclose(
        plain(mx.nd.array(CHAIN_X, ctx=mx.cpu())).asnumpy(), ty,
        rtol=BN_TOL, atol=BN_TOL)


def test_fused_conv_bias_gets_no_gradient():
    """A fused conv's bias is cancelled by the training-mode BatchNorm,
    so it is off the graph: its gradient buffer is left as it was (as the
    JAX package's), while the first BN's running mean records it."""
    net = _chain(mx.gluon.nn)
    net.initialize(ctx=mx.cpu())
    net(mx.nd.array(CHAIN_X, ctx=mx.cpu()))
    bias = net[0].bias
    bias.set_data(np.full(8, 0.5, np.float32))
    bias.grad()[:] = 7.0
    fused = net.optimize_for(backend="tpu_fused_conv_bn")
    with mx.autograd.record():
        y = fused(mx.nd.array(CHAIN_X, ctx=mx.cpu()))
    y.backward()
    assert (bias.grad().asnumpy() == 7.0).all()
    assert np.abs(net[-1].weight.grad().asnumpy()).max() > 0
    # running mean of conv-out = raw + bias: 0.9 * 0 + 0.1 * (mean + 0.5)
    rm = net[1].running_mean.data().asnumpy()
    raw = net[0].weight.data().asnumpy().reshape(8, 5) @ \
        CHAIN_X.transpose(1, 0, 2, 3).reshape(5, -1)
    np.testing.assert_allclose(rm, 0.1 * (raw.mean(1) + 0.5), rtol=1e-4,
                               atol=1e-5)


def test_dense_after_conv_restores_nchw_order():
    """Dense(flatten=True) right after a conv (no Flatten) sees NCHW
    feature order under optimize_for."""
    nn = mx.gluon.nn
    x = mx.nd.array(RS.rand(2, 3, 8, 8).astype(np.float32), ctx=mx.cpu())
    net = nn.HybridSequential()
    net.add(nn.Conv2D(4, kernel_size=3, in_channels=3),
            nn.Dense(5, in_units=4 * 6 * 6))
    net.initialize(ctx=mx.cpu())
    y_ref = net(x).asnumpy()
    fused = net.optimize_for(backend="tpu_fused_conv_bn")
    np.testing.assert_allclose(y_ref, fused(x).asnumpy(), rtol=TOL, atol=TOL)


def test_flatten_after_conv_restores_nchw_order():
    nn = mx.gluon.nn
    x = mx.nd.array(RS.rand(2, 3, 5, 5).astype(np.float32), ctx=mx.cpu())
    net = nn.HybridSequential()
    net.add(nn.Conv2D(4, kernel_size=1, in_channels=3), nn.Flatten())
    net.initialize(ctx=mx.cpu())
    y_ref = net(x).asnumpy()
    fused = net.optimize_for(backend="tpu_fused_conv_bn")
    np.testing.assert_allclose(y_ref, fused(x).asnumpy(), rtol=TOL, atol=TOL)


class _TwoMaps(mx.gluon.HybridBlock):
    def __init__(self, **kw):
        super().__init__(**kw)
        nn = mx.gluon.nn
        with self.name_scope():
            self.c1 = nn.Conv2D(4, kernel_size=1, in_channels=3)
            self.c2 = nn.Conv2D(6, kernel_size=3, in_channels=3)

    def hybrid_forward(self, F, x):
        return self.c1(x), self.c2(x)


_Out = collections.namedtuple("_Out", ["feat", "aux"])


class _NamedMaps(_TwoMaps):
    def hybrid_forward(self, F, x):
        return _Out(self.c1(x), self.c2(x))


def test_adapter_tuple_and_namedtuple_outputs():
    """Multi-feature-map nets get every 4-D output transposed back to
    NCHW; a namedtuple keeps its type and field order; the fused 1x1
    conv's output materialises with its bias."""
    x = mx.nd.array(RS.rand(2, 3, 8, 8).astype(np.float32), ctx=mx.cpu())
    net = _TwoMaps()
    net.initialize(ctx=mx.cpu())
    net.c1.bias.set_data(np.arange(4, dtype=np.float32))
    refs = [o.asnumpy() for o in net(x)]
    outs = net.optimize_for(backend="tpu_fused_conv_bn")(x)
    assert isinstance(outs, tuple) and len(outs) == 2
    assert outs[0].shape == (2, 4, 8, 8) and outs[1].shape == (2, 6, 6, 6)
    for ref, out in zip(refs, outs):
        np.testing.assert_allclose(ref, out.asnumpy(), rtol=TOL, atol=TOL)
    net2 = _NamedMaps()
    net2.initialize(ctx=mx.cpu())
    out2 = net2.optimize_for(backend="tpu_fused_conv_bn")(x)
    assert type(out2) is _Out
    assert out2.feat.shape == (2, 4, 8, 8) and out2.aux.shape == (2, 6, 6, 6)


def test_lazy_arrays_materialise_on_every_read():
    """A StatsArray answers shape, dtype and context without computing
    its tensor; any read of the tensor (an operator, .data, asnumpy)
    materialises raw + bias once."""
    from mxnet_tpu_torch.gluon.nn.tpu_fusion import PendingApply, StatsArray

    raw = mx.nd.array(RS.randn(2, 3, 3, 4).astype(np.float32), ctx=mx.cpu())
    bias = mx.nd.array(np.arange(4, dtype=np.float32), ctx=mx.cpu())
    z = mx.nd.zeros((4,), ctx=mx.cpu())
    sa = StatsArray(raw, z, z, 18, bias=bias)
    assert sa.shape == (2, 3, 3, 4) and sa.ndim == 4 and sa._pending()
    assert sa.context == mx.cpu() and sa.dtype == np.float32
    np.testing.assert_allclose((sa * 1.0).asnumpy(),
                               raw.asnumpy() + np.arange(4), rtol=TOL)
    assert not sa._pending() and sa.data is sa.data
    s = mx.nd.array(np.full(4, 2.0, np.float32), ctx=mx.cpu())
    pa = PendingApply(raw, s, -bias, False).with_relu()
    np.testing.assert_allclose(
        pa.asnumpy(), np.maximum(raw.asnumpy() * 2 - np.arange(4), 0),
        rtol=TOL)


def test_optimize_for_refuses_unknown_blocks_and_backends():
    nn = mx.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Conv2D(4, 1, in_channels=3), nn.LayerNorm(in_channels=4))
    with pytest.raises(MXNetError, match="unsupported parameterised block"):
        net.optimize_for(backend="tpu_fused_conv_bn")
    net.optimize_for(backend="tpu_fused_conv_bn", strict=False)
    with pytest.raises(MXNetError, match="unknown optimize_for backend"):
        net.optimize_for(backend="MKLDNN")
    marked = [b for b in (net[0],) if getattr(b, "_tpu_fused", False)]
    assert marked == [net[0]] and net[0]._kwargs["layout"] == "NHWC"


def test_layers_run_on_cuda():
    """Conv, pooling, BatchNorm and a fused chain on the card (K4/K5
    launched once per fused conv per step)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mxnet_tpu_torch.ops import _kernels

    net = _chain(mx.gluon.nn)
    net.initialize(ctx=mx.gpu(0))
    x = mx.nd.array(CHAIN_X, ctx=mx.gpu(0))
    net(x)
    fused = net.optimize_for(backend="tpu_fused_conv_bn")
    _kernels.LAUNCHES.clear()
    with mx.autograd.record():
        y = fused(x)
    y.backward()
    mx.nd.waitall()
    for k in ("fused_fwd", "fused_dw", "fused_dx"):
        assert _kernels.LAUNCHES[k] == 3, (k, dict(_kernels.LAUNCHES))
