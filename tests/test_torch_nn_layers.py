"""Port parity: the rest of ``gluon.nn`` and the ``nd`` operators under it
(``Deconvolution``, ``pad``, ``clip``, ``concat``, ``InstanceNorm``,
``GroupNorm`` and every ``LeakyReLU`` act type), against the JAX package.

A layer is built on both sides and the JAX layer's weights are carried
into the port's by name; an operator takes the same numpy arrays on both
sides. The same input goes through both under ``autograd.record()`` and
the backward takes the same random head gradient. The output and the
gradients of the input and of every parameter agree within 1e-5 of the
largest |value| of each (float32; the sides sum in other orders over at
most a few hundred terms, and the norms divide by a standard deviation
estimated from 24 to 200 values).
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import re

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon.utils import load_numpy

TOL = 1e-5
CPU = {"ctx": mx.cpu()}


def _strip(name):
    """A parameter name without its block counters (the two packages'
    global counters run apart across tests)."""
    return re.sub(r"\d+_", "_", name)


def _np(a):
    return np.array(a.asnumpy())


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert err <= TOL, f"{what}: {err:.3e} of the largest |value|"


def _head(shape):
    return np.random.RandomState(5).randn(*shape).astype(np.float32)


def _run_block(mxmod, block, x, ctx_kw):
    """Forward under record(), backward with a seeded head gradient: the
    output, the input's gradient and every trainable parameter's
    gradient, keyed without block counters."""
    xa = mxmod.nd.array(x, **ctx_kw)
    xa.attach_grad()
    with mxmod.autograd.record():
        y = block(xa)
    y.backward(mxmod.nd.array(_head(y.shape), **ctx_kw))
    grads = {_strip(k): _np(p.grad())
             for k, p in block.collect_params().items()
             if p.grad_req != "null"}
    return _np(y), _np(xa.grad), grads


def _both_blocks(factory, x, hybridize=False):
    jblock, tblock = factory(jmx.gluon.nn), factory(mx.gluon.nn)
    jblock.initialize()
    tblock.initialize(**CPU)
    jblock(jmx.nd.array(x))  # resolve deferred shapes
    tblock(mx.nd.array(x, **CPU))
    jp, tp = jblock.collect_params(), tblock.collect_params()
    assert [_strip(k) for k in tp.keys()] == [_strip(k) for k in jp.keys()]
    assert [p.shape for p in tp.values()] == [p.shape for p in jp.values()]
    load_numpy(tp, {k: _np(p.data()) for k, p in zip(tp.keys(),
                                                      jp.values())})
    if hybridize:
        jblock.hybridize()
        tblock.hybridize()
    jy, jgx, jg = _run_block(jmx, jblock, x, {})
    ty, tgx, tg = _run_block(mx, tblock, x, CPU)
    _close(ty, jy, "output")
    _close(tgx, jgx, "input gradient")
    assert sorted(tg) == sorted(jg)
    for k in jg:
        _close(tg[k], jg[k], f"gradient of {k}")
    return ty


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# name: (factory of a layer given the nn module, input shape)
LAYERS = {
    "conv1d_s2_p1": (lambda nn: nn.Conv1D(4, 3, strides=2, padding=1),
                     (2, 3, 9)),
    "conv1d_groups_dilate": (lambda nn: nn.Conv1D(6, 3, dilation=2,
                                                  groups=3), (2, 3, 11)),
    "conv3d": (lambda nn: nn.Conv3D(4, 3, padding=1), (2, 3, 4, 5, 5)),
    "conv3d_s2_nobias": (lambda nn: nn.Conv3D(4, (1, 3, 3), strides=2,
                                              use_bias=False),
                         (1, 2, 5, 7, 7)),
    "conv1d_transpose_adj": (lambda nn: nn.Conv1DTranspose(
        4, 3, strides=2, padding=1, output_padding=1), (2, 6, 7)),
    "conv1d_transpose_groups_s3": (lambda nn: nn.Conv1DTranspose(
        4, 4, strides=3, groups=2, output_padding=2), (2, 6, 5)),
    "conv2d_transpose_s2_p1": (lambda nn: nn.Conv2DTranspose(
        4, 4, strides=2, padding=1), (2, 3, 5, 5)),
    "conv2d_transpose_groups_adj_s3": (lambda nn: nn.Conv2DTranspose(
        4, 3, strides=3, padding=1, output_padding=2, groups=2),
        (2, 4, 4, 5)),
    "conv2d_transpose_s1_dilate_act": (lambda nn: nn.Conv2DTranspose(
        3, 3, dilation=2, activation="relu"), (1, 2, 4, 4)),
    "conv3d_transpose_adj": (lambda nn: nn.Conv3DTranspose(
        3, 3, strides=2, padding=1, output_padding=1), (1, 2, 3, 4, 4)),
    "conv3d_transpose_groups": (lambda nn: nn.Conv3DTranspose(
        4, (2, 3, 3), strides=(1, 2, 2), groups=2), (1, 4, 3, 3, 3)),
    "maxpool1d_ceil": (lambda nn: nn.MaxPool1D(3, 2, ceil_mode=True),
                       (2, 3, 10)),
    "avgpool1d_pad_exclude": (lambda nn: nn.AvgPool1D(
        3, 2, padding=1, count_include_pad=False), (2, 3, 9)),
    "avgpool1d_ceil_include": (lambda nn: nn.AvgPool1D(
        3, 2, padding=1, ceil_mode=True), (2, 3, 10)),
    "globalmaxpool1d": (lambda nn: nn.GlobalMaxPool1D(), (2, 3, 7)),
    "globalavgpool1d": (lambda nn: nn.GlobalAvgPool1D(), (2, 3, 7)),
    "maxpool3d": (lambda nn: nn.MaxPool3D(2), (1, 2, 4, 6, 6)),
    "maxpool3d_pad_ceil": (lambda nn: nn.MaxPool3D(3, 2, 1, ceil_mode=True),
                           (1, 2, 5, 6, 6)),
    "avgpool3d_ceil_exclude": (lambda nn: nn.AvgPool3D(
        3, 2, 1, ceil_mode=True, count_include_pad=False), (1, 2, 5, 6, 6)),
    "avgpool3d_include": (lambda nn: nn.AvgPool3D(3, 2, 1),
                          (1, 2, 5, 6, 6)),
    "globalmaxpool3d": (lambda nn: nn.GlobalMaxPool3D(), (2, 3, 3, 4, 4)),
    "globalavgpool3d": (lambda nn: nn.GlobalAvgPool3D(), (2, 3, 3, 4, 4)),
    "reflectionpad2d": (lambda nn: nn.ReflectionPad2D(2), (2, 3, 5, 6)),
    "reflectionpad2d_uneven": (lambda nn: nn.ReflectionPad2D(
        (0, 0, 0, 0, 1, 3, 2, 0)), (1, 2, 5, 4)),
    "syncbatchnorm": (lambda nn: nn.SyncBatchNorm(), (4, 3, 5, 5)),
    "instancenorm": (lambda nn: nn.InstanceNorm(), (2, 3, 5, 5)),
    "instancenorm_scale_1d": (lambda nn: nn.InstanceNorm(scale=True,
                                                         epsilon=1e-3),
                              (2, 3, 24)),
    "groupnorm": (lambda nn: nn.GroupNorm(2), (2, 4, 3, 3)),
    "groupnorm_one_3d": (lambda nn: nn.GroupNorm(), (2, 4, 2, 3, 3)),
    "leakyrelu": (lambda nn: nn.LeakyReLU(0.1), (2, 3, 4)),
    "prelu_per_channel": (lambda nn: nn.PReLU(in_channels=3),
                          (2, 3, 4, 4)),
    "prelu_single": (lambda nn: nn.PReLU(), (2, 3, 4)),
    "elu": (lambda nn: nn.ELU(0.7), (2, 3, 4)),
    "selu": (lambda nn: nn.SELU(), (2, 3, 4)),
    "gelu": (lambda nn: nn.GELU(), (2, 3, 4)),
    "swish": (lambda nn: nn.Swish(1.5), (2, 3, 4)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(name):
    factory, shape = LAYERS[name]
    _both_blocks(factory, _x(*shape))


def test_prelu_alpha_takes_its_gradient():
    """PReLU's slopes start at 0.25 and learn: their gradient is the sum
    of head * x over the negative inputs of each channel."""
    x = _x(2, 3, 4, 4)
    _both_blocks(lambda nn: nn.PReLU(in_channels=3), x)
    block = mx.gluon.nn.PReLU(in_channels=3)
    block.initialize(**CPU)
    np.testing.assert_array_equal(_np(block.alpha.data()), [0.25] * 3)
    _, _, grads = _run_block(mx, block, x, CPU)
    head = _head(x.shape)
    want = (head * x * (x < 0)).sum(axis=(0, 2, 3))
    _close(grads[_strip(block.alpha.name)], want, "alpha gradient")


# name: (factory given the nn module, input shape)
LAMBDAS = {
    "lambda_op_name": (lambda nn: nn.Lambda("relu"), (2, 3, 4)),
    "lambda_function": (lambda nn: nn.Lambda(lambda x: x * 2 + 1),
                        (2, 3)),
    "hybridlambda_op_name": (lambda nn: nn.HybridLambda("sigmoid"),
                             (2, 3, 4)),
    "hybridlambda_function": (lambda nn: nn.HybridLambda(
        lambda F, x: F.LeakyReLU(x, act_type="elu", slope=0.5)), (2, 3, 4)),
}


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("name", sorted(LAMBDAS))
def test_lambda_matches_jax(name, hybridize):
    """Each inside a container (a Lambda is a plain Block, so its
    container is a Sequential, whose hybridize() only reaches hybrid
    children)."""
    factory, shape = LAMBDAS[name]

    def build(nn):
        net = nn.HybridSequential() if name.startswith("hybrid") \
            else nn.Sequential()
        net.add(factory(nn))
        return net

    _both_blocks(build, _x(*shape), hybridize=hybridize)


def test_nn_exports_every_reference_layer():
    """Every name of the JAX package's ``gluon.nn`` but SymbolBlock
    (ROADMAP A13)."""
    want = {n for n in dir(jmx.gluon.nn) if not n.startswith("_")
            and isinstance(getattr(jmx.gluon.nn, n), type)} - {"SymbolBlock"}
    have = {n for n in dir(mx.gluon.nn) if not n.startswith("_")}
    assert want <= have, sorted(want - have)


def _run_op(mxmod, op, arrays, kwargs, ctx_kw):
    """``op(*arrays, **kwargs)`` recorded, backward with a seeded head:
    the output and each input's gradient."""
    xs = [mxmod.nd.array(a, **ctx_kw) for a in arrays]
    for a in xs:
        a.attach_grad()
    with mxmod.autograd.record():
        y = getattr(mxmod.nd, op)(*xs, **kwargs)
    y.backward(mxmod.nd.array(_head(y.shape), **ctx_kw))
    return _np(y), [_np(a.grad) for a in xs]


def _both_ops(op, arrays, **kwargs):
    jy, jg = _run_op(jmx, op, arrays, kwargs, {})
    ty, tg = _run_op(mx, op, arrays, kwargs, CPU)
    _close(ty, jy, f"{op} output")
    for i, (a, b) in enumerate(zip(tg, jg)):
        _close(a, b, f"{op} gradient of input {i}")
    return ty


# (spatial axes, stride, groups, adj, pad, dilate)
DECONV = [(1, 1, 1, 0, 0, 1), (1, 2, 2, 1, 1, 1), (1, 3, 1, 2, 1, 2),
          (2, 1, 2, 0, 1, 1), (2, 2, 1, 1, 1, 1), (2, 3, 2, 2, 0, 1),
          (2, 2, 1, 0, 2, 2), (3, 1, 1, 0, 1, 1), (3, 2, 2, 1, 1, 1),
          (3, 3, 1, 2, 0, 1)]


@pytest.mark.parametrize("nd,stride,groups,adj,pad,dilate", DECONV)
def test_deconvolution_op_matches_jax(nd, stride, groups, adj, pad, dilate):
    cin, cout, k = 4, 6, 3
    x = _x(2, cin, *(4,) * nd)
    w = _x(cin, cout // groups, *(k,) * nd, seed=1) * 0.3
    b = _x(cout, seed=2)
    kw = dict(kernel=(k,) * nd, stride=(stride,) * nd, pad=(pad,) * nd,
              adj=(adj,) * nd, dilate=(dilate,) * nd, num_filter=cout,
              num_group=groups, no_bias=False)
    y = _both_ops("Deconvolution", [x, w, b], **kw)
    span = (4 - 1) * stride + (k - 1) * dilate + 1 - 2 * pad + adj
    assert y.shape == (2, cout) + (span,) * nd


@pytest.mark.parametrize("mode,pad_width,value", [
    ("constant", (0, 0, 1, 2, 0, 3), 0.0),
    ("constant", (0, 0, 0, 0, 2, 1, 1, 2), -1.5),
    ("edge", (0, 0, 0, 0, 2, 3, 1, 0), 0.0),
    ("edge", (1, 0, 0, 2, 4, 1), 0.0),
    ("reflect", (0, 0, 0, 0, 2, 1, 3, 2), 0.0),
    ("reflect", (0, 0, 0, 0, 6, 5, 0, 4), 0.0),  # longer than the axis
])
def test_pad_matches_jax(mode, pad_width, value):
    shape = (2, 3, 4, 5)[:len(pad_width) // 2]
    _both_ops("pad", [_x(*shape)], mode=mode, pad_width=pad_width,
              constant_value=value)


@pytest.mark.parametrize("a_min,a_max", [(0.0, 6.0), (-0.5, 0.5),
                                         (None, 0.3), (-0.2, None)])
def test_clip_matches_jax(a_min, a_max):
    _both_ops("clip", [_x(3, 4, 5) * 4], a_min=a_min, a_max=a_max)


@pytest.mark.parametrize("op,dim", [("concat", 1), ("concat", 0),
                                    ("Concat", -1), ("concat", 2)])
def test_concat_matches_jax(op, dim):
    shapes = [[2, 3, 4], [2, 3, 4], [2, 3, 4]]
    for i, s in enumerate(shapes):
        s[dim] += i
    _both_ops(op, [_x(*s, seed=i) for i, s in enumerate(shapes)], dim=dim)


@pytest.mark.parametrize("act_type,kw,shape", [
    ("leaky", {"slope": 0.2}, (2, 3, 4)),
    ("prelu", {}, (2, 3, 4, 4)),
    ("prelu", {}, (5, 3)),  # 2-D: slopes broadcast against the last axis
    ("elu", {"slope": 0.8}, (2, 3, 4)),
    ("selu", {}, (2, 3, 4)),
    ("gelu", {}, (2, 3, 4)),
    ("rrelu", {"lower_bound": 0.1, "upper_bound": 0.3}, (2, 3, 4)),
])
def test_leaky_relu_act_types_match_jax(act_type, kw, shape):
    arrays = [_x(*shape) * 2]
    if act_type == "prelu":
        arrays.append(np.array([0.1, 0.25, -0.4], np.float32))
    _both_ops("LeakyReLU", arrays, act_type=act_type, **kw)


@pytest.mark.parametrize("op,kw,shape", [
    ("InstanceNorm", {"eps": 1e-3}, (2, 3, 4, 5)),
    ("InstanceNorm", {"eps": 1e-5}, (2, 3, 3, 2, 4)),
    ("GroupNorm", {"num_groups": 2}, (2, 4, 3, 3)),
    ("GroupNorm", {"num_groups": 3, "eps": 1e-3}, (2, 6, 8)),
])
def test_norm_ops_match_jax(op, kw, shape):
    c = shape[1]
    _both_ops(op, [_x(*shape) + 1.5, _x(c, seed=1), _x(c, seed=2)], **kw)


@pytest.mark.parametrize("op,kw", [("Activation", {"act_type": "relu"}),
                                   ("relu", {}),
                                   ("clip", {"a_min": 0.0, "a_max": 6.0})])
def test_ties_take_half_the_gradient(op, kw):
    """At exactly 0 (and at clip's bounds) the JAX package's relu and clip
    pass half the gradient (``jnp.maximum`` and ``jnp.clip`` split a tie);
    so does the port. Such ties are real: a bias-free conv over a pixel
    whose relu'd inputs are all zero outputs exactly 0."""
    x = _x(2, 3, 4)
    x[0, 0, :3] = 0.0
    x[1, 2, :2] = 6.0
    got = _both_ops(op, [x], **kw)
    _, (grad,) = _run_op(mx, op, [x], kw, CPU)
    head = _head(got.shape)
    np.testing.assert_array_equal(grad[0, 0, :3], 0.5 * head[0, 0, :3])
    if op == "clip":
        np.testing.assert_array_equal(grad[1, 2, :2], 0.5 * head[1, 2, :2])
