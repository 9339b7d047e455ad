"""Port parity: Gluon layers, parameters and autograd of
``mxnet_tpu_torch`` against the JAX package.

Each layer is built on both sides, the JAX layer's weights are carried
into the port's by name (``gluon.utils.load_numpy``), and the same numpy
input goes through both under ``autograd.record()``; the backward of the
(non-scalar) output uses MXNet's head gradient of ones. Outputs and the
gradients of the input and every parameter must agree within 1e-5
absolute and relative (float32; the sides differ in summation order over
at most a few dozen terms).

The autograd tests check MXNet's semantics, which torch's ``.grad`` does
not have by itself: ``grad_req="write"`` overwrites across backwards,
``"add"`` accumulates, a non-scalar head is seeded with ones, and
``record``/``pause``/``train_mode``/``predict_mode`` set the same flags.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import re

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.utils import load_numpy

TOL = 1e-5


def _carry(jblock, tblock):
    """Copy the JAX block's weights into the port's, parameter by
    parameter. The two packages' global name counters (``dense3_`` ...)
    run apart across tests, so names are matched with counters removed."""
    jparams, tparams = jblock.collect_params(), tblock.collect_params()
    assert [re.sub(r"\d+_", "_", k) for k in tparams.keys()] == \
        [re.sub(r"\d+_", "_", k) for k in jparams.keys()]
    load_numpy(tparams, {k: p.data().asnumpy()
                         for k, p in zip(tparams.keys(), jparams.values())})


def _run(mxmod, block, x, ctx_kw, attach_input):
    xa = mxmod.nd.array(x, **ctx_kw)
    if attach_input:
        xa.attach_grad()
    with mxmod.autograd.record():
        y = block(xa)
    y.backward()
    grads = {k.replace(block.prefix, "", 1): p.grad().asnumpy()
             for k, p in block.collect_params().items()
             if p.grad_req != "null"}
    return y.asnumpy(), (xa.grad.asnumpy() if attach_input else None), grads


def _hybrid_stack(nn):
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(8, flatten=False), nn.GELU(),
                nn.LayerNorm(), nn.Dense(3, flatten=False))
    return net


RS = np.random.RandomState(0)
# name: (layer factory over the nn module, input, float input?)
LAYERS = {
    "dense_flatten": (lambda nn: nn.Dense(5),
                      RS.randn(3, 4, 2).astype(np.float32), True),
    "dense_last_axis_tanh": (
        lambda nn: nn.Dense(6, flatten=False, activation="tanh"),
        RS.randn(2, 3, 4).astype(np.float32), True),
    "dense_relu_no_bias": (
        lambda nn: nn.Dense(4, activation="relu", use_bias=False),
        RS.randn(5, 7).astype(np.float32), True),
    "embedding": (lambda nn: nn.Embedding(10, 4),
                  RS.randint(0, 10, (2, 5)).astype(np.float32), False),
    "layernorm": (lambda nn: nn.LayerNorm(),
                  (RS.randn(2, 3, 8) * 3 + 1).astype(np.float32), True),
    "gelu": (lambda nn: nn.GELU(), RS.randn(4, 6).astype(np.float32) * 3,
             True),
    "dropout0": (lambda nn: nn.Dropout(0.0),
                 RS.randn(4, 6).astype(np.float32), True),
    "hybrid_stack": (_hybrid_stack, RS.randn(2, 5, 4).astype(np.float32),
                     True),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_layer_matches_jax(name):
    factory, x, float_input = LAYERS[name]
    jblock, tblock = factory(jmx.gluon.nn), factory(mx.gluon.nn)
    jblock.initialize()
    tblock.initialize(ctx=mx.cpu())
    jblock(jmx.nd.array(x))  # resolve deferred shapes
    tblock(mx.nd.array(x, ctx=mx.cpu()))
    assert [k.replace(tblock.prefix, "", 1)
            for k in tblock.collect_params()] == \
        [k.replace(jblock.prefix, "", 1) for k in jblock.collect_params()]
    _carry(jblock, tblock)
    jy, jgx, jg = _run(jmx, jblock, x, {}, float_input)
    ty, tgx, tg = _run(mx, tblock, x, {"ctx": mx.cpu()}, float_input)
    np.testing.assert_allclose(ty, jy, rtol=TOL, atol=TOL)
    if float_input:
        np.testing.assert_allclose(tgx, jgx, rtol=TOL, atol=TOL)
    assert sorted(tg) == sorted(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=TOL, atol=TOL,
                                   err_msg=k)


def test_softmax_cross_entropy_matches_jax():
    rs = np.random.RandomState(1)
    pred = rs.randn(3, 4, 7).astype(np.float32) * 2
    label = rs.randint(0, 7, (3, 4)).astype(np.float32)
    out = []
    for mxmod, kw in ((jmx, {}), (mx, {"ctx": mx.cpu()})):
        p = mxmod.nd.array(pred, **kw)
        p.attach_grad()
        with mxmod.autograd.record():
            loss = mxmod.gluon.loss.SoftmaxCrossEntropyLoss()(
                p, mxmod.nd.array(label, **kw))
        loss.backward()
        out.append((loss.asnumpy(), p.grad.asnumpy()))
    (tl, tg), (jl, jg) = out[1], out[0]
    assert tl.shape == (3,)
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tg, jg, rtol=TOL, atol=TOL)


def test_dropout_trains_and_predicts():
    """Rate 0.5: identity outside training; in ``record()`` about half
    the entries are zeroed and the rest scaled by 2 (draws from the
    torch generator, so only the distribution is checked)."""
    torch.manual_seed(0)
    drop = mx.gluon.nn.Dropout(0.5)
    x = mx.nd.ones((200, 50), ctx=mx.cpu())
    assert (drop(x).asnumpy() == 1).all()
    with mx.autograd.record():
        y = drop(x).asnumpy()
    assert set(np.unique(y)) <= {0.0, 2.0}
    assert 0.45 < (y == 0).mean() < 0.55


@pytest.mark.parametrize("req", ["write", "add"])
def test_grad_req_write_overwrites_add_accumulates(req):
    got = []
    for mxmod, kw in ((jmx, {}), (mx, {"ctx": mx.cpu()})):
        x = mxmod.nd.array(np.array([1.0, 2.0, 3.0], np.float32), **kw)
        x.attach_grad(req)
        for _ in range(2):
            with mxmod.autograd.record():
                y = x * x
            y.backward()  # non-scalar head: seeded with ones
        got.append(x.grad.asnumpy())
    want = np.array([2.0, 4.0, 6.0]) * (1 if req == "write" else 2)
    np.testing.assert_allclose(got[0], want)
    np.testing.assert_allclose(got[1], want)


def test_parameter_grad_req_and_head_gradient():
    """A Dense weight with grad_req "add" accumulates over two backwards
    with an explicit head gradient; "write" on the bias overwrites."""
    x = np.random.RandomState(2).randn(3, 4).astype(np.float32)
    hg = np.random.RandomState(3).randn(3, 2).astype(np.float32)
    got = []
    for mxmod, kw in ((jmx, {}), (mx, {"ctx": mx.cpu()})):
        net = mxmod.gluon.nn.Dense(2, in_units=4)
        net.initialize(**kw)
        if mxmod is mx:
            _carry(jnet, net)
        else:
            jnet = net
        net.weight.grad_req = "add"
        for p in (net.weight, net.bias):
            p.data().attach_grad(p.grad_req)
        for _ in range(2):
            with mxmod.autograd.record():
                y = net(mxmod.nd.array(x, **kw))
            y.backward(mxmod.nd.array(hg, **kw))
        got.append((net.weight.grad().asnumpy(), net.bias.grad().asnumpy()))
    for a, b in zip(got[0], got[1]):
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[1][1], hg.sum(0), rtol=TOL, atol=TOL)


def test_grad_req_set_after_initialize_pinned():
    """``grad_req`` set after ``initialize`` changes no handle in either
    package: the gradient keeps the mode it was attached with, so two
    backwards leave one backward's gradient ("write"). MXNet 1.x
    re-attaches; both packages' behaviour is pinned here."""
    x = np.random.RandomState(4).randn(3, 4).astype(np.float32)
    got = []
    for mxmod, kw in ((jmx, {}), (mx, {"ctx": mx.cpu()})):
        net = mxmod.gluon.nn.Dense(2, in_units=4, use_bias=False)
        net.initialize(**kw)
        net.collect_params().setattr("grad_req", "add")
        assert net.weight.grad_req == "add"
        for _ in range(2):
            with mxmod.autograd.record():
                y = net(mxmod.nd.array(x, **kw))
            y.backward()
        got.append(net.weight.grad().asnumpy())
    one = np.repeat(x.sum(0)[None], 2, 0)  # one backward of a head of ones
    np.testing.assert_allclose(got[0], one, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[1], one, rtol=TOL, atol=TOL)


def test_record_pause_and_modes_match_jax():
    def flags(mxmod):
        ag = mxmod.autograd
        out = [(ag.is_recording(), ag.is_training())]
        with ag.record():
            out.append((ag.is_recording(), ag.is_training()))
            with ag.pause():
                out.append((ag.is_recording(), ag.is_training()))
            with ag.predict_mode():
                out.append((ag.is_recording(), ag.is_training()))
        with ag.record(train_mode=False):
            out.append((ag.is_recording(), ag.is_training()))
        with ag.train_mode():
            out.append((ag.is_recording(), ag.is_training()))
        out.append((ag.is_recording(), ag.is_training()))
        return out

    assert flags(mx) == flags(jmx)


def test_unrecorded_ops_build_no_graph_and_cannot_backward():
    x = mx.nd.array([1.0, 2.0], ctx=mx.cpu())
    x.attach_grad()
    y = x * 2
    assert not y.data.requires_grad
    with pytest.raises(MXNetError, match="not on the tape"):
        y.backward()
    with mx.autograd.record():
        with mx.autograd.pause():
            z = x * 2
        w = x * 3
    assert not z.data.requires_grad and w.data.requires_grad


def test_views_write_through_and_deferred_init():
    a = mx.nd.zeros((4, 3), ctx=mx.cpu())
    b = a[1:3]
    b[:] = 5
    assert a.asnumpy()[1:3].sum() == 30 and a.asnumpy()[0].sum() == 0
    net = mx.gluon.nn.Dense(7)
    net.initialize(ctx=mx.cpu())
    with pytest.raises(mx.gluon.DeferredInitializationError):
        net.weight.data()
    net(mx.nd.ones((2, 5), ctx=mx.cpu()))
    assert net.weight.shape == (7, 5) and net.bias.shape == (7,)
    assert (net.bias.data().asnumpy() == 0).all()


def test_load_numpy_refuses_missing_extra_and_shape():
    net = mx.gluon.nn.Dense(2, in_units=3, prefix="d_")
    net.initialize(ctx=mx.cpu())
    w, b = np.ones((2, 3), np.float32), np.ones(2, np.float32)
    with pytest.raises(MXNetError, match="missing"):
        load_numpy(net.collect_params(), {"d_weight": w})
    with pytest.raises(MXNetError, match="extra"):
        load_numpy(net.collect_params(),
                   {"d_weight": w, "d_bias": b, "d_other": b})
    with pytest.raises(MXNetError, match="shape"):
        load_numpy(net.collect_params(), {"d_weight": w.T, "d_bias": b})
    load_numpy(net.collect_params(), {"d_weight": w, "d_bias": b})
    assert (net.weight.data().asnumpy() == 1).all()


def test_readme_loop_matches_jax():
    """The README's loop (HybridSequential of Dense(128, relu) and
    Dense(10), hybridize, SGD lr 0.1, SoftmaxCrossEntropyLoss) for 3
    steps on both packages from the same weights; the port runs it under
    ``with mx.cpu():`` (its default context is the card)."""
    rs = np.random.RandomState(5)
    x = rs.randn(8, 20).astype(np.float32)
    y = rs.randint(0, 10, 8).astype(np.float32)
    nets = []
    for mxmod, ctx in ((jmx, jmx.cpu()), (mx, mx.cpu())):
        net = mxmod.gluon.nn.HybridSequential()
        net.add(mxmod.gluon.nn.Dense(128, activation="relu"),
                mxmod.gluon.nn.Dense(10))
        with ctx:
            net.initialize()
            net.hybridize()
            net(mxmod.nd.array(x))  # resolve deferred shapes
        nets.append(net)
    _carry(*nets)
    losses = []
    for mxmod, ctx, net in ((jmx, jmx.cpu(), nets[0]),
                            (mx, mx.cpu(), nets[1])):
        gluon, autograd = mxmod.gluon, mxmod.autograd
        with ctx:
            xa, ya = mxmod.nd.array(x), mxmod.nd.array(y)
            trainer = gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.1})
            run = []
            for _ in range(3):
                with autograd.record():
                    loss = gluon.loss.SoftmaxCrossEntropyLoss()(net(xa), ya)
                loss.backward()
                trainer.step(x.shape[0])
                run.append(loss.asnumpy())
        losses.append(np.stack(run))
    np.testing.assert_allclose(losses[1], losses[0], rtol=TOL, atol=TOL)
    assert losses[1][-1].mean() < losses[1][0].mean()
