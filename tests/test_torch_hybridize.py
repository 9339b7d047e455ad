"""Port parity: ``HybridBlock.hybridize`` and the cached graph
(``gluon/block.py`` ``_CachedGraph``) of ``mxnet_tpu_torch`` against the
JAX package's and against the port's own eager path.

On the CPU an entry runs its forward and backward halves eagerly, so
these tests hold the key and its retrace causes, the autograd function
that routes the gradients, the write-back of BatchNorm's running
statistics, both recording paths (shared residuals and, under
``MXTPU_FUSED_STEP=0``, the legacy recompute), the identity guard over
the parameter handles and ``SPMDTrainStep``'s trace flag. The
``*_on_cuda`` tests repeat the cases with captured CUDA graphs and skip
without a card.

Tolerances (float32):
- the port hybridized against the port eager: equal bit for bit on the
  CPU (the same operators in the same order), 1e-6 relative to the
  largest |value| on the card (the same kernels; cuBLAS may pick another
  algorithm inside a capture);
- against the JAX package: 1e-5 absolute and relative for the small
  blocks (as ``test_torch_gluon.py``); the 2-layer BERT's loss 1e-5
  relative and each gradient 1e-5 of the largest |grad| of its layer (the
  weight and bias of one projection: the attention key bias's gradient is
  zero in exact arithmetic, float noise on both sides); the small
  ResNetV1 through ``optimize_for`` as ``test_torch_resnet.py``, loss
  and running statistics 1e-4 relative (every BatchNorm divides by a
  batch standard deviation, so rounding grows through the stages);
- every optimizer, hybridized against eager over 2 steps: weights 1e-6
  absolute and relative (equal on the CPU);
- ``SPMDTrainStep`` hybridized against eager: losses 1e-6 relative.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import logging
import re

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import observability as jobs
from mxnet_tpu.models import bert as jbert
from mxnet_tpu_torch import fusedstep
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import block as tblock
from mxnet_tpu_torch.gluon.block import reset_names
from mxnet_tpu_torch.gluon.utils import load_numpy
from mxnet_tpu_torch.ops import _kernels

TOL = 1e-5
KW = {"ctx": mx.cpu()}
RS = np.random.RandomState(0)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return {"ctx": mx.gpu(0)}


def _np(a):
    """A host copy (the JAX package's CPU ``asnumpy`` may alias a buffer
    that a later update donates and overwrites)."""
    return np.array(a.asnumpy())


def _carry(jnet, tnet):
    """The JAX block's weights into the port's, parameter by parameter;
    the packages' global name counters run apart, so names are matched
    with counters removed."""
    jparams, tparams = jnet.collect_params(), tnet.collect_params()
    assert [re.sub(r"\d+_", "_", k) for k in tparams.keys()] == \
        [re.sub(r"\d+_", "_", k) for k in jparams.keys()]
    load_numpy(tparams, {k: _np(p.data()) for k, p in
                         zip(tparams.keys(), jparams.values())})


def _mlp(m, act="tanh", out=3):
    net = m.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(m.gluon.nn.Dense(8, activation=act), m.gluon.nn.Dense(out))
    return net


def _conv_block(m):
    nn = m.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv2D(4, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.MaxPool2D(2), nn.Flatten(),
                nn.Dense(3))
    return net


def _pair(factory, x):
    """The block built in both packages, shapes resolved by one predict
    call on ``x``, the JAX block's weights carried into the port's."""
    jnet = factory(jmx)
    jnet.initialize()
    jnet(jmx.nd.array(x))
    tnet = factory(mx)
    tnet.initialize(**KW)
    tnet(mx.nd.array(x, **KW))
    _carry(jnet, tnet)
    return jnet, tnet


def _fresh(factory, x, ctx_kw=KW, seed=0):
    """A port block from a torch seed, shapes resolved on ``x``."""
    torch.manual_seed(seed)
    net = factory(mx)
    net.initialize(init=mx.initializer.Xavier(), **ctx_kw)
    net(mx.nd.array(x, **ctx_kw))
    return net


def _copy_weights(src, dst):
    """``src``'s weights into ``dst`` (the same architecture), in order."""
    dparams = dst.collect_params()
    load_numpy(dparams, {k: _np(p.data()) for k, p in
                         zip(dparams.keys(), src.collect_params().values())})


def _fwd_bwd(m, net, x, ctx_kw, attach=False):
    """One recorded forward and backward of sum(out^2): the output, the
    input's gradient (when ``attach``) and every gradient by name."""
    xa = m.nd.array(x, **ctx_kw)
    if attach:
        xa.attach_grad()
    with m.autograd.record():
        out = net(xa)
        loss = (out * out).sum()
    loss.backward()
    grads = {k: _np(p.grad()) for k, p in net.collect_params().items()
             if p.grad_req != "null"}
    return _np(out), (_np(xa.grad) if attach else None), grads


def _values(net):
    return {k: _np(p.data()) for k, p in net.collect_params().items()}


def _same(a, b):
    """Equal bit for bit: arrays, or dicts of arrays whose keys differ at
    most in their name counters."""
    if isinstance(a, dict):
        assert [re.sub(r"\d+_", "_", k) for k in a] == \
            [re.sub(r"\d+_", "_", k) for k in b]
        for (k, u), v in zip(a.items(), b.values()):
            np.testing.assert_array_equal(u, v, err_msg=k)
    else:
        np.testing.assert_array_equal(a, b)


def _near_by_name(got, want, tol=TOL):
    """Dicts keyed by names that differ only in their counters."""
    assert len(got) == len(want)
    for (kg, g), (kw, w) in zip(got.items(), want.items()):
        assert re.sub(r"\d+_", "_", kg) == re.sub(r"\d+_", "_", kw)
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=kg)


def _entries(net):
    return net._cached_graph._cache


# ---------------------------------------------------------------------------
# against the JAX package (tests/test_gluon.py's hybrid cases)
# ---------------------------------------------------------------------------

def test_hybrid_consistency_matches_jax():
    """test_gluon.py::test_hybrid_consistency: a hybridized Dense stack
    gives its eager output, and the JAX package's, and a second call hits
    the cache."""
    x = RS.randn(4, 6).astype(np.float32)
    jnet, tnet = _pair(_mlp, x)
    eager = _np(tnet(mx.nd.array(x, **KW)))
    jnet.hybridize()
    tnet.hybridize()
    jout = _np(jnet(jmx.nd.array(x)))
    first = _np(tnet(mx.nd.array(x, **KW)))
    entry = next(iter(_entries(tnet).values()))
    second = _np(tnet(mx.nd.array(x, **KW)))
    _same(first, eager)
    _same(second, first)
    np.testing.assert_allclose(first, jout, rtol=TOL, atol=TOL)
    assert list(_entries(tnet).values()) == [entry]
    assert tnet._cached_graph.retrace_causes == []


def test_hybrid_grad_consistency_matches_jax():
    """test_gluon.py::test_hybrid_grad_consistency: the gradients of a
    hybridized stack equal its eager ones and the JAX package's
    hybridized ones."""
    x = np.linspace(-1, 1, 12).reshape(3, 4).astype(np.float32)
    jnet, tnet = _pair(lambda m: _mlp(m, "relu", 2), x)
    eager = _fwd_bwd(mx, tnet, x, KW)
    jnet.hybridize()
    tnet.hybridize()
    hyb = _fwd_bwd(mx, tnet, x, KW)
    jhyb = _fwd_bwd(jmx, jnet, x, {})
    _same(hyb[0], eager[0])
    _same(hyb[2], eager[2])
    np.testing.assert_allclose(hyb[0], jhyb[0], rtol=TOL, atol=TOL)
    _near_by_name(hyb[2], jhyb[2])


def test_conv_block_matches_jax():
    """test_gluon.py::test_conv_block: Conv2D + BatchNorm + relu + pooling
    + Dense hybridized, in predict mode and recorded in training mode (the
    running statistics written back), against eager and the JAX
    package."""
    x = RS.rand(2, 3, 8, 8).astype(np.float32)
    jnet, tnet = _pair(_conv_block, x)
    eager_net = _conv_block(mx)
    eager_net.initialize(**KW)
    eager_net(mx.nd.array(x, **KW))
    _copy_weights(tnet, eager_net)
    jnet.hybridize()
    tnet.hybridize()
    pred = _np(tnet(mx.nd.array(x, **KW)))
    _same(pred, _np(eager_net(mx.nd.array(x, **KW))))
    np.testing.assert_allclose(pred, _np(jnet(jmx.nd.array(x))),
                               rtol=TOL, atol=TOL)
    hyb = _fwd_bwd(mx, tnet, x, KW)
    eager = _fwd_bwd(mx, eager_net, x, KW)
    jhyb = _fwd_bwd(jmx, jnet, x, {})
    _same(hyb[0], eager[0])
    _same(hyb[2], eager[2])
    _same(_values(tnet), _values(eager_net))
    np.testing.assert_allclose(hyb[0], jhyb[0], rtol=TOL, atol=TOL)
    _near_by_name(hyb[2], jhyb[2])
    _near_by_name(_values(tnet), _values(jnet))
    assert len(_entries(tnet)) == 2  # predict, then recording


def test_batchnorm_moving_stats_eager_and_hybrid():
    """test_gluon.py::test_batchnorm_moving_stats_eager_and_hybrid: a
    predict call leaves the running statistics; each recorded call moves
    them once, hybridized as eager, and as in the JAX package."""
    x = (RS.randn(4, 3, 5, 5) + 2.0).astype(np.float32)

    def bn(m):
        return m.gluon.nn.BatchNorm(in_channels=3)

    stats = {}
    for name, m, kw, hyb in (("eager", mx, KW, False),
                             ("hybrid", mx, KW, True),
                             ("jax", jmx, {}, True)):
        b = bn(m)
        b.initialize(**kw)
        if hyb:
            b.hybridize()
        xa = m.nd.array(x, **kw)
        b(xa)
        rm0 = _np(b.running_mean.data())
        np.testing.assert_array_equal(rm0, np.zeros(3, np.float32))
        seen = []
        for _ in range(3):
            with m.autograd.record():
                b(xa)
            seen.append((_np(b.running_mean.data()),
                         _np(b.running_var.data())))
        assert not np.allclose(seen[0][0], rm0)
        assert not np.allclose(seen[1][0], seen[0][0])
        stats[name] = seen
    for (em, ev), (hm, hv), (jm, jv) in zip(stats["eager"], stats["hybrid"],
                                            stats["jax"]):
        _same(hm, em)
        _same(hv, ev)
        np.testing.assert_allclose(hm, jm, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(hv, jv, rtol=TOL, atol=TOL)


# BERT at test_torch_bert.py's CPU size
BERT_CFG = dict(vocab_size=1000, dropout=0.0, num_layers=2, units=64,
                hidden_size=128, num_heads=4, max_length=64,
                use_pooler=False, use_classifier=False)


def _check_layer_grads(got, want, tol):
    """Each gradient within ``tol`` of the largest |grad| of its layer."""
    assert sorted(got) == sorted(want)
    layer_max = {}
    for k, g in want.items():
        layer = k.rsplit("_", 1)[0]
        layer_max[layer] = max(layer_max.get(layer, 0.0), np.abs(g).max())
    for k in want:
        err = np.abs(got[k] - want[k]).max()
        assert err <= tol * layer_max[k.rsplit("_", 1)[0]], (k, err)


def test_bert_two_layers_hybridized_matches_jax():
    """A 2-layer BERT hybridized in both packages from the same weights:
    one recorded forward + backward, loss within 1e-5 relative and every
    gradient within 1e-5 of its layer's largest; the port's hybridized
    run equals its eager run bit for bit."""
    jnet = jbert.get_bert_model("bert_12_768_12", **BERT_CFG)
    jnet.initialize(init=jmx.initializer.Normal(0.02))
    rs = np.random.RandomState(0)
    x = rs.randint(0, 1000, (2, 16))
    y = rs.randint(0, 1000, (2, 16)).astype(np.float32)
    jnet(jmx.nd.array(x, dtype="int32"))
    weights = {k.replace(jnet.prefix, "bertmodel0_", 1): _np(p.data())
               for k, p in jnet.collect_params().items()}
    tnets = []
    for _ in range(2):
        reset_names()
        t = mx.models.get_bert_model("bert_12_768_12", **BERT_CFG)
        t.initialize(init=mx.initializer.Normal(0.02), **KW)
        t(mx.nd.array(x, dtype="int32", **KW))
        load_numpy(t.collect_params(), weights)
        tnets.append(t)
    jnet.hybridize()
    tnets[1].hybridize()

    def run(m, net, kw):
        sce = m.gluon.loss.SoftmaxCrossEntropyLoss()
        with m.autograd.record():
            loss = sce(net(m.nd.array(x, dtype="int32", **kw))[-1],
                       m.nd.array(y, **kw))
        loss.backward()
        return float(_np(loss).mean()), {
            k.replace(net.prefix, "bertmodel0_", 1): _np(p.grad())
            for k, p in net.collect_params().items()
            if p.grad_req != "null"}

    jloss, jgrads = run(jmx, jnet, {})
    eloss, egrads = run(mx, tnets[0], KW)
    hloss, hgrads = run(mx, tnets[1], KW)
    assert hloss == eloss
    _same(hgrads, egrads)
    assert abs(hloss - jloss) <= 1e-5 * abs(jloss)
    _check_layer_grads(hgrads, jgrads, 1e-5)
    (entry,) = _entries(tnets[1]).values()
    assert entry.recording


def _resnet(m):
    vision = m.gluon.model_zoo.vision
    return vision.ResNetV1(vision.BottleneckV1, [1, 1, 1, 1],
                           [8, 16, 32, 64, 128], classes=10,
                           prefix="resnetv10_")


def test_resnet_optimize_for_hybridized_matches_jax():
    """A small ResNetV1 through ``optimize_for("tpu_fused_conv_bn")``,
    hybridized in both packages from the same weights: two recorded
    steps with an SGD update between, the losses and the running
    statistics within 1e-4 relative; the port's hybridized run equals its
    eager run bit for bit."""
    rs = np.random.RandomState(1)
    x = rs.rand(2, 3, 64, 64).astype(np.float32)
    y = rs.randint(0, 10, (2,)).astype(np.float32)
    np.random.seed(0)
    jnet = _resnet(jmx)
    jnet.initialize(init=jmx.initializer.Xavier())
    jnet(jmx.nd.array(x))
    weights = _values(jnet)
    tnets = []
    for _ in range(2):
        t = _resnet(mx)
        t.initialize(**KW)
        t(mx.nd.array(x[:1], **KW))
        load_numpy(t.collect_params(), weights)
        tnets.append(t)
    jcall = jnet.optimize_for(backend="tpu_fused_conv_bn")
    ecall, hcall = (t.optimize_for(backend="tpu_fused_conv_bn")
                    for t in tnets)
    jcall.hybridize()
    hcall.hybridize()

    def run(m, call, net, kw):
        sce = m.gluon.loss.SoftmaxCrossEntropyLoss()
        trainer = m.gluon.Trainer(net.collect_params(), "sgd",
                                  {"learning_rate": 0.005, "momentum": 0.9,
                                   "wd": 1e-4})
        losses = []
        for _ in range(2):
            with m.autograd.record():
                loss = sce(call(m.nd.array(x, **kw)), m.nd.array(y, **kw))
            loss.backward()
            trainer.step(len(x))
            losses.append(_np(loss))
        return np.stack(losses), {k: v for k, v in _values(net).items()
                                  if "running" in k}

    jl, jstats = run(jmx, jcall, jnet, {})
    el, estats = run(mx, ecall, tnets[0], KW)
    hl, hstats = run(mx, hcall, tnets[1], KW)
    _same(hl, el)
    _same(hstats, estats)
    np.testing.assert_allclose(hl, jl, rtol=1e-4)
    assert sorted(hstats) == sorted(jstats)
    for k in jstats:
        scale = max(np.abs(jstats[k]).max(), 1e-30)
        assert np.abs(hstats[k] - jstats[k]).max() <= 1e-4 * scale, k
    (entry,) = _entries(tnets[1]).values()
    assert entry.recording


# ---------------------------------------------------------------------------
# the cache: one entry, hits, retrace causes, the wobble budget
# ---------------------------------------------------------------------------

def test_exactly_one_entry_then_hits():
    """test_observability.py::test_cachedop_exactly_one_compile_then_hits:
    five calls of one signature build one entry; the other four hit it."""
    x = RS.randn(2, 8).astype(np.float32)
    net = _fresh(_mlp, x)
    net.hybridize()
    built = []
    init = tblock._Entry.__init__

    def counting(self, *a, **k):
        built.append(self)
        init(self, *a, **k)

    tblock._Entry.__init__ = counting
    try:
        for _ in range(5):
            net(mx.nd.array(x, **KW))
    finally:
        tblock._Entry.__init__ = init
    assert len(built) == 1
    assert list(_entries(net).values()) == built
    assert net._cached_graph.retrace_causes == []


class _Arity:
    """A block of one or two inputs, in either package."""

    @staticmethod
    def make(m):
        class Arity(m.gluon.HybridBlock):
            def hybrid_forward(self, F, x, y=None):
                return x * 2 if y is None else x * y

        return Arity()


def _dense(m):
    return m.gluon.nn.Dense(4, in_units=8)


def _tanh(m):
    return m.gluon.nn.Activation("tanh")


def _calls_shape(m, net, kw):
    net(m.nd.array(np.ones((2, 8)), **kw))
    net(m.nd.array(np.ones((3, 8)), **kw))


def _calls_dtype(m, net, kw):
    net(m.nd.array(np.ones((2, 8)), **kw))
    net(m.nd.array(np.ones((2, 8)), dtype="float16", **kw))


def _calls_arity(m, net, kw):
    net(m.nd.array(np.ones((2, 8)), **kw))
    net(m.nd.array(np.ones((2, 8)), **kw), m.nd.array(np.ones((2, 8)), **kw))


def _calls_training(m, net, kw):
    with m.autograd.predict_mode():
        net(m.nd.array(np.ones((2, 8)), **kw))
    with m.autograd.train_mode():
        net(m.nd.array(np.ones((2, 8)), **kw))


def _calls_recording(m, net, kw):
    net(m.nd.array(np.ones((2, 8)), **kw))
    with m.autograd.record(train_mode=False):
        net(m.nd.array(np.ones((2, 8)), **kw))


def _calls_tracked(m, net, kw):
    with m.autograd.record():
        net(m.nd.array(np.ones((2, 8)), **kw))
    xa = m.nd.array(np.ones((2, 8)), **kw)
    xa.attach_grad()
    with m.autograd.record():
        net(xa)


def _calls_fused(m, net, kw):
    with m.autograd.record():
        net(m.nd.array(np.ones((2, 8)), **kw))
    prev = m.fusedstep.set_enabled(False)
    try:
        with m.autograd.record():
            net(m.nd.array(np.ones((2, 8)), **kw))
    finally:
        m.fusedstep.set_enabled(prev)


RETRACES = {
    "shape": (_dense, _calls_shape),
    "dtype": (_tanh, _calls_dtype),
    "arity": (_Arity.make, _calls_arity),
    "training": (_dense, _calls_training),
    "recording": (_dense, _calls_recording),
    "inputs_tracked": (_dense, _calls_tracked),
    "fused_step": (_dense, _calls_fused),
}


@pytest.mark.parametrize("cause", list(RETRACES))
def test_retrace_cause_named_as_jax(cause):
    """Each key field that changes between two calls names the second
    capture's cause as the JAX package's ``_retrace_cause`` names it (read
    from its ``mxtpu_cachedop_retrace_total`` labels)."""
    factory, calls = RETRACES[cause]
    tnet = factory(mx)
    tnet.initialize(**KW)
    tnet.hybridize()
    calls(mx, tnet, KW)
    (got,) = tnet._cached_graph.retrace_causes
    assert cause in got.split("+")
    assert len(_entries(tnet)) == 2
    jnet = factory(jmx)
    jnet.initialize()
    jnet.hybridize()
    prev = jobs.set_enabled(True)
    try:
        jobs.reset()
        calls(jmx, jnet, {})
        labels = [ls.get("cause")
                  for ls in jobs.CACHEDOP_RETRACE_TOTAL.labelsets()]
    finally:
        jobs.set_enabled(prev)
        jobs.reset()
    assert labels == [got]


def test_shape_wobble_budget_warns_once(monkeypatch, caplog):
    """test_input_pipeline.py:328: over MXTPU_RETRACE_BUDGET distinct
    shapes, one warning per block."""
    monkeypatch.setenv("MXTPU_RETRACE_BUDGET", "2")
    net = _dense(mx)
    net.initialize(**KW)
    net.hybridize()
    with caplog.at_level(logging.WARNING,
                         logger="mxnet_tpu_torch.gluon.block"):
        for bsz in (1, 2, 3, 4):
            net(mx.nd.ones((bsz, 8), **KW))
    warns = [r for r in caplog.records if "shape_wobble" in r.message]
    assert len(warns) == 1
    assert net._cached_graph.retrace_causes == ["shape"] * 3


def test_shape_wobble_budget_zero_disables(monkeypatch, caplog):
    """test_input_pipeline.py:348: budget 0 never warns."""
    monkeypatch.setenv("MXTPU_RETRACE_BUDGET", "0")
    assert fusedstep.retrace_budget() == 0
    net = _dense(mx)
    net.initialize(**KW)
    net.hybridize()
    with caplog.at_level(logging.WARNING,
                         logger="mxnet_tpu_torch.gluon.block"):
        for bsz in (1, 2, 3, 4):
            net(mx.nd.ones((bsz, 8), **KW))
    assert not [r for r in caplog.records if "shape_wobble" in r.message]


def test_retrace_budget_default(monkeypatch):
    monkeypatch.delenv("MXTPU_RETRACE_BUDGET", raising=False)
    assert fusedstep.retrace_budget() == 8


def test_flat_arguments_only_and_deferred_first_call_run_eagerly():
    """The eager routes are the JAX package's: the first call of a block
    with deferred shapes, and arguments that are not flat. Non-NDArray
    arguments are baked into the entry at its first call."""
    net = _mlp(mx)
    net.initialize(**KW)
    net.hybridize()
    net(mx.nd.ones((2, 5), **KW))  # resolves the deferred shapes
    assert net._cached_graph._cache == {}
    net(mx.nd.ones((2, 5), **KW))
    assert len(_entries(net)) == 1

    class Scaled(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, x, scale=None):
            return x if scale is None else x * scale

    s = Scaled()
    s.initialize(**KW)
    s.hybridize()
    np.testing.assert_array_equal(_np(s(mx.nd.ones((2,), **KW), 3.0)),
                                  [3.0, 3.0])
    # 3.0 is baked in: the same key with 5.0 replays the first value
    np.testing.assert_array_equal(_np(s(mx.nd.ones((2,), **KW), 5.0)),
                                  [3.0, 3.0])
    assert len(_entries(s)) == 1

    class Summed(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, xs):
            return xs[0] + xs[1]

    t = Summed()
    t.initialize(**KW)
    t.hybridize()
    out = t([mx.nd.ones((2,), **KW), mx.nd.ones((2,), **KW)])
    np.testing.assert_array_equal(_np(out), [2.0, 2.0])
    assert t._cached_graph._cache == {}


# ---------------------------------------------------------------------------
# the recording paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False], ids=["shared", "legacy"])
def test_retain_graph_second_backward_same_gradients(fused):
    """test_fused_step.py::test_retain_graph_backward_after_donation: a
    second backward of one recorded call (``retain_graph=True`` on the
    first) gives the same gradients, on both recording paths, with an
    input gradient too."""
    x = RS.randn(3, 6).astype(np.float32)
    net = _fresh(_conv_free_stack, x)
    net.hybridize()
    prev = fusedstep.set_enabled(fused)
    try:
        xa = mx.nd.array(x, **KW)
        xa.attach_grad()
        with mx.autograd.record():
            loss = (net(xa) ** 2).sum()
        loss.backward(retain_graph=True)
        first = ({k: _np(p.grad()) for k, p in
                  net.collect_params().items()}, _np(xa.grad))
        loss.backward()
        second = ({k: _np(p.grad()) for k, p in
                   net.collect_params().items()}, _np(xa.grad))
    finally:
        fusedstep.set_enabled(prev)
    _same(first[0], second[0])
    _same(first[1], second[1])
    assert np.abs(first[1]).max() > 0


def _conv_free_stack(m):
    nn = m.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(8, flatten=False), nn.GELU(), nn.LayerNorm(),
                nn.Dense(3, flatten=False))
    return net


def _dropout_bn(m):
    nn = m.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(16), nn.BatchNorm(), nn.Activation("relu"),
                nn.Dropout(0.5), nn.Dense(3))
    return net


def test_legacy_path_equals_shared_path_and_eager():
    """``MXTPU_FUSED_STEP=0`` selects the legacy entry, whose backward runs
    the forward again: over a BatchNorm and a dropout of 0.5, from one
    torch seed, its outputs, input and parameter gradients and running
    statistics equal the shared-residual entry's and the eager path's bit
    for bit (the recompute reads the running statistics and the random
    state the forward found, so the statistics move once per call and the
    masks match)."""
    x = RS.randn(6, 5).astype(np.float32)
    base = _fresh(_dropout_bn, x)
    runs = []
    for hyb, fused in ((False, True), (True, True), (True, False)):
        net = _dropout_bn(mx)
        net.initialize(**KW)
        net(mx.nd.array(x, **KW))
        _copy_weights(base, net)
        if hyb:
            net.hybridize()
        prev = fusedstep.set_enabled(fused)
        try:
            torch.manual_seed(3)
            res = [_fwd_bwd(mx, net, x, KW, attach=True) for _ in range(2)]
        finally:
            fusedstep.set_enabled(prev)
        runs.append((res, _values(net)))
        if hyb:
            (key,) = _entries(net)
            assert key[4] is fused
    for (res, vals) in runs[1:]:
        for (o, xg, g), (eo, exg, eg) in zip(res, runs[0][0]):
            _same(o, eo)
            _same(xg, exg)
            _same(g, eg)
        _same(vals, runs[0][1])


# ---------------------------------------------------------------------------
# robustness
# ---------------------------------------------------------------------------

def test_second_forward_before_backward_gives_eager_gradients():
    """A block called twice inside one record() (the second call before
    the first one's backward): the gradients of a loss over both outputs
    equal the eager path's."""
    xs = [RS.randn(3, 6).astype(np.float32) for _ in range(2)]
    base = _fresh(_conv_free_stack, xs[0])
    got = []
    for hyb in (False, True):
        net = _conv_free_stack(mx)
        net.initialize(**KW)
        net(mx.nd.array(xs[0], **KW))
        _copy_weights(base, net)
        if hyb:
            net.hybridize()
        with mx.autograd.record():
            a = net(mx.nd.array(xs[0], **KW))
            b = net(mx.nd.array(xs[1], **KW))
            loss = (a * a).sum() + (b * b * b).sum()
        loss.backward()
        got.append({k: _np(p.grad()) for k, p in
                    net.collect_params().items()})
    _same(got[1], got[0])


def test_exception_inside_hybridized_block_leaves_it_usable():
    """test_exc_handling.py::test_exception_inside_hybridized_block: an
    error in the forward reaches the caller, every parameter handle keeps
    its tensor, nothing is cached, and the next call works."""

    class Bad(mx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.dense = mx.gluon.nn.Dense(4, in_units=2)
            self.fail = True

        def hybrid_forward(self, F, x):
            if self.fail:
                return F.reshape(x, shape=(999, 999))  # invalid reshape
            return self.dense(x)

    b = Bad()
    b.initialize(**KW)
    b.hybridize()
    tensors = [p.data()._t for p in b.collect_params().values()]
    with pytest.raises(Exception):
        b(mx.nd.ones((2, 2), **KW))
    with pytest.raises(Exception):
        with mx.autograd.record():
            b(mx.nd.ones((2, 2), **KW))
    assert [p.data()._t for p in b.collect_params().values()] == tensors
    assert not tblock._in_cached_trace()
    assert b._cached_graph._cache == {}
    b.fail = False
    assert b(mx.nd.ones((2, 2), **KW)).shape == (2, 4)


@pytest.mark.parametrize("how", ["cast", "reinit"])
def test_swapped_parameter_recaptures(how):
    """A ``cast`` (new tensors behind the same handles) or a forced
    re-initialisation (new handles) recaptures, cause ``params``, instead
    of replaying the old tensors: outputs and gradients follow the new
    ones, as the eager path's do."""
    x = RS.randn(3, 6).astype(np.float32)
    nets = [_fresh(_conv_free_stack, x) for _ in range(2)]
    nets[1].hybridize()
    for net in nets:
        _fwd_bwd(mx, net, x, KW)
    for i, net in enumerate(nets):
        if how == "cast":
            net.cast("float32")
        else:
            torch.manual_seed(9)
            net.collect_params().initialize(init=mx.initializer.Xavier(),
                                            force_reinit=True, **KW)
    eager, hyb = (_fwd_bwd(mx, net, x, KW) for net in nets)
    _same(hyb[0], eager[0])
    _same(hyb[2], eager[2])
    assert nets[1]._cached_graph.retrace_causes == ["params"]
    assert len(_entries(nets[1])) == 1


OPTIMIZERS = sorted(mx.optimizer.optimizer._REGISTRY)


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_every_optimizer_hybridized_matches_eager(name):
    """Every optimizer of the port's registry, 2 Trainer steps, on a
    hybridized net and on an eager one from the same weights and seed:
    weights within 1e-6, and the update writes in place (each handle
    keeps its tensor), which a captured graph needs."""
    x = RS.randn(4, 6).astype(np.float32)
    y = np.array([0, 1, 2, 1], np.float32)
    base = _fresh(_mlp, x)
    out = []
    for hyb in (False, True):
        net = _mlp(mx)
        net.initialize(**KW)
        net(mx.nd.array(x, **KW))
        _copy_weights(base, net)
        if hyb:
            net.hybridize()
        tensors = [p.data()._t for p in net.collect_params().values()]
        trainer = mx.gluon.Trainer(net.collect_params(), name,
                                   {"learning_rate": 0.01})
        sce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        torch.manual_seed(5)
        for _ in range(2):
            with mx.autograd.record():
                loss = sce(net(mx.nd.array(x, **KW)), mx.nd.array(y, **KW))
            loss.backward()
            trainer.step(len(x))
        assert [p.data()._t for p in
                net.collect_params().values()] == tensors
        out.append(_values(net))
    for (k, want), got in zip(out[0].items(), out[1].values()):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    assert any(not np.array_equal(v, _np(p.data())) for v, p in
               zip(out[0].values(), base.collect_params().values()))


def test_spmd_train_step_on_hybridized_net_matches_eager():
    """``SPMDTrainStep(mesh=None)`` binds its own parameter copies into the
    handles; inside its step a hybridized block runs eagerly (the trace
    flag), so the loss trajectory over 3 Adam steps equals the eager
    net's, and no cached graph is built."""
    from mxnet_tpu_torch.parallel import SPMDTrainStep

    x = RS.randn(4, 6).astype(np.float32)
    y = np.array([0, 1, 2, 1], np.float32)
    base = _fresh(_dropout_free_bn, x)
    losses = []
    for hyb in (False, True):
        net = _dropout_free_bn(mx)
        net.initialize(**KW)
        net(mx.nd.array(x, **KW))
        _copy_weights(base, net)
        if hyb:
            net.hybridize()
        step = SPMDTrainStep(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                             "adam", {"learning_rate": 0.01}, mesh=None)
        losses.append([step(mx.nd.array(x, **KW), mx.nd.array(y, **KW))
                       for _ in range(3)])
        if hyb:
            assert net._cached_graph is None
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)
    assert losses[0][2] < losses[0][0]


def _dropout_free_bn(m):
    nn = m.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(16), nn.BatchNorm(), nn.Activation("relu"),
                nn.Dense(3))
    return net


# ---------------------------------------------------------------------------
# on the card: the same cases with captured CUDA graphs
# ---------------------------------------------------------------------------

def _rel(a, b):
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


def _close_dicts(got, want, tol=1e-6):
    """Dicts in the same parameter order (names may differ in counters)."""
    assert [re.sub(r"\d+_", "_", k) for k in got] == \
        [re.sub(r"\d+_", "_", k) for k in want]
    for (k, w), g in zip(want.items(), got.values()):
        assert _rel(g, w) <= tol, (k, _rel(g, w))


def _twin(factory, x, kw):
    base = _fresh(factory, x, kw)
    net = factory(mx)
    net.initialize(**kw)
    net(mx.nd.array(x, **kw))
    _copy_weights(base, net)
    net.hybridize()
    return base, net


def test_captured_matches_eager_on_cuda():
    """Captured forward and backward over Conv2D + BatchNorm: three
    recorded calls give the eager outputs, gradients and running
    statistics (1e-6), the entry is captured, and a predict call makes a
    second, forward-only entry."""
    kw = _cuda()
    x = RS.rand(4, 3, 8, 8).astype(np.float32)
    eager, hyb = _twin(_conv_block, x, kw)
    for _ in range(3):
        e, h = _fwd_bwd(mx, eager, x, kw), _fwd_bwd(mx, hyb, x, kw)
        assert _rel(h[0], e[0]) <= 1e-6
        _close_dicts(h[2], e[2])
        _close_dicts(_values(hyb), _values(eager))
    (entry,) = _entries(hyb).values()
    assert entry.graphed and entry.recording and entry.gen == 3
    out = _np(hyb(mx.nd.array(x, **kw)))
    assert _rel(out, _np(eager(mx.nd.array(x, **kw)))) <= 1e-6
    assert len(_entries(hyb)) == 2


def test_outputs_are_fresh_on_cuda():
    """An output held from one replay does not change at the next."""
    kw = _cuda()
    x = RS.randn(4, 6).astype(np.float32)
    _, net = _twin(_mlp, x, kw)
    a = net(mx.nd.array(x, **kw))
    held = _np(a)
    net(mx.nd.array(x * 2, **kw))
    np.testing.assert_array_equal(_np(a), held)


@pytest.mark.parametrize("fused", [True, False], ids=["shared", "legacy"])
def test_retain_graph_and_legacy_on_cuda(fused):
    """Both recording paths captured: a retain_graph second backward
    replays the backward graph to the same gradients, equal to the
    eager path's (1e-6)."""
    kw = _cuda()
    x = RS.randn(3, 6).astype(np.float32)
    eager, hyb = _twin(_conv_free_stack, x, kw)
    prev = fusedstep.set_enabled(fused)
    try:
        grads = []
        for net, passes in ((eager, 1), (hyb, 2)):
            xa = mx.nd.array(x, **kw)
            xa.attach_grad()
            with mx.autograd.record():
                loss = (net(xa) ** 2).sum()
            for i in range(passes):
                loss.backward(retain_graph=i + 1 < passes)
                grads.append(({k: _np(p.grad()) for k, p in
                               net.collect_params().items()},
                              _np(xa.grad)))
    finally:
        fusedstep.set_enabled(prev)
    _same(grads[1][0], grads[2][0])
    _close_dicts(grads[1][0], grads[0][0])
    assert _rel(grads[1][1], grads[0][1]) <= 1e-6
    (entry,) = _entries(hyb).values()
    assert entry.graphed and entry.legacy is (not fused)


def test_second_forward_before_backward_on_cuda(caplog):
    """The second recorded call before the first one's backward runs
    uncaptured, logged once through the fused step's fallback funnel, and
    the gradients equal the eager path's (1e-6)."""
    kw = _cuda()
    xs = [RS.randn(3, 6).astype(np.float32) for _ in range(2)]
    eager, hyb = _twin(_conv_free_stack, xs[0], kw)
    fusedstep.reset_fallback_log()
    got = []
    with caplog.at_level(logging.WARNING,
                         logger="mxnet_tpu_torch.fusedstep"):
        for net in (eager, hyb):
            with mx.autograd.record():
                a = net(mx.nd.array(xs[0], **kw))
                b = net(mx.nd.array(xs[1], **kw))
                loss = (a * a).sum() + (b * b * b).sum()
            loss.backward()
            got.append({k: _np(p.grad()) for k, p in
                        net.collect_params().items()})
    _close_dicts(got[1], got[0])
    assert len([r for r in caplog.records
                if "called again under record()" in r.message]) == 1


def test_capture_failure_raises_on_cuda():
    """An operation that synchronises with the host inside a capture
    raises MXNetError; nothing is cached, the default generator still
    draws, and the block runs eagerly once un-hybridized."""
    kw = _cuda()

    class Syncs(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return x * float(x.data.sum().item())

    b = Syncs()
    b.initialize(**kw)
    b.hybridize()
    with pytest.raises(MXNetError, match="CUDA graph"):
        b(mx.nd.ones((2, 2), **kw))
    assert not tblock._in_cached_trace()
    assert b._cached_graph._cache == {}
    # the default generator left capture mode: random draws still work
    assert torch.rand(4, device="cuda").shape == (4,)
    b.hybridize(False)
    np.testing.assert_array_equal(_np(b(mx.nd.ones((2, 2), **kw))),
                                  np.full((2, 2), 4.0))


def test_cast_recaptures_on_cuda():
    """A cast recaptures (cause ``params``) and the replay follows the new
    tensors: outputs and gradients equal the eager net's (1e-6)."""
    kw = _cuda()
    x = RS.randn(3, 6).astype(np.float32)
    eager, hyb = _twin(_conv_free_stack, x, kw)
    for net in (eager, hyb):
        _fwd_bwd(mx, net, x, kw)
        net.cast("float32")
    e, h = _fwd_bwd(mx, eager, x, kw), _fwd_bwd(mx, hyb, x, kw)
    assert _rel(h[0], e[0]) <= 1e-6
    _close_dicts(h[2], e[2])
    assert hyb._cached_graph.retrace_causes == ["params"]


@pytest.mark.parametrize("name", ["sgd", "adam", "lamb", "rmsprop"])
def test_optimizers_on_cuda(name):
    """Two Trainer steps on a captured net against the eager net (weights
    1e-6)."""
    kw = _cuda()
    x = RS.randn(4, 6).astype(np.float32)
    y = np.array([0, 1, 2, 1], np.float32)
    eager, hyb = _twin(_mlp, x, kw)
    vals = []
    for net in (eager, hyb):
        trainer = mx.gluon.Trainer(net.collect_params(), name,
                                   {"learning_rate": 0.01})
        sce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        for _ in range(2):
            with mx.autograd.record():
                loss = sce(net(mx.nd.array(x, **kw)), mx.nd.array(y, **kw))
            loss.backward()
            trainer.step(len(x))
        vals.append(_values(net))
    _close_dicts(vals[1], vals[0])


def test_launch_accounting_on_cuda():
    """K1 and K2 inside a captured 2-layer BERT: each replay adds the
    launches its capture recorded (one K1 per layer per forward, one of
    each K2 kernel per layer per backward), and only then."""
    kw = _cuda()
    reset_names()
    net = mx.models.get_bert_model("bert_12_768_12", **BERT_CFG)
    net.initialize(init=mx.initializer.Normal(0.02), **kw)
    x = mx.nd.array(RS.randint(0, 1000, (2, 16)), dtype="int32", **kw)
    net(x)
    net.hybridize()
    with mx.autograd.record():
        loss = net(x)[-1].sum()
    loss.backward()  # warm-up, capture and the first replay
    torch.cuda.synchronize()
    _kernels.LAUNCHES.clear()
    for _ in range(3):
        with mx.autograd.record():
            loss = net(x)[-1].sum()
        loss.backward()
    torch.cuda.synchronize()
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert _kernels.LAUNCHES[name] == 2 * 3, name


def test_spmd_train_step_on_cuda():
    """SPMDTrainStep on a hybridized net on the card: the eager net's
    losses over 3 steps (1e-6), nothing captured."""
    kw = _cuda()
    from mxnet_tpu_torch.parallel import SPMDTrainStep

    x = RS.randn(4, 6).astype(np.float32)
    y = np.array([0, 1, 2, 1], np.float32)
    eager, hyb = _twin(_dropout_free_bn, x, kw)
    hyb._cached_graph = None
    losses = []
    for net in (eager, hyb):
        step = SPMDTrainStep(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                             "adam", {"learning_rate": 0.01}, mesh=None)
        losses.append([step(mx.nd.array(x, **kw), mx.nd.array(y, **kw))
                       for _ in range(3)])
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)
    assert hyb._cached_graph is None
