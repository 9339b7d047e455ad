"""Port parity: ``HybridBlock.warmup`` and ``HybridBlock.aot_predict_fn``
of ``mxnet_tpu_torch``.

The four ``test_warmup_*`` cases of ``tests/test_input_pipeline.py`` and
``tests/test_serving.py::test_aot_predict_fn_parity`` replayed on the
port, plus what the port adds: after a warmup every parameter handle,
gradient buffer and optimizer state holds the same tensor object as
before (the cached graph's identity guard and the Trainer's plan depend
on it), the random generators and BatchNorm's running statistics are as
before, and ``aot_predict_fn``'s function records nothing, never touches
a cached graph and puts every handle back when it raises. The
``*_on_cuda`` tests repeat the entry counts with captured CUDA graphs
and capture ``aot_predict_fn``'s function through ``gluon._capture``.

Tolerances: the port against itself (a warmed net against one that was
not, ``aot_predict_fn`` against the eager forward) equal bit for bit;
against the JAX package 1e-5 absolute and relative (float32, the same
weights, sums in other orders).
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn

KW = {"ctx": mx.cpu()}
TOL = 1e-5
FEAT, CLASSES = 6, 4


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return {"ctx": mx.gpu(0)}


def _mlp(ctx_kw=KW, seed=0):
    torch.manual_seed(seed)
    net = nn.HybridSequential()
    net.add(nn.Dense(8, activation="relu", in_units=6),
            nn.Dense(3, in_units=8))
    net.initialize(init=mx.initializer.Xavier(), **ctx_kw)
    net.hybridize()
    return net


def _bn_net(ctx_kw=KW, seed=0, dropout=0.5):
    torch.manual_seed(seed)
    net = nn.HybridSequential()
    net.add(nn.Dense(8, in_units=6), nn.BatchNorm(in_channels=8),
            nn.Dropout(dropout), nn.Dense(3, in_units=8))
    net.initialize(init=mx.initializer.Xavier(), **ctx_kw)
    net.hybridize()
    return net


def _entries(net):
    return len(net._cached_graph._cache) if net._cached_graph else 0


def _tensors(net):
    return [(p.data().data, p.data().grad.data if p.grad_req != "null"
             else None) for p in net.collect_params().values()]


def _same_objects(a, b):
    return all(x is y and g is h for (x, g), (y, h) in zip(a, b))


def _values(net):
    return {k: p.data().data.clone() for k, p in
            net.collect_params().items()}


def test_warmup_builds_inference_entries():
    net = _mlp()
    assert net.warmup([(4, 6), (8, 6)], ctx=mx.cpu()) == 2
    assert _entries(net) == 2
    with autograd.predict_mode():
        net(mx.nd.ones((4, 6), **KW))
        net(mx.nd.ones((8, 6), **KW))
    assert _entries(net) == 2, "warmed shapes must not build again"
    assert net._cached_graph.retrace_causes == ["shape"]


def _batch():
    x = np.random.RandomState(1).randn(4, 6).astype(np.float32)
    y = np.random.RandomState(2).randint(0, 3, (4,)).astype(np.float32)
    return x, y


def _steps(net, trainer, ctx_kw, n=3):
    x, y = _batch()
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    X, Y = mx.nd.array(x, **ctx_kw), mx.nd.array(y, **ctx_kw)
    losses = []
    for _ in range(n):
        with autograd.record():
            loss = loss_fn(net(X), Y)
        loss.backward()
        trainer.step(4)
        losses.append(loss.data.clone())
    return losses


def _warmed_and_plain(make, ctx_kw, opt, params):
    """A net warmed with a full step and 3 steps after it, and a net
    from the same seed that takes the 3 steps without warming up."""
    net = make(ctx_kw)
    tr = gluon.Trainer(net.collect_params(), opt, params, kvstore=None)
    before = _values(net)
    tensors = _tensors(net)
    cuda = ctx_kw["ctx"] != mx.cpu()
    rng = torch.cuda.get_rng_state() if cuda else torch.get_rng_state()
    assert net.warmup([(4, 6), (8, 6)], ctx=ctx_kw["ctx"],
                      loss_fn=gluon.loss.SoftmaxCrossEntropyLoss(),
                      trainer=tr) == 2
    for k, p in net.collect_params().items():
        assert torch.equal(p.data().data, before[k]), k
    assert _same_objects(_tensors(net), tensors)
    assert torch.equal(torch.cuda.get_rng_state() if cuda
                       else torch.get_rng_state(), rng)
    assert not tr._optimizer._index_update_count  # update counts restored
    assert not tr._fused_states                   # momentum restored
    entries = _entries(net)
    losses = _steps(net, tr, ctx_kw)
    assert _entries(net) == entries, "the first real step built an entry"
    assert tr._fused not in (False, None)
    plain = make(ctx_kw)
    ptr = gluon.Trainer(plain.collect_params(), opt, params, kvstore=None)
    plain_losses = _steps(plain, ptr, ctx_kw)
    return net, plain, losses, plain_losses


@pytest.mark.parametrize("make", [_mlp, _bn_net], ids=["mlp", "bn_dropout"])
def test_warmup_full_step_restores_training_state(make):
    net, plain, losses, plain_losses = _warmed_and_plain(
        make, KW, "sgd", {"learning_rate": 0.1, "momentum": 0.9})
    for a, b in zip(losses, plain_losses):
        assert torch.equal(a, b)
    for p, q in zip(net._collect_params_with_prefix().values(),
                    plain._collect_params_with_prefix().values()):
        assert torch.equal(p.data().data, q.data().data), p.name


def test_warmup_then_training_matches_jax():
    """The JAX package's own case: warmup, 3 steps, against its weights
    from the same start."""
    net = _mlp()
    jnet = jmx.gluon.nn.HybridSequential()
    jnet.add(jmx.gluon.nn.Dense(8, activation="relu", in_units=6),
             jmx.gluon.nn.Dense(3, in_units=8))
    jnet.initialize()
    for jp, tp in zip(jnet.collect_params().values(),
                      net.collect_params().values()):
        jp.set_data(jmx.nd.array(tp.data().asnumpy()))
    jnet.hybridize()
    for m, n, kw in ((jmx, jnet, {}), (mx, net, KW)):
        tr = m.gluon.Trainer(n.collect_params(), "sgd",
                             {"learning_rate": 0.1, "momentum": 0.9},
                             kvstore=None)
        assert n.warmup([(4, 6), (8, 6)],
                        loss_fn=m.gluon.loss.SoftmaxCrossEntropyLoss(),
                        trainer=tr, **({} if m is jmx else KW)) == 2
        x, y = _batch()
        X, Y = m.nd.array(x, **kw), m.nd.array(y, **kw)
        for _ in range(3):
            with m.autograd.record():
                loss = m.gluon.loss.SoftmaxCrossEntropyLoss()(n(X), Y)
            loss.backward()
            tr.step(4)
    for jp, tp in zip(jnet.collect_params().values(),
                      net.collect_params().values()):
        np.testing.assert_allclose(tp.data().asnumpy(),
                                   np.array(jp.data().asnumpy()),
                                   rtol=TOL, atol=TOL)


def test_warmup_restores_existing_adam_state_in_place():
    net = _bn_net()
    tr = gluon.Trainer(net.collect_params(), "adam", {"learning_rate": 0.01})
    _steps(net, tr, KW, n=1)
    states = {k: tuple(t.clone() for t in st)
              for k, st in tr._fused_states.items()}
    objects = {k: tuple(st) for k, st in tr._fused_states.items()}
    grads = {k: p.grad().data.clone() for k, p in
             net.collect_params().items() if p.grad_req != "null"}
    stats = {k: p.data().data.clone() for k, p in
             net.collect_params().items() if "running" in k}
    counts = dict(tr._optimizer._index_update_count)
    tensors = _tensors(net)
    assert states and stats
    net.warmup([(4, 6), (8, 6)], ctx=mx.cpu(),
               loss_fn=gluon.loss.SoftmaxCrossEntropyLoss(), trainer=tr)
    assert _same_objects(_tensors(net), tensors)
    assert sorted(tr._fused_states) == sorted(states)
    for k, st in tr._fused_states.items():
        assert all(a is b for a, b in zip(st, objects[k]))
        assert all(torch.equal(a, b) for a, b in zip(st, states[k]))
    for k, g in grads.items():
        assert torch.equal(net.collect_params()[k].grad().data, g)
    for k, s in stats.items():
        assert torch.equal(net.collect_params()[k].data().data, s)
    assert tr._optimizer._index_update_count == counts


def test_warmup_restores_eager_optimizer_state(monkeypatch):
    """On the per-parameter path (``MXTPU_FUSED_STEP=0``) the eager
    ``_opt_state`` is put back too, in place."""
    from mxnet_tpu_torch import fusedstep

    monkeypatch.setattr(fusedstep, "ENABLED", False)
    net = _mlp()
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.1, "momentum": 0.9})
    _steps(net, tr, KW, n=1)
    moms = {k: (p._opt_state, p._opt_state.data.clone())
            for k, p in net.collect_params().items()}
    net.warmup((4, 6), ctx=mx.cpu(),
               loss_fn=gluon.loss.SoftmaxCrossEntropyLoss(), trainer=tr)
    for k, p in net.collect_params().items():
        assert p._opt_state is moms[k][0]
        assert torch.equal(p._opt_state.data, moms[k][1])


def test_warmup_accepts_single_shape_forms():
    net = _mlp()
    assert net.warmup((4, 6), ctx=mx.cpu()) == 1   # bare tuple
    assert net.warmup([4, 6], ctx=mx.cpu()) == 1   # bare list
    assert net.warmup([[4, 6], (8, 6)], ctx=mx.cpu()) == 2
    with pytest.raises(MXNetError, match="requires loss_fn"):
        net.warmup((4, 6), ctx=mx.cpu(), trainer=object())


def test_warmup_resolves_deferred_init():
    net = nn.HybridSequential()
    net.add(nn.Dense(8, activation="relu"), nn.Dense(2))  # deferred shapes
    net.initialize(**KW)
    net.hybridize()
    assert net.warmup([(4, 6)], ctx=mx.cpu()) == 1
    assert net(mx.nd.ones((4, 6), **KW)).shape == (4, 2)


class _RaggedNet(gluon.HybridBlock):
    """``tests/test_serving.py``'s net: (T, FEAT) rows, output
    (CLASSES,)."""

    def __init__(self, m=mx, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.proj = m.gluon.nn.Dense(CLASSES, flatten=False,
                                         in_units=FEAT)

    def hybrid_forward(self, F, x):
        return F.mean(self.proj(x), axis=1)


class _JRaggedNet(jmx.gluon.HybridBlock):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.proj = jmx.gluon.nn.Dense(CLASSES, flatten=False,
                                           in_units=FEAT)

    def hybrid_forward(self, F, x):
        return F.mean(self.proj(x), axis=1)


def test_aot_predict_fn_parity():
    import jax

    jnet = _JRaggedNet()
    jnet.initialize()
    net = _RaggedNet()
    net.initialize(**KW)
    jfn, jparams = jnet.aot_predict_fn(sample_shape=(1, 8, FEAT))
    fn, params = net.aot_predict_fn(ctx=mx.cpu(), sample_shape=(1, 8, FEAT))
    assert len(params) == len(jparams) == 2
    for t, j in zip(params, jparams):
        with torch.no_grad():
            t.copy_(torch.from_numpy(np.array(j)))
    x = np.random.RandomState(0).rand(3, 8, FEAT).astype(np.float32)
    want = np.asarray(jax.jit(jfn)(jparams, x))
    got = fn(params, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    eager = net(mx.nd.array(x, **KW))
    assert torch.equal(got, eager.data)
    assert torch.equal(fn(params, x), got)  # a numpy input


def test_aot_predict_fn_is_pure():
    net = _bn_net()
    net(mx.nd.ones((4, 6), **KW))  # an entry of the cached graph
    with autograd.record():
        net(mx.nd.array(np.random.RandomState(3).randn(4, 6)
                        .astype(np.float32), **KW))
    stats = {k: p.data().data.clone() for k, p in
             net.collect_params().items() if "running" in k}
    fn, params = net.aot_predict_fn(ctx=mx.cpu())
    entries, handles = _entries(net), _tensors(net)
    x = torch.from_numpy(np.random.RandomState(4).randn(5, 6)
                         .astype(np.float32))
    with autograd.record():
        out = fn(params, x)
    assert not out.requires_grad and out.grad_fn is None
    with autograd.predict_mode():
        want = net(mx.nd.array(x.numpy(), **KW))
    assert torch.equal(out, want.data)  # dropout off, running statistics
    for k, s in stats.items():
        assert torch.equal(net.collect_params()[k].data().data, s)
    assert _entries(net) == entries + 1  # the predict call above only
    # other tensors bound in their place; the handles come back
    doubled = [p * 2 for p in params]
    assert not torch.equal(fn(doubled, x), out)
    assert _same_objects(_tensors(net), handles)
    with pytest.raises(RuntimeError):
        fn(params, torch.zeros(5, 7))  # wrong width raises in the forward
    assert _same_objects(_tensors(net), handles)
    from mxnet_tpu_torch.gluon import block

    assert not block._in_cached_trace()


def test_export_raises_naming_the_symbol_layer():
    net = _mlp()
    with pytest.raises(MXNetError, match="A13"):
        net.export("/nonexistent/model")


def test_warmup_entries_on_cuda():
    """Without dropout: a capture draws its own random numbers on the
    card, so a warmed net's dropout masks are not an un-warmed net's."""
    kw = _cuda()
    net, plain, losses, plain_losses = _warmed_and_plain(
        lambda ctx_kw: _bn_net(ctx_kw, dropout=0.0), kw, "adam",
        {"learning_rate": 0.01})
    graph = net._cached_graph
    assert all(e.graphed for e in graph._cache.values())
    for a, b in zip(losses, plain_losses):
        assert torch.equal(a, b)


def test_aot_predict_fn_captured_on_cuda():
    kw = _cuda()
    from mxnet_tpu_torch.gluon import _capture

    net = _bn_net(kw)
    with autograd.record():
        net(mx.nd.array(np.random.RandomState(3).randn(8, 6)
                        .astype(np.float32), **kw))
    fn, params = net.aot_predict_fn()
    for batch in (2, 8):
        x = torch.randn(batch, 6, device="cuda")
        static = x.clone()
        _capture.warm_up(lambda: fn(params, static))
        graph = _capture.Graph(torch.cuda.graph_pool_handle(), "aot fn")
        out = graph.capture(lambda: fn(params, static))
        static.copy_(x)
        graph.replay()
        with autograd.predict_mode():
            want = net(mx.nd.array(x.cpu().numpy(), **kw))
        torch.cuda.synchronize()
        assert torch.equal(out, want.data)


def test_capture_pauses_the_garbage_collector(monkeypatch):
    """A collection during a capture could free a dropped block's graphs
    and their memory pool, which the stream capture refuses: the
    collector is off inside ``_capture.Graph.capture`` and back on after,
    also when the capture fails. Every capture is thread-local (C19)."""
    import gc

    from mxnet_tpu_torch.gluon import _capture

    seen, modes = [], []

    class FakeGraph:
        def __init__(self, graph, pool=None, capture_error_mode="global"):
            modes.append(capture_error_mode)

        def __enter__(self):
            seen.append(gc.isenabled())

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: None)
    monkeypatch.setattr(torch.cuda, "graph", FakeGraph)
    monkeypatch.setattr(_capture, "_release_generator", lambda: None)
    assert gc.isenabled()
    graph = _capture.Graph(None, "a test function")
    assert graph.capture(lambda: 3) == 3
    with pytest.raises(MXNetError, match="a test function"):
        graph.capture(lambda: 1 / 0)
    assert seen == [False, False] and gc.isenabled()
    assert modes == ["thread_local", "thread_local"]


def test_capture_amid_cyclic_garbage_on_cuda():
    """Hybridized nets dropped with their graphs become cyclic garbage;
    with the collector made eager, a later capture still succeeds."""
    import gc

    kw = _cuda()

    def drop_a_captured_net():
        net = _bn_net(kw, dropout=0.0)
        with autograd.record():
            net(mx.nd.ones((4, 6), **kw)).backward()

    threshold = gc.get_threshold()
    try:
        for _ in range(2):
            drop_a_captured_net()
        gc.set_threshold(1, 1, 1)
        net = _bn_net(kw, dropout=0.0)
        with autograd.record():
            out = net(mx.nd.ones((4, 6), **kw))
        out.backward()
        assert net._cached_graph._cache and all(
            e.graphed for e in net._cached_graph._cache.values())
    finally:
        gc.set_threshold(*threshold)
