"""Port parity: ``InferenceEngine`` and ``ContinuousBatcher`` of
``mxnet_tpu_torch.serving`` against the JAX package's, on the CPU.

``tests/test_serving.py``'s cases run through both packages (each case is
parametrised over the package, the same scenario and the same asserts),
and where both compute, their results are held to each other on the same
weights (carried across with ``.params`` or ``set_data``) and the same
seeded inputs: tolerance 1e-5 relative to each output's largest magnitude
(float32; the same math in another order). A small BERT (2 layers, 64
units, 4 heads, vocabulary 100; sequence, pooled and NSP outputs) serves
behind both engines at buckets (8,), (16,), (32,). The port's engine runs
its function eagerly on the CPU (``ctx=mx.cpu()``); the ``*_on_cuda``
tests capture one CUDA graph per bucket and skip without a card.

Left out until their items: ``test_engine_serves_quantized_net`` (int8,
ROADMAP A13) and the telemetry cases ``test_serving_metrics_and_slo_
snapshot`` and ``test_report_serving_section`` (A12).
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import collections
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.observability.metrics import Histogram as JaxHistogram
from mxnet_tpu_torch.observability.metrics import Histogram

FEAT = 6
CLASSES = 4
BUCKETS = [(4, FEAT), (8, FEAT), (16, FEAT)]
TOL = 1e-5
PKGS = ("jax", "torch")


class _Pkg:
    """One package's names for a scenario."""

    def __init__(self, which):
        self.jax = which == "jax"
        self.mx = jmx if self.jax else mx
        self.serving = self.mx.serving
        self.kw = {} if self.jax else {"ctx": mx.cpu()}

    def array(self, a, **kw):
        return self.mx.nd.array(a, **self.kw, **kw)


def _pkg(which):
    return _Pkg(which)


def _ragged_net(p, seed=0):
    """Rows are (T, FEAT) sequences, ragged on T; output (CLASSES,). The
    same weights in both packages for one seed."""
    class Ragged(p.mx.gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.proj = p.mx.gluon.nn.Dense(CLASSES, flatten=False,
                                                in_units=FEAT)

        def hybrid_forward(self, F, x):
            return F.mean(self.proj(x), axis=1)

    net = Ragged()
    net.initialize(**p.kw)
    rs = np.random.RandomState(seed)
    net.proj.weight.set_data(p.array(rs.randn(CLASSES, FEAT)
                                     .astype(np.float32)))
    net.proj.bias.set_data(p.array(rs.randn(CLASSES).astype(np.float32)))
    return net


def _vec_net(p, bias=0.0, feat=8, classes=CLASSES):
    """Fixed-shape net: y = 0.1 * sum(x) + bias per class, so versions are
    told apart by their bias."""
    net = p.mx.gluon.nn.HybridSequential()
    net.add(p.mx.gluon.nn.Dense(classes, in_units=feat))
    net.initialize(**p.kw)
    net[0].weight.set_data(p.mx.nd.ones((classes, feat), **p.kw) * 0.1)
    net[0].bias.set_data(p.mx.nd.ones((classes,), **p.kw) * bias)
    return net


def _engine(p, net=None, shapes=None, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_wait_ms", 20.0)
    return p.serving.InferenceEngine(net or _ragged_net(p), shapes or BUCKETS,
                                     **p.kw, **kw)


def _expect(p, net, row):
    """The net on the bucket-padded row (padding takes part in the mean,
    by design: the bucket is the contract shape)."""
    return np.array(net(p.array(row[None])).asnumpy())[0]


def _rel_close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


# -- satellite units: the latency histogram ---------------------------------

def test_histogram_quantile_equals_the_reference():
    """The registry's ``Histogram`` (which the engines keep their
    latency in) gives exactly the reference's quantiles on the same
    observations."""
    rs = np.random.RandomState(7)
    obs = list(rs.exponential(0.01, 200)) + [0.5, 1.5, 3.0, 100.0]
    for buckets in ((1.0, 2.0, 4.0, 8.0), None):
        h, j = Histogram("t", buckets=buckets), \
            JaxHistogram("t", buckets=buckets)
        assert h.quantile(0.5) is None is j.quantile(0.5)
        for v in obs:
            h.observe(v)
            j.observe(v)
        for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
            assert h.quantile(q) == j.quantile(q)
        assert h.value() == j.value() and h.sum() == j.sum()
        with pytest.raises(mx.MXNetError):
            h.quantile(1.5)
    h = Histogram("t", buckets=(1.0, 2.0, 4.0, 8.0))
    h.observe(100.0)  # beyond the last finite bucket: clamps, no inf
    assert h.quantile(1.0) == 8.0


# -- the AOT hook ------------------------------------------------------------

def test_aot_predict_fn_parity():
    import jax

    jnet, net = _ragged_net(_pkg("jax")), _ragged_net(_pkg("torch"))
    jfn, jparams = jnet.aot_predict_fn(sample_shape=(1, 8, FEAT))
    fn, params = net.aot_predict_fn(ctx=mx.cpu(), sample_shape=(1, 8, FEAT))
    x = np.random.RandomState(0).rand(3, 8, FEAT).astype(np.float32)
    want = np.asarray(jax.jit(jfn)(jparams, x))
    _rel_close(fn(params, torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("pkg", PKGS)
def test_aot_predict_fn_required(pkg):
    p = _pkg(pkg)
    with pytest.raises(p.mx.base.MXNetError, match="aot_predict_fn"):
        p.serving.InferenceEngine(object(), BUCKETS, **p.kw)


# -- engine: buckets, parity, the sealed contract ----------------------------

RAGGED_T = [1, 3, 4, 5, 8, 9, 16, 2, 13]


def _ragged_traffic(p):
    from importlib import import_module

    pad = import_module(f"{p.mx.__name__}.gluon.data.shape_guard") \
        .pad_to_shape
    net = _ragged_net(p)
    eng = _engine(p, net)
    outs = []
    try:
        assert eng.sealed and eng.stats()["compiles"] == len(BUCKETS)
        rng = np.random.RandomState(1)
        for t in RAGGED_T:
            row = rng.rand(t, FEAT).astype(np.float32)
            bucket = eng._bucket_for(row.shape)
            padded_row = pad(row[None], (1,) + bucket)[0]
            out = eng.predict(row, timeout=10.0)
            assert out.shape == (1, CLASSES)
            np.testing.assert_allclose(out[0], _expect(p, net, padded_row),
                                       rtol=TOL, atol=TOL)
            outs.append(out)
        st = eng.stats()
        assert st["compiles"] == len(BUCKETS)  # FLAT after warmup
        assert st["retraces_after_warmup"] == 0
        assert st["requests_ok"] == len(RAGGED_T)
        assert st["latency_p50_ms"] is not None
    finally:
        eng.close()
    return outs


def test_engine_parity_and_zero_recompiles():
    """Ragged traffic through both engines: each answers its own net's
    forward on the padded row, the compiles stay flat, and the two
    packages agree."""
    jouts, touts = _ragged_traffic(_pkg("jax")), _ragged_traffic(
        _pkg("torch"))
    for t, j in zip(touts, jouts):
        _rel_close(t, j)


@pytest.mark.parametrize("pkg", PKGS)
def test_engine_micro_batch_rows(pkg):
    p = _pkg(pkg)
    net = _ragged_net(p)
    eng = _engine(p, net)
    try:
        x = np.random.RandomState(2).rand(3, 4, FEAT).astype(np.float32)
        out = eng.predict(x, timeout=10.0)
        assert out.shape == (3, CLASSES)  # exactly the request's rows
        for i in range(3):
            np.testing.assert_allclose(out[i], _expect(p, net, x[i]),
                                       rtol=TOL, atol=TOL)
    finally:
        eng.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_engine_refuses_unbucketable_shape(pkg):
    p = _pkg(pkg)
    eng = _engine(p)
    try:
        with pytest.raises(p.serving.RetraceForbidden, match="shape"):
            eng.submit(np.zeros((40, FEAT), np.float32))
        with pytest.raises(p.serving.RetraceForbidden):
            eng.submit(np.zeros((2, 3, 4, 5), np.float32))  # bad rank
        assert eng.stats()["refused"] == 2
        assert eng.stats()["compiles"] == len(BUCKETS)  # refused != traced
    finally:
        eng.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_engine_refuses_dtype_with_cast_off(pkg):
    p = _pkg(pkg)
    eng = _engine(p)
    try:
        x = np.zeros((4, FEAT), np.int32)
        with pytest.raises(p.serving.RetraceForbidden, match="dtype"):
            eng.submit(x, cast=False)
        out = eng.predict(x, timeout=10.0)  # the default casts instead
        assert out.shape == (1, CLASSES)
    finally:
        eng.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_engine_oversized_request_typed(pkg):
    p = _pkg(pkg)
    eng = _engine(p, max_batch=4)
    try:
        with pytest.raises(p.serving.RequestTooLarge,
                           match="split it client-side"):
            eng.submit(np.zeros((5, 4, FEAT), np.float32))
    finally:
        eng.close()


# -- continuous batching -----------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_batching_coalesces_requests(pkg):
    p = _pkg(pkg)
    eng = _engine(p, max_batch=4, max_wait_ms=100.0)
    try:
        x = np.zeros((4, FEAT), np.float32)
        futs = [eng.submit(x) for _ in range(4)]
        for f in futs:
            assert f.result(timeout=10.0).shape == (1, CLASSES)
        st = eng.stats()
        assert st["requests_ok"] == 4
        assert st["batches"] <= 2  # coalesced, not one dispatch each
        assert st["mean_batch_fill"] >= 0.5
    finally:
        eng.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_deadline_expires_as_typed_timeout(pkg):
    p = _pkg(pkg)
    # autostart=False holds the scheduler so the expiry is deterministic
    eng = _engine(p, autostart=False)
    try:
        fut = eng.submit(np.zeros((4, FEAT), np.float32), deadline_ms=1.0)
        time.sleep(0.03)
        eng._batcher.start()
        with pytest.raises(p.serving.RequestTimeout, match="deadline expired"):
            fut.result(timeout=10.0)
        assert eng.stats()["timeouts"] == 1
    finally:
        eng.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_full_queue_sheds_typed(pkg):
    p = _pkg(pkg)
    eng = _engine(p, autostart=False, queue_cap=2)
    x = np.zeros((4, FEAT), np.float32)
    accepted = [eng.submit(x), eng.submit(x)]
    with pytest.raises(p.serving.ServerOverloaded, match="load shed"):
        eng.submit(x)
    assert eng.stats()["shed"] == 1
    eng.close()  # the scheduler never ran: accepted work fails typed
    for f in accepted:
        with pytest.raises(p.serving.EngineClosed):
            f.result(timeout=10.0)


@pytest.mark.parametrize("pkg", PKGS)
def test_close_drains_inflight(pkg):
    p = _pkg(pkg)
    net = _ragged_net(p)
    eng = _engine(p, net, max_wait_ms=200.0)  # long window: work queues
    x = np.random.RandomState(3).rand(4, FEAT).astype(np.float32)
    futs = [eng.submit(x) for _ in range(5)]
    eng.close()  # accepted work completes
    for f in futs:
        out = f.result(timeout=10.0)
        np.testing.assert_allclose(out[0], _expect(p, net, x), rtol=TOL,
                                   atol=TOL)
    with pytest.raises(p.serving.EngineClosed):
        eng.submit(x)
    eng.close()  # idempotent


@pytest.mark.parametrize("pkg", PKGS)
def test_pause_resume_cycle(pkg):
    p = _pkg(pkg)
    eng = _engine(p)
    try:
        x = np.zeros((4, FEAT), np.float32)
        eng.predict(x, timeout=10.0)
        compiles = eng.stats()["compiles"]
        eng.pause()
        with pytest.raises(p.serving.EngineClosed, match="paused"):
            eng.submit(x)
        eng.resume()
        eng.predict(x, timeout=10.0)  # serving again, no recapture
        assert eng.stats()["compiles"] == compiles
    finally:
        eng.close()
    with pytest.raises(p.serving.EngineClosed, match="released"):
        eng.resume()


@pytest.mark.parametrize("pkg", PKGS)
def test_batcher_dispatch_error_propagates(pkg):
    p = _pkg(pkg)
    batcher = __import__(f"{p.mx.__name__}.serving.batcher",
                         fromlist=["_Request"])

    def bad_dispatch(bucket, reqs):
        raise ValueError("device exploded")

    b = p.serving.ContinuousBatcher(bad_dispatch, max_batch=2,
                                    max_wait=0.001, queue_cap=8)
    try:
        req = batcher._Request(np.zeros((1, 2), np.float32), 1, (2,))
        b.submit(req)
        assert req.event.wait(10.0)
        with pytest.raises(ValueError, match="device exploded"):
            p.serving.ServeFuture(req).result(0)
    finally:
        b.close()
        b.close()  # idempotent


@pytest.mark.parametrize("pkg", PKGS)
def test_future_client_timeout_does_not_cancel(pkg):
    p = _pkg(pkg)
    eng = _engine(p, autostart=False)  # the result never arrives
    try:
        fut = eng.submit(np.zeros((4, FEAT), np.float32))
        with pytest.raises(TimeoutError, match="still in flight"):
            fut.result(timeout=0.01)
        assert not fut.done()  # client patience != request deadline
        assert fut.cancel() and fut.cancelled()
        with pytest.raises(p.serving.RequestCancelled):
            fut.result(timeout=1.0)
    finally:
        eng.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_env_knob_defaults(pkg, monkeypatch):
    s = _pkg(pkg).serving
    for name in ("MXTPU_SERVE_MAX_BATCH", "MXTPU_SERVE_MAX_WAIT_MS",
                 "MXTPU_SERVE_QUEUE"):
        monkeypatch.delenv(name, raising=False)
    assert s.serve_max_batch() == 8
    assert s.serve_max_wait_ms() == 5.0
    assert s.serve_queue_cap() == 256
    monkeypatch.setenv("MXTPU_SERVE_MAX_BATCH", "2")
    monkeypatch.setenv("MXTPU_SERVE_MAX_WAIT_MS", "0.5")
    monkeypatch.setenv("MXTPU_SERVE_QUEUE", "3")
    assert s.serve_max_batch() == 2
    assert s.serve_max_wait_ms() == 0.5
    assert s.serve_queue_cap() == 3


def test_stats_keys_equal_the_reference():
    jeng, teng = _engine(_pkg("jax")), _engine(_pkg("torch"))
    try:
        x = np.zeros((4, FEAT), np.float32)
        jeng.predict(x, timeout=10.0)
        teng.predict(x, timeout=10.0)
        js, ts = jeng.stats(), teng.stats()
        assert set(ts) == set(js)
        for key in ("buckets", "max_batch", "requests_ok", "batches",
                    "compiles", "retraces_after_warmup", "refused"):
            assert ts[key] == js[key], key
    finally:
        jeng.close()
        teng.close()


# -- a small BERT behind both engines ----------------------------------------

BERT_BUCKETS = [(8,), (16,), (32,)]


def _bert(m):
    return m.models.bert.get_bert_model(
        "bert_12_768_12", vocab_size=100, dropout=0.0, num_layers=2,
        units=64, hidden_size=128, num_heads=4, max_length=32,
        use_decoder=False)


@pytest.fixture(scope="module")
def bert_pair(tmp_path_factory):
    """The JAX BERT and the port's with its weights (``.params``)."""
    jnet = _bert(jmx)
    jnet.initialize()
    jnet(jmx.nd.array(np.ones((1, 8)), dtype="int32"))
    path = str(tmp_path_factory.mktemp("bert") / "bert.params")
    jnet.save_parameters(path)
    net = _bert(mx)
    net.load_parameters(path, ctx=mx.cpu())
    return jnet, net


def test_bert_served_by_both_engines_agrees(bert_pair):
    """Ragged int32 id rows (lengths 3-32) through each package's
    InferenceEngine (buckets 8, 16, 32; max_batch 4): each of the three
    outputs (sequence, pooled, NSP logits) of the port within 1e-5 of its
    largest magnitude of the JAX package's, and both equal to their own
    net's forward on the same zero-padded rows."""
    jnet, net = bert_pair
    rs = np.random.RandomState(11)
    rows = [rs.randint(1, 100, n).astype(np.int32)
            for n in (3, 8, 9, 17, 32, 5, 16, 30)]
    kw = dict(dtype="int32", max_batch=4, max_wait_ms=20.0)
    jeng = jmx.serving.InferenceEngine(jnet, BERT_BUCKETS, **kw)
    teng = mx.serving.InferenceEngine(net, BERT_BUCKETS, ctx=mx.cpu(), **kw)
    try:
        jfut = [jeng.submit(r) for r in rows]
        tfut = [teng.submit(r) for r in rows]
        for r, jf, tf in zip(rows, jfut, tfut):
            jout, tout = jf.result(timeout=60.0), tf.result(timeout=60.0)
            assert isinstance(tout, tuple) and len(tout) == len(jout) == 3
            bucket = next(b for (b,) in BERT_BUCKETS if len(r) <= b)
            padded = np.zeros((1, bucket), np.int32)
            padded[0, :len(r)] = r
            with mx.autograd.predict_mode():
                own = net(mx.nd.array(padded, dtype="int32", ctx=mx.cpu()))
            for t, j, o in zip(tout, jout, own):
                _rel_close(t, np.asarray(j))
                np.testing.assert_allclose(t, o.asnumpy(), rtol=1e-6,
                                           atol=1e-6)
        assert teng.stats()["compiles"] == len(BERT_BUCKETS)
        assert teng.stats()["requests_ok"] == len(rows)
    finally:
        jeng.close()
        teng.close()


# -- launch accounting while a capture runs -----------------------------------

@pytest.mark.parametrize("others", ["eager", "replay"])
def test_launch_counts_follow_the_capturing_stream(monkeypatch, others):
    """While a capture runs, a wrapper's count goes to the capture only
    from a thread whose current stream is capturing; another thread's
    eager launches and replays land in ``LAUNCHES`` as they run, and
    after the capture every count goes to ``LAUNCHES`` again. The
    capture state is faked per thread: there is no card here."""
    from mxnet_tpu_torch.ops import _kernels

    state = threading.local()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: getattr(state, "capturing", False))
    n0 = dict(_kernels.LAUNCHES)
    captured = collections.Counter()
    _kernels.capture_counts(captured)
    try:
        def capturing():
            state.capturing = True
            for _ in range(3):
                _kernels.count("flash_fwd")

        def other():
            for _ in range(5):
                if others == "eager":
                    _kernels.count("flash_fwd")
                else:
                    _kernels.add({"flash_fwd": 1})

        threads = [threading.Thread(target=f)
                   for f in (capturing, other, capturing)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    finally:
        _kernels.capture_counts(None)
    assert dict(captured) == {"flash_fwd": 6}
    assert _kernels.LAUNCHES["flash_fwd"] - n0.get("flash_fwd", 0) == 5
    state.capturing = True  # no capture under way: counted as it ran
    _kernels.count("flash_fwd")
    assert _kernels.LAUNCHES["flash_fwd"] - n0.get("flash_fwd", 0) == 6
    assert dict(captured) == {"flash_fwd": 6}


def test_launch_count_asks_no_card_without_a_capture(monkeypatch):
    """With no capture under way a count never queries the card, so the
    wrappers' plain CPU path stays free of CUDA calls."""
    from mxnet_tpu_torch.ops import _kernels

    def refuse():
        raise AssertionError("queried the card's capture state")

    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", refuse)
    n0 = _kernels.LAUNCHES["paged_decode"]
    _kernels.count("paged_decode")
    assert _kernels.LAUNCHES["paged_decode"] == n0 + 1


# -- on the card -------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return {"ctx": mx.gpu(0)}


def test_engine_captures_each_bucket_on_cuda():
    """One captured graph per bucket; replays in an order other than the
    capture order (the graphs share one memory pool) equal the eager
    forward on the same padded rows, and nothing captures after seal."""
    kw = _cuda()
    net = _ragged_net(_pkg("torch"))
    net.collect_params().reset_ctx(kw["ctx"])
    eng = mx.serving.InferenceEngine(net, BUCKETS, max_batch=4,
                                     max_wait_ms=1.0, **kw)
    try:
        assert all(e.graph is not None for e in eng._compiled.values())
        rs = np.random.RandomState(5)
        for t in (16, 3, 9, 4, 12, 1, 8):  # not the capture order
            row = rs.rand(t, FEAT).astype(np.float32)
            bucket = eng._bucket_for(row.shape)
            padded = np.zeros((1,) + bucket, np.float32)
            padded[0, :t] = row
            out = eng.predict(row, timeout=30.0)
            want = net(mx.nd.array(padded, **kw)).asnumpy()
            np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-6)
        assert eng.stats()["compiles"] == len(BUCKETS)
    finally:
        eng.close()


def _bert_on(ctx, seed=0):
    torch.manual_seed(seed)
    net = _bert(mx)
    net.initialize(ctx=ctx)
    net(mx.nd.ones((1, 8), dtype="int32", ctx=ctx))  # deferred shapes
    return net


def test_capture_while_another_engine_replays_on_cuda():
    """A second engine (a 2-layer BERT, two buckets) captures its graphs in
    thread-local mode while the first one (a 2-layer BERT too, whose
    replays launch K1) serves from its scheduler thread; both answer
    right, and K1's count is exact: two launches a graph, and ``LAUNCHES``
    gains two per replay of the first engine's batches, two per warm-up
    and per warm replay of the second's buckets, and two for its one
    request."""
    from mxnet_tpu_torch.ops import _kernels

    kw = _cuda()
    kw_eng = dict(ctx=kw["ctx"], dtype="int32", max_batch=2,
                  max_wait_ms=0.5)
    first = mx.serving.InferenceEngine(_bert_on(kw["ctx"]), [(8,)],
                                       **kw_eng)
    graphs = [e.graph for e in first._compiled.values()]
    x = np.ones((8,), np.int32)
    want = first.predict(x, timeout=30.0)
    stop, seen, errors = threading.Event(), [], []

    def client():
        while not stop.is_set():
            try:
                seen.append(first.predict(x, timeout=30.0))
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(e)
                return

    net2 = _bert_on(kw["ctx"], 1)  # its shape-resolving forward: uncounted
    n0 = _kernels.LAUNCHES["flash_fwd"]
    b0 = first.stats()["batches"]
    t = threading.Thread(target=client)
    t.start()
    try:
        time.sleep(0.05)
        second = mx.serving.InferenceEngine(net2, [(8,), (16,)], **kw_eng)
        graphs += [e.graph for e in second._compiled.values()]
        got = second.predict(np.ones((5,), np.int32), timeout=30.0)
        assert len(got) == 3 and np.isfinite(got[0]).all()
        second.close()
    finally:
        stop.set()
        t.join(timeout=30.0)
        first.close()  # its scheduler thread has counted its last batch
    assert not errors and seen
    for out in seen:
        for a, b in zip(out, want):
            np.testing.assert_array_equal(a, b)
    assert [g.launches["flash_fwd"] for g in graphs] == [2, 2, 2]
    batches = first.stats()["batches"] - b0
    assert batches >= len(seen)
    assert _kernels.LAUNCHES["flash_fwd"] - n0 \
        == 2 * batches + 2 * 2 * 2 + 2


def test_eager_launch_in_another_thread_during_capture_on_cuda():
    """K1 launched eagerly, over and over, in another thread while an
    engine captures its buckets: each launch counts as it ran, and none
    goes to the graphs, which hold two launches each (the two layers)."""
    from mxnet_tpu_torch.ops import _kernels
    from mxnet_tpu_torch.ops.flash_attention import _cuda_flash_fwd

    kw = _cuda()
    net = _bert_on(kw["ctx"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(2, 4, 64, 16, device="cuda", generator=gen)
               for _ in range(3))
    stop, calls, errors = threading.Event(), [0], []

    def eager():
        try:
            while not stop.is_set():
                _cuda_flash_fwd(q, k, v, 0.25, False, 0)
                calls[0] += 1
            torch.cuda.synchronize()
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    n0 = _kernels.LAUNCHES["flash_fwd"]
    t = threading.Thread(target=eager)
    t.start()
    try:
        time.sleep(0.05)
        eng = mx.serving.InferenceEngine(net, [(8,), (16,), (32,)],
                                         ctx=kw["ctx"], dtype="int32",
                                         max_batch=2, max_wait_ms=0.5)
    finally:
        stop.set()
        t.join(timeout=30.0)
    try:
        assert not errors and calls[0] > 0
        assert [e.graph.launches["flash_fwd"]
                for e in eng._compiled.values()] == [2, 2, 2]
        # each bucket: a warm-up and a warm replay of its two layers
        assert _kernels.LAUNCHES["flash_fwd"] - n0 \
            == calls[0] + 3 * 2 * 2
    finally:
        eng.close()
