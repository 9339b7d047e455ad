"""Port parity: ``DevicePrefetcher``, ``DataLoader(device=...)`` and
``PrefetchingIter`` against the JAX package (the data cases of
``tests/test_input_pipeline.py``; its telemetry series wait for the
metrics registry, ROADMAP A12, its mesh and SPMD cases for ROADMAP A11,
and its warm-up and compile-cache cases are the JAX package's
compilation, which the port does not have).

On the CPU ``device=mx.cpu()`` and ``device=None`` keep batches on the
host. The ``*_on_cuda`` tests check the card's staging: every batch
equal to its host batch bit for bit, the copy enqueued on the prefetcher's
side stream (not the consumer's), a pinned buffer's data right across
many batches while the consumer's stream is busy (one is reused only
after its copy ran), and the consumer's stream ordered after the copy.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import gc
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.gluon import data as jdata
from mxnet_tpu_torch.gluon.data import (
    ArrayDataset,
    DataLoader,
    DevicePrefetcher,
    stack_batches,
)
from mxnet_tpu_torch.gluon.data.prefetcher import wrap_for_fit


def _np(a):
    return np.array(a.asnumpy())


def _loader(n=10, bs=4, **kw):
    X = np.random.RandomState(0).rand(n, 3).astype(np.float32)
    Y = np.arange(n).astype(np.float32)
    return DataLoader(ArrayDataset(X, Y), batch_size=bs, **kw), \
        jdata.DataLoader(jdata.ArrayDataset(X, Y), batch_size=bs, **kw)


@pytest.mark.parametrize("device", [None, "cpu"])
def test_prefetcher_matches_jax_and_direct_iteration(device):
    loader, jloader = _loader()
    ctx = mx.cpu() if device else None
    jctx = jmx.cpu() if device else None
    pf = DevicePrefetcher(loader, device=ctx)
    jpf = jdata.DevicePrefetcher(jloader, device=jctx)
    for _ in range(2):  # two epochs through the same wrapper
        got = [(_np(x), _np(y), x.context) for x, y in pf]
        want = [(_np(x), _np(y)) for x, y in jpf]
        assert len(got) == len(want) == 3
        for (gx, gy, c), (wx, wy) in zip(got, want):
            assert c == mx.cpu()
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)


def test_prefetcher_preserves_structure():
    src = [{"x": np.ones((2, 2), np.float32), "meta": "a",
            "pair": (mx.nd.ones((1,), ctx=mx.cpu()), 3)}]
    (b,) = list(DevicePrefetcher(src, device=mx.cpu()))
    assert isinstance(b["x"], mx.NDArray) and b["meta"] == "a"
    assert isinstance(b["pair"], tuple) and b["pair"][1] == 3
    it = mx.io.NDArrayIter(np.zeros((4, 2), np.float32),
                           np.zeros(4, np.float32), batch_size=2)
    batch = next(iter(DevicePrefetcher(it, device=mx.cpu())))
    assert type(batch).__name__ == "DataBatch" and batch.pad == 0


def test_prefetcher_propagates_source_error_and_closes():
    def bad():
        yield mx.nd.ones((2, 2), ctx=mx.cpu())
        raise RuntimeError("boom in source")

    pf = DevicePrefetcher(bad(), device=mx.cpu())
    it = iter(pf)
    next(it)
    with pytest.raises(RuntimeError, match="boom in source"):
        next(it)
    assert pf._thread is None  # closed (thread joined), not leaked
    pf.close()
    pf.close()  # idempotent


def test_prefetcher_close_unblocks_full_queue():
    def endless():
        i = 0
        while True:
            yield np.full((4,), i, np.float32)
            i += 1

    pf = DevicePrefetcher(endless(), device=mx.cpu(), depth=2)
    it = iter(pf)
    next(it)
    time.sleep(0.1)  # let the producer fill and block on the queue
    thread = pf._thread
    pf.close()
    assert pf._thread is None and not thread.is_alive()


def test_prefetcher_close_while_producing_from_another_thread():
    """close() from another thread while the producer stages: the
    producer stops and is joined, the consumer's next call returns or
    stops (it is never left waiting), and a fresh iter() restarts."""
    def slow():
        for i in range(1000):
            time.sleep(0.001)
            yield np.full((2,), i, np.float32)

    pf = DevicePrefetcher(slow(), device=None, depth=2)
    it = iter(pf)
    next(it)
    closer = threading.Thread(target=pf.close)
    closer.start()
    closer.join(timeout=10)
    assert not closer.is_alive() and pf._thread is None


def test_prefetcher_dataiter_protocol_and_reset():
    data = np.arange(24, dtype=np.float32).reshape(12, 2)
    it = mx.io.NDArrayIter(data, np.arange(12, dtype=np.float32),
                           batch_size=4, shuffle=False)
    pf = DevicePrefetcher(it, device=mx.cpu())
    assert pf.batch_size == 4  # attribute passthrough
    assert len(pf.provide_data) == 1
    for _ in range(2):  # epochs: the wrapper resets the exhausted source
        batches = list(pf)
        assert len(batches) == 3
        np.testing.assert_array_equal(_np(batches[0].data[0]), data[:4])
    it2 = iter(pf)
    next(it2)
    pf.reset()
    assert len(list(pf)) == 3
    assert pf.cursor == 3


def test_wrap_for_fit_respects_env(monkeypatch):
    src = [1, 2, 3]
    monkeypatch.setenv("MXTPU_DEVICE_PREFETCH", "0")
    assert wrap_for_fit(src) is src
    monkeypatch.setenv("MXTPU_DEVICE_PREFETCH", "3")
    wrapped = wrap_for_fit(src)
    assert isinstance(wrapped, DevicePrefetcher) and wrapped._depth == 3
    assert wrap_for_fit(wrapped) is wrapped  # never double-wraps
    loader, _ = _loader(4, 2, device=mx.cpu())
    assert wrap_for_fit(loader) is loader


def test_prefetcher_iter_on_inflight_iterator_loses_nothing():
    loader, _ = _loader(10, 4, device=mx.cpu())
    it = iter(loader)
    time.sleep(0.1)  # let the producer stage batches ahead
    assert len(list(it)) == 3  # list() calls iter() again


def test_prefetcher_stays_exhausted_until_reiterated():
    loader, _ = _loader(8, 4)
    pf = DevicePrefetcher(loader, device=mx.cpu())
    it = iter(pf)
    assert len(list(it)) == 2
    for _ in range(3):
        with pytest.raises(StopIteration):
            next(it)
    assert len(list(iter(pf))) == 2


def test_dataloader_device_and_pad_last_batch():
    loader, jloader = _loader(10, 4, last_batch="pad", device=mx.cpu())
    assert len(loader) == 3
    for _ in range(2):
        assert [tuple(x.shape) for x, _ in loader] == [(4, 3)] * 3
    np.testing.assert_array_equal(_np(list(loader)[-1][1]), [8, 9, 0, 1])
    short = DataLoader(ArrayDataset(np.arange(3, dtype=np.float32),
                                    np.arange(3, dtype=np.float32)),
                       batch_size=8, last_batch="pad")
    (x, _), = list(short)
    np.testing.assert_array_equal(_np(x), [0, 1, 2, 0, 1, 2, 0, 1])


def test_dataloader_del_robust_when_init_raised():
    with pytest.raises(ValueError):
        DataLoader(ArrayDataset(np.zeros((4, 2), np.float32),
                                np.zeros((4,), np.float32)))
    obj = DataLoader.__new__(DataLoader)
    obj.__del__()
    gc.collect()


def test_stack_batches_matches_jax():
    from mxnet_tpu.gluon.data.prefetcher import stack_batches as jstack

    rng = np.random.RandomState(1)
    bs = [(rng.rand(2, 3).astype(np.float32), 7) for _ in range(3)]
    got = stack_batches([(mx.nd.array(a, ctx=mx.cpu()), k) for a, k in bs])
    want = jstack([(jmx.nd.array(a), k) for a, k in bs])
    np.testing.assert_array_equal(_np(got[0]), _np(want[0]))
    assert got[1] == want[1] == 7
    with pytest.raises(ValueError):
        stack_batches([])
    with pytest.raises(ValueError):
        stack_batches([mx.nd.ones((2,), ctx=mx.cpu()),
                       mx.nd.ones((3,), ctx=mx.cpu())])


def test_unported_prefetcher_options_raise(monkeypatch):
    # a mesh is ported (each rank's rows, on the current context's
    # device): without a card and without ``with mx.cpu()`` it refuses
    # the host, as every entry point does
    import torch

    mesh = mx.parallel.make_mesh({"dp": 1})
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(mx.MXNetError, match="no CUDA device"):
            DevicePrefetcher([], mesh=mesh)
        with pytest.raises(mx.MXNetError, match="no CUDA device"):
            DevicePrefetcher([]).repartition(mesh=mesh)
    with mx.cpu():
        assert list(DevicePrefetcher([], mesh=mesh)) == []
    with pytest.raises(mx.MXNetError, match="A13"):
        DevicePrefetcher([]).repartition(world=2, rank=0)
    # the chaos hook is ported (``resilience.chaos``, site ``prefetch``):
    # MXTPU_CHAOS no longer refuses a prefetcher
    monkeypatch.setenv("MXTPU_CHAOS", "nan@prefetch:2")
    assert list(DevicePrefetcher([])) == []


def test_repartition_restages_onto_the_new_device():
    src = [np.full((2,), i, np.float32) for i in range(4)]
    pf = DevicePrefetcher(src, device=None, depth=2)
    it = iter(pf)
    first = next(it)
    time.sleep(0.05)
    pf.repartition(device=mx.cpu())
    rest = list(it)
    assert [float(_np(b)[0]) for b in [first] + rest] == [0, 1, 2, 3]
    assert all(b.context == mx.cpu() for b in rest)


class _BoomIter(mx.io.DataIter):
    def __init__(self, good_batches=1):
        super().__init__(2)
        self._n = 0
        self._good = good_batches
        self.provide_data = [mx.io.DataDesc("data", (2, 2))]
        self.provide_label = [mx.io.DataDesc("softmax_label", (2,))]

    def reset(self):
        self._n = 0

    def next(self):
        self._n += 1
        if self._n > self._good:
            raise ValueError("decode failed")
        return mx.io.DataBatch(data=[mx.nd.ones((2, 2), ctx=mx.cpu())],
                               label=[mx.nd.ones((2,), ctx=mx.cpu())],
                               pad=0)


def test_prefetching_iter_lifecycle():
    it = mx.io.PrefetchingIter(_BoomIter(good_batches=1))
    it.next()
    with pytest.raises(ValueError, match="decode failed"):
        it.next()
    for t in it.prefetch_threads:
        t.join(timeout=5.0)
        assert not t.is_alive()
    inner = mx.io.NDArrayIter(np.arange(12, dtype=np.float32).reshape(6, 2),
                              np.arange(6, dtype=np.float32), batch_size=2)
    it = mx.io.PrefetchingIter(inner)
    assert sum(1 for _ in it) == 3
    it.reset()
    assert sum(1 for _ in it) == 3
    it.close()
    it.close()
    for t in it.prefetch_threads:
        assert not t.is_alive()


# -- on the card -------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return mx.gpu(0)


def test_staged_batches_equal_host_batches_on_cuda():
    ctx = _cuda()
    rng = np.random.RandomState(3)
    host = [(rng.rand(16, 3, 8, 8).astype(np.float32),
             rng.randint(0, 10, (16,)).astype(np.float32)) for _ in range(5)]
    pinned = [(torch.from_numpy(x).pin_memory(), y) for x, y in host]
    for src in (host, [(mx.nd.array(x, ctx=mx.cpu()), y) for x, y in host],
                [(mx.NDArray(x), y) for x, y in pinned]):
        pf = DevicePrefetcher(src, device=ctx, depth=2)
        got = list(pf)
        torch.cuda.synchronize()
        assert len(got) == 5
        for (x, y), (hx, hy) in zip(got, host):
            assert x.context == ctx and y.context == ctx
            assert torch.equal(x.data.cpu(), torch.from_numpy(hx))
            assert torch.equal(y.data.cpu(), torch.from_numpy(hy))


def test_copies_run_on_the_side_stream_on_cuda():
    ctx = _cuda()
    src = [np.full((1 << 20,), i, np.float32) for i in range(4)]
    pf = DevicePrefetcher(src, device=ctx, depth=2)
    assert pf._stream is not None
    assert pf._stream != torch.cuda.current_stream()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = [b.data * 2 for b in pf]
        torch.cuda.synchronize()
    for i, t in enumerate(out):
        assert float(t[0]) == 2 * i
    cuda = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = {e.device_resource_id for e in cuda if "HtoD" in e.name}
    kernels = {e.device_resource_id for e in cuda
               if "elementwise" in e.name}
    assert copies and kernels and not copies & kernels


def test_pinned_buffers_reused_after_their_event_on_cuda():
    """Many batches through the pinned staging while the consumer's
    stream is kept busy: a pinned buffer handed out again before its
    copy ran would deliver another batch's values. The source rewrites
    one pageable buffer for every batch, as a reader with a reused batch
    buffer does."""
    ctx = _cuda()
    buf = np.empty((1 << 20,), np.float32)

    def source():
        for i in range(48):
            buf[:] = i
            yield buf

    a = torch.randn(2048, 2048, device="cuda")
    sums = []
    for b in DevicePrefetcher(source(), device=ctx, depth=2):
        for _ in range(4):
            a = torch.tanh(a @ a)  # keeps the step's stream busy
        sums.append(b.data.sum())
    got = torch.stack(sums).cpu().numpy()
    np.testing.assert_array_equal(got, np.arange(48, dtype=np.float32)
                                  * buf.size)


def test_dataloader_pin_memory_and_device_on_cuda():
    ctx = _cuda()
    X = np.random.RandomState(0).rand(10, 3).astype(np.float32)
    Y = np.arange(10).astype(np.float32)
    loader = DataLoader(ArrayDataset(X, Y), batch_size=4, pin_memory=True)
    x, y = next(iter(loader))
    assert x.data.is_pinned() and x.context == mx.cpu()
    loader = DataLoader(ArrayDataset(X, Y), batch_size=4, pin_memory=True,
                        device=ctx)
    got = [(_np(x), _np(y)) for x, y in loader]
    np.testing.assert_array_equal(np.concatenate([g[0] for g in got]), X)


def test_capture_survives_a_staging_thread_on_cuda():
    """C19: a hybridized block's first step captures its forward and
    backward while another thread does what a staging thread does
    (pinned allocations, copies on a side stream, event records, queries
    and waits). In the global capture mode such calls invalidated the
    capture; the cached graph now captures in thread-local mode."""
    ctx = _cuda()
    stop = threading.Event()
    errors = []

    def stager():
        try:
            side = torch.cuda.Stream()
            while not stop.is_set():
                host = torch.empty(1 << 18, pin_memory=True)
                with torch.cuda.stream(side):
                    dev = host.to("cuda", non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(side)
                ev.query()
                ev.synchronize()
                del dev
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(64, activation="relu"), mx.gluon.nn.Dense(10))
    net.initialize(ctx=ctx)
    net.hybridize()
    x = mx.nd.array(np.random.RandomState(0).rand(32, 16), ctx=ctx)
    y = mx.nd.array(np.arange(32) % 10, ctx=ctx)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    t = threading.Thread(target=stager, daemon=True)
    t.start()
    try:
        time.sleep(0.05)
        for _ in range(3):
            with mx.autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
        torch.cuda.synchronize()
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive() and not errors
    entries = list(net._cached_graph._cache.values())
    assert len(entries) == 1 and entries[0].graphed
    assert np.isfinite(_np(loss)).all()
