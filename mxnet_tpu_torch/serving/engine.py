"""InferenceEngine: one captured CUDA graph per shape bucket behind a
continuous batcher.

PyTorch counterpart of ``mxnet_tpu/serving/engine.py``. Deploy path (all
the capturing happens HERE, never per request):

1. ``net.aot_predict_fn()`` gives the pure predict-mode function of the
   parameters and the input;
2. on a CUDA device, each declared shape bucket gets a static input
   buffer of ``(max_batch,) + bucket`` rows and ONE captured CUDA graph
   of the function over it (``gluon._capture``: a warm-up run on a side
   stream, the capture, then one replay as the warm execution, so
   request 1 runs at steady state). The buckets' graphs share one memory
   pool: the scheduler thread copies each replay's outputs to the host
   before any other bucket replays;
3. the engine SEALS: a request whose signature matches no bucket is
   refused loudly with a typed :class:`RetraceForbidden` naming the
   cause (``gluon.block.signature_causes``), never captured for.

The weights are the engine's own copies of the net's parameters, made at
deploy: every replay reads them, nothing writes them, and a
``ModelRepository`` swap hands the next engine its own.

Request path: ``submit()`` pads the request's rows onto its bucket
(``shape_guard.pad_to_shape``, ``SequenceBucketer`` selection) and queues
it; the :class:`ContinuousBatcher` scheduler groups requests per bucket
and ``_execute`` stacks them, pads the partial batch to ``max_batch``
with ``shape_guard.pad_batch``, copies it into the bucket's static buffer
with one host-to-device copy from pinned memory, replays the bucket's
graph, copies every output to the host once, and returns only the
requests' rows: pad rows never reach a result.

With ``ctx=mx.cpu()`` (the caller's explicit choice of device) the
function runs eagerly per batch with the same padding and slicing. On a
CUDA device a capture or replay that fails raises ``MXNetError``; nothing
runs eagerly in its place.
"""

from __future__ import annotations

import contextlib
import time

import numpy as _np
import torch

from .. import observability as _obs
from ..base import MXNetError, getenv
from ..observability.metrics import Histogram as _Histogram
from .batcher import ContinuousBatcher, ServeFuture, _Request
from .errors import (
    EngineClosed,
    RequestTooLarge,
    RetraceForbidden,
    ServerOverloaded,
)

_MAX_BATCH_DEFAULT = 8
_MAX_WAIT_MS_DEFAULT = 5.0
_QUEUE_DEFAULT = 256


def serve_max_batch() -> int:
    """Batch capacity (rows) per dispatch, ``MXTPU_SERVE_MAX_BATCH``."""
    return max(1, int(getenv("MXTPU_SERVE_MAX_BATCH", _MAX_BATCH_DEFAULT,
                             dtype=int)))


def serve_max_wait_ms() -> float:
    """Longest a partial batch waits for fill before dispatching,
    ``MXTPU_SERVE_MAX_WAIT_MS`` (the latency/throughput knob)."""
    return float(getenv("MXTPU_SERVE_MAX_WAIT_MS", _MAX_WAIT_MS_DEFAULT,
                        dtype=float))


def serve_queue_cap() -> int:
    """Bounded submit-queue depth (requests) before load shedding,
    ``MXTPU_SERVE_QUEUE``."""
    return max(1, int(getenv("MXTPU_SERVE_QUEUE", _QUEUE_DEFAULT,
                             dtype=int)))


class _Bucket:
    """One sealed bucket: its static input, and on CUDA its graph, the
    graph's outputs and the pinned host buffers of both directions."""

    __slots__ = ("static", "graph", "outs", "host_in", "host_outs")

    def __init__(self, static):
        self.static = static
        self.graph = None
        self.outs = None
        self.host_in = None
        self.host_outs = None


class InferenceEngine:
    """Serve one model version: sealed per-bucket executables (captured
    CUDA graphs on a card) behind a continuous batcher.

    ``shapes``: one per-ROW input shape (no batch dim) or a list of
    them, the shape buckets, e.g. ``[(8, 16), (16, 16), (32, 16)]``
    for ragged sequences. Shapes varying along exactly one axis get
    :class:`SequenceBucketer` smallest-fitting-bucket selection; any
    request row shape elementwise <= a bucket pads onto it.

    >>> eng = InferenceEngine(net, shapes=[(16,), (32,)], max_batch=8)
    >>> y = eng.predict(x)                  # sync, one row or a few
    >>> fut = eng.submit(x, deadline_ms=50) # async with a deadline
    >>> fut.result(), fut.version
    """

    def __init__(self, net, shapes, *, ctx=None, dtype="float32",
                 max_batch=None, max_wait_ms=None, queue_cap=None,
                 name="model", version="v1", autostart=True):
        from ..context import current_context, resolve_device

        self._name = str(name)
        self._version = str(version)
        self._ctx = ctx or current_context()
        self.device = resolve_device(self._ctx)
        self._dtype = _np.dtype(dtype)
        self._max_batch = int(max_batch) if max_batch is not None \
            else serve_max_batch()
        self._max_wait = (float(max_wait_ms) if max_wait_ms is not None
                          else serve_max_wait_ms()) / 1e3
        self._queue_cap = int(queue_cap) if queue_cap is not None \
            else serve_queue_cap()
        self._buckets = self._normalize_shapes(shapes)
        self._rank = len(self._buckets[0])
        self._bucketer = self._build_bucketer()
        self._compiled = {}
        self._single = True
        self._params = None
        self._fn = None
        self._sealed = False
        self._closed = False
        self._paused = False
        self._batcher = None
        # engine-local SLO state: independent of the global telemetry
        # switch, so stats() reads real numbers with telemetry off
        self._latency = _Histogram("local_latency")
        self._fill_sum = 0.0
        self._batches = 0
        self._requests_ok = 0
        self._refused = 0
        self._shed = 0
        self._timeouts = 0
        self._compiles = 0
        with self._on_device():
            self._deploy(net)
        self._batcher = ContinuousBatcher(
            self._execute, max_batch=self._max_batch,
            max_wait=self._max_wait, queue_cap=self._queue_cap,
            on_expire=self._on_expire, autostart=autostart,
            name=self._name)

    # -- bucket geometry ---------------------------------------------------
    @staticmethod
    def _normalize_shapes(shapes):
        if isinstance(shapes, tuple) or (
                isinstance(shapes, list) and shapes and
                not isinstance(shapes[0], (tuple, list))):
            shapes = [shapes]
        buckets = sorted({tuple(int(d) for d in s) for s in shapes},
                         key=lambda b: (int(_np.prod(b)), b))
        if not buckets or any(d <= 0 for b in buckets for d in b):
            raise MXNetError(f"invalid serving shape buckets {shapes!r}")
        if len({len(b) for b in buckets}) != 1:
            raise MXNetError(
                f"serving shape buckets must share one rank, got {buckets}")
        return buckets

    def _build_bucketer(self):
        """Shapes varying along exactly one axis -> SequenceBucketer
        selection on that axis (the ragged-sequence fast path)."""
        from ..gluon.data.shape_guard import SequenceBucketer

        if len(self._buckets) < 2:
            return None
        varying = [i for i in range(self._rank)
                   if len({b[i] for b in self._buckets}) > 1]
        if len(varying) != 1:
            return None
        return SequenceBucketer([b[varying[0]] for b in self._buckets],
                                axis=varying[0])

    def _bucket_for(self, row_shape):
        """Smallest bucket every dim of ``row_shape`` fits in; typed
        refusal (never a capture) when none does."""
        if self._bucketer is not None:
            ax = self._bucketer.axis
            try:
                target = self._bucketer.bucket_for(int(row_shape[ax]))
            except MXNetError:
                target = None
            if target is not None:
                cand = tuple(target if i == ax else d
                             for i, d in enumerate(row_shape))
                if cand in self._compiled:
                    return cand
        else:
            fits = [b for b in self._buckets
                    if all(d <= t for d, t in zip(row_shape, b))]
            if fits:
                return fits[0]  # buckets sorted smallest-first
        self._refuse(row_shape)

    def _refuse(self, row_shape, got_dtype=None):
        from ..gluon.block import signature_causes

        got_dtype = str(got_dtype or self._dtype)
        closest = min(self._buckets,
                      key=lambda b: sum(abs(d - t) for d, t in
                                        zip(row_shape, b))
                      if len(b) == len(row_shape) else float("inf"))
        causes = signature_causes(
            ((closest, str(self._dtype)),), ((tuple(row_shape), got_dtype),))
        self._refused += 1
        if _obs.ENABLED:
            _obs.record_serve_request(self._name, "error")
        raise RetraceForbidden(
            f"sealed serving engine {self._name}:{self._version} has no "
            f"executable for row signature {tuple(row_shape)}/{got_dtype} "
            f"(cause: {'+'.join(causes) or 'unknown'}; no capture after "
            f"deploy). Known buckets: {self._buckets} @ "
            f"{self._dtype.name}. Pad/bucket the client input, or add a "
            f"bucket and redeploy.")

    # -- deploy (capture, seal) --------------------------------------------
    @contextlib.contextmanager
    def _on_device(self):
        """Bind the calling thread to the engine's card (work goes to that
        card's current stream) and turn autograd off."""
        with contextlib.ExitStack() as stack:
            if self.device.type == "cuda":
                stack.enter_context(torch.cuda.device(self.device))
            stack.enter_context(torch.inference_mode())
            yield

    def _deploy(self, net):
        from ..gluon import _capture
        from ..ndarray.ndarray import torch_dtype

        if not hasattr(net, "aot_predict_fn"):
            raise MXNetError(
                f"{type(net).__name__} has no aot_predict_fn — serve a "
                "HybridBlock")
        fn, params = net.aot_predict_fn(
            ctx=self._ctx, dtype=self._dtype.name,
            sample_shape=(1,) + self._buckets[0])
        self._fn = fn
        # the engine's own weights: read by every execution, never written
        self._params = [p.detach().clone() for p in params]
        cuda = self.device.type == "cuda"
        pool = torch.cuda.graph_pool_handle() if cuda else None
        for bucket in self._buckets:
            t0 = time.perf_counter()
            entry = _Bucket(torch.zeros((self._max_batch,) + bucket,
                                        dtype=torch_dtype(self._dtype.name),
                                        device=self.device))
            if cuda:
                def run(entry=entry):
                    return fn(self._params, entry.static)

                _capture.warm_up(run)
                entry.graph = _capture.Graph(
                    pool, f"serving {self._name}:{self._version} bucket "
                    f"{bucket}")
                out = entry.graph.capture(run)
                entry.graph.replay()  # warm execution
                entry.host_in = torch.empty(entry.static.shape,
                                            dtype=entry.static.dtype,
                                            pin_memory=True)
            else:
                out = fn(self._params, entry.static)  # warm execution
            self._single = not isinstance(out, (tuple, list))
            outs = (out,) if self._single else tuple(out)
            if cuda:
                entry.outs = outs
                entry.host_outs = [torch.empty(o.shape, dtype=o.dtype,
                                               pin_memory=True) for o in outs]
                torch.cuda.synchronize(self.device)
            self._compiled[bucket] = entry
            self._compiles += 1
            if _obs.ENABLED:
                _obs.SERVE_COMPILE_TOTAL.inc(1, model=self._name)
                _obs.tracer().record(
                    "serving.compile", cat="serving",
                    ts=t0, dur=time.perf_counter() - t0,
                    args={"model": self._name, "version": self._version,
                          "bucket": str(bucket)})
        self._sealed = True

    # -- request path ------------------------------------------------------
    def submit(self, x, deadline_ms=None, cast=True) -> ServeFuture:
        """Queue one request (a single row, or a micro-batch with a
        leading rows axis, ``rows <= max_batch``). Raises typed errors:
        :class:`ServerOverloaded` (queue full), :class:`RequestTooLarge`,
        :class:`RetraceForbidden` (no bucket), :class:`EngineClosed`.
        ``deadline_ms``: drop (typed timeout) if not dispatched in time.
        ``cast=False`` refuses dtype mismatches instead of converting."""
        if self._closed or self._paused:
            if _obs.ENABLED:
                _obs.record_serve_request(self._name, "closed")
            raise EngineClosed(
                f"engine {self._name}:{self._version} is "
                f"{'closed' if self._closed else 'paused (standby)'}")
        arr = x.asnumpy() if hasattr(x, "asnumpy") else _np.asarray(x)
        if not cast and arr.dtype != self._dtype:
            self._refuse(arr.shape[1:] if arr.ndim == self._rank + 1
                         else arr.shape, got_dtype=arr.dtype)
        arr = _np.asarray(arr, self._dtype)
        if arr.ndim == self._rank:
            arr = arr[None]  # single row convenience
        if arr.ndim != self._rank + 1 or arr.shape[0] < 1:
            self._refuse(arr.shape)
        rows = int(arr.shape[0])
        if rows > self._max_batch:
            if _obs.ENABLED:
                _obs.record_serve_request(self._name, "too_large")
            raise RequestTooLarge(
                f"request carries {rows} rows > max_batch "
                f"{self._max_batch} (MXTPU_SERVE_MAX_BATCH) — it can "
                "never fit one dispatch; split it client-side")
        bucket = self._bucket_for(arr.shape[1:])
        if arr.shape[1:] != bucket:
            from ..gluon.data.shape_guard import pad_to_shape

            arr = pad_to_shape(arr, (rows,) + bucket)
        deadline = None if deadline_ms is None else \
            time.perf_counter() + float(deadline_ms) / 1e3
        req = _Request(arr, rows, bucket, deadline=deadline)
        req.version = self._version
        if _obs.ENABLED:
            _obs.record_serve_submit(self._name, req.req_id)
        try:
            self._batcher.submit(req)
        except ServerOverloaded:
            self._shed += 1
            if _obs.ENABLED:
                _obs.record_serve_request(self._name, "shed")
            raise
        except EngineClosed:
            if _obs.ENABLED:
                _obs.record_serve_request(self._name, "closed")
            raise
        return ServeFuture(req)

    def predict(self, x, timeout=None, deadline_ms=None):
        """Synchronous request: submit + wait. Returns the host result
        (numpy; tuple for multi-output nets), pad rows stripped."""
        return self.submit(x, deadline_ms=deadline_ms).result(timeout)

    def _on_expire(self, req):
        self._timeouts += 1
        if _obs.ENABLED:
            _obs.record_serve_request(self._name, "timeout")

    def _run(self, entry, padded):
        """One batch through the bucket's executable; the host copies of
        its outputs."""
        if entry.graph is None:
            out = self._fn(self._params, torch.from_numpy(padded))
            outs = (out,) if self._single else tuple(out)
            return [o.numpy() for o in outs]
        entry.host_in.numpy()[...] = padded
        entry.static.copy_(entry.host_in, non_blocking=True)
        entry.graph.replay()
        for h, o in zip(entry.host_outs, entry.outs):
            h.copy_(o, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return [h.numpy() for h in entry.host_outs]

    def _execute(self, bucket, reqs):
        """Batcher dispatch hook (scheduler thread): stack the group,
        pad to capacity, run the ONE sealed executable, unpad."""
        from ..gluon.data.shape_guard import pad_batch

        entry = self._compiled.get(bucket)
        if entry is None:  # cannot happen post-seal; refuse, not capture
            raise RetraceForbidden(
                f"no executable for bucket {bucket} (engine sealed)")
        # phase boundary 1: queue-wait ends, batch assembly begins
        t_asm = time.perf_counter()
        for r in reqs:
            r.t_assembly = t_asm
        stacked = _np.concatenate([r.payload for r in reqs], axis=0) \
            if len(reqs) > 1 else reqs[0].payload
        n_valid = int(stacked.shape[0])
        padded = stacked
        if n_valid < self._max_batch:
            padded, _mask = pad_batch(stacked, self._max_batch)
            # the mask's valid prefix is exactly rows [:n_valid] — the
            # unpad below slices it; pad rows never reach a result
        t0 = time.perf_counter()
        with self._on_device():
            if _obs.flight.INSTALLED:
                with _obs.flight.dispatch("serving"):
                    host = self._run(entry, _np.ascontiguousarray(padded))
            else:
                host = self._run(entry, _np.ascontiguousarray(padded))
        if _obs.ENABLED:
            _obs.record_xla_dispatch("serving")
        dt = time.perf_counter() - t0
        now = time.perf_counter()
        off = 0
        for r in reqs:
            # copies: the pinned buffers are rewritten by the next batch
            rows = [h[off:off + r.rows].copy() for h in host]
            off += r.rows
            r.finish(result=rows[0] if self._single else tuple(rows))
            self._requests_ok += 1
            self._latency.observe(now - r.t_submit)
            if _obs.ENABLED:
                _obs.record_serve_request(self._name, "ok",
                                          latency=now - r.t_submit)
        self._batches += 1
        self._fill_sum += n_valid / self._max_batch
        if _obs.ENABLED:
            t_done = time.perf_counter()
            # one batch span id parents every request's phase span (queue
            # -> batch -> dispatch -> slice): the p99 decomposes
            batch_span = _obs.tracer().new_span_id()
            for r in reqs:
                _obs.record_serve_phases(
                    self._name, r.req_id, r.t_submit,
                    {"queue": t_asm - r.t_submit,
                     "batch": t0 - t_asm,
                     "dispatch": dt,
                     "slice": t_done - now},
                    parent=batch_span)
            _obs.record_serve_batch(self._name, bucket, n_valid,
                                    self._max_batch, dt,
                                    self._batcher.qsize(),
                                    span_id=batch_span)

    # -- introspection -----------------------------------------------------
    @property
    def name(self):
        return self._name

    @property
    def version(self):
        return self._version

    @property
    def buckets(self):
        return list(self._buckets)

    @property
    def sealed(self):
        return self._sealed

    def queue_depth(self) -> int:
        """Requests waiting in the admission queue right now."""
        return self._batcher.qsize() if self._batcher is not None else 0

    def stats(self) -> dict:
        """Engine-local SLO snapshot (plain floats, works with global
        telemetry off). ``compiles`` counts the deploy's captures, one per
        bucket (warm runs on the CPU), and is flat after seal."""
        p50 = self._latency.quantile(0.5)
        p99 = self._latency.quantile(0.99)
        return {
            "model": self._name, "version": self._version,
            "buckets": [list(b) for b in self._buckets],
            "max_batch": self._max_batch,
            "requests_ok": self._requests_ok,
            "batches": self._batches,
            "mean_batch_fill": (self._fill_sum / self._batches)
            if self._batches else None,
            "latency_p50_ms": None if p50 is None else p50 * 1e3,
            "latency_p99_ms": None if p99 is None else p99 * 1e3,
            "shed": self._shed, "timeouts": self._timeouts,
            "refused": self._refused,
            "compiles": self._compiles,
            "retraces_after_warmup": 0 if self._sealed else None,
            "queue_depth": self._batcher.qsize() if self._batcher else 0,
        }

    # -- lifecycle ---------------------------------------------------------
    def pause(self):
        """Stop accepting work and DRAIN in-flight requests, keeping the
        graphs and weights resident (repository standby: rollback is
        ``resume()``, not a recapture)."""
        if self._paused or self._closed:
            return
        self._paused = True
        self._batcher.close()

    def resume(self):
        """Reactivate a paused standby engine (repository rollback)."""
        if self._closed:
            raise EngineClosed(f"engine {self._name}:{self._version} was "
                               "released; reload instead of resume")
        if not self._paused:
            return
        self._batcher = ContinuousBatcher(
            self._execute, max_batch=self._max_batch,
            max_wait=self._max_wait, queue_cap=self._queue_cap,
            on_expire=self._on_expire, name=self._name)
        self._paused = False

    def kill(self):
        """Abrupt host-death simulation: queued requests FAIL with a
        typed :class:`ReplicaDead` instead of draining; their waiters
        unblock at once. Idempotent; a no-op after ``close()``."""
        from .errors import ReplicaDead

        if self._closed:
            return
        self._closed = True
        name = f"{self._name}:{self._version}"
        if self._batcher is not None:
            self._batcher.abort(lambda: ReplicaDead(
                f"engine {name} killed (abrupt host death) with this "
                "request queued — retry on a surviving replica"))
        self._release()

    def close(self):
        """Drain in-flight requests, then release: graphs and weights
        dropped. Idempotent; errors propagate to waiters, safe from
        ``__del__``."""
        if self._closed:
            return
        self._closed = True
        if self._batcher is not None:
            self._batcher.close()
        self._release()

    def _release(self):
        self._compiled = {}
        self._params = None
        self._fn = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass
