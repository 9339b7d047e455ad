"""Continuous batching: a background scheduler thread drains an async
request queue into shape-stable batches.

PyTorch-port counterpart of ``mxnet_tpu/serving/batcher.py``, the same
module: pure Python and threads, no device code (the engine's dispatch
hook binds its card). The serving mirror of a prefetcher (a thread and a
bounded ``queue.Queue``; exceptions propagate to the waiter, ``close()``
is idempotent, drains, and joins; ``__del__`` is safe), but
demand-driven: requests arrive one at a
time from many client threads, and the scheduler groups them by shape
bucket, dispatching a group when it FILLS (``max_batch`` rows) or when
its oldest request has waited ``max_wait`` (tail-latency bound),
whichever comes first. Per-request deadlines are enforced HERE, before
dispatch: an expired request gets a typed :class:`RequestTimeout`, its
slot goes to the next request — never a stale result.

Backpressure is the bounded submit queue: when it is full, ``submit``
raises :class:`ServerOverloaded` immediately (load shed) instead of
queueing unbounded work the deadline would kill anyway.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time

from .errors import EngineClosed, ServerOverloaded
from .. import observability as _obs

#: queue sentinel: close() enqueues it BEHIND already-accepted requests,
#: so the drain processes everything admitted before the close.
_CLOSE = object()

#: process-unique request ids, minted at construction (itertools.count
#: is GIL-atomic) — the correlation key the trace spans thread through
#: queue-wait -> batch-assembly -> dispatch -> slice-out
_REQ_IDS = itertools.count(1)


class _Request:
    """One in-flight request: host payload rows (already padded onto
    their bucket's row shape), terminal result/error, and the wait
    event its :class:`ServeFuture` blocks on."""

    __slots__ = ("payload", "rows", "bucket", "t_submit", "deadline",
                 "event", "result", "error", "version", "req_id",
                 "t_assembly", "claimed", "cancelled", "_state_lock")

    def __init__(self, payload, rows, bucket, deadline=None):
        self.payload = payload
        self.rows = rows
        self.bucket = bucket
        self.t_submit = time.perf_counter()
        self.deadline = deadline  # absolute perf_counter time, or None
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.version = None
        self.req_id = next(_REQ_IDS)
        self.t_assembly = None  # stamped when batch assembly picks it up
        # claim/cancel CAS: exactly one of {batch assembly, client
        # cancel} wins a queued request; the loser sees False
        self.claimed = False
        self.cancelled = False
        self._state_lock = threading.Lock()

    def finish(self, result=None, error=None):
        self.result = result
        self.error = error
        self.event.set()

    def claim(self) -> bool:
        """Batch assembly takes ownership: False iff the client already
        cancelled (or the request is otherwise terminal) — the entry is
        skipped at drain time, its slot going to the next request."""
        with self._state_lock:
            if self.cancelled or self.event.is_set():
                return False
            self.claimed = True
            return True

    def cancel(self) -> bool:
        """Client-side withdrawal: wins only while still queued (never
        claimed by assembly, not yet terminal). On success the request
        finishes with a typed :class:`RequestCancelled`."""
        from .errors import RequestCancelled

        with self._state_lock:
            if self.claimed or self.event.is_set():
                return False
            self.cancelled = True
        self.finish(error=RequestCancelled(
            "request cancelled by the client while queued (never "
            "dispatched; the queue slot is reclaimed at the next drain)"))
        return True


class ServeFuture:
    """Client-side handle for a submitted request."""

    def __init__(self, req: _Request):
        self._req = req

    def done(self) -> bool:
        return self._req.event.is_set()

    @property
    def version(self):
        """The model version that answered (set with the result) —
        exactly one coherent version per request, even mid-swap."""
        return self._req.version

    @property
    def req_id(self) -> int:
        """The request's correlation id — the key its trace spans
        (``serving.submit`` / ``serving.request``) carry."""
        return self._req.req_id

    def cancel(self) -> bool:
        """Withdraw a still-queued request: True iff the cancel won the
        race against batch assembly. On True the request is NEVER
        dispatched, its queue slot is reclaimed at the next drain, and
        ``result()`` raises :class:`RequestCancelled`. On False the
        request already entered a batch (or finished) — its original
        outcome stands. A caller abandoning ``result(timeout=)`` should
        cancel() so its slot stops occupying the bounded queue."""
        return self._req.cancel()

    def cancelled(self) -> bool:
        return self._req.cancelled

    def result(self, timeout=None):
        """Block for the outcome; raises the request's typed error
        (RequestTimeout / EngineClosed / ...) if it failed. ``timeout``
        here is the CLIENT's patience — hitting it raises TimeoutError
        without cancelling the request (call :meth:`cancel` to also
        withdraw it)."""
        if not self._req.event.wait(timeout):
            raise TimeoutError(
                f"serving result not ready within {timeout}s (the request "
                "is still in flight; its own deadline governs shedding — "
                "cancel() withdraws it if it is still queued)")
        if self._req.error is not None:
            raise self._req.error
        return self._req.result


class ContinuousBatcher:
    """Scheduler thread turning single requests into bucket batches.

    ``dispatch(bucket, requests)`` is the engine's execute hook: it runs
    the batch and calls ``finish`` on every request (the batcher
    backstops it — an exception from dispatch fails the whole group).
    ``on_expire(request)`` is invoked for deadline-expired requests
    (metrics), after the typed error is set.
    """

    #: lock protocol: lifecycle state flips only under the close lock, so
    #: submit/close cannot race on `_closed` and two closers never both
    #: join `_thread`
    _GUARDED_BY = {"_closed": "_close_lock", "_thread": "_close_lock",
                   "_abort": "_close_lock"}

    def __init__(self, dispatch, *, max_batch, max_wait, queue_cap,
                 on_expire=None, autostart=True, name="default"):
        self._dispatch = dispatch
        self._max_batch = int(max_batch)
        self._max_wait = float(max_wait)
        self._on_expire = on_expire
        self._name = str(name)  # metric label: the model this serves
        self._queue = queue.Queue(maxsize=int(queue_cap))
        self._closed = False
        self._abort = None  # error factory set by abort(); see _GUARDED_BY
        self._close_lock = threading.Lock()
        self._thread = None
        if autostart:
            self.start()

    def start(self):
        with self._close_lock:
            if self._thread is None and not self._closed:
                self._thread = threading.Thread(
                    target=self._run, name="mxtpu-serving-batcher",
                    daemon=True)
                self._thread.start()
        return self

    def qsize(self) -> int:
        return self._queue.qsize()

    # -- client side -------------------------------------------------------
    def submit(self, req: _Request):
        if self._closed:
            raise EngineClosed("serving engine is closed/paused; submit "
                               "refused (in-flight work was drained)")
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            raise ServerOverloaded(
                f"serving queue full ({self._queue.maxsize} requests, "
                "MXTPU_SERVE_QUEUE) — load shed; retry with backoff") \
                from None
        return req

    # -- scheduler thread --------------------------------------------------
    def _next_wake(self, pending):
        """Earliest future event: a group's max-wait flush or a request
        deadline (None = nothing pending, sleep until work arrives)."""
        wake = None
        for group in pending.values():
            if not group:
                continue
            t = group[0].t_submit + self._max_wait
            wake = t if wake is None else min(wake, t)
            for r in group:
                if r.deadline is not None:
                    wake = r.deadline if wake is None else min(wake, r.deadline)
        return wake

    def _admit(self, pending, req):
        pending.setdefault(req.bucket, []).append(req)

    def _expire(self, pending, now):
        from .errors import RequestTimeout

        for bucket, group in pending.items():
            kept = []
            for r in group:
                if r.event.is_set():
                    continue  # cancelled while pending: drop the entry
                if r.deadline is not None and now >= r.deadline:
                    r.finish(error=RequestTimeout(
                        f"deadline expired after "
                        f"{(now - r.t_submit) * 1e3:.1f} ms waiting for a "
                        f"bucket {r.bucket} batch slot"))
                    if self._on_expire is not None:
                        self._on_expire(r)
                else:
                    kept.append(r)
            pending[bucket] = kept

    def _flush(self, pending, bucket, force=False):
        """Dispatch FIFO prefixes of ``bucket``'s group while it fills a
        batch (or unconditionally under ``force`` — close-time drain)."""
        group = pending.get(bucket) or []
        while group:
            take, rows = [], 0
            while group and rows + group[0].rows <= self._max_batch:
                r = group.pop(0)
                if not r.claim():
                    continue  # cancelled entry: skipped at drain time
                take.append(r)
                rows += r.rows
            if not take:  # head alone exceeds max_batch: cannot happen
                break     # (submit validates rows <= max_batch)
            try:
                self._dispatch(bucket, take)
            except BaseException as e:  # propagate to every waiter
                for r in take:
                    if not r.event.is_set():
                        r.finish(error=e)
            if rows < self._max_batch and not force:
                break  # partial batch only flushes when due/forced
        pending[bucket] = group

    def _sweep(self, pending, force=False):
        now = time.perf_counter()
        self._expire(pending, now)
        for bucket in list(pending):
            group = pending[bucket]
            if not group:
                continue
            rows = 0
            for r in group:
                rows += r.rows
            due = group[0].t_submit + self._max_wait <= now
            if force or due or rows >= self._max_batch:
                self._flush(pending, bucket, force=force or due)

    def _run(self):
        pending = {}
        while True:
            wake = self._next_wake(pending)
            timeout = None if wake is None else \
                max(0.0, wake - time.perf_counter())
            t0 = time.perf_counter()
            try:
                item = self._queue.get(timeout=timeout)
            except queue.Empty:
                item = None
            if _obs.ENABLED:
                # idle-vs-busy split for the scheduler thread: blocked-
                # on-admission wall time (the serving analogue of the
                # prefetch consumer-wait counter; a counter inc, no sync)
                _obs.SERVE_SCHED_WAIT_SECONDS.inc(
                    time.perf_counter() - t0, model=self._name)
            closing = item is _CLOSE
            if item is not None and not closing:
                self._admit(pending, item)
            # greedy drain: admit the WHOLE backlog before scheduling,
            # so a burst coalesces into full batches instead of being
            # dispatched one newly-due request at a time
            while True:
                try:
                    extra = self._queue.get_nowait()
                except queue.Empty:
                    break
                if extra is _CLOSE:
                    closing = True
                else:
                    self._admit(pending, extra)
            if closing:
                with self._close_lock:
                    abort = self._abort
                if abort is not None:
                    # abrupt death: FAIL everything pending instead of
                    # dispatching it (waiters unblock typed, never hang)
                    for group in pending.values():
                        for r in group:
                            if not r.event.is_set():
                                r.finish(error=abort())
                    return
                # close-time drain: everything admitted before the
                # close dispatches (partial batches go out padded)
                self._sweep(pending, force=True)
                return
            self._sweep(pending)

    # -- shutdown ----------------------------------------------------------
    def abort(self, error_factory=None):
        """Abrupt-death hook (a replica kill, host-death simulation): refuse new submits and FAIL every queued request
        with ``error_factory()`` instead of dispatching it — the
        opposite of ``close()``'s graceful drain. In-flight waiters
        unblock immediately with a typed error, never hang."""
        def _default():
            return EngineClosed("engine killed (abrupt replica death); "
                                "queued work was failed, not drained")

        make = error_factory or _default
        with self._close_lock:
            self._closed = True
            self._abort = make
            thread = self._thread
        if thread is not None:
            while True:  # a full queue drains continuously under _run
                try:
                    self._queue.put_nowait(_CLOSE)
                    break
                except queue.Full:
                    time.sleep(0.001)
            thread.join(timeout=10.0)
        # whether or not a scheduler thread ever ran, nothing may stay
        # queued: fail the stragglers here (idempotent with _run's own
        # abort drain — finished requests are skipped)
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not _CLOSE and not req.event.is_set():
                req.finish(error=make())
        with self._close_lock:
            self._thread = None

    def close(self):
        """Idempotent: refuse new submits, drain accepted requests
        (partial batches dispatch), join the scheduler thread."""
        with self._close_lock:
            first = not self._closed
            self._closed = True
            thread = self._thread
        if not first:
            # a concurrent/second closer still waits for the drain, but
            # the JOIN happens outside the lock: holding it across a
            # 10 s wait would convoy submit()/start() (lock-order rule)
            if thread is not None:
                thread.join(timeout=10.0)
                with self._close_lock:
                    self._thread = None
            return
        if thread is None:
            # never started (autostart=False): fail queued requests —
            # nothing will ever dispatch them
            while True:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    return
                if req is not _CLOSE and not req.event.is_set():
                    req.finish(error=EngineClosed(
                        "engine closed before its scheduler started"))
        self._queue.put(_CLOSE)
        thread.join(timeout=10.0)
        with self._close_lock:
            self._thread = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
