"""Typed serving errors (PyTorch port of ``mxnet_tpu/serving/errors.py``,
same classes, same hierarchy) — every way a request can fail has its own
class, so front-ends map outcomes to response codes by type (load shed
-> 503, deadline -> 504, refused shape -> 400) instead of parsing
message strings. All subclass :class:`~mxnet_tpu_torch.base.MXNetError`.
"""

from __future__ import annotations

from ..base import MXNetError


class ServingError(MXNetError):
    """Base class for every serving-layer failure."""


class ServerOverloaded(ServingError):
    """Load shed: the bounded request queue was full at submit time
    (backpressure — the client should retry with backoff or reroute).
    The request was REJECTED, never partially processed."""


class RequestTimeout(ServingError):
    """The request's deadline expired before its batch dispatched.
    Typed — a deadline miss is never answered with a stale result."""


class RequestTooLarge(ServingError):
    """A single request carries more rows than ``max_batch`` — it can
    never fit in one dispatch. Split it client-side (the engine never
    splits implicitly: partial results are not a thing)."""


class EngineClosed(ServingError):
    """Submit after ``close()`` (or to a paused standby version).
    In-flight requests at close time still complete — only NEW work is
    refused."""


class RetraceForbidden(ServingError):
    """The sealed engine refused an input signature with no AOT
    executable (retrace budget is 0 after warmup). The message names
    the cause (shape/dtype/arity — ``gluon.block.signature_causes``)
    and the known buckets; fix the client or add a bucket and
    redeploy."""


class StagedLoadError(ServingError):
    """A staged model load failed build/warmup/verification. The stage
    was discarded — the previous live version never stopped serving."""


class RequestCancelled(ServingError):
    """The client cancelled a still-queued request (``ServeFuture.
    cancel()``). The request was never dispatched — its queue slot is
    reclaimed at the next drain and no compute was spent on it. A
    request that already entered batch assembly can NOT be cancelled
    (cancel() returns False); exactly one of {dispatch, cancel} wins."""


class ReplicaDead(ServingError):
    """ONE replica died with this request on it (host kill, broken
    pipe, heartbeat death). An internal routing signal: the fleet
    router catches it and retries the request on a surviving replica —
    fleet callers only ever see :class:`ReplicaLost`, and only when
    every candidate failed."""


class ReplicaLost(ServingError):
    """Fleet-level terminal failure: EVERY candidate replica was tried
    (at most once each) and all failed with a replica-death class error.
    Raised only after the router's retry-with-backoff is exhausted —
    a single host kill never surfaces this while a survivor exists."""


class KVCacheOOM(ServerOverloaded):
    """The paged KV cache's block pool could not supply the blocks a
    generation request needs (admission reservation or mid-decode
    growth). Subclasses :class:`ServerOverloaded` — the request was
    refused (or retired early with the tokens produced so far), never
    left holding a partially-backed cache; the client should retry
    after other sequences complete or the pool is resized
    (``MXTPU_KVCACHE_BLOCKS``)."""


class BrownoutShed(ServerOverloaded):
    """Degraded-mode load shed: the fleet's latched brownout state
    machine refused this request's priority class (``bulk`` sheds
    before ``interactive`` before ``critical``). Subclasses
    :class:`ServerOverloaded` so existing 503 mappings apply, but typed
    so clients can tell policy shedding from a full queue."""
