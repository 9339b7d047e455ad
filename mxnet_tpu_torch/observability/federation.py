"""Cross-rank metric federation: the job-scope view of the registry.

PyTorch counterpart of ``mxnet_tpu/observability/federation.py``: the
same snapshots, cluster table and exposition; a rank is a
``torch.distributed`` rank and the exchange is the port's
``kvstore.dist.all_gather_bytes``.

Every observability surface below this module is per-process: rank 0's
``/metrics`` says nothing about rank 5's straggling allreduce. This
module turns the per-process registries into ONE cluster picture:

- each rank periodically serializes its ``MetricsRegistry`` into a
  plain-JSON snapshot and publishes it over the kvstore side-channel
  (``kvstore/dist.py::all_gather_bytes`` — the existing collective
  plumbing, NOT a new transport; no server processes, no sockets),
- rank 0 (any rank, really — the gather is symmetric) merges the
  snapshots and exposes them at ``GET /metrics/cluster``: every series
  re-labeled with ``rank="r"``, plus job-level aggregates under
  ``rank="all"`` (sum for counters, min/median/max for gauges,
  element-wise merged buckets for histograms),
- a rank whose snapshot age exceeds ``MXTPU_FEDERATION_STALE_S`` is
  MARKED via ``mxtpu_federation_stale_ranks{rank=...} 1`` — its last
  series stay visible; silence is a signal, never a silent drop,
- the per-rank ``step_epoch`` (the shared tracer step id stamped by
  ``Trainer.step``/``Superstep.step``) rides every snapshot, so
  ``tools/telemetry_report.py`` can line the same step up across ranks
  (the cross-rank straggler/skew picture).

Collective-ordering contract: cross-process collectives must enter
the wire in the SAME order on every rank, and each rank's publisher
timer fires on an independent clock — so the daemon thread NEVER
issues collectives. It only refreshes this rank's local row + the
meta gauges. The multi-process ``exchange()`` is driven exclusively
from ``poll()``, the step-boundary hook the trainer calls on the same
thread as the pushpull (like ``watchdog.poll``): it fires on a
step-count beat (``MXTPU_FEDERATION_BEAT_STEPS``) derived from the
shared tracer step, and synchronous data-parallel ranks execute
identical step sequences, so every rank enters the gather between the
same two training allreduces.

Hot-path contract (pinned by the dispatch-count regression test): the
training loop NEVER blocks on per-step federation work. Snapshots are
taken on the publisher daemon thread (or an HTTP handler thread);
lazy device scalars stored by ``Gauge.set_lazy`` float exactly there
— zero added dispatches, zero added syncs per step. In a multi-process
world the beat-step exchange is the one deliberate exception: two
watchdog-timed collectives every ``MXTPU_FEDERATION_BEAT_STEPS``
steps, amortized off the steady-state step cost.

Switch: ``MXTPU_FEDERATION=1`` arms the background publisher
(interval ``MXTPU_FEDERATION_INTERVAL_S``) and the step-beat poll;
``exchange()`` / ``publish_local()`` work without it for
deterministic tests.
"""

from __future__ import annotations

import json
import logging
import threading
import time

from ..base import getenv
from .metrics import Histogram, MetricsRegistry, SeriesGauge

_logger = logging.getLogger("mxnet_tpu_torch.observability.federation")

#: rank -> {"snap": decoded snapshot dict, "recv": monotonic receive time}
_CLUSTER = {}
_CLUSTER_LOCK = threading.Lock()

_PUBLISHER = {"thread": None, "stop": None}
_PUB_LOCK = threading.Lock()

#: step-beat state for the trainer-driven exchange: armed by start(),
#: consumed by poll() on the trainer thread. ``last_idx`` is the last
#: beat index (tracer step // MXTPU_FEDERATION_BEAT_STEPS) exchanged —
#: pure step arithmetic, identical on every rank by construction.
_BEAT = {"active": False, "last_idx": -1}

#: machine-checked lock protocol (mxtpu-lint thread-guard): the cluster
#: table is written by the publisher/HTTP threads and read by the
#: exposition path concurrently; the publisher singleton and the beat
#: state mutate only under the publisher lock so start/stop cannot
#: leak a second daemon thread or a stale beat counter
_GUARDED_BY = {"_CLUSTER": "_CLUSTER_LOCK", "_PUBLISHER": "_PUB_LOCK",
               "_BEAT": "_PUB_LOCK"}


def federation_enabled() -> bool:
    """``MXTPU_FEDERATION`` (default off): arm the background publisher
    thread at first Context creation."""
    return bool(getenv("MXTPU_FEDERATION", False, dtype=bool))


def federation_interval_s() -> float:
    """``MXTPU_FEDERATION_INTERVAL_S`` (default 10): publisher cadence."""
    return float(getenv("MXTPU_FEDERATION_INTERVAL_S", 10.0, dtype=float))


def federation_stale_s() -> float:
    """``MXTPU_FEDERATION_STALE_S`` (default 30): snapshot age beyond
    which a rank is marked stale (0 disables marking)."""
    return float(getenv("MXTPU_FEDERATION_STALE_S", 30.0, dtype=float))


def federation_beat_steps() -> int:
    """``MXTPU_FEDERATION_BEAT_STEPS`` (default 32): trainer steps
    between multi-process exchanges. A step count, not seconds — the
    beat must be derived from state every rank advances identically
    (the shared step counter), never a per-rank wall clock."""
    return max(1, int(getenv("MXTPU_FEDERATION_BEAT_STEPS", 32,
                             dtype=int)))


# ---------------------------------------------------------------------------
# snapshot / ingest
# ---------------------------------------------------------------------------

def _encode_key(key: tuple) -> str:
    """Label key tuple -> canonical JSON string (snapshots are JSON)."""
    return json.dumps([list(p) for p in key])


def _decode_key(s: str) -> tuple:
    return tuple((str(k), str(v)) for k, v in json.loads(s))


def _float(v) -> float:
    try:
        return float(v)  # mxtpu-lint: host-sync-ok
    except (TypeError, ValueError):
        return float("nan")


def _metric_kind(m) -> str:
    if isinstance(m, Histogram):
        return "histogram"
    if isinstance(m, SeriesGauge):
        return "series_gauge"
    return m.kind


def snapshot(rank=None):  # mxtpu-lint: hot-path
    """Serialize the process registry into a plain-JSON dict.

    Runs on the publisher/HTTP thread, never the training loop: this is
    exactly where lazy device scalars (``Gauge.set_lazy``, the
    superstep's series gauges) float to plain floats — the deliberate
    off-hot-path sync point.
    """
    from . import _REGISTRY, _TRACER

    if rank is None:
        rank = _process_index()
    metrics = {}
    for m in _REGISTRY.metrics():
        vals = {}
        for key in list(m._values):
            raw = m._values.get(key)
            if raw is None:
                continue
            if isinstance(m, Histogram):
                vals[_encode_key(key)] = [_float(x) for x in raw]
            elif isinstance(m, SeriesGauge):
                if hasattr(raw, "tolist"):
                    raw = raw.tolist()  # mxtpu-lint: host-sync-ok
                vals[_encode_key(key)] = [_float(x) for x in raw]
            else:
                vals[_encode_key(key)] = _float(raw)
        if not vals:
            continue
        entry = {"kind": _metric_kind(m), "help": m.help, "values": vals}
        if isinstance(m, Histogram):
            entry["buckets"] = list(m.buckets)
        metrics[m.name] = entry
    return {
        "rank": int(rank),  # mxtpu-lint: host-sync-ok
        "wall": time.time(),
        # host-side step counter, not a device value
        "step_epoch": int(_TRACER.step),  # mxtpu-lint: host-sync-ok
        "metrics": metrics,
    }


def _process_index() -> int:
    from ..parallel.mesh import world

    return world()[0]


def _world_size() -> int:
    from ..parallel.mesh import world

    return world()[1]


def ingest(snap: dict, recv_mono=None):
    """Record one rank's snapshot into the cluster table (the seam the
    exchange path, tests and bench synthetic ranks all feed)."""
    rank = int(snap.get("rank", 0))
    entry = {"snap": snap,
             "recv": time.monotonic() if recv_mono is None else recv_mono}
    with _CLUSTER_LOCK:
        _CLUSTER[rank] = entry
    return rank


def publish_local():
    """Snapshot THIS rank and ingest it locally (the single-process
    degenerate exchange; also refreshes our own row before exposition
    so the serving rank is never its own stale entry)."""
    return ingest(snapshot())


def exchange():
    """All-gather every rank's snapshot over the kvstore side-channel
    and ingest them all. Raises on collective failure (the step-beat
    ``poll()`` catches and degrades to ``publish_local``; a dist test
    lets the platform error surface so the launcher skip-contract
    applies).

    Call ONLY from a point ordered identically on every rank — the
    step-boundary ``poll()`` or a synchronous test — never from a
    free-running thread: the two side-channel collectives must
    interleave with the training allreduces in the same order on
    every process (see ``all_gather_bytes``).
    """
    snap = snapshot()
    payload = json.dumps(snap, default=float).encode("utf-8")
    from ..kvstore.dist import all_gather_bytes

    blobs = all_gather_bytes(payload)
    now = time.monotonic()
    for blob in blobs:
        if not blob:
            continue
        ingest(json.loads(blob.decode("utf-8")), recv_mono=now)
    return len(blobs)


def reset():
    """Drop every ingested snapshot (test isolation)."""
    with _CLUSTER_LOCK:
        _CLUSTER.clear()


# ---------------------------------------------------------------------------
# staleness + cluster meta gauges
# ---------------------------------------------------------------------------

def cluster_ranks() -> list:
    with _CLUSTER_LOCK:
        return sorted(_CLUSTER)


def stale_ranks(now=None) -> list:
    """Ranks whose snapshot age exceeds ``MXTPU_FEDERATION_STALE_S``."""
    limit = federation_stale_s()
    if limit <= 0:
        return []
    now = time.monotonic() if now is None else now
    with _CLUSTER_LOCK:
        ages = {r: now - e["recv"] for r, e in _CLUSTER.items()}
    return sorted(r for r, age in ages.items() if age > limit)


def cluster_values(metric, match=None, fresh_only=True, now=None):
    """Consumer API: per-rank values of one scalar metric across the
    ingested cluster table — ``{rank: float}``.

    ``match`` filters labelsets by a subset dict (e.g. ``{"model":
    "resnet"}``); multiple surviving labelsets per rank are summed.
    With ``fresh_only`` (default) stale ranks are EXCLUDED — a
    consumer that gets ``{}`` back knows the federation is cold and
    must fall back to local signals (the fleet router's
    consistent-hash fallback). Histogram/series metrics are skipped:
    this reads the scalar plane (queue depths, counters, gauges)."""
    match = match or {}
    stale = set(stale_ranks(now)) if fresh_only else ()
    out = {}
    with _CLUSTER_LOCK:
        snaps = {r: e["snap"] for r, e in _CLUSTER.items()
                 if r not in stale}
    for rank, snap in snaps.items():
        entry = (snap.get("metrics") or {}).get(metric)
        if not entry or entry.get("kind") in ("histogram", "series_gauge"):
            continue
        total, hit = 0.0, False
        for enc, value in (entry.get("values") or {}).items():
            try:
                labels = dict(_decode_key(enc))
            except Exception:
                continue
            if any(labels.get(k) != str(v) for k, v in match.items()):
                continue
            if isinstance(value, (int, float)) and value == value:
                total += float(value)
                hit = True
        if hit:
            out[rank] = total
    return out


def update_cluster_meta(now=None):
    """Refresh the federation meta gauges in the LOCAL registry (they
    ride the next snapshot like any other series): rank count, per-rank
    snapshot age, per-rank stale flag, per-rank last step_epoch."""
    from . import (
        FEDERATION_LAST_STEP,
        FEDERATION_RANKS,
        FEDERATION_SNAPSHOT_AGE_SECONDS,
        FEDERATION_STALE_RANKS,
    )

    now = time.monotonic() if now is None else now
    stale = set(stale_ranks(now))
    with _CLUSTER_LOCK:
        entries = {r: (now - e["recv"], e["snap"].get("step_epoch", 0))
                   for r, e in _CLUSTER.items()}
    FEDERATION_RANKS.set(len(entries))
    for r, (age, step) in entries.items():
        FEDERATION_SNAPSHOT_AGE_SECONDS.set(age, rank=str(r))
        FEDERATION_STALE_RANKS.set(1.0 if r in stale else 0.0, rank=str(r))
        FEDERATION_LAST_STEP.set(float(step), rank=str(r))
    return sorted(stale)


# ---------------------------------------------------------------------------
# merged exposition
# ---------------------------------------------------------------------------

def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    if not n:
        return 0.0
    mid = n // 2
    return xs[mid] if n % 2 else (xs[mid - 1] + xs[mid]) / 2.0


def _rekey(key: tuple) -> list:
    # a base series may itself carry a rank="…" label (the federation
    # meta gauges are BY observed rank): rename it to peer="…" so the
    # publisher's own rank label stays unique in the merged exposition
    return [("peer", v) if k == "rank" else (k, v) for k, v in key]


def _with_rank(key: tuple, rank: str) -> tuple:
    return tuple(sorted(_rekey(key) + [("rank", rank)]))


def _with_agg(key: tuple, rank: str, agg: str) -> tuple:
    return tuple(sorted(_rekey(key) + [("rank", rank), ("agg", agg)]))


def cluster_registry() -> MetricsRegistry:
    """Merge every ingested snapshot into a fresh registry: per-rank
    series under ``rank="r"`` plus job aggregates under ``rank="all"``
    (counters sum; gauges min/median/max; histogram bucket lists merge
    element-wise when the rank bucket layouts agree)."""
    with _CLUSTER_LOCK:
        snaps = {r: e["snap"] for r, e in sorted(_CLUSTER.items())}

    reg = MetricsRegistry()
    # name -> {"kind", "help", "buckets", "by_key": {base key: {rank: value}}}
    merged = {}
    for rank, snap in snaps.items():
        for name, ent in (snap.get("metrics") or {}).items():
            slot = merged.setdefault(name, {
                "kind": ent.get("kind", "gauge"),
                "help": ent.get("help", ""),
                "buckets": ent.get("buckets"),
                "bucket_mismatch": False,
                "by_key": {},
            })
            if slot["kind"] == "histogram" and ent.get("buckets") is not None:
                if slot["buckets"] is None:
                    slot["buckets"] = ent["buckets"]
                elif list(slot["buckets"]) != list(ent["buckets"]):
                    slot["bucket_mismatch"] = True
            for enc_key, value in (ent.get("values") or {}).items():
                try:
                    key = _decode_key(enc_key)
                except (ValueError, TypeError):
                    continue
                slot["by_key"].setdefault(key, {})[rank] = value

    for name in sorted(merged):
        slot = merged[name]
        kind = slot["kind"]
        if kind == "counter":
            m = reg.counter(name, slot["help"])
        elif kind == "histogram":
            m = reg.histogram(name, slot["help"],
                              buckets=slot["buckets"] or None)
        elif kind == "series_gauge":
            m = reg.series_gauge(name, slot["help"])
        else:
            m = reg.gauge(name, slot["help"])
        for key, by_rank in slot["by_key"].items():
            for rank, value in by_rank.items():
                if kind == "histogram" and not (
                        isinstance(value, list)
                        and len(value) == len(m.buckets) + 3):
                    # a rank running a different bucket layout can't be
                    # rendered against this exposition's `le` edges —
                    # drop the row rather than crash the scrape (its
                    # scalar series still expose; aggregates are
                    # already suppressed via bucket_mismatch)
                    continue
                m._values[_with_rank(key, str(rank))] = (
                    list(value) if isinstance(value, list) else value)
            # job-level aggregate under rank="all"
            if kind == "counter":
                m._values[_with_rank(key, "all")] = sum(
                    v for v in by_rank.values()
                    if isinstance(v, (int, float)))
            elif kind == "gauge":
                vals = [v for v in by_rank.values()
                        if isinstance(v, (int, float)) and v == v]
                if vals:
                    m._values[_with_agg(key, "all", "min")] = min(vals)
                    m._values[_with_agg(key, "all", "median")] = _median(vals)
                    m._values[_with_agg(key, "all", "max")] = max(vals)
            elif kind == "histogram" and not slot["bucket_mismatch"]:
                recs = [v for v in by_rank.values() if isinstance(v, list)]
                width = len(m.buckets) + 3  # buckets + Inf + sum + count
                recs = [r for r in recs if len(r) == width]
                if recs:
                    total = [0.0] * width
                    for rec in recs:
                        for i, x in enumerate(rec):
                            total[i] += x
                    # counts back to ints so exposition matches a local
                    # histogram byte-for-byte (sum stays float)
                    agg = [int(x) for x in total[:-2]] + [total[-2],
                                                          int(total[-1])]
                    m._values[_with_rank(key, "all")] = agg
            # series gauges stay per-rank: per-slot series from
            # different ranks are different dispatches, not one series
    return reg


def dump_prometheus_cluster() -> str:
    """The ``/metrics/cluster`` body: refresh our own snapshot + the
    meta gauges, then expose the merged per-rank registry."""
    publish_local()
    update_cluster_meta()
    # meta gauges changed after our snapshot was taken — refresh once
    # more so the exposed row carries the current stale/age picture
    publish_local()
    return cluster_registry().dump_prometheus()


def dump_cluster_snapshot(path=None) -> str:
    """JSON post-mortem bundle for ``tools/telemetry_report.py``: every
    rank's snapshot, the stale set, and this rank's trace events (so
    the report's existing per-process sections render from the same
    file)."""
    from . import _TRACER

    publish_local()
    stale = update_cluster_meta()
    with _CLUSTER_LOCK:
        ranks = {str(r): e["snap"] for r, e in sorted(_CLUSTER.items())}
    body = json.dumps({
        "federation": 1,
        "generated_wall": time.time(),
        "stale": [int(r) for r in stale],
        "ranks": ranks,
        "events": _TRACER.events(),
    }, default=float)
    if path:
        with open(path, "w") as f:
            f.write(body)
    return body


# ---------------------------------------------------------------------------
# background publisher
# ---------------------------------------------------------------------------

def _publish_once():  # mxtpu-lint: hot-path
    """One publisher heartbeat: refresh OUR row + the meta gauges.

    LOCAL ONLY — this runs on the daemon timer thread, whose clock is
    independent per rank, so it must never issue collectives: a
    federation gather launched here can interleave differently with
    the training loop's allreduces on different ranks (mismatched
    cross-process collective order deadlocks or corrupts results).
    The multi-process exchange lives in ``poll()``."""
    from . import FEDERATION_PUBLISH_TOTAL

    publish_local()
    FEDERATION_PUBLISH_TOTAL.inc()
    update_cluster_meta()


def _exchange_once():  # mxtpu-lint: hot-path
    """One step-beat exchange: failures degrade to a local publish
    (counted, logged) so the scrape endpoint never goes dark."""
    from . import FEDERATION_ERRORS_TOTAL, FEDERATION_PUBLISH_TOTAL

    try:
        exchange()
        FEDERATION_PUBLISH_TOTAL.inc()
    except Exception as e:
        FEDERATION_ERRORS_TOTAL.inc()
        _logger.warning("federation exchange failed (%s); publishing "
                        "locally only", e)
        try:
            publish_local()
        except Exception:
            _logger.exception("federation local publish failed")
    update_cluster_meta()


def poll():  # mxtpu-lint: hot-path
    """Trainer-cadence hook (the step thread, right after pushpull):
    the ONLY place a multi-process federation exchange runs.

    Fires on a step-count beat (``MXTPU_FEDERATION_BEAT_STEPS``)
    derived from the shared tracer step: synchronous data-parallel
    ranks execute identical step sequences, so every rank reaches the
    same beat between the same two training allreduces — the
    side-channel collectives stay identically ordered across the
    world, which a per-rank interval timer cannot guarantee.
    Single-process worlds are fully covered by the daemon heartbeat;
    there poll() is a no-op (the zero-added-dispatch contract)."""
    if not _BEAT["active"]:
        return False
    if _world_size() <= 1:
        return False
    from . import _TRACER

    idx = _TRACER.step // federation_beat_steps()
    with _PUB_LOCK:
        if idx <= _BEAT["last_idx"]:
            return False
        _BEAT["last_idx"] = idx
    _exchange_once()
    return True


def _publisher_loop(stop, interval):  # mxtpu-lint: hot-path
    while not stop.wait(interval):
        _publish_once()


def start(interval=None) -> bool:
    """Start the publisher daemon thread and arm the step-beat poll
    (idempotent)."""
    if interval is None:
        interval = federation_interval_s()
    with _PUB_LOCK:
        if _PUBLISHER["thread"] is not None and \
                _PUBLISHER["thread"].is_alive():
            return False
        stop_ev = threading.Event()
        t = threading.Thread(
            target=_publisher_loop, args=(stop_ev, float(interval)),
            name="mxtpu-federation", daemon=True)
        _PUBLISHER.update(thread=t, stop=stop_ev)
        _BEAT.update(active=True, last_idx=-1)
        t.start()
    return True


def stop():
    """Stop the publisher thread and disarm the step-beat poll
    (idempotent); join outside the lock."""
    with _PUB_LOCK:
        t, ev = _PUBLISHER["thread"], _PUBLISHER["stop"]
        _PUBLISHER.update(thread=None, stop=None)
        _BEAT.update(active=False, last_idx=-1)
    if ev is not None:
        ev.set()
    if t is not None:
        t.join(timeout=5)


def maybe_start():
    """Arm from ``MXTPU_FEDERATION=1`` (first-Context wiring, same
    deferred hookup as the metrics endpoint); no-op otherwise."""
    if federation_enabled():
        start()
