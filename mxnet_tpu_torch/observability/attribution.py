"""Step-time attribution plane: per-phase accounting for the train loop.

PyTorch counterpart of ``mxnet_tpu/observability/attribution.py`` (host code:
the same classes, names and output).

The stack emits every primitive performance signal — prefetcher
consumer-wait (`mxtpu_data_prefetch_wait_seconds_total`), `data.h2d`
staging spans, trainer/superstep dispatch spans, the overlap probe's
exposed-comm gauge, checkpoint tick time — but nothing JOINS them, so
"why is this step 80.9 ms" is a human reading five metric families side
by side. This module closes that gap (the MXNet ``src/profiler/``
operator-attribution capability, rebuilt on signals the hot paths
already record): at each step boundary it splits the step PERIOD (end
of the previous step to the end of this one) into

    {input_wait, h2d, compute, comm_exposed, ckpt_overhead, host_gap}

- ``input_wait``    — consumer wall time blocked on the prefetch queue
                      (delta of the PR-4 counter),
- ``h2d``           — host->device staging latency (delta of the
                      ``data.h2d`` histogram sum; staged concurrently by
                      the producer thread, so it is capped at the
                      period budget remaining),
- ``ckpt_overhead`` — in-loop checkpoint tick cost (snapshot dispatch +
                      enqueue; the background WRITE is never loop time),
- ``comm_exposed``  — gradient-communication time not hidden behind
                      compute: host-measured comm dispatches (kvstore
                      allreduce, the staged SPMD comm leg) when they
                      exist, else the overlap probe's per-step
                      exposed-comm figure for the running mode,
- ``compute``       — the dispatch span minus exposed comm,
- ``host_gap``      — the non-negative residual (python overhead, loss
                      construction, logging — everything unattributed).

Phases are computed with a BUDGET decomposition (each phase is capped
by the period time still unaccounted for, in the order above), which
makes two invariants hold by construction: every phase is >= 0 and the
phases sum exactly to the step period (so sum(phases) <= any outer
wall-time measurement of the same steps).

Everything here is host arithmetic over already-recorded host floats:
ZERO added device dispatches and zero device syncs per step (pinned by
the regression test). Published three ways:

- ``mxtpu_step_phase_seconds{phase=}`` histograms (per-step amortized —
  a K-step superstep divides its dispatch across its K iterations),
- ``mxtpu_step_phase_last_seconds{phase=}`` — a LAZY SeriesGauge over
  the last-N per-step records (the stored value is a live view; the
  list materializes only at read/exposition time),
- a ``step.phases`` trace span per dispatch (the timeline/doctor food),

and the whole family rides PR-15 federation automatically (federation
serializes the full registry), so the cluster view gets per-rank phase
skew for free.

Switch: ``MXTPU_ATTRIBUTION`` (default ON — the plane arms whenever
telemetry itself is on; every hook site checks ``observability.ENABLED``
first, so with telemetry off the cost is one module-bool read).
"""

from __future__ import annotations

import collections
import threading

from ..base import getenv

#: THE switch (same pattern as watchdog.ENABLED / chaos.ENABLED): hot
#: sites read one module attribute — effective only when the telemetry
#: master switch (observability.ENABLED) is also on.
ENABLED = bool(getenv("MXTPU_ATTRIBUTION", True, dtype=bool))

#: phase keys, in BUDGET order (each capped at the period time still
#: unaccounted for; host_gap is the residual and comes last)
PHASES = ("input_wait", "h2d", "ckpt_overhead", "comm_exposed",
          "compute", "host_gap")

#: per-step records kept for the series gauge / flight bundle / bench
_RECORDS = 128

_STATE = {
    "last_t1": None,        # perf_counter of the previous step boundary
    "prev_wait": 0.0,       # cumulative counters at the last boundary
    "prev_h2d": 0.0,
    "prev_ckpt": 0.0,
    "prev_comm": 0.0,
    "comm_extra": 0.0,      # host-timed comm dispatches (note_comm)
    "comm_hint": {},        # overlap-probe exposed s/step, by comm mode
    "wait_max": 0.0,        # longest single consumer wait since the
                            # last boundary (prefetcher spike evidence)
    "records": collections.deque(maxlen=_RECORDS),
}
_LOCK = threading.RLock()

#: machine-checked lock protocol (mxtpu-lint thread-guard): the state is
#: shared between the trainer thread (record_step), the prefetcher
#: consumer (note_input_wait) and probe/report readers
_GUARDED_BY = {"_STATE": "_LOCK"}


def set_enabled(on: bool) -> bool:
    """Flip the attribution plane at runtime; returns the prior state."""
    global ENABLED
    prev, ENABLED = ENABLED, bool(on)
    return prev


def reset():
    """Pristine plane state (test isolation / bench scenario boundary):
    cumulative-counter anchors re-seed at the NEXT record_step, so a
    reset mid-run never attributes another scenario's backlog."""
    from . import (CHECKPOINT_TICK_SECONDS, DATA_H2D_SECONDS,
                   DATA_PREFETCH_WAIT_SECONDS, KV_ALLREDUCE_SECONDS)

    with _LOCK:
        _STATE["last_t1"] = None
        _STATE["prev_wait"] = DATA_PREFETCH_WAIT_SECONDS.total()
        _STATE["prev_h2d"] = DATA_H2D_SECONDS.sum()
        _STATE["prev_ckpt"] = CHECKPOINT_TICK_SECONDS.total()
        _STATE["prev_comm"] = KV_ALLREDUCE_SECONDS.sum() \
            + _STATE["comm_extra"]
        _STATE["comm_hint"] = {}
        _STATE["wait_max"] = 0.0
        _STATE["records"].clear()


# ---------------------------------------------------------------------------
# feeder hooks (cheap accumulators written by OTHER hot paths)
# ---------------------------------------------------------------------------

def note_input_wait(dt: float):
    """Prefetcher consumer hook: track the longest SINGLE queue wait
    since the last step boundary (the running total already lives in
    ``mxtpu_data_prefetch_wait_seconds_total``; the max is what makes a
    one-off stall distinguishable from uniform slowness)."""
    if dt > _STATE["wait_max"]:
        with _LOCK:
            if dt > _STATE["wait_max"]:
                _STATE["wait_max"] = dt


def note_comm(dt: float):
    """A host-timed communication dispatch (e.g. the staged SPMD comm
    leg) — accumulated and attributed to ``comm_exposed`` at the next
    step boundary."""
    with _LOCK:
        _STATE["comm_extra"] += dt


def set_comm_hint(exposed_by_mode):
    """Overlap-probe wiring (``parallel.overlap.measure_overlap``): the
    per-step exposed-comm seconds by comm mode. Used for in-graph comm
    schedules (``ready``/``barrier``) where no host-side timestamp can
    see the wire time — the probe's figure is the best available
    estimate until the next probe."""
    with _LOCK:
        _STATE["comm_hint"] = dict(exposed_by_mode or {})


# ---------------------------------------------------------------------------
# the decomposition (called at step boundaries by the trainer hot paths)
# ---------------------------------------------------------------------------

class _SeriesView:
    """Lazy view for ``mxtpu_step_phase_last_seconds``: the SeriesGauge
    stores this object once; the per-phase list materializes only when
    the gauge is READ (exposition / flight dump), never per step."""

    __slots__ = ("phase",)

    def __init__(self, phase):
        self.phase = phase

    def tolist(self):
        with _LOCK:
            recs = list(_STATE["records"])
        return [r[self.phase] for r in recs]


_VIEWS = {ph: _SeriesView(ph) for ph in PHASES}


def record_step(t0: float, t1: float, k: int = 1, site: str = "trainer",
                comm_mode: str | None = None):
    """Attribute one step boundary. ``t0``/``t1`` bound the DISPATCH
    span the caller already measured; the attributed period runs from
    the previous boundary to ``t1`` (first record after reset: the
    dispatch span alone). ``k`` — training iterations the dispatch
    covered (a superstep passes its K; phases are published per-step
    amortized). ``comm_mode`` selects the overlap-probe hint when no
    host-measured comm exists. Pure host arithmetic — zero dispatches.
    """
    from . import (CHECKPOINT_TICK_SECONDS, DATA_H2D_SECONDS,
                   DATA_PREFETCH_WAIT_DELTA, DATA_PREFETCH_WAIT_SECONDS,
                   KV_ALLREDUCE_SECONDS, STEP_PHASE_LAST,
                   STEP_PHASE_SECONDS, _TRACER)

    wait_cum = DATA_PREFETCH_WAIT_SECONDS.total()
    h2d_cum = DATA_H2D_SECONDS.sum()
    ckpt_cum = CHECKPOINT_TICK_SECONDS.total()
    with _LOCK:
        comm_cum = KV_ALLREDUCE_SECONDS.sum() + _STATE["comm_extra"]
        last = _STATE["last_t1"]
        d_wait = max(wait_cum - _STATE["prev_wait"], 0.0)
        d_h2d = max(h2d_cum - _STATE["prev_h2d"], 0.0)
        d_ckpt = max(ckpt_cum - _STATE["prev_ckpt"], 0.0)
        d_comm = max(comm_cum - _STATE["prev_comm"], 0.0)
        wait_max = _STATE["wait_max"]
        hint = _STATE["comm_hint"].get(comm_mode) if comm_mode else None
        _STATE["last_t1"] = t1
        _STATE["prev_wait"] = wait_cum
        _STATE["prev_h2d"] = h2d_cum
        _STATE["prev_ckpt"] = ckpt_cum
        _STATE["prev_comm"] = comm_cum
        _STATE["wait_max"] = 0.0

    kk = max(int(k), 1)  # python int, never a device scalar  # mxtpu-lint: host-sync-ok
    dispatch = max(t1 - t0, 0.0)
    period = max(t1 - last, dispatch) if last is not None else dispatch
    if hint is not None and d_comm <= 0.0:
        # in-graph comm schedule: no host timestamp sees the wire time;
        # use the probe's per-step exposed figure (never ADDED to a
        # host-measured value — that would double-count)
        d_comm = max(float(hint), 0.0) * kk  # host float from the probe  # mxtpu-lint: host-sync-ok

    # budget decomposition: each phase caps at the unaccounted period
    # time -> every phase >= 0 and sum(phases) == period, by construction
    budget = period
    input_wait = min(d_wait, budget)
    budget -= input_wait
    h2d = min(d_h2d, budget)
    budget -= h2d
    ckpt = min(d_ckpt, budget)
    budget -= ckpt
    comm = min(d_comm, dispatch, budget)
    budget -= comm
    compute = min(max(dispatch - comm, 0.0), budget)
    budget -= compute
    host_gap = max(budget, 0.0)

    rec = {"site": site, "step": _TRACER.step, "k": kk,
           "period_s": period, "dispatch_s": dispatch,
           "input_wait": input_wait / kk, "h2d": h2d / kk,
           "ckpt_overhead": ckpt / kk, "comm_exposed": comm / kk,
           "compute": compute / kk, "host_gap": host_gap / kk,
           "input_wait_max_s": wait_max}
    for ph in PHASES:
        STEP_PHASE_SECONDS.observe(rec[ph], phase=ph)
        STEP_PHASE_LAST.set_series(_VIEWS[ph], phase=ph)
    # the promoted per-step delta series (satellite of the PR-4 counter):
    # a spike is VISIBLE here where the running total hides it — the
    # watchdog's input_wait detector reads exactly this gauge
    DATA_PREFETCH_WAIT_DELTA.set(rec["input_wait"])
    with _LOCK:
        _STATE["records"].append(rec)
    _TRACER.record(
        "step.phases", cat="attribution", ts=t1 - period, dur=period,
        args={"site": site, "k": kk,
              "period_ms": round(period * 1e3, 4),
              "dispatch_ms": round(dispatch * 1e3, 4),
              **{f"{ph}_ms": round(rec[ph] * 1e3, 4) for ph in PHASES}})
    return rec


# ---------------------------------------------------------------------------
# read side (reports / flight bundle / bench stamps — off the hot path)
# ---------------------------------------------------------------------------

def records() -> list:
    """The last-N per-step phase records (plain dicts of floats)."""
    with _LOCK:
        return [dict(r) for r in _STATE["records"]]


def last_record():
    """The most recent phase record, or None before the first step."""
    with _LOCK:
        return dict(_STATE["records"][-1]) if _STATE["records"] else None


def mean_phases(site=None, last_n=None) -> dict:
    """Mean per-step phase seconds over the recent records (optionally
    filtered by ``site`` and truncated to the last ``last_n``); adds
    ``step_wall`` (mean per-step period) and ``count``. Empty dict when
    nothing was recorded — callers degrade gracefully."""
    recs = records()
    if site is not None:
        recs = [r for r in recs if r["site"] == site]
    if last_n:
        recs = recs[-int(last_n):]
    if not recs:
        return {}
    n = len(recs)
    out = {ph: sum(r[ph] for r in recs) / n for ph in PHASES}
    out["step_wall"] = sum(r["period_s"] / r["k"] for r in recs) / n
    out["count"] = n
    return out
