"""Fused-train-step policy of the port: one switch, one fallback funnel.

PyTorch counterpart of the part of ``mxnet_tpu/fusedstep.py`` that the
single-device Trainer and ``SPMDTrainStep`` read:

- ``ENABLED`` — the switch, seeded from ``MXTPU_FUSED_STEP`` (default
  on): the multi-tensor update (``optimizer/multi_tensor.py``) instead of
  the per-parameter loop;
- ``log_fallback(site, reason)`` — every place the fast path declines
  funnels through here, logged once per (site, reason): the fallback is
  never silent, and never a wrong answer (the per-parameter path takes
  over);
- ``retrace_budget()`` — how many input-shape signatures a hybridized
  block may capture before it warns (``gluon/block.py``);
- ``superstep_k()`` / ``set_superstep_k()`` — the default K of
  ``gluon.Superstep`` (``MXTPU_SUPERSTEP_K``, default 1);
- the data-parallel knobs, with the reference's names and defaults:
  ``bucket_bytes()`` (``MXTPU_BUCKET_BYTES``, the kvstore's gradient
  buckets), ``amp_allreduce_dtype()`` (``MXTPU_AMP_ALLREDUCE_DTYPE``, the
  wire type of float32 buckets), ``overlap_mode()`` (``MXTPU_OVERLAP``),
  ``overlap_bucket_bytes()`` (``MXTPU_OVERLAP_BUCKET_BYTES``) and
  ``zero_stage()`` (``MXTPU_ZERO_STAGE``), read by ``kvstore`` and
  ``parallel.SPMDTrainStep``;
- the pipeline and MoE knobs, with the reference's names and defaults:
  ``pipeline_schedule()`` (``MXTPU_PIPELINE_SCHEDULE``) and
  ``pipeline_microbatches()`` (``MXTPU_PIPELINE_MICROBATCHES``), read by
  ``parallel.PipelineTrainStep`` and ``Composed4DStep``; ``moe_router()``
  (``MXTPU_MOE_ROUTER``), ``moe_capacity_factor()``
  (``MXTPU_MOE_CAPACITY_FACTOR``) and ``moe_a2a_chunks()``
  (``MXTPU_MOE_A2A_CHUNKS``), read by ``parallel.moe``;
- ``elastic_enabled()`` (``MXTPU_ELASTIC``), the pause points' switch
  (``resilience/elastic.py``).

The reference's ``DONATE`` has no counterpart (torch updates in place).
"""

from __future__ import annotations

import logging

from .base import getenv

#: Master switch for the fused update. Flip at runtime with set_enabled().
ENABLED = bool(getenv("MXTPU_FUSED_STEP", True, dtype=bool))

_RETRACE_BUDGET_DEFAULT = 8
_BUCKET_BYTES_DEFAULT = 4 << 20
_AMP_AR_DTYPES = ("bfloat16", "float16")
_OVERLAP_MODES = ("ready", "barrier", "staged")

#: K-step superstep: how many forward + backward + update iterations one
#: gluon.Superstep call runs (MXTPU_SUPERSTEP_K, default 1)
SUPERSTEP_K = max(1, int(getenv("MXTPU_SUPERSTEP_K", 1, dtype=int)))

_logger = logging.getLogger("mxnet_tpu_torch.fusedstep")
_LOGGED: set = set()


def enabled() -> bool:
    return ENABLED


def set_enabled(on: bool) -> bool:
    """Flip the fused update at runtime; returns the previous state."""
    global ENABLED
    prev, ENABLED = ENABLED, bool(on)
    return prev


def superstep_k() -> int:
    """Default iteration count of a ``gluon.Superstep``
    (``MXTPU_SUPERSTEP_K``); 1 makes each call one captured step."""
    return SUPERSTEP_K


def set_superstep_k(k: int) -> int:
    """Set the default superstep K; returns the previous value. Existing
    Superstep objects keep their K."""
    global SUPERSTEP_K
    prev, SUPERSTEP_K = SUPERSTEP_K, max(1, int(k))
    return prev


def retrace_budget() -> int:
    """Per-block budget of distinct input-shape signatures a cached graph
    may capture before it warns ``shape_wobble`` once
    (``MXTPU_RETRACE_BUDGET``, default 8): partial last batches and
    unbucketed lengths otherwise multiply capture time and graph memory
    silently. 0 disables the check."""
    return int(getenv("MXTPU_RETRACE_BUDGET", _RETRACE_BUDGET_DEFAULT,
                      dtype=int))


def elastic_enabled() -> bool:
    """Live-elasticity master switch (``MXTPU_ELASTIC``, default off):
    arms the membership-monitor pause points in ``Trainer.step`` /
    ``Superstep.step`` (``resilience/elastic.py``) so preemption
    notices and resize signals are processed at safe step boundaries.
    Attaching a ``MembershipMonitor`` programmatically arms them too;
    when off, each pause point costs one module-bool read."""
    return bool(getenv("MXTPU_ELASTIC", False, dtype=bool))


def log_fallback(site: str, reason: str):
    """Record that ``site`` declined the fast path because of ``reason``:
    logged at WARNING once per (site, reason) per process, and counted
    per label in the telemetry registry when telemetry is on."""
    from . import observability as _obs

    if _obs.ENABLED:
        _obs.FUSED_FALLBACK_TOTAL.inc(1, site=site, reason=reason)
    key = (site, reason)
    if key not in _LOGGED:
        _LOGGED.add(key)
        _logger.warning(
            "fused step: %s falling back to the general path (%s); "
            "set MXTPU_FUSED_STEP=0 to silence the fast path entirely",
            site, reason)


def reset_fallback_log():
    """Forget which (site, reason) pairs were already logged (tests)."""
    _LOGGED.clear()


def _warn_once(key, msg, *args):
    if key not in _LOGGED:
        _LOGGED.add(key)
        _logger.warning(msg, *args)


def bucket_bytes() -> int:
    """Target payload of one flat gradient bucket of the kvstore's
    bucketed pushpull (``MXTPU_BUCKET_BYTES``, default 4 MiB)."""
    return int(getenv("MXTPU_BUCKET_BYTES", _BUCKET_BYTES_DEFAULT,
                      dtype=int))


def amp_allreduce_dtype() -> str:
    """Wire type of float32 gradient buckets in a reduction across
    processes (``MXTPU_AMP_ALLREDUCE_DTYPE``: ``bfloat16``/``float16``;
    "" = full precision, the default). The sum is taken in float32 on the
    other side. An unknown value is ignored with one warning."""
    v = getenv("MXTPU_AMP_ALLREDUCE_DTYPE", "", dtype=str) or ""
    if v and v not in _AMP_AR_DTYPES:
        _warn_once(("fusedstep", "amp_allreduce_dtype"),
                   "MXTPU_AMP_ALLREDUCE_DTYPE=%r is not one of %s; "
                   "gradient allreduce stays full precision", v,
                   _AMP_AR_DTYPES)
        return ""
    return v


def overlap_mode() -> str:
    """Gradient-communication schedule of the mesh train step
    (``MXTPU_OVERLAP``): ``ready`` (default; ``1``) starts each bucket's
    collective as its last gradient is produced, ``barrier`` (``0``)
    after the whole backward, ``staged`` as a separate phase between
    backward and update. Unknown values give ``ready`` with one
    warning."""
    v = str(getenv("MXTPU_OVERLAP", "ready", dtype=str) or "ready").lower()
    v = {"1": "ready", "true": "ready", "on": "ready",
         "0": "barrier", "false": "barrier", "off": "barrier"}.get(v, v)
    if v not in _OVERLAP_MODES:
        _warn_once(("fusedstep", f"MXTPU_OVERLAP={v!r}"),
                   "MXTPU_OVERLAP=%r is not one of %s; using 'ready'", v,
                   _OVERLAP_MODES)
        return "ready"
    return v


def overlap_bucket_bytes() -> int:
    """Target bucket payload of the mesh step's collectives
    (``MXTPU_OVERLAP_BUCKET_BYTES``; defaults to :func:`bucket_bytes`, so
    the step's and the kvstore's plans agree unless tuned apart)."""
    v = getenv("MXTPU_OVERLAP_BUCKET_BYTES", None, dtype=int)
    return int(v) if v else bucket_bytes()


def zero_stage() -> int:
    """Default ZeRO stage of ``SPMDTrainStep`` (``MXTPU_ZERO_STAGE``,
    default 0): 0 replicated, 1 sharded optimizer state, 2 also
    reduce-scattered gradients, 3 also parameters sharded at rest. A value
    outside 0-3 gives 0 with one warning."""
    s = int(getenv("MXTPU_ZERO_STAGE", 0, dtype=int))
    if s not in (0, 1, 2, 3):
        _warn_once(("fusedstep", f"MXTPU_ZERO_STAGE={s}"),
                   "MXTPU_ZERO_STAGE=%s is not 0-3; using 0", s)
        return 0
    return s


_PIPELINE_SCHEDULES = ("gpipe", "1f1b", "interleaved")


def pipeline_schedule() -> str:
    """Default pipeline schedule of ``PipelineTrainStep``
    (``MXTPU_PIPELINE_SCHEDULE``): ``gpipe`` (default: fill-drain, bubble
    (S-1)/(M+S-1), activation stash growing with M), ``1f1b`` (the same
    bubble, the stash capped at the stage depth) or ``interleaved`` (1F1B
    over v virtual chunks per rank, the bubble divided by v). Another
    value gives ``gpipe`` with one warning."""
    v = str(getenv("MXTPU_PIPELINE_SCHEDULE", "gpipe", dtype=str)
            or "gpipe").lower()
    if v not in _PIPELINE_SCHEDULES:
        _warn_once(("fusedstep", f"MXTPU_PIPELINE_SCHEDULE={v!r}"),
                   "MXTPU_PIPELINE_SCHEDULE=%r is not one of %s; using "
                   "'gpipe'", v, _PIPELINE_SCHEDULES)
        return "gpipe"
    return v


def pipeline_microbatches() -> int:
    """Default microbatch count of the pipeline schedules
    (``MXTPU_PIPELINE_MICROBATCHES``, default 0: one per pipeline
    stage)."""
    return max(0, int(getenv("MXTPU_PIPELINE_MICROBATCHES", 0, dtype=int)))


_MOE_ROUTERS = ("top1", "top2")


def moe_router() -> str:
    """Default MoE router (``MXTPU_MOE_ROUTER``): ``top1`` (default, one
    expert a token) or ``top2`` (two experts with renormalized combine
    weights). Another value gives ``top1`` with one warning."""
    v = str(getenv("MXTPU_MOE_ROUTER", "top1", dtype=str) or "top1").lower()
    if v not in _MOE_ROUTERS:
        _warn_once(("fusedstep", f"MXTPU_MOE_ROUTER={v!r}"),
                   "MXTPU_MOE_ROUTER=%r is not one of %s; using 'top1'", v,
                   _MOE_ROUTERS)
        return "top1"
    return v


def moe_capacity_factor() -> float:
    """Default expert capacity factor (``MXTPU_MOE_CAPACITY_FACTOR``,
    default 1.5): an expert's slots are ``tokens / experts * factor``;
    tokens past them drop (zero output from that expert)."""
    v = getenv("MXTPU_MOE_CAPACITY_FACTOR", None, dtype=float)
    return float(v) if v else 1.5


def moe_a2a_chunks() -> int:
    """Segments of the capacity axis in ``moe_apply_a2a``'s expert
    exchange (``MXTPU_MOE_A2A_CHUNKS``, default 2): one all-to-all, expert
    product and return all-to-all per segment; 1 is one exchange."""
    return max(1, int(getenv("MXTPU_MOE_A2A_CHUNKS", 2, dtype=int)))
