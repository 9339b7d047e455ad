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
  block may capture before it warns (``gluon/block.py``).

The reference's ``DONATE`` has no counterpart (torch updates in place);
its bucket, overlap, superstep, pipeline, MoE, ZeRO and elastic knobs
come with the paths that read them (ROADMAP A8, A11).
"""

from __future__ import annotations

import logging

from .base import getenv

#: Master switch for the fused update. Flip at runtime with set_enabled().
ENABLED = bool(getenv("MXTPU_FUSED_STEP", True, dtype=bool))

_RETRACE_BUDGET_DEFAULT = 8

_logger = logging.getLogger("mxnet_tpu_torch.fusedstep")
_LOGGED: set = set()


def enabled() -> bool:
    return ENABLED


def set_enabled(on: bool) -> bool:
    """Flip the fused update at runtime; returns the previous state."""
    global ENABLED
    prev, ENABLED = ENABLED, bool(on)
    return prev


def retrace_budget() -> int:
    """Per-block budget of distinct input-shape signatures a cached graph
    may capture before it warns ``shape_wobble`` once
    (``MXTPU_RETRACE_BUDGET``, default 8): partial last batches and
    unbucketed lengths otherwise multiply capture time and graph memory
    silently. 0 disables the check."""
    return int(getenv("MXTPU_RETRACE_BUDGET", _RETRACE_BUDGET_DEFAULT,
                      dtype=int))


def log_fallback(site: str, reason: str):
    """Record that ``site`` declined the fast path because of ``reason``:
    logged at WARNING once per (site, reason) per process."""
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
