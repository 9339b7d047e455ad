"""Deterministic fault injection (``MXTPU_CHAOS``).

PyTorch counterpart of ``mxnet_tpu/resilience/chaos.py``: seedable fault
points in the trainer, superstep and input-pipeline paths behind ONE
module boolean (``ENABLED``), so the disabled cost at every site is one
attribute read.

Spec grammar (comma-separated faults)::

    MXTPU_CHAOS="<fault>[@<site>]:<step>[:<arg>][,...][,seed=<n>]"

    kill:5            SIGKILL the process at fault-step 5 (any site)
    term:5            SIGTERM instead (exercises the graceful path)
    raise:5           raise ChaosInjectedError at step 5
    nan:3             NaN-poison the batch staged/consumed at step 3
    stall:4:0.25      sleep 0.25 s at step 4 (slow-host straggler)
    nan@superstep:2   site-scoped: only the superstep path fires it
    nan:p0.1,seed=7   probabilistic: each eligible step fires w.p. 0.1
                      from a seeded stream

Besides, as in the reference::

    collective:1      fail the next collective/barrier ONCE (one-shot)
    resize:8:2        membership change: ask the elastic control loop
                      to resize to 2 ranks at its step 8 (the arg is
                      the target rank count; see resilience/elastic)
    stall@rank1:p1:0.05  per-rank site: every heartbeat probe of rank 1
                      stalls 50 ms (a straggling peer)

The parser accepts the reference's ``kill_replica`` too; only it waits,
for the serving fleet (ROADMAP A13 (h)).

Steps are counted per (fault class, site) from 1 unless the caller passes
its own step counter, so a spec replays identically run to run.

Sites wired:

- ``trainer``: ``gluon.Trainer.step`` (kill/term/raise/stall);
- ``superstep``: ``gluon.Superstep.step`` (every fault; ``nan`` poisons
  slot 0 of the stacked batch block);
- ``prefetch``: ``gluon.data.DevicePrefetcher`` staging (``nan``
  poisons the staged batch);
- ``collective`` / ``barrier``: ``kvstore/dist.py``'s all-reduce and
  barrier (``collective`` one-shot failure; the barrier's retry with
  backoff turns it into a recovered step);
- ``bucket_psum`` / ``bucket_psum_scatter`` / ``bucket_allgather``: the
  data-parallel step's bucket collectives (``parallel/overlap.py``): a
  due fault raises before the collective is issued, never wrong numbers;
- ``elastic``: the live-elasticity control loop
  (``resilience/elastic.py``): ``resize:<step>:<n>`` asks for ``n``
  ranks at that step boundary; ``rank<k>`` sites stall rank ``k``'s
  heartbeat probe (a straggler).
"""

from __future__ import annotations

import logging
import os
import random as _pyrandom
import re
import signal
import threading
import time

from ..base import MXNetError, getenv

_logger = logging.getLogger("mxnet_tpu.chaos")

#: THE switch. Fault-point call sites check this module attribute and
#: fall through when False — chaos disabled must cost one boolean read
#: and add zero dispatches (regression-pinned in tests/test_resilience).
ENABLED = False

_LOCK = threading.Lock()
_STATE = {
    "faults": [],       # list of fault dicts
    "counters": {},     # site -> steps seen at that site
    "rng": None,        # seeded stream for probabilistic faults
    "spec": None,
    "fired": [],        # (fault, site, step) log for tests/telemetry
}

_FAULT_KINDS = ("kill", "term", "raise", "nan", "stall", "collective",
                "resize", "kill_replica")


class ChaosInjectedError(MXNetError):
    """Raised by the ``raise`` fault (and a fired ``collective`` fault)
    so tests can catch exactly the injected failure."""


def _parse_one(tok):
    """``kind[@site]:step-or-pP[:arg]`` -> fault dict."""
    m = re.match(
        r"^(?P<kind>[a-z_]+)(@(?P<site>[a-zA-Z_][a-zA-Z0-9_]*))?"
        r"(:(?P<when>p?[0-9.]+))?(:(?P<arg>[0-9.]+))?$", tok.strip())
    if not m or m.group("kind") not in _FAULT_KINDS:
        raise MXNetError(
            f"MXTPU_CHAOS: cannot parse fault {tok!r} "
            f"(kinds: {', '.join(_FAULT_KINDS)})")
    kind = m.group("kind")
    when = m.group("when")
    fault = {"kind": kind, "site": m.group("site"), "step": None,
             "prob": None, "arg": m.group("arg"), "armed": True}
    if when is None:
        if kind != "collective":
            raise MXNetError(
                f"MXTPU_CHAOS: fault {tok!r} needs a :<step> (or :p<prob>)")
        fault["step"] = 1  # collective defaults to the next call
    elif when.startswith("p"):
        fault["prob"] = float(when[1:])
    else:
        fault["step"] = int(float(when))
    if kind == "resize" and fault["arg"] is None:
        raise MXNetError(
            f"MXTPU_CHAOS: fault {tok!r} needs a target device count "
            "(resize:<step>:<n_devices>)")
    return fault


def configure(spec, seed=None):
    """Arm the fault set from a spec string (see module docstring).
    Returns the parsed fault list. An empty/None spec disables."""
    global ENABLED
    with _LOCK:
        if not spec:
            ENABLED = False
            _STATE.update(faults=[], counters={}, rng=None, spec=None,
                          fired=[])
            return []
        faults = []
        for tok in str(spec).split(","):
            tok = tok.strip()
            if not tok:
                continue
            if tok.startswith("seed="):
                seed = int(tok[5:])
                continue
            faults.append(_parse_one(tok))
        _STATE.update(faults=faults, counters={}, spec=str(spec),
                      fired=[],
                      rng=_pyrandom.Random(0 if seed is None else seed))
        ENABLED = bool(faults)
        if ENABLED:
            _logger.warning(
                "CHAOS armed: %s (seed=%s) — faults WILL be injected",
                spec, seed)
        return faults


def reset():
    """Disarm every fault and forget all per-site step counters."""
    configure(None)


def maybe_configure():
    """Arm from ``MXTPU_CHAOS`` when set (called at package import —
    without the var this is one getenv and nothing else)."""
    spec = getenv("MXTPU_CHAOS", None)
    if spec:
        configure(spec, seed=int(getenv("MXTPU_CHAOS_SEED", 0, dtype=int)))
    return ENABLED


def spec():
    return _STATE["spec"]


def fired():
    """Injection log: list of ``(kind, site, step)`` tuples."""
    return list(_STATE["fired"])


def _due(fault, site, step):
    if not fault["armed"]:
        return False
    if fault["site"] is not None and fault["site"] != site:
        return False
    if fault["prob"] is not None:
        return _STATE["rng"].random() < fault["prob"]
    return step == fault["step"]


def _record(fault, site, step):
    fault["armed"] = fault["prob"] is not None  # step faults are one-shot
    _STATE["fired"].append((fault["kind"], site, step))
    _logger.error("CHAOS: injecting %s at %s step %d (spec %r)",
                  fault["kind"], site, step, _STATE["spec"])
    from .. import observability as _obs

    if _obs.ENABLED:
        _obs.CHAOS_INJECTIONS_TOTAL.inc(1, kind=fault["kind"], site=site)


def _advance(kind_class, site, step):
    # counters are per (fault-class, site): a step_point and a nan_due
    # at the SAME site must not consume each other's step numbers
    with _LOCK:
        if step is None:
            key = (kind_class, site)
            step = _STATE["counters"].get(key, 0) + 1
            _STATE["counters"][key] = step
        return step


def step_point(site, step=None):
    """Process-level fault point for a training-step boundary: fires
    ``kill``/``term``/``raise``/``stall`` faults due at this (site,
    step). Callers guard on ``chaos.ENABLED`` first. ``step`` defaults
    to a per-site counter starting at 1."""
    step = _advance("step", site, step)
    for fault in _STATE["faults"]:
        if fault["kind"] not in ("kill", "term", "raise", "stall") \
                or not _due(fault, site, step):
            continue
        _record(fault, site, step)
        if fault["kind"] == "stall":
            time.sleep(float(fault["arg"] or 1.0))
        elif fault["kind"] == "raise":
            raise ChaosInjectedError(
                f"chaos: injected failure at {site} step {step}")
        else:
            signum = signal.SIGKILL if fault["kind"] == "kill" \
                else signal.SIGTERM
            os.kill(os.getpid(), signum)
            # SIGTERM returns here once the handlers (checkpoint final
            # save, flight bundle) finish and the default disposition
            # re-raises; SIGKILL never returns.
            time.sleep(30)  # pragma: no cover - death is imminent
    return step


def nan_due(site, step=None):
    """True when a ``nan`` fault is due at this (site, step). Callers
    that know their batch structure use this and poison in place; the
    not-firing path touches no arrays and dispatches nothing."""
    step = _advance("nan", site, step)
    for fault in _STATE["faults"]:
        if fault["kind"] == "nan" and _due(fault, site, step):
            _record(fault, site, step)
            return True
    return False


def poison_struct(batch):
    """The batch with every floating leaf of its nested structure
    (tuple/list/dict/NDArray/tensor) replaced by NaNs of the same shape,
    type and device; other leaves (labels, metadata) ride through
    untouched. Called once a ``nan`` fault fired (``nan_due``), never on
    the hot path."""
    import torch

    from ..ndarray.ndarray import NDArray

    def walk(obj):
        if isinstance(obj, (list, tuple)):
            return type(obj)(walk(o) for o in obj)
        if isinstance(obj, dict):
            return {k: walk(v) for k, v in obj.items()}
        t = obj.data if isinstance(obj, NDArray) else obj
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            bad = torch.full_like(t, float("nan"))
            return NDArray(bad) if isinstance(obj, NDArray) else bad
        return obj

    return walk(batch)


def resize_due(site="elastic", step=None):
    """Target rank count of a due ``resize`` fault at this (site,
    step), or None. The elastic control loop polls this once per step
    boundary when chaos is armed — how a chaos spec drives a runtime
    grow/shrink (``resize:8:2,resize:16:4`` = shrink to 2 at step 8,
    grow back to 4 at step 16)."""
    step = _advance("resize", site, step)
    for fault in _STATE["faults"]:
        if fault["kind"] != "resize" or not _due(fault, site, step):
            continue
        _record(fault, site, step)
        return int(float(fault["arg"]))
    return None


def collective_point(site="collective"):
    """Collective fault point: a due ``collective`` fault raises
    ``ChaosInjectedError`` ONCE (one-shot) — the caller's
    retry-with-backoff turns it into a recovered step; without retry it
    surfaces loudly instead of hanging."""
    step = _advance("collective", site, None)
    for fault in _STATE["faults"]:
        if fault["kind"] != "collective" or not _due(fault, site, step):
            continue
        _record(fault, site, step)
        raise ChaosInjectedError(
            f"chaos: injected one-shot collective failure at {site} "
            f"call {step}")
    return step
