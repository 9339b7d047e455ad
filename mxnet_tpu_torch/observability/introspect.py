"""Performance introspection: per-site FLOPs and CUDA memory accounting,
an MFU/roofline estimator, and step-bounded profiler windows.

PyTorch counterpart of ``mxnet_tpu/observability/introspect.py``: the
same records, fields, gauges, ``introspect.cost`` trace events and
tables, from CUDA sources instead of XLA's analyses.

- **Site cost/memory accounting** (``MXTPU_INTROSPECT=1`` or
  ``set_enabled(True)``): a site (the ``SPMDTrainStep`` step, the
  ``Trainer``'s fused update, ``gluon.Superstep``, or any region a
  caller names with :func:`site`) registers once, on its first run:
  ``flops`` from ``torch.utils.flop_counter.FlopCounterMode`` over that
  run (which counts matrix products, convolutions and attention, not
  elementwise work: an optimizer update's site reads 0, where XLA's
  cost analysis counts its adds) plus the hand-written kernels'
  operations counted from their
  shapes (``ops/_kernels.note_flops``: the flash kernels' 4/6/8/10
  FLOPs per visible (query, key) pair and head dimension, the fused
  conv + BN kernels' 2 M K N); and on a card the run's
  ``torch.cuda`` memory statistics: ``argument_bytes`` allocated when
  it began, ``output_bytes`` allocated when it ended, ``temp_bytes``
  its peak above both, ``bytes_accessed`` the peak it allocated (torch
  has no HBM traffic counter, so the roofline's intensity uses it as a
  lower bound on the bytes moved). Torch has no buffer donation:
  ``alias_bytes`` is None and the donation check stays quiet. A CUDA
  graph replays what its capture ran, so a site's first run is counted
  eagerly or while it is captured, never per replay.
- **MFU / roofline estimator**: achieved-vs-peak from the card's peak
  table below (``mfu_estimate``), and a formatted ``cost_table()``.
- **Profiler windows**: ``MXTPU_PROFILE=<dir>[:start:stop]`` arms a
  step-bounded ``torch.profiler`` capture written as a chrome trace
  under ``dir``; ``profile_window(logdir)`` is the context-manager
  form, and ``annotate(name)`` an NVTX range
  (``torch.cuda.nvtx.range``) plus a ``record_function`` span.

Cost note: a registration runs its site once under the FLOP counter
(a ``TorchDispatchMode``: every aten op pays a Python call), so
introspection is opt-in and registers each site once; the steady-state
hot path pays one module-bool read.
"""

from __future__ import annotations

import contextlib
import logging
import threading

from ..base import getenv

_logger = logging.getLogger("mxnet_tpu_torch.introspect")

#: THE switch: cost/memory registration is skipped entirely when False.
#: Seeded from MXTPU_INTROSPECT (default off).
ENABLED = bool(getenv("MXTPU_INTROSPECT", False, dtype=bool))

_LOCK = threading.Lock()
_COSTS: dict = {}  # site -> cost record dict


def enabled() -> bool:
    return ENABLED


def set_enabled(on: bool) -> bool:
    """Flip site introspection at runtime; returns the previous state.
    Sites already run register on their next run."""
    global ENABLED
    prev, ENABLED = ENABLED, bool(on)
    return prev


def reset():
    """Drop every registered site record (tests)."""
    with _LOCK:
        _COSTS.clear()


# ---------------------------------------------------------------------------
# device peak tables (per card): the dense bf16/fp16 tensor-core rate and
# the HBM rate of NVIDIA's H100 data sheet (SXM part, no sparsity, at its
# 700 W limit; a card set below it runs slower). The CPU has no table, so
# MFU degrades to None with a reason there.
# ---------------------------------------------------------------------------

_PEAK_TFLOPS = {
    "NVIDIA H100": 989.0,
}

_PEAK_HBM_GBS = {
    "NVIDIA H100": 3350.0,
}


def device_peaks():
    """``(peak_tflops, peak_hbm_gbs, reason)`` for CUDA device 0, or
    ``(None, None, reason)`` with no card or no table for it."""
    try:
        import torch

        if not torch.cuda.is_available():
            return None, None, "no CUDA device (the CPU has no peak table)"
        kind = torch.cuda.get_device_name(0)
    except Exception as e:  # driver not initializable
        return None, None, f"backend unavailable: {type(e).__name__}"
    for k, v in _PEAK_TFLOPS.items():
        if kind.startswith(k):
            return v, _PEAK_HBM_GBS.get(k), None
    return None, None, f"no peak-FLOPs table for device kind {kind!r}"


# ---------------------------------------------------------------------------
# site registration
# ---------------------------------------------------------------------------

def registered(site) -> bool:
    """Lock-free already-registered probe: hot paths call this before
    opening a counting run."""
    return site in _COSTS


def _record(site, flops, mem, donated):
    peak_bytes = mem.get("peak")
    rec = {
        "site": site,
        "flops": float(flops),
        "bytes_accessed": peak_bytes,
        "transcendentals": None,
        "arith_intensity": (float(flops) / peak_bytes)
        if peak_bytes else None,
        "argument_bytes": mem.get("before"),
        "output_bytes": mem.get("after"),
        "temp_bytes": mem.get("temp"),
        "alias_bytes": None,
        "generated_code_bytes": None,
        "donated": bool(donated),
    }
    peak_tf, peak_bw, peak_reason = device_peaks()
    rec["peak_tflops"] = peak_tf
    rec["peak_hbm_gbs"] = peak_bw
    if peak_reason:
        rec["peak_reason"] = peak_reason
    return rec


_NULL = contextlib.nullcontext()


def site(name, device=None, donated=False, force=False):
    """Count the region as site ``name``'s one registered run (a shared
    no-op context when introspection is off, or the site registered
    before unless ``force``): the FLOPs of every aten op inside it plus
    the noted kernel FLOPs, and on a CUDA ``device`` (default: the
    current one, when a card is visible) its memory statistics. Never
    raises for its own sake: a failed count records a stub with
    ``error`` set."""
    if not ENABLED or (name in _COSTS and not force):
        return _NULL
    return _counted(name, device, donated)


@contextlib.contextmanager
def _counted(name, device, donated):
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from ..ops import _kernels

    cuda = torch.cuda.is_available() and (
        device is None or torch.device(device).type == "cuda")
    mem = {}
    if cuda:
        torch.cuda.synchronize()
        mem["before"] = int(torch.cuda.memory_allocated())
        torch.cuda.reset_peak_memory_stats()
    noted = [0]
    counter = FlopCounterMode(display=False)
    _kernels.FLOP_SINKS.append(noted)
    try:
        with counter:
            yield
    finally:
        _kernels.FLOP_SINKS.remove(noted)
    try:
        if cuda:
            torch.cuda.synchronize()
            mem["after"] = int(torch.cuda.memory_allocated())
            mem["peak"] = int(torch.cuda.max_memory_allocated())
            mem["temp"] = max(mem["peak"] - max(mem["before"],
                                                mem["after"]), 0)
        rec = _record(name, counter.get_total_flops() + noted[0], mem,
                      donated)
    except Exception as e:  # introspection must never take training down
        rec = {"site": name, "flops": None, "bytes_accessed": None,
               "donated": bool(donated),
               "error": f"{type(e).__name__}: {e}"[:200]}
    _publish(rec)


def _publish(rec):
    site_name = rec["site"]
    with _LOCK:
        _COSTS[site_name] = rec
    # gauges + one trace event carrying the whole record, which
    # tools/telemetry_report.py's roofline table reads from a dump
    from . import (
        ENABLED as _TEL,
        EXEC_ALIAS_BYTES,
        EXEC_ARG_BYTES,
        EXEC_ARITH_INTENSITY,
        EXEC_BYTES_ACCESSED,
        EXEC_FLOPS,
        EXEC_OUT_BYTES,
        EXEC_TEMP_BYTES,
        tracer,
    )

    if _TEL:
        for gauge, key in ((EXEC_FLOPS, "flops"),
                           (EXEC_BYTES_ACCESSED, "bytes_accessed"),
                           (EXEC_ARITH_INTENSITY, "arith_intensity"),
                           (EXEC_TEMP_BYTES, "temp_bytes"),
                           (EXEC_ARG_BYTES, "argument_bytes"),
                           (EXEC_OUT_BYTES, "output_bytes"),
                           (EXEC_ALIAS_BYTES, "alias_bytes")):
            if rec.get(key) is not None:
                gauge.set(rec[key], site=site_name)
    tracer().record("introspect.cost", cat="introspect", dur=0.0,
                    args=dict(rec), ph="i")


def costs() -> dict:
    """``{site: record}`` snapshot of every registered executable."""
    with _LOCK:
        return {k: dict(v) for k, v in _COSTS.items()}


def site_cost(site):
    with _LOCK:
        rec = _COSTS.get(site)
        return dict(rec) if rec else None


def flops_per_step(sites=None):
    """Sum of registered per-invocation FLOPs over ``sites`` (default:
    the one-dispatch train-step trio). Returns ``(flops, reason)`` —
    flops None with the reason filled when nothing usable registered.
    A superstep site's FLOPs cover K iterations; divide by K yourself.
    """
    if sites is None:
        snap = costs()
        sites = [s for s in snap
                 if s.startswith(("cachedop_fwd", "cachedop_bwd"))
                 or s in ("trainer_fused", "spmd_step")]
    total, seen = 0.0, 0
    for s in sites:
        rec = site_cost(s)
        if rec is None:
            continue
        if rec.get("flops") is None:
            return None, rec.get(
                "error", f"backend reports no cost analysis for {s!r}")
        total += rec["flops"]
        seen += 1
    if not seen:
        return None, "no executable sites registered " \
                     "(MXTPU_INTROSPECT off, or nothing dispatched yet)"
    return total, None


def mfu_estimate(site, step_seconds):
    """Achieved-vs-peak for one site: ``{"achieved_tflops", "mfu",
    "bound", "reason"}``. ``mfu`` is None with a reason on backends
    without a peak table or cost analysis. Gated on the runtime feature
    set — ``Features()["INTROSPECTION"]`` — so environments that stub
    it out degrade to the reason string instead of wrong numbers."""
    from ..runtime import Features

    out = {"site": site, "achieved_tflops": None, "mfu": None,
           "bound": None, "reason": None}
    try:
        if not Features().is_enabled("INTROSPECTION"):
            out["reason"] = "INTROSPECTION feature disabled"
            return out
    except Exception:
        pass
    rec = site_cost(site)
    if rec is None:
        out["reason"] = f"site {site!r} not registered"
        return out
    flops = rec.get("flops")
    if flops is None:
        out["reason"] = rec.get("error",
                                "backend reports no cost analysis")
        return out
    if not step_seconds or step_seconds <= 0:
        out["reason"] = "no step timing"
        return out
    out["achieved_tflops"] = flops / step_seconds / 1e12
    ai = rec.get("arith_intensity")
    peak_tf, peak_bw = rec.get("peak_tflops"), rec.get("peak_hbm_gbs")
    if peak_tf is None:
        out["reason"] = rec.get("peak_reason", "no peak-FLOPs table")
        return out
    out["mfu"] = out["achieved_tflops"] / peak_tf
    if ai is not None and peak_bw:
        ridge = peak_tf * 1e12 / (peak_bw * 1e9)  # flops/byte
        out["bound"] = "compute" if ai >= ridge else "memory"
    return out


def cost_table() -> str:
    """Human-readable per-site roofline table of every registered
    executable (the in-process twin of telemetry_report's section)."""
    snap = costs()
    if not snap:
        return "introspect: no executables registered " \
               "(set MXTPU_INTROSPECT=1 before building)"
    lines = ["Executable cost/memory (per invocation):",
             f"{'Site':<34}{'GFLOPs':>10}{'MiB acc':>10}{'AI':>8}"
             f"{'Temp MiB':>10}{'Alias MiB':>10}{'Donated':>9}"]
    for site in sorted(snap):
        rec = snap[site]

        def fmt(key, scale, nd=2):
            v = rec.get(key)
            return f"{v / scale:.{nd}f}" if v is not None else "-"

        lines.append(
            f"{site:<34}{fmt('flops', 1e9):>10}"
            f"{fmt('bytes_accessed', 2**20):>10}"
            f"{fmt('arith_intensity', 1.0, 1):>8}"
            f"{fmt('temp_bytes', 2**20):>10}"
            f"{fmt('alias_bytes', 2**20):>10}"
            f"{'yes' if rec.get('donated') else 'no':>9}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# profiler windows (torch.profiler)
# ---------------------------------------------------------------------------

def _parse_profile_env(value):
    """``<dir>[:start:stop]`` → (dir, start, stop). Bare dir defaults
    to steps [1, 10]; the trailing two fields must both be ints (a
    path containing ':' is otherwise kept whole)."""
    parts = value.split(":")
    if len(parts) >= 3 and parts[-1].isdigit() and parts[-2].isdigit():
        start = max(int(parts[-2]), 1)
        return ":".join(parts[:-2]), start, max(int(parts[-1]), start)
    start = 1
    return value, start, start + 9


_PROFILE = {
    "dir": None, "start": 0, "stop": 0,
    "active": False, "done": False, "step": 0, "captures": 0,
}

#: True when a MXTPU_PROFILE window is armed (or profiling was started
#: programmatically); the ONE boolean the training hot paths read.
PROFILING = False


def configure_profile(logdir, start=1, stop=None):
    """Arm a step-bounded profiler window: capture starts when the
    step counter reaches ``start`` and stops after ``stop``."""
    global PROFILING
    _PROFILE.update(dir=logdir, start=max(int(start), 1),
                    stop=int(stop) if stop is not None else int(start) + 9,
                    active=False, done=False, step=0)
    PROFILING = logdir is not None
    return dict(_PROFILE)


def _maybe_arm_from_env():
    v = getenv("MXTPU_PROFILE", None)
    if v:
        d, start, stop = _parse_profile_env(str(v))
        configure_profile(d, start, stop)


def profile_state() -> dict:
    return dict(_PROFILE)


def _start_trace():
    import torch

    try:
        prof = torch.profiler.profile(
            activities=_activities(), record_shapes=False)
        prof.__enter__()
        _PROFILE["prof"] = prof
        _PROFILE["active"] = True
        _PROFILE["captures"] += 1
        _logger.info("profiler window OPEN at step %d -> %s",
                     _PROFILE["step"], _PROFILE["dir"])
    except Exception as e:  # profiler busy: disarm loudly
        _PROFILE["done"] = True
        global PROFILING
        PROFILING = False  # steps go back to the zero-cost path
        _logger.warning("profiler window failed to open: %s: %s",
                        type(e).__name__, e)


def _activities():
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _export(prof, logdir):
    import os

    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{os.getpid()}_"
                        f"{_PROFILE['captures']}.json")
    prof.export_chrome_trace(path)
    return path


def _stop_trace():
    prof = _PROFILE.pop("prof", None)
    try:
        if prof is not None:
            prof.__exit__(None, None, None)
            _export(prof, _PROFILE["dir"])
    except Exception as e:
        _logger.warning("profiler stop failed: %s: %s",
                        type(e).__name__, e)
    _PROFILE["active"] = False
    _PROFILE["done"] = True
    global PROFILING
    PROFILING = False
    _logger.info("profiler window CLOSED after step %d", _PROFILE["step"])


@contextlib.contextmanager
def profile_step(k=1, name="train"):
    """Wrap one ``Trainer.step`` / K-step superstep: advances the window
    state machine (open at ``start``, close after ``stop``) and marks
    the covered region ``{name}#{step}`` (``record_function``) so the
    device trace aligns with host step numbers. Call only when
    ``PROFILING`` is True."""
    import torch

    first = _PROFILE["step"] + 1
    _PROFILE["step"] += int(k)
    if (not _PROFILE["active"] and not _PROFILE["done"]
            and _PROFILE["dir"] and _PROFILE["step"] >= _PROFILE["start"]):
        _start_trace()
    if _PROFILE["active"]:
        try:
            with torch.profiler.record_function(f"{name}#{first}"):
                yield
        finally:
            if _PROFILE["step"] >= _PROFILE["stop"]:
                _stop_trace()
    else:
        yield


@contextlib.contextmanager
def profile_window(logdir):
    """Programmatic capture: everything inside the block lands in one
    ``torch.profiler`` chrome trace under ``logdir`` (open in Perfetto).
    Composes with ``annotate()`` named spans."""
    import torch

    prof = torch.profiler.profile(activities=_activities())
    prof.__enter__()
    _PROFILE["captures"] += 1
    was_active = _PROFILE["active"]
    _PROFILE["active"] = True  # annotate() spans inside the block record
    try:
        yield logdir
    finally:
        _PROFILE["active"] = was_active
        try:
            prof.__exit__(None, None, None)
            _export(prof, logdir)
        except Exception as e:
            _logger.warning("profile_window stop failed: %s: %s",
                            type(e).__name__, e)


@contextlib.contextmanager
def _annotated(name):
    import torch

    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


def annotate(name):
    """Named profiler span (an NVTX range on a card, and a
    ``record_function`` span) for hot regions: the fused update, bucket
    pack/allreduce/unpack. Returns a no-op context manager when no
    window is active, so call sites can use it unconditionally inside a
    ``PROFILING`` check."""
    if not (_PROFILE["active"] or PROFILING):
        return contextlib.nullcontext()
    return _annotated(name)


_maybe_arm_from_env()
