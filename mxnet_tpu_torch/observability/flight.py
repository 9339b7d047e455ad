"""Crash flight recorder: post-mortem bundles for hangs, preemptions
and crashes (``MXTPU_DUMP_ON_CRASH=<dir>``).

PyTorch counterpart of ``mxnet_tpu/observability/flight.py``, with the
reference's bundle keys; ``backend``/``devices`` name the CUDA cards
(or the CPU) and ``env`` keeps the ``MXTPU_``/``TORCH_``/``CUDA_``/
``NCCL_`` variables. The checkpoint manager's final save runs as a
pre-dump hook, so its SIGTERM save comes first whichever handler was
installed first.

Training dies in ways host logs don't explain: a preemption SIGTERM
mid-superstep, an OOM inside a donated executable, a hung collective.
The PR-1 ring-buffer tracer already holds the last ~65k events in
memory; this module gets them OUT on the way down. With
``MXTPU_DUMP_ON_CRASH`` set (or ``flight.install(dir)`` called), an
unhandled exception, SIGTERM or SIGABRT writes ONE JSON bundle:

- the last-N trace events (``MXTPU_FLIGHT_EVENTS``, default 512),
- a live metric snapshot (every registry value, floats forced — lazy
  device gauges sync here, at dump time),
- the per-site executable cost table (``introspect.costs()``),
- the dispatch sites in flight at the moment of death (which compiled
  executable the process was inside — the "where was it stuck" answer
  for hangs),
- step counters, backend/devices, and the MXTPU_* environment.

The handlers chain: a previously-installed excepthook/signal handler
still runs after the dump. Everything is best-effort — a recorder must
never turn a crash into a different crash.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import sys
import threading
import time

from ..base import getenv

_logger = logging.getLogger("mxnet_tpu_torch.flight")

#: True once install() ran — the ONE boolean dispatch sites check
#: before paying the in-flight bookkeeping dict ops.
INSTALLED = False

_STATE = {
    "dir": None,
    "prev_excepthook": None,
    "prev_signal": {},  # signum -> previous handler
    "dumped": False,    # one bundle per process death, not one per hook
}

_IN_FLIGHT: dict = {}  # site -> depth (currently executing dispatches)
_IN_FLIGHT_LOCK = threading.Lock()

#: pre-dump hooks: callables run BEFORE the bundle is written when a
#: hooked signal fires (and, for hooks registered with
#: ``signals_only=False``, before an exception bundle too). This is the
#: deterministic ordering seam for the resilience layer: the final
#: checkpoint registers here, so "checkpoint first, flight bundle
#: second" holds no matter which handler was installed first (the other
#: install order reaches the same sequence through handler chaining +
#: the checkpoint's own once-per-death flag). Hooks are best-effort —
#: one raising must not cost the bundle or the re-raise.
_PRE_DUMP_HOOKS: list = []  # (fn, signals_only)


def register_pre_dump(fn, signals_only=True):
    """Run ``fn()`` before the crash bundle is written (idempotent per
    fn). ``signals_only``: skip it for plain unhandled exceptions."""
    for f, _ in _PRE_DUMP_HOOKS:
        if f is fn:
            return
    _PRE_DUMP_HOOKS.append((fn, bool(signals_only)))


def unregister_pre_dump(fn):
    _PRE_DUMP_HOOKS[:] = [(f, s) for f, s in _PRE_DUMP_HOOKS if f is not fn]


def _run_pre_dump(from_signal):
    for fn, signals_only in list(_PRE_DUMP_HOOKS):
        if signals_only and not from_signal:
            continue
        try:
            fn()
        except Exception as e:  # a hook must never mask the crash
            try:
                _logger.error("flight pre-dump hook failed: %s: %s",
                              type(e).__name__, e)
            except Exception:
                pass


def installed() -> bool:
    return INSTALLED


def dump_dir():
    return _STATE["dir"]


# ---------------------------------------------------------------------------
# in-flight dispatch tracking
# ---------------------------------------------------------------------------

class _Dispatch:
    """Context manager marking ``site`` as in flight. Near-zero cost
    and only ever constructed when the recorder is installed."""

    __slots__ = ("site",)

    def __init__(self, site):
        self.site = site

    def __enter__(self):
        with _IN_FLIGHT_LOCK:
            _IN_FLIGHT[self.site] = _IN_FLIGHT.get(self.site, 0) + 1
        return self

    def __exit__(self, *exc):
        with _IN_FLIGHT_LOCK:
            n = _IN_FLIGHT.get(self.site, 0) - 1
            if n <= 0:
                _IN_FLIGHT.pop(self.site, None)
            else:
                _IN_FLIGHT[self.site] = n
        return False


def dispatch(site) -> _Dispatch:
    """``with flight.dispatch("trainer_fused"): fn(...)`` — call sites
    guard on ``flight.INSTALLED`` first so the off path stays free."""
    return _Dispatch(site)


def in_flight() -> dict:
    with _IN_FLIGHT_LOCK:
        return dict(_IN_FLIGHT)


# ---------------------------------------------------------------------------
# bundle assembly
# ---------------------------------------------------------------------------

def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        if hasattr(v, "tolist"):
            try:  # device arrays (series gauges) sync here, at dump time
                return v.tolist()
            except Exception:
                pass
        try:
            return float(v)  # lazy device scalars sync here
        except (TypeError, ValueError):
            return str(v)


def _metric_snapshot():
    from . import registry

    snap = {}
    for m in registry().metrics():
        try:
            vals = {}
            for key, v in list(m._values.items()):
                label = ",".join(f"{k}={val}" for k, val in key) or ""
                if isinstance(v, list):
                    vals[label] = [_jsonable(x) for x in v]
                else:
                    vals[label] = _jsonable(v)
            if vals:
                snap[m.name] = {"kind": m.kind, "values": vals}
        except Exception:  # one bad metric must not sink the bundle
            snap[m.name] = {"kind": m.kind, "values": "unreadable"}
    return snap


def build_bundle(reason: str) -> dict:
    """The flight-recorder bundle as a plain dict (also the API tests
    use directly — the hooks just write this to disk)."""
    from . import summary, tracer
    from . import introspect as _introspect

    n = int(getenv("MXTPU_FLIGHT_EVENTS", 512, dtype=int))
    trc = tracer()
    events = trc.events()[-max(n, 1):]
    bundle = {
        "format": "mxtpu-flight-recorder-v1",
        "reason": reason,
        "time_unix": time.time(),
        "pid": os.getpid(),
        "step": trc.step,
        "in_flight": in_flight(),
        "executables": _introspect.costs(),
        "trace_events": [
            {k: _jsonable(v) if k != "args" else
             {ak: _jsonable(av) for ak, av in (v or {}).items()}
             for k, v in ev.items()} for ev in events],
        "metrics": _metric_snapshot(),
        "env": {k: v for k, v in os.environ.items()
                if k.startswith(("MXTPU_", "TORCH_", "CUDA_", "NCCL_"))},
    }
    try:
        bundle["summary"] = summary()
    except Exception:
        pass
    try:
        # the last-N per-step phase records: a dying job's bundle says
        # WHERE its final steps spent their time, not just how long
        from . import attribution

        bundle["phase_records"] = attribution.records()[-32:]
    except Exception:
        bundle["phase_records"] = []
    try:
        import torch

        cuda = torch.cuda.is_available()
        bundle["backend"] = "cuda" if cuda else "cpu"
        bundle["devices"] = [torch.cuda.get_device_name(i) for i in
                             range(torch.cuda.device_count())] if cuda \
            else ["cpu"]
    except Exception:
        bundle["backend"] = None
    return bundle


def dump(reason="manual", path=None) -> str | None:
    """Write one bundle; returns the path (None if nowhere to write or
    the write itself failed — logged, never raised)."""
    d = _STATE["dir"]
    if path is None:
        if not d:
            return None
        path = os.path.join(
            d, f"flight_{os.getpid()}_{int(time.time())}.json")
    try:
        bundle = build_bundle(reason)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(bundle, f, indent=1, default=str)
            f.write("\n")
        _logger.error("flight recorder: wrote %s (%s)", path, reason)
        return path
    except Exception as e:  # never turn a crash into a different crash
        try:
            _logger.error("flight recorder dump failed: %s: %s",
                          type(e).__name__, e)
        except Exception:
            pass
        return None


# ---------------------------------------------------------------------------
# hooks
# ---------------------------------------------------------------------------

def _excepthook(exc_type, exc, tb):
    if not _STATE["dumped"]:
        _STATE["dumped"] = True
        _run_pre_dump(from_signal=False)
        dump(reason=f"exception: {exc_type.__name__}: {exc}"[:300])
    prev = _STATE["prev_excepthook"] or sys.__excepthook__
    prev(exc_type, exc, tb)


def _signal_handler(signum, frame):
    if not _STATE["dumped"]:
        _STATE["dumped"] = True
        # resilience ordering contract: the final checkpoint (a pre-dump
        # hook) commits BEFORE the flight bundle is written
        _run_pre_dump(from_signal=True)
        try:
            name = signal.Signals(signum).name
        except ValueError:
            name = str(signum)
        dump(reason=f"signal: {name}")
    prev = _STATE["prev_signal"].get(signum)
    if callable(prev):
        prev(signum, frame)
        return
    # default disposition: die by the same signal so the parent sees
    # the true exit status (preemption managers key on it)
    signal.signal(signum, signal.SIG_DFL)
    os.kill(os.getpid(), signum)


def install(dirpath) -> bool:
    """Install the excepthook + SIGTERM/SIGABRT handlers writing
    bundles into ``dirpath``. Idempotent (re-install just re-points the
    directory). Signal handlers only land on the main thread; elsewhere
    the excepthook alone is installed (logged)."""
    global INSTALLED
    _STATE["dir"] = str(dirpath)
    _STATE["dumped"] = False
    if INSTALLED:
        return True
    _STATE["prev_excepthook"] = sys.excepthook
    sys.excepthook = _excepthook
    if threading.current_thread() is threading.main_thread():
        for signum in (signal.SIGTERM, signal.SIGABRT):
            try:
                if signal.getsignal(signum) is signal.SIG_IGN:
                    # an explicitly-ignored signal stays ignored: the
                    # recorder must not turn a survive-broadcast-TERM
                    # process into one that dies on it
                    continue
                prev = signal.signal(signum, _signal_handler)
                if prev not in (signal.SIG_DFL, _signal_handler):
                    _STATE["prev_signal"][signum] = prev
            except (ValueError, OSError) as e:  # pragma: no cover
                _logger.warning("flight recorder: cannot hook %s: %s",
                                signum, e)
    else:  # pragma: no cover - install is normally at import time
        _logger.warning("flight recorder installed off the main thread: "
                        "signal hooks skipped, excepthook only")
    INSTALLED = True
    return True


def uninstall():
    """Remove the hooks (tests). Safe when not installed."""
    global INSTALLED
    if not INSTALLED:
        return
    if sys.excepthook is _excepthook:
        sys.excepthook = _STATE["prev_excepthook"] or sys.__excepthook__
    if threading.current_thread() is threading.main_thread():
        for signum in (signal.SIGTERM, signal.SIGABRT):
            try:
                if signal.getsignal(signum) is _signal_handler:
                    signal.signal(
                        signum,
                        _STATE["prev_signal"].get(signum, signal.SIG_DFL))
            except (ValueError, OSError):  # pragma: no cover
                pass
    _STATE["prev_excepthook"] = None
    _STATE["prev_signal"].clear()
    _STATE["dir"] = None
    INSTALLED = False


def maybe_install():
    """Install from ``MXTPU_DUMP_ON_CRASH`` when set (called once at
    observability import — opt-in, so plain imports stay hook-free)."""
    d = getenv("MXTPU_DUMP_ON_CRASH", None)
    if d:
        install(str(d))
    return INSTALLED
