"""Anomaly watchdog: rolling-window detectors over the live registry.

PyTorch counterpart of ``mxnet_tpu/observability/watchdog.py`` (host code:
the same classes, names and output).

Between crashes (flight recorder) and dashboards (scrape endpoint)
nothing watches the training signal ITSELF: a NaN loss at step 40k
scrolls past, a 3x step-time regression hides in a mean. The watchdog
closes that gap with detectors that read series the hot paths already
emit — it adds NO instrumentation, NO dispatches and never mutates
training numerics (detection only):

- ``nan``          — non-finite loss (superstep per-iteration series)
                     or grad norm,
- ``loss_spike``   — loss above ``_SPIKE_FACTOR`` x the trailing-window
                     median,
- ``grad_explosion`` — grad norm above ``_GRAD_FACTOR`` x its
                     trailing-window median,
- ``step_time``    — recent mean step wall time above ``_STEP_FACTOR``
                     x the warmup baseline mean,
- ``queue_saturation`` — serving queue depth at >= 90% of the bound
                     (load shedding imminent), latched per model until
                     it drains below half,
- ``input_wait``   — the attribution plane's per-step input-wait delta
                     (``mxtpu_data_prefetch_wait_delta_seconds``) above
                     ``_INPUT_FRACTION`` of the step period: the
                     accelerator idles on the host (raise
                     MXTPU_DEVICE_PREFETCH / add loader workers).

Every firing increments ``mxtpu_anomaly_total{kind=...}``, records an
``anomaly`` trace instant, and notes itself into the crash flight
bundle via ``flight.register_pre_dump``; with
``MXTPU_WATCHDOG_CHECKPOINT=1`` and a ``CheckpointManager`` attached it
also requests a proactive async checkpoint (the recovery point moves
BEFORE the job dies of the divergence it just spotted).

Switch: ``MXTPU_WATCHDOG=1``. Cadence: the trainer hot paths call
``poll()`` (a monotonic-clock compare unless the
``MXTPU_WATCHDOG_INTERVAL_S`` window elapsed); ``start()`` runs the
same ``check_now()`` on a daemon thread for serving-only processes.
"""

from __future__ import annotations

import collections
import threading
import time

from ..base import getenv

#: THE switch (same pattern as observability.ENABLED / chaos.ENABLED):
#: hot paths read one module attribute and skip everything when False.
ENABLED = bool(getenv("MXTPU_WATCHDOG", False, dtype=bool))

#: detector constants — spike factors are deliberately loose (an alarm
#: that cries on noise gets muted); regression tests pin the contract,
#: not the exact thresholds
_SPIKE_FACTOR = 10.0     # loss vs trailing median
_GRAD_FACTOR = 25.0      # grad norm vs trailing median
_STEP_FACTOR = 3.0       # recent mean step time vs warmup baseline
_QUEUE_FRACTION = 0.9    # queue depth vs bound
_INPUT_FRACTION = 0.5    # per-step input wait vs step period
_INPUT_FLOOR_S = 0.001   # ignore sub-ms waits (tight loops are noise)
_WINDOW = 64             # trailing-window capacity
_MIN_WINDOW = 8          # observations before median detectors arm
_WARMUP_STEPS = 10       # step-time observations forming the baseline

_STATE = {
    "loss_window": collections.deque(maxlen=_WINDOW),
    "grad_window": collections.deque(maxlen=_WINDOW),
    "seen_step": 0,            # tracer step already consumed
    "warm_sum": 0.0,           # step-time warmup baseline accumulators
    "warm_count": 0,
    "prev_sum": 0.0,           # cumulative step-time at last check
    "prev_count": 0,
    "queue_latched": set(),    # models latched on queue saturation
    "input_seen_step": 0,      # attribution record already consumed
    "last_poll": 0.0,
    "ckpt_mgr": None,
    "anomalies": collections.deque(maxlen=32),
    "note_registered": False,
}
_LOCK = threading.RLock()

#: anomaly listeners (actuators): ``fn(kind, details)`` called on every
#: firing — how detection becomes ACTION (the fleet autoscaler turns
#: ``queue_saturation`` into a scale-up). Mutated under ``_LOCK``,
#: called OUTSIDE it (a slow actuator must not block detection).
_LISTENERS = []

#: machine-checked lock protocol (mxtpu-lint thread-guard): detector
#: state is shared between the trainer poll path and the daemon loop
_GUARDED_BY = {"_STATE": "_LOCK", "_LISTENERS": "_LOCK"}


def watchdog_interval_s() -> float:
    """``MXTPU_WATCHDOG_INTERVAL_S`` (default 1): minimum seconds
    between detector sweeps (poll or daemon loop)."""
    return float(getenv("MXTPU_WATCHDOG_INTERVAL_S", 1.0, dtype=float))


def _checkpoint_on_anomaly() -> bool:
    return bool(getenv("MXTPU_WATCHDOG_CHECKPOINT", False, dtype=bool))


def set_enabled(on: bool) -> bool:
    """Flip the watchdog at runtime; returns the previous state."""
    global ENABLED
    prev, ENABLED = ENABLED, bool(on)
    return prev


def reset():
    """Restore pristine detector state AND wiring (test isolation):
    a stale CheckpointManager from a previous trainer must not keep
    receiving proactive saves, and the flight-note flag re-arms so a
    fresh flight module can be registered against (re-registration of
    the same hook is idempotent in ``flight.register_pre_dump``)."""
    with _LOCK:
        _STATE["loss_window"].clear()
        _STATE["grad_window"].clear()
        _STATE["seen_step"] = 0
        _STATE["warm_sum"] = 0.0
        _STATE["warm_count"] = 0
        _STATE["prev_sum"] = 0.0
        _STATE["prev_count"] = 0
        _STATE["queue_latched"] = set()
        _STATE["input_seen_step"] = 0
        _STATE["last_poll"] = 0.0
        _STATE["anomalies"].clear()
        _STATE["ckpt_mgr"] = None
        _STATE["note_registered"] = False
        del _LISTENERS[:]


def register_listener(fn):
    """Register an anomaly actuator: ``fn(kind, details)`` runs on
    every detector firing (after the counter/trace/flight plumbing),
    outside the detector lock. Actuator exceptions are swallowed —
    a broken actuator must never break detection. Returns ``fn`` so it
    can be used as a decorator; idempotent per function object."""
    with _LOCK:
        if fn not in _LISTENERS:
            _LISTENERS.append(fn)
    return fn


def unregister_listener(fn):
    """Remove a previously registered actuator (idempotent)."""
    with _LOCK:
        try:
            _LISTENERS.remove(fn)
        except ValueError:
            pass


def attach_checkpoint_manager(mgr):
    """Give the watchdog a PR-8 ``CheckpointManager`` to request
    proactive saves through (``CheckpointManager.attach`` wires this
    automatically when the watchdog is armed)."""
    with _LOCK:
        _STATE["ckpt_mgr"] = mgr


def _flight_note():
    """flight.register_pre_dump hook: fold the recent anomaly record
    into the crash bundle's trace ring (a dying job's last bundle says
    WHAT the watchdog saw, not just that it died)."""
    from . import _TRACER

    with _LOCK:
        recent = list(_STATE["anomalies"])
    if recent:
        _TRACER.instant("anomaly", cat="watchdog", kind="summary",
                        recent=recent)


def _fire(kind: str, **details):
    """One anomaly: typed counter + trace instant + flight note +
    (opt-in) proactive checkpoint. Never touches training state."""
    from . import ANOMALY_TOTAL, _TRACER, flight

    ANOMALY_TOTAL.inc(1, kind=kind)
    _TRACER.instant("anomaly", cat="watchdog", kind=kind, **details)
    with _LOCK:
        _STATE["anomalies"].append(dict(details, kind=kind,
                                        step=_TRACER.step))
        if not _STATE["note_registered"]:
            _STATE["note_registered"] = True
            try:
                flight.register_pre_dump(_flight_note, signals_only=False)
            except Exception:
                _STATE["note_registered"] = False
        mgr = _STATE["ckpt_mgr"]
        listeners = list(_LISTENERS)
    if mgr is not None and _checkpoint_on_anomaly():
        try:
            mgr.save_async(reason="anomaly")
        except Exception:
            pass  # a failed proactive save must never break detection
    for fn in listeners:  # outside _LOCK: actuators may be slow
        try:
            fn(kind, dict(details))
        except Exception:
            pass  # a broken actuator must never break detection


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    if not n:
        return 0.0
    mid = n // 2
    return xs[mid] if n % 2 else (xs[mid - 1] + xs[mid]) / 2.0


def _finite(x) -> bool:
    return x == x and x not in (float("inf"), float("-inf"))


def _check_training(fired):
    """Loss + grad detectors: consume the per-step series ONCE per new
    tracer step (re-checking a stale series must not re-fire — the
    'exactly one firing per seeded NaN' contract)."""
    from . import SUPERSTEP_ITER_LOSS, TRAINER_GRAD_NORM, _TRACER

    cur_step = _TRACER.step
    with _LOCK:
        if cur_step <= _STATE["seen_step"]:
            return
        _STATE["seen_step"] = cur_step

    # reading these series/gauges syncs lazy device values — that is
    # the point: the watchdog, never the training loop, pays the sync
    losses = SUPERSTEP_ITER_LOSS.series()  # mxtpu-lint: host-sync-ok
    bad = [x for x in losses if not _finite(x)]
    if bad:
        _fire("nan", source="loss", step=cur_step)
        fired.append("nan")
    with _LOCK:
        window = list(_STATE["loss_window"])
    finite = [x for x in losses if _finite(x)]
    if len(window) >= _MIN_WINDOW and finite:
        med = _median(window)
        peak = max(finite)
        if peak > _SPIKE_FACTOR * max(abs(med), 1e-12):
            _fire("loss_spike", peak=peak, median=med, step=cur_step)
            fired.append("loss_spike")
    with _LOCK:
        _STATE["loss_window"].extend(finite)

    if TRAINER_GRAD_NORM._values:
        gn = TRAINER_GRAD_NORM.value()  # mxtpu-lint: host-sync-ok
        if not _finite(gn):
            if "nan" not in fired:
                _fire("nan", source="grad_norm", step=cur_step)
                fired.append("nan")
        else:
            with _LOCK:
                gwin = list(_STATE["grad_window"])
                _STATE["grad_window"].append(gn)
            if len(gwin) >= _MIN_WINDOW:
                med = _median(gwin)
                if gn > _GRAD_FACTOR * max(abs(med), 1e-12):
                    _fire("grad_explosion", grad_norm=gn, median=med,
                          step=cur_step)
                    fired.append("grad_explosion")


def _check_step_time(fired):
    """Step-time regression vs the warmup baseline: the first
    ``_WARMUP_STEPS`` observations (eager + amortized superstep
    histograms combined) form the baseline mean; afterwards each NEW
    batch of observations fires when its mean exceeds
    ``_STEP_FACTOR`` x baseline."""
    from . import SUPERSTEP_STEP_SECONDS, TRAINER_STEP_SECONDS

    cum_sum = TRAINER_STEP_SECONDS.sum() + SUPERSTEP_STEP_SECONDS.sum()
    cum_count = TRAINER_STEP_SECONDS.value() + SUPERSTEP_STEP_SECONDS.value()
    with _LOCK:
        ds = cum_sum - _STATE["prev_sum"]
        dc = cum_count - _STATE["prev_count"]
        _STATE["prev_sum"] = cum_sum
        _STATE["prev_count"] = cum_count
        if dc <= 0:
            return
        if _STATE["warm_count"] < _WARMUP_STEPS:
            _STATE["warm_sum"] += ds
            _STATE["warm_count"] += dc
            return
        baseline = _STATE["warm_sum"] / max(_STATE["warm_count"], 1)
    recent = ds / dc
    if baseline > 0 and recent > _STEP_FACTOR * baseline:
        _fire("step_time", recent_mean_s=recent, baseline_s=baseline)
        fired.append("step_time")


def _check_serving(fired):
    """Serving queue saturation: depth at >= ``_QUEUE_FRACTION`` of the
    bound means shedding is imminent; latched per model until the
    queue drains below half."""
    from . import SERVE_QUEUE_DEPTH

    try:
        from ..serving.engine import serve_queue_cap

        cap = serve_queue_cap()
    except Exception:
        return
    if cap <= 0:
        return
    for labels in SERVE_QUEUE_DEPTH.labelsets():
        model = labels.get("model", "?")
        depth = SERVE_QUEUE_DEPTH.value(**labels)
        with _LOCK:
            latched = model in _STATE["queue_latched"]
            if depth >= _QUEUE_FRACTION * cap and not latched:
                _STATE["queue_latched"].add(model)
                do_fire = True
            else:
                do_fire = False
                if depth < 0.5 * cap and latched:
                    _STATE["queue_latched"].discard(model)
        if do_fire:
            _fire("queue_saturation", model=model, depth=depth, cap=cap)
            fired.append("queue_saturation")


def _check_input_wait(fired):
    """Input starvation: the attribution plane's LAST per-step record
    says the consumer spent >= ``_INPUT_FRACTION`` of the step period
    blocked on the prefetch queue (and at least ``_INPUT_FLOOR_S`` —
    micro-benchmark loops idle in sub-ms noise). Consumed once per new
    attribution record, so a stale record never re-fires."""
    from . import attribution

    rec = attribution.last_record()
    if rec is None:
        return
    step = int(rec.get("step") or 0)
    with _LOCK:
        if step <= _STATE["input_seen_step"]:
            return
        _STATE["input_seen_step"] = step
    per_step = rec["period_s"] / max(rec["k"], 1)
    wait = rec["input_wait"]
    if per_step > 0 and wait >= _INPUT_FLOOR_S and \
            wait >= _INPUT_FRACTION * per_step:
        _fire("input_wait", wait_s=wait, step_s=per_step,
              fraction=round(wait / per_step, 4),
              max_single_wait_s=rec.get("input_wait_max_s", 0.0),
              step=step)
        fired.append("input_wait")


def check_now() -> list:
    """Run every detector once; returns the kinds fired this sweep.
    Deterministic — the test seam (``poll()``/the daemon loop add only
    cadence)."""
    fired = []
    _check_training(fired)
    _check_step_time(fired)
    _check_serving(fired)
    _check_input_wait(fired)
    return fired


def poll():
    """Trainer-cadence hook: a monotonic-clock compare per call; the
    detectors run only when ``MXTPU_WATCHDOG_INTERVAL_S`` elapsed.
    Reading lazy gauges here syncs values the step ALREADY computed —
    zero added dispatches (pinned by the regression test)."""
    if not ENABLED:
        return []
    now = time.monotonic()
    with _LOCK:
        if now - _STATE["last_poll"] < watchdog_interval_s():
            return []
        _STATE["last_poll"] = now
    return check_now()


# ---------------------------------------------------------------------------
# daemon loop (serving-only processes have no trainer to poll from)
# ---------------------------------------------------------------------------

_WATCH = {"thread": None, "stop": None}
_WATCH_LOCK = threading.Lock()
_GUARDED_BY["_WATCH"] = "_WATCH_LOCK"


def _watchdog_loop(stop, interval):  # mxtpu-lint: hot-path
    while not stop.wait(interval):
        try:
            check_now()
        except Exception:
            pass  # the watchdog must never take the process down


def start(interval=None) -> bool:
    """Start the detector daemon thread (idempotent)."""
    if interval is None:
        interval = watchdog_interval_s()
    with _WATCH_LOCK:
        if _WATCH["thread"] is not None and _WATCH["thread"].is_alive():
            return False
        stop_ev = threading.Event()
        t = threading.Thread(
            target=_watchdog_loop, args=(stop_ev, float(interval)),
            name="mxtpu-watchdog", daemon=True)
        _WATCH.update(thread=t, stop=stop_ev)
        t.start()
    return True


def stop():
    """Stop the daemon thread (idempotent); join outside the lock."""
    with _WATCH_LOCK:
        t, ev = _WATCH["thread"], _WATCH["stop"]
        _WATCH.update(thread=None, stop=None)
    if ev is not None:
        ev.set()
    if t is not None:
        t.join(timeout=5)


def maybe_start():
    """Arm the daemon loop from ``MXTPU_WATCHDOG=1`` (first-Context
    wiring); trainer processes additionally get ``poll()`` cadence."""
    if ENABLED:
        start()
