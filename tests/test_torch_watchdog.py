"""The port's anomaly watchdog (``observability/watchdog.py``) against the
JAX package's: each detector (nan, loss spike, grad explosion, step-time
regression, serving queue saturation) run on the same series in both
packages fires the same anomalies, with the same counters and the same
trace-event arguments; a chaos NaN through the port's real superstep
fires once; the firing's opt-in proactive checkpoint; the poll switch,
interval gate and daemon thread."""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import numpy as np
import pytest

import mxnet_tpu_torch as mx
from mxnet_tpu import observability as jobs
from mxnet_tpu_torch import observability as obs

BOTH = (obs, jobs)


@pytest.fixture(autouse=True)
def armed(monkeypatch):
    """Armed watchdogs over clean registries; no cadence gate."""
    monkeypatch.setenv("MXTPU_WATCHDOG_INTERVAL_S", "0")
    for o in BOTH:
        o.set_enabled(True)
        o.reset()
        o.watchdog.stop()
        o.watchdog.reset()
        o.watchdog.set_enabled(True)
    yield
    from mxnet_tpu_torch.resilience import chaos

    chaos.reset()
    for o in BOTH:
        o.watchdog.stop()
        o.watchdog.set_enabled(False)
        o.watchdog.reset()
        o.watchdog.attach_checkpoint_manager(None)
        o.set_enabled(False)
        o.reset()


def _anomalies(o):
    return [e["args"] for e in o.tracer().events()
            if e.get("name") == "anomaly"]


def _nan_grad(o):
    o.TRAINER_GRAD_NORM.set(float("inf"))
    o.tracer().mark_step()
    return [o.watchdog.check_now()]


def _loss_spike(o):
    out = []
    for _ in range(4):
        o.SUPERSTEP_ITER_LOSS.set_series([1.0, 1.1, 0.9])
        o.tracer().mark_step()
        out.append(o.watchdog.check_now())
    o.SUPERSTEP_ITER_LOSS.set_series([55.0])
    o.tracer().mark_step()
    out.append(o.watchdog.check_now())
    return out


def _grad_explosion(o):
    out = []
    for i in range(12):
        o.TRAINER_GRAD_NORM.set(1.0 + 0.01 * i)
        o.tracer().mark_step()
        out.append(o.watchdog.check_now())
    o.TRAINER_GRAD_NORM.set(99.0)
    o.tracer().mark_step()
    out.append(o.watchdog.check_now())
    return out


def _step_time(o):
    out = []
    for _ in range(10):
        o.TRAINER_STEP_SECONDS.observe(0.01)
    out.append(o.watchdog.check_now())
    o.TRAINER_STEP_SECONDS.observe(0.2)
    out.append(o.watchdog.check_now())
    o.TRAINER_STEP_SECONDS.observe(0.011)
    out.append(o.watchdog.check_now())
    return out


def _queue(o):
    if o is obs:
        from mxnet_tpu_torch.serving.engine import serve_queue_cap
    else:
        from mxnet_tpu.serving.engine import serve_queue_cap
    cap = serve_queue_cap()
    out = []
    for frac in (0.95, 0.95, 0.25, 0.95):
        o.SERVE_QUEUE_DEPTH.set(int(cap * frac), model="m")
        out.append(o.watchdog.check_now())
    return out


@pytest.mark.parametrize("scenario", [_nan_grad, _loss_spike,
                                      _grad_explosion, _step_time, _queue],
                         ids=["nan", "loss_spike", "grad_explosion",
                              "step_time", "queue_saturation"])
def test_detector_fires_as_the_reference(scenario):
    got, want = scenario(obs), scenario(jobs)
    assert got == want
    assert any(got)  # each scenario fires
    assert _anomalies(obs) == _anomalies(jobs)
    assert obs.ANOMALY_TOTAL.labelsets() == jobs.ANOMALY_TOTAL.labelsets()
    for kind in {k for fired in got for k in fired}:
        assert obs.ANOMALY_TOTAL.value(kind=kind) == \
            jobs.ANOMALY_TOTAL.value(kind=kind)


def test_chaos_nan_through_a_real_superstep_fires_once():
    from mxnet_tpu_torch.gluon.data.prefetcher import stack_batches
    from mxnet_tpu_torch.resilience import chaos

    wd = obs.watchdog
    lf = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(16, activation="relu", in_units=8),
            mx.gluon.nn.Dense(4, in_units=16))
    net.initialize(ctx=mx.cpu())
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.05}, kvstore=None)
    sstep = mx.gluon.Superstep(net, lf, tr, k=2)
    X = np.random.default_rng(0).standard_normal((8, 8)).astype(np.float32)
    xs = stack_batches([mx.nd.array(X, ctx=mx.cpu())] * 2)
    ys = stack_batches([mx.nd.zeros((8,), ctx=mx.cpu())] * 2)
    sstep.step(xs, ys, 8)
    assert wd.check_now() == []
    chaos.configure("nan@superstep:1")
    sstep.step(xs, ys, 8)  # the superstep's own poll sweeps it
    assert obs.ANOMALY_TOTAL.value(kind="nan") == 1.0
    assert wd.check_now() == [] and wd.check_now() == []
    assert obs.ANOMALY_TOTAL.value(kind="nan") == 1.0
    assert [a["source"] for a in _anomalies(obs)] == ["loss"]


class _FakeMgr:
    def __init__(self):
        self.calls = []

    def save_async(self, reason=None):
        self.calls.append(reason)


def test_proactive_checkpoint_is_opt_in(monkeypatch):
    wd = obs.watchdog
    mgr = _FakeMgr()
    wd.attach_checkpoint_manager(mgr)
    obs.SUPERSTEP_ITER_LOSS.set_series([float("nan")])
    obs.tracer().mark_step()
    assert "nan" in wd.check_now() and mgr.calls == []
    monkeypatch.setenv("MXTPU_WATCHDOG_CHECKPOINT", "1")
    obs.SUPERSTEP_ITER_LOSS.set_series([float("nan")])
    obs.tracer().mark_step()
    assert "nan" in wd.check_now() and mgr.calls == ["anomaly"]
    wd.reset()
    assert wd._STATE["ckpt_mgr"] is None


def test_checkpoint_manager_attach_wires_the_watchdog(tmp_path,
                                                      monkeypatch):
    monkeypatch.setenv("MXTPU_WATCHDOG_CHECKPOINT", "1")
    net = mx.gluon.nn.Dense(4, in_units=4)
    net.initialize(ctx=mx.cpu())
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1}, kvstore=None)
    mgr = mx.resilience.CheckpointManager(
        str(tmp_path), net=net, trainer=tr, keep=2,
        install_sigterm=False).attach()
    try:
        assert obs.watchdog._STATE["ckpt_mgr"] is mgr
        obs.SUPERSTEP_ITER_LOSS.set_series([float("nan")])
        obs.tracer().mark_step()
        assert "nan" in obs.watchdog.check_now()
        mgr.flush()
        assert mgr.last_saved is not None
    finally:
        mgr.close()


def test_poll_switch_interval_gate_and_daemon(monkeypatch):
    wd = obs.watchdog
    obs.TRAINER_GRAD_NORM.set(float("nan"))
    obs.tracer().mark_step()
    wd.set_enabled(False)
    assert wd.poll() == []
    wd.set_enabled(True)
    assert wd.poll() == ["nan"]
    monkeypatch.setenv("MXTPU_WATCHDOG_INTERVAL_S", "3600")
    obs.TRAINER_GRAD_NORM.set(float("inf"))
    obs.tracer().mark_step()
    assert wd.poll() == []
    assert wd.start(interval=0.01) is True
    assert wd.start(interval=0.01) is False
    wd.stop()
    wd.stop()
