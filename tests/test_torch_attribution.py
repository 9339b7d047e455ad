"""The port's step-time attribution plane (``observability/attribution.py``)
against the JAX package's: the same notes (prefetch-wait counter deltas,
single input waits, host-timed comm, checkpoint ticks, the overlap
probe's comm hint) and the same step spans give the same records, phase
for phase, the same series gauge and ``step.phases`` trace arguments,
and the same watchdog ``input_wait`` firings; a real port training loop
gives records whose phases sum to their periods, bounded by the wall;
the crash bundle carries them."""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import time

import numpy as np
import pytest

import mxnet_tpu_torch as mx
from mxnet_tpu import observability as jobs
from mxnet_tpu_torch import observability as obs

BOTH = (obs, jobs)


@pytest.fixture(autouse=True)
def armed():
    for o in BOTH:
        o.set_enabled(True)
        o.reset()
        o.attribution.set_enabled(True)
        o.attribution.reset()
    yield
    for o in BOTH:
        o.watchdog.set_enabled(False)
        o.watchdog.reset()
        o.attribution.set_enabled(True)
        o.attribution.reset()
        o.set_enabled(False)
        o.reset()


def _notes_script(o):
    """Fixed notes and spans: every feeder kind, a capped backlog, a
    superstep, the overlap probe's hint."""
    attr = o.attribution
    t = 100.0
    o.DATA_PREFETCH_WAIT_SECONDS.inc(0.004)
    attr.note_input_wait(0.003)
    attr.note_input_wait(0.001)
    attr.note_comm(0.002)
    o.record_ckpt_tick(0.0005)
    attr.record_step(t, t + 0.010)
    o.DATA_PREFETCH_WAIT_SECONDS.inc(10.0)  # a backlog past the period
    attr.note_comm(5.0)
    attr.record_step(t + 0.010, t + 0.012)
    attr.record_step(t + 0.012, t + 0.020, k=4, site="superstep")
    o.record_overlap_probe({"ready": 0.001, "staged": 0.003}, 0.66)
    attr.record_step(t + 0.020, t + 0.030, site="spmd", comm_mode="overlap")
    attr.record_step(t + 0.031, t + 0.035, site="spmd", comm_mode="staged")
    return (attr.records(), attr.mean_phases(),
            attr.mean_phases(site="spmd", last_n=2),
            o.STEP_PHASE_LAST.series(phase="compute"),
            o.DATA_PREFETCH_WAIT_DELTA.value(),
            [e["args"] for e in o.tracer().events()
             if e.get("name") == "step.phases"])


def test_records_equal_the_reference():
    got, want = _notes_script(obs), _notes_script(jobs)
    assert got == want
    recs = got[0]
    assert len(recs) == 5
    for r in recs:
        assert all(r[ph] >= 0.0 for ph in obs.attribution.PHASES), r
        assert sum(r[ph] for ph in obs.attribution.PHASES) * r["k"] == \
            pytest.approx(r["period_s"], rel=1e-9)
    assert recs[0]["input_wait"] == pytest.approx(0.004, rel=1e-6)
    assert recs[0]["comm_exposed"] == pytest.approx(0.002, rel=1e-6)


def _input_wait_script(o):
    o.watchdog.reset()
    o.watchdog.set_enabled(True)
    attr = o.attribution
    fired = []
    for i, wait in enumerate((0.008, 0.0005, 0.009)):
        o.DATA_PREFETCH_WAIT_SECONDS.inc(wait)
        o.tracer().mark_step()
        attr.record_step(200.0 + 0.01 * i, 200.01 + 0.01 * i)
        fired.append(o.watchdog.check_now())
        fired.append(o.watchdog.check_now())  # the same record: latched
    return fired, o.ANOMALY_TOTAL.value(kind="input_wait")


def test_watchdog_input_wait_fires_as_the_reference():
    got = _input_wait_script(obs)
    assert got == _input_wait_script(jobs)
    assert got[1] == 2.0


def _tiny_loop(steps=6):
    mx.random.seed(0)
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(8, activation="relu", in_units=8))
    net.add(mx.gluon.nn.Dense(4, in_units=8))
    net.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    net.hybridize()
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.05}, kvstore=None)
    lf = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    X = mx.nd.array(np.random.RandomState(0).rand(4, 8)
                    .astype(np.float32), ctx=mx.cpu())
    Y = mx.nd.array(np.arange(4, dtype=np.float32), ctx=mx.cpu())
    for _ in range(steps):
        with mx.autograd.record():
            loss = lf(net(X), Y)
        loss.backward()
        tr.step(4)


def test_real_loop_phases_sum_to_periods_within_the_wall():
    attr = obs.attribution
    t0 = time.perf_counter()
    _tiny_loop()
    wall = time.perf_counter() - t0
    recs = [r for r in attr.records() if r["site"] == "trainer"]
    assert len(recs) == 6
    for r in recs:
        assert all(r[ph] >= 0.0 for ph in attr.PHASES), r
        assert sum(r[ph] for ph in attr.PHASES) == \
            pytest.approx(r["period_s"], rel=1e-9)
    assert sum(r["period_s"] for r in recs) <= wall * 1.001
    assert obs.flight.build_bundle("t")["phase_records"][-1]["site"] == \
        "trainer"


def test_disarmed_plane_records_nothing():
    obs.attribution.set_enabled(False)
    _tiny_loop(steps=2)
    assert obs.attribution.records() == []
