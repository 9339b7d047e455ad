"""The port's crash flight recorder (``observability/flight.py``) against
the JAX package's: the bundle of the same records has the reference's
keys; in-flight dispatch tracking; install/uninstall hygiene; a lazy
device gauge serialises; and, in child processes, a SIGTERM mid-training
and an unhandled exception each write a bundle with the last trace
events and the introspection table, the SIGTERM one after the checkpoint
manager's final save (the two handlers chained, neither replacing the
other)."""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import glob
import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import observability as jobs
from mxnet_tpu_torch import observability as obs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def clean():
    for o in (obs, jobs):
        o.set_enabled(False)
        o.reset()
        o.introspect.set_enabled(False)
        o.introspect.reset()
    yield
    for o in (jobs, obs):  # the last installed first: hooks chain
        o.flight.uninstall()
        o.set_enabled(False)
        o.reset()
        o.introspect.set_enabled(False)
        o.introspect.reset()


def _train_steps(mxmod, ctx, n=2):
    net = mxmod.gluon.nn.Dense(4, in_units=8)
    net.initialize(**ctx)
    net.hybridize()
    tr = mxmod.gluon.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": 0.1}, kvstore=None)
    lf = mxmod.gluon.loss.SoftmaxCrossEntropyLoss()
    X, Y = mxmod.nd.ones((8, 8), **ctx), mxmod.nd.zeros((8,), **ctx)
    for _ in range(n):
        with mxmod.autograd.record():
            loss = lf(net(X), Y)
        loss.backward()
        tr.step(8)


def _bundle(mxmod, o, ctx, tmp_path):
    o.flight.install(str(tmp_path))
    o.set_enabled(True)
    o.introspect.set_enabled(True)
    _train_steps(mxmod, ctx)
    path = o.flight.dump(reason="manual-test")
    assert path and os.path.exists(path)
    return json.load(open(path))


def test_manual_bundle_has_the_reference_keys(tmp_path):
    got = _bundle(mx, obs, {"ctx": mx.cpu()}, tmp_path / "port")
    want = _bundle(jmx, jobs, {}, tmp_path / "ref")
    assert sorted(got) == sorted(want)
    assert got["format"] == want["format"] == "mxtpu-flight-recorder-v1"
    assert got["reason"] == "manual-test" and got["step"] == want["step"]
    core = {"mxtpu_trainer_step_total", "mxtpu_trainer_step_seconds",
            "mxtpu_trainer_grad_norm", "mxtpu_executable_flops",
            "mxtpu_cachedop_compile_total"}
    assert core <= set(got["metrics"]) and core <= set(want["metrics"])
    assert set(got["metrics"]) <= {m.name for m in obs.registry().metrics()}
    # torch's FLOP counter counts products and convolutions: the fused
    # SGD update's elementwise work reads 0 in the port
    assert got["executables"]["trainer_fused"]["flops"] == 0.0
    assert sorted(got["executables"]["trainer_fused"]) == sorted(
        want["executables"]["trainer_fused"])
    assert got["in_flight"] == {} and got["backend"] == "cpu"
    names = {ev["name"] for ev in got["trace_events"]}
    assert {"trainer.step", "introspect.cost"} <= names


def test_dump_without_dir_returns_none():
    assert obs.flight.dump(reason="nowhere") is None \
        is jobs.flight.dump(reason="nowhere")


def test_in_flight_tracking(tmp_path):
    for o in (obs, jobs):
        with o.flight.dispatch("t_site"):
            with o.flight.dispatch("t_site"):
                assert o.flight.in_flight() == {"t_site": 2}
            assert o.flight.in_flight() == {"t_site": 1}
        assert o.flight.in_flight() == {}
        o.flight.install(str(tmp_path))
        with o.flight.dispatch("spmd_step"):
            assert o.flight.build_bundle("probe")["in_flight"] == {
                "spmd_step": 1}


def test_install_uninstall_restores_hooks(tmp_path):
    prev_hook = sys.excepthook
    prev_term = signal.getsignal(signal.SIGTERM)
    obs.flight.install(str(tmp_path))
    assert obs.flight.INSTALLED and sys.excepthook is not prev_hook
    obs.flight.install(str(tmp_path))  # idempotent
    obs.flight.uninstall()
    assert not obs.flight.INSTALLED
    assert sys.excepthook is prev_hook
    assert signal.getsignal(signal.SIGTERM) == prev_term
    obs.flight.uninstall()  # idempotent too


def test_bundle_survives_lazy_device_gauges(tmp_path):
    obs.flight.install(str(tmp_path))
    obs.TRAINER_GRAD_NORM.set_lazy(torch.tensor(3.5))
    b = json.load(open(obs.flight.dump(reason="lazy")))
    assert b["metrics"]["mxtpu_trainer_grad_norm"]["values"][""] == 3.5


_CHILD = """
import sys, time
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import resilience
net = mx.gluon.nn.Dense(4, in_units=8)
net.initialize(ctx=mx.cpu())
net.hybridize()
tr = mx.gluon.Trainer(net.collect_params(), "sgd", {{"learning_rate": 0.1}},
                      kvstore=None)
mgr = resilience.CheckpointManager({ckpt!r}, every_n_steps=10 ** 6,
                                   net=net, trainer=tr).attach(tr)
lf = mx.gluon.loss.SoftmaxCrossEntropyLoss()
X = mx.nd.ones((8, 8), ctx=mx.cpu())
Y = mx.nd.zeros((8,), ctx=mx.cpu())
def one():
    with mx.autograd.record():
        l = lf(net(X), Y)
    l.backward()
    tr.step(8)
one()
open({ready!r}, "w").write("ready")
i = 0
while True:
    one()
    i += 1
    if {raise_at} and i >= {raise_at}:
        raise RuntimeError("mid-training crash for the recorder test")
    time.sleep(0.001)
"""


def _spawn(tmp_path, raise_at=0):
    dump_dir = tmp_path / "dumps"
    ready = str(tmp_path / "ready")
    env = dict(os.environ, MXTPU_DUMP_ON_CRASH=str(dump_dir),
               MXTPU_TELEMETRY="1", MXTPU_INTROSPECT="1")
    env.pop("PYTHONPATH", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", _CHILD.format(
            root=ROOT, ready=ready, raise_at=raise_at,
            ckpt=str(tmp_path / "ck"))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    t0 = time.monotonic()
    while not os.path.exists(ready):
        if proc.poll() is not None:
            raise AssertionError(
                f"child died early: {proc.stderr.read().decode()[-2000:]}")
        if time.monotonic() - t0 > 120:
            proc.kill()
            raise AssertionError("child never became ready")
        time.sleep(0.05)
    return proc, dump_dir


def _read_bundle(dump_dir):
    files = glob.glob(str(dump_dir / "flight_*.json"))
    assert len(files) == 1, files
    return json.load(open(files[0]))


def test_sigterm_writes_the_checkpoint_then_the_bundle(tmp_path):
    proc, dump_dir = _spawn(tmp_path)
    try:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    # the signal is re-raised after both: a true SIGTERM death
    assert proc.returncode == -signal.SIGTERM, proc.stderr.read()[-2000:]
    b = _read_bundle(dump_dir)
    assert b["reason"] == "signal: SIGTERM"
    assert "trainer.step" in {ev["name"] for ev in b["trace_events"]}
    assert b["executables"]["trainer_fused"]["flops"] == 0.0
    assert b["env"].get("MXTPU_DUMP_ON_CRASH") and b["step"] > 0
    # the final save committed, and before the bundle was written
    man = glob.glob(str(tmp_path / "ck" / "*" / "MANIFEST.json"))
    assert len(man) == 1 and json.load(open(man[0]))["reason"] == "sigterm"
    assert os.path.getmtime(man[0]) <= os.path.getmtime(
        glob.glob(str(dump_dir / "flight_*.json"))[0])


def test_unhandled_exception_writes_bundle(tmp_path):
    proc, dump_dir = _spawn(tmp_path, raise_at=3)
    try:
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 1  # the original traceback still exits 1
    assert b"mid-training crash" in proc.stderr.read()
    b = _read_bundle(dump_dir)
    assert b["reason"].startswith("exception: RuntimeError")
    assert "trainer_fused" in b["executables"]
