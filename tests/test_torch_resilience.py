"""Port parity: checkpoint and resume in one process and fault injection
(``mx.resilience``: ``checkpoint``, ``resume``, ``chaos``), replaying
the one-device cases of the reference's ``tests/test_resilience.py``,
and the checkpoint format across the two packages.

Resume is held bit for bit: a checkpoint restored into a fresh net and
trainer (another init) and trained on gives the uninterrupted run's
losses, weights, optimizer state (fp32 masters, momentum, Adam's m, v and
t) and loss-scaler counters exactly, with ``trainer.step`` and with
``gluon.Superstep``. Across the packages: the JAX package's
``read_checkpoint`` and ``tools/verify_checkpoint.py`` read a port
checkpoint, and the port reads the JAX package's, every tensor but the
random state (each package keeps its own generator's) equal exactly.
Elastic and sharded checkpoints are ROADMAP A11's.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import resilience
from mxnet_tpu_torch.resilience import chaos, checkpoint
from test_torch_amp import np32, set_weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = {"ctx": mx.cpu()}


@pytest.fixture(autouse=True)
def _clean():
    chaos.reset()
    jmx.resilience.chaos.reset()
    yield
    chaos.reset()
    jmx.resilience.chaos.reset()
    mx.amp.disable()
    jmx.amp.disable()


def _build(m=mx, kw=KW, seed=0, optimizer="adam", fp16=False, lr=0.05,
           dropout=0.0):
    nn = m.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu", in_units=8))
    if dropout:
        net.add(nn.Dropout(dropout))
    net.add(nn.Dense(4, in_units=16))
    net.initialize(**kw)
    set_weights(m, net, seed)
    if fp16:
        m.amp.init("float16")
        m.amp.convert_model(net)
    net.hybridize()
    params = {"learning_rate": lr, "multi_precision": fp16}
    if optimizer == "sgd":
        params["momentum"] = 0.9
    tr = m.gluon.Trainer(net.collect_params(), optimizer, params,
                         kvstore=None)
    if fp16:
        m.amp.init_trainer(tr)
        tr._amp_loss_scaler = m.amp.LossScaler(init_scale=1024.0)
    return net, tr


def _xy(m=mx, kw=KW, i=0, fp16=False):
    rs = np.random.RandomState(10 + i)
    x = m.nd.array(rs.randn(8, 8).astype(np.float32), **kw)
    y = m.nd.array(rs.randint(0, 4, (8,)).astype(np.float32), **kw)
    return (x.astype("float16") if fp16 else x), y


def _step(net, tr, i, fp16=False, m=mx, kw=KW):
    loss_fn = m.gluon.loss.SoftmaxCrossEntropyLoss()
    x, y = _xy(m, kw, i, fp16)
    with m.autograd.record():
        loss = loss_fn(net(x), y)
        if fp16:
            with m.amp.scale_loss(loss, tr) as sl:
                sl.backward()
    if not fp16:
        loss.backward()
    tr.step(8)
    return float(np32(loss.mean()))


def _superstep(ss, i, k, fp16=False):
    stack = mx.gluon.data.stack_batches
    bs = [_xy(mx, KW, j, fp16) for j in range(i, i + k)]
    return np32(ss.step(stack([b[0] for b in bs]),
                        stack([b[1] for b in bs]), 8)).tolist()


def _manager(path, net, tr, every=2, keep=3):
    return resilience.CheckpointManager(path, every_n_steps=every,
                                        keep=keep, net=net, trainer=tr,
                                        install_sigterm=False).attach(tr)


# -- commit protocol, retention, verify ---------------------------------------

def test_interval_commits_retention_and_verify(tmp_path):
    net, tr = _build()
    mgr = _manager(tmp_path / "ck", net, tr, every=2, keep=2)
    try:
        for i in range(9):
            _step(net, tr, i)
            assert mgr.flush(timeout=120)
        steps = [s for s, _ in resilience.list_checkpoints(tmp_path / "ck")]
        assert steps == [6, 8]
        assert resilience.verify(str(tmp_path / "ck")) == []
        assert resilience.latest_checkpoint(str(tmp_path / "ck")).endswith(
            "step_0000000008")
        assert mgr.last_error is None and mgr.commits == 4
        assert len(mgr.snapshot_seconds) == len(mgr.write_seconds) == 4
        names = os.listdir(tmp_path / "ck")
        assert not [n for n in names if n.startswith(".tmp")]
    finally:
        mgr.close()
    assert getattr(tr, "_ckpt_manager", None) is None


def test_snapshot_copies_are_written_over_once_written(tmp_path):
    """The second checkpoint writes its copies into the first's (the same
    tensors), and each commit holds its own step's values."""
    net, tr = _build(optimizer="sgd")
    mgr = _manager(tmp_path / "ck", net, tr, every=1)
    try:
        _step(net, tr, 0)
        assert mgr.flush(timeout=120)
        first = dict(mgr._spare)
        _step(net, tr, 1)
        assert mgr.flush(timeout=120)
        second = mgr._spare
        assert set(second) == set(first)
        assert all(second[k] is v for k, v in first.items()
                   if isinstance(v, torch.Tensor))
        _, got = checkpoint.read_checkpoint(str(tmp_path / "ck"))
        for k, p in net._collect_params_with_prefix().items():
            assert torch.equal(got[f"param::{k}"], p.data().data)
        _, old = checkpoint.read_checkpoint(
            str(tmp_path / "ck" / "step_0000000001"))
        assert not torch.equal(old["param::0.weight"],
                               got["param::0.weight"])
    finally:
        mgr.close()


def test_verify_catches_corruption_truncation_and_missing_state(tmp_path):
    net, tr = _build()
    mgr = _manager(tmp_path / "ck", net, tr)
    _step(net, tr, 0), _step(net, tr, 1)
    assert mgr.flush()
    mgr.close()
    step = resilience.latest_checkpoint(str(tmp_path / "ck"))
    with open(os.path.join(step, "MANIFEST.json")) as f:
        man = json.load(f)
    with open(os.path.join(step, "data.bin"), "r+b") as f:
        f.seek(0)
        f.write(b"\xff\xff\xff\xff")
    assert any("checksum" in p for p in resilience.verify(step))
    with pytest.raises(mx.MXNetError, match="checksum"):
        checkpoint.read_checkpoint(step)
    with open(os.path.join(step, "data.bin"), "r+b") as f:
        f.truncate(16)
    assert any("payload" in p for p in resilience.verify(step))
    key = next(k for k in man["tensors"] if k.startswith("fused::"))
    del man["tensors"][key]
    with open(os.path.join(step, "MANIFEST.json"), "w") as f:
        json.dump(man, f)
    assert any("missing" in p for p in resilience.verify(step))
    assert resilience.verify(str(tmp_path / "nothing"))


@pytest.mark.parametrize("optimizer,fp16,superstep", [
    ("sgd", False, False), ("adam", True, False),
    ("adam", False, True), ("sgd", True, True)],
    ids=["sgd-fp32", "adam-fp16", "adam-fp32-superstep",
         "sgd-fp16-superstep"])
def test_resume_bit_exact(tmp_path, optimizer, fp16, superstep):
    """8 steps with a checkpoint every 4; step 4 restored into a fresh
    net and trainer (another init) and 4 more steps: losses, weights,
    optimizer state, masters and the scaler bit for bit."""
    k = 2

    def run(net, tr, start, n):
        if not superstep:
            return [_step(net, tr, i, fp16) for i in range(start,
                                                           start + n)]
        ss = mx.gluon.Superstep(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                                tr, k=k)
        return [v for i in range(start, start + n, k)
                for v in _superstep(ss, i, k, fp16)]

    net, tr = _build(optimizer=optimizer, fp16=fp16)
    mgr = _manager(tmp_path / "ck", net, tr, every=4)
    want = run(net, tr, 0, 4)
    assert mgr.flush()
    want += run(net, tr, 4, 4)
    mgr.close()
    mx.amp.disable()
    net2, tr2 = _build(seed=1234, optimizer=optimizer, fp16=fp16)
    rep = resilience.load_checkpoint(
        str(tmp_path / "ck" / "step_0000000004"), net=net2, trainer=tr2)
    assert rep.step == 4 and rep.kind == "trainer" and not rep.elastic
    assert run(net2, tr2, 4, 4) == want[4:]
    for (_, a), (_, b) in zip(
            sorted(net._collect_params_with_prefix().items()),
            sorted(net2._collect_params_with_prefix().items())):
        assert torch.equal(a.data().data, b.data().data)
        sa, sb = tr._fused_states[a.name], tr2._fused_states[b.name]
        assert len(sa) == len(sb)
        assert all(torch.equal(u, v) for u, v in zip(sa, sb))
    if fp16:
        s, s2 = tr._amp_loss_scaler, tr2._amp_loss_scaler
        assert (s.loss_scale, s._unskipped, s.overflow_total) == \
            (s2.loss_scale, s2._unskipped, s2.overflow_total)
    assert tr.optimizer._index_update_count == \
        tr2.optimizer._index_update_count


def test_unequal_adam_steps_restored_into_a_live_superstep(tmp_path):
    """A checkpoint whose Adam ``t`` leaves differ (the first weight frozen
    for one step), restored in place into a superstep whose plan was
    built over equal ``t``: the next superstep takes each parameter's own
    bias correction, bit for bit two ``trainer.step``s from the same
    checkpoint."""
    net, tr = _build()
    mgr = _manager(tmp_path / "ck", net, tr, every=3)
    net[0].weight.grad_req = "null"
    _step(net, tr, 0)
    net[0].weight.grad_req = "write"
    _step(net, tr, 1), _step(net, tr, 2)
    assert mgr.flush()
    mgr.close()
    assert sorted(int(st[-1]) for st in tr._fused_states.values()) == \
        [2, 3, 3, 3]
    ck = str(tmp_path / "ck" / "step_0000000003")

    net2, tr2 = _build(seed=7)
    ss = mx.gluon.Superstep(net2, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                            tr2, k=2)
    _superstep(ss, 0, 2)
    assert ss._plan["t_uniform"]
    resilience.load_checkpoint(ck, net=net2, trainer=tr2)
    got = _superstep(ss, 3, 2)
    assert not ss._plan["t_uniform"]

    net3, tr3 = _build(seed=8)
    resilience.load_checkpoint(ck, net=net3, trainer=tr3)
    assert got == [_step(net3, tr3, i) for i in (3, 4)]
    for (_, a), (_, b) in zip(
            sorted(net2._collect_params_with_prefix().items()),
            sorted(net3._collect_params_with_prefix().items())):
        assert torch.equal(a.data().data, b.data().data)
        sa, sb = tr2._fused_states[a.name], tr3._fused_states[b.name]
        assert all(torch.equal(u, v) for u, v in zip(sa, sb))


def test_resume_without_net_raises_and_eager_state_resumes(tmp_path):
    net, tr = _build()
    mx.fusedstep.set_enabled(False)
    try:
        mgr = _manager(tmp_path / "ck", net, tr)
        _step(net, tr, 0), _step(net, tr, 1)
        assert mgr.flush()
        mgr.close()
        net2, tr2 = _build(seed=5)
        with pytest.raises(mx.MXNetError, match="net="):
            resilience.load_checkpoint(str(tmp_path / "ck"), trainer=tr2)
        resilience.load_checkpoint(str(tmp_path / "ck"), net=net2,
                                   trainer=tr2)
        assert _step(net2, tr2, 2) == _step(net, tr, 2)
    finally:
        mx.fusedstep.set_enabled(True)


def test_resume_restores_the_random_stream(tmp_path):
    net, tr = _build(dropout=0.5)
    mgr = _manager(tmp_path / "ck", net, tr)
    _step(net, tr, 0), _step(net, tr, 1)
    assert mgr.flush()
    mgr.close()
    a = [_step(net, tr, i) for i in (2, 3)]
    u = mx.nd.random.uniform(shape=(4,), **KW).asnumpy()
    net2, tr2 = _build(seed=9, dropout=0.5)
    resilience.load_checkpoint(str(tmp_path / "ck"), net=net2, trainer=tr2)
    assert [_step(net2, tr2, i) for i in (2, 3)] == a
    np.testing.assert_array_equal(
        mx.nd.random.uniform(shape=(4,), **KW).asnumpy(), u)


def test_cursor_rides_the_checkpoint_and_skip_batches(tmp_path):
    from mxnet_tpu_torch.gluon.data import DevicePrefetcher

    pf = DevicePrefetcher([np.full((2, 8), i, np.float32) for i in range(6)])
    it = iter(pf)
    next(it), next(it), next(it)
    net, tr = _build()
    mgr = resilience.CheckpointManager(tmp_path / "ck", every_n_steps=1,
                                       net=net, trainer=tr, ring=pf,
                                       install_sigterm=False).attach()
    _step(net, tr, 0)
    assert mgr.flush()
    mgr.close()
    rep = resilience.load_checkpoint(str(tmp_path / "ck"), net=net,
                                     trainer=tr)
    assert rep.cursor == 3
    rest = list(resilience.skip_batches(range(6), rep.cursor))
    assert rest == [3, 4, 5]
    assert list(resilience.resume.restore_cursor(range(6), 4)) == [4, 5]
    with pytest.raises(mx.MXNetError, match="restore"):
        resilience.resume.restore_cursor(range(3), {"kind": "stream"})


def test_env_configures_a_manager(tmp_path, monkeypatch):
    assert checkpoint.parse_env("/a/b:7") == ("/a/b", 7)
    assert checkpoint.parse_env("/a/b") == ("/a/b", 100)
    monkeypatch.delenv("MXTPU_CHECKPOINT", raising=False)
    net, tr = _build()
    assert resilience.maybe_checkpointing(net, tr) is None
    monkeypatch.setenv("MXTPU_CHECKPOINT", f"{tmp_path}/ck:3")
    mgr = resilience.maybe_checkpointing(net, tr)
    try:
        assert mgr.every_n_steps == 3 and tr._ckpt_manager is mgr
        for i in range(3):
            _step(net, tr, i)
        assert mgr.flush()
        assert [s for s, _ in resilience.list_checkpoints(
            f"{tmp_path}/ck")] == [3]
    finally:
        mgr.close()


def test_a11_surface_raises(tmp_path):
    """A11's surface works here: live elasticity's three names (their
    worlds of ranks are ``tests/test_torch_elastic.py``'s), and the
    sharded checkpoint (``tests/test_torch_tp.py`` holds it in worlds of
    ranks) refuses what it cannot write or find, as the JAX package's
    does."""
    mon = resilience.MembershipMonitor(straggler_factor=2.0)
    mon.request_resize(2, reason="manual")
    assert [s["kind"] for s in mon.drain()] == ["resize"]
    desc = resilience.snapshot_descriptor(
        {"param::w": [(((0, 2),), np.ones(2, np.float32))]}, step=1)
    assert resilience.verify_descriptor(desc) == [] \
        == jmx.resilience.verify_descriptor(desc)
    net = mx.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=mx.cpu())
    et = resilience.ElasticTrainer(net, mx.gluon.loss.L2Loss(), "sgd")
    assert np.isfinite(et.step(mx.nd.ones((2, 3), ctx=mx.cpu()),
                               mx.nd.ones((2, 2), ctx=mx.cpu())))
    assert et.committed_steps == 1
    et.close()
    net = mx.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=mx.cpu())
    step = mx.parallel.SPMDTrainStep(net, mx.gluon.loss.L2Loss(), "sgd")
    with pytest.raises(mx.MXNetError, match="run a step"):
        resilience.save_spmd_checkpoint(str(tmp_path), step, 1)
    with pytest.raises(mx.MXNetError, match="no committed checkpoint"):
        resilience.load_checkpoint(str(tmp_path / "x"), spmd_step=step)
    assert resilience.verify_descriptor({"format": "mxtpu-snapshot-v1"}) \
        == jmx.resilience.verify_descriptor({"format": "mxtpu-snapshot-v1"})


# -- the format across the packages ---------------------------------------

def test_checkpoint_format_across_the_packages(tmp_path):
    """An fp16 Adam run with masters and a scaler in each package: the
    JAX package reads the port's checkpoint (and its verify tool passes),
    the port reads the JAX package's; params, optimizer state, masters,
    counts and scaler equal exactly, the random state aside."""
    ck = {}
    for m, kw in ((mx, KW), (jmx, {})):
        net, tr = _build(m, kw, optimizer="adam", fp16=True)
        mgr = m.resilience.CheckpointManager(
            str(tmp_path / m.__name__), every_n_steps=2, net=net,
            trainer=tr, install_sigterm=False) if m is mx else \
            m.resilience.CheckpointManager(
                str(tmp_path / m.__name__), every_n_steps=2, net=net,
                trainer=tr)
        mgr.attach(tr)
        for i in range(2):
            _step(net, tr, i, True, m, kw)
        assert mgr.flush()
        mgr.close()
        m.amp.disable()
        ck[m] = str(tmp_path / m.__name__)
    jman, jten = jmx.resilience.checkpoint.read_checkpoint(ck[mx])
    tman, tten = checkpoint.read_checkpoint(ck[jmx])
    own_j = jmx.resilience.checkpoint.read_checkpoint(ck[jmx])[1]
    own_t = checkpoint.read_checkpoint(ck[mx])[1]
    for mine, theirs, other in ((own_t, jten, "port via jax"),
                                (own_j, tten, "jax via port")):
        keys = {k for k in mine if not k.startswith("rng::")}
        assert keys == {k for k in theirs if not k.startswith("rng::")}
    # each package reads the other's file as its own reader reads it
    for k in own_t:
        if k.startswith("rng::"):
            continue
        a = own_t[k].float().numpy() if isinstance(own_t[k], torch.Tensor) \
            else np.asarray(own_t[k], np.float32)
        np.testing.assert_array_equal(a, np.asarray(jten[k], np.float32), k)
    # the two runs themselves agree to float16's rounding
    for k in own_j:
        if k.startswith("rng::"):
            continue
        np.testing.assert_allclose(np32(tten[k]), np.asarray(
            own_j[k], np.float32), rtol=2e-3, atol=1e-4, err_msg=k)
    assert jman["extras"]["scaler"] == tman["extras"]["scaler"]
    assert jman["extras"]["opt_kind"] == tman["extras"]["opt_kind"]
    tool = os.path.join(ROOT, "tools", "verify_checkpoint.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, tool, "--all", ck[mx]], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    # the port resumes from the JAX package's checkpoint and steps on
    net, tr = _build(optimizer="adam", fp16=True)
    resilience.load_checkpoint(ck[jmx], net=net, trainer=tr)
    assert tr._amp_loss_scaler.loss_scale == 1024.0
    assert np.isfinite(_step(net, tr, 2, True))


# -- chaos --------------------------------------------------------------------

def test_chaos_spec_parsing_matches_jax():
    spec = ("kill:5,term@trainer:3,raise:2,nan@superstep:4,stall:1:0.5,"
            "collective:1,resize:8:2,kill_replica@fleet:40:1,nan:p0.25,"
            "seed=7")
    assert chaos.configure(spec) == jmx.resilience.chaos.configure(spec)
    assert chaos.ENABLED and chaos.spec() == spec
    for bad in ("boom:1", "kill", "resize:3"):
        with pytest.raises(mx.MXNetError):
            chaos.configure(bad)
    chaos.reset()
    assert not chaos.ENABLED and chaos.fired() == []


def test_chaos_raise_stall_and_probabilistic_faults():
    net, tr = _build()
    chaos.configure("raise@trainer:2")
    _step(net, tr, 0)
    with pytest.raises(chaos.ChaosInjectedError):
        _step(net, tr, 1)
    assert chaos.fired() == [("raise", "trainer", 2)]
    seqs = []
    for m in (chaos, jmx.resilience.chaos):
        m.configure("raise:p0.5", seed=42)
        seq = []
        for _ in range(12):
            try:
                m.step_point("t")
                seq.append(0)
            except m.ChaosInjectedError:
                seq.append(1)
        seqs.append(seq)
    assert seqs[0] == seqs[1] and 0 < sum(seqs[0]) < 12


def test_chaos_nan_poisons_a_prefetched_batch():
    from mxnet_tpu_torch.gluon.data import DevicePrefetcher

    chaos.configure("nan@prefetch:2")
    host = [np.ones((2, 4), np.float32) for _ in range(3)]
    out = list(DevicePrefetcher(host))
    assert np.isfinite(np32(out[0])).all() and np.isfinite(np32(out[2])).all()
    assert np.isnan(np32(out[1])).all()
    assert np.isfinite(host[1]).all()  # the source is not written


def test_chaos_nan_superstep_fp16_skips_one_iteration_like_jax():
    """``nan@superstep`` poisons slot 0: that iteration alone skips;
    the trained weights stay finite. BatchNorm-free net: a poisoned
    batch's running statistics are kept in both packages (ROADMAP
    C20)."""
    flags = {}
    for m, kw in ((mx, KW), (jmx, {})):
        net, tr = _build(m, kw, optimizer="sgd", fp16=True)
        ss = m.gluon.Superstep(net, m.gluon.loss.SoftmaxCrossEntropyLoss(),
                               tr, k=4)
        stack = m.gluon.data.stack_batches
        x, y = _xy(m, kw, 0, True)
        ss.step(stack([x] * 4), stack([y] * 4), 8)
        m.resilience.chaos.configure("nan@superstep:1")
        ss.step(stack([x] * 4), stack([y] * 4), 8)
        s = tr._amp_loss_scaler
        flags[m] = (s.loss_scale, s.overflow_total)
        for _, p in net.collect_params().items():
            assert np.isfinite(np32(p.data())).all()
        if m is mx:
            assert ss.last_overflow.tolist() == [1.0, 0.0, 0.0, 0.0]
        m.amp.disable()
    assert flags[mx] == flags[jmx] == (512.0, 1)


def test_poisoned_batchnorm_statistics_are_kept_like_jax_c20():
    """C20 (a fault of the reference, reproduced): a skipped float16
    iteration's BatchNorm running statistics, computed from the NaN
    batch, are kept while the weights are not updated."""
    kept = {}
    for m, kw in ((mx, KW), (jmx, {})):
        nn = m.gluon.nn
        net = nn.HybridSequential()
        net.add(nn.Dense(16, in_units=8), nn.BatchNorm(in_channels=16),
                nn.Dense(3, in_units=16))
        net.initialize(**kw)
        set_weights(m, net)
        m.amp.convert_model(net, "float16")
        net.hybridize()
        tr = m.gluon.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": 0.05,
                              "multi_precision": True}, kvstore=None)
        tr._amp_loss_scaler = m.amp.LossScaler(init_scale=1024.0)
        ss = m.gluon.Superstep(net, m.gluon.loss.SoftmaxCrossEntropyLoss(),
                               tr, k=2)
        m.resilience.chaos.configure("nan@superstep:1")
        stack = m.gluon.data.stack_batches
        x, y = _xy(m, kw, 0, True)
        ss.step(stack([x, x]), stack([y, y]), 8)
        kept[m] = {k: bool(np.isfinite(np32(p.data())).all())
                   for k, p in net._collect_params_with_prefix().items()}
        m.resilience.chaos.reset()
        m.amp.disable()
    assert kept[mx] == kept[jmx]
    assert not kept[mx]["1.running_mean"] and kept[mx]["0.weight"]


_CHILD = r"""
import os, signal, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, os.path.join({root!r}, "tests"))
import numpy as np
import torch
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import resilience
from mxnet_tpu_torch.gluon import trainer as trainer_mod
mode, ck = sys.argv[1], sys.argv[2]
torch.manual_seed(0)
net = mx.gluon.nn.HybridSequential()
net.add(mx.gluon.nn.Dense(16, activation="relu", in_units=8),
        mx.gluon.nn.Dense(4, in_units=16))
net.initialize(ctx=mx.cpu())
net.hybridize()
tr = mx.gluon.Trainer(net.collect_params(), "adam", {{"learning_rate": 0.05}})
k, steps = 2, 10
start = 0
if mode == "resume":
    rep = resilience.load_checkpoint(ck, net=net, trainer=tr)
    start = rep.step
mgr = resilience.CheckpointManager(ck, every_n_steps=1000, net=net,
                                   trainer=tr).attach()
mgr.restore_step(start)
ss = mx.gluon.Superstep(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), tr, k=k)
if mode == "kill":
    orig = trainer_mod.Superstep._iterate
    def iterate(self, plan, i):
        if mgr.step == 4 and i == 1:  # inside superstep 3
            os.kill(os.getpid(), signal.SIGTERM)
        return orig(self, plan, i)
    trainer_mod.Superstep._iterate = iterate
rs = np.random.RandomState(3)
data = [(rs.randn(k, 8, 8).astype(np.float32),
         rs.randint(0, 4, (k, 8)).astype(np.float32)) for _ in range(5)]
for g in range(start // k, steps // k):
    x, y = data[g]
    out = ss.step(mx.nd.array(x, ctx=mx.cpu()),
                  mx.nd.array(y, ctx=mx.cpu()), 8)
    print("LOSS", g, out.data.tolist(), flush=True)
w = torch.cat([p.data().data.flatten() for _, p in
               sorted(net.collect_params().items())])
print("HASH", w.double().sum().item(), flush=True)
mgr.close()
"""


def test_sigterm_mid_superstep_commits_at_the_k_boundary(tmp_path):
    """A SIGTERM raised inside superstep 3's iterations: the final
    checkpoint waits for the superstep's end (step 6, a K boundary),
    the process dies by the signal, and a fresh process resuming from
    the checkpoint reproduces the uninterrupted run's last supersteps
    and weights bit for bit."""
    script = tmp_path / "child.py"
    script.write_text(_CHILD.format(root=ROOT))
    env = {k: v for k, v in os.environ.items() if k != "MXTPU_CHAOS"}

    def child(mode, ck, rc=0):
        r = subprocess.run([sys.executable, str(script), mode, str(ck)],
                           env=env, capture_output=True, text=True,
                           timeout=180)
        assert r.returncode == rc, r.stdout + r.stderr
        losses = {int(ln.split()[1]): ln.split(" ", 2)[2]
                  for ln in r.stdout.splitlines() if ln.startswith("LOSS")}
        h = [ln for ln in r.stdout.splitlines() if ln.startswith("HASH")]
        return losses, h

    full, full_hash = child("full", tmp_path / "ref")
    child("kill", tmp_path / "ck", rc=-signal.SIGTERM)
    ckpts = resilience.list_checkpoints(str(tmp_path / "ck"))
    assert [s for s, _ in ckpts] == [6]
    with open(os.path.join(ckpts[0][1], "MANIFEST.json")) as f:
        assert json.load(f)["reason"] == "sigterm"
    assert resilience.verify(ckpts[0][1]) == []
    res, res_hash = child("resume", tmp_path / "ck")
    assert res == {g: full[g] for g in (3, 4)}
    assert res_hash == full_hash
