"""Live elasticity: the port's ``resilience.elastic`` in a gloo world of 4
ranks against its own uninterrupted runs and the JAX package.

This file is also the worker: ``python tests/test_torch_elastic.py
--worker <scenario> <out_dir>`` (``tests/torch_world.py``) joins the
world, runs the scenario and writes ``<scenario>_rank<r>.npz``; it
imports neither JAX nor the JAX package. A module fixture starts the
world under a hard limit (``SPAWN_TIMEOUT_S``) and meanwhile computes the
JAX package's single-device ``SPMDTrainStep(mesh=None)`` trajectories.

The reference's tentpole (``tests/test_elastic.py``: its MLP and batch,
chaos ``resize:6:2,resize:9:4``, 11 steps, at sgd ZeRO 3 and adam
ZeRO 0): the first 5 losses equal the port's uninterrupted dp-4 run bit
for bit, the state handed over at the shrink equals that run's state
after 5 steps bit for bit, 11 steps are committed on every rank, the
regrow reuses the cached step, the descriptor verifies in both
packages, and all 11 losses are within 1e-5 relative of the JAX
package's single-device step (the reference's mesh step fails under jax
0.9.0, ROADMAP). Every rank returns the same loss; a rank outside the
topology calls no loss. In the same world: two evictions in one drain,
a straggler evicted through ``stall@rank2``, a preemption notice seen by
one rank only, the grow and clip contracts, the old topology's state
dropped, the bucket collectives' chaos faults, a ``Composed4DStep``
snapshot crossing topologies. The reference's six elastic tests that
pass under jax 0.9.0 have host-side counterparts at the end, held to
the reference's results.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import hashlib
import json
import os
import pickle
import re
import subprocess
import sys
import time

import numpy as np
import pytest

import torch_world

SPAWN_TIMEOUT_S = 150
LR = 0.05
STEPS = 11
CHAOS = "resize:6:2,resize:9:4"
RUNS = {"sgd_zero3": ("sgd", 3, {"momentum": 0.9}),
        "adam_zero0": ("adam", 0, {})}
REL_TOL = 1e-5


def batch(n=12):
    r = np.random.RandomState(0)
    return (r.rand(n, 8).astype(np.float32),
            r.randint(0, 4, (n,)).astype(np.float32))


def weights(shapes):
    """The reference's ``_build`` draws: uniform(-0.2, 0.2) from seed 7,
    one parameter after another in natural name order."""
    r = np.random.RandomState(7)
    return [r.uniform(-0.2, 0.2, s).astype(np.float32) for s in shapes]


def natkey(name):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", name)]


def canon(chunks):
    """Auto-name-independent view of a chunk set: keys in natural order,
    each key's distinct (spans, bytes) sorted."""
    out = []
    for key in sorted(chunks, key=natkey):
        out.append(sorted({(tuple((int(a), int(b)) for a, b in spans),
                            np.ascontiguousarray(d).tobytes())
                           for spans, d in chunks[key]}))
    return out


def digest(obj):
    return hashlib.sha256(pickle.dumps(obj, protocol=4)).hexdigest()


# ---------------------------------------------------------------------------
# the worker side
# ---------------------------------------------------------------------------

def _build(mx):
    from mxnet_tpu_torch.gluon import nn

    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu", in_units=8))
    net.add(nn.Dense(4, in_units=16))
    net.initialize(ctx=mx.cpu())
    items = sorted(net.collect_params().items(), key=lambda kv: natkey(kv[0]))
    for (_, p), w in zip(items, weights([p.shape for _, p in items])):
        p.set_data(mx.nd.array(w, ctx=mx.cpu()))
    net.hybridize()
    return net


class _Counting:
    """The loss, counting its calls (a rank outside the topology makes
    none)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args):
        self.calls += 1
        return self.fn(*args)


def _gathered(mx, obj):
    from mxnet_tpu_torch.kvstore.dist import all_gather_bytes

    return [pickle.loads(b) for b in all_gather_bytes(pickle.dumps(obj))]


def _tentpole(mx, rank, res):
    from mxnet_tpu_torch.parallel import spmd
    from mxnet_tpu_torch.resilience import chaos, elastic

    x, y = batch()
    X, Y = mx.nd.array(x, ctx=mx.cpu()), mx.nd.array(y, ctx=mx.cpu())
    for tag, (opt, stage, hyper) in RUNS.items():
        lf = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        ref = mx.parallel.SPMDTrainStep(
            _build(mx), lf, opt, dict(hyper),
            mesh=mx.parallel.make_mesh({"dp": 4}), zero_stage=stage)
        ref_losses = [ref(X, Y, lr=LR) for _ in range(5)]
        merged = {}
        for ch in _gathered(mx, spmd.spmd_state_snapshot(ref)[0]):
            for k, parts in ch.items():
                merged.setdefault(k, []).extend(parts)
        chaos.configure(CHAOS)
        snap = {}
        counting = _Counting(mx.gluon.loss.SoftmaxCrossEntropyLoss())
        et = elastic.ElasticTrainer(
            _build(mx), counting, opt, dict(hyper), zero_stage=stage,
            on_resize=lambda ev, ch: snap.setdefault("chunks", ch))
        losses, calls = [], []
        for _ in range(STEPS):
            before = counting.calls
            losses.append(et.step(X, Y, lr=LR))
            calls.append(counting.calls - before)
        chaos.reset()
        res[f"{tag}:ref"] = np.array(ref_losses)
        res[f"{tag}:losses"] = np.array(losses)
        res[f"{tag}:calls"] = np.array(calls)
        res[f"{tag}:events"] = np.array(json.dumps(et.resize_events))
        res[f"{tag}:committed"] = np.array(et.committed_steps)
        res[f"{tag}:snap_equal"] = np.array(
            canon(snap["chunks"]) == canon(merged))
        res[f"{tag}:snap_digest"] = np.array(digest(canon(snap["chunks"])))
        res[f"{tag}:ref_digest"] = np.array(digest(canon(merged)))
        res[f"{tag}:verify"] = np.array(json.dumps(
            mx.resilience.verify_descriptor(et.last_descriptor)))
        res[f"{tag}:descriptor"] = np.array(json.dumps(et.last_descriptor))
        et.close()


def _multi_eviction(mx, rank, res):
    """Two ranks flagged in one drain (enqueued on rank 0 only: the
    agreement spreads them); an evicted rank never returns through a
    grow in the same drain."""
    from mxnet_tpu_torch.resilience import elastic

    x, y = batch()
    X, Y = mx.nd.array(x, ctx=mx.cpu()), mx.nd.array(y, ctx=mx.cpu())
    et = elastic.ElasticTrainer(_build(mx), mx.gluon.loss
                                .SoftmaxCrossEntropyLoss(), "sgd", {},
                                min_devices=1)
    et.step(X, Y, lr=LR)
    if rank == 0:
        et.monitor._enqueue({"kind": "dead_peer", "reason": "dead_peer",
                             "target": None, "rank": 1, "detail": ""})
        et.monitor._enqueue({"kind": "straggler", "reason": "straggler",
                             "target": None, "rank": 2, "detail": ""})
    et.step(X, Y, lr=LR)
    first = et.devices
    if rank == 0:
        et.monitor._enqueue({"kind": "straggler", "reason": "straggler",
                             "target": None, "rank": 1, "detail": ""})
        et.monitor.request_resize(3, reason="grow")
    et.step(X, Y, lr=LR)
    res["evict:first"] = np.array(first)
    res["evict:second"] = np.array(et.devices)
    et.close()


def _straggler(mx, rank, res):
    from mxnet_tpu_torch.resilience import chaos, elastic

    x, y = batch()
    X, Y = mx.nd.array(x, ctx=mx.cpu()), mx.nd.array(y, ctx=mx.cpu())
    chaos.configure("stall@rank2:p1:0.05")
    mon = elastic.MembershipMonitor(straggler_factor=3.0,
                                    min_latency_s=0.02)
    et = elastic.ElasticTrainer(_build(mx), mx.gluon.loss
                                .SoftmaxCrossEntropyLoss(), "sgd",
                                {"momentum": 0.9}, monitor=mon,
                                zero_stage=2)
    t0 = time.monotonic()
    for _ in range(8):
        et.step(X, Y, lr=LR)
        if et.resize_events:
            break
    wall = time.monotonic() - t0
    chaos.reset()
    after = et.step(X, Y, lr=LR)  # trains on on the shrunk topology
    res["straggler:events"] = np.array(json.dumps(et.resize_events))
    res["straggler:devices"] = np.array(et.devices)
    res["straggler:wall"] = np.array(wall)
    res["straggler:after"] = np.array(after)
    et.close()


def _notice(mx, rank, res, out_dir):
    """A preemption notice that only rank 0 polls: shrink, then grow."""
    from mxnet_tpu_torch.resilience import elastic

    x, y = batch()
    X, Y = mx.nd.array(x, ctx=mx.cpu()), mx.nd.array(y, ctx=mx.cpu())
    path = os.path.join(out_dir, "notice")
    mon = elastic.MembershipMonitor(notice_path=path if rank == 0 else "")
    et = elastic.ElasticTrainer(_build(mx), mx.gluon.loss
                                .SoftmaxCrossEntropyLoss(), "adam", {},
                                monitor=mon, zero_stage=2)
    et.step(X, Y, lr=LR)
    if rank == 0:
        with open(path, "w") as f:
            f.write("shrink:2")
    et.step(X, Y, lr=LR)
    shrunk = et.devices
    if rank == 0:
        time.sleep(0.01)  # a distinct mtime
        with open(path, "w") as f:
            f.write("grow:4")
    et.step(X, Y, lr=LR)
    res["notice:shrunk"] = np.array(shrunk)
    res["notice:grown"] = np.array(et.devices)
    res["notice:events"] = np.array(json.dumps(et.resize_events))
    et.close()


def _grow_clip(mx, rank, res):
    from mxnet_tpu_torch.resilience import elastic

    x, y = batch()
    X, Y = mx.nd.array(x, ctx=mx.cpu()), mx.nd.array(y, ctx=mx.cpu())
    et = elastic.ElasticTrainer(_build(mx), mx.gluon.loss
                                .SoftmaxCrossEntropyLoss(), "sgd", {},
                                devices=[0, 1], min_devices=2)
    et.step(X, Y, lr=LR)
    if rank == 0:
        et.monitor.request_resize(8, reason="grow")  # the pool has 4
    et.step(X, Y, lr=LR)
    grown = et.devices
    if rank == 0:
        et.monitor.request_resize(1, reason="shrink")  # min_devices=2
    et.step(X, Y, lr=LR)
    res["clip:grown"] = np.array(grown)
    res["clip:shrunk"] = np.array(et.devices)
    et.close()


def _drops_state(mx, rank, res):
    from mxnet_tpu_torch.resilience import chaos, elastic

    x, y = batch()
    X, Y = mx.nd.array(x, ctx=mx.cpu()), mx.nd.array(y, ctx=mx.cpu())
    chaos.configure("resize:3:2,resize:5:4")
    et = elastic.ElasticTrainer(_build(mx), mx.gluon.loss
                                .SoftmaxCrossEntropyLoss(), "adam", {},
                                zero_stage=2)
    for _ in range(2):
        et.step(X, Y, lr=LR)
    old = et.spmd_step
    et.step(X, Y, lr=LR)  # the shrink fires here
    dropped = et.spmd_step is not old and old._state is None
    et.step(X, Y, lr=LR)
    et.step(X, Y, lr=LR)  # the grow re-enters the dropped step
    chaos.reset()
    back = et.spmd_step is old and old._state is not None
    et.step(X, Y, lr=LR)  # and it still trains
    res["drop:dropped"] = np.array(dropped)
    res["drop:back"] = np.array(back)
    res["drop:warm"] = np.array(et.resize_events[1]["warm"])
    et.close()


def _bucket_faults(mx, rank, res):
    from mxnet_tpu_torch.resilience import chaos

    x, y = batch()
    X, Y = mx.nd.array(x, ctx=mx.cpu()), mx.nd.array(y, ctx=mx.cpu())
    mesh = mx.parallel.make_mesh({"dp": 4})
    raised = []
    for site, opt, stage in (("bucket_psum", "sgd", 0),
                             ("bucket_psum_scatter", "adam", 2),
                             ("bucket_allgather", "sgd", 3)):
        chaos.configure(f"collective@{site}:1")
        st = mx.parallel.SPMDTrainStep(
            _build(mx), mx.gluon.loss.SoftmaxCrossEntropyLoss(), opt, {},
            mesh=mesh, zero_stage=stage)
        try:
            for _ in range(2):  # ZeRO 3 gathers from its second step
                st(X, Y, lr=LR)
            raised.append("")
        except chaos.ChaosInjectedError as e:
            raised.append(str(e))
        chaos.reset()
    res["faults:raised"] = np.array(raised)


def _composed(mx, rank, res):
    """(dp 4, ZeRO 0) -> (dp 2 x pp 2, ZeRO 2) and back: every tensor of
    the snapshot bit for bit."""
    import torch

    par = mx.parallel
    L, D, B, M = 4, 8, 16, 4
    rng = np.random.RandomState(0)
    W0 = torch.from_numpy((rng.randn(L, D, D) * 0.3).astype(np.float32))
    b0 = torch.from_numpy((rng.randn(L, D) * 0.1).astype(np.float32))
    x = torch.from_numpy(rng.randn(B, D).astype(np.float32))
    y = torch.from_numpy(rng.randn(B, D).astype(np.float32))

    def stage_fn(p, h):
        W, b = p
        return torch.tanh(h @ W + b)

    def loss_fn(o, yy):
        return ((o - yy) ** 2).mean()

    def build(mesh, zero):
        return par.Composed4DStep(stage_fn, (W0, b0), mesh, loss_fn,
                                  optimizer="adam", num_microbatches=M,
                                  zero_stage=zero, device="cpu")

    step_a = build(par.composed_mesh(dp=4), 0)
    for _ in range(3):
        step_a(x, y, lr=0.02)
    chunks_a, _ = step_a.state_snapshot()
    step_b = build(par.composed_mesh(dp=2, pp=2), 2)
    step_b.restore_chunks(chunks_a)
    chunks_b, _ = step_b.state_snapshot()
    step_a2 = build(par.composed_mesh(dp=4), 0)
    step_a2.restore_chunks(chunks_b)
    chunks_a2, _ = step_a2.state_snapshot()
    res["composed:ab"] = np.array(canon(_pairs(chunks_a))
                                  == canon(_pairs(chunks_b)))
    res["composed:aa"] = np.array(canon(_pairs(chunks_a))
                                  == canon(_pairs(chunks_a2)))
    la = [float(step_a(x, y, lr=0.02)) for _ in range(3)]
    lb = [float(step_b(x, y, lr=0.02)) for _ in range(3)]
    res["composed:la"], res["composed:lb"] = np.array(la), np.array(lb)


def _pairs(chunks):
    return {k: [(tuple((sl.start, sl.stop) for sl in idx), d)
                for idx, d in parts] for k, parts in chunks.items()}


def worker(scenario, out_dir):
    if scenario == "imports":
        torch_world.imports_only()
    mx, rank = torch_world.join()
    res = {}
    _tentpole(mx, rank, res)
    _multi_eviction(mx, rank, res)
    _straggler(mx, rank, res)
    _notice(mx, rank, res, out_dir)
    _grow_clip(mx, rank, res)
    _drops_state(mx, rank, res)
    _bucket_faults(mx, rank, res)
    _composed(mx, rank, res)
    np.savez(os.path.join(out_dir, f"{scenario}_rank{rank}.npz"), **res)
    mx.kv.shutdown_distributed()


# ---------------------------------------------------------------------------
# the test side
# ---------------------------------------------------------------------------

def _jax_trajectories():
    """The JAX package's single-device step on the same weights and
    batch: 11 losses a run."""
    import mxnet_tpu as jmx
    from mxnet_tpu.gluon import nn

    x, y = batch()
    out = {}
    for tag, (opt, _, hyper) in RUNS.items():
        net = nn.HybridSequential()
        net.add(nn.Dense(16, activation="relu", in_units=8))
        net.add(nn.Dense(4, in_units=16))
        net.initialize(init=jmx.initializer.Constant(0.0))
        items = sorted(net.collect_params().items(),
                       key=lambda kv: natkey(kv[0]))
        for (_, p), w in zip(items, weights([p.shape for _, p in items])):
            p.set_data(jmx.nd.array(w))
        net.hybridize()
        step = jmx.parallel.SPMDTrainStep(
            net, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), opt,
            dict(hyper), mesh=None)
        out[tag] = np.array([step(x, y, lr=LR) for _ in range(STEPS)])
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("elastic"))
    procs = torch_world.start(__file__, "w4", 4, out_dir)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    ref = _jax_trajectories()
    logs = torch_world.finish(procs, deadline, SPAWN_TIMEOUT_S)
    ranks = torch_world.results(out_dir, "w4", logs)
    return {"ranks": ranks, "ref": ref, "dir": out_dir}


@pytest.mark.parametrize("tag", list(RUNS))
def test_resize_4_2_4_bitexact_zero_lost(world, tag):
    r0 = world["ranks"][0]
    events = json.loads(str(r0[f"{tag}:events"]))
    assert [e["to"] for e in events] == [2, 4]
    assert events[0]["step"] == 5  # the boundary: 5 committed
    assert events[1]["warm"] is True  # 2 -> 4 reuses the cached step
    for r in world["ranks"]:
        assert int(r[f"{tag}:committed"]) == STEPS
        # bit for bit: the uninterrupted dp-4 run's losses and state
        np.testing.assert_array_equal(r[f"{tag}:losses"][:5], r[f"{tag}:ref"])
        assert bool(r[f"{tag}:snap_equal"])
        assert str(r[f"{tag}:snap_digest"]) == str(r[f"{tag}:ref_digest"])
        assert json.loads(str(r[f"{tag}:verify"])) == []
        # every rank returns the same loss
        np.testing.assert_array_equal(r[f"{tag}:losses"], r0[f"{tag}:losses"])


@pytest.mark.parametrize("tag", list(RUNS))
def test_resize_losses_match_jax_single_device(world, tag):
    got = world["ranks"][0][f"{tag}:losses"]
    want = world["ref"][tag]
    np.testing.assert_allclose(got, want, rtol=REL_TOL, atol=0)


@pytest.mark.parametrize("tag", list(RUNS))
def test_rank_outside_topology_runs_no_forward(world, tag):
    for rank, r in enumerate(world["ranks"]):
        calls = r[f"{tag}:calls"]
        # steps 6-8 (indices 5-7) run on ranks 0 and 1 only
        want = [0 if rank >= 2 and 5 <= i <= 7 else 1 for i in range(STEPS)]
        assert calls.tolist() == want, (rank, calls)


@pytest.mark.parametrize("tag", list(RUNS))
def test_descriptor_verifies_in_both_packages(world, tag, tmp_path):
    from mxnet_tpu import resilience as jres

    desc = json.loads(str(world["ranks"][0][f"{tag}:descriptor"]))
    assert desc["format"] == "mxtpu-snapshot-v1"
    assert desc["topology"] == {"from_devices": 2, "to_devices": 4}
    assert jres.verify_descriptor(desc) == []
    p = tmp_path / "desc.json"
    p.write_text(json.dumps(desc))
    tool = os.path.join(torch_world.ROOT, "tools", "verify_checkpoint.py")
    got = subprocess.run([sys.executable, tool, "--from-json", str(p)],
                         capture_output=True, text=True, timeout=120,
                         cwd=torch_world.ROOT)
    assert got.returncode == 0 and got.stdout.startswith("OK"), \
        got.stdout + got.stderr


def test_multi_eviction_one_drain_removes_the_right_ranks(world):
    for r in world["ranks"]:
        assert r["evict:first"].tolist() == [0, 3]
        assert r["evict:second"].tolist() == [0, 1, 2]


def test_straggler_evicted_before_the_watchdog(world):
    from mxnet_tpu_torch.kvstore.dist import _barrier_timeout_s

    for r in world["ranks"]:
        events = json.loads(str(r["straggler:events"]))
        assert events and events[0]["reason"] == "straggler"
        assert r["straggler:devices"].tolist() == [0, 1, 3]
        assert float(r["straggler:wall"]) < _barrier_timeout_s() / 2
        assert np.isfinite(float(r["straggler:after"]))


def test_preempt_notice_on_one_rank_shrinks_then_grows(world):
    for r in world["ranks"]:
        assert r["notice:shrunk"].tolist() == [0, 1]
        assert r["notice:grown"].tolist() == [0, 1, 2, 3]
        events = json.loads(str(r["notice:events"]))
        assert [e["reason"] for e in events] == ["notice", "notice"]
        assert events[1]["warm"] is True


def test_grow_and_clip_contracts(world):
    for r in world["ranks"]:
        assert r["clip:grown"].tolist() == [0, 1, 2, 3]
        assert r["clip:shrunk"].tolist() == [0, 1]


def test_resize_drops_old_topology_state(world):
    for rank, r in enumerate(world["ranks"]):
        if rank < 2:  # a member of both topologies
            assert bool(r["drop:dropped"]) and bool(r["drop:back"])
        assert bool(r["drop:warm"])


def test_chaos_bucket_collective_faults_surface_loudly(world):
    for r in world["ranks"]:
        raised = r["faults:raised"].tolist()
        for site, msg in zip(("bucket_psum", "bucket_psum_scatter",
                              "bucket_allgather"), raised):
            assert f"collective failure at {site}" in msg, (site, msg)


def test_composed4d_snapshot_crosses_topology_bitexact(world):
    for r in world["ranks"]:
        assert bool(r["composed:ab"]) and bool(r["composed:aa"])
        np.testing.assert_allclose(r["composed:lb"], r["composed:la"],
                                   atol=2e-5)


# ---------------------------------------------------------------------------
# the reference's elastic tests that pass under jax 0.9.0, held to its
# results (one process)
# ---------------------------------------------------------------------------

@pytest.fixture
def clean():
    from mxnet_tpu.resilience import chaos as jchaos
    from mxnet_tpu.resilience import elastic as jel
    from mxnet_tpu_torch.resilience import chaos, elastic

    yield
    for c, e in ((chaos, elastic), (jchaos, jel)):
        c.reset()
        if e.monitor() is not None:
            e.monitor().detach()


def _monitor_run(elastic):
    out = []
    for spec, lat in (((3.0, 3, 0.01), (0.05, 0.001, 2)),
                      ((3.0, 3, 0.01), (0.005, 0.0001, 1)),
                      ((3.0, 5, 0.01), (0.5, 0.001, 0))):
        mon = elastic.MembershipMonitor(straggler_factor=spec[0],
                                        min_samples=spec[1],
                                        min_latency_s=spec[2])
        for _ in range(3 if spec[1] == 3 else 1):
            for r in range(4):
                mon.observe_latency(r, lat[0] if r == lat[2] else lat[1])
        out.append((mon.straggler_ranks(),
                    [(s["kind"], s["rank"]) for s in mon.drain()]))
    return out


def test_straggler_policy_math(clean):
    from mxnet_tpu.resilience import elastic as jel
    from mxnet_tpu_torch.resilience import elastic

    got = _monitor_run(elastic)
    assert got == _monitor_run(jel)
    assert got[0] == ([2], [("straggler", 2)])
    assert got[1][0] == [] and got[2][0] == []


def test_chaos_resize_spec_parsing(clean):
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    from mxnet_tpu.resilience import chaos as jchaos
    from mxnet_tpu_torch.resilience import chaos

    for spec in ("resize:8:2,resize@elastic:16:4",
                 "stall@rank12:p0.5:0.1,seed=3"):
        got, want = chaos.configure(spec), jchaos.configure(spec)
        assert got == want, spec
        chaos.reset()
        jchaos.reset()
    with pytest.raises(mx.MXNetError):
        chaos.configure("resize:8")
    with pytest.raises(jmx.MXNetError):
        jchaos.configure("resize:8")


def _prefetch_vals(mesh_of, DevicePrefetcher, mx_vals):
    batches = [np.full((12, 4), i, np.float32) for i in range(6)]
    pf = DevicePrefetcher(batches, mesh=mesh_of(4), depth=4)
    it = iter(pf)
    got = [next(it) for _ in range(2)]
    cursors = [pf.cursor]
    pf.repartition(mesh=mesh_of(2))
    got += list(it)
    cursors.append(pf.cursor)
    pf.close()
    return cursors, [float(mx_vals(b)[0, 0]) for b in got]


def test_prefetcher_repartition_preserves_cursor_and_data():
    import jax
    from jax.sharding import Mesh

    import mxnet_tpu_torch as mx
    from mxnet_tpu.gluon.data.prefetcher import DevicePrefetcher as JPF

    want = _prefetch_vals(
        lambda n: Mesh(np.array(jax.devices()[:n]), ("dp",)), JPF,
        lambda b: np.asarray(b.data))
    with mx.cpu():  # a mesh stages onto the current context
        got = _prefetch_vals(
            lambda n: mx.parallel.make_mesh({"dp": n},
                                            devices=list(range(n))),
            mx.gluon.data.DevicePrefetcher, lambda b: b.asnumpy())
    assert got == want == ([2, 6], [0.0, 1.0, 2.0, 3.0, 4.0, 5.0])


def test_superstep_ring_repartition_delegates():
    import jax
    from jax.sharding import Mesh

    import mxnet_tpu_torch as mx
    from mxnet_tpu.gluon.data.prefetcher import SuperstepRing as JRing

    def run(mesh_of, Ring):
        batches = [(np.full((8, 4), i, np.float32),
                    np.zeros((8,), np.float32)) for i in range(4)]
        ring = Ring(batches, k=2, mesh=mesh_of(4))
        it = iter(ring)
        _, k1 = next(it)
        c1 = ring.cursor
        ring.repartition(mesh=mesh_of(2))
        _, k2 = next(it)
        out = (k1, c1, k2, ring.cursor)
        ring.close()
        return out

    want = run(lambda n: Mesh(np.array(jax.devices()[:n]), ("dp",)), JRing)
    with mx.cpu():
        got = run(lambda n: mx.parallel.make_mesh({"dp": n},
                                                  devices=list(range(n))),
                  mx.gluon.data.SuperstepRing)
    assert got == want == (2, 2, 2, 4)


def test_kvstore_reset_world_clears_reduce_cache():
    """The reference drops its cached reduce mesh; the port caches
    nothing about the world, so the hook has nothing to drop and a store
    reduces as before after it."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu.kvstore import dist as jkvd
    from mxnet_tpu_torch.kvstore import dist as kvd

    jkvd._REDUCE["mesh"] = jkvd._REDUCE["fn"] = "stale"
    jkvd.reset_world()
    assert jkvd._REDUCE["mesh"] is None and jkvd._REDUCE["fn"] is None
    assert not hasattr(kvd, "_REDUCE")
    assert kvd.reset_world() is None
    kv = mx.kv.create("dist_tpu_sync")
    kv.init(3, mx.nd.ones((2,), ctx=mx.cpu()))
    out = mx.nd.zeros((2,), ctx=mx.cpu())
    kv.pushpull(3, mx.nd.ones((2,), ctx=mx.cpu()) * 2, out=out)
    assert out.asnumpy().tolist() == [2.0, 2.0]


def _notice_commits(mxmod, tmp_path, elastic, ctx):
    tmp_path.mkdir()
    notice = tmp_path / "notice"
    net = mxmod.gluon.nn.HybridSequential()
    net.add(mxmod.gluon.nn.Dense(16, activation="relu", in_units=8))
    net.add(mxmod.gluon.nn.Dense(4, in_units=16))
    net.initialize(**ctx)
    tr = mxmod.gluon.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": 0.05}, kvstore=None)
    mgr = mxmod.resilience.CheckpointManager(
        str(tmp_path / "ck"), every_n_steps=10 ** 6, net=net,
        trainer=tr, install_sigterm=False).attach(tr)
    mon = elastic.MembershipMonitor(notice_path=str(notice)).attach()
    x, y = batch(8)
    X, Y = mxmod.nd.array(x, **ctx), mxmod.nd.array(y, **ctx)
    lf = mxmod.gluon.loss.SoftmaxCrossEntropyLoss()
    commits = []
    try:
        def one():
            with mxmod.autograd.record():
                l = lf(net(X), Y)
            l.backward()
            tr.step(8)
            mgr.flush(timeout=60)
            commits.append(mgr.commits)

        one(), one()
        notice.write_text("")  # a plain preemption notice
        one()
        man = json.load(open(os.path.join(mgr.last_saved,
                                          "MANIFEST.json")))
        one()  # consumed: one notice, one checkpoint
    finally:
        mon.detach()
        mgr.close()
    return commits, man["reason"]


def test_preempt_notice_proactive_checkpoint_at_pause_point(tmp_path, clean):
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    from mxnet_tpu.resilience import elastic as jel
    from mxnet_tpu_torch.resilience import elastic

    got = _notice_commits(mx, tmp_path / "port", elastic,
                          {"ctx": mx.cpu()})
    want = _notice_commits(jmx, tmp_path / "ref", jel, {})
    assert got == want == ([0, 0, 1, 1], "preempt_notice")


def test_snapshot_descriptor_equals_the_reference():
    from mxnet_tpu.resilience import elastic as jel
    from mxnet_tpu_torch.resilience import elastic

    rs = np.random.RandomState(3)
    chunks = {"param::w": [((slice(0, 4), slice(0, 3)),
                            rs.randn(4, 3).astype(np.float32))],
              "opt::w::0": [((slice(0, 6),), rs.randn(6).astype(np.float32)),
                            ((slice(6, 12),),
                             rs.randn(6).astype(np.float32))],
              "opt::w::1": [((), np.array(3.0, np.float32))],
              "residual::0": [((slice(0, 8),), np.zeros(8, np.float32))]}
    kw = dict(extents={"residual::0": 8}, step=5, reason="chaos",
              from_devices=4, to_devices=2, cursor=7)
    want = jel.snapshot_descriptor(chunks, **kw)
    assert elastic.snapshot_descriptor(chunks, **kw) == want
    pairs = {k: [(tuple((sl.start, sl.stop) for sl in idx), d)
                 for idx, d in parts] for k, parts in chunks.items()}
    assert elastic.snapshot_descriptor(pairs, **kw) == want


if __name__ == "__main__" and len(sys.argv) >= 4 and \
        sys.argv[1] == "--worker":
    worker(sys.argv[2], sys.argv[3])
