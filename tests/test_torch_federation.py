"""The port's metric federation (``observability/federation.py``) against
the JAX package's: the same registry operations give the same snapshot
(but for its wall time), and the same snapshots ingested give identical
cluster exposition, stale marking and per-rank reads; in a gloo world of
2 ranks one ``exchange()`` (over ``kvstore.dist.all_gather_bytes``) gives
each rank a cluster view with both.

This file is also the worker of its world: ``python
tests/test_torch_federation.py --worker fed2 <out_dir>``
(``tests/torch_world.py``); it imports neither JAX nor the JAX package.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import json
import os
import sys
import time

import numpy as np
import pytest

import torch_world

SPAWN_TIMEOUT_S = 90
#: help texts the port words for itself (``test_torch_observability``)
PORT_HELP = {"mxtpu_xla_dispatch_total"}


# ---------------------------------------------------------------------------
# the worker side
# ---------------------------------------------------------------------------

def worker(scenario, out_dir):
    if scenario == "imports":
        torch_world.imports_only()
    mx, rank = torch_world.join()
    obs = mx.observability
    obs.set_enabled(True)
    obs.KV_PUSH_TOTAL.inc(10 + rank)
    obs.SERVE_QUEUE_DEPTH.set(3 * (rank + 1), model="bert")
    obs.TRAINER_STEP_SECONDS.observe(0.01 * (rank + 1))
    n = obs.federation.exchange()
    res = {"n": np.array(n),
           "ranks": np.array(obs.federation.cluster_ranks()),
           "depth": np.array(json.dumps(obs.federation.cluster_values(
               "mxtpu_serving_queue_depth", {"model": "bert"}))),
           "cluster": np.array(obs.federation.cluster_registry()
                               .dump_prometheus())}
    np.savez(os.path.join(out_dir, f"{scenario}_rank{rank}.npz"), **res)
    mx.kv.shutdown_distributed()


# ---------------------------------------------------------------------------
# the test side
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("federation"))
    procs = torch_world.start(__file__, "fed2", 2, out_dir)
    logs = torch_world.finish(procs, time.monotonic() + SPAWN_TIMEOUT_S,
                              SPAWN_TIMEOUT_S)
    return torch_world.results(out_dir, "fed2", logs)


@pytest.fixture
def both():
    from mxnet_tpu import observability as jobs
    from mxnet_tpu_torch import observability as obs

    for o in (obs, jobs):
        o.set_enabled(True)
        o.reset()
        o.federation.stop()
        o.federation.reset()
    yield obs, jobs
    for o in (obs, jobs):
        o.federation.stop()
        o.federation.reset()
        o.set_enabled(False)
        o.reset()


def _record(o):
    o.KV_PUSH_TOTAL.inc(5)
    o.KV_PUSH_BYTES.inc(1024)
    o.SERVE_QUEUE_DEPTH.set(4, model="bert")
    o.SERVE_QUEUE_DEPTH.set(1, model="resnet")
    for v in (0.01, 0.02, 0.5):
        o.TRAINER_STEP_SECONDS.observe(v)
    o.SUPERSTEP_ITER_LOSS.set_series([1.0, 0.5])
    o.tracer().mark_step()
    o.record_xla_dispatch("spmd_step", 3)


def _snap(o):
    s = o.federation.snapshot(rank=0)
    s.pop("wall")
    for name in PORT_HELP:
        s["metrics"].get(name, {}).pop("help", None)
    return s


def test_snapshot_equals_the_reference(both):
    obs, jobs = both
    _record(obs)
    _record(jobs)
    assert _snap(obs) == _snap(jobs)


def _peers(snap):
    """Three ranks from one snapshot: values scaled by rank, rank 2's
    histogram bucket layout its own."""
    out = []
    for r in range(3):
        p = json.loads(json.dumps(snap))
        p["rank"], p["wall"], p["step_epoch"] = r, 1000.0 + r, 7 + r
        for m in p["metrics"].values():
            for k, v in m["values"].items():
                m["values"][k] = [x * (r + 1) for x in v] \
                    if isinstance(v, list) else v * (r + 1)
        out.append(p)
    out[2]["metrics"]["mxtpu_trainer_step_seconds"]["buckets"] = [0.1, 1.0]
    out[2]["metrics"]["mxtpu_trainer_step_seconds"]["values"] = {
        "": [1.0, 2.0, 2.0, 0.52]}
    return out


def test_same_snapshots_give_identical_cluster_exposition(both,
                                                          monkeypatch):
    obs, jobs = both
    monkeypatch.setenv("MXTPU_FEDERATION_STALE_S", "30")
    _record(jobs)
    peers = _peers(jobs.federation.snapshot(rank=0))
    texts, metas = [], []
    for o in (obs, jobs):
        for r, p in enumerate(peers):
            # rank 2 was last heard from 100 s ago: stale, still shown
            o.federation.ingest(json.loads(json.dumps(p)),
                                recv_mono=500.0 - (100.0 if r == 2 else 0))
        stale = o.federation.update_cluster_meta(now=500.0)
        metas.append((stale, o.federation.stale_ranks(now=500.0),
                      o.federation.cluster_ranks(),
                      o.federation.cluster_values(
                          "mxtpu_serving_queue_depth", {"model": "bert"},
                          now=500.0),
                      o.FEDERATION_RANKS.value(),
                      o.FEDERATION_STALE_RANKS.value(rank="2")))
        texts.append(o.federation.cluster_registry().dump_prometheus())
    assert texts[0] == texts[1]
    assert metas[0] == metas[1]
    assert metas[0][0] == [2] and metas[0][3] == {0: 4.0, 1: 8.0}
    assert 'rank="all"' in texts[0] and 'rank="2"' in texts[0]


def test_poll_is_a_no_op_in_one_process(both):
    obs, _ = both
    assert obs.federation.poll() is False


def test_exchange_in_a_world_of_two_sees_both_ranks(world):
    for rank, r in enumerate(world):
        assert int(r["n"]) == 2
        assert r["ranks"].tolist() == [0, 1]
        assert json.loads(str(r["depth"])) == {"0": 3.0, "1": 6.0}
        text = str(r["cluster"])
        for want in ('mxtpu_kvstore_push_total{rank="0"} 10',
                     'mxtpu_kvstore_push_total{rank="1"} 11',
                     'mxtpu_kvstore_push_total{rank="all"} 21'):
            assert want in text, want


if __name__ == "__main__" and len(sys.argv) >= 4 and \
        sys.argv[1] == "--worker":
    worker(sys.argv[2], sys.argv[3])
