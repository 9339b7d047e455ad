"""Port parity in worlds of several processes: ``dist_tpu_sync``, the
Trainer over ranks and ``SPMDTrainStep`` on a data-parallel mesh, each a
``torch.distributed`` world of gloo ranks on the CPU.

This file is also the worker: ``python tests/test_torch_dist.py --worker
<scenario> <out_dir>`` under the environment contract of
``tools/launch.py`` (``MXTPU_COORDINATOR``, ``MXTPU_NUM_PROCESSES``,
``MXTPU_PROCESS_ID``) joins the world through
``kvstore.init_distributed(backend="gloo")``, runs its scenario and writes
``<scenario>_rank<r>.npz``. The worker imports neither JAX nor the JAX
package (``tests/test_torch_isolation.py`` runs its import set); the JAX
package's side is computed here, in the test process. A module fixture
starts every world at once and waits for all of them, each with a hard
limit (``SPAWN_TIMEOUT_S``, the counterpart of the reference's
``DIST_TEST_TIMEOUT_S``): a world that overruns is killed with its
process group and its tests fail with its output.

- Worlds of 2 and 3 replay ``tests/distributed/dist_worker.py``'s
  analytically known aggregates (rank 0's init wins, push sums,
  ``pushpull`` leaves the store, an updater on the global sum, 2-bit
  compression before the wire), plus the bucketed multi-key pushpull with
  compression, ``bucket_allreduce``/``bucket_reduce_scatter`` on known
  sums, ``all_gather_bytes`` of blobs of different lengths and
  ``row_sparse_pull`` raising (A13), asserted in each rank; in the world
  of 2 ``measure_overlap`` reports every mode.
- A barrier whose peer never arrives raises ``CollectiveTimeoutError``
  within its limit (``MXTPU_BARRIER_TIMEOUT_S=3``: under 10 s).
- ``Trainer(kvstore="dist_tpu_sync")`` over two ranks on a two-layer,
  narrow BERT (Adam, two steps, each rank its half of the batch) against
  the JAX package's two-context ``kvstore="device"`` Trainer on the same
  halves: the same sum of per-shard gradients. Weights (Normal(0.02)
  from a numpy seed) within 1e-5 absolute + 1e-4 relative (the forwards
  sum in another order), the attention's key biases, whose gradient is
  rounding noise that Adam amplifies, within Adam's step bound; the two
  ranks' weights and first summed gradients equal bit for bit.
- ``SPMDTrainStep`` on a dp mesh of 2 and of 4, four steps of an MLP on
  four global batches: ZeRO 1/2/3 give stage 0's losses and weights bit
  for bit, ``ready`` equals ``barrier`` (and ``staged``) bit for bit, the
  ranks' replicas are equal, ``zero_memory_report`` shows stage 2/3's
  optimizer + gradient bytes within 1.05/dp of replicated and stage 3's
  parameter bytes below stage 0's; 2-bit compression gives the same
  numbers through the all-reduce and the reduce-scatter, carries a
  residual and lowers the loss on the first batch as the exact run does;
  float32 as ``grad_dtype`` changes nothing. Compression and a bfloat16
  ``grad_dtype``, which the reference's mesh path cannot run under this
  JAX, are held against a plain torch run written from their semantics
  (``_plain_dp_reference``): 1e-7 absolute + 1e-6 relative for the
  compressed Adam, bit for bit for the bfloat16 SGD. The rest is held
  against the JAX package's single-device ``SPMDTrainStep(mesh=None)`` on the global
  batch, with SGD with momentum and with Adam: losses within 1e-5
  relative, weights within 1e-5 absolute + 1e-4 relative (the mean over
  the global batch is taken as (1/dp) times the sum of the shards' means,
  and Adam's bias correction is double in the port).
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: hard limit of one world, start to end
SPAWN_TIMEOUT_S = 150
STEPS = 4
GLOBAL_BATCH = 8
BERT_CFG = dict(vocab_size=1000, dropout=0.0, num_layers=2, units=64,
                hidden_size=128, num_heads=4, max_length=64)
HYPER = {"sgd": {"momentum": 0.9, "wd": 0.01}, "adam": {"wd": 0.01}}
LR = 0.05


# ---------------------------------------------------------------------------
# inputs both sides make from numpy seeds
# ---------------------------------------------------------------------------

def mlp_weights():
    """Sorted-name order of an MLP 10 -> 16 (relu) -> 4: bias0, weight0,
    bias1, weight1."""
    rs = np.random.RandomState(3)
    return [rs.uniform(-0.3, 0.3, s).astype(np.float32)
            for s in ((16,), (16, 10), (4,), (4, 16))]


def mlp_batches():
    rs = np.random.RandomState(7)
    return [(rs.randn(GLOBAL_BATCH, 10).astype(np.float32),
             rs.randn(GLOBAL_BATCH, 4).astype(np.float32))
            for _ in range(STEPS)]


def bert_batch(rows=4, seq=16):
    rs = np.random.RandomState(0)
    ids = rs.randint(5, 1000, (rows, seq)).astype(np.int32)
    types = (np.arange(seq) >= seq // 2).astype(np.int32)[None].repeat(
        rows, 0)
    mask = (rs.uniform(size=(rows, seq)) < 0.15).astype(np.float32)
    mask[:, 1] = 1.0
    nsp = rs.randint(0, 2, (rows,)).astype(np.float32)
    return ids, types, mask, nsp


def make_mlp(m, ctx=None):
    kw = {} if ctx is None else {"ctx": ctx}
    net = m.gluon.nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(m.gluon.nn.Dense(16, in_units=10, activation="relu"),
                m.gluon.nn.Dense(4, in_units=16))
    net.initialize(**kw)
    for (_, p), w in zip(sorted(net.collect_params().items()),
                         mlp_weights()):
        p.set_data(m.nd.array(w, **kw))
    return net


#: SPMD runs: (name, optimizer, zero stage, overlap, extra kwargs)
SPMD2 = [(f"{o}_z{s}_ready", o, s, "ready", {})
         for o in ("adam", "sgd") for s in (0, 1, 2, 3)] + [
    ("adam_z0_barrier", "adam", 0, "barrier", {}),
    ("adam_z2_barrier", "adam", 2, "barrier", {}),
    ("adam_z0_staged", "adam", 0, "staged", {}),
    ("sgd_z0_barrier", "sgd", 0, "barrier", {}),
    ("adam_z0_comp", "adam", 0, "ready",
     {"compression_params": {"type": "2bit", "threshold": 0.05}}),
    ("adam_z2_comp", "adam", 2, "ready",
     {"compression_params": {"type": "2bit", "threshold": 0.05}}),
    ("adam_z0_staged_comp", "adam", 0, "staged",
     {"compression_params": {"type": "2bit", "threshold": 0.05}}),
    ("sgd_z0_bf16", "sgd", 0, "ready", {"grad_dtype": "bfloat16"}),
    ("sgd_z0_fp32", "sgd", 0, "ready", {"grad_dtype": "float32"}),
]
SPMD4 = [(f"adam_z{s}_ready", "adam", s, "ready", {}) for s in (0, 2, 3)] \
    + [("adam_z3_barrier", "adam", 3, "barrier", {}),
       ("sgd_z0_ready", "sgd", 0, "ready", {}),
       ("sgd_z2_ready", "sgd", 2, "ready", {})]


# ---------------------------------------------------------------------------
# the worker (no JAX here)
# ---------------------------------------------------------------------------

def _w_aggregates(mx, rank, n, cpu=None):
    """``dist_worker.py``'s aggregates, asserted in this rank (on the
    host, or on the context ``cpu`` names)."""
    shape = (4, 5)
    cpu = cpu or mx.cpu()

    def full(v):
        return mx.nd.array(np.full(shape, v, np.float32), ctx=cpu)

    def check(a, v):
        np.testing.assert_allclose(a.asnumpy(), np.full(shape, v,
                                                        np.float32),
                                   rtol=1e-6)

    kv = mx.kv.create("dist_tpu_sync")
    assert kv.rank == rank and kv.num_workers == n
    # a list of keys is broadcast in buckets (several keys a bucket; in
    # the world of 3, with 4 KiB buckets, the largest in one of its own):
    # rank 0's values everywhere
    kv0 = mx.kv.create("dist_tpu_sync")
    shapes = [(3,), (300, 5), (2, 2), (7,)]
    kv0.init(["a", "b", "c", "d"],
             [mx.nd.array(np.full(sh, rank + i, np.float32), ctx=cpu)
              for i, sh in enumerate(shapes)])
    for i, (k, sh) in enumerate(zip("abcd", shapes)):
        got = mx.nd.zeros(sh, ctx=cpu)
        kv0.pull(k, out=got)
        np.testing.assert_array_equal(got.asnumpy(),
                                      np.full(sh, i, np.float32))
    kv.init("w", full(7.0 + rank))
    out = mx.nd.zeros(shape, ctx=cpu)
    kv.pull("w", out=out)
    check(out, 7.0)
    kv.barrier()
    kv.push("w", full(rank + 1.0))
    kv.pull("w", out=out)
    expect = n * (n + 1) / 2.0
    check(out, expect)
    grad = full(2.0 * (rank + 1))
    kv.pushpull("w", grad, out=grad)
    check(grad, 2.0 * expect)
    kv.pull("w", out=out)
    check(out, expect)
    kv.barrier()
    kv2 = mx.kv.create("dist_sync")
    kv2.init("u", full(1.0))

    def updater(key, g, weight):
        weight -= 0.1 * g

    kv2.set_updater(updater)
    kv2.push("u", full(1.0))
    kv2.pull("u", out=out)
    check(out, 1.0 - 0.1 * n)
    try:
        kv.row_sparse_pull("w", out=out, row_ids=mx.nd.array([1], ctx=cpu))
        raise AssertionError("row_sparse_pull did not raise")
    except mx.MXNetError as e:
        assert "A13" in str(e)
    kv3 = mx.kv.create("dist_tpu_sync")
    kv3.init("c", full(0.0))
    kv3.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    kv3.push("c", full(1.0))
    kv3.pull("c", out=out)
    check(out, 0.5 * n)
    kv3.push("c", full(0.25))
    kv3.pull("c", out=out)
    check(out, 0.5 * n)
    # the bucketed multi-key pushpull, compressed, over three rounds
    kv4 = mx.kv.create("dist_tpu_sync")
    kv4.set_gradient_compression({"type": "2bit", "threshold": 0.3})
    rs = np.random.RandomState(rank)
    vals = [rs.uniform(-1, 1, (64,)).astype(np.float32) for _ in range(3)]
    keys = [0, 1, 2]
    kv4.init(keys, [mx.nd.zeros((64,), ctx=cpu) for _ in keys])
    grads = [mx.nd.array(v, ctx=cpu) for v in vals]
    res = [np.zeros(64, np.float32) for _ in keys]
    mine = []
    for _ in range(3):
        gs = [mx.nd.array(v, ctx=cpu) for v in vals]
        kv4.pushpull(keys, gs, out=gs)
        q = []
        for i, v in enumerate(vals):
            acc = v + res[i]
            qi = np.where(acc >= 0.3, 0.3, np.where(acc <= -0.3, -0.3,
                                                    0.0)).astype(np.float32)
            res[i] = acc - qi
            q.append(qi)
        mine.append((q, [g.asnumpy() for g in gs]))
    del grads
    assert len(kv4._bucket_plans) == 1
    # the bucketed collectives alone: each rank's (rank + 1) * g summed
    from mxnet_tpu_torch.parallel import overlap

    shapes = [(3, 5), (7,), (2, 2)]
    plan = overlap.build_bucket_plan(shapes, ["float32"] * 3,
                                     bucket_bytes=64, dp=n)
    gs = [torch_from(np.arange(np.prod(sh), dtype=np.float32).reshape(sh)
                     * (rank + 1)) for sh in shapes]
    red, _ = overlap.bucket_allreduce(gs, None, plan, postscale=0.5)
    shards, _ = overlap.bucket_reduce_scatter(gs, None, plan)
    scale = n * (n + 1) / 2.0
    for k, sh in enumerate(shapes):
        want = np.arange(np.prod(sh), dtype=np.float32).reshape(sh) * scale
        np.testing.assert_allclose(red[k].numpy(), want * 0.5, rtol=1e-6)
        flat = np.zeros(plan.pad_sizes[k], np.float32)
        flat[:want.size] = want.ravel()
        np.testing.assert_allclose(
            shards[k].numpy(), np.split(flat, n)[rank], rtol=1e-6)
    blobs = mx.kv.all_gather_bytes(b"r%d-" % rank * rank)
    assert blobs == [b"r%d-" % r * r for r in range(n)], blobs
    kv.barrier()
    return {"aggregates_ok": np.array(1),
            "bucketed_q": np.stack([np.stack(q) for q, _ in mine]),
            "bucketed_out": np.stack([np.stack(o) for _, o in mine])}


def torch_from(a):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a))


def _w_measure_overlap(mx, n):
    """``measure_overlap`` on the world: every mode's step time and the
    exposed communication, as the reference reports them."""
    x, y = mlp_batches()[0]
    out = mx.parallel.measure_overlap(
        lambda: make_mlp(mx, mx.cpu()), mx.gluon.loss.L2Loss(), "sgd", {},
        mx.parallel.make_mesh({"dp": n}), mx.nd.array(x, ctx=mx.cpu()),
        mx.nd.array(y, ctx=mx.cpu()), steps=2, warmup=1)
    assert set(out["step_seconds"]) == {"nocomm", "ready", "barrier",
                                        "staged"}
    assert set(out["exposed_comm_seconds"]) == {"ready", "barrier",
                                                "staged"}
    assert all(v >= 0 for v in out["exposed_comm_seconds"].values())
    assert 0.0 <= out["hidden_fraction"] <= 1.0
    return {"measure_overlap_ok": np.array(1)}


def _w_trainer(mx, rank, out_dir):
    from chip_smoke import pretrain_loss

    net = mx.models.get_bert_model("bert_12_768_12", **BERT_CFG)
    net.load_parameters(os.path.join(out_dir, "bert.params"), ctx=mx.cpu())
    tr = mx.gluon.Trainer(net.collect_params(), "adam",
                          {"learning_rate": 1e-3, "wd": 0.01},
                          kvstore="dist_tpu_sync")
    batch = bert_batch()
    half = batch[0].shape[0] // 2
    mine = [mx.nd.array(a[rank * half:(rank + 1) * half],
                        dtype=a.dtype.name, ctx=mx.cpu()) for a in batch]
    out = {}
    losses = []
    for step in range(2):
        with mx.autograd.record():
            loss = pretrain_loss(mx, net, *mine, mask_id=3)[0]
        loss.backward()
        losses.append(float(loss.asscalar()))
        if step == 0:
            tr.allreduce_grads()
            out["grad0"] = np.concatenate([
                p.grad().asnumpy().ravel()
                for _, p in sorted(net.collect_params().items())])
            tr.update(1)
        else:
            tr.step(1)
    out["bert_losses"] = np.array(losses)
    out["bert_weights"] = np.concatenate([
        p.data().asnumpy().ravel()
        for _, p in sorted(net.collect_params().items())])
    return out


def _w_spmd(mx, n, runs, ctx=None):
    ctx = ctx or mx.cpu()
    mesh = mx.parallel.make_mesh({"dp": n})
    out = {}
    for name, opt, stage, overlap, extra in runs:
        net = make_mlp(mx, ctx)
        step = mx.parallel.SPMDTrainStep(
            net, mx.gluon.loss.L2Loss(), opt, dict(HYPER[opt]), mesh,
            zero_stage=stage, overlap=overlap, **extra)
        losses = [step(mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx),
                       lr=LR) for x, y in mlp_batches()]
        rep = step.zero_memory_report()
        step.sync_to_block()
        x0, y0 = mlp_batches()[0]
        out[f"{name}:eval"] = np.array([float(mx.gluon.loss.L2Loss()(
            n_(mx.nd.array(x0, ctx=ctx)),
            mx.nd.array(y0, ctx=ctx)).mean().asscalar())
            for n_ in (make_mlp(mx, ctx), net)])
        out[f"{name}:losses"] = np.array(losses)
        out[f"{name}:weights"] = np.concatenate([
            p.data().asnumpy().ravel()
            for _, p in sorted(net.collect_params().items())])
        out[f"{name}:report"] = np.array([
            rep["opt_bytes_per_device"], rep["opt_bytes_replicated"],
            rep["grad_bytes_per_device"], rep["grad_bytes_replicated"],
            rep["param_bytes_per_device"], rep["param_bytes_replicated"]])
        out[f"{name}:mode"] = np.array(f"{step._mode}/{step._overlap_mode}")
        out[f"{name}:residual"] = np.array(
            -1.0 if step._residuals is None else
            float(sum(r.abs().sum() for r in step._residuals)))
    return out


def _w_timeout(mx, rank, out_dir):
    """Rank 1 never reaches the barrier; rank 0's must raise in time."""
    marker = os.path.join(out_dir, "timeout_done")
    if rank == 1:
        t0 = time.monotonic()
        while not os.path.exists(marker) and time.monotonic() - t0 < 30:
            time.sleep(0.1)
        return {}
    from mxnet_tpu_torch.kvstore import CollectiveTimeoutError

    kv = mx.kv.create("dist_tpu_sync")
    t0 = time.monotonic()
    try:
        kv.barrier()
        raised = "nothing"
    except CollectiveTimeoutError as e:
        raised = f"CollectiveTimeoutError: {e}"
    return {"raised": np.array(raised),
            "seconds": np.array(time.monotonic() - t0)}


def worker(scenario, out_dir):
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    import mxnet_tpu_torch as mx

    if scenario == "imports":
        import chip_smoke  # noqa: F401  (the trainer scenario's loss)
        from mxnet_tpu_torch.kvstore import dist  # noqa: F401
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"))
        print(bad)
        sys.exit(1 if bad else 0)
    rank = int(os.environ["MXTPU_PROCESS_ID"])
    n = int(os.environ["MXTPU_NUM_PROCESSES"])
    res = {}
    if scenario == "nccl":
        # NCCL over the card(s) this machine has: it forms the group
        # (several cards), or init_distributed raises with NCCL's words
        try:
            mx.kv.init_distributed(backend="nccl", timeout=60)
        except mx.MXNetError as e:
            res["raised"] = np.array(str(e))
        else:
            res.update(_w_aggregates(mx, rank, n, mx.gpu(0)))
            mx.kv.shutdown_distributed()
        np.savez(os.path.join(out_dir, f"{scenario}_rank{rank}.npz"), **res)
        return
    backend = mx.kv.init_distributed(backend="gloo", timeout=60)
    assert backend == "gloo"
    if scenario in ("main", "aggregates"):
        res.update(_w_aggregates(mx, rank, n))
    if scenario == "main":
        res.update(_w_measure_overlap(mx, n))
        res.update(_w_trainer(mx, rank, out_dir))
        res.update(_w_spmd(mx, n, SPMD2))
    if scenario == "spmd4":
        res.update(_w_spmd(mx, n, SPMD4))
    if scenario == "timeout":
        res.update(_w_timeout(mx, rank, out_dir))
    if scenario == "cuda":
        res.update(_w_aggregates(mx, rank, n, mx.gpu(0)))
        res.update(_w_spmd(mx, n, SPMD4, mx.gpu(0)))
        res["device"] = np.array(str(mx.resolve_device(mx.gpu(0))))
    np.savez(os.path.join(out_dir, f"{scenario}_rank{rank}.npz"), **res)
    if scenario == "timeout":
        if rank == 0:
            open(os.path.join(out_dir, "timeout_done"), "w").close()
        # a rank abandoned inside a collective cannot leave the world
        # cleanly: end the process (the watchdog thread is still blocked)
        sys.stdout.flush()
        os._exit(0)
    mx.kv.shutdown_distributed()


# ---------------------------------------------------------------------------
# the test side
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(scenario, n, out_dir, env_extra=None):
    port = _free_port()
    procs = []
    for r in range(n):
        env = dict(os.environ, MXTPU_COORDINATOR=f"127.0.0.1:{port}",
                   MXTPU_NUM_PROCESSES=str(n), MXTPU_PROCESS_ID=str(r),
                   OMP_NUM_THREADS="1", **(env_extra or {}))
        env.pop("PYTHONPATH", None)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker",
             scenario, out_dir], env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True))
    return procs


def _finish(procs, deadline):
    """Each rank's (return code, output); a world past ``deadline`` is
    killed, every process group of it."""
    out = []
    for p in procs:
        try:
            text, _ = p.communicate(timeout=max(deadline - time.monotonic(),
                                                0.1))
        except subprocess.TimeoutExpired:
            for q in procs:
                try:
                    os.killpg(q.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
            text, _ = p.communicate()
            text = (text or "") + f"\n[killed after {SPAWN_TIMEOUT_S} s]"
        out.append((p.returncode, text))
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    import jax  # noqa: F401
    import mxnet_tpu as jmx

    out_dir = str(tmp_path_factory.mktemp("dist"))
    jnet = jmx.models.get_bert_model("bert_12_768_12", **BERT_CFG)
    jnet.initialize()
    ids, types, _, _ = bert_batch()
    jnet(jmx.nd.array(ids, dtype="int32"), jmx.nd.array(types, dtype="int32"))
    # Normal(0.02) weights from a numpy seed (biases, gamma and beta keep
    # their constant initialisers), whatever ran before in this process
    rs = np.random.RandomState(11)
    for name, p in sorted(jnet.collect_params().items()):
        if name.endswith("weight"):
            p.set_data(jmx.nd.array(
                rs.normal(0.0, 0.02, p.shape).astype(np.float32)))
    jnet.save_parameters(os.path.join(out_dir, "bert.params"))
    plan = {"main": 2, "aggregates": 3, "spmd4": 4, "timeout": 2}
    env = {"timeout": {"MXTPU_BARRIER_TIMEOUT_S": "3"},
           "aggregates": {"MXTPU_BUCKET_BYTES": "4096"}}
    started = {s: _start(s, n, out_dir, env.get(s))
               for s, n in plan.items()}
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    done = {s: _finish(procs, deadline) for s, procs in started.items()}
    results = {}
    for s, n in plan.items():
        ranks = []
        for r in range(n):
            path = os.path.join(out_dir, f"{s}_rank{r}.npz")
            ranks.append(dict(np.load(path)) if os.path.exists(path)
                         else None)
        results[s] = (done[s], ranks)
    return {"results": results, "dir": out_dir}


def _world(worlds, scenario):
    logs, ranks = worlds["results"][scenario]
    for r, (rc, text) in enumerate(logs):
        assert rc == 0 and ranks[r] is not None, \
            f"{scenario} rank {r} rc={rc}:\n{text[-3000:]}"
    return ranks


@pytest.mark.parametrize("scenario", ["main", "aggregates"])
def test_dist_worker_aggregates(worlds, scenario):
    ranks = _world(worlds, scenario)
    for res in ranks:
        assert int(res["aggregates_ok"]) == 1
        if scenario == "main":
            assert int(res["measure_overlap_ok"]) == 1
        # the bucketed compressed pushpull: the sum over ranks of each
        # rank's quantized values, every round
        np.testing.assert_allclose(
            res["bucketed_out"], sum(r["bucketed_q"] for r in ranks),
            rtol=1e-6, atol=1e-7)


def test_barrier_without_its_peer_raises_in_time(worlds):
    ranks = _world(worlds, "timeout")
    raised = str(ranks[0]["raised"])
    assert raised.startswith("CollectiveTimeoutError"), raised
    assert 2.5 <= float(ranks[0]["seconds"]) < 10.0


def _two_context_reference(params_path):
    """The JAX package's two-context Trainer on the same halves (its
    eager multi-context update leaves the second copy on the first
    context's device: each copy is moved back after every step, as in
    ``tests/test_torch_kvstore.py``)."""
    import jax
    import mxnet_tpu as jmx
    from chip_smoke import pretrain_loss

    ctxs = [jmx.cpu(0), jmx.cpu(1)]
    net = jmx.models.get_bert_model("bert_12_768_12", **BERT_CFG)
    net.load_parameters(params_path, ctx=ctxs)
    batch = bert_batch()
    half = batch[0].shape[0] // 2
    shards = [[jmx.nd.array(a[i * half:(i + 1) * half],
                            dtype=a.dtype.name, ctx=c) for a in batch]
              for i, c in enumerate(ctxs)]
    for p in net.collect_params().values():
        for c, d in zip(p.list_ctx(), p.list_data()):
            d._set_data(jax.device_put(d.data, c.jax_device))
    tr = jmx.gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": 1e-3, "wd": 0.01},
                           kvstore="device")
    losses = []
    for _ in range(2):
        with jmx.autograd.record():
            ls = [pretrain_loss(jmx, net, *s, mask_id=3)[0] for s in shards]
        for loss in ls:
            loss.backward()
        tr.step(1)
        for p in net.collect_params().values():
            for c, d in zip(p.list_ctx(), p.list_data()):
                d._set_data(jax.device_put(d.data, c.jax_device))
        losses.append([float(loss.asscalar()) for loss in ls])
    items = sorted(net.collect_params().items())
    weights = np.concatenate([np.array(p.data(ctxs[0]).asnumpy()).ravel()
                              for _, p in items])
    key_bias = np.concatenate([
        np.full(int(np.prod(p.shape)), name.endswith("attn_key_bias"))
        for name, p in items])
    return np.array(losses), weights, key_bias


def test_two_rank_trainer_matches_two_context_jax(worlds):
    ranks = _world(worlds, "main")
    np.testing.assert_array_equal(ranks[0]["grad0"], ranks[1]["grad0"])
    np.testing.assert_array_equal(ranks[0]["bert_weights"],
                                  ranks[1]["bert_weights"])
    losses, weights, key_bias = _two_context_reference(
        os.path.join(worlds["dir"], "bert.params"))
    got_losses = np.stack([ranks[0]["bert_losses"],
                           ranks[1]["bert_losses"]], axis=1)
    np.testing.assert_allclose(got_losses, losses, rtol=1e-5)
    got = ranks[0]["bert_weights"]
    np.testing.assert_allclose(got[~key_bias], weights[~key_bias],
                               rtol=1e-4, atol=1e-5)
    # The attention's key bias has a zero gradient in exact arithmetic
    # (the softmax over the keys ignores the shift q.b_k that it adds), so
    # each package's is rounding noise, below 1e-9 here, and Adam, which
    # moves an element by up to lr |g| / (|g| + eps), can turn that noise
    # into steps of up to lr * 1e-9 / (1e-9 + 1e-8) in either package:
    # 2 packages x 2 steps x 1e-3 x 0.091 < 4e-4 apart.
    assert np.abs(ranks[0]["grad0"][key_bias]).max() < 1e-9
    np.testing.assert_allclose(got[key_bias], weights[key_bias], rtol=0,
                               atol=4e-4)


def _single_device_reference(opt):
    """The JAX package's ``SPMDTrainStep(mesh=None)`` on the global
    batches."""
    import mxnet_tpu as jmx

    net = make_mlp(jmx)
    step = jmx.parallel.SPMDTrainStep(net, jmx.gluon.loss.L2Loss(), opt,
                                      dict(HYPER[opt]), mesh=None)
    losses = [step(jmx.nd.array(x), jmx.nd.array(y), lr=LR)
              for x, y in mlp_batches()]
    step.sync_to_block()
    return np.array(losses), np.concatenate([
        np.array(p.data().asnumpy()).ravel()
        for _, p in sorted(net.collect_params().items())])


@pytest.fixture(scope="module")
def references():
    return {opt: _single_device_reference(opt) for opt in HYPER}


@pytest.mark.parametrize("scenario,runs", [("main", SPMD2),
                                           ("spmd4", SPMD4)],
                         ids=["dp2", "dp4"])
def test_spmd_dp_matches_single_device_jax(worlds, references, scenario,
                                           runs):
    ranks = _world(worlds, scenario)
    for name, opt, stage, _, extra in runs:
        for res in ranks[1:]:
            np.testing.assert_array_equal(res[f"{name}:weights"],
                                          ranks[0][f"{name}:weights"], name)
            np.testing.assert_array_equal(res[f"{name}:losses"],
                                          ranks[0][f"{name}:losses"], name)
        if extra:
            continue
        losses, weights = references[opt]
        np.testing.assert_allclose(ranks[0][f"{name}:losses"], losses,
                                   rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(ranks[0][f"{name}:weights"], weights,
                                   rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("scenario,runs", [("main", SPMD2),
                                           ("spmd4", SPMD4)],
                         ids=["dp2", "dp4"])
def test_zero_stages_and_schedules_bit_for_bit(worlds, scenario, runs):
    res = _world(worlds, scenario)[0]
    for name, opt, stage, overlap, extra in runs:
        if extra or (stage == 0 and overlap == "ready"):
            continue
        base = f"{opt}_z0_ready"
        np.testing.assert_array_equal(res[f"{name}:losses"],
                                      res[f"{base}:losses"], name)
        np.testing.assert_array_equal(res[f"{name}:weights"],
                                      res[f"{base}:weights"], name)
    if scenario == "main":
        assert str(res["adam_z0_staged:mode"]) == "staged/staged"
        assert str(res["adam_z0_staged_comp:mode"]) == "overlap/barrier"
        assert str(res["adam_z1_ready:mode"]).startswith("jit/")
        assert str(res["adam_z2_ready:mode"]) == "overlap/ready"


@pytest.mark.parametrize("scenario,dp", [("main", 2), ("spmd4", 4)],
                         ids=["dp2", "dp4"])
def test_zero_memory_report_reductions(worlds, scenario, dp):
    res = _world(worlds, scenario)[0]
    rep = {s: res[f"adam_z{s}_ready:report"] for s in (0, 2, 3)}
    opt_dev, opt_rep, grad_dev, grad_rep, par_dev, par_rep = rep[0]
    assert opt_dev == opt_rep and grad_dev == grad_rep and par_dev == par_rep
    for s in (2, 3):
        o_d, o_r, g_d, g_r, _, _ = rep[s]
        assert o_d + g_d <= (o_r + g_r) / dp * 1.05, (s, rep[s])
    assert rep[3][4] < rep[0][4]


def _plain_dp_reference(opt, n, threshold=None, wire=None):
    """The MLP's data-parallel run over ``n`` ranks written out in plain
    torch from the semantics, independent of the port's collectives: each
    rank's gradient of the mean L2 loss over its rows; with ``threshold``,
    that gradient plus the rank's own carried residual quantized to
    ``{-t, 0, +t}`` and the error carried to the next step (before the
    sum and the 1/n); with ``wire``, each rank's gradient in the wire type
    and their sum rounded to it; the sum times 1/n; then MXNet's rule on
    the whole parameter. Returns (losses, concatenated weights in sorted
    name order)."""
    import torch
    import torch.nn.functional as tF

    ws = [torch.from_numpy(w.copy()) for w in mlp_weights()]
    res = [[torch.zeros_like(w) for w in ws] for _ in range(n)]
    moms = [[torch.zeros_like(w), torch.zeros_like(w)] for w in ws]
    wd, rows = HYPER[opt]["wd"], GLOBAL_BATCH // n
    losses = []
    for t, (x, y) in enumerate(mlp_batches(), 1):
        per_rank, loss_sum = [], 0.0
        for r in range(n):
            p = [w.clone().requires_grad_() for w in ws]
            xr = torch.from_numpy(x[r * rows:(r + 1) * rows])
            yr = torch.from_numpy(y[r * rows:(r + 1) * rows])
            out = tF.linear(torch.relu(tF.linear(xr, p[1], p[0])), p[3],
                            p[2])
            loss = (0.5 * torch.square(yr - out)).mean(dim=1).mean()
            gs = list(torch.autograd.grad(loss, p))
            if threshold is not None:
                thr = torch.tensor(threshold, dtype=torch.float32)
                for k, g in enumerate(gs):
                    acc = g + res[r][k]
                    gs[k] = torch.where(acc >= thr, thr, torch.where(
                        acc <= -thr, -thr, torch.zeros(())))
                    res[r][k] = acc - gs[k]
            if wire is not None:
                gs = [g.to(wire).float() for g in gs]
            per_rank.append(gs)
            loss_sum += float(loss.detach())
        losses.append(loss_sum / n)
        for k, w in enumerate(ws):
            g = sum(pr[k] for pr in per_rank)
            if wire is not None:
                g = g.to(wire).float()
            g = g * (1.0 / n) + wd * w
            m, v = moms[k]
            if opt == "sgd":
                m.mul_(HYPER["sgd"]["momentum"]).sub_(LR * g)
                w.add_(m)
            else:
                m.mul_(0.9).add_(0.1 * g)
                v.mul_(0.999).add_(0.001 * g * g)
                lr_t = LR * np.sqrt(1 - 0.999 ** t) / (1 - 0.9 ** t)
                w.sub_(np.float32(lr_t) * m / (torch.sqrt(v) + 1e-8))
    return np.array(losses), np.concatenate([w.numpy().ravel() for w in ws])


def test_compression_and_grad_dtype(worlds):
    """2-bit compression and a bfloat16 ``grad_dtype`` on the dp mesh of 2
    against ``_plain_dp_reference``: the compressed sums are exact (sums
    of two values of {-t, 0, t}), so the compressed Adam runs agree with
    it to Adam's own rounding (the port's bias correction is double and
    its update multi-tensor: at most 3e-8 apart measured, held to 1e-7
    absolute + 1e-6 relative); the bfloat16 run's SGD agrees bit for bit.
    The bfloat16 sum alone moves the weights by 8e-5 from the float32
    run, and compression by far more, so either fault shows."""
    import torch

    res = _world(worlds, "main")[0]
    for a, b in (("adam_z0_comp", "adam_z2_comp"),
                 ("adam_z0_comp", "adam_z0_staged_comp")):
        np.testing.assert_array_equal(res[f"{a}:losses"],
                                      res[f"{b}:losses"])
        np.testing.assert_array_equal(res[f"{a}:weights"],
                                      res[f"{b}:weights"])
    assert float(res["adam_z0_comp:residual"]) > 0
    losses, weights = _plain_dp_reference("adam", 2, threshold=0.05)
    np.testing.assert_allclose(res["adam_z0_comp:losses"], losses,
                               rtol=1e-6)
    np.testing.assert_allclose(res["adam_z0_comp:weights"], weights,
                               rtol=1e-6, atol=1e-7)
    assert np.abs(res["adam_z0_ready:weights"] - weights).max() > 1e-3
    for run in ("adam_z0_comp", "adam_z0_ready"):
        before, after = res[f"{run}:eval"]
        assert after < before, (run, before, after)
    np.testing.assert_array_equal(res["sgd_z0_fp32:weights"],
                                  res["sgd_z0_ready:weights"])
    losses, weights = _plain_dp_reference("sgd", 2, wire=torch.bfloat16)
    np.testing.assert_allclose(res["sgd_z0_bf16:losses"], losses, rtol=1e-6)
    np.testing.assert_array_equal(res["sgd_z0_bf16:weights"], weights)
    assert np.abs(res["sgd_z0_ready:weights"] - weights).max() > 1e-5


def _card_world(tmp_path, scenario):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = str(tmp_path)
    logs = _finish(_start(scenario, 2, out),
                   time.monotonic() + SPAWN_TIMEOUT_S)
    ranks = []
    for r, (rc, text) in enumerate(logs):
        path = os.path.join(out, f"{scenario}_rank{r}.npz")
        assert rc == 0 and os.path.exists(path), \
            f"rank {r} rc={rc}:\n{text[-3000:]}"
        ranks.append(dict(np.load(path)))
    return ranks


def test_two_rank_gloo_world_on_cuda(tmp_path):
    """Two ranks sharing the card through gloo (``chip_smoke.py``'s
    DIST_BACKEND): the aggregates and the dp-2 SPMD step on CUDA tensors,
    every rank on its card (``mx.gpu(0)``), ZeRO 2/3 and ``barrier``
    equal to stage 0 bit for bit, the replicas equal."""
    import torch

    ranks = _card_world(tmp_path, "cuda")
    want = f"cuda:{0 % torch.cuda.device_count()}"
    assert str(ranks[0]["device"]) == want
    for res in ranks:
        assert int(res["aggregates_ok"]) == 1
    for name, opt, stage, overlap, _ in SPMD4:
        np.testing.assert_array_equal(ranks[0][f"{name}:weights"],
                                      ranks[1][f"{name}:weights"])
        np.testing.assert_array_equal(ranks[0][f"{name}:weights"],
                                      ranks[0][f"{opt}_z0_ready:weights"])


def test_nccl_forms_or_raises_on_cuda(tmp_path):
    """NCCL between two ranks: on a machine with one card it refuses
    ("Duplicate GPU detected") and ``init_distributed`` raises with its
    words, never falling back to gloo; with two cards it forms the group
    and the aggregates hold."""
    import torch

    ranks = _card_world(tmp_path, "nccl")
    if torch.cuda.device_count() == 1:
        for res in ranks:
            msg = str(res["raised"])
            assert "nccl could not form" in msg and "Duplicate GPU" in msg, \
                msg
    else:
        for res in ranks:
            assert int(res["aggregates_ok"]) == 1


if __name__ == "__main__" and len(sys.argv) >= 4 and \
        sys.argv[1] == "--worker":
    worker(sys.argv[2], sys.argv[3])
