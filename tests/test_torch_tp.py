"""Tensor parallelism, sharded checkpoints and the superstep on a mesh:
the port in gloo worlds of 2 (tp 2) and 4 (dp 2 x tp 2) against the JAX
package's GSPMD step on its 8-device virtual CPU mesh.

This file is also the worker: ``python tests/test_torch_tp.py --worker
<scenario> <out_dir>`` under the environment contract of
``tools/launch.py`` joins the world through
``kvstore.init_distributed(backend="gloo")``, runs its scenario and writes
``<scenario>_rank<r>.npz``; it imports neither JAX nor the JAX package
(``tests/test_torch_isolation.py`` runs its import set). A module fixture
starts both worlds at once, each under a hard limit (``SPAWN_TIMEOUT_S``),
and meanwhile computes the JAX package's side in the test process.

- ``SPMDTrainStep(param_sharding=...)``: the reference's tensor-parallel
  MLP (Dense(32, relu, in 16), Dense(8, in 32)) with dense0's weight
  ``P("tp", None)``, ``P(None, "tp")`` and with a sharded bias, SGD lr
  0.1, 3 steps on one (8, 16) batch from numpy seed 0; ``llama_tiny``
  with ``tp_sharding_map()`` on dp 2 x tp 2, Adam lr 1e-3, 3 steps on
  ids (8, 16). Both against the reference's step on dp 4 x tp 2 and the
  port's ``mesh=None``: weights within 1e-5 absolute + 1e-4 relative,
  losses within 1e-4 relative; the replicated norms equal across ranks
  bit for bit; each rank's flash attention runs on its 2 of 4 query
  heads and 1 of 2 kv heads, and refuses a placement it cannot split (a
  sequence shard; split queries beside whole keys). LAMB, whose trust
  ratio needs the whole parameter's norms, at ZeRO 0 and 2 on the split
  MLP, within the same tolerance of both one-device steps.
- ZeRO 1, 2 and 3 under tp: each rank's optimizer-state blocks are the
  reference's ``_opt_state_spec`` layout (its device's indices), and the
  losses and weights equal ZeRO 0's bit for bit.
- Sharded state: the reference's ``test_spmd_sharded_checkpoint_roundtrip``
  on the port (bit for bit after a load, a fresh step resumes within
  1e-6, a missing prefix raises); the reference's shard file from dp 4 x
  tp 2 loads into the port's dp 2 x tp 2 world and the next step matches
  the reference's next step (1e-5 + 1e-4 relative); the port's files of
  4 ranks load into the reference, into a world of 2 (tp 2) and into one
  process bit for bit; a flat dp-4 ZeRO-2 checkpoint round-trips.
- ``save_spmd_checkpoint`` in a world of 2 commits once with both
  shards in its manifest and not a stale one, and ``ResumeReport.elastic``
  is the reference's; ``CheckpointManager`` and ``load_checkpoint(net=,
  trainer=)`` work in a world of 2 (rank 0 commits).
- ``run_superstep`` on dp 2 (ZeRO 0 and 2) and on tp 2 equals three
  single mesh steps bit for bit, and the reference's
  ``run_superstep(mesh=None)`` over the global batches within 1e-5 +
  1e-4 relative; ``DevicePrefetcher(mesh=)`` hands each rank its rows.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import json
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
STEPS = 3
MLP_LR = 0.1
LLAMA_LR = 1e-3
#: the MLP's tensor-parallel cases: dense0's weight split on its output
#: features, on its input features, and with its bias split too
MLP_SPECS = {"col": {"mlp_dense0_weight": ("tp", None)},
             "row": {"mlp_dense0_weight": (None, "tp")},
             "bias": {"mlp_dense0_weight": ("tp", None),
                      "mlp_dense0_bias": ("tp",)}}
ZERO_STAGES = (0, 1, 2, 3)


# ---------------------------------------------------------------------------
# inputs both sides make from numpy seeds
# ---------------------------------------------------------------------------

def mlp_weights():
    """Sorted-name order: dense0 bias, weight, dense1 bias, weight."""
    rs = np.random.RandomState(5)
    return [rs.uniform(-0.3, 0.3, s).astype(np.float32)
            for s in ((32,), (32, 16), (8,), (8, 32))]


def mlp_batch(k=0):
    rs = np.random.RandomState(k)
    return (rs.randn(8, 16).astype(np.float32),
            rs.randint(0, 8, (8,)).astype(np.float32))


def make_mlp(m, ctx=None):
    kw = {} if ctx is None else {"ctx": ctx}
    net = m.gluon.nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(m.gluon.nn.Dense(32, activation="relu", in_units=16),
                m.gluon.nn.Dense(8, in_units=32))
    net.initialize(**kw)
    for (_, p), w in zip(sorted(net.collect_params().items()),
                         mlp_weights()):
        p.set_data(m.nd.array(w, **kw))
    return net


def llama_ids():
    return np.random.RandomState(2).randint(0, 256, (8, 16)).astype(
        np.float32)


def make_llama(m, ctx=None):
    """``llama_tiny`` (2 layers, width 64, 4 heads, 2 kv heads): Normal(0.02)
    weights from a numpy seed, the norms' weights ones."""
    kw = {} if ctx is None else {"ctx": ctx}
    net = m.models.llama_tiny(prefix="llama_")
    net.initialize(**kw)
    net(m.nd.array(llama_ids()[:1], dtype="int32", **kw))
    rs = np.random.RandomState(11)
    for name, p in sorted(net.collect_params().items()):
        if "ln_" in name or "norm_" in name:
            p.set_data(m.nd.ones(p.shape, **kw))
        else:
            p.set_data(m.nd.array(
                rs.normal(0.0, 0.02, p.shape).astype(np.float32), **kw))
    return net


def lm_loss(m):
    ce = m.gluon.loss.SoftmaxCrossEntropyLoss()

    def loss(logits, labels):
        return ce(logits.reshape((-1, logits.shape[-1])),
                  labels.reshape((-1,)))

    return loss


def params_of(net):
    return {n: np.array(p.data().asnumpy())
            for n, p in sorted(net.collect_params().items())}


# ---------------------------------------------------------------------------
# the worker (no JAX here)
# ---------------------------------------------------------------------------

def _spec(mx, spec):
    return mx.parallel.P(*spec)


def _w_mlp_tp(mx, mesh, res, ctx):
    x, y = mlp_batch()
    for case, specs in MLP_SPECS.items():
        net = make_mlp(mx, ctx)
        step = mx.parallel.SPMDTrainStep(
            net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd", {}, mesh,
            param_sharding={n: _spec(mx, s) for n, s in specs.items()})
        losses = [step(mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx),
                       lr=MLP_LR) for _ in range(STEPS)]
        step.sync_to_block()
        res[f"mlp_{case}:losses"] = np.array(losses)
        for n, v in params_of(net).items():
            res[f"mlp_{case}:{n}"] = v


def _w_release(mx, mesh, res, ctx):
    """While the tensor-parallel step holds its blocks, the block's whole
    tensors and gradient buffers hold no storage: reading or writing them
    refuses, ``sync_to_block`` brings values and buffers back, the next
    step releases them again and trains on as ``_w_mlp_tp``'s, and
    ``init_state`` starts again from the values the step holds."""
    from mxnet_tpu_torch.base import MXNetError

    x, y = mlp_batch()
    xy = (mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx))
    net = make_mlp(mx, ctx)
    step = mx.parallel.SPMDTrainStep(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd", {}, mesh,
        param_sharding={n: _spec(mx, s)
                        for n, s in MLP_SPECS["col"].items()})
    step(*xy, lr=MLP_LR)
    res["release:held"] = np.array(
        step.zero_memory_report()["block_bytes_per_device"])
    w = net.collect_params()["mlp_dense0_weight"]
    refused = []
    for use in (lambda: w.data().asnumpy(),
                lambda: w.set_data(np.zeros(w.shape, np.float32))):
        try:
            use()
            refused.append(False)
        except MXNetError:
            refused.append(True)
    res["release:refused"] = np.array(refused)
    step.sync_to_block()
    res["release:synced"] = np.array(
        step.zero_memory_report()["block_bytes_per_device"])
    res["release:grad_shape"] = np.array(w.grad().shape)
    for _ in range(STEPS - 1):
        step(*xy, lr=MLP_LR)
    res["release:again"] = np.array(
        step.zero_memory_report()["block_bytes_per_device"])
    step.init_state()  # from the values the step holds, not the released
    step.sync_to_block()
    for n, v in params_of(net).items():
        res[f"release:{n}"] = v


def _w_mlp_lamb(mx, mesh, res, ctx):
    """LAMB under tp, whose trust ratio takes the whole parameter's norms
    (summed over the axes that split a block), at ZeRO 0 and 2."""
    x, y = mlp_batch()
    for stage in (0, 2):
        net = make_mlp(mx, ctx)
        step = mx.parallel.SPMDTrainStep(
            net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "lamb", {}, mesh,
            param_sharding={n: _spec(mx, s)
                            for n, s in MLP_SPECS["bias"].items()},
            zero_stage=stage)
        res[f"lamb_z{stage}:losses"] = np.array(
            [step(mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx), lr=0.01)
             for _ in range(STEPS)])
        step.sync_to_block()
        for n, v in params_of(net).items():
            res[f"lamb_z{stage}:{n}"] = v


def _llama_step(mx, mesh, ctx, stage, net=None):
    net = net or make_llama(mx, ctx)
    return net, mx.parallel.SPMDTrainStep(
        net, lm_loss(mx), "adam", {}, mesh,
        param_sharding=net.tp_sharding_map(), zero_stage=stage)


def _llama_xy(mx, ctx):
    ids = llama_ids()
    return (mx.nd.array(ids, dtype="int32", ctx=ctx),
            mx.nd.array(np.roll(ids, -1, 1), ctx=ctx))


def _head_counts(mx):
    """Record the (query heads, kv heads) of every flash forward."""
    from mxnet_tpu_torch.ops import flash_attention as fa

    seen = []
    fwd = fa._FlashAttention.forward

    def spy(ctx, q, k, v, *args):
        seen.append((int(q.shape[1]), int(k.shape[1])))
        return fwd(ctx, q, k, v, *args)

    fa._FlashAttention.forward = staticmethod(spy)
    return seen


def _w_llama_tp(mx, mesh, res, ctx):
    x, y = _llama_xy(mx, ctx)
    heads = _head_counts(mx)
    stepped = set()
    for stage in ZERO_STAGES:
        net, step = _llama_step(mx, mesh, ctx, stage)
        step.init_state()
        mark = len(heads)
        losses = [step(x, y, lr=LLAMA_LR) for _ in range(STEPS)]
        stepped.update(heads[mark:])
        step.sync_to_block()
        res[f"llama_z{stage}:losses"] = np.array(losses)
        for n, v in params_of(net).items():
            res[f"llama_z{stage}:{n}"] = v
        spans = {}
        for i, n in enumerate(step._names):
            shape = tuple(step._handles[i].data.shape)
            for li, sp in enumerate(step._opt_specs[i]):
                if sp:
                    spans[f"{n}::{li}"] = [list(s) for s in
                                           step._spans(shape, sp)]
        res[f"llama_z{stage}:opt_spans"] = np.array(json.dumps(spans))
        res[f"llama_z{stage}:memory"] = np.array(
            json.dumps(step.zero_memory_report()))
    res["llama:heads"] = np.array(sorted(stepped))


def _local_state(step):
    params, opt = step._state
    return [p.detach().clone() for p in params] + \
        [leaf.detach().clone() for st in opt for leaf in st]


def _w_ckpt_roundtrip(mx, mesh, res, ctx, out_dir):
    """The reference's ``test_spmd_sharded_checkpoint_roundtrip`` on the
    port, on Llama at ZeRO 2; the files go to the parent and the world
    of 2."""
    import torch
    import torch.distributed as dist

    x, y = _llama_xy(mx, ctx)
    net, step = _llama_step(mx, mesh, ctx, 2)
    step(x, y, lr=LLAMA_LR)
    prefix = os.path.join(out_dir, "port4")
    fname = step.save_states(prefix)
    dist.barrier()  # every rank's file is written
    res["ckpt:fname"] = np.array(os.path.basename(fname))
    saved = _local_state(step)
    step.sync_to_block()
    for n, v in params_of(net).items():
        res[f"ckpt_saved:{n}"] = v
    for _ in range(3):
        step(x, y, lr=LLAMA_LR)
    moved = any(not torch.equal(a, b) for a, b in
                zip(saved, _local_state(step)))
    step.load_states(prefix)
    res["ckpt:moved"] = np.array(moved)
    res["ckpt:bitexact"] = np.array(all(
        torch.equal(a, b) for a, b in zip(saved, _local_state(step))))
    res["ckpt:handles"] = np.array(all(
        np.array_equal(res[f"ckpt_saved:{n}"], v)
        for n, v in params_of(net).items()))
    l1 = step(x, y, lr=LLAMA_LR)
    _, step2 = _llama_step(mx, mesh, ctx, 2, net=make_llama(mx, ctx))
    step2.init_state()
    step2.load_states(prefix)
    l2 = step2(x, y, lr=LLAMA_LR)
    res["ckpt:resume"] = np.array([l1, l2])
    try:
        step2.load_states(os.path.join(out_dir, "nope"))
        res["ckpt:missing_raises"] = np.array(False)
    except mx.MXNetError:
        res["ckpt:missing_raises"] = np.array(True)


def _wait_for(path, limit=100):
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > limit:
            raise TimeoutError(f"{path} did not appear in {limit} s")
        time.sleep(0.1)


def _w_load_reference(mx, mesh, res, ctx, out_dir):
    """The reference's dp 4 x tp 2 shard file into dp 2 x tp 2 at ZeRO 2
    (another optimizer-state layout than the saved one), then one step."""
    _wait_for(os.path.join(out_dir, "ref8.ready"))
    x, y = _llama_xy(mx, ctx)
    net, step = _llama_step(mx, mesh, ctx, 2)
    step.init_state()
    step.load_states(os.path.join(out_dir, "ref8"))
    res["fromref:loss"] = np.array(step(x, y, lr=LLAMA_LR))
    step.sync_to_block()
    for n, v in params_of(net).items():
        res[f"fromref:{n}"] = v


def _w_flat_zero2(mx, res, ctx, out_dir):
    """A flat dp-4 ZeRO-2 checkpoint (the data-parallel layouts) round
    trip: save after one Adam step, load into a fresh step."""
    import torch
    import torch.distributed as dist

    dp4 = mx.parallel.make_mesh({"dp": 4})
    x, y = mlp_batch()
    mk = lambda: mx.parallel.SPMDTrainStep(  # noqa: E731
        make_mlp(mx, ctx), mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
        {}, dp4, zero_stage=2)
    step = mk()
    step(mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx), lr=0.01)
    step.save_states(os.path.join(out_dir, "flat4"))
    dist.barrier()  # every rank's file is written
    fresh = mk()
    fresh.init_state()
    fresh.load_states(os.path.join(out_dir, "flat4"))
    res["flat4:bitexact"] = np.array(all(
        torch.equal(a, b) for a, b in
        zip(_local_state(step), _local_state(fresh))))
    step.sync_to_block()
    for n, v in params_of(step.block).items():
        res[f"flat4:{n}"] = v


def _w_superstep(mx, mesh, res, ctx, tag, stage, specs=None):
    """``run_superstep`` over three stacked global batches against three
    single mesh steps (each on a net from the same weights)."""
    xs, ys = zip(*[mlp_batch(k) for k in range(3)])
    kw = dict(zero_stage=stage)
    if specs:
        kw["param_sharding"] = {n: _spec(mx, s) for n, s in specs.items()}
    nets = [make_mlp(mx, ctx) for _ in range(2)]
    steps = [mx.parallel.SPMDTrainStep(
        n, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam", {}, mesh, **kw)
        for n in nets]
    sup = steps[0].run_superstep(mx.nd.array(np.stack(xs), ctx=ctx),
                                 mx.nd.array(np.stack(ys), ctx=ctx),
                                 lr=0.01)
    single = [steps[1](mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx),
                       lr=0.01) for x, y in zip(xs, ys)]
    for s in steps:
        s.sync_to_block()
    res[f"super_{tag}:losses"] = np.array(sup.detach().cpu().numpy())
    res[f"super_{tag}:single"] = np.array(single, dtype=np.float32)
    a, b = params_of(nets[0]), params_of(nets[1])
    res[f"super_{tag}:equal"] = np.array(
        all(np.array_equal(a[n], b[n]) for n in a))
    for n, v in a.items():
        res[f"super_{tag}:{n}"] = v


def _w_flash_refuses(mx, mesh, res):
    """``flash_attention`` on DTensors it cannot split raises, naming the
    op and the placement: a shard of the sequence, and a query split on
    its heads beside whole keys."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard

    dm = mesh.device_mesh(("tp",), "cpu")
    cases = {"sequence": (Shard(2), Shard(2)), "mixed": (Shard(1),
                                                         Replicate())}
    for name, (qp, kp) in cases.items():
        q, k = (DTensor.from_local(torch.zeros((1, 2, 8, 16)), dm, [pl],
                                   run_check=False) for pl in (qp, kp))
        try:
            mx.nd.flash_attention(mx.nd.NDArray(q), mx.nd.NDArray(k),
                                  mx.nd.NDArray(k))
            res[f"refuse:{name}"] = np.array("")
        except ValueError as e:
            res[f"refuse:{name}"] = np.array(str(e))


def _w_prefetcher(mx, mesh, res, ctx):
    from mxnet_tpu_torch.gluon.data.prefetcher import DevicePrefetcher

    batches = [np.arange(24, dtype=np.float32).reshape(4, 6) + 100 * k
               for k in range(3)]
    with ctx:
        got = [b.asnumpy() for b in DevicePrefetcher(batches, mesh=mesh)]
    res["prefetch:rows"] = np.stack(got)


def _w_save_spmd_checkpoint(mx, mesh, res, ctx, out_dir, rank):
    from mxnet_tpu_torch import resilience

    root = os.path.join(out_dir, "spmdck")
    x, y = mlp_batch()
    step = mx.parallel.SPMDTrainStep(
        make_mlp(mx, ctx), mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
        {}, mesh, zero_stage=2)
    step(mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx), lr=0.01)
    if rank == 0:
        # a crashed, differently sized earlier run of the same step left
        # its third rank's shard in the staging directory
        from mxnet_tpu_torch.resilience.checkpoint import _step_dirname

        stale = os.path.join(root, f".shards-{_step_dirname(1)}")
        os.makedirs(stale, exist_ok=True)
        np.savez(os.path.join(stale, "spmd.shard2.npz"), junk=np.zeros(3))
    t0 = time.monotonic()
    path = resilience.save_spmd_checkpoint(root, step, 1)
    res["save:seconds"] = np.array(time.monotonic() - t0)
    res["save:path"] = np.array(str(path))
    fresh = mx.parallel.SPMDTrainStep(
        make_mlp(mx, ctx), mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
        {}, mesh, zero_stage=2)
    rep = resilience.load_checkpoint(root, spmd_step=fresh)
    res["save:elastic"] = np.array(rep.elastic)
    res["save:same"] = np.array(all(
        np.array_equal(a.cpu().numpy(), b.cpu().numpy())
        for a, b in zip(_local_state(step), _local_state(fresh))))
    step.sync_to_block()
    for n, v in params_of(step.block).items():
        res[f"save:{n}"] = v


def _w_manager(mx, res, ctx, out_dir, rank):
    """``CheckpointManager`` + ``load_checkpoint(net=, trainer=)`` in a
    world of 2: every rank trains the same replicated net."""
    import torch.distributed as dist

    from mxnet_tpu_torch import autograd, resilience

    root = os.path.join(out_dir, "mgr")
    net = make_mlp(mx, ctx)
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1})
    mgr = resilience.CheckpointManager(root, 1, net=net, trainer=tr,
                                       install_sigterm=False).attach()
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    x, y = mlp_batch()
    for _ in range(2):
        with autograd.record():
            loss = loss_fn(net(mx.nd.array(x, ctx=ctx)),
                           mx.nd.array(y, ctx=ctx))
        loss.backward()
        tr.step(8)
    mgr.flush()
    want = params_of(net)
    dist.barrier()
    res["mgr:commits"] = np.array(mgr.commits)
    for _, p in net.collect_params().items():
        p.set_data(p.data() * 0)
    rep = resilience.load_checkpoint(root, net=net, trainer=tr)
    res["mgr:restored"] = np.array(all(
        np.array_equal(v, params_of(net)[n]) for n, v in want.items()))
    res["mgr:step"] = np.array(rep.step)
    with open(os.path.join(rep.path, "MANIFEST.json")) as f:
        res["mgr:process_count"] = np.array(
            json.load(f)["world"]["process_count"])
    mgr.close()


def _w_from_port4(mx, mesh, res, ctx, out_dir):
    """The dp 2 x tp 2 world's files, restored into this world's tp 2."""
    _wait_for(os.path.join(out_dir, "port4.ready"))
    net, step = _llama_step(mx, mesh, ctx, 0)
    step.init_state()
    step.load_states(os.path.join(out_dir, "port4"))
    for n, v in params_of(net).items():
        res[f"from4:{n}"] = v


def _w_card(mx, rank, res, out_dir):
    """``llama_tiny`` tensor-parallel over two ranks sharing the card:
    K1 and K6 launched on each rank's heads; the shard files round
    trip."""
    import torch

    from mxnet_tpu_torch.ops import _kernels

    os.environ["MXTPU_FLASH_BWD"] = "fused"
    ctx = mx.gpu(0)
    mesh = mx.parallel.make_mesh({"tp": 2})
    x, y = _llama_xy(mx, ctx)
    net, step = _llama_step(mx, mesh, ctx, 0)
    step.init_state()
    before = dict(_kernels.LAUNCHES)
    heads = _head_counts(mx)
    losses = [step(x, y, lr=LLAMA_LR) for _ in range(STEPS)]
    torch.cuda.synchronize()
    res["card:launches"] = np.array(json.dumps({
        k: v - before.get(k, 0) for k, v in _kernels.LAUNCHES.items()}))
    res["card:heads"] = np.array(sorted(set(heads)))
    res["card:losses"] = np.array(losses)
    step.save_states(os.path.join(out_dir, "card"))
    torch.distributed.barrier()  # every rank's file is written
    saved = _local_state(step)
    step(x, y, lr=LLAMA_LR)
    step.load_states(os.path.join(out_dir, "card"))
    res["card:bitexact"] = np.array(all(
        torch.equal(a, b) for a, b in zip(saved, _local_state(step))))
    res["device"] = np.array(str(step._state[0][0].device))


def worker(scenario, out_dir):
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    import mxnet_tpu_torch as mx

    if scenario == "imports":
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"))
        print(bad)
        sys.exit(1 if bad else 0)
    rank = int(os.environ["MXTPU_PROCESS_ID"])
    res = {}
    assert mx.kv.init_distributed(backend="gloo", timeout=60) == "gloo"
    if scenario == "cuda":
        _w_card(mx, rank, res, out_dir)
    elif scenario == "dptp4":
        ctx = mx.cpu()
        mesh = mx.parallel.make_mesh({"dp": 2, "tp": 2})
        _w_mlp_tp(mx, mesh, res, ctx)
        _w_mlp_lamb(mx, mesh, res, ctx)
        _w_llama_tp(mx, mesh, res, ctx)
        _w_ckpt_roundtrip(mx, mesh, res, ctx, out_dir)
        if rank == 0:
            open(os.path.join(out_dir, "port4.ready"), "w").close()
        _w_flat_zero2(mx, res, ctx, out_dir)
        _w_load_reference(mx, mesh, res, ctx, out_dir)
    else:  # tp2
        ctx = mx.cpu()
        tp = mx.parallel.make_mesh({"tp": 2})
        dp = mx.parallel.make_mesh({"dp": 2})
        _w_mlp_tp(mx, tp, res, ctx)
        _w_release(mx, tp, res, ctx)
        for stage in (0, 2):
            _w_superstep(mx, dp, res, ctx, f"dp_z{stage}", stage)
        _w_superstep(mx, tp, res, ctx, "tp", 0, MLP_SPECS["col"])
        _w_prefetcher(mx, dp, res, ctx)
        _w_flash_refuses(mx, tp, res)
        _w_save_spmd_checkpoint(mx, dp, res, ctx, out_dir, rank)
        _w_manager(mx, res, ctx, out_dir, rank)
        _w_from_port4(mx, tp, res, ctx, out_dir)
    np.savez(os.path.join(out_dir, f"{scenario}_rank{rank}.npz"), **res)
    mx.kv.shutdown_distributed()


# ---------------------------------------------------------------------------
# the test side
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(scenario, n, out_dir):
    port = _free_port()
    procs = []
    for r in range(n):
        env = dict(os.environ, MXTPU_COORDINATOR=f"127.0.0.1:{port}",
                   MXTPU_NUM_PROCESSES=str(n), MXTPU_PROCESS_ID=str(r),
                   OMP_NUM_THREADS="1")
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


def _jax_llama_step(jmx, mesh, stage=0, ctx=None):
    net = make_llama(jmx, ctx)
    spec = net.tp_sharding_map() if mesh is not None else None
    return net, jmx.parallel.SPMDTrainStep(
        net, lm_loss(jmx), "adam", {}, mesh=mesh, param_sharding=spec,
        zero_stage=stage)


def _jax_llama_xy(jmx):
    ids = llama_ids()
    return jmx.nd.array(ids), jmx.nd.array(np.roll(ids, -1, 1))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds, started at once; meanwhile the reference's shard file
    the dp 2 x tp 2 world restores, and the reference's step after it."""
    import jax  # noqa: F401
    import mxnet_tpu as jmx

    out_dir = str(tmp_path_factory.mktemp("tp"))
    plan = {"tp2": 2, "dptp4": 4}
    started = {s: _start(s, n, out_dir) for s, n in plan.items()}
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        mesh = jmx.parallel.make_mesh({"dp": 4, "tp": 2})
        _, step = _jax_llama_step(jmx, mesh)
        x, y = _jax_llama_xy(jmx)
        step(x, y, lr=LLAMA_LR)
        step.save_states(os.path.join(out_dir, "ref8"))
        after = {"loss": step(x, y, lr=LLAMA_LR)}
        step.sync_to_block()
        after["params"] = params_of(step.block)
    finally:
        open(os.path.join(out_dir, "ref8.ready"), "w").close()
    done = {s: _finish(procs, deadline) for s, procs in started.items()}
    results = {}
    for s, n in plan.items():
        ranks = []
        for r in range(n):
            path = os.path.join(out_dir, f"{s}_rank{r}.npz")
            ranks.append(dict(np.load(path)) if os.path.exists(path)
                         else None)
        results[s] = (done[s], ranks)
    return {"results": results, "dir": out_dir, "ref8_next": after}


def _world(worlds, scenario):
    logs, ranks = worlds["results"][scenario]
    bad = [f"{scenario} rank {r} rc={rc}:\n{text[-3000:]}"
           for r, (rc, text) in enumerate(logs)
           if rc != 0 or ranks[r] is None]
    assert not bad, "\n".join(bad)
    return ranks


def _close(got, want, rtol=1e-4, atol=1e-5, what=""):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.fixture(scope="module")
def mlp_references():
    """The reference's GSPMD step on dp 4 x tp 2 and the port's
    ``mesh=None`` step, for each MLP spec case."""
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as tmx
    from jax.sharding import PartitionSpec as JP

    x, y = mlp_batch()
    out = {}
    mesh = jmx.parallel.make_mesh({"dp": 4, "tp": 2})
    for case, specs in MLP_SPECS.items():
        net = make_mlp(jmx)
        step = jmx.parallel.SPMDTrainStep(
            net, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd", {}, mesh,
            param_sharding={n: JP(*s) for n, s in specs.items()})
        losses = [step(jmx.nd.array(x), jmx.nd.array(y), lr=MLP_LR)
                  for _ in range(STEPS)]
        step.sync_to_block()
        out[("jax", case)] = (np.array(losses), params_of(net))
    net = make_mlp(tmx, tmx.cpu())
    step = tmx.parallel.SPMDTrainStep(
        net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd", {}, None)
    losses = [step(tmx.nd.array(x, ctx=tmx.cpu()),
                   tmx.nd.array(y, ctx=tmx.cpu()), lr=MLP_LR)
              for _ in range(STEPS)]
    step.sync_to_block()
    out["none"] = (np.array(losses), params_of(net))
    return out


@pytest.mark.parametrize("world", ["tp2", "dptp4"])
@pytest.mark.parametrize("case", list(MLP_SPECS))
def test_mlp_param_sharding_matches_gspmd(worlds, mlp_references, world,
                                          case):
    ranks = _world(worlds, world)
    for ref in (mlp_references[("jax", case)], mlp_references["none"]):
        losses, params = ref
        for res in ranks:
            _close(res[f"mlp_{case}:losses"], losses, rtol=1e-4, atol=0,
                   what="losses")
            for n, v in params.items():
                _close(res[f"mlp_{case}:{n}"], v, what=n)


def test_block_released_while_the_tp_step_holds_it(worlds):
    whole = 4 * sum(w.size for w in mlp_weights())  # float32
    for res in _world(worlds, "tp2"):
        assert int(res["release:held"]) == 0
        assert list(res["release:refused"]) == [True, True]
        # the values and the gradient buffers, whole again
        assert int(res["release:synced"]) == 2 * whole
        assert tuple(res["release:grad_shape"]) == (32, 16)
        assert int(res["release:again"]) == 0
        for n in ("mlp_dense0_bias", "mlp_dense0_weight", "mlp_dense1_bias",
                  "mlp_dense1_weight"):
            np.testing.assert_array_equal(res[f"release:{n}"],
                                          res[f"mlp_col:{n}"], n)


@pytest.mark.parametrize("stage", [0, 2])
def test_lamb_under_tp_matches_one_process(worlds, stage):
    """LAMB's trust ratio on a split weight and bias (dp 2 x tp 2) against
    the port's and the reference's one-device step."""
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as tmx

    x, y = mlp_batch()
    refs = []
    for m, kw in ((tmx, {"ctx": tmx.cpu()}), (jmx, {})):
        net = make_mlp(m, kw.get("ctx"))
        step = m.parallel.SPMDTrainStep(
            net, m.gluon.loss.SoftmaxCrossEntropyLoss(), "lamb", {}, None)
        losses = [step(m.nd.array(x, **kw), m.nd.array(y, **kw), lr=0.01)
                  for _ in range(STEPS)]
        step.sync_to_block()
        refs.append((np.array(losses), params_of(net)))
    for res in _world(worlds, "dptp4"):
        for losses, params in refs:
            _close(res[f"lamb_z{stage}:losses"], losses, rtol=1e-4, atol=0)
            for n, v in params.items():
                _close(res[f"lamb_z{stage}:{n}"], v, what=n)


@pytest.fixture(scope="module")
def llama_references():
    """The reference's ``test_llama_tp_dp_mesh`` setup (dp 4 x tp 2, the
    ``jit`` path) and the port's ``mesh=None`` step, 3 Adam steps."""
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as tmx

    out = {}
    net, step = _jax_llama_step(jmx, jmx.parallel.make_mesh(
        {"dp": 4, "tp": 2}))
    x, y = _jax_llama_xy(jmx)
    losses = [step(x, y, lr=LLAMA_LR) for _ in range(STEPS)]
    step.sync_to_block()
    out["jax"] = (np.array(losses), params_of(net))
    out["jax_step"] = step
    net = make_llama(tmx, tmx.cpu())
    step = tmx.parallel.SPMDTrainStep(net, lm_loss(tmx), "adam", {}, None)
    x, y = _llama_xy(tmx, tmx.cpu())
    losses = [step(x, y, lr=LLAMA_LR) for _ in range(STEPS)]
    step.sync_to_block()
    out["none"] = (np.array(losses), params_of(net))
    return out


def test_llama_tp_dp_matches_gspmd_and_one_process(worlds,
                                                   llama_references):
    ranks = _world(worlds, "dptp4")
    for which in ("jax", "none"):
        losses, params = llama_references[which]
        for res in ranks:
            _close(res["llama_z0:losses"], losses, rtol=1e-4, atol=0,
                   what=f"{which} losses")
            for n, v in params.items():
                _close(res[f"llama_z0:{n}"], v, what=f"{which} {n}")
    for res in ranks[1:]:
        for n in llama_references["none"][1]:
            if "ln_" in n or "norm_" in n:
                np.testing.assert_array_equal(res[f"llama_z0:{n}"],
                                              ranks[0][f"llama_z0:{n}"], n)
    # each rank's attention ran on its 2 of 4 query and 1 of 2 kv heads
    for res in ranks:
        assert res["llama:heads"].tolist() == [[2, 1]], res["llama:heads"]


def test_tp_sharding_map_equals_reference():
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as tmx

    for name, kw in (("llama_tiny", {}), ("llama3_8b", {"num_layers": 1})):
        jspecs = getattr(jmx.models, name)(prefix="m_", **kw) \
            .tp_sharding_map()
        tspecs = getattr(tmx.models, name)(prefix="m_", **kw) \
            .tp_sharding_map()
        assert sorted(jspecs) == sorted(tspecs) and jspecs
        for n in jspecs:
            assert tuple(tspecs[n]) == tuple(jspecs[n]), n
            assert isinstance(tspecs[n], tmx.parallel.PartitionSpec)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_zero_under_tp_layout_and_bits(worlds, llama_references, stage):
    """Each rank's optimizer-state blocks are the reference's
    ``_opt_state_spec`` layout at its device; every stage gives ZeRO 0's
    numbers bit for bit."""
    import jax
    import mxnet_tpu as jmx
    from jax.sharding import NamedSharding

    ranks = _world(worlds, "dptp4")
    mesh = jmx.parallel.make_mesh({"dp": 2, "tp": 2},
                                  devices=jax.devices()[:4])
    net = make_llama(jmx)
    step = jmx.parallel.SPMDTrainStep(
        net, lm_loss(jmx), "adam", {}, mesh=mesh,
        param_sharding=net.tp_sharding_map(), zero_stage=stage)
    step._mode = step._mesh_mode()
    for r, res in enumerate(ranks):
        got = json.loads(str(res[f"llama_z{stage}:opt_spans"]))
        for n, p in sorted(net.collect_params().items()):
            spec = step._opt_state_spec(n, p.data().data)
            idx = NamedSharding(mesh, spec).devices_indices_map(
                tuple(p.shape))[mesh.devices.flat[r]]
            want = [[0 if s.start is None else s.start,
                     d if s.stop is None else s.stop]
                    for s, d in zip(idx, p.shape)]
            assert got[f"{n}::0"] == want, (r, n)
            assert got[f"{n}::1"] == want, (r, n)
        for key, v in res.items():
            if key.startswith("llama_z0:") and key != "llama_z0:opt_spans" \
                    and key != "llama_z0:memory":
                np.testing.assert_array_equal(
                    res[key.replace("z0", f"z{stage}")], v, key)
    mem = json.loads(str(ranks[0][f"llama_z{stage}:memory"]))
    full = json.loads(str(ranks[0]["llama_z0:memory"]))
    # dp 2 halves every moment but the vocab-split head's (128 rows % 2)
    assert mem["opt_bytes_per_device"] < 0.55 * full["opt_bytes_per_device"]


def test_sharded_checkpoint_roundtrip(worlds):
    for res in _world(worlds, "dptp4"):
        assert str(res["ckpt:fname"]).endswith(".npz")
        assert bool(res["ckpt:moved"])
        assert bool(res["ckpt:bitexact"]) and bool(res["ckpt:handles"])
        l1, l2 = res["ckpt:resume"]
        assert abs(l1 - l2) < 1e-6
        assert bool(res["ckpt:missing_raises"])


def test_reference_shard_file_loads_into_port_world(worlds):
    """The reference's one file (dp 4 x tp 2, ZeRO 0) restored onto the
    port's dp 2 x tp 2 at ZeRO 2, and the next step."""
    want = worlds["ref8_next"]
    for res in _world(worlds, "dptp4"):
        _close(res["fromref:loss"], want["loss"], rtol=1e-4, atol=0)
        for n, v in want["params"].items():
            _close(res[f"fromref:{n}"], v, what=n)


def test_port_shard_files_load_everywhere(worlds):
    """The four ranks' files: into the reference's dp 4 x tp 2 and
    one-device steps exactly, into the world of 2 (tp 2) and into one
    port process bit for bit."""
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as tmx

    four = _world(worlds, "dptp4")
    two = _world(worlds, "tp2")
    saved = {k.split(":", 1)[1]: v for k, v in four[0].items()
             if k.startswith("ckpt_saved:")}
    prefix = os.path.join(worlds["dir"], "port4")
    assert sorted(f for f in os.listdir(worlds["dir"])
                  if f.startswith("port4.shard")) == \
        [f"port4.shard{r}.npz" for r in range(4)]
    for res in two:
        for n, v in saved.items():
            np.testing.assert_array_equal(res[f"from4:{n}"], v, n)
    net, step = _jax_llama_step(tmx, None, ctx=tmx.cpu())
    step.init_state()
    step.load_states(prefix)
    for n, v in params_of(net).items():
        np.testing.assert_array_equal(v, saved[n], n)
    for mesh in (jmx.parallel.make_mesh({"dp": 4, "tp": 2}), None):
        net, step = _jax_llama_step(jmx, mesh, stage=2)
        step.init_state()
        step.load_states(prefix)
        for n, v in params_of(net).items():
            np.testing.assert_array_equal(v, saved[n], n)


def test_flat_zero2_checkpoint_roundtrip(worlds):
    import mxnet_tpu_torch as tmx

    ranks = _world(worlds, "dptp4")
    for res in ranks:
        assert bool(res["flat4:bitexact"])
    step = tmx.parallel.SPMDTrainStep(
        make_mlp(tmx, tmx.cpu()), tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
        "adam", {}, None)
    step.init_state()
    step.load_states(os.path.join(worlds["dir"], "flat4"))
    for n, v in params_of(step.block).items():
        np.testing.assert_array_equal(v, ranks[0][f"flat4:{n}"], n)


def test_save_spmd_checkpoint_in_a_world(worlds):
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as tmx

    ranks = _world(worlds, "tp2")
    path = str(ranks[0]["save:path"])
    assert os.path.isdir(path) and str(ranks[1]["save:path"]) == "None"
    root = os.path.dirname(path)
    assert [d for d in os.listdir(root) if d.startswith("step_")] == \
        [os.path.basename(path)]
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)
    assert sorted(manifest["files"]) == ["spmd.shard0.npz",
                                         "spmd.shard1.npz"]
    assert manifest["world"]["process_count"] == 2
    for res in ranks:
        assert not bool(res["save:elastic"]) and bool(res["save:same"])
    # 2 -> 1: elastic in both packages, the same weights
    step = tmx.parallel.SPMDTrainStep(
        make_mlp(tmx, tmx.cpu()), tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
        "adam", {}, None)
    rep = tmx.resilience.load_checkpoint(root, spmd_step=step)
    jstep = jmx.parallel.SPMDTrainStep(
        make_mlp(jmx), jmx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam", {},
        None)
    jrep = jmx.resilience.load_checkpoint(root, spmd_step=jstep)
    assert rep.elastic == jrep.elastic is True
    for n, v in params_of(step.block).items():
        np.testing.assert_array_equal(v, ranks[0][f"save:{n}"], n)
        np.testing.assert_array_equal(params_of(jstep.block)[n], v, n)


def test_checkpoint_manager_and_load_in_a_world(worlds):
    ranks = _world(worlds, "tp2")
    # every step is an interval boundary; a snapshot still queued when the
    # next comes is replaced (latest wins), so rank 0 commits 1 or 2 times
    assert int(ranks[0]["mgr:commits"]) in (1, 2)
    assert int(ranks[1]["mgr:commits"]) == 0
    for res in ranks:
        assert bool(res["mgr:restored"]) and int(res["mgr:step"]) == 2
        assert int(res["mgr:process_count"]) == 2


@pytest.fixture(scope="module")
def superstep_reference():
    """The reference's ``run_superstep(mesh=None)`` over the three global
    batches."""
    import mxnet_tpu as jmx

    xs, ys = zip(*[mlp_batch(k) for k in range(3)])
    net = make_mlp(jmx)
    step = jmx.parallel.SPMDTrainStep(
        net, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam", {}, None)
    losses = np.array(step.run_superstep(jmx.nd.array(np.stack(xs)),
                                         jmx.nd.array(np.stack(ys)),
                                         lr=0.01))
    step.sync_to_block()
    return losses, params_of(net)


@pytest.mark.parametrize("tag", ["dp_z0", "dp_z2", "tp"])
def test_run_superstep_on_a_mesh(worlds, superstep_reference, tag):
    losses, params = superstep_reference
    for res in _world(worlds, "tp2"):
        np.testing.assert_array_equal(res[f"super_{tag}:losses"],
                                      res[f"super_{tag}:single"])
        assert bool(res[f"super_{tag}:equal"])
        _close(res[f"super_{tag}:losses"], losses, what="losses")
        for n, v in params.items():
            _close(res[f"super_{tag}:{n}"], v, what=n)


def test_flash_attention_refuses_what_it_cannot_split(worlds):
    for res in _world(worlds, "tp2"):
        for name in ("sequence", "mixed"):
            msg = str(res[f"refuse:{name}"])
            assert "flash_attention" in msg and "placement" in msg, msg


def test_prefetcher_stages_each_ranks_rows(worlds):
    for r, res in enumerate(_world(worlds, "tp2")):
        want = np.stack([np.arange(24, dtype=np.float32).reshape(4, 6)
                         [2 * r:2 * r + 2] + 100 * k for k in range(3)])
        np.testing.assert_array_equal(res["prefetch:rows"], want)


def test_llama_tp_world_on_cuda(tmp_path):
    """Two ranks sharing the card through gloo: ``llama_tiny``
    tensor-parallel, each rank's K1 and K6 on its 2 query and 1 kv heads
    (``MXTPU_FLASH_BWD=fused``), K2 never; the losses finite; the shard
    files round trip bit for bit."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = str(tmp_path)
    logs = _finish(_start("cuda", 2, out),
                   time.monotonic() + SPAWN_TIMEOUT_S)
    for r, (rc, text) in enumerate(logs):
        path = os.path.join(out, f"cuda_rank{r}.npz")
        assert rc == 0 and os.path.exists(path), \
            f"rank {r} rc={rc}:\n{text[-3000:]}"
        res = dict(np.load(path))
        launches = json.loads(str(res["card:launches"]))
        assert launches.get("flash_fwd", 0) >= STEPS * 2
        assert launches.get("flash_bwd_fused", 0) >= STEPS * 2
        assert launches.get("flash_bwd_dq", 0) == 0
        assert res["card:heads"].tolist() == [[2, 1]]
        assert np.isfinite(res["card:losses"]).all()
        assert bool(res["card:bitexact"])
        assert str(res["device"]).startswith("cuda")


if __name__ == "__main__" and len(sys.argv) >= 4 and \
        sys.argv[1] == "--worker":
    worker(sys.argv[2], sys.argv[3])
