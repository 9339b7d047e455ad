"""Port parity: ``mx.parallel``'s mesh and bucket arithmetic against the
JAX package's (``parallel/mesh.py``, ``parallel/overlap.py``).

- ``make_mesh``/``composed_mesh``/``axis_size``/``validate_mesh_axes`` on
  the same sizes: the same axis names, sizes and grid shape (the JAX
  package's grid holds devices, the port's holds ranks; a world of one
  may name any grid, which is arithmetic until it is used).
- ``build_bucket_plan``: the same buckets, order, sizes and padding for
  the same shapes, dtypes, order and target bytes.
- ``first_use_order``: the same readiness order, on the reference's own
  three-product function and on the gradients of a two-layer MLP and a
  two-layer, narrow BERT (the JAX package traces its jaxpr, the port
  watches the torch calls of one forward). Under jax 0.9 the JAX
  package's ``first_use_order`` finds no ``jax.core.Var`` and returns
  None (its reversed-order fallback); the ``jax_var`` fixture gives it
  ``jax.extend.core.Var`` under that name, so it computes what it was
  written to.
- ``shard_batch`` gives rank r rows ``[r*B/dp, (r+1)*B/dp)``; a world of
  one is rank 0 of 1, and its data-parallel mesh has ``dp=1``.
- the ``fusedstep`` knobs read by these paths and by the pipeline and
  MoE paths, as the JAX package reads them.
- ``test_a11_remainders_raise``: what ROADMAP A11 still leaves raises
  naming it; each part a slice has ported keeps its case and works in one
  process (a ``pp`` mesh is declined by ``SPMDTrainStep`` with the
  reference's words, a ring of one rank is the plain attention).
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import fusedstep as jfusedstep
from mxnet_tpu.parallel import mesh as jmesh
from mxnet_tpu.parallel import overlap as jovl
from mxnet_tpu_torch import fusedstep as tfusedstep
from mxnet_tpu_torch.parallel import mesh as tmesh
from mxnet_tpu_torch.parallel import overlap as tovl


@pytest.mark.parametrize("axes", [{"dp": 8}, {"dp": 2, "tp": 4},
                                  {"dp": -1, "tp": 2}, {"tp": 2, "dp": 4},
                                  {"x": 2, "y": 4}])
def test_make_mesh_matches_jax(axes):
    jm = jmesh.make_mesh(dict(axes), devices=jax.devices()[:8])
    tm = tmesh.make_mesh(dict(axes), devices=range(8))
    assert tuple(tm.axis_names) == tuple(jm.axis_names)
    assert dict(tm.shape) == dict(jm.shape)
    assert tm.devices.shape == jm.devices.shape
    assert tmesh.current_mesh() is tm
    for name in ("dp", "tp", "pp", "x"):
        assert tmesh.axis_size(tm, name) == jmesh.axis_size(jm, name)


def test_make_mesh_bad_sizes_raise():
    with pytest.raises(AssertionError):
        jmesh.make_mesh({"dp": 3}, devices=jax.devices()[:8])
    with pytest.raises(ValueError, match="8 devices"):
        tmesh.make_mesh({"dp": 3}, devices=range(8))


@pytest.mark.parametrize("sizes", [dict(dp=2, tp=4), dict(dp=-1, pp=2),
                                   dict(tp=2, sp=2, ep=2),
                                   dict(dp=1, pp=1, tp=8)])
def test_composed_mesh_matches_jax(sizes):
    jm = jmesh.composed_mesh(**sizes, devices=jax.devices()[:8])
    tm = tmesh.composed_mesh(**sizes, devices=range(8))
    assert tuple(tm.axis_names) == tuple(jm.axis_names) == tmesh.MESH_AXES
    assert dict(tm.shape) == dict(jm.shape)


def test_composed_mesh_rejects_inference_off_dp():
    for m in (jmesh, tmesh):
        with pytest.raises(ValueError, match="dp-only"):
            m.composed_mesh(tp=-1, devices=list(range(8)) if m is tmesh
                            else jax.devices()[:8])


def test_validate_mesh_axes_matches_jax():
    for names, ok in ((("dp", "tp"), True), (("batch", "model"), True),
                      (("dp", "rows"), False)):
        sizes = dict(zip(names, (2, 4)))
        jm = jmesh.make_mesh(sizes, devices=jax.devices()[:8])
        tm = tmesh.make_mesh(sizes, devices=range(8))
        for m, mesh in ((jmesh, jm), (tmesh, tm)):
            if ok:
                assert m.validate_mesh_axes(mesh) is mesh
            else:
                with pytest.raises(ValueError, match="unknown mesh axes"):
                    m.validate_mesh_axes(mesh)


def test_world_of_one_defaults():
    assert tmesh.world() == (0, 1)
    assert mx.kv.create("dist_tpu_sync").num_workers == 1
    m = mx.parallel.data_parallel_mesh()
    assert dict(m.shape) == {"dp": 1} and m.group("dp") is None
    assert m.axis_index("dp") == 0 and m.axis_index("tp") == 0
    assert mx.kv.all_gather_bytes(b"abc") == [b"abc"]
    assert dict(mx.parallel.make_mesh().shape) == {"dp": 1}


def test_a_mesh_larger_than_the_world_cannot_train():
    net = mx.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=mx.cpu())
    step = mx.parallel.SPMDTrainStep(
        net, mx.gluon.loss.L2Loss(), "sgd", {},
        mesh=mx.parallel.make_mesh({"dp": 2}, devices=[0, 1]))
    x = mx.nd.ones((4, 3), ctx=mx.cpu())
    with pytest.raises(mx.MXNetError, match="world of 1"):
        step(x, mx.nd.ones((4, 2), ctx=mx.cpu()))


@pytest.mark.parametrize("dp,rank", [(2, 0), (2, 1), (4, 3)])
def test_shard_batch_takes_the_ranks_rows(dp, rank, monkeypatch):
    mesh = tmesh.make_mesh({"dp": dp}, devices=range(dp))
    monkeypatch.setattr(tmesh, "world", lambda: (rank, dp))
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    got = mx.parallel.shard_batch(mx.nd.array(x, ctx=mx.cpu()), mesh)
    b = 8 // dp
    np.testing.assert_array_equal(got.numpy(), x[rank * b:(rank + 1) * b])
    assert mx.parallel.replicate(mx.nd.array(x, ctx=mx.cpu()),
                                 mesh).shape == (8, 3)
    with pytest.raises(mx.MXNetError, match="does not split"):
        mx.parallel.shard_batch(mx.nd.ones((3, 2), ctx=mx.cpu()), mesh)


PLAN_CASES = {
    "mixed_dtypes_dp4": ([(7,), (5,), (3, 3), (4,)],
                         ["float32", "float16", "float32", "float32"],
                         None, 1 << 20, 4),
    "splits_at_target": ([(1024,)] * 6, ["float32"] * 6, None, 8192, 1),
    "given_order": ([(100,), (3, 30), (64,), (8, 8), (1,)],
                    ["float32", "bfloat16", "float32", "bfloat16",
                     "float32"], [2, 0, 4, 1, 3], 600, 2),
    "one_per_bucket": ([(10,), (20,), (30,)], ["float32"] * 3, None, 1, 3),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_build_bucket_plan_matches_jax(case):
    shapes, dtypes, order, target, dp = PLAN_CASES[case]
    jp = jovl.build_bucket_plan(shapes, dtypes, order=order,
                                bucket_bytes=target, dp=dp)
    tp = tovl.build_bucket_plan(shapes, dtypes, order=order,
                                bucket_bytes=target, dp=dp)
    for field in ("buckets", "shapes", "sizes", "pad_sizes", "order",
                  "dp"):
        assert getattr(tp, field) == getattr(jp, field), field
    assert len(tp) == len(jp)
    for rs in (False, True):
        assert tovl.residual_shapes(tp, rs) == jovl.residual_shapes(jp, rs)


def test_shard_arithmetic_matches_jax():
    x = np.arange(10, dtype=np.float32).reshape(2, 5)
    flat = tovl.pad_flat(torch.from_numpy(x), 12)
    np.testing.assert_array_equal(flat.numpy(),
                                  np.asarray(jovl.pad_flat(jnp.asarray(x),
                                                           12)))
    np.testing.assert_array_equal(
        tovl.unpad_reshape(flat, 10, (2, 5)).numpy(), x)
    plan = tovl.build_bucket_plan([(2, 5)], ["float32"], dp=4)
    rows = [tovl.shard_of(torch.from_numpy(x), plan, r, 0).numpy()
            for r in range(4)]
    np.testing.assert_array_equal(np.concatenate(rows)[:10], x.ravel())
    assert all(r.shape == (3,) for r in rows)


@pytest.fixture
def jax_var(monkeypatch):
    import jax.extend

    monkeypatch.setattr(jax.core, "Var", jax.extend.core.Var, raising=False)


def test_first_use_order_of_the_reference_function(jax_var):
    def jf(params, x):
        h = x @ params[0]
        h = h @ params[1]
        return jnp.sum(h @ params[2])

    def tf(params, x):
        h = x @ params[0]
        h = h @ params[1]
        return torch.sum(h @ params[2])

    avals = [jax.ShapeDtypeStruct((4, 4), jnp.float32)] * 3
    want = jovl.first_use_order(
        jf, (avals, jax.ShapeDtypeStruct((2, 4), jnp.float32)), 3)
    got = tovl.first_use_order(
        tf, ([torch.randn(4, 4) for _ in range(3)], torch.randn(2, 4)), 3)
    assert got == want == [2, 1, 0]
    # no signal: every parameter consumed by one call
    assert tovl.first_use_order(
        lambda ps, x: torch.stack(ps).sum(),
        ([torch.ones(2), torch.ones(2)], None), 2) is None


def _orders(jnet, tnet, x, y, loss_of):
    """The readiness order of each package's step over its net."""
    jstep = jmx.parallel.SPMDTrainStep(jnet, loss_of(jmx), "sgd", {})
    jstep.init_state()
    plan = jstep._plan_buckets(
        jax.ShapeDtypeStruct(x.shape, jnp.asarray(x).dtype),
        jax.ShapeDtypeStruct(y.shape, jnp.asarray(y).dtype),
        jstep._make_run_forward())
    tstep = mx.parallel.SPMDTrainStep(tnet, loss_of(mx), "sgd", {})
    tstep.init_state()
    params = tstep._state[0]
    didx = [i for i, d in enumerate(tstep._diff) if d]

    def fwd(diff, xx, yy):
        full = list(params)
        for i, p in zip(didx, diff):
            full[i] = p
        return tstep._run_forward(full, xx, yy)

    got = tovl.first_use_order(
        fwd, ([params[i] for i in didx], torch.from_numpy(x),
              torch.from_numpy(y)), len(didx))
    names = [jstep._names[i] for i in didx]
    return [names[k] for k in plan.order], \
        [names[k] for k in (got or [])]


def test_first_use_order_of_an_mlp_matches_jax(jax_var):
    nets = []
    for m, kw in ((jmx, {}), (mx, {"ctx": mx.cpu()})):
        net = m.gluon.nn.HybridSequential(prefix="mlp_")
        with net.name_scope():
            net.add(m.gluon.nn.Dense(8, in_units=5, activation="relu"),
                    m.gluon.nn.Dense(8, in_units=8, activation="relu"),
                    m.gluon.nn.Dense(3, in_units=8))
        net.initialize(**kw)
        nets.append(net)
    x = np.ones((2, 5), np.float32)
    y = np.ones((2, 3), np.float32)
    want, got = _orders(*nets, x, y, lambda m: m.gluon.loss.L2Loss())
    assert got == want


def test_first_use_order_of_bert_matches_jax(tmp_path, jax_var):
    cfg = dict(vocab_size=1000, dropout=0.0, num_layers=2, units=64,
               hidden_size=128, num_heads=4, max_length=64,
               use_pooler=False, use_classifier=False)
    ids = np.random.RandomState(0).randint(5, 1000, (2, 16)).astype(
        np.float32)
    jnet = jmx.models.bert_base(**cfg)
    jnet.initialize(init=jmx.initializer.Normal(0.02))
    jnet(jmx.nd.array(ids, dtype="int32"))
    path = str(tmp_path / "b.params")
    jnet.save_parameters(path)
    tnet = mx.models.bert_base(**cfg)
    tnet.load_parameters(path, ctx=mx.cpu())

    def loss_of(m):
        sce = m.gluon.loss.SoftmaxCrossEntropyLoss()
        return lambda out, y: sce(out[-1], y)

    want, got = _orders(jnet, tnet, ids, ids, loss_of)
    assert got == want


def test_fusedstep_knobs_match_jax(monkeypatch):
    for var, vals, fn in (
            ("MXTPU_BUCKET_BYTES", [None, "1024"], "bucket_bytes"),
            ("MXTPU_OVERLAP", [None, "barrier", "1", "0", "off", "bogus",
                               "staged"], "overlap_mode"),
            ("MXTPU_OVERLAP_BUCKET_BYTES", [None, "4096"],
             "overlap_bucket_bytes"),
            ("MXTPU_ZERO_STAGE", [None, "2", "3", "7"], "zero_stage"),
            ("MXTPU_AMP_ALLREDUCE_DTYPE", [None, "bfloat16", "float16",
                                           "int8"], "amp_allreduce_dtype"),
            ("MXTPU_PIPELINE_SCHEDULE", [None, "1f1b", "INTERLEAVED",
                                         "zigzag"], "pipeline_schedule"),
            ("MXTPU_PIPELINE_MICROBATCHES", [None, "8", "-2"],
             "pipeline_microbatches"),
            ("MXTPU_MOE_ROUTER", [None, "top2", "top3"], "moe_router"),
            ("MXTPU_MOE_CAPACITY_FACTOR", [None, "2.5"],
             "moe_capacity_factor"),
            ("MXTPU_MOE_A2A_CHUNKS", [None, "4", "0"], "moe_a2a_chunks")):
        for v in vals:
            if v is None:
                monkeypatch.delenv(var, raising=False)
            else:
                monkeypatch.setenv(var, v)
            assert getattr(tfusedstep, fn)() == \
                getattr(jfusedstep, fn)(), (var, v)


def _fake_world(monkeypatch, n):
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: n)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)


#: ROADMAP A11's parts that the port still leaves: none since live
#: elasticity
A11_LEFT = ()


@pytest.mark.parametrize("what", [
    "param_sharding", "tp_sharding_map", "run_superstep_on_a_mesh",
    "spmd_save_states", "spmd_load_states", "pp_axis",
    "checkpoint_manager_in_a_world", "load_checkpoint_in_a_world",
    "prefetcher_mesh", "ring_attention", "elastic"])
def test_a11_remainders_raise(what, tmp_path, monkeypatch):
    """Every part of ROADMAP A11 is ported (``A11_LEFT`` is empty); each
    keeps its case, which holds it working in one process (the worlds of
    several ranks are ``tests/test_torch_tp.py``'s,
    ``tests/test_torch_dist.py``'s and ``tests/test_torch_elastic.py``'s)."""
    from mxnet_tpu_torch import resilience
    from mxnet_tpu_torch.gluon.data.prefetcher import DevicePrefetcher

    net = mx.gluon.nn.Dense(2, in_units=3, prefix="dense0_")
    net.initialize(ctx=mx.cpu())
    loss = mx.gluon.loss.L2Loss()
    x = mx.nd.ones((4, 3), ctx=mx.cpu())
    y = mx.nd.ones((4, 2), ctx=mx.cpu())
    assert what not in A11_LEFT
    if what == "elastic":
        # a pool of one rank: the step is the plain one, the resize
        # controller runs with no collective and no signal
        et = resilience.ElasticTrainer(net, loss, "sgd", {})
        plain = mx.gluon.nn.Dense(2, in_units=3, prefix="dense0_")
        plain.initialize(ctx=mx.cpu())
        plain.weight.set_data(net.weight.data())
        plain.bias.set_data(net.bias.data())
        step = mx.parallel.SPMDTrainStep(plain, loss, "sgd", {})
        for _ in range(3):
            assert et.step(x, y, lr=0.1) == step(x, y, lr=0.1)
        assert et.devices == [0] and et.committed_steps == 3
        assert et.resize_events == []
        desc = et.snapshot()
        assert resilience.verify_descriptor(desc) == []
        assert desc["step"] == 3
        et.close()
    elif what == "pp_axis":
        # the pipeline executor's: SPMDTrainStep declines with the
        # reference's words (test_composed4d.py)
        with pytest.raises(mx.MXNetError, match="use Composed4DStep"):
            mx.parallel.SPMDTrainStep(
                net, loss, "sgd", {},
                mx.parallel.make_mesh({"dp": 2, "pp": 2}, devices=range(4)))
    elif what == "ring_attention":
        # a ring of one rank: the plain attention of the whole sequence
        rs = np.random.RandomState(0)
        q, k, v = (torch.from_numpy(rs.randn(1, 2, 8, 4).astype(np.float32))
                   for _ in range(3))
        from mxnet_tpu_torch.ops import flash_attention as fa

        got = mx.parallel.ring_attention(
            q, k, v, mx.parallel.make_mesh({"sp": 1}), causal=True)
        torch.testing.assert_close(
            got, fa._torch_flash_fwd(q, k, v, 0.5, True)[0], rtol=1e-6,
            atol=1e-6)
    elif what == "param_sharding":
        # one process: the specs have no mesh to act on (the reference's
        # _sharding_for gives None), the step is the plain one
        step = mx.parallel.SPMDTrainStep(net, loss, "sgd", {}, param_sharding={
            "dense0_weight": mx.parallel.P("tp", None)})
        w0 = net.weight.data().asnumpy().copy()
        assert np.isfinite(step(x, y, lr=0.1))
        step.sync_to_block()
        assert not np.array_equal(net.weight.data().asnumpy(), w0)
    elif what == "tp_sharding_map":
        specs = mx.models.llama_tiny(prefix="llama_").tp_sharding_map()
        assert specs["llama_layers_l0_attn_q_weight"] == ("tp", None)
        assert specs["llama_layers_l0_attn_o_weight"] == (None, "tp")
        assert specs["llama_norm_weight"] == ()
    elif what == "run_superstep_on_a_mesh":
        mesh = mx.parallel.make_mesh({"dp": 1})
        other = mx.gluon.nn.Dense(2, in_units=3)
        other.initialize(ctx=mx.cpu())
        other.weight.set_data(net.weight.data())
        a = mx.parallel.SPMDTrainStep(net, loss, "sgd", {}, mesh)
        b = mx.parallel.SPMDTrainStep(other, loss, "sgd", {}, mesh)
        xs = mx.nd.array(np.random.RandomState(0).randn(2, 4, 3)
                         .astype(np.float32), ctx=mx.cpu())
        ys = mx.nd.ones((2, 4, 2), ctx=mx.cpu())
        got = a.run_superstep(xs, ys, lr=0.1)
        want = [b(xs[i], ys[i], lr=0.1) for i in range(2)]
        np.testing.assert_array_equal(got.numpy(),
                                      np.array(want, np.float32))
    elif what in ("spmd_save_states", "spmd_load_states"):
        step = mx.parallel.SPMDTrainStep(net, loss, "adam", {})
        step(x, y, lr=0.1)
        fname = mx.parallel.spmd_save_states(step, str(tmp_path / "s"))
        assert fname.endswith(".shard0.npz")
        saved = [t.clone() for t in step._state[0]]
        step(x, y, lr=0.1)
        mx.parallel.spmd_load_states(step, str(tmp_path / "s"))
        for a, b in zip(saved, step._state[0]):
            assert torch.equal(a, b)
        with pytest.raises(mx.MXNetError, match="no checkpoint shards"):
            mx.parallel.spmd_load_states(step, str(tmp_path / "nope"))
    elif what in ("checkpoint_manager_in_a_world",
                  "load_checkpoint_in_a_world"):
        import json

        _fake_world(monkeypatch, 2)
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1})
        mgr = resilience.CheckpointManager(str(tmp_path / "ck"), 1,
                                           net=net, trainer=tr,
                                           install_sigterm=False)
        path = mgr.save_sync()
        mgr.close()
        with open(f"{path}/MANIFEST.json") as f:
            assert json.load(f)["world"]["process_count"] == 2
        w = net.weight.data().asnumpy().copy()
        net.weight.set_data(net.weight.data() * 0)
        resilience.load_checkpoint(str(tmp_path / "ck"), net=net,
                                   trainer=tr)
        np.testing.assert_array_equal(net.weight.data().asnumpy(), w)
    else:
        batches = [np.arange(6, dtype=np.float32).reshape(2, 3)]
        with mx.cpu():
            got = list(DevicePrefetcher(batches,
                                        mesh=mx.parallel.make_mesh({"dp": 1})))
        np.testing.assert_array_equal(got[0].asnumpy(), batches[0])
