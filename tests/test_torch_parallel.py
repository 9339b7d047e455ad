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
- the ``fusedstep`` knobs read by these paths, as the JAX package reads
  them.
"""

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
                                           "int8"], "amp_allreduce_dtype")):
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


@pytest.mark.parametrize("what", [
    "param_sharding", "tp_sharding_map", "run_superstep_on_a_mesh",
    "spmd_save_states", "spmd_load_states", "pp_axis",
    "checkpoint_manager_in_a_world", "load_checkpoint_in_a_world",
    "prefetcher_mesh"])
def test_a11_remainders_raise(what, tmp_path, monkeypatch):
    """What this slice leaves of ROADMAP A11 raises MXNetError naming it,
    where it would otherwise do the wrong thing silently."""
    from mxnet_tpu_torch import resilience
    from mxnet_tpu_torch.gluon.data.prefetcher import DevicePrefetcher

    net = mx.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=mx.cpu())
    loss = mx.gluon.loss.L2Loss()
    with pytest.raises(mx.MXNetError, match="A11"):
        if what == "param_sharding":
            mx.parallel.SPMDTrainStep(net, loss, "sgd", {}, param_sharding={
                "dense0_weight": ("tp", None)})
        elif what == "tp_sharding_map":
            mx.models.llama_tiny().tp_sharding_map()
        elif what == "run_superstep_on_a_mesh":
            mesh = mx.parallel.make_mesh({"dp": 2}, devices=[0, 1])
            mx.parallel.SPMDTrainStep(net, loss, "sgd", {}, mesh) \
                .run_superstep(mx.nd.ones((2, 4, 3), ctx=mx.cpu()),
                               mx.nd.ones((2, 4, 2), ctx=mx.cpu()))
        elif what == "spmd_save_states":
            mx.parallel.spmd_save_states(None, str(tmp_path / "s"))
        elif what == "spmd_load_states":
            mx.parallel.spmd_load_states(None, str(tmp_path / "s"))
        elif what == "pp_axis":
            mx.parallel.SPMDTrainStep(
                net, loss, "sgd", {},
                mx.parallel.make_mesh({"dp": 2, "pp": 2},
                                      devices=range(4)))
        elif what == "checkpoint_manager_in_a_world":
            _fake_world(monkeypatch, 2)
            resilience.CheckpointManager(str(tmp_path / "ck"), 1,
                                         install_sigterm=False)
        elif what == "load_checkpoint_in_a_world":
            _fake_world(monkeypatch, 2)
            resilience.load_checkpoint(str(tmp_path / "ck"), net=net)
        else:
            DevicePrefetcher([], mesh=mx.parallel.make_mesh({"dp": 1}))
