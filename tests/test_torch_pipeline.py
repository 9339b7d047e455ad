"""Pipelines: the port in gloo worlds of 2 (pp 2) and 4 (pp 4) against
the JAX package's ``parallel/pipeline.py`` on its virtual CPU mesh.

This file is also the worker (``tests/torch_world.py``): ``python
tests/test_torch_pipeline.py --worker <scenario> <out_dir>`` imports
neither JAX nor the JAX package.

- ``pipeline_apply`` (the reference test's near-identity relu stages,
  width 16, batch 8 in 4 microbatches) forward within 1e-5 and the
  gradients of ``sum(out**2)`` within 1e-4 relative + 1e-5 of
  ``jax.grad`` of the reference's; the gpipe ``PipelineTrainStep`` (MSE
  to a tanh target, lr 0.05, 5 SGD steps) within 1e-5 of the reference's
  losses and 1e-4 of its stage weights.
- ``1f1b`` and ``interleaved`` (the tick-table executor): the reference's
  own ``1f1b``/``interleaved`` fail under jax 0.9.0 (ROADMAP), so they are
  held to the single-device autodiff trajectory of the same stages in
  JAX (``test_composed4d.py::_ref_losses``'s form, with the reference's
  ``_RULES`` for Adam) and to the port's gpipe, within 2e-5 (the
  reference test's); under bf16 AMP, 1f1b within 2e-2 of gpipe (the
  reference test's).
- ``build_pipeline_schedule``'s tables and ``bubble_fraction``, for a grid
  of (name, S, M, v), equal the reference's bit for bit;
  ``measure_pipeline_bubble``'s reports equal.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import os
import sys
import time

import numpy as np
import pytest

import torch_world

SPAWN_TIMEOUT_S = 120
WORLDS = {"pp2": 2, "pp4": 4}
D = 16
STEPS = 3
LR = 0.05
#: (optimizer, amp) cells of the schedule runs
CELLS = (("sgd", None), ("adam", None), ("sgd", "bfloat16"))


def relu_stages(S, seed):
    """The reference test's near-identity relu stages."""
    rng = np.random.RandomState(seed)
    eye = np.eye(D, dtype=np.float32)
    return [{"w": eye + rng.randn(D, D).astype(np.float32) * 0.05,
             "b": np.full(D, 0.05, np.float32)} for _ in range(S)]


def apply_batch():
    return np.random.RandomState(1).randn(8, D).astype(np.float32)


def train_batch():
    rng = np.random.RandomState(5)
    x = rng.randn(16, D).astype(np.float32)
    w_true = rng.randn(D, D).astype(np.float32) * 0.4
    return x, np.tanh(x @ w_true).astype(np.float32)


def tanh_stages(n):
    """``test_composed4d.py::_pp_stages``: (W, b) per stage."""
    rng = np.random.RandomState(7)
    return [((np.eye(D) + rng.randn(D, D) * 0.05).astype(np.float32),
             np.full(D, 0.05, np.float32)) for _ in range(n)]


def sched_batch():
    rng = np.random.RandomState(0)
    return (rng.randn(8, D).astype(np.float32),
            rng.randn(8, D).astype(np.float32))


# ---------------------------------------------------------------------------
# the worker side
# ---------------------------------------------------------------------------

def worker(scenario, out_dir):
    if scenario == "imports":
        torch_world.imports_only()
    import torch

    mx, rank = torch_world.join()
    S = WORLDS[scenario]
    mesh = mx.parallel.make_mesh({"pp": S})
    par = mx.parallel
    res = {}

    def relu_fn(p, x):
        return torch.relu(x @ p["w"] + p["b"])

    def tanh_fn(p, h):
        W, b = p
        return torch.tanh(h @ W + b)

    def mse(o, y):
        return ((o - y) ** 2).mean()

    def tensors(stages):
        return [{k: torch.from_numpy(v) for k, v in s.items()}
                if isinstance(s, dict) else
                tuple(torch.from_numpy(a) for a in s) for s in stages]

    # pipeline_apply: forward and gradients of sum(out**2)
    stacked = par.stack_stage_params(tensors(relu_stages(S, 2)))
    local = {k: v.requires_grad_(True) for k, v in
             par.shard_stages(stacked, mesh).items()}
    x = torch.from_numpy(apply_batch())
    out = par.pipeline_apply(relu_fn, local, x, mesh, num_microbatches=4)
    (out ** 2).sum().backward()
    res["apply:out"] = out.detach().numpy()
    res["apply:dw"] = local["w"].grad.numpy()
    res["apply:db"] = local["b"].grad.numpy()
    try:
        par.pipeline_apply(relu_fn, local, torch.zeros(7, D), mesh,
                           num_microbatches=4)
        res["apply:bad_mb"] = "no error"
    except mx.MXNetError as e:
        res["apply:bad_mb"] = str(e)

    # the gpipe train step
    xt, yt = (torch.from_numpy(a) for a in train_batch())
    step = par.PipelineTrainStep(
        relu_fn, par.stack_stage_params(tensors(relu_stages(S, 4))), mesh,
        mse, num_microbatches=4, schedule="gpipe")
    res["gpipe:losses"] = np.array([float(step(xt, yt, lr=LR))
                                    for _ in range(5)])
    res["gpipe:w"] = step.params()["w"].numpy()

    # the three schedules on the (W, b) tanh stages
    xs, ys = (torch.from_numpy(a) for a in sched_batch())
    for opt, amp in CELLS:
        tag = f"{opt}-{amp}"
        for name, n_stages in (("gpipe", S), ("1f1b", S),
                               ("interleaved", 2 * S)):
            step = par.PipelineTrainStep(
                tanh_fn, par.stack_stage_params(tensors(
                    tanh_stages(n_stages))), mesh, mse,
                num_microbatches=4, schedule=name, optimizer=opt,
                amp_dtype=amp)
            res[f"{tag}:{name}"] = np.array(
                [float(step(xs, ys, lr=LR)) for _ in range(STEPS)])
            res[f"{tag}:{name}:report"] = str(step.schedule_report())
    np.savez(os.path.join(out_dir, f"{scenario}_rank{rank}.npz"), **res)
    mx.kv.shutdown_distributed()


# ---------------------------------------------------------------------------
# the test side
# ---------------------------------------------------------------------------

def _jax_single_device(jmx, jnp, stages, opt):
    """The single-device autodiff trajectory of the stacked tanh stages:
    ``loss = mean((stage_L(...stage_1(x)) - y)**2)``, the reference's
    ``_RULES[opt]`` on each stacked leaf."""
    import jax

    from mxnet_tpu.parallel.spmd import _RULES

    init, update = _RULES[opt]({})
    W = jnp.asarray(np.stack([w for w, _ in stages]))
    b = jnp.asarray(np.stack([bb for _, bb in stages]))
    sw, sb = init(W), init(b)
    x, y = (jnp.asarray(a) for a in sched_batch())

    @jax.jit
    def one(W, b, sw, sb):
        def loss_of(W, b):
            h = x
            for i in range(W.shape[0]):
                h = jnp.tanh(h @ W[i] + b[i])
            return jnp.mean((h - y) ** 2)

        loss, (gW, gb) = jax.value_and_grad(loss_of, (0, 1))(W, b)
        W, sw = update(W, gW, sw, jnp.float32(LR))
        b, sb = update(b, gb, sb, jnp.float32(LR))
        return W, b, sw, sb, loss

    out = []
    for _ in range(STEPS):
        W, b, sw, sb, loss = one(W, b, sw, sb)
        out.append(float(loss))
    return np.array(out)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    import mxnet_tpu as jmx
    from mxnet_tpu.parallel import pipeline as jpp

    out_dir = str(tmp_path_factory.mktemp("pipeline"))
    started = {s: torch_world.start(__file__, s, n, out_dir)
               for s, n in WORLDS.items()}
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    ref = {}

    def relu_fn(p, x):
        return jax.nn.relu(x @ p["w"] + p["b"])

    for s, S in WORLDS.items():
        mesh = jmx.parallel.make_mesh({"pp": S}, devices=jax.devices()[:S])
        stages = [{k: jnp.asarray(v) for k, v in p.items()}
                  for p in relu_stages(S, 2)]
        stacked = jpp.stack_stage_params(stages)
        x = jnp.asarray(apply_batch())

        def loss_pipe(params, mesh=mesh, x=x):
            out = jpp.pipeline_apply(relu_fn, params, x, mesh,
                                     num_microbatches=4)
            return jnp.sum(out ** 2), out

        (_, out), g = jax.jit(jax.value_and_grad(loss_pipe, has_aux=True))(
            stacked)
        ref[(s, "apply")] = (np.asarray(out), np.asarray(g["w"]),
                             np.asarray(g["b"]))
        xt, yt = (jnp.asarray(a) for a in train_batch())
        step = jpp.PipelineTrainStep(
            relu_fn, jpp.stack_stage_params(
                [{k: jnp.asarray(v) for k, v in p.items()}
                 for p in relu_stages(S, 4)]), mesh,
            lambda o, y: jnp.mean((o - y) ** 2), num_microbatches=4)
        ref[(s, "gpipe")] = np.array([float(step(xt, yt, lr=LR))
                                      for _ in range(5)])
        ref[(s, "gpipe_w")] = np.asarray(step._params["w"])
        for opt in ("sgd", "adam"):
            for n in (S, 2 * S):
                ref[(opt, n)] = _jax_single_device(jmx, jnp,
                                                   tanh_stages(n), opt)
    logs = {s: torch_world.finish(p, deadline, SPAWN_TIMEOUT_S)
            for s, p in started.items()}
    return {"dir": out_dir, "logs": logs, "ref": ref}


def _ranks(worlds, scenario):
    return torch_world.results(worlds["dir"], scenario,
                               worlds["logs"][scenario])


@pytest.mark.parametrize("scenario", sorted(WORLDS))
def test_pipeline_apply_matches_reference(worlds, scenario):
    out, gw, gb = worlds["ref"][(scenario, "apply")]
    for r, res in enumerate(_ranks(worlds, scenario)):
        np.testing.assert_allclose(res["apply:out"], out, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(res["apply:dw"], gw[r:r + 1], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(res["apply:db"], gb[r:r + 1], rtol=1e-4,
                                   atol=1e-5)
        assert "must divide the batch size 7" in str(res["apply:bad_mb"])


@pytest.mark.parametrize("scenario", sorted(WORLDS))
def test_gpipe_train_step_matches_reference(worlds, scenario):
    losses = worlds["ref"][(scenario, "gpipe")]
    w = worlds["ref"][(scenario, "gpipe_w")]
    for r, res in enumerate(_ranks(worlds, scenario)):
        np.testing.assert_allclose(res["gpipe:losses"], losses, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(res["gpipe:w"], w[r:r + 1], rtol=1e-4,
                                   atol=1e-5)
        assert res["gpipe:losses"][-1] < res["gpipe:losses"][0]


@pytest.mark.parametrize("cell", [f"{o}-{a}" for o, a in CELLS])
@pytest.mark.parametrize("scenario", sorted(WORLDS))
def test_schedules_agree(worlds, scenario, cell):
    """gpipe, 1f1b and interleaved: the same microbatch work in another
    order; AMP off, every schedule on the single-device trajectory."""
    S = WORLDS[scenario]
    opt, amp = cell.split("-")
    for res in _ranks(worlds, scenario):
        gp, f1b, il = (res[f"{cell}:{n}"]
                       for n in ("gpipe", "1f1b", "interleaved"))
        if amp != "None":
            np.testing.assert_allclose(f1b, gp, atol=2e-2)
            assert il[-1] <= il[0] + 2e-2
            continue
        np.testing.assert_allclose(f1b, gp, atol=2e-5)
        np.testing.assert_allclose(gp, worlds["ref"][(opt, S)], atol=2e-5)
        np.testing.assert_allclose(f1b, worlds["ref"][(opt, S)], atol=2e-5)
        np.testing.assert_allclose(il, worlds["ref"][(opt, 2 * S)],
                                   atol=2e-5)
        rep = eval(str(res[f"{cell}:interleaved:report"]))
        assert rep["virtual"] == 2 and rep["ranks"] == S


GRID = [(name, S, M, v) for name in ("gpipe", "1f1b", "interleaved")
        for S in (1, 2, 3, 4) for M in (1, 2, 4, 8) for v in (1, 2, 3)
        if (v == 1 or name == "interleaved")
        and (name != "interleaved" or M % S == 0)]


@pytest.mark.parametrize("name,S,M,v", GRID)
def test_schedule_tables_match_reference(name, S, M, v):
    from mxnet_tpu.parallel import pipeline as jpp

    import mxnet_tpu_torch as mx

    got = mx.parallel.build_pipeline_schedule(S, M, name, virtual=v)
    want = jpp.build_pipeline_schedule(S, M, name, virtual=v)
    assert (got.ticks, got.stash_slots, got.bstash_slots) == \
        (want.ticks, want.stash_slots, want.bstash_slots)
    assert got.bubble_fraction == want.bubble_fraction
    assert got.report() == want.report()
    assert sorted(got.tables) == sorted(want.tables)
    for col in want.tables:
        np.testing.assert_array_equal(got.tables[col], want.tables[col],
                                      err_msg=col)


def test_bubble_probe_and_declines():
    from mxnet_tpu.parallel import pipeline as jpp

    import mxnet_tpu_torch as mx

    for S, M in ((2, 4), (4, 8)):
        assert mx.parallel.measure_pipeline_bubble(S, M) == \
            jpp.measure_pipeline_bubble(S, M)
    with pytest.raises(mx.MXNetError, match="interleaved"):
        mx.parallel.build_pipeline_schedule(2, 4, "1f1b", virtual=2)
    with pytest.raises(mx.MXNetError, match="multiple of the pp axis"):
        mx.parallel.build_pipeline_schedule(4, 6, "interleaved", virtual=2)
    with pytest.raises(mx.MXNetError, match="unknown pipeline schedule"):
        mx.parallel.build_pipeline_schedule(2, 4, "zigzag")
    for S, v in ((2, 2), (4, 2), (2, 4), (3, 3)):
        assert mx.parallel.stage_permutation(S, v) == \
            jpp.stage_permutation(S, v)


@pytest.mark.parametrize("opt", ["sgd", "nag", "adam"])
def test_slab_update_equals_whole_leaf(monkeypatch, opt):
    """``_update_leaves`` updates an element-wise rule's leaf and state in
    place a slab at a time; with slabs of 7 elements (a leaf of 65 is ten
    slabs, the last short; a leaf of 3 and a scalar are one each) three
    steps equal the rule applied to the whole leaf, bit for bit."""
    import torch

    from mxnet_tpu_torch.parallel import pipeline
    from mxnet_tpu_torch.parallel.spmd import _RULES

    monkeypatch.setattr(pipeline, "_UPDATE_CHUNK", 7)
    init, update = _RULES[opt]({"momentum": 0.9, "wd": 1e-3})
    rng = np.random.RandomState(3)
    shapes = ((13, 5), (3,), ())
    whole = [torch.from_numpy(np.asarray(rng.randn(*s), np.float32))
             for s in shapes]
    slabbed = [w.clone() for w in whole]
    st_whole = [tuple(init(w)) for w in whole]
    st_slab = [tuple(init(w)) for w in slabbed]
    lr = torch.tensor(0.05)
    for _ in range(3):
        grads = [torch.from_numpy(np.asarray(rng.randn(*s), np.float32))
                 for s in shapes]
        for i in range(len(whole)):
            whole[i], st = update(whole[i], grads[i], st_whole[i], lr)
            st_whole[i] = tuple(st)
        kept = list(slabbed)
        pipeline._update_leaves(update, slabbed, list(grads), st_slab, lr,
                                elementwise=True)
        assert all(a is b for a, b in zip(kept, slabbed))  # in place
    for a, b in zip(slabbed, whole):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for sa, sb in zip(st_slab, st_whole):
        assert len(sa) == len(sb)
        for a, b in zip(sa, sb):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


if __name__ == "__main__" and len(sys.argv) >= 4 and \
        sys.argv[1] == "--worker":
    worker(sys.argv[2], sys.argv[3])
