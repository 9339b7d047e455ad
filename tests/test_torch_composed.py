"""The composed train step: the port's ``Composed4DStep`` and Megatron's
``tp_copy``/``tp_all_gather`` in gloo worlds of 4 (dp 4; dp 2 x pp 2;
pp 4) and 8 (dp 2 x pp 2 x tp 2).

This file is also the worker (``tests/torch_world.py``): ``python
tests/test_torch_composed.py --worker <scenario> <out_dir>`` imports
neither JAX nor the JAX package.

The reference's ``Composed4DStep`` fails under jax 0.9.0
(``shard_map(check_rep=...)``, ROADMAP), so every layout is held to the
single-device autodiff trajectory that ``test_composed4d.py::_ref_losses``
computes in JAX (4 tanh stages of width 8, batch 16 in 4 microbatches, 5
steps, SGD lr 0.1), and for Adam and LAMB (lr 0.02) to the same net with
the reference's ``_RULES`` applied to each stacked leaf (LAMB's trust
ratio spans the whole stacked leaf, as the reference's sharded norms do),
within 2e-5 (the reference test's): dp 4; dp 2 x pp 2 at ZeRO 0, 2 and 3;
pp 4 with gpipe and 1f1b; dp 2 x pp 2 x tp 2 at ZeRO 0 and 2 (W split
on its output features, the f/g bracket in the stage). With
``embed_fn``/``head_fn`` (a token table before the stages, an RMS norm and
a projection after them, Adam), dp 2 x pp 2 under 1f1b at ZeRO 0 and 2
and under interleaved at ZeRO 0, 2 and 3, and pp 4 under gpipe, give the
trajectory's losses and, on every rank, its table, norm and projection
within 2e-5. ``run_superstep``
equals the stepwise losses bit for bit; a snapshot taken at dp 4 restores
into dp 2 x pp 2 (ZeRO 3) and snapshots again bit for bit, and both
layouts' next step agree. ZeRO 2 halves the optimizer bytes at dp 2.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import os
import sys
import time

import numpy as np
import pytest

import torch_world

SPAWN_TIMEOUT_S = 150
WORLDS = {"w4": 4, "w8": 8}
L, D, B, M = 4, 8, 16, 4
STEPS = 5
TOL = 2e-5


def data():
    rng = np.random.RandomState(0)
    W0 = (rng.randn(L, D, D) * 0.3).astype(np.float32)
    b0 = (rng.randn(L, D) * 0.1).astype(np.float32)
    X = rng.randn(B, D).astype(np.float32)
    Y = rng.randn(B, D).astype(np.float32)
    return W0, b0, X, Y


#: the embed/head bracket: a token table of VOCAB rows, an RMS norm and a
#: projection to OUT features
VOCAB, OUT, EPS = 11, 5, 1e-6


def eh_data():
    rng = np.random.RandomState(1)
    E0 = (rng.randn(VOCAB, D) * 0.5).astype(np.float32)
    G0 = (1.0 + rng.randn(D) * 0.1).astype(np.float32)
    Wo0 = (rng.randn(D, OUT) * 0.3).astype(np.float32)
    ids = rng.randint(0, VOCAB, (B,)).astype(np.int64)
    Yh = rng.randn(B, OUT).astype(np.float32)
    return E0, G0, Wo0, ids, Yh


#: (tag, pp, stages, schedule, zero) of the embed/head runs (Adam): dp 2 x
#: pp 2 under 1f1b and interleaved, pp 4 under gpipe
EH_RUNS = (("1f1b:0", 2, 2, "1f1b", 0), ("1f1b:2", 2, 2, "1f1b", 2),
           ("interleaved:0", 2, 4, "interleaved", 0),
           ("interleaved:2", 2, 4, "interleaved", 2),
           ("interleaved:3", 2, 4, "interleaved", 3),
           ("gpipe:pp4", 4, 4, "gpipe", 0))
EH_LR = 0.02


# ---------------------------------------------------------------------------
# the worker side
# ---------------------------------------------------------------------------

def worker(scenario, out_dir):
    if scenario == "imports":
        torch_world.imports_only()
    import torch

    mx, rank = torch_world.join()
    par = mx.parallel
    W0, b0, X, Y = (torch.from_numpy(a) for a in data())
    res = {}

    def stage_fn(p, h):
        W, b = p
        return torch.tanh(h @ W + b)

    def stage_fn_tp(p, h):
        W, b = p
        out = par.tp_copy(h, "tp") @ W
        return torch.tanh(par.tp_all_gather(out, "tp", axis=1) + b)

    def loss_fn(o, y):
        return ((o - y) ** 2).mean()

    def make(mesh, zero, opt="sgd", sf=stage_fn, specs=None, schedule=None):
        return par.Composed4DStep(sf, (W0, b0), mesh, loss_fn,
                                  optimizer=opt, num_microbatches=M,
                                  zero_stage=zero, tp_specs=specs,
                                  schedule=schedule)

    def run(step, steps=STEPS, lr=0.1):
        return np.array([float(step(X, Y, lr=lr)) for _ in range(steps)])

    if scenario == "w8":
        mesh = par.composed_mesh(dp=2, pp=2, tp=2)
        specs = (par.P(None, "tp"), par.P())
        for zero in (0, 2):
            res[f"tp:sgd:{zero}"] = run(make(mesh, zero, sf=stage_fn_tp,
                                             specs=specs))
            res[f"tp:lamb:{zero}"] = run(make(mesh, zero, "lamb",
                                              stage_fn_tp, specs), lr=0.02)
        np.savez(os.path.join(out_dir, f"{scenario}_rank{rank}.npz"), **res)
        mx.kv.shutdown_distributed()
        return

    dp4 = par.composed_mesh(dp=4)
    # bucketed_psum: mixed dtypes and sizes in 256-byte buckets
    gs = [torch.full((40,), rank + 1.0), torch.arange(6, dtype=torch.int32)
          .reshape(2, 3) * (rank + 1), torch.full((3, 5), 0.5 * rank,
                                                 dtype=torch.float64)]
    res["psum"] = np.concatenate([t.double().reshape(-1).numpy() for t in
                                  par.bucketed_psum(gs, "dp", 256, dp4)])
    step = make(dp4, 0)
    res["dp4:schedule"] = step.schedule.name
    res["dp4:sgd:0"] = run(step)
    pp4 = par.composed_mesh(pp=4)
    for name in ("gpipe", "1f1b"):
        res[f"pp4:{name}"] = run(make(pp4, 0, schedule=name))
    mesh = par.composed_mesh(dp=2, pp=2)
    for zero in (0, 2, 3):
        res[f"dp2pp2:sgd:{zero}"] = run(make(mesh, zero))
        for opt in ("adam", "lamb"):
            res[f"dp2pp2:{opt}:{zero}"] = run(make(mesh, zero, opt),
                                              lr=0.02)
    # embed_fn/head_fn: a token table feeds stage 0, an RMS norm and a
    # projection sit between the last stage and the loss
    E0, G0, Wo0, ids, Yh = (torch.from_numpy(a) for a in eh_data())

    def embed_fn(p, x):
        return p[0][x]

    def head_fn(p, h):
        g, Wo = p
        return (h * torch.rsqrt((h * h).mean(-1, keepdim=True) + EPS)
                * g) @ Wo

    for tag, pp, n, sched, zero in EH_RUNS:
        m = par.composed_mesh(dp=4 // pp, pp=pp)
        step = par.Composed4DStep(
            stage_fn, (W0[:n], b0[:n]), m, loss_fn, optimizer="adam",
            num_microbatches=M, zero_stage=zero, schedule=sched,
            embed_fn=embed_fn, embed_params=(E0,), head_fn=head_fn,
            head_params=(G0, Wo0))
        res[f"eh:{tag}"] = np.array([float(step(ids, Yh, lr=EH_LR))
                                     for _ in range(STEPS)])
        # this rank's own copies of the bracket after the last step
        chunks, _ = step.state_snapshot()
        for key in ("embed::p0", "head::p0", "head::p1"):
            res[f"eh:{tag}:{key}"] = chunks[key][0][1]
    # reports
    s0, s2 = make(mesh, 0, "adam"), make(mesh, 2, "adam")
    s0(X, Y, lr=0.02)
    s2(X, Y, lr=0.02)
    res["mem0"], res["mem2"] = str(s0.memory_report()), \
        str(s2.memory_report())
    res["report"] = str(s0.schedule_report())
    try:
        s0(X[:6], Y[:6], lr=0.1)
        res["bad_batch"] = "no error"
    except mx.MXNetError as e:
        res["bad_batch"] = str(e)
    # run_superstep against stepwise
    a = make(mesh, 2, "adam")
    res["super:stepwise"] = run(a, 4, lr=0.02)
    b = make(mesh, 2, "adam")
    res["super:scan"] = b.run_superstep(torch.stack([X] * 4),
                                        torch.stack([Y] * 4),
                                        lr=0.02).numpy()
    # a snapshot at dp 4 restored into dp 2 x pp 2 (ZeRO 3)
    a = make(dp4, 2, "adam")
    run(a, 2, lr=0.02)
    chunks, _ = a.state_snapshot()
    b = make(mesh, 3, "adam")
    b.restore_chunks(chunks)
    again, _ = b.state_snapshot()
    res["snap:keys"] = sorted(chunks) == sorted(again)
    res["snap:equal"] = all(
        np.array_equal(chunks[k][0][1], again[k][0][1]) and
        chunks[k][0][1].dtype == again[k][0][1].dtype for k in chunks)
    res["snap:next"] = np.array([float(a(X, Y, lr=0.02)),
                                 float(b(X, Y, lr=0.02))])
    np.savez(os.path.join(out_dir, f"{scenario}_rank{rank}.npz"), **res)
    mx.kv.shutdown_distributed()


# ---------------------------------------------------------------------------
# the test side
# ---------------------------------------------------------------------------

def _trajectory(opt, lr, n=L, bracket=False):
    """``_ref_losses``: single-device autodiff in JAX, the reference's
    ``_RULES[opt]`` on each stacked leaf, over the first ``n`` stages;
    with ``bracket`` the token table before them and the RMS norm and
    projection after them (``eh_data``), each their own leaves. Returns
    the losses and the final leaves."""
    import jax
    import jax.numpy as jnp

    from mxnet_tpu.parallel.spmd import _RULES

    W0, b0, X, Y = data()
    leaves = [W0[:n], b0[:n]]
    if bracket:
        E0, G0, Wo0, X, Y = eh_data()
        leaves += [E0, G0, Wo0]
    init, update = _RULES[opt]({})
    ps = [jnp.asarray(a) for a in leaves]
    st = [init(p) for p in ps]
    x, y = jnp.asarray(X), jnp.asarray(Y)

    @jax.jit
    def one(ps, st):
        def loss_of(ps):
            h = ps[2][x] if bracket else x
            for i in range(n):
                h = jnp.tanh(h @ ps[0][i] + ps[1][i])
            if bracket:
                h = (h * jax.lax.rsqrt(jnp.mean(h * h, -1, keepdims=True)
                                       + EPS) * ps[3]) @ ps[4]
            return jnp.mean((h - y) ** 2)

        loss, gs = jax.value_and_grad(loss_of)(ps)
        new = [update(p, g, s, jnp.float32(lr))
               for p, g, s in zip(ps, gs, st)]
        return [w for w, _ in new], [s for _, s in new], loss

    out = []
    for _ in range(STEPS):
        ps, st, loss = one(ps, st)
        out.append(float(loss))
    return np.array(out), [np.asarray(p) for p in ps]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("composed"))
    started = {s: torch_world.start(__file__, s, n, out_dir)
               for s, n in WORLDS.items()}
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    ref = {"sgd": _trajectory("sgd", 0.1)[0],
           "adam": _trajectory("adam", 0.02)[0],
           "lamb": _trajectory("lamb", 0.02)[0]}
    for n in {n for _, _, n, _, _ in EH_RUNS}:
        ref[f"eh{n}"] = _trajectory("adam", EH_LR, n, bracket=True)
    logs = {s: torch_world.finish(p, deadline, SPAWN_TIMEOUT_S)
            for s, p in started.items()}
    return {"dir": out_dir, "logs": logs, "ref": ref}


def _ranks(worlds, scenario):
    return torch_world.results(worlds["dir"], scenario,
                               worlds["logs"][scenario])


def test_dp_only_matches_ref(worlds):
    for res in _ranks(worlds, "w4"):
        assert str(res["dp4:schedule"]) == "interleaved"  # pp 1 -> v = L
        np.testing.assert_allclose(res["dp4:sgd:0"], worlds["ref"]["sgd"],
                                   atol=TOL)


@pytest.mark.parametrize("opt", ["sgd", "adam", "lamb"])
@pytest.mark.parametrize("zero", [0, 2, 3])
def test_dp_pp_matches_ref(worlds, zero, opt):
    for res in _ranks(worlds, "w4"):
        np.testing.assert_allclose(res[f"dp2pp2:{opt}:{zero}"],
                                   worlds["ref"][opt], atol=TOL)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_gpipe_and_1f1b_match_ref(worlds, schedule):
    for res in _ranks(worlds, "w4"):
        np.testing.assert_allclose(res[f"pp4:{schedule}"],
                                   worlds["ref"]["sgd"], atol=TOL)


@pytest.mark.parametrize("opt", ["sgd", "lamb"])
@pytest.mark.parametrize("zero", [0, 2])
def test_dp_pp_tp_matches_ref(worlds, zero, opt):
    for res in _ranks(worlds, "w8"):
        np.testing.assert_allclose(res[f"tp:{opt}:{zero}"],
                                   worlds["ref"][opt], atol=TOL)


@pytest.mark.parametrize("tag", [r[0] for r in EH_RUNS])
def test_embed_head_match_ref(worlds, tag):
    """``embed_fn``/``head_fn`` around the stages: the losses and, on every
    rank, the table, norm and projection after the last step equal the
    single-device trajectory's (the embedding's and the head's gradients
    are computed on one pp rank each and summed over pp)."""
    n = next(r[2] for r in EH_RUNS if r[0] == tag)
    losses, leaves = worlds["ref"][f"eh{n}"]
    for res in _ranks(worlds, "w4"):
        np.testing.assert_allclose(res[f"eh:{tag}"], losses, atol=TOL)
        for key, want in (("embed::p0", leaves[2]), ("head::p0", leaves[3]),
                          ("head::p1", leaves[4])):
            np.testing.assert_allclose(res[f"eh:{tag}:{key}"], want,
                                       atol=TOL, err_msg=key)


def test_superstep_matches_stepwise(worlds):
    for res in _ranks(worlds, "w4"):
        np.testing.assert_array_equal(res["super:scan"],
                                      res["super:stepwise"])
        np.testing.assert_allclose(res["super:stepwise"],
                                   worlds["ref"]["adam"][:4], atol=TOL)


def test_snapshot_crosses_layouts_bit_for_bit(worlds):
    for res in _ranks(worlds, "w4"):
        assert bool(res["snap:keys"]) and bool(res["snap:equal"])
        a, b = res["snap:next"]
        np.testing.assert_allclose(b, a, atol=TOL)


def test_bucketed_psum_sums_over_the_axis(worlds):
    """The reference's in-graph bucketed ``psum`` (``spmd.bucketed_psum``)
    on ``torch.distributed``: each tensor summed over dp 4, in its own
    order, shape and dtype, across dtype-homogeneous buckets."""
    want = np.concatenate([np.full(40, 10.0), np.arange(6) * 10.0,
                           np.full(15, 3.0)])
    for res in _ranks(worlds, "w4"):
        np.testing.assert_array_equal(res["psum"], want)


def test_reports_and_batch_check(worlds):
    for res in _ranks(worlds, "w4"):
        m0, m2 = eval(str(res["mem0"])), eval(str(res["mem2"]))
        assert m2["opt_bytes_per_device"] <= \
            m0["opt_bytes_per_device"] * 0.55, (m0, m2)
        assert m0["zero_stage"] == 0 and m2["zero_stage"] == 2
        for key in ("schedule", "bubble_fraction", "stash_slots",
                    "param_bytes_per_device"):
            assert key in m0
        rep = eval(str(res["report"]))
        assert rep["schedule"] == "interleaved"  # L 4 over pp 2 -> v 2
        assert rep["ranks"] == 2 and rep["virtual"] == 2
        assert 0.0 <= rep["bubble_fraction"] < 1.0
        assert rep["stash_slots"] >= 1
        assert "dp" in str(res["bad_batch"])


def _one_process_step(mesh, **kw):
    import mxnet_tpu_torch as mx

    W0, b0, _, _ = data()
    return mx.parallel.Composed4DStep(
        lambda p, h: h, (W0, b0), mesh, lambda o, y: o.sum(),
        device="cpu", **kw)


def test_declines_as_the_reference():
    import mxnet_tpu_torch as mx

    par = mx.parallel
    with pytest.raises(mx.MXNetError, match="ring_attention"):
        _one_process_step(par.composed_mesh(dp=2, sp=2, devices=range(4)))
    with pytest.raises(mx.MXNetError, match="moe_apply_a2a"):
        _one_process_step(par.composed_mesh(dp=2, ep=2, devices=range(4)))
    for sched in ("gpipe", "1f1b"):
        with pytest.raises(mx.MXNetError, match="interleaved"):
            _one_process_step(par.composed_mesh(dp=2, pp=2,
                                                devices=range(4)),
                              schedule=sched)
    with pytest.raises(mx.MXNetError, match="composed_mesh"):
        _one_process_step(par.make_mesh({"tp": 1}))


def test_spmd_step_declines_pp_mesh():
    """The reference's words (``test_composed4d.py``)."""
    import mxnet_tpu_torch as mx

    with pytest.raises(mx.MXNetError, match="Composed4DStep"):
        mx.parallel.SPMDTrainStep(
            None, None, mesh=mx.parallel.composed_mesh(dp=2, pp=2,
                                                       devices=range(4)))


if __name__ == "__main__" and len(sys.argv) >= 4 and \
        sys.argv[1] == "--worker":
    worker(sys.argv[2], sys.argv[3])


def test_a11_world_on_cuda(monkeypatch):
    """``chip_smoke.py``'s two-rank world of ``[dist-ring]``,
    ``[dist-llama-pp]`` and ``[dist-moe-ep]`` on the card at cut widths:
    every gate of the three phases (the kernels' launches, the kernels at
    the new shapes against their plain versions, the references)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.path.insert(0, torch_world.ROOT)
    import chip_smoke

    fails = []
    monkeypatch.setattr(chip_smoke, "check",
                        lambda ok, what: ok or fails.append(what))
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = chip_smoke.dist_a11_phases("card", cut={
        "ring": (1, 4, 512, 64),
        "llama": dict(vocab_size=512, units=256, intermediate=512,
                      num_heads=4, num_kv_heads=2),
        "moe": dict(d_model=64, d_hidden=128, experts=4, tokens=256)})
    assert not fails, fails
    assert {r["name"] for r in rows} == {
        "flash_fwd@ring", "flash_bwd_dq@ring", "flash_bwd_dkv@ring",
        "flash_fwd@llama-pp", "flash_bwd_fused@llama-pp"}
    assert all(r["launches"] > 0 for r in rows)
