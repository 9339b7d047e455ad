"""Port parity: the K-step superstep (``gluon.Superstep``,
``gluon.data.SuperstepRing``, ``SPMDTrainStep.run_superstep(mesh=None)``)
against the JAX package and against the port's own single steps,
replaying the one-device cases of the reference's
``tests/test_superstep.py``.

On the CPU a superstep runs its K iterations eagerly with the arithmetic
of the card's captured graph (``tests/test_torch_superstep_cuda.py``
holds the graph against it on a card). Tolerances:

- against the port's own ``trainer.step`` loop on the same batches:
  equal bit for bit (the same update, ``gluon.trainer._fused_apply``);
- against the JAX package's superstep on the same weights and batches:
  the reference's own tolerances (fp32 1e-5, bfloat16 2e-2, float16
  2e-3, relative and absolute) on losses, weights and optimizer state;
  the loss scaler's counters and overflow flags exactly.

The multi-device cases (``bucketed_psum`` in the scan, a mesh) are
ROADMAP A11's.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import logging

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from test_torch_amp import np32, set_weights

KW = {"ctx": mx.cpu()}
PKGS = ((jmx, {}), (mx, KW))
TOL = {None: 1e-5, "bfloat16": 2e-2, "float16": 2e-3}


@pytest.fixture(autouse=True)
def _clean():
    prev = (jmx.fusedstep.set_enabled(True), mx.fusedstep.set_enabled(True))
    yield
    for m in (jmx, mx):
        m.amp.disable()
        m.resilience.chaos.reset()
    jmx.fusedstep.set_enabled(prev[0])
    mx.fusedstep.set_enabled(prev[1])


def _batch(m, kw, i, amp_dtype=None, poison=False, n=16):
    rs = np.random.RandomState(100 + i)
    x = rs.randn(n, 8).astype(np.float32)
    if poison:
        x[0, 0] = np.inf
    y = rs.randint(0, 3, (n,)).astype(np.float32)
    xa = m.nd.array(x, **kw)
    return (xa.astype(amp_dtype) if amp_dtype else xa), m.nd.array(y, **kw)


def _build(m, kw, opt="sgd", amp_dtype=None, bn=False, deferred=False,
           window=2000, sched=None):
    nn = m.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu",
                     **({} if deferred else {"in_units": 8})))
    if bn:
        net.add(nn.BatchNorm(**({} if deferred else {"in_channels": 16})))
    net.add(nn.Dense(3, **({} if deferred else {"in_units": 16})))
    net.initialize(**kw)
    if deferred:
        net(_batch(m, kw, 0)[0])
    set_weights(m, net)
    if amp_dtype:
        m.amp.convert_model(net, amp_dtype)
    net.hybridize()
    params = {"learning_rate": 0.05, "multi_precision": bool(amp_dtype)}
    if opt == "sgd":
        params["momentum"] = 0.9
    if sched is not None:
        params["lr_scheduler"] = m.lr_scheduler.FactorScheduler(
            step=1, factor=0.8)
    tr = m.gluon.Trainer(net.collect_params(), opt, params, kvstore=None)
    if amp_dtype == "float16":
        tr._amp_loss_scaler = m.amp.LossScaler(
            init_scale=1024.0, scale_factor=2.0, scale_window=window)
    return net, tr


def _loss(m):
    return m.gluon.loss.SoftmaxCrossEntropyLoss()


def _single(m, kw, steps, opt="sgd", amp_dtype=None, poison=None,
            net=None, tr=None, start=0, **build):
    if net is None:
        net, tr = _build(m, kw, opt, amp_dtype, **build)
    loss_fn = _loss(m)
    losses = []
    for i in range(start, start + steps):
        x, y = _batch(m, kw, i, amp_dtype, poison == i)
        with m.autograd.record():
            loss = loss_fn(net(x), y)
            if amp_dtype == "float16":
                with m.amp.scale_loss(loss, tr) as sl:
                    sl.backward()
        if amp_dtype != "float16":
            loss.backward()
        tr.step(16)
        losses.append(float(np32(loss.mean())))
    return net, tr, losses


def _stacked(m, kw, start, k, amp_dtype=None, poison=None):
    from_pkg = m.gluon.data.prefetcher.stack_batches
    bs = [_batch(m, kw, i, amp_dtype, poison == i)
          for i in range(start, start + k)]
    return from_pkg([b[0] for b in bs]), from_pkg([b[1] for b in bs])


def _super(m, kw, steps, k, opt="sgd", amp_dtype=None, poison=None,
           net=None, tr=None, start=0, **build):
    if net is None:
        net, tr = _build(m, kw, opt, amp_dtype, **build)
    ss = m.gluon.Superstep(net, _loss(m), tr, k=k)
    losses, flags = [], []
    for g in range(start, start + steps, k):
        out = ss.step(*_stacked(m, kw, g, k, amp_dtype, poison), 16)
        losses.extend(np32(out).tolist())
        if m is mx and ss.last_overflow is not None:
            flags.append(ss.last_overflow.tolist())
    assert isinstance(ss._plan, dict), ss._plan
    return net, tr, losses, ss, flags


def _state(net, tr):
    """Weights and optimizer-state leaves by structural name (fp32)."""
    out = {}
    for k, p in sorted(net._collect_params_with_prefix().items()):
        out[k] = np32(p.data())
        for i, leaf in enumerate(tr._fused_states.get(p.name, ())):
            out[f"{k}::{i}"] = np32(leaf)
    return out


def _assert_states(got, want, tol):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=tol, atol=tol,
                                   err_msg=k)


def _bitwise(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("opt,amp_dtype,k", [
    ("sgd", None, 1), ("sgd", None, 2), ("sgd", None, 4), ("adam", None, 4),
    ("sgd", "bfloat16", 4), ("adam", "bfloat16", 4),
    ("sgd", "float16", 4), ("adam", "float16", 4)])
def test_superstep_parity(opt, amp_dtype, k):
    """8 steps as supersteps: bit for bit the port's single steps, and
    the JAX package's superstep within its tolerance."""
    steps = 8
    net, tr, losses, ss, _ = _super(mx, KW, steps, k, opt, amp_dtype)
    snet, str_, slosses = _single(mx, KW, steps, opt, amp_dtype)
    assert losses == slosses
    _bitwise(_state(net, tr), _state(snet, str_))
    jnet, jtr, jlosses, _, _ = _super(jmx, {}, steps, k, opt, amp_dtype)
    tol = TOL[amp_dtype]
    np.testing.assert_allclose(losses, jlosses, rtol=tol, atol=tol)
    _assert_states(_state(net, tr), _state(jnet, jtr), tol)
    o, jo = tr.optimizer, jtr.optimizer
    assert o._index_update_count == jo._index_update_count
    assert o.num_update == jo.num_update == steps


def test_superstep_batchnorm_statistics_carry():
    net, tr, losses, _, _ = _super(mx, KW, 8, 4, bn=True)
    snet, str_, slosses = _single(mx, KW, 8, bn=True)
    assert losses == slosses
    _bitwise(_state(net, tr), _state(snet, str_))
    jnet, jtr, jlosses, _, _ = _super(jmx, {}, 8, 4, bn=True)
    _assert_states(_state(net, tr), _state(jnet, jtr), 1e-5)


def test_superstep_resolves_deferred_shapes_without_an_update():
    net, tr, losses, ss, _ = _super(mx, KW, 4, 4, deferred=True)
    snet, str_, slosses = _single(mx, KW, 4, deferred=True)
    assert losses == slosses
    assert tr.optimizer.num_update == 4
    _bitwise(_state(net, tr), _state(snet, str_))


@pytest.mark.parametrize("window,poison", [(2000, 1), (2, None)],
                         ids=["skip_mid_superstep", "growth_in_superstep"])
def test_superstep_fp16_scaler_per_iteration(window, poison):
    """An inf in slot 1 of 4 skips that iteration alone (the flags
    ``[0, 1, 0, 0]``, the scale halves inside the superstep); with
    window 2 the scale grows twice within one superstep; the counters
    equal the JAX package's, and the port's single steps bit for bit."""
    out = {}
    for m, kw in PKGS:
        net, tr, losses, ss, flags = _super(m, kw, 8, 4, "adam", "float16",
                                            poison=poison, window=window)
        s = tr._amp_loss_scaler
        out[m] = (s.loss_scale, s._unskipped, s.overflow_total, flags,
                  _state(net, tr), losses)
    snet, str_, _ = _single(mx, KW, 8, "adam", "float16", poison=poison,
                            window=window)
    s = str_._amp_loss_scaler
    assert out[mx][:3] == out[jmx][:3] == (s.loss_scale, s._unskipped,
                                          s.overflow_total)
    _bitwise(out[mx][4], _state(snet, str_))
    _assert_states(out[mx][4], out[jmx][4], TOL["float16"])
    if poison is not None:
        assert out[mx][3] == [[0.0, 1.0, 0.0, 0.0], [0.0] * 4]
        assert out[mx][:3] == (512.0, 6, 1)
        assert all(np.isfinite(v).all() for v in out[mx][4].values())
    else:
        assert out[mx][:3] == (1024.0 * 16, 0, 0)


def test_superstep_and_trainer_step_share_state():
    """2 single steps, a superstep of 4, 2 single steps again: momentum
    and Adam's t move through one store (bit for bit an 8-step single
    loop), and the trainer's plan keeps its states (not rebuilt)."""
    for opt in ("sgd", "adam"):
        net, tr, _ = _single(mx, KW, 2, opt)
        plan = tr._fused
        _super(mx, KW, 4, 4, opt, net=net, tr=tr, start=2)
        _single(mx, KW, 2, opt, net=net, tr=tr, start=6)
        assert tr._fused is plan
        snet, str_, _ = _single(mx, KW, 8, opt)
        _bitwise(_state(net, tr), _state(snet, str_))
        if opt == "adam":
            assert {int(st[2]) for st in tr._fused_states.values()} == {8}
            assert set(tr.optimizer._index_update_count.values()) == {8}


def test_superstep_migrates_eager_state_and_back():
    net, tr = _build(mx, KW, "sgd")
    mx.fusedstep.set_enabled(False)
    _single(mx, KW, 2, net=net, tr=tr)
    mx.fusedstep.set_enabled(True)
    _super(mx, KW, 4, 4, net=net, tr=tr, start=2)
    mx.fusedstep.set_enabled(False)
    _single(mx, KW, 2, net=net, tr=tr, start=6)
    mx.fusedstep.set_enabled(True)
    snet, str_ = _build(mx, KW, "sgd")
    mx.fusedstep.set_enabled(False)
    _single(mx, KW, 8, net=snet, tr=str_)
    mx.fusedstep.set_enabled(True)
    for (k, a), (_, b) in zip(
            sorted(net._collect_params_with_prefix().items()),
            sorted(snet._collect_params_with_prefix().items())):
        np.testing.assert_allclose(np32(a.data()), np32(b.data()),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_superstep_lr_schedule_per_iteration():
    """A FactorScheduler stepping every update: iteration i of a
    superstep takes lr(first_update + i), as the single steps do and as
    the JAX package's superstep does."""
    net, tr, losses, _, _ = _super(mx, KW, 8, 4, "sgd", sched=True)
    snet, str_, slosses = _single(mx, KW, 8, "sgd", sched=True)
    assert losses == slosses
    _bitwise(_state(net, tr), _state(snet, str_))
    jnet, jtr, jlosses, _, _ = _super(jmx, {}, 8, 4, "sgd", sched=True)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5, atol=1e-5)
    assert tr.optimizer.num_update == jtr.optimizer.num_update == 8


def test_unfusable_optimizer_and_disabled_flag_run_single_steps(caplog):
    mx.fusedstep.reset_fallback_log()
    net, tr = _build(mx, KW, "rmsprop")
    ss = mx.gluon.Superstep(net, _loss(mx), tr, k=2)
    with caplog.at_level(logging.WARNING):
        out = ss.step(*_stacked(mx, KW, 0, 2), 16)
    assert ss._plan is False and out.shape == (2,)
    assert any("superstep" in r.getMessage() and "rmsprop" in r.getMessage()
               for r in caplog.records)
    snet, str_, slosses = _single(mx, KW, 2, "rmsprop")
    assert np32(out).tolist() == slosses
    mx.fusedstep.set_enabled(False)
    net, tr = _build(mx, KW)
    ss = mx.gluon.Superstep(net, _loss(mx), tr, k=2)
    ss.step(*_stacked(mx, KW, 0, 2), 16)
    assert ss._plan is None and tr.optimizer.num_update == 2


def test_superstep_k_knob():
    prev = mx.fusedstep.set_superstep_k(3)
    try:
        assert mx.fusedstep.superstep_k() == 3
        net, tr = _build(mx, KW)
        assert mx.gluon.Superstep(net, _loss(mx), tr).k == 3
        assert mx.gluon.Superstep(net, _loss(mx), tr, k=5).k == 5
    finally:
        mx.fusedstep.set_superstep_k(prev)
    assert mx.fusedstep.superstep_k() == jmx.fusedstep.superstep_k() == 1


def _ring_batches(n):
    return [(np.full((2, 3), i, np.float32), np.full((2,), i, np.float32))
            for i in range(n)]


def test_ring_groups_and_tail_like_jax():
    out = {}
    for m in (jmx, mx):
        ring = m.gluon.data.SuperstepRing(_ring_batches(7), 3)
        got = [(n, np32(g[0]).shape if n == 3 else len(g))
               for g, n in ring]
        ring.close()
        out[m] = (got, ring.cursor)
    assert out[mx] == out[jmx] == ([(3, (3, 2, 3)), (3, (3, 2, 3)), (1, 1)],
                                   7)


def test_ring_error_contract():
    def source():
        yield from _ring_batches(4)
        raise ValueError("source broke")

    ring = mx.gluon.data.SuperstepRing(source(), 3)
    it = iter(ring)
    _, n = next(it)
    assert n == 3
    group, n = next(it)  # the staged batch before the error, short
    assert n == 1 and len(group) == 1
    with pytest.raises(ValueError, match="source broke"):
        next(it)
    ring.close()
    ring.close()

    def interrupted():
        yield _ring_batches(1)[0]
        raise KeyboardInterrupt

    ring = mx.gluon.data.SuperstepRing(interrupted(), 2)
    with pytest.raises(KeyboardInterrupt):
        next(iter(ring))
    ring.close()


def test_ring_wraps_an_existing_prefetcher():
    from mxnet_tpu_torch.gluon.data import DevicePrefetcher

    pf = DevicePrefetcher(_ring_batches(4), depth=4)
    ring = mx.gluon.data.SuperstepRing(pf, 2)
    assert [n for _, n in ring] == [2, 2]
    with pytest.raises(ValueError):
        mx.gluon.data.SuperstepRing(pf, 2, depth=3)


def test_stack_batches_structure_and_mismatch():
    stack = mx.gluon.data.stack_batches
    a = {"x": mx.nd.ones((2, 3), **KW), "meta": "s"}
    out = stack([a, a])
    assert out["x"].shape == (2, 2, 3) and out["meta"] == "s"
    with pytest.raises(ValueError, match="not shape/structure stable"):
        stack([mx.nd.ones((2, 3), **KW), mx.nd.ones((3, 3), **KW)])
    with pytest.raises(ValueError):
        stack([])


@pytest.mark.parametrize("ring_k", [2, 3], ids=["same_k", "ring_k_3"])
def test_run_with_a_dataloader_and_a_tail(ring_k):
    """``run`` over a DataLoader of 5 batches (list batches): the ring's
    own k decides what is a stacked group; equal bit for bit to the
    single-step loop over the same batches."""
    def loader(m, kw):
        xs = np.concatenate([np32(_batch(m, kw, i)[0]) for i in range(5)])
        ys = np.concatenate([np32(_batch(m, kw, i)[1]) for i in range(5)])
        ds = m.gluon.data.ArrayDataset(xs, ys)
        return m.gluon.data.DataLoader(ds, batch_size=16)

    net, tr = _build(mx, KW)
    ss = mx.gluon.Superstep(net, _loss(mx), tr, k=2)
    ring = mx.gluon.data.SuperstepRing(loader(mx, KW), ring_k)
    losses = ss.run(ring, 16)
    snet, str_, slosses = _single(mx, KW, 5)
    assert losses == slosses
    _bitwise(_state(net, tr), _state(snet, str_))
    jnet, jtr = _build(jmx, {})
    jloss = jmx.gluon.Superstep(jnet, _loss(jmx), jtr, k=2).run(
        jmx.gluon.data.SuperstepRing(loader(jmx, {}), ring_k), 16)
    np.testing.assert_allclose(losses, jloss, rtol=1e-5, atol=1e-5)


def test_spmd_run_superstep_matches_jax():
    out = {}
    for m, kw in PKGS:
        net = m.gluon.nn.HybridSequential()
        net.add(m.gluon.nn.Dense(16, activation="relu", in_units=8),
                m.gluon.nn.Dense(3, in_units=16))
        net.initialize(**kw)
        set_weights(m, net)
        step = m.parallel.SPMDTrainStep(net, _loss(m), "adam",
                                        {"wd": 0.01}, mesh=None)
        xs, ys = _stacked(m, kw, 0, 4)
        a = np32(step.run_superstep(xs, ys, lr=[0.01, 0.02, 0.03, 0.04]))
        b = np32(step.run_superstep(xs, ys, lr=0.01))
        step.sync_to_block()
        out[m] = (np.concatenate([a, b]), {k: np32(p.data()) for k, p in
                                           net._collect_params_with_prefix()
                                           .items()})
    np.testing.assert_allclose(out[mx][0], out[jmx][0], rtol=1e-5, atol=1e-5)
    for k, w in out[jmx][1].items():
        np.testing.assert_allclose(out[mx][1][k], w, rtol=1e-5, atol=1e-5)
    with pytest.raises(mx.MXNetError, match="lr must be"):
        step.run_superstep(xs, ys, lr=[0.1, 0.2])
    # a mesh must come from make_mesh; the superstep on a data axis of
    # several ranks runs in their world (tests/test_torch_tp.py), and a
    # process alone refuses a mesh of two ranks, as a single step does
    with pytest.raises(mx.MXNetError, match="make_mesh"):
        mx.parallel.SPMDTrainStep(net, _loss(mx), "adam", {}, mesh=object())
    dp2 = mx.parallel.make_mesh({"dp": 2}, devices=[0, 1])
    with pytest.raises(mx.MXNetError, match="join the world first"):
        mx.parallel.SPMDTrainStep(net, _loss(mx), "adam", {},
                                  mesh=dp2).run_superstep(xs, ys)
