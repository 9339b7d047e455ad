"""Port parity: the Trainer's fused multi-tensor update
(``optimizer/multi_tensor.py``, default path of ``Trainer.step`` and of
``SPMDTrainStep(mesh=None)``) against the port's per-parameter path and
against the JAX package's fused update, with ``save_states``/
``load_states`` across the two packages. Replays the cases of the
reference's ``tests/test_fused_step.py`` that a single device reaches.

Nets: an MLP of Dense layers (8 inputs, width 16, 3 classes) with the
same weights in both packages (numpy seed), softmax cross-entropy over a
batch of 16 from a numpy seed.

Tolerances: float32 weights within 1e-6 absolute and relative (``TOL``):
the two paths and the two packages evaluate the same element-wise update
in another order, on gradients that differ in summation order only.
bfloat16 weights under ``multi_precision`` within 2^-7 relative (one
bfloat16 step either way, each side rounding its own fp32 master).
Every JAX host array kept is a copy (the reference's fused update
donates its buffers).
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import logging

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon.utils import load_numpy

TOL = 1e-6
BF16_TOL = 2.0 ** -7
KW = {"ctx": mx.cpu()}
PKGS = ((jmx, {}), (mx, KW))


@pytest.fixture(autouse=True)
def _fused_on():
    prev = (jmx.fusedstep.set_enabled(True), mx.fusedstep.set_enabled(True))
    yield
    jmx.fusedstep.set_enabled(prev[0])
    mx.fusedstep.set_enabled(prev[1])


def _mlp(mxmod, kw, n_hidden=1, seed=0, width=16, in_units=8, classes=3):
    nn = mxmod.gluon.nn
    net = nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        for _ in range(n_hidden):
            net.add(nn.Dense(width, activation="relu", in_units=in_units))
            in_units = width
        net.add(nn.Dense(classes, in_units=in_units))
    net.initialize(**kw)
    rs = np.random.RandomState(seed)
    arrays = {k: (rs.randn(*p.shape) * 0.4).astype(np.float32)
              for k, p in sorted(net.collect_params().items())}
    if mxmod is mx:
        load_numpy(net.collect_params(), arrays)
    else:
        for k, p in net.collect_params().items():
            p.set_data(mxmod.nd.array(arrays[k]))
    return net


def _batch(mxmod, kw, dtype=None):
    x = mxmod.nd.array(np.random.RandomState(1).randn(16, 8)
                       .astype(np.float32), **kw)
    y = mxmod.nd.array(np.random.RandomState(2).randint(0, 3, (16,))
                       .astype(np.float32), **kw)
    return (x.astype(dtype) if dtype else x), y


def _weights(net):
    return [np.array(p.data().astype("float32").asnumpy())
            for _, p in sorted(net.collect_params().items())]


def _train(mxmod, kw, opt, params, steps=3, fused=True, net=None,
           before=None, dtype=None, trainer=None):
    """``steps`` Trainer steps; ``before(i, trainer, net)`` runs before
    step i; ``fused`` is the MXTPU_FUSED_STEP switch (or a function of
    the step)."""
    net = net or _mlp(mxmod, kw)
    if dtype:
        net.cast(dtype)
    tr = trainer or mxmod.gluon.Trainer(net.collect_params(), opt,
                                        dict(params), kvstore=None)
    loss_fn = mxmod.gluon.loss.SoftmaxCrossEntropyLoss()
    x, y = _batch(mxmod, kw, dtype)
    for i in range(steps):
        mxmod.fusedstep.set_enabled(fused(i) if callable(fused) else fused)
        if before is not None:
            before(i, tr, net)
        with mxmod.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        tr.step(16)
    mxmod.fusedstep.set_enabled(True)
    return _weights(net), tr, net


def _close(got, want, tol=TOL):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


def _sched(mxmod):
    return mxmod.lr_scheduler.FactorScheduler(step=1, factor=0.7)


def _mults(i, tr, net):
    if i == 0:
        for k, p in net.collect_params().items():
            if "bias" in k:
                p.lr_mult, p.wd_mult = 2.0, 0.0
            elif "dense0" in k:
                p.lr_mult, p.wd_mult = 0.5, 3.0


FUSED_CASES = {
    "sgd_momentum_wd": ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
                                "wd": 1e-3}, None),
    "sgd_clip": ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
                         "clip_gradient": 0.05}, None),
    "sgd_plain_mults": ("sgd", {"learning_rate": 0.1, "wd": 1e-2}, _mults),
    "sgd_scheduler": ("sgd", {"learning_rate": 0.2, "momentum": 0.9,
                              "lr_scheduler": _sched}, None),
    "nag": ("nag", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3,
                    "clip_gradient": 0.1}, _mults),
    "nag_plain": ("nag", {"learning_rate": 0.1}, None),
    "adam_wd": ("adam", {"learning_rate": 0.01, "wd": 0.01}, None),
    "adam_clip_mults": ("adam", {"learning_rate": 0.01, "wd": 0.01,
                                 "clip_gradient": 0.1}, _mults),
    "adam_scheduler_begin": ("adam", {"learning_rate": 0.01,
                                      "begin_num_update": 10000,
                                      "lr_scheduler": _sched}, None),
    "lamb": ("lamb", {"learning_rate": 0.01, "wd": 0.01}, None),
    "lamb_clip_mults_begin": ("lamb", {"learning_rate": 0.01, "wd": 0.01,
                                       "clip_gradient": 0.1,
                                       "begin_num_update": 5}, _mults),
}


def _params(mxmod, params):
    return {k: (v(mxmod) if callable(v) else v) for k, v in params.items()}


@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_matches_eager_and_jax(case):
    """sgd/nag/adam/lamb with clipping, lr_mult/wd_mult, a scheduler and
    begin_num_update: the port's fused update against its eager path
    and against the JAX package's fused update, 3 steps."""
    opt, params, before = FUSED_CASES[case]
    want, jtr, _ = _train(jmx, {}, opt, _params(jmx, params), before=before)
    got, ttr, _ = _train(mx, KW, opt, _params(mx, params), before=before)
    eager, etr, _ = _train(mx, KW, opt, _params(mx, params), before=before,
                           fused=False)
    assert isinstance(ttr._fused, dict) and isinstance(jtr._fused, dict)
    assert etr._fused is None and not etr._fused_states
    _close(got, eager)
    _close(got, want)
    o, jo = ttr.optimizer, jtr.optimizer
    assert o._index_update_count == jo._index_update_count
    assert o.num_update == jo.num_update == etr.optimizer.num_update
    if opt in ("adam", "lamb"):
        # the step leaf is kept as in the reference, int32
        for name, st in ttr._fused_states.items():
            jst = jtr._fused_states[name]
            assert st[2].dtype == torch.int32
            assert int(st[2]) == int(jst[2]) == o.num_update


def _foreach_calls(n_hidden, opt, params):
    net = _mlp(mx, KW, n_hidden=n_hidden)
    x, y = _batch(mx, KW)
    tr = mx.gluon.Trainer(net.collect_params(), opt, params)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def backward():
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()

    backward()
    tr.step(16)  # builds the plan
    backward()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.step(16)
    names = [e.name for e in prof.events()]
    assert isinstance(tr._fused, dict)
    assert len(tr._fused["active"]) == 2 * (n_hidden + 1)
    return sum(n.startswith("aten::_foreach_") for n in names)


@pytest.mark.parametrize("opt,params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3,
             "clip_gradient": 1.0}),
    ("adam", {"learning_rate": 0.01, "wd": 0.01}),
    ("lamb", {"learning_rate": 0.01, "wd": 0.01}),
], ids=["sgd", "adam", "lamb"])
def test_foreach_calls_constant_in_parameter_count(opt, params):
    """A 4-parameter and a 16-parameter net make the same number of
    ``torch._foreach_*`` calls per step (on the card each is one launch
    for the whole list)."""
    small = _foreach_calls(1, opt, params)
    large = _foreach_calls(7, opt, params)
    assert small == large > 0, (small, large)


@pytest.mark.parametrize("opt,params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01, "wd": 0.01}),
], ids=["sgd", "adam"])
def test_flip_fused_eager_fused_keeps_state(opt, params):
    """fused for 2 steps, eager for 2, fused for 2 again: the momentum and
    Adam's step count move with the state both ways, so the run equals an
    all-eager run and the JAX package's same flip."""
    flip = lambda i: i < 2 or i >= 4  # noqa: E731
    toggled, ttr, _ = _train(mx, KW, opt, params, steps=6, fused=flip)
    eager, _, _ = _train(mx, KW, opt, params, steps=6, fused=False)
    want, _, _ = _train(jmx, {}, opt, params, steps=6, fused=flip)
    assert isinstance(ttr._fused, dict)
    assert all(not hasattr(p, "_opt_state")
               for p in ttr._params)  # ownership moved back
    _close(toggled, eager)
    _close(toggled, want)


def test_flip_to_eager_midrun_keeps_momentum():
    mixed, _, _ = _train(mx, KW, "sgd", {"learning_rate": 0.1,
                                         "momentum": 0.9}, steps=6,
                         fused=lambda i: i < 3)
    eager, _, _ = _train(mx, KW, "sgd", {"learning_rate": 0.1,
                                         "momentum": 0.9}, steps=6,
                         fused=False)
    _close(mixed, eager)


def test_freezing_param_midrun_rebuilds_plan():
    """grad_req='null' after 3 steps: the plan rebuilds without that
    parameter, which stays bit for bit, and the rest matches eager."""
    snaps, plans = {}, []

    def freeze(i, tr, net):
        if i == 3:
            p = net.collect_params()["mlp_dense0_weight"]
            p.grad_req = "null"
            snaps[tr] = np.array(p.data().asnumpy())
        plans.append(tr._fused)

    out = []
    for fused in (True, False):
        w, tr, net = _train(mx, KW, "sgd", {"learning_rate": 0.1,
                                            "momentum": 0.9}, steps=6,
                            fused=fused, before=freeze)
        frozen = net.collect_params()["mlp_dense0_weight"].data().asnumpy()
        np.testing.assert_array_equal(frozen, snaps[tr])
        out.append(w)
        if fused:
            assert plans[4] is not plans[3] and isinstance(plans[4], dict)
            assert len(tr._fused["active"]) == 3
    _close(out[0], out[1])


def test_set_learning_rate_does_not_rebuild_valid_plan():
    plans = []

    def lr_step(i, tr, net):
        if i:
            tr.set_learning_rate(0.1 / (i + 1))
        plans.append(tr._fused)

    got, tr, _ = _train(mx, KW, "sgd", {"learning_rate": 0.1,
                                        "momentum": 0.9}, steps=4,
                        before=lr_step)
    assert plans[1] is plans[2] is plans[3] is tr._fused
    want, _, _ = _train(jmx, {}, "sgd", {"learning_rate": 0.1,
                                         "momentum": 0.9}, steps=4,
                        before=lr_step)
    _close(got, want)


def test_mutating_trace_constant_hyper_rebuilds_plan():
    plans = []

    def mutate(i, tr, net):
        if i == 2:
            tr._optimizer.momentum = 0.5
        plans.append(tr._fused)

    got, tr, _ = _train(mx, KW, "sgd", {"learning_rate": 0.05,
                                        "momentum": 0.9}, steps=4,
                        before=mutate)
    eager, _, _ = _train(mx, KW, "sgd", {"learning_rate": 0.05,
                                         "momentum": 0.9}, steps=4,
                         before=mutate, fused=False)
    assert tr._fused is not plans[2] and tr._fused["hyper"]["momentum"] == 0.5
    _close(got, eager)


def test_unsupported_optimizer_falls_back_and_logs_once(caplog):
    mx.fusedstep.reset_fallback_log()
    with caplog.at_level(logging.WARNING, logger="mxnet_tpu_torch.fusedstep"):
        w, tr, _ = _train(mx, KW, "rmsprop", {"learning_rate": 0.01})
        eager, _, _ = _train(mx, KW, "rmsprop", {"learning_rate": 0.01},
                             fused=False)
        _train(mx, KW, "lamb", {"learning_rate": 0.01, "lower_bound": 0.1})
    assert tr._fused is False  # a cached verdict, looked at no more
    msgs = [r.getMessage() for r in caplog.records]
    assert sum("optimizer 'rmsprop'" in m for m in msgs) == 1, msgs
    assert sum("lamb with bounds" in m for m in msgs) == 1, msgs
    _close(w, eager)
    want, _, _ = _train(jmx, {}, "rmsprop", {"learning_rate": 0.01})
    _close(w, want)


def test_sparse_and_gradless_parameters_fall_back():
    p = mx.gluon.Parameter("w", shape=(4, 3), grad_stype="row_sparse")
    p.initialize(ctx=mx.cpu())
    tr = mx.gluon.Trainer([p], "sgd", {"learning_rate": 0.1})
    assert tr._fused_setup() is False
    q = mx.gluon.Parameter("q", shape=(4, 3))
    q.initialize(ctx=mx.cpu())
    q.data()._grad = None
    tr = mx.gluon.Trainer([q], "sgd", {"learning_rate": 0.1})
    assert tr._fused_setup() is False


def test_deferred_init_does_not_disable_fused():
    nn = mx.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(8, activation="relu"), nn.Dense(2))
    net.initialize(ctx=mx.cpu())
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1})
    assert tr._fused_setup() is False and tr._fused is None
    x = mx.nd.ones((4, 8), ctx=mx.cpu())
    for _ in range(2):
        with mx.autograd.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        tr.step(4)
    assert isinstance(tr._fused, dict)


def test_reinitialized_parameter_rebuilds_plan():
    """A re-initialized parameter gets a new handle: the plan must not
    keep updating the old one."""
    plans = []

    def reinit(i, tr, net):
        if i == 2:
            net.collect_params()["mlp_dense1_bias"].initialize(
                ctx=mx.cpu(), force_reinit=True)
        plans.append(tr._fused)

    _, tr, net = _train(mx, KW, "sgd", {"learning_rate": 0.1}, steps=3,
                        before=reinit)
    assert tr._fused is not plans[2]
    h = net.collect_params()["mlp_dense1_bias"].data()
    assert any(t is h for t in tr._fused["handles"])


SAVE_CASES = [(src, path, opt) for src in ("jax", "port")
              for path in ("fused", "eager") for opt in ("adam", "sgd")]


@pytest.mark.parametrize("src,path,opt", SAVE_CASES,
                         ids=[f"{s}-{p}-{o}" for s, p, o in SAVE_CASES])
def test_save_states_load_states_across_packages(tmp_path, src, path, opt):
    """2 steps in one package (on its fused or eager path), save_states;
    the other package takes the weights and load_states, and its third
    step (fused) gives the weights of the saver's own third step."""
    params = {"adam": {"learning_rate": 0.01, "wd": 0.01},
              "sgd": {"learning_rate": 0.1, "momentum": 0.9}}[opt]
    saver, loader = (PKGS if src == "jax" else PKGS[::-1])
    (smx, skw), (lmx, lkw) = saver, loader
    fname = str(tmp_path / "trainer.states")
    _, str_, snet = _train(smx, skw, opt, params, steps=2,
                           fused=path == "fused")
    str_.save_states(fname)
    w2 = {k: np.array(p.data().asnumpy())
          for k, p in snet.collect_params().items()}
    want, _, _ = _train(smx, skw, opt, params, steps=1, net=snet,
                        trainer=str_, fused=path == "fused")
    lnet = _mlp(lmx, lkw)
    for k, p in lnet.collect_params().items():
        p.set_data(lmx.nd.array(w2[k], **lkw))
    ltr = lmx.gluon.Trainer(lnet.collect_params(), opt, dict(params),
                            kvstore=None)
    ltr.load_states(fname)
    assert ltr._fused is None
    assert ltr.optimizer.num_update == 2
    got, _, _ = _train(lmx, lkw, opt, params, steps=1, net=lnet,
                       trainer=ltr)
    _close(got, want)


def test_load_states_clears_stale_eager_state(tmp_path):
    fname = str(tmp_path / "s.states")
    _, tr, net = _train(mx, KW, "sgd", {"learning_rate": 0.1,
                                        "momentum": 0.9}, steps=2)
    tr.save_states(fname)
    p = next(iter(net.collect_params().values()))
    p._opt_state = mx.nd.zeros(p.shape, ctx=mx.cpu())
    tr.load_states(fname)
    assert not hasattr(p, "_opt_state") and p.name in tr._fused_states
    other = mx.gluon.Trainer([p], "sgd", {"learning_rate": 0.1})
    with pytest.raises(mx.MXNetError, match="model structure differs"):
        other.load_states(fname)


def _bf16_updates(mxmod, kw, opt, params, grads):
    """3 Trainer steps of a bfloat16 net on the given gradients, written
    into the gradient buffers (the update alone: a backward in bfloat16
    rounds differently in each package)."""
    net = _mlp(mxmod, kw)
    net.cast("bfloat16")
    tr = mxmod.gluon.Trainer(net.collect_params(), opt, dict(params),
                             kvstore=None)
    items = sorted(net.collect_params().items())
    for step in grads:
        for (_, p), g in zip(items, step):
            p.grad()._set_data(mxmod.nd.array(g, **kw).astype(
                "bfloat16").data)
        tr.step(16)
    return _weights(net), tr, net


@pytest.mark.parametrize("opt,params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01, "wd": 0.01}),
], ids=["sgd", "adam"])
def test_multi_precision_bf16_fused_matches_jax(opt, params):
    """A bfloat16 net (``Block.cast``) with ``multi_precision``: the fused
    update keeps fp32 masters as state leaf 0 and every weight is its
    master rounded. On the same bfloat16 gradients the masters agree
    with the JAX package's within ``TOL`` and the weights within 2^-7
    relative; through a backward, the fused run agrees with the port's
    eager run."""
    params = dict(params, multi_precision=True)
    rs = np.random.RandomState(3)
    shapes = [p.shape for _, p in sorted(_mlp(mx, KW).collect_params()
                                         .items())]
    grads = [[(rs.randn(*s) * 4).astype(np.float32) for s in shapes]
             for _ in range(3)]
    got, tr, net = _bf16_updates(mx, KW, opt, params, grads)
    want, jtr, _ = _bf16_updates(jmx, {}, opt, params, grads)
    assert isinstance(tr._fused, dict) and isinstance(jtr._fused, dict)
    for k, p in net.collect_params().items():
        master = tr._fused_states[k][0]
        assert master.dtype == torch.float32
        assert p.data().data.dtype == torch.bfloat16
        assert torch.equal(p.data().data, master.to(torch.bfloat16))
        np.testing.assert_allclose(
            master.numpy(), np.array(jtr._fused_states[k][0]), rtol=TOL,
            atol=TOL)
    _close(got, want, BF16_TOL)
    fused, _, _ = _train(mx, KW, opt, params, dtype="bfloat16")
    eager, _, _ = _train(mx, KW, opt, params, dtype="bfloat16", fused=False)
    _close(fused, eager, BF16_TOL)


@pytest.mark.parametrize("opt,hyper", [
    ("sgd", {"momentum": 0.9, "wd": 1e-3}),
    ("nag", {"momentum": 0.9, "wd": 1e-3}),
    ("adam", {"wd": 0.01}),
    ("adamw", {"beta1": 0.8}),
    ("lamb", {"wd": 0.01}),
])
def test_spmd_step_fused_matches_per_parameter(opt, hyper):
    """SPMDTrainStep(mesh=None): the multi-tensor update (the default)
    against the per-parameter rules (MXTPU_FUSED_STEP=0), 3 steps. The
    weights after the first step within ``TOL``, and after the third for
    SGD and NAG; the losses within 1e-5 relative. The rules compute
    Adam's and LAMB's bias correction in float32 on the device, as the
    JAX package's do, the multi-tensor update in double on the host, so
    their first step differs by up to 6.4e-6 relative (1 - 0.999 in
    float32); from the second step on, gradients near zero, which Adam
    normalises to steps of about lr, carry that difference on."""
    out = []
    for fused in (True, False):
        mx.fusedstep.set_enabled(fused)
        net = _mlp(mx, KW)
        x, y = _batch(mx, KW)
        step = mx.parallel.SPMDTrainStep(
            net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), opt, hyper)
        losses = [step(x, y, lr=0.05)]
        step.sync_to_block()
        first = _weights(net)
        losses += [step(x, y, lr=0.05) for _ in range(2)]
        step.sync_to_block()
        out.append((losses, first, _weights(net)))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-5)
    _close(out[0][1], out[1][1])
    if opt in ("sgd", "nag"):
        _close(out[0][2], out[1][2])


@pytest.mark.parametrize("opt,params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3,
             "clip_gradient": 0.05}),
    ("adam", {"learning_rate": 0.01, "wd": 0.01}),
    ("lamb", {"learning_rate": 0.01, "wd": 0.01}),
], ids=["sgd", "adam", "lamb"])
def test_fused_update_on_cuda_matches_cpu_on_cuda(opt, params):
    """On the card (the ``_foreach_*`` ops' multi-tensor kernels) the
    fused update gives the CPU's weights on the same gradients (the
    CPU's, written into the card's buffers), within ``TOL``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gpu = {"ctx": mx.gpu(0)}
    nets = [_mlp(mx, kw) for kw in (KW, gpu)]
    trs = [mx.gluon.Trainer(n.collect_params(), opt, dict(params))
           for n in nets]
    x, y = _batch(mx, KW)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    for _ in range(3):
        with mx.autograd.record():
            loss = loss_fn(nets[0](x), y)
        loss.backward()
        for (k, p), q in zip(sorted(nets[0].collect_params().items()),
                             [q for _, q in sorted(
                                 nets[1].collect_params().items())]):
            q.grad()._set_data(p.grad().data.to(q.data().data.device))
        for tr in trs:
            tr.step(16)
    assert isinstance(trs[1]._fused, dict)
    _close(_weights(nets[1]), _weights(nets[0]))
