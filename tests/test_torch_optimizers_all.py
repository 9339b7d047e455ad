"""Port parity: every optimizer of ``mxnet_tpu_torch.optimizer`` and the
arguments the reference's ``Optimizer`` and ``Trainer`` take (C5),
against the JAX package on the same numpy inputs.

- Each registered optimizer: 3 updates through
  ``create_state_multi_precision``/``update_multi_precision`` with weight
  decay, gradient rescaling and clipping, against the reference's.
- SGLD: its noise comes from each package's own generator, so it is
  judged by its moments over a seeded draw: with a zero gradient the step
  is pure noise of standard deviation sqrt(lr).
- C5: ``param_idx2name`` with ``set_lr_mult``/``set_wd_mult`` by name, an
  ``lr_scheduler``, ``sym``, ``begin_num_update``, ``multi_precision``,
  ``lazy_update`` and ``learning_rate``/``set_learning_rate``; the
  Trainer's ``kvstore``/``update_on_kvstore`` on one device, its
  ``learning_rate``/``optimizer``/``set_learning_rate`` members, and what
  one device cannot honour raising.
- The cases of the reference's ``tests/test_optimizer.py``, replayed
  through both packages.

Tolerance: 1e-6 absolute and relative in float32 (``TOL``, as
``test_torch_optimizer.py``): each update is a handful of element-wise
float32 operations evaluated in another order on each side. float16
masters: the master within ``TOL``, the weight within one float16 step
(2^-10 relative). The JAX package's CPU ``asnumpy`` can alias a buffer a
later update replaces: every host array kept is a copy.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

TOL = 1e-6
KW = {"ctx": mx.cpu()}

OPT_CASES = {
    "nag": ("nag", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
    "nag_plain": ("nag", dict(learning_rate=0.1, wd=0.01)),
    "signum": ("signum", dict(learning_rate=0.01, wd=0.01, wd_lh=0.1)),
    "signum_plain": ("signum", dict(learning_rate=0.01, momentum=0.0,
                                    wd=0.01)),
    "adamw": ("adamw", dict(learning_rate=0.01, wd=0.05)),
    "adagrad": ("adagrad", dict(learning_rate=0.1, wd=0.01)),
    "adadelta": ("adadelta", dict(wd=0.01, rho=0.8)),
    "rmsprop": ("rmsprop", dict(learning_rate=0.01, wd=0.01,
                                clip_weights=0.9)),
    "rmsprop_centered": ("rmsprop", dict(learning_rate=0.01, wd=0.01,
                                         centered=True)),
    "ftrl": ("ftrl", dict(learning_rate=0.1, wd=0.01, lamda1=0.05)),
    "ftml": ("ftml", dict(learning_rate=0.1, wd=0.01)),
    "lars": ("lars", dict(learning_rate=0.5, wd=0.01)),
    "lars_momentum": ("lars", dict(learning_rate=0.5, momentum=0.9,
                                   wd=0.01)),
    "lamb": ("lamb", dict(learning_rate=0.05, wd=0.01)),
    "lamb_bounds": ("lamb", dict(learning_rate=0.05, wd=0.01,
                                 lower_bound=0.5, upper_bound=1.5,
                                 bias_correction=False)),
    "dcasgd": ("dcasgd", dict(learning_rate=0.1, wd=0.01)),
    "dcasgd_momentum": ("dcasgd", dict(learning_rate=0.1, momentum=0.9,
                                       wd=0.01)),
    "groupadagrad": ("groupadagrad", dict(learning_rate=0.1)),
    "lbsgd": ("lbsgd", dict(learning_rate=0.5, momentum=0.9, wd=0.01,
                            warmup_epochs=1, updates_per_epoch=4,
                            batch_scale=4)),
    "lbsgd_sqrt": ("lbsgd", dict(learning_rate=0.5, wd=0.01,
                                 warmup_strategy="sqrt", warmup_epochs=1,
                                 updates_per_epoch=2)),
    "sgd": ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01,
                        lazy_update=True)),
    "adam": ("adam", dict(learning_rate=0.01, wd=0.01, lazy_update=True)),
}
PRE = dict(rescale_grad=0.5, clip_gradient=1.5)


def _updates(mxmod, name, kwargs, w0, grads, kw, dtype=None):
    opt = mxmod.optimizer.create(name, **kwargs)
    w = mxmod.nd.array(w0, **kw)
    if dtype is not None:
        w = w.astype(dtype)
    state = opt.create_state_multi_precision(0, w)
    for g in grads:
        gnd = mxmod.nd.array(g, **kw)
        opt.update_multi_precision(
            0, w, gnd.astype(dtype) if dtype else gnd, state)
    return np.array(w.astype("float32").asnumpy()), opt, state


def _arrays(seed, shape=(5, 4), n=3):
    rs = np.random.RandomState(seed)
    return (rs.randn(*shape).astype(np.float32),
            [rs.randn(*shape).astype(np.float32) * 2 for _ in range(n)])


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_three_updates_match_jax(case):
    name, kwargs = OPT_CASES[case]
    kwargs = dict(kwargs, **PRE)
    w0, grads = _arrays(0)
    want, jopt, _ = _updates(jmx, name, kwargs, w0, grads, {})
    got, topt, _ = _updates(mx, name, kwargs, w0, grads, KW)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert topt.num_update == jopt.num_update == 3


def test_every_registered_optimizer_is_covered():
    from mxnet_tpu.optimizer.optimizer import _OPT_REGISTRY
    from mxnet_tpu_torch.optimizer.optimizer import _REGISTRY

    assert sorted(_REGISTRY) == sorted(_OPT_REGISTRY)
    covered = {name for name, _ in OPT_CASES.values()} | {"sgld"}
    assert covered == set(_REGISTRY)


def test_sgld_noise_moments_match_jax():
    """lr 0.04, zero gradient and wd: the update is noise of standard
    deviation 0.2; over 40000 draws the sample mean lies within 4.5e-3
    (4.5 standard errors) of 0 and the standard deviation within 2% of
    0.2, in both packages."""
    lr, n = 0.04, 40000
    out = {}
    for mxmod, kw in ((jmx, {}), (mx, KW)):
        if mxmod is jmx:
            jmx.random.seed(3)
        opt = mxmod.optimizer.create("sgld", learning_rate=lr)
        w = mxmod.nd.array(np.zeros(n, np.float32), **kw)
        opt.update(0, w, mxmod.nd.array(np.zeros(n, np.float32), **kw),
                   None)
        out[mxmod.__name__] = np.array(w.asnumpy())
    for step in out.values():
        assert abs(step.mean()) < 4.5e-3
        assert abs(step.std() / lr ** 0.5 - 1) < 0.02
    # the half gradient step is the reference's term for term: two draws
    # from the same seed, with and without the gradient
    w0, grads = _arrays(4)
    ws = []
    for g in (grads[0], np.zeros_like(grads[0])):
        torch.manual_seed(7)
        opt = mx.optimizer.create("sgld", learning_rate=lr)
        w = mx.nd.array(w0, **KW)
        opt.update(0, w, mx.nd.array(g, **KW), None)
        ws.append(w.asnumpy())
    np.testing.assert_allclose(ws[0] - ws[1], -lr / 2 * grads[0],
                               rtol=1e-5, atol=1e-6)


def test_sgld_generator_is_explicit_and_seeded():
    draws = []
    for seed in (5, 5, 6):
        torch.manual_seed(seed)
        opt = mx.optimizer.create("sgld", learning_rate=0.01)
        torch.randn(3)  # the global stream moves; the optimizer's does not
        w = mx.nd.array(np.zeros(8, np.float32), **KW)
        opt.update(0, w, mx.nd.array(np.zeros(8, np.float32), **KW), None)
        draws.append(w.asnumpy())
        assert opt._generator(w.data.device).initial_seed() == seed
    np.testing.assert_array_equal(draws[0], draws[1])
    assert not np.array_equal(draws[0], draws[2])


@pytest.mark.parametrize("name", ["sgd", "adam", "nag"])
def test_multi_precision_float16_matches_jax(name):
    """``multi_precision`` keeps an fp32 master of a float16 weight."""
    kwargs = dict(learning_rate=0.05, momentum=0.9, multi_precision=True) \
        if name != "adam" else dict(learning_rate=0.05,
                                    multi_precision=True)
    w0, grads = _arrays(5)
    want, _, jst = _updates(jmx, name, kwargs, w0, grads, {}, "float16")
    got, _, tst = _updates(mx, name, kwargs, w0, grads, KW, "float16")
    assert tst[0].dtype == np.float32
    np.testing.assert_allclose(tst[0].asnumpy(),
                               np.array(jst[0].asnumpy()), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got, want, rtol=2.0 ** -10, atol=0)


def test_optimizer_arguments_of_the_reference():
    """C5 through both packages: ``param_idx2name`` with multipliers set
    by name, an ``lr_scheduler`` (``base_lr`` from ``learning_rate``),
    ``sym``, ``begin_num_update``, ``multi_precision=False`` and
    ``lazy_update``: the same weights after 3 updates of two indices."""
    w0, grads = _arrays(6)
    out = []
    for mxmod, kw in ((jmx, {}), (mx, KW)):
        sched = mxmod.lr_scheduler.FactorScheduler(step=1, factor=0.5)
        opt = mxmod.optimizer.create(
            "sgd", learning_rate=0.2, momentum=0.9, wd=0.01,
            param_idx2name={0: "w", 1: "b"}, lr_scheduler=sched, sym=None,
            begin_num_update=4, multi_precision=False, lazy_update=True)
        opt.set_lr_mult({"w": 0.5})
        opt.set_wd_mult({"b": 0.0})
        assert sched.base_lr == 0.2 and opt.num_update == 4
        ws = [mxmod.nd.array(w0, **kw), mxmod.nd.array(w0 * 2, **kw)]
        states = [opt.create_state_multi_precision(i, w)
                  for i, w in enumerate(ws)]
        for g in grads:
            for i, w in enumerate(ws):
                opt.update_multi_precision(i, w, mxmod.nd.array(g, **kw),
                                           states[i])
        out.append(([np.array(w.asnumpy()) for w in ws], opt.num_update,
                    opt.learning_rate, opt._get_lr(0), opt._get_wd(1)))
    (jw, jn, jlr, jlr0, jwd1), (tw, tn, tlr, tlr0, twd1) = out
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    assert (tn, tlr, tlr0, twd1) == (jn, jlr, jlr0, jwd1) and tn == 7


def test_learning_rate_and_set_learning_rate():
    for mxmod in (jmx, mx):
        opt = mxmod.optimizer.create("adam", learning_rate=0.1)
        assert opt.learning_rate == 0.1
        opt.set_learning_rate(0.05)
        assert opt.learning_rate == 0.05 and opt.lr == 0.05
        sched = mxmod.lr_scheduler.FactorScheduler(step=1, factor=0.5)
        opt = mxmod.optimizer.create("sgd", learning_rate=1.0,
                                     lr_scheduler=sched)
        with pytest.raises(mxmod.MXNetError, match="lr_scheduler"):
            opt.set_learning_rate(0.1)


def _dense_pair(seed=1):
    rs = np.random.RandomState(seed)
    x = rs.randn(6, 4).astype(np.float32)
    w0 = rs.randn(3, 4).astype(np.float32)
    b0 = rs.randn(3).astype(np.float32)
    nets = []
    for mxmod, kw in ((jmx, {}), (mx, KW)):
        net = mxmod.gluon.nn.Dense(3, in_units=4, prefix="d_")
        net.initialize(**kw)
        net.weight.set_data(mxmod.nd.array(w0, **kw))
        net.bias.set_data(mxmod.nd.array(b0, **kw))
        nets.append(net)
    return x, nets


TRAINER_ARGS = {
    "kvstore_none": ("sgd", {"learning_rate": 0.1},
                     dict(kvstore=None, update_on_kvstore=False)),
    "kvstore_device": ("sgd", {"learning_rate": 0.1},
                       dict(kvstore="device", update_on_kvstore=False)),
    "kvstore_local": ("adam", {"learning_rate": 0.01},
                      dict(kvstore="local")),
    "momentum_lazy": ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
                              "lazy_update": True}, {}),
    "multi_precision_false": ("adam", {"learning_rate": 0.01,
                                       "multi_precision": False},
                              dict(kvstore=None)),
    "begin_num_update": ("adam", {"learning_rate": 0.01,
                                  "begin_num_update": 0}, {}),
    "begin_num_update_warm": ("adam", {"learning_rate": 0.01,
                                       "begin_num_update": 100}, {}),
}


@pytest.mark.parametrize("case", list(TRAINER_ARGS))
def test_trainer_arguments_match_jax(case):
    """C5's inputs: the Trainer and optimizer arguments ``bench.py``
    passes run on the port and give the reference's weights after 3
    steps."""
    name, params, tkw = TRAINER_ARGS[case]
    x, nets = _dense_pair()
    out = []
    for (mxmod, kw), net in zip(((jmx, {}), (mx, KW)), nets):
        trainer = mxmod.gluon.Trainer(net.collect_params(), name,
                                      dict(params), **tkw)
        for _ in range(3):
            with mxmod.autograd.record():
                loss = (net(mxmod.nd.array(x, **kw)) ** 2).sum()
            loss.backward()
            trainer.step(x.shape[0])
        out.append((np.array(net.weight.data().asnumpy()),
                    np.array(net.bias.data().asnumpy())))
    for got, want in zip(out[1], out[0]):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_trainer_members_match_jax():
    x, nets = _dense_pair(2)
    got = []
    for (mxmod, kw), net in zip(((jmx, {}), (mx, KW)), nets):
        tr = mxmod.gluon.Trainer(net.collect_params(), "sgd",
                                 {"learning_rate": 0.1, "momentum": 0.9})
        assert isinstance(tr.optimizer, mxmod.optimizer.SGD)
        assert tr.learning_rate == 0.1
        for i in range(4):
            if i == 2:
                tr.set_learning_rate(0.01)
            with mxmod.autograd.record():
                loss = (net(mxmod.nd.array(x, **kw)) ** 2).sum()
            loss.backward()
            tr.step(x.shape[0])
        assert tr.learning_rate == tr.optimizer.lr == 0.01
        got.append(np.array(net.weight.data().asnumpy()))
    np.testing.assert_allclose(got[1], got[0], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kwargs", [
    {"kvstore": "dist_sync"},
    {"kvstore": "dist_device_sync"},
    {"kvstore": object()},
    {"compression_params": {"type": "2bit", "threshold": 0.5}},
], ids=["dist_sync", "dist_device_sync", "store_object", "compression"])
def test_what_one_device_cannot_honour_raises(kwargs):
    """What needed several devices now makes a store (a ``dist*`` name in
    a world of one is ``dist_tpu_sync``, whose sums are the identity; a
    store object is used as given; ``compression_params`` reach the
    store) and trains as the JAX package's Trainer does."""
    x, (jnet, net) = _dense_pair()
    jkw = dict(kwargs)
    if "kvstore" in kwargs and not isinstance(kwargs["kvstore"], str):
        kwargs = {"kvstore": mx.kv.create("dist_tpu_sync")}
        jkw = {"kvstore": jmx.kv.create("dist_tpu_sync")}
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1}, **kwargs)
    jtr = jmx.gluon.Trainer(jnet.collect_params(), "sgd",
                            {"learning_rate": 0.1}, **jkw)
    for mxmod, trainer, n, kw in ((jmx, jtr, jnet, {}), (mx, tr, net, KW)):
        with mxmod.autograd.record():
            loss = (n(mxmod.nd.array(x, **kw)) ** 2).sum()
        loss.backward()
        trainer.step(x.shape[0])
    # one context: a store only for a dist name or a store object, in
    # both packages alike
    assert type(tr._kvstore).__name__ == type(jtr._kvstore).__name__
    assert (tr._kvstore is None) == ("compression_params" in kwargs)
    np.testing.assert_allclose(net.weight.data().asnumpy(),
                               np.array(jnet.weight.data().asnumpy()),
                               rtol=TOL, atol=TOL)


def test_multi_device_parameter_raises():
    """A parameter on two contexts is accepted (the store sums over
    them); contexts that differ between parameters still raise, as in the
    JAX package."""
    p = mx.gluon.Parameter("w", shape=(4, 0), allow_deferred_init=True)
    p.initialize(ctx=[mx.cpu(0), mx.cpu(1)])
    tr = mx.gluon.Trainer([p], "sgd", {"learning_rate": 0.1})
    assert tr._contexts == [mx.cpu(0), mx.cpu(1)]
    q = mx.gluon.Parameter("v", shape=(4, 0), allow_deferred_init=True)
    q.initialize(ctx=[mx.cpu(0)])
    with pytest.raises(mx.MXNetError, match="same contexts"):
        mx.gluon.Trainer([p, q], "sgd", {"learning_rate": 0.1})


# ---------------------------------------------------------------------------
# the reference's tests/test_optimizer.py, through both packages
# ---------------------------------------------------------------------------

QUADRATIC = [
    ("sgd", {"learning_rate": 0.1}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.1}),
    ("adamw", {"learning_rate": 0.1, "wd": 0.01}),
    ("adagrad", {"learning_rate": 0.5}),
    ("adadelta", {}),
    ("rmsprop", {"learning_rate": 0.05}),
    ("rmsprop", {"learning_rate": 0.05, "centered": True}),
    ("ftrl", {"learning_rate": 0.5}),
    ("ftml", {"learning_rate": 0.1}),
    ("lamb", {"learning_rate": 0.05}),
    ("lars", {"learning_rate": 0.5}),
    ("signum", {"learning_rate": 0.01}),
    ("dcasgd", {"learning_rate": 0.1}),
]


@pytest.mark.parametrize("name,kwargs", QUADRATIC,
                         ids=[f"{n}{i}" for i, (n, _) in
                              enumerate(QUADRATIC)])
def test_all_optimizers_decrease_quadratic_like_jax(name, kwargs):
    """f(w) = w^2 / 2 from w = 3, 50 updates with grad = w: every rule
    descends, and the port's trajectory is the reference's (relative
    1e-5 after 50 steps: float32 rounding compounds)."""
    finals = []
    for mxmod, kw in ((jmx, {}), (mx, KW)):
        opt = mxmod.optimizer.create(name, rescale_grad=1.0, **kwargs)
        w = mxmod.nd.array([3.0], **kw)
        state = opt.create_state_multi_precision(0, w)
        for _ in range(50):
            g = mxmod.nd.array([float(np.array(w.asnumpy())[0])], **kw)
            opt.update_multi_precision(0, w, g, state)
        finals.append(float(np.array(w.asnumpy())[0]))
    assert abs(finals[1]) < 2.95, f"{name} did not descend: {finals[1]}"
    np.testing.assert_allclose(finals[1], finals[0], rtol=1e-5, atol=1e-6)


def test_small_cases_of_the_reference():
    """test_sgd_momentum_formula, test_sgd_wd, test_adam_first_step,
    test_clip_gradient, test_lr_scheduler_in_optimizer,
    test_create_registry, test_updater and test_lr_wd_mult."""
    o = mx.optimizer.SGD(learning_rate=0.1, momentum=0.9, rescale_grad=1.0)
    w = mx.nd.array([1.0], **KW)
    st = o.create_state(0, w)
    o.update(0, w, mx.nd.array([0.5], **KW), st)
    np.testing.assert_allclose(w.asnumpy(), [0.95], rtol=1e-6)
    o.update(0, w, mx.nd.array([0.5], **KW), st)
    np.testing.assert_allclose(w.asnumpy(), [0.855], rtol=1e-6)
    o = mx.optimizer.SGD(learning_rate=0.1, wd=0.1, rescale_grad=1.0)
    w = mx.nd.array([1.0], **KW)
    o.update(0, w, mx.nd.array([0.0], **KW), None)
    np.testing.assert_allclose(w.asnumpy(), [0.99], rtol=1e-6)
    o = mx.optimizer.Adam(learning_rate=0.001, rescale_grad=1.0)
    w = mx.nd.array([1.0], **KW)
    o.update(0, w, mx.nd.array([1.0], **KW), o.create_state(0, w))
    assert abs(float(w.asnumpy()[0]) - 0.999) < 1e-5
    o = mx.optimizer.SGD(learning_rate=1.0, clip_gradient=0.1,
                         rescale_grad=1.0)
    w = mx.nd.array([0.0], **KW)
    o.update(0, w, mx.nd.array([100.0], **KW), None)
    np.testing.assert_allclose(w.asnumpy(), [-0.1], rtol=1e-6)
    sched = mx.lr_scheduler.MultiFactorScheduler(step=[2, 4], factor=0.1)
    o = mx.optimizer.SGD(learning_rate=1.0, lr_scheduler=sched)
    w = mx.nd.array([0.0], **KW)
    for _ in range(6):
        o.update(0, w, mx.nd.array([0.0], **KW), None)
    assert o.learning_rate < 1.0
    assert isinstance(mx.optimizer.create("sgd"), mx.optimizer.SGD)
    with pytest.raises(mx.MXNetError):
        mx.optimizer.create("definitely_not_an_optimizer")
    o = mx.optimizer.SGD(learning_rate=1.0)
    o.set_lr_mult({0: 0.1})
    assert o._get_lr(0) == pytest.approx(0.1)
    assert o._get_lr(1) == pytest.approx(1.0)


def test_updater_matches_jax_and_round_trips_its_states():
    w0, grads = _arrays(8)
    out = []
    for mxmod, kw in ((jmx, {}), (mx, KW)):
        upd = mxmod.optimizer.get_updater(mxmod.optimizer.create(
            "adam", learning_rate=0.01))
        w = mxmod.nd.array(w0, **kw)
        for g in grads[:2]:
            upd(0, mxmod.nd.array(g, **kw), w)
        out.append((upd, w))
    (jupd, jw), (tupd, tw) = out
    np.testing.assert_allclose(tw.asnumpy(), np.array(jw.asnumpy()),
                               rtol=TOL, atol=TOL)
    blob = tupd.get_states()
    fresh = mx.optimizer.get_updater(tupd.optimizer)
    fresh.set_states(blob)
    for a, b in zip(fresh.states[0], tupd.states[0]):
        assert torch.equal(a.data, b.data)


def test_group_adagrad_row_wise_history_like_jax():
    o = {}
    for mxmod, kw in ((jmx, {}), (mx, KW)):
        opt = mxmod.optimizer.create("groupadagrad", learning_rate=0.1)
        w = mxmod.nd.ones((3, 4), **kw) if mxmod is mx else \
            mxmod.nd.ones((3, 4))
        g = mxmod.nd.array(np.array([[1, 1, 1, 1], [2, 2, 2, 2],
                                     [0, 0, 0, 0]], np.float32), **kw)
        state = opt.create_state(0, w)
        assert state.shape == (3,)
        opt.update(0, w, g, state)
        o[mxmod.__name__] = np.array(w.asnumpy())
        bad = mxmod.optimizer.create("groupadagrad", learning_rate=0.1,
                                     wd=1e-4)
        with pytest.raises(mxmod.MXNetError, match="weight decay"):
            bad.update(9, w, g, bad.create_state(9, w))
    wn = o["mxnet_tpu_torch"]
    np.testing.assert_allclose(wn, o["mxnet_tpu"], rtol=TOL, atol=TOL)
    assert np.allclose(wn[2], 1.0) and wn[0][0] != wn[1][0]


def test_lbsgd_keeps_float16_weights_and_caps_the_ratio():
    o = mx.optimizer.create("lbsgd", learning_rate=1.0, warmup_epochs=0)
    wh = mx.nd.ones((4,), **KW).astype("float16")
    o.update(4, wh, mx.nd.ones((4,), **KW).astype("float16"),
             o.create_state(4, wh))
    assert wh.dtype == np.float16
    w2 = mx.nd.ones((4,), **KW)
    o.update(1, w2, mx.nd.array(np.full(4, 1e-8, np.float32), **KW),
             o.create_state(1, w2))
    assert np.abs(w2.asnumpy() - 1.0).max() < 1.0
