"""Port parity: AMP (``mx.amp``, ``mx.contrib.amp``, the AMP operators)
against the JAX package, replaying the one-device cases of the
reference's ``tests/test_amp.py``.

Nets: small MLPs (and one with BatchNorm) with the same weights in both
packages, set from a numpy seed by structural name; batches from numpy
seeds. Tolerances, each stated where it is used:

- the cast policy: a bfloat16 output equal to the JAX package's within
  one bfloat16 rounding (2^-8 relative), a mean of 4096 bfloat16 values
  within 5e-3 of the float64 mean (the reference's own bound);
- bfloat16 training: losses within 2^-7 relative of the JAX package's
  over 4 steps (each side rounds its own products), and within (0.08
  relative, 0.05 absolute) of the fp32 run's (the reference's
  ``test_bf16_fp32_loss_trajectory_parity`` allowance);
- float16 with the loss scaler: the scaler's scale, stable count and
  overflow total equal to the JAX package's exactly; weights and fp32
  masters within 1e-3 relative of the JAX package's (each side rounds
  float16 products its own way), and a skipped step's weights, masters
  and state leaves equal bit for bit to their values before it.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

KW = {"ctx": mx.cpu()}
PKGS = ((jmx, {}), (mx, KW))
BF16_ULP = 2.0 ** -8
F16_RTOL = 1e-3


@pytest.fixture(autouse=True)
def _amp_off_after():
    prev = (jmx.fusedstep.set_enabled(True), mx.fusedstep.set_enabled(True))
    yield
    jmx.amp.disable()
    mx.amp.disable()
    jmx.fusedstep.set_enabled(prev[0])
    mx.fusedstep.set_enabled(prev[1])


def np32(a):
    """A float32 host copy of an NDArray of either package."""
    d = a.data if hasattr(a, "data") else a
    if isinstance(d, torch.Tensor):
        return d.detach().float().cpu().numpy().copy()
    return np.array(np.asarray(d, dtype=np.float32))


def dt(a):
    """The type name of an NDArray of either package."""
    return str(a.dtype).replace("torch.", "")


def set_weights(mxmod, net, seed=0):
    """Numpy-seeded weights by structural name (the same in both
    packages; running variances and BatchNorm gammas positive)."""
    rs = np.random.RandomState(seed)
    for name, p in sorted(net._collect_params_with_prefix().items()):
        a = (rs.randn(*p.shape) * 0.4).astype(np.float32)
        if "running_var" in name or "gamma" in name:
            a = np.abs(a) + 0.5
        if mxmod is mx:
            with torch.no_grad():
                p.data().data.copy_(torch.from_numpy(a))
        else:
            p.set_data(mxmod.nd.array(a).astype(dt(p.data())))


def mlp(mxmod, kw, bn=False, width=16, in_units=8, classes=3, seed=0):
    nn = mxmod.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(width, activation="relu", in_units=in_units))
    if bn:
        net.add(nn.BatchNorm(in_channels=width))
    net.add(nn.Dense(classes, in_units=width))
    net.initialize(**kw)
    set_weights(mxmod, net, seed)
    return net


def batch(mxmod, kw, i=0, n=16, width=8, classes=3, dtype=None):
    rs = np.random.RandomState(100 + i)
    x = mxmod.nd.array(rs.randn(n, width).astype(np.float32), **kw)
    y = mxmod.nd.array(rs.randint(0, classes, (n,)).astype(np.float32),
                       **kw)
    return (x.astype(dtype) if dtype else x), y


def weights(net):
    return {k: np32(p.data()) for k, p in
            sorted(net._collect_params_with_prefix().items())}


def fp16_setup(mxmod, kw, opt="sgd", window=1000, lr=0.01, init=1024.0,
               zero_bias=False):
    mxmod.amp.init("float16")
    net = mxmod.gluon.nn.Dense(4, in_units=8)
    net.initialize(**kw)
    set_weights(mxmod, net)
    if zero_bias:
        net.bias.set_data(mxmod.nd.zeros((4,), **kw))
    mxmod.amp.convert_model(net)
    net.hybridize()
    tr = mxmod.gluon.Trainer(net.collect_params(), opt,
                             {"learning_rate": lr, "multi_precision": True},
                             kvstore=None)
    mxmod.amp.init_trainer(tr)
    tr._amp_loss_scaler = mxmod.amp.LossScaler(
        init_scale=init, scale_factor=2.0, scale_window=window)
    return net, tr


def fp16_step(mxmod, kw, net, tr, poison=False, unscale=False, batch=4,
              x_scale=1.0):
    X = (mxmod.nd.ones((4, 8), **kw) * x_scale).astype("float16")
    with mxmod.autograd.record():
        loss = (net(X) ** 2).sum()
        with mxmod.amp.scale_loss(loss, tr) as sl:
            sl.backward()
    if poison:
        g = net.weight.grad()
        if mxmod is mx:
            g.data.fill_(float("inf"))
        else:
            import jax.numpy as jnp

            g._set_data(jnp.full(g.shape, jnp.inf, g.data.dtype))
    if unscale:
        mxmod.amp.unscale(tr)
    tr.step(batch)


def scaler_state(tr):
    s = tr._amp_loss_scaler
    return s.loss_scale, s._unskipped, s.overflow_total


def _leaves(tr):
    return [np.array(np32(leaf)) for st in tr._fused_states.values()
            for leaf in st]


# -- the cast policy ---------------------------------------------------------

def test_cast_policy_upcasts_and_keeps_the_activation_type():
    vals = np.random.RandomState(0).rand(4096).astype(np.float32)
    x2 = np.random.RandomState(1).rand(2, 5).astype(np.float32)
    got = {}
    for m, kw in PKGS:
        m.amp.init("bfloat16")
        x = m.nd.array(vals, **kw).astype("bfloat16")
        mean = m.nd.mean(x)
        sm = m.nd.softmax(m.nd.array(x2, **kw).astype("bfloat16"))
        assert dt(mean) == dt(sm) == "bfloat16"
        got[m] = (float(np32(mean)), np32(sm))
        m.amp.disable()
    ref = float(vals.astype(np.float64).mean())
    for m in (jmx, mx):
        assert got[m][0] == pytest.approx(ref, rel=5e-3)
    assert got[mx][0] == pytest.approx(got[jmx][0], rel=BF16_ULP)
    np.testing.assert_allclose(got[mx][1], got[jmx][1], rtol=BF16_ULP,
                               atol=0)


def test_policy_state_is_the_shared_dict():
    from mxnet_tpu_torch.amp import policy

    mx.amp.init("bfloat16")
    assert mx.amp.is_enabled is policy.is_enabled
    assert mx.amp.is_enabled()
    assert mx.amp.target_dtype() == "bfloat16"
    mx.amp._STATE["target_dtype"] = None
    assert not mx.amp.is_enabled()
    with pytest.raises(mx.MXNetError):
        mx.amp.init("float64")
    assert mx.contrib.amp.init is mx.amp.init
    with pytest.raises(mx.MXNetError, match="A13"):
        mx.contrib.onnx  # noqa: B018


def test_amp_toggle_and_fp32_ops_capture_again():
    """The hybridized key carries the policy: turning AMP on, and
    extending its fp32 list, each capture again with cause ``amp``."""
    net = mx.gluon.nn.Dense(4, in_units=6)
    net.initialize(**KW)
    net.hybridize()
    x = mx.nd.ones((2, 6), **KW)
    net(x)
    net(x)
    mx.amp.init("bfloat16")
    net(x)
    mx.amp.init("bfloat16", fp32_ops=["FullyConnected"])
    net(x)
    assert net._cached_graph.retrace_causes == ["amp", "amp"]
    assert len(net._cached_graph._cache) == 3


def test_fp32_ops_extension_runs_the_op_in_fp32():
    w = np.random.RandomState(0).randn(4, 8).astype(np.float32)
    x = np.random.RandomState(1).randn(2, 8).astype(np.float32)
    out = {}
    for m, kw in PKGS:
        m.amp.init("bfloat16", fp32_ops=["FullyConnected"])
        y = m.nd.FullyConnected(m.nd.array(x, **kw).astype("bfloat16"),
                                m.nd.array(w, **kw).astype("bfloat16"),
                                no_bias=True, num_hidden=4)
        assert dt(y) == "bfloat16"
        out[m] = np32(y)
        m.amp.disable()
    np.testing.assert_allclose(out[mx], out[jmx], rtol=BF16_ULP, atol=0)


@pytest.mark.parametrize("kind", ["resnet18_v1", "layernorm"])
def test_convert_model_pins_norm_layers_like_jax(kind):
    dtypes = {}
    for m, kw in PKGS:
        m.amp.init("bfloat16")
        if kind == "resnet18_v1":
            net = m.gluon.model_zoo.vision.resnet18_v1(classes=4)
            net.initialize(**kw)
            m.amp.convert_model(net)
            with m.autograd.predict_mode():
                out = net(m.nd.zeros((1, 3, 32, 32), **kw).astype(
                    "bfloat16"))
        else:
            net = m.gluon.nn.HybridSequential()
            net.add(m.gluon.nn.Dense(8, in_units=8),
                    m.gluon.nn.LayerNorm(in_channels=8))
            net.initialize(**kw)
            m.amp.convert_model(net)
            out = net(m.nd.ones((2, 8), **kw).astype("bfloat16"))
        assert dt(out) == "bfloat16"
        dtypes[m] = {k: dt(p.data()) for k, p in
                     net._collect_params_with_prefix().items()}
        m.amp.disable()
    assert dtypes[mx] == dtypes[jmx]
    assert {"bfloat16", "float32"} == set(dtypes[mx].values())


# -- bf16 training -----------------------------------------------------------

def _train(m, kw, dtype, steps=4):
    if dtype != "float32":
        m.amp.init(dtype)
    net = mlp(m, kw, width=16)
    if dtype != "float32":
        m.amp.convert_model(net)
    net.hybridize()
    tr = m.gluon.Trainer(net.collect_params(), "sgd",
                         {"learning_rate": 0.1, "momentum": 0.9,
                          "multi_precision": dtype != "float32"},
                         kvstore=None)
    loss_fn = m.gluon.loss.SoftmaxCrossEntropyLoss()
    x, y = batch(m, kw, dtype=None if dtype == "float32" else dtype)
    losses = []
    for _ in range(steps):
        with m.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        tr.step(16)
        losses.append(float(np32(loss).astype(np.float64).mean()))
    m.amp.disable()
    assert isinstance(tr._fused, dict)
    return losses, tr, net


def test_bf16_training_matches_jax_and_tracks_fp32():
    got, ttr, tnet = _train(mx, KW, "bfloat16")
    want, jtr, jnet = _train(jmx, {}, "bfloat16")
    l32 = _train(mx, KW, "float32")[0]
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7)
    for a, b in zip(l32, got):
        assert b == pytest.approx(a, rel=0.08, abs=0.05)
    assert got[-1] < got[0]
    # fp32 masters as state leaf 0, the stored weight their rounding
    for k, p in tnet._collect_params_with_prefix().items():
        st = ttr._fused_states[p.name]
        assert len(st) == 2 and all(s.dtype == torch.float32 for s in st)
        assert torch.equal(p.data().data, st[0].to(torch.bfloat16))


# -- fp16 with the loss scaler ------------------------------------------------

@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_fp16_skip_backoff_and_growth_match_jax(fused, opt):
    """An inf gradient at step 1 skips the whole update (weights, masters
    and every state leaf bit for bit) and halves the scale; two clean
    steps (window 2) grow it; weights and scaler equal the JAX
    package's."""
    out = {}
    for m, kw in PKGS:
        m.fusedstep.set_enabled(fused)
        net, tr = fp16_setup(m, kw, opt=opt, window=2)
        history = []
        for i in range(6):
            before = (np32(net.weight.data()), _leaves(tr))
            fp16_step(m, kw, net, tr, poison=i == 1)
            if i == 1:
                np.testing.assert_array_equal(np32(net.weight.data()),
                                              before[0])
                for a, b in zip(_leaves(tr), before[1]):
                    np.testing.assert_array_equal(a, b)
            history.append(scaler_state(tr))
        out[m] = (history, weights(net), isinstance(tr._fused, dict))
        m.amp.disable()
    assert out[mx][0] == out[jmx][0]
    assert out[mx][0][1] == (512.0, 0, 1)
    # steps 2-3 and 4-5 fill two windows of two clean steps
    assert [h[0] for h in out[mx][0]] == [1024.0, 512.0, 512.0, 1024.0,
                                          1024.0, 2048.0]
    assert out[mx][2] == fused
    for k, w in out[jmx][1].items():
        np.testing.assert_allclose(out[mx][1][k], w, rtol=F16_RTOL,
                                   atol=1e-4)


def test_adam_after_a_skip_reads_the_state_step_like_jax():
    """The reference's skip leaves Adam's ``t`` where it was while the
    update counts move on; the next step's bias correction reads ``t``.
    The port's fused update read the host count until this slice."""
    out = {}
    for m, kw in PKGS:
        net, tr = fp16_setup(m, kw, opt="adam", lr=0.05)
        w0 = np32(net.weight.data())
        for i in range(3):
            fp16_step(m, kw, net, tr, poison=i == 1)
        st = tr._fused_states[net.weight.name]
        out[m] = (np32(net.weight.data()) - w0, int(np32(st[3])),
                  tr._optimizer._index_update_count)
        m.amp.disable()
    assert out[mx][1] == out[jmx][1] == 2
    assert out[mx][2] == out[jmx][2]
    np.testing.assert_allclose(out[mx][0], out[jmx][0], rtol=F16_RTOL,
                               atol=1e-5)


def test_fp16_tiny_combined_rescale_does_not_underflow():
    """(1/batch)/scale at batch 4096 and scale 2^15 is 7.5e-9, below
    float16's smallest subnormal: the update must unscale in fp32."""
    deltas = {}
    for m, kw in PKGS:
        net, tr = fp16_setup(m, kw, lr=1.0, init=2.0 ** 15, window=10 ** 6,
                             zero_bias=True)
        w0 = np32(tr._fused_states.get(net.weight.name, (None,))[0]
                  if tr._fused_states else net.weight.data())
        for _ in range(3):
            fp16_step(m, kw, net, tr, batch=4096, x_scale=0.01)
        assert tr._amp_loss_scaler.overflow_total == 0
        master = np32(tr._fused_states[net.weight.name][0])
        deltas[m] = master - w0
        m.amp.disable()
    assert np.abs(deltas[mx]).max() > 0.0
    np.testing.assert_allclose(deltas[mx], deltas[jmx], rtol=F16_RTOL,
                               atol=1e-9)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
def test_unscale_divides_and_keeps_the_overflow_check(fused):
    for m, kw in PKGS:
        m.fusedstep.set_enabled(fused)
        net, tr = fp16_setup(m, kw)
        X = m.nd.ones((4, 8), **kw).astype("float16")
        with m.autograd.record():
            loss = (net(X) ** 2).sum()
            with m.amp.scale_loss(loss, tr) as sl:
                sl.backward()
        scaled = np32(net.weight.grad())
        m.amp.unscale(tr)
        np.testing.assert_allclose(np32(net.weight.grad()) * 1024.0, scaled,
                                   rtol=1e-3)
        assert tr._amp_pending == "unscaled"
        # an inf after unscale still skips and backs off
        fp16_step(m, kw, net, tr, poison=True, unscale=True)
        assert scaler_state(tr) == (512.0, 0, 1)
        m.amp.disable()


def test_unscale_then_step_divides_once():
    runs = {}
    for with_unscale in (True, False):
        net, tr = fp16_setup(mx, KW)
        for _ in range(3):
            fp16_step(mx, KW, net, tr, unscale=with_unscale)
        runs[with_unscale] = np32(net.weight.data())
        mx.amp.disable()
    np.testing.assert_array_equal(runs[True], runs[False])


def test_eager_fallback_unscales_the_buffers():
    mx.fusedstep.set_enabled(False)
    net, tr = fp16_setup(mx, KW)
    X = mx.nd.ones((4, 8), **KW).astype("float16")
    with mx.autograd.record():
        loss = (net(X) ** 2).sum()
        with mx.amp.scale_loss(loss, tr) as sl:
            sl.backward()
    scaled = np32(net.weight.grad())
    tr.step(4)
    np.testing.assert_allclose(np32(net.weight.grad()) * 1024.0, scaled,
                               rtol=2e-3, atol=1e-4)


def test_has_overflow_takes_params_arrays_and_grads():
    ls = mx.amp.LossScaler()
    p = mx.gluon.Parameter("w", shape=(3,))
    p.initialize(**KW)
    p.grad().data.fill_(1.0)
    a = mx.nd.ones((2,), **KW)
    a.attach_grad()
    assert not ls.has_overflow([p, a, np.ones(3, np.float32)])
    a.grad.data[0] = float("nan")
    assert ls.has_overflow([p, a])
    assert ls.has_overflow([np.array([1.0, np.inf], np.float32)])
    ls.update_scale(True)
    assert (ls.loss_scale, ls.overflow_total) == (32768.0, 1)


def test_load_parameters_after_convert_model(tmp_path):
    """fp16 with BatchNorm: the mixed types come back exactly in a fresh
    converted net, and reloading the live net keeps the Trainer's
    plan."""
    mx.amp.init("float16")

    def build():
        net = mlp(mx, KW, bn=True, width=8)
        mx.amp.convert_model(net)
        net.hybridize()
        return net

    net = build()
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.05, "momentum": 0.9,
                           "multi_precision": True})
    mx.amp.init_trainer(tr)
    tr._amp_loss_scaler = mx.amp.LossScaler(init_scale=1024.0)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    x, y = batch(mx, KW, dtype="float16")

    def step():
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
            with mx.amp.scale_loss(loss, tr) as sl:
                sl.backward()
        tr.step(16)

    step()
    step()
    plan = tr._fused
    assert isinstance(plan, dict)
    fname = str(tmp_path / "mixed.params")
    net.save_parameters(fname)
    net2 = build()
    net2.load_parameters(fname)
    p1, p2 = (n._collect_params_with_prefix() for n in (net, net2))
    assert {dt(p.data()) for p in p1.values()} == {"float16",
                                                          "float32"}
    for k in p1:
        assert p1[k].data().data.dtype == p2[k].data().data.dtype
        assert torch.equal(p1[k].data().data, p2[k].data().data)
    net.load_parameters(fname)
    step()
    assert tr._fused is plan


# -- the AMP operators --------------------------------------------------------

def _invoke(m, kw, name, arrays, **attrs):
    nd = [m.nd.array(a, **kw).astype(str(a.dtype)) for a in arrays]
    out = getattr(m.nd, name)(*nd, **attrs)
    outs = out if isinstance(out, (list, tuple)) else [out]
    return [np32(o) for o in outs], [dt(o) for o in outs]


@pytest.mark.parametrize("name,arrays,attrs", [
    ("amp_cast", ("f32",), {"dtype": "bfloat16"}),
    ("amp_cast", ("f16",), {"dtype": "float32"}),
    ("amp_multicast", ("f16", "f32"), {"num_outputs": 2}),
    ("amp_multicast", ("f16", "f32"), {"num_outputs": 2,
                                      "cast_narrow": True}),
    ("all_finite", ("f32",), {}),
    ("all_finite", ("inf",), {}),
    ("multi_all_finite", ("f32", "f16"), {"num_arrays": 2}),
    ("multi_all_finite", ("f32", "inf"), {"num_arrays": 2}),
    ("mp_adamw_update", ("f16", "f16", "f32", "pos", "f32", "one"),
     {"lr": 0.01, "wd": 0.1, "eta": 0.5}),
    ("multi_mp_adamw_update", ("f16", "f16", "f32", "pos", "f32") * 2,
     {"lrs": (0.01, 0.02), "wds": (0.0, 0.1), "rescale_grad": 0.5,
      "clip_gradient": 0.3, "num_tensors": 2}),
])
def test_amp_operators_match_jax(name, arrays, attrs):
    rs = np.random.RandomState(0)
    kinds = {"f32": lambda: rs.randn(3, 4).astype(np.float32),
             "f16": lambda: rs.randn(3, 4).astype(np.float16),
             "pos": lambda: rs.rand(3, 4).astype(np.float32),
             "inf": lambda: np.array([[1.0, np.inf]], np.float32),
             "one": lambda: np.array([1.0], np.float32)}
    data = [kinds[k]() for k in arrays]
    want, wt = _invoke(jmx, {}, name, data, **attrs)
    got, gt = _invoke(mx, KW, name, data, **attrs)
    assert gt == wt
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


def test_amp_multicast_refuses_integers():
    with pytest.raises(mx.MXNetError):
        mx.nd.amp_multicast(mx.nd.ones((2,), **KW),
                            mx.nd.array([1, 2], dtype="int32", **KW),
                            num_outputs=2)
