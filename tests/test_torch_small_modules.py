"""Port parity: the small modules of ROADMAP §A item 2 against the JAX
package: the initializers ``InitDesc``, ``Orthogonal``, ``MSRAPrelu``,
``Bilinear``, ``LSTMBias``, ``Mixed``, ``Load`` and ``create``'s
aliases; ``gluon.Constant`` and ``mx.Optimizer``; ``runtime``
(``Features``, ``backoff_delays``, ``retry_with_backoff``); ``util``;
``name``; ``attribute``.

``Bilinear``, ``LSTMBias``, ``Mixed``, ``Load`` and the dispatch by name
are held exactly. ``Orthogonal`` and ``MSRAPrelu`` draw from torch's
stream (the JAX package draws from numpy's), so they are held by what
defines them: Q Q^T = scale^2 I for ``Orthogonal`` within 1e-4 of
scale^2 (float32 sums of up to 72 products), and ``MSRAPrelu``'s standard deviation within 3% of
sqrt(2 / (1 + slope^2) / fan_avg) on 256 x 512 weights, the reference's
draws by the same test.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import random

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx


def _arr(shape):
    return mx.nd.zeros(shape, ctx=mx.cpu())


def _np(a):
    return np.array(a.asnumpy())


@pytest.mark.parametrize("shape", [(2, 3, 4, 4), (1, 1, 5, 5),
                                   (3, 2, 3, 7)])
def test_bilinear_equals_jax(shape):
    a, ja = _arr(shape), jmx.nd.zeros(shape)
    mx.initializer.Bilinear()("up_weight", a)
    jmx.initializer.Bilinear()("up_weight", ja)
    np.testing.assert_array_equal(_np(a), _np(ja))


def test_lstm_bias_and_init_desc_equal_jax():
    for fb in (1.0, 2.5):
        a, ja = _arr((16,)), jmx.nd.zeros((16,))
        d = mx.initializer.InitDesc("l0_i2h_bias", attrs={"__init__":
                                                          "lstmbias"})
        jd = jmx.initializer.InitDesc("l0_i2h_bias",
                                      attrs={"__init__": "lstmbias"})
        mx.initializer.Zero()(d, a)
        jmx.initializer.Zero()(jd, ja)
        np.testing.assert_array_equal(_np(a), _np(ja))
        mx.initializer.LSTMBias(fb)._init_weight("w", a)
        jmx.initializer.LSTMBias(fb)._init_weight("w", ja)
        np.testing.assert_array_equal(_np(a), _np(ja))
    # a plain name ending in "bias" takes the zero init in both
    a, ja = _arr((8,)) + 3, jmx.nd.zeros((8,)) + 3
    mx.initializer.LSTMBias()("x_bias", a)
    jmx.initializer.LSTMBias()("x_bias", ja)
    np.testing.assert_array_equal(_np(a), _np(ja))
    with pytest.raises(TypeError):
        mx.initializer.Zero()(3, a)


@pytest.mark.parametrize("name", ["fc_weight", "fc_bias", "bn_gamma",
                                  "bn_beta", "bn_running_mean",
                                  "bn_moving_var", "bn_moving_inv_var",
                                  "bn_moving_avg", "other"])
def test_name_dispatch_equals_jax(name):
    a, ja = _arr((3, 4)) + 5, jmx.nd.zeros((3, 4)) + 5
    mx.initializer.Constant(0.5)(name, a)
    jmx.initializer.Constant(0.5)(name, ja)
    np.testing.assert_array_equal(_np(a), _np(ja))


def test_mixed_and_load_equal_jax():
    init = mx.initializer.Mixed([".*bias", ".*"],
                                [mx.initializer.One(),
                                 mx.initializer.Constant(0.3)])
    jinit = jmx.initializer.Mixed([".*bias", ".*"],
                                  [jmx.initializer.One(),
                                   jmx.initializer.Constant(0.3)])
    for name in ("fc_bias", "fc_weight"):
        a, ja = _arr((2, 3)), jmx.nd.zeros((2, 3))
        init(name, a)
        jinit(name, ja)
        np.testing.assert_array_equal(_np(a), _np(ja))
    with pytest.raises(ValueError):
        mx.initializer.Mixed(["a"], [mx.initializer.One()])("b", _arr((1,)))
    with pytest.raises(mx.MXNetError):
        mx.initializer.Mixed(["a", "b"], [mx.initializer.One()])
    vals = np.arange(6, dtype=np.float32).reshape(2, 3)
    load = mx.initializer.Load({"arg:w": mx.nd.array(vals, ctx=mx.cpu())},
                               default_init=mx.initializer.One())
    jload = jmx.initializer.Load({"arg:w": jmx.nd.array(vals)},
                                 default_init=jmx.initializer.One())
    for name in ("w", "v_weight"):
        a, ja = _arr((2, 3)), jmx.nd.zeros((2, 3))
        load(name, a)
        jload(name, ja)
        np.testing.assert_array_equal(_np(a), _np(ja))
    with pytest.raises(ValueError):
        mx.initializer.Load({})("w", _arr((1,)))


@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
@pytest.mark.parametrize("shape", [(16, 64), (64, 16), (8, 4, 3, 3)])
def test_orthogonal_by_its_definition(rand_type, shape):
    for pkg, arr in ((mx, _arr(shape)), (jmx, jmx.nd.zeros(shape))):
        pkg.initializer.Orthogonal(scale=1.5, rand_type=rand_type)(
            "q_weight", arr)
        q = _np(arr).reshape(shape[0], -1).astype(np.float64)
        gram = q @ q.T if q.shape[0] <= q.shape[1] else q.T @ q
        np.testing.assert_allclose(gram, 2.25 * np.eye(len(gram)),
                                   atol=1e-4 * 2.25)


def test_msraprelu_by_its_moments():
    shape = (256, 512)
    want = np.sqrt(2.0 / (1 + 0.25 ** 2) / ((256 + 512) / 2.0))
    for pkg, arr in ((mx, _arr(shape)), (jmx, jmx.nd.zeros(shape))):
        init = pkg.initializer.create("msraprelu")
        init("c_weight", arr)
        v = _np(arr)
        assert abs(v.mean()) < 0.03 * want
        assert abs(v.std() / want - 1) < 0.03
    seeded = [mx.initializer.MSRAPrelu(seed=4) for _ in range(2)]
    a, b = _arr(shape), _arr(shape)
    seeded[0]("w_weight", a)
    seeded[1]("w_weight", b)
    np.testing.assert_array_equal(_np(a), _np(b))


def test_create_aliases_match_jax():
    for name in ("zeros", "ones", "gaussian", "normal", "uniform", "xavier",
                 "msraprelu", "orthogonal", "bilinear", "lstmbias",
                 "constant", "zero", "one"):
        assert type(mx.initializer.create(name)).__name__ == \
            type(jmx.initializer.create(name)).__name__
    assert mx.initializer.zeros is mx.initializer.Zero
    assert mx.initializer.ones is mx.initializer.One
    assert set(mx.initializer.registry) >= set(jmx.initializer.registry) - {
        "mixed", "load"}
    with pytest.raises(mx.MXNetError):
        mx.initializer.create("no_such_init")


def test_constant_export_and_optimizer_export():
    assert mx.gluon.Constant is mx.gluon.parameter.Constant
    c = mx.gluon.Constant("c", mx.nd.array([1.0, 2.0], ctx=mx.cpu()))
    c.initialize(ctx=mx.cpu())
    np.testing.assert_array_equal(_np(c.data()), [1.0, 2.0])
    assert c.grad_req == "null"
    assert mx.Optimizer is mx.optimizer.Optimizer
    assert isinstance(mx.optimizer.create("sgd"), mx.Optimizer)


def test_runtime_features_and_backoff_match_jax():
    f = mx.runtime.Features()
    assert f.is_enabled("cuda") == torch.cuda.is_available()
    assert f.is_enabled("CUDNN") == (torch.cuda.is_available()
                                     and torch.backends.cudnn.is_available())
    assert not f.is_enabled("TPU") and not f.is_enabled("XLA")
    assert f.is_enabled("OPENCV") == jmx.runtime.Features().is_enabled(
        "OPENCV")
    assert {x.name for x in mx.runtime.feature_list()} == set(f)
    for jitter in (True, False):
        got = mx.runtime.backoff_delays(5, 0.5, max_delay=3.0,
                                        jitter=jitter,
                                        rng=random.Random(7))
        want = jmx.runtime.backoff_delays(5, 0.5, max_delay=3.0,
                                          jitter=jitter,
                                          rng=random.Random(7))
        assert got == want
    calls, slept = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    assert mx.runtime.retry_with_backoff(flaky, attempts=3, base_delay=0.1,
                                         sleep=slept.append) == "ok"
    assert len(calls) == 3 and len(slept) == 2
    with pytest.raises(KeyError):
        mx.runtime.retry_with_backoff(
            lambda: (_ for _ in ()).throw(KeyError("x")), attempts=4,
            no_retry=(KeyError,), sleep=slept.append)


def test_util_name_attribute_match_jax():
    assert mx.util.get_gpu_count() == mx.num_gpus()
    used, total = mx.util.get_gpu_memory(0)
    if torch.cuda.is_available():
        assert 0 <= used <= total and total > 0
    else:
        assert (used, total) == (0, 0)
    try:
        mx.set_np()
        assert mx.is_np_array() and mx.util.is_np_shape()
    finally:
        mx.reset_np()
    assert not mx.is_np_array()
    mx.name.reset()
    jmx.name.reset()
    got = [mx.name.next_prefix("dense"), mx.name.next_name("dense"),
           mx.name.next_name("conv")]
    want = [jmx.name.next_prefix("dense"), jmx.name.next_name("dense"),
            jmx.name.next_name("conv")]
    assert got == want == ["dense0_", "dense1", "conv0"]
    with mx.AttrScope(ctx_group="a", x="1"):
        with mx.AttrScope(ctx_group="b"):
            got = mx.AttrScope.current().get({"y": "2"})
    with jmx.AttrScope(ctx_group="a", x="1"):
        with jmx.AttrScope(ctx_group="b"):
            want = jmx.AttrScope.current().get({"y": "2"})
    assert got == want == {"ctx_group": "b", "x": "1", "y": "2"}
    assert mx.AttrScope.current().get() == {}
