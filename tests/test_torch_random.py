"""``mx.random`` and ``mx.nd.random`` of the port, against
``tests/test_random.py``'s cases, on the CPU.

torch's Philox and the JAX package's threefry draw different numbers from
one seed, so draws are held by their moments and a seed by repeating bit
for bit. Moment bounds are about six standard errors of the mean (or of
the share) at the sample size, so a correct sampler fails them with
probability below 1e-8, while a wrong mean or scale fails them; seeds are
fixed, so the tests repeat.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

KW = {"ctx": mx.cpu()}


def test_seed_repeats_bit_for_bit():
    mx.random.seed(42)
    a = mx.nd.random.uniform(shape=(100,), **KW).asnumpy()
    mx.random.seed(42)
    b = mx.nd.random.uniform(shape=(100,), **KW).asnumpy()
    np.testing.assert_array_equal(a, b)
    c = mx.nd.random.uniform(shape=(100,), **KW).asnumpy()
    assert not np.allclose(b, c)
    mx.random.seed(43)
    d = mx.nd.random.uniform(shape=(100,), **KW).asnumpy()
    assert not np.allclose(a, d)
    mx.random.seed(7, ctx=mx.cpu())
    e = mx.random.normal(shape=(5,), **KW).asnumpy()
    mx.random.seed(7, ctx=mx.cpu())
    np.testing.assert_array_equal(e, mx.random.normal(shape=(5,),
                                                      **KW).asnumpy())


def test_every_sampler_repeats_from_a_seed():
    def draw():
        mx.random.seed(3)
        nd = mx.nd.random
        return [nd.uniform(shape=(6,), **KW), nd.normal(shape=(6,), **KW),
                nd.randn(2, 3, **KW), nd.randint(0, 9, shape=(6,), **KW),
                nd.gamma(2.0, 1.5, shape=(6,), **KW),
                nd.exponential(2.0, shape=(6,), **KW),
                nd.poisson(3.0, shape=(6,), **KW),
                mx.random.bernoulli(0.3, shape=(6,), **KW),
                nd.multinomial(mx.nd.array([0.2, 0.3, 0.5], **KW), shape=6),
                nd.shuffle(mx.nd.arange(6, **KW))]

    for a, b in zip(draw(), draw()):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


def test_uniform_range_and_moments():
    mx.random.seed(0)
    x = mx.nd.random.uniform(2.0, 5.0, shape=(100000,), **KW).asnumpy()
    assert x.dtype == np.float32
    assert x.min() >= 2.0 and x.max() < 5.0
    assert abs(x.mean() - 3.5) < 6 * 3 / np.sqrt(12) / np.sqrt(x.size)
    assert abs(x.var() - 0.75) < 0.02


def test_normal_moments():
    mx.random.seed(0)
    x = mx.nd.random.normal(1.0, 2.0, shape=(100000,), **KW).asnumpy()
    assert abs(x.mean() - 1.0) < 6 * 2.0 / np.sqrt(x.size)
    assert abs(x.std() - 2.0) < 0.03
    y = mx.nd.random.randn(300, 300, loc=-1.0, scale=0.5, **KW).asnumpy()
    assert y.shape == (300, 300) and abs(y.mean() + 1.0) < 0.01


def test_randint_matches_jax_contract():
    mx.random.seed(0)
    x = mx.nd.random.randint(0, 10, shape=(5000,), **KW).asnumpy()
    j = jmx.nd.random.randint(0, 10, shape=(5000,)).asnumpy()
    assert x.dtype == j.dtype == np.int32
    assert x.min() >= 0 and x.max() <= 9
    assert len(np.unique(x)) == 10
    assert abs(x.mean() - 4.5) < 6 * np.sqrt(8.25) / np.sqrt(x.size)


def test_gamma_exponential_poisson_moments():
    mx.random.seed(1)
    n = 100000
    g = mx.nd.random.gamma(2.0, 2.0, shape=(n,), **KW).asnumpy()
    assert abs(g.mean() - 4.0) < 6 * np.sqrt(8.0) / np.sqrt(n)
    assert abs(g.var() - 8.0) < 0.4
    e = mx.nd.random.exponential(2.0, shape=(n,), **KW).asnumpy()
    assert abs(e.mean() - 2.0) < 6 * 2.0 / np.sqrt(n)
    p = mx.nd.random.poisson(3.0, shape=(n,), **KW).asnumpy()
    assert abs(p.mean() - 3.0) < 6 * np.sqrt(3.0) / np.sqrt(n)
    assert np.array_equal(p, np.round(p))
    b = mx.random.bernoulli(0.3, shape=(n,), **KW).asnumpy()
    assert set(np.unique(b)) == {0.0, 1.0}
    assert abs(b.mean() - 0.3) < 6 * np.sqrt(0.21 / n)


def test_multinomial_matches_jax_contract():
    mx.random.seed(0)
    probs = mx.nd.array([0.1, 0.0, 0.9], **KW)
    s = mx.nd.random.multinomial(probs, shape=5000).asnumpy()
    assert s.dtype == np.int32
    assert set(np.unique(s)) <= {0, 2}
    assert abs((s == 2).mean() - 0.9) < 6 * np.sqrt(0.09 / 5000)
    bprobs = [[1.0, 0.0], [0.0, 1.0]]
    s2, lp = mx.nd.random.multinomial(mx.nd.array(bprobs, **KW),
                                      get_prob=True)
    j2, jlp = jmx.nd.random.multinomial(jmx.nd.array(bprobs), get_prob=True)
    np.testing.assert_array_equal(s2.asnumpy(), j2.asnumpy())
    np.testing.assert_allclose(lp.asnumpy(), jlp.asnumpy(), atol=1e-6)
    s3 = mx.nd.random.multinomial(mx.nd.array(bprobs, **KW), shape=4)
    assert s3.shape == (2, 4) and (s3.asnumpy()[1] == 1).all()


def test_shuffle_is_a_permutation():
    mx.random.seed(0)
    x = mx.nd.arange(0, 100, **KW)
    y = mx.nd.random.shuffle(x).asnumpy()
    assert sorted(y.tolist()) == list(range(100))
    assert not np.array_equal(y, np.arange(100))
    assert (x.asnumpy() == np.arange(100)).all()  # a new array


def test_out_writes_in_place():
    out = mx.nd.zeros((4, 4), **KW)
    t = out.data
    assert mx.nd.random.uniform(1.0, 2.0, out=out) is out
    assert out.data is t and (out.asnumpy() >= 1).all()


def test_dropout_draws_from_the_seeded_stream():
    """Dropout's mask comes from ``mx.random``: two draws differ, a seed
    repeats them, and the kept share is 1 - p within six standard
    errors."""
    x = mx.nd.ones((200, 200), **KW)

    def two():
        mx.random.seed(0)
        with mx.autograd.record():
            a = mx.nd.Dropout(x, p=0.5).asnumpy()
            b = mx.nd.Dropout(x, p=0.5).asnumpy()
        return a, b

    a, b = two()
    assert not np.allclose(a, b)
    a2, b2 = two()
    np.testing.assert_array_equal(a, a2)
    np.testing.assert_array_equal(b, b2)
    keep = (a != 0).mean()
    assert abs(keep - 0.5) < 6 * np.sqrt(0.25 / a.size)
    assert set(np.unique(a)) == {0.0, 2.0}


def test_seed_reaches_a_hybridized_block_and_sgld():
    """A hybridized block's dropout and SGLD's noise repeat from a seed."""
    def run():
        mx.random.seed(5)
        net = mx.gluon.nn.HybridSequential()
        net.add(mx.gluon.nn.Dense(8, in_units=8), mx.gluon.nn.Dropout(0.5))
        net.initialize(init=mx.initializer.Constant(0.1), **KW)
        net.hybridize()
        x = mx.nd.ones((4, 8), **KW)
        with mx.autograd.record():
            outs = [net(x).asnumpy() for _ in range(2)]
        opt = mx.optimizer.create("sgld", learning_rate=0.01)
        w = mx.nd.zeros((6,), **KW)
        opt.update(0, w, mx.nd.zeros((6,), **KW), None)
        mx.random.seed(5)
        w2 = mx.nd.zeros((6,), **KW)
        opt.update(0, w2, mx.nd.zeros((6,), **KW), None)
        return outs + [w.asnumpy(), w2.asnumpy()]

    first, second = run(), run()
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(first[0], first[1])
    np.testing.assert_array_equal(first[2], first[3])


def test_generator_is_the_devices_default():
    assert mx.random.generator(torch.device("cpu")) is torch.default_generator
    assert mx.random.generator(mx.cpu()) is torch.default_generator


def test_test_utils_seeding_and_comparison():
    from mxnet_tpu_torch import test_utils as tu

    @tu.with_seed(11)
    def draw():
        return (np.random.rand(3), mx.nd.random.uniform(shape=(3,),
                                                        **KW).asnumpy())

    a, b = draw(), draw()
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert tu.random_seed(9) == 9
    assert len(tu.rand_shape_nd(3)) == 3 and len(tu.rand_shape_2d()) == 2
    assert len(tu.rand_shape_3d()) == 3
    r = tu.rand_ndarray((2, 3), ctx=mx.cpu())
    assert r.shape == (2, 3) and (np.abs(r.asnumpy()) <= 1).all()
    with pytest.raises(mx.MXNetError, match="A13"):
        tu.rand_ndarray((2, 3), stype="csr", ctx=mx.cpu())
    tu.assert_almost_equal(mx.nd.ones((2,), **KW), np.ones(2))
    assert tu.almost_equal(np.ones(2), np.ones(2) + 1e-7)
    assert not tu.almost_equal(np.ones(2), np.zeros(2))
    assert tu.same(mx.nd.ones((2,), **KW), np.ones(2))
    tu.check_consistency(lambda a: a * 2, [mx.cpu(), mx.cpu()],
                         [np.ones(3, np.float32)])
    with pytest.raises(mx.MXNetError, match="A13"):
        tu.check_symbolic_forward(None, [], [])


def test_samplers_and_captured_dropout_on_cuda():
    """On the card: the samplers' moments (1e6 draws, chip_smoke's
    ``[nd-ops]`` bounds), and a hybridized block's dropout in its CUDA
    graph: two replays draw different masks, a seed before each repeats
    them, with no new capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ctx = mx.gpu(0)
    mx.random.seed(0)
    n = 1_000_000
    for arr, mean, var in (
            (mx.nd.random.uniform(2.0, 5.0, shape=(n,), ctx=ctx), 3.5, 0.75),
            (mx.nd.random.normal(1.0, 2.0, shape=(n,), ctx=ctx), 1.0, 4.0),
            (mx.nd.random.gamma(2.0, 2.0, shape=(n,), ctx=ctx), 4.0, 8.0),
            (mx.nd.random.poisson(3.0, shape=(n,), ctx=ctx), 3.0, 3.0)):
        v = arr.data.double()
        assert abs(float(v.mean()) - mean) <= 6 * (var / n) ** 0.5
        assert abs(float(v.var()) - var) <= 0.02 * var
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(64, in_units=64), mx.gluon.nn.Dropout(0.5))
    net.initialize(init=mx.initializer.Constant(0.01), ctx=ctx)
    net.hybridize()
    x = mx.nd.ones((32, 64), ctx=ctx)
    outs = []
    for seed in (None, 3, None, 3):
        if seed is not None:
            mx.random.seed(seed)
        with mx.autograd.record():
            y = net(x)
        y.backward()
        outs.append(y.asnumpy())
    entries = list(net._cached_graph._cache.values())
    assert len(entries) == 1 and entries[0].graphed
    assert not np.array_equal(outs[1], outs[2])
    np.testing.assert_array_equal(outs[1], outs[3])
