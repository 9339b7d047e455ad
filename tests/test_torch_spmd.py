"""Port parity: ``mxnet_tpu_torch.parallel.SPMDTrainStep(mesh=None)`` and
its update rules against the JAX package's ``parallel/spmd.py``.

- Every ``_RULES`` entry, and ``mp_rule`` on bfloat16 weights: two updates
  on the same numpy arrays through both packages' rules. float32 within
  1e-6 relative (+1e-7 absolute): element-wise math, the lamb norms
  summed in another order. bf16: the fp32 master within 1e-6, the rounded
  weight within one bf16 step (2^-8 relative).
- 3 Adam steps of ``llama_tiny`` (the reference's ``test_llama_tiny_train``
  model and loss) from the same weights and batch: the loss trajectory
  within 1e-5 relative under ``MXTPU_FLASH_BWD=fused`` and ``split``
  (float32; the two sides differ in summation order only), the final
  weights within 1e-5 absolute + 1e-4 relative (Adam's 1/sqrt(v) scales
  float32 noise of small gradients up).
- A Dense + BatchNorm net: 2 SGD-momentum steps, losses and the running
  statistics the step carries against the JAX step's.
- ``run_steps(n)`` equals n calls, the Gluon parameters keep their values
  until ``sync_to_block``, dropout draws from torch's default generator,
  the data-parallel options on one device change nothing, and tensor
  parallelism raises.

The JAX step donates its buffers: every JAX host array a test keeps is a
copy (``np.array``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import models as jmodels
from mxnet_tpu.parallel import spmd as jspmd
from mxnet_tpu_torch.gluon.utils import load_numpy
from mxnet_tpu_torch.parallel import spmd as tspmd

RULE_CASES = {
    "sgd": ("sgd", {"wd": 0.01}),
    "sgd_momentum": ("sgd", {"momentum": 0.9, "wd": 0.01}),
    "nag": ("nag", {"wd": 0.01}),
    "nag_momentum": ("nag", {"momentum": 0.9, "wd": 0.01}),
    "adam": ("adam", {"wd": 0.01}),
    "adamw": ("adamw", {"beta1": 0.8, "beta2": 0.99, "epsilon": 1e-6}),
    "lamb": ("lamb", {"wd": 0.01}),
}


def _rule_arrays(seed):
    rs = np.random.RandomState(seed)
    w = rs.randn(6, 5).astype(np.float32)
    grads = [rs.randn(6, 5).astype(np.float32) for _ in range(2)]
    return w, grads


def _run_rules(jrule, trule, w, grads, lr, jdtype, tdtype):
    jinit, jupd = jrule
    tinit, tupd = trule
    jw = jnp.asarray(w).astype(jdtype)
    tw = torch.from_numpy(w).to(tdtype)
    js, ts = jinit(jw), tuple(tinit(tw))
    out = []
    for g in grads:
        jw, js = jupd(jw, jnp.asarray(g).astype(jdtype), js,
                      jnp.asarray(lr, jnp.float32))
        tw, ts = tupd(tw, torch.from_numpy(g).to(tdtype), ts,
                      torch.tensor(lr, dtype=torch.float32))
        out.append((np.array(jnp.asarray(jw, jnp.float32)),
                    [np.array(jnp.asarray(s, jnp.float32)) for s in js],
                    tw.float().numpy(), [s.float().numpy() for s in ts]))
    return out


@pytest.mark.parametrize("case", list(RULE_CASES))
def test_rule_matches_jax(case):
    name, hyper = RULE_CASES[case]
    w, grads = _rule_arrays(0)
    for jw, js, tw, ts in _run_rules(
            jspmd._RULES[name](hyper), tspmd._RULES[name](hyper), w, grads,
            0.05, jnp.float32, torch.float32):
        np.testing.assert_allclose(tw, jw, rtol=1e-6, atol=1e-7)
        assert len(ts) == len(js)
        for a, b in zip(ts, js):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_mp_rule_on_bf16_matches_jax(name):
    hyper = {"momentum": 0.9} if name == "sgd" else {}
    w, grads = _rule_arrays(1)
    for jw, js, tw, ts in _run_rules(
            jspmd.mp_rule(*jspmd._RULES[name](hyper)),
            tspmd.mp_rule(*tspmd._RULES[name](hyper)), w, grads, 0.05,
            jnp.bfloat16, torch.bfloat16):
        np.testing.assert_allclose(ts[0], js[0], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tw, jw, rtol=2.0 ** -8, atol=0)
        np.testing.assert_array_equal(tw, ts[0].astype(
            jnp.bfloat16).astype(np.float32))


def test_mp_rule_passes_fp32_through_and_low_precision_predicate():
    assert tspmd.is_low_precision_dtype(torch.bfloat16)
    assert tspmd.is_low_precision_dtype("float16")
    assert not tspmd.is_low_precision_dtype(torch.float32)
    init, _ = tspmd.mp_rule(*tspmd._RULES["adam"]({}))
    assert len(init(torch.zeros(3))) == 3
    assert len(init(torch.zeros(3, dtype=torch.bfloat16))) == 4


# ---------------------------------------------------------------------------
# the step on llama_tiny
# ---------------------------------------------------------------------------

BATCH, SEQ, VOCAB = 2, 16, 256


def _lm_loss(mxmod):
    loss_fn = mxmod.gluon.loss.SoftmaxCrossEntropyLoss()

    def lm_loss(logits, labels):
        return loss_fn(logits.reshape((-1, logits.shape[-1])),
                       labels.reshape((-1,)))

    return lm_loss


def _batch():
    ids = np.random.RandomState(0).randint(0, VOCAB, (BATCH, SEQ + 1)) \
        .astype(np.float32)
    return ids[:, :-1], ids[:, 1:]


def _llama_pair():
    jnet = jmodels.llama_tiny()
    jnet.initialize(init=jmx.initializer.Normal(0.02))
    tnet = mx.models.llama_tiny()
    tnet.initialize(init=mx.initializer.Normal(0.02), ctx=mx.cpu())
    x, _ = _batch()
    jnet(jmx.nd.array(x))
    tnet(mx.nd.array(x, ctx=mx.cpu()))
    load_numpy(tnet.collect_params(),
               {k.replace(jnet.prefix, tnet.prefix, 1):
                np.array(p.data().asnumpy())
                for k, p in jnet.collect_params().items()})
    return jnet, tnet


@pytest.mark.parametrize("route", ["fused", "split"])
def test_three_adam_steps_match_jax(monkeypatch, route):
    monkeypatch.setenv("MXTPU_FLASH_BWD", route)
    jnet, tnet = _llama_pair()
    x, y = _batch()
    jstep = jmx.parallel.SPMDTrainStep(jnet, _lm_loss(jmx), "adam", {},
                                       mesh=None)
    tstep = mx.parallel.SPMDTrainStep(tnet, _lm_loss(mx), "adam", {},
                                      mesh=None)
    jx, jy = jmx.nd.array(x), jmx.nd.array(y)
    tx, ty = mx.nd.array(x, ctx=mx.cpu()), mx.nd.array(y, ctx=mx.cpu())
    jl = np.array([jstep(jx, jy, lr=1e-3) for _ in range(3)])
    tl = np.array([tstep(tx, ty, lr=1e-3) for _ in range(3)])
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    jstep.sync_to_block()
    tstep.sync_to_block()
    tparams = tnet.collect_params()
    for k, p in jnet.collect_params().items():
        got = tparams[k.replace(jnet.prefix, tnet.prefix, 1)].data()
        np.testing.assert_allclose(got.asnumpy(), np.array(
            p.data().asnumpy()), rtol=1e-4, atol=1e-5, err_msg=k)


def _weights(net):
    return {k: p.data().data.clone() for k, p in
            net.collect_params().items()}


def test_run_steps_equals_n_calls_and_sync_to_block():
    _, a = _llama_pair()
    b = mx.models.llama_tiny()
    b.initialize(ctx=mx.cpu())
    x, y = _batch()
    tx, ty = mx.nd.array(x, ctx=mx.cpu()), mx.nd.array(y, ctx=mx.cpu())
    b(tx)
    load_numpy(b.collect_params(), {
        k.replace(a.prefix, b.prefix, 1): p.data().asnumpy()
        for k, p in a.collect_params().items()})
    before = _weights(a)
    sa = mx.parallel.SPMDTrainStep(a, _lm_loss(mx), "adam", {})
    sb = mx.parallel.SPMDTrainStep(b, _lm_loss(mx), "adam", {})
    last = sa.run_steps(tx, ty, 3, lr=1e-3)
    losses = [sb(tx, ty, lr=1e-3, sync=False) for _ in range(3)]
    assert isinstance(last, torch.Tensor) and last.dim() == 0
    assert isinstance(sb(tx, ty, lr=0.0), float)
    assert torch.equal(last, losses[-1])
    # the Gluon parameters keep their values until sync_to_block
    for k, w in _weights(a).items():
        assert torch.equal(w, before[k]), k
    sa.sync_to_block()
    state = dict(zip(sa._names, sa._state[0]))
    for k, w in _weights(a).items():
        assert torch.equal(w, state[k]), k
        assert not torch.equal(w, before[k]), k
    # a later step goes on from the step's own state, not the block's
    assert float(sa.run_steps(tx, ty, 1, lr=1e-3)) < float(last)


def _bn_net(mxmod, **ctx):
    nn = mxmod.gluon.nn
    net = nn.HybridSequential(prefix="bnnet_")
    with net.name_scope():
        net.add(nn.Dense(8, in_units=4), nn.BatchNorm(in_channels=8),
                nn.Dense(3, in_units=8))
    net.initialize(init=mxmod.initializer.Xavier(), **ctx)
    return net


def test_batch_norm_statistics_carried_like_jax():
    jnet, tnet = _bn_net(jmx), _bn_net(mx, ctx=mx.cpu())
    load_numpy(tnet.collect_params(), {
        k: np.array(p.data().asnumpy())
        for k, p in jnet.collect_params().items()})
    rs = np.random.RandomState(5)
    x = rs.randn(6, 4).astype(np.float32)
    y = rs.randint(0, 3, (6,)).astype(np.float32)
    hyper = {"momentum": 0.9, "wd": 1e-3}
    jstep = jmx.parallel.SPMDTrainStep(
        jnet, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd", hyper)
    tstep = mx.parallel.SPMDTrainStep(
        tnet, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd", hyper)
    stats0 = {k: p.data().asnumpy().copy()
              for k, p in tnet.collect_params().items()
              if "running" in k}
    jl = [jstep(jmx.nd.array(x), jmx.nd.array(y), lr=0.1) for _ in range(2)]
    tl = [tstep(mx.nd.array(x, ctx=mx.cpu()), mx.nd.array(y, ctx=mx.cpu()),
                lr=0.1) for _ in range(2)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    jstep.sync_to_block()
    tstep.sync_to_block()
    assert stats0
    for k, before in stats0.items():
        got = tnet.collect_params()[k].data().asnumpy()
        want = np.array(jnet.collect_params()[k].data().asnumpy())
        assert not np.array_equal(got, before), k
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def _dropout_losses():
    mx.gluon.block.reset_names()
    nn = mx.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(16, in_units=8), nn.Dropout(0.5),
                nn.Dense(4, in_units=16))
    net.initialize(init=mx.initializer.Xavier(seed=0), ctx=mx.cpu())
    rs = np.random.RandomState(0)
    x = mx.nd.array(rs.randn(5, 8), ctx=mx.cpu())
    y = mx.nd.array(rs.randint(0, 4, (5,)), ctx=mx.cpu())
    step = mx.parallel.SPMDTrainStep(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd")
    return [step(x, y, lr=0.1) for _ in range(3)]


def test_dropout_draws_from_the_default_generator():
    torch.manual_seed(1)
    a = _dropout_losses()
    torch.manual_seed(1)
    assert _dropout_losses() == a
    torch.manual_seed(2)
    assert _dropout_losses() != a


@pytest.mark.parametrize("kwargs", [
    {"mesh": object()},
    {"param_sharding": {"w": ("tp", None)}},
    {"zero_stage": 2},
    {"zero_stage": 3},
    {"overlap": True},
    {"compression_params": {"type": "2bit"}},
    {"grad_dtype": "bfloat16"},
], ids=lambda kw: next(iter(kw)) + str(next(iter(kw.values())))[:6])
def test_what_one_device_cannot_honour_raises(kwargs):
    """On one device the data-parallel options have nothing to act on and
    the step equals the plain one bit for bit (the JAX package's
    single-device path ignores them too); a mesh must come from
    ``parallel.make_mesh``, and tensor parallelism still raises (A11)."""
    net = mx.models.llama_tiny()
    if "param_sharding" in kwargs:
        with pytest.raises(mx.MXNetError, match="ROADMAP A11"):
            mx.parallel.SPMDTrainStep(net, _lm_loss(mx), "adam", {},
                                      **kwargs)
        return
    if "mesh" in kwargs:
        with pytest.raises(mx.MXNetError, match="make_mesh"):
            mx.parallel.SPMDTrainStep(net, _lm_loss(mx), "adam", {},
                                      **kwargs)
        kwargs = {"mesh": mx.parallel.make_mesh({"dp": 1})}
    _, a = _llama_pair()
    x, y = _batch()
    tx, ty = mx.nd.array(x, ctx=mx.cpu()), mx.nd.array(y, ctx=mx.cpu())
    b = mx.models.llama_tiny()
    b.initialize(ctx=mx.cpu())
    b(tx)
    load_numpy(b.collect_params(), {
        k.replace(a.prefix, b.prefix, 1): p.data().asnumpy()
        for k, p in a.collect_params().items()})
    plain = mx.parallel.SPMDTrainStep(a, _lm_loss(mx), "adam", {})
    opted = mx.parallel.SPMDTrainStep(b, _lm_loss(mx), "adam", {}, **kwargs)
    assert [plain(tx, ty, lr=1e-3) for _ in range(2)] == \
        [opted(tx, ty, lr=1e-3) for _ in range(2)]
    for p, q in zip(plain._state[0], opted._state[0]):
        assert torch.equal(p, q)


def test_bad_arguments_raise_like_jax():
    net = mx.models.llama_tiny()
    with pytest.raises(mx.MXNetError, match="zero_stage must be 0-3"):
        mx.parallel.SPMDTrainStep(net, _lm_loss(mx), zero_stage=5)
    with pytest.raises(mx.MXNetError, match="supports"):
        mx.parallel.SPMDTrainStep(net, _lm_loss(mx), "rmsprop")
    # ZeRO-1 on one device shards nothing: accepted
    mx.parallel.SPMDTrainStep(net, _lm_loss(mx), zero_stage=1)
