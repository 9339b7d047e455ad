"""Port parity: BERT through the Gluon loop, ``mxnet_tpu_torch`` against the
JAX package, at ``bench_bert``'s CPU size (``bert_12_768_12`` cut to vocab
1000, 2 layers, units 64, hidden 128, 4 heads, max_length 64; batch 2,
sequence 16; no pooler or classifier; dropout 0).

The port's net gets the JAX net's initial weights name for name
(``gluon.utils.load_numpy``); token ids and labels come from a numpy seed.

Tolerances (float32): forward outputs 1e-5 relative to max |value| (two
post-norm layers of float32 products over at most 128 terms; the two
sides differ in summation order only, ~1e-6). Training: 3 steps of Adam
(lr 1e-3, wd 0.01, the bench's optimizer at a rate that moves the loss in
3 steps); losses within 1e-5 relative, and final weights within 1e-5
absolute plus 1e-4 relative. The absolute part is for the attention's key
bias: its gradient is zero in exact arithmetic (softmax ignores a shift
shared by all keys), so both sides update it by float32 noise scaled by
Adam's 1/(sqrt(v) + eps), a few 1e-6 after 3 steps.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.models import bert as jbert
from mxnet_tpu_torch.gluon.block import reset_names
from mxnet_tpu_torch.gluon.utils import load_numpy

CFG = dict(vocab_size=1000, dropout=0.0, num_layers=2, units=64,
           hidden_size=128, num_heads=4, max_length=64, use_pooler=False,
           use_classifier=False)
BATCH, SEQ = 2, 16


def _nets():
    jnet = jbert.get_bert_model("bert_12_768_12", **CFG)
    jnet.initialize(init=jmx.initializer.Normal(0.02))
    reset_names()
    tnet = mx.models.get_bert_model("bert_12_768_12", **CFG)
    tnet.initialize(init=mx.initializer.Normal(0.02), ctx=mx.cpu())
    jparams = jnet.collect_params()
    ids = np.random.RandomState(0).randint(0, 1000, (BATCH, SEQ))
    # deferred shapes resolve at the first forward on both sides
    jnet(jmx.nd.array(ids, dtype="int32"))
    tnet(mx.nd.array(ids, dtype="int32", ctx=mx.cpu()))
    arrays = {k.replace(jnet.prefix, "bertmodel0_", 1): p.data().asnumpy()
              for k, p in jparams.items()}
    load_numpy(tnet.collect_params(), arrays)
    return jnet, tnet


def _batch():
    rs = np.random.RandomState(0)
    x = rs.randint(0, 1000, (BATCH, SEQ))
    y = rs.randint(0, 1000, (BATCH, SEQ)).astype(np.float32)
    return x, y


def _close(got, want, rtol):
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rtol * scale, \
        (float(np.abs(got - want).max()), scale)


def test_parameter_names_equal_the_jax_package():
    jnet = jbert.get_bert_model("bert_12_768_12", **CFG)
    reset_names()
    tnet = mx.models.get_bert_model("bert_12_768_12", **CFG)
    assert tnet.prefix == "bertmodel0_"
    want = [k.replace(jnet.prefix, "bertmodel0_", 1)
            for k in jnet.collect_params().keys()]
    assert list(tnet.collect_params().keys()) == want
    assert "bertmodel0_encoder_cells_transformer0_attn_query_weight" in want
    for k, p in jnet.collect_params().items():
        assert tnet.collect_params()[
            k.replace(jnet.prefix, "bertmodel0_", 1)].shape == p.shape


def test_forward_matches_jax():
    jnet, tnet = _nets()
    x, _ = _batch()
    jout = jnet(jmx.nd.array(x, dtype="int32"))
    tout = tnet(mx.nd.array(x, dtype="int32", ctx=mx.cpu()))
    assert isinstance(tout, tuple) and len(tout) == len(jout) == 2
    for t, j in zip(tout, jout):
        assert t.shape == j.shape
        _close(t.asnumpy(), j.asnumpy(), 1e-5)
    assert tout[1].shape == (BATCH, SEQ, 1000)


def test_pooler_classifier_and_masked_positions_match_jax():
    """The full-head configuration (pooler, NSP classifier, token types,
    masked positions) gives the JAX package's outputs too."""
    cfg = dict(CFG, use_pooler=True, use_classifier=True)
    jnet = jbert.get_bert_model("bert_12_768_12", **cfg)
    jnet.initialize(init=jmx.initializer.Normal(0.02))
    reset_names()
    tnet = mx.models.get_bert_model("bert_12_768_12", **cfg)
    tnet.initialize(init=mx.initializer.Normal(0.02), ctx=mx.cpu())
    rs = np.random.RandomState(4)
    x = rs.randint(0, 1000, (BATCH, SEQ))
    types = rs.randint(0, 2, (BATCH, SEQ)).astype(np.float32)
    masked = rs.randint(0, SEQ, (BATCH, 3)).astype(np.float32)
    jargs = [jmx.nd.array(a) for a in (x, types, masked)]
    targs = [mx.nd.array(a, ctx=mx.cpu()) for a in (x, types, masked)]
    jnet(jargs[0], jargs[1])
    tnet(targs[0], targs[1])
    load_numpy(tnet.collect_params(),
               {k.replace(jnet.prefix, "bertmodel0_", 1): p.data().asnumpy()
                for k, p in jnet.collect_params().items()})
    jout = jnet(jargs[0], jargs[1], None, jargs[2])
    tout = tnet(targs[0], targs[1], None, targs[2])
    assert len(tout) == len(jout) == 4
    for t, j in zip(tout, jout):
        assert t.shape == j.shape
        _close(t.asnumpy(), j.asnumpy(), 1e-5)


def _train(mxmod, net, ctx_kw, steps):
    x, y = _batch()
    xa = mxmod.nd.array(x, dtype="int32", **ctx_kw)
    ya = mxmod.nd.array(y, **ctx_kw)
    sce = mxmod.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mxmod.gluon.Trainer(net.collect_params(), "adam",
                                  {"learning_rate": 1e-3, "wd": 0.01})
    losses = []
    for _ in range(steps):
        with mxmod.autograd.record():
            loss = sce(net(xa)[-1], ya)
        loss.backward()
        trainer.step(BATCH)
        losses.append(loss.asnumpy())
    return np.stack(losses)


def test_three_adam_steps_match_jax():
    jnet, tnet = _nets()
    jl = _train(jmx, jnet, {}, 3)
    tl = _train(mx, tnet, {"ctx": mx.cpu()}, 3)
    assert tl.shape == (3, BATCH)
    _close(tl, jl, 1e-5)
    assert tl[-1].mean() < tl[0].mean()  # the loss falls on the fixed batch
    tparams = tnet.collect_params()
    for k, p in jnet.collect_params().items():
        got = tparams[k.replace(jnet.prefix, "bertmodel0_", 1)].data()
        np.testing.assert_allclose(got.asnumpy(), p.data().asnumpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_bench_bert_kernel_launch_counts_on_cuda():
    """On the card, one forward launches K1 once per layer and one
    backward each K2 kernel once per layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mxnet_tpu_torch.ops import _kernels

    net = mx.models.get_bert_model("bert_12_768_12", **CFG)
    net.initialize(init=mx.initializer.Normal(0.02))
    x, y = _batch()
    sce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    xa, ya = mx.nd.array(x, dtype="int32"), mx.nd.array(y)
    net(xa)  # resolve deferred shapes
    _kernels.LAUNCHES.clear()
    with mx.autograd.record():
        loss = sce(net(xa)[-1], ya)
    loss.backward()
    mx.nd.waitall()
    assert _kernels.LAUNCHES["flash_fwd"] == CFG["num_layers"]
    assert _kernels.LAUNCHES["flash_bwd_dq"] == CFG["num_layers"]
    assert _kernels.LAUNCHES["flash_bwd_dkv"] == CFG["num_layers"]
