"""Port parity: BERT's pretraining step as the JAX package defines the
model (``BERTModel`` with its pooler, NSP classifier and MLM decoder), at
a CPU size (``bert_12_768_12`` cut to 2 layers, units 64, hidden 128, 4
heads, vocab 1000; batch 4, sequence 16), dropout 0.

The JAX net's weights reach the port through a ``.params`` file
(``save_parameters``/``load_parameters``). Both packages then run the
pretraining loss of ``chip_smoke.py``'s ``[bert-pretrain]``
(``chip_smoke.pretrain_loss``, written over either package) through their
own ``nd`` operators on the same numpy batch: 15% of the positions
(a numpy mask) replaced by a mask id with ``nd.where``, the MLM
cross-entropy over the masked positions (``nd.log_softmax``,
``nd.pick``, weighted by the mask) plus the NSP cross-entropy
(``nd.softmax_cross_entropy``), one backward and one Adam step (lr 1e-3,
wd 0.01), then the MLM accuracy readout (``nd.topk``, ``nd.argmax``,
``nd.broadcast_equal``).

Tolerances (float32; the two sides round in another order): loss 1e-5
relative; each gradient within 1e-4 of its layer's largest |gradient| (a
key bias's gradient is float noise on both sides, judged against its
layer); weights after the step within 1e-5 absolute plus 1e-4 relative;
the top-1 and top-5 hits equal.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from chip_smoke import mlm_hits, pretrain_loss

CFG = dict(vocab_size=1000, dropout=0.0, num_layers=2, units=64,
           hidden_size=128, num_heads=4, max_length=64)
BATCH, SEQ, MASK_ID = 4, 16, 3
KW = {"ctx": mx.cpu()}


def _batch():
    rs = np.random.RandomState(0)
    ids = rs.randint(5, 1000, (BATCH, SEQ)).astype(np.int32)
    types = (np.arange(SEQ) >= SEQ // 2).astype(np.int32)[None].repeat(
        BATCH, 0)
    mask = (rs.uniform(size=(BATCH, SEQ)) < 0.15).astype(np.float32)
    mask[:, 1] = 1.0  # every row has a masked position
    nsp = rs.randint(0, 2, (BATCH,)).astype(np.float32)
    return ids, types, mask, nsp


def _run(mod, net, kw):
    ids_np, types_np, mask_np, nsp_np = _batch()
    nd = mod.nd
    ids = nd.array(ids_np, dtype="int32", **kw)
    types = nd.array(types_np, dtype="int32", **kw)
    mask = nd.array(mask_np, **kw)
    nsp = nd.array(nsp_np, **kw)
    trainer = mod.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 1e-3, "wd": 0.01})
    with mod.autograd.record():
        loss, mlm = pretrain_loss(mod, net, ids, types, mask, nsp,
                                  mask_id=MASK_ID)
    loss.backward()
    grads = {k: np.array(p.grad().asnumpy())
             for k, p in net.collect_params().items()}
    hits = mlm_hits(mod, mlm, ids, mask)
    trainer.step(1)
    weights = {k: np.array(p.data().asnumpy())
               for k, p in net.collect_params().items()}
    return float(loss.asscalar()), grads, hits, weights


def test_pretraining_step_matches_jax(tmp_path):
    jnet = jmx.models.get_bert_model("bert_12_768_12", **CFG)
    jnet.initialize(init=jmx.initializer.Normal(0.02))
    ids, types, _, _ = _batch()
    jnet(jmx.nd.array(ids, dtype="int32"), jmx.nd.array(types, dtype="int32"))
    path = str(tmp_path / "bert.params")
    jnet.save_parameters(path)
    tnet = mx.models.get_bert_model("bert_12_768_12", **CFG)
    tnet.load_parameters(path, ctx=mx.cpu())
    assert len(tnet(mx.nd.array(ids, dtype="int32", **KW),
                    mx.nd.array(types, dtype="int32", **KW))) == 4

    jloss, jgrads, jhits, jw = _run(jmx, jnet, {})
    tloss, tgrads, thits, tw = _run(mx, tnet, KW)
    assert abs(tloss - jloss) <= 1e-5 * abs(jloss)
    tkeys = list(tgrads)
    assert len(tkeys) == len(jgrads)
    layer = {}
    for k, g in zip(tkeys, jgrads.values()):
        blk = k.rsplit("_", 1)[0]
        layer[blk] = max(layer.get(blk, 0.0), float(np.abs(g).max()))
    for k, want in zip(tkeys, jgrads.values()):
        err = float(np.abs(tgrads[k] - want).max())
        assert err <= 1e-4 * max(layer[k.rsplit("_", 1)[0]], 1e-30), k
    for k, want in zip(tkeys, jw.values()):
        np.testing.assert_allclose(tw[k], want, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert thits == jhits
    assert np.isfinite(tloss)


def test_the_full_model_has_the_jax_package_parameters():
    """``mx.models.bert_base()`` with the reference's defaults: dropout
    0.1, pooler, NSP classifier and MLM decoder, vocab 30522; the same
    parameter names and shapes as the JAX package's (counted without
    allocating: shapes are known before initialisation, but the word
    embedding's input width)."""
    jnet = jmx.models.bert_base()
    tnet = mx.models.bert_base()
    jp, tp = jnet.collect_params(), tnet.collect_params()
    strip = (lambda k, net: k.replace(net.prefix, "", 1))
    assert [strip(k, jnet) for k in jp] == [strip(k, tnet) for k in tp]
    assert [p.shape for p in jp.values()] == [p.shape for p in tp.values()]
    assert tnet.encoder.dropout is not None and tnet.encoder.dropout._rate \
        == 0.1
    for name in ("pooler", "classifier", "decoder"):
        assert hasattr(tnet, name)


def test_pretraining_step_on_cuda(tmp_path):
    """The cut BERT's pretraining step on the card (K1/K2) against the
    port on the host, at dropout 0; then at dropout 0.1 two steps from one
    ``mx.random.seed`` equal bit for bit."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    host = mx.models.get_bert_model("bert_12_768_12", **CFG)
    host.initialize(init=mx.initializer.Normal(0.02), ctx=mx.cpu())
    ids, types, _, _ = _batch()
    host(mx.nd.array(ids, dtype="int32", **KW),
         mx.nd.array(types, dtype="int32", **KW))
    path = str(tmp_path / "bert.params")
    host.save_parameters(path)
    card = mx.models.get_bert_model("bert_12_768_12", **CFG)
    card.load_parameters(path, ctx=mx.gpu(0))
    hloss, hgrads, _, _ = _run(mx, host, KW)
    closs, cgrads, _, _ = _run(mx, card, {"ctx": mx.gpu(0)})
    assert abs(closs - hloss) <= 1e-5 * abs(hloss)
    for (k, want), got in zip(hgrads.items(), cgrads.values()):
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= 1e-4 * scale or \
            scale < 1e-6, k
    cfg = dict(CFG, dropout=0.1)
    losses = []
    for _ in range(2):
        net = mx.models.get_bert_model("bert_12_768_12", **cfg)
        net.load_parameters(path, ctx=mx.gpu(0))
        mx.random.seed(0)
        losses.append(_run(mx, net, {"ctx": mx.gpu(0)})[0])
    assert losses[0] == losses[1]
