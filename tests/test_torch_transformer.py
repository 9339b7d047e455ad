"""Port parity: the seq2seq Transformer (``models/transformer.py``) of
``mxnet_tpu_torch`` against the JAX package's, at a small size:
Transformer(src vocab 12, tgt vocab 9, 2 + 2 layers, units 32, hidden
64, 4 heads, dropout 0), batch 2, source length 7, target length 5, so
the decoder's cross-attention runs with T != S.

The JAX net's weights are carried into the port through a ``.params``
file (``save_parameters`` / ``load_parameters``); tokens come from a
numpy seed. Tolerances (float32, sums in other orders): the forward
within 1e-5 relative to the largest |logit|; the losses of 3 Adam steps
(lr 1e-3) within 1e-5 relative; the port's hybridized net equal to its
eager net bit for bit on the CPU (the same operators in the same order;
on the card 1e-6 relative, as ``test_torch_hybridize.py`` allows).
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.models import transformer as jtr

KW = {"ctx": mx.cpu()}
CFG = dict(num_layers=2, units=32, hidden_size=64, num_heads=4, dropout=0.0,
           max_length=16)
SRC_V, TGT_V, B, S, T = 12, 9, 2, 7, 5
TOL = 1e-5


def _tokens():
    rs = np.random.RandomState(0)
    return (rs.randint(0, SRC_V, (B, S)), rs.randint(0, TGT_V, (B, T)),
            rs.randint(0, TGT_V, (B, T)).astype(np.float32))


def _close(got, want, rtol=TOL):
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rtol * scale, \
        (float(np.abs(got - want).max()), scale)


def _nets(tmp_path, ctx_kw=KW):
    jnet = jtr.Transformer(SRC_V, TGT_V, **CFG)
    jnet.initialize(init=jmx.initializer.Normal(0.02))
    src, tgt, _ = _tokens()
    jnet(jmx.nd.array(src), jmx.nd.array(tgt))
    path = str(tmp_path / "transformer.params")
    jnet.save_parameters(path)
    tnet = mx.models.Transformer(SRC_V, TGT_V, **CFG)
    tnet.initialize(**ctx_kw)
    tnet(mx.nd.array(src, **ctx_kw), mx.nd.array(tgt, **ctx_kw))
    tnet.load_parameters(path)
    return jnet, tnet, path


def test_parameter_names_and_count_equal_the_jax_package(tmp_path):
    jnet, tnet, path = _nets(tmp_path)
    assert list(tnet._collect_params_with_prefix()) == \
        list(jnet._collect_params_with_prefix())
    n = sum(int(np.prod(p.shape)) for p in tnet.collect_params().values())
    assert n == sum(int(np.prod(p.shape))
                    for p in jnet.collect_params().values())
    assert isinstance(tnet.dec_cells[0], mx.models.TransformerDecoderCell)


def test_forward_matches_jax(tmp_path):
    jnet, tnet, _ = _nets(tmp_path)
    src, tgt, _ = _tokens()
    want = np.array(jnet(jmx.nd.array(src), jmx.nd.array(tgt)).asnumpy())
    got = tnet(mx.nd.array(src, **KW), mx.nd.array(tgt, **KW))
    assert got.shape == (B, T, TGT_V)
    _close(got.asnumpy(), want)


def _train(m, net, ctx_kw, steps=3):
    src, tgt, y = _tokens()
    xs, xt = m.nd.array(src, **ctx_kw), m.nd.array(tgt, **ctx_kw)
    ya = m.nd.array(y, **ctx_kw)
    sce = m.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = m.gluon.Trainer(net.collect_params(), "adam",
                              {"learning_rate": 1e-3, "beta2": 0.98,
                               "epsilon": 1e-9})
    losses = []
    for _ in range(steps):
        with m.autograd.record():
            loss = sce(net(xs, xt), ya)
        loss.backward()
        trainer.step(B)
        losses.append(np.array(loss.asnumpy()))
    return np.stack(losses)


def test_three_adam_steps_match_jax(tmp_path):
    jnet, tnet, _ = _nets(tmp_path)
    jl = _train(jmx, jnet, {})
    tl = _train(mx, tnet, KW)
    _close(tl, jl)
    assert tl[-1].mean() < tl[0].mean()


def _hybrid_pair(tmp_path, ctx_kw):
    _, eager, path = _nets(tmp_path, ctx_kw)
    hybrid = mx.models.Transformer(SRC_V, TGT_V, **CFG)
    hybrid.initialize(**ctx_kw)
    src, tgt, _ = _tokens()
    hybrid(mx.nd.array(src, **ctx_kw), mx.nd.array(tgt, **ctx_kw))
    hybrid.load_parameters(path)
    hybrid.hybridize()
    return eager, hybrid


def _loss_and_grads(net, ctx_kw):
    src, tgt, y = _tokens()
    sce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        loss = sce(net(mx.nd.array(src, **ctx_kw),
                       mx.nd.array(tgt, **ctx_kw)), mx.nd.array(y, **ctx_kw))
    loss.backward()
    return loss.data.detach().clone(), [
        p.grad().data.clone() for p in
        net._collect_params_with_prefix().values()]


def test_hybridized_equals_eager(tmp_path):
    eager, hybrid = _hybrid_pair(tmp_path, KW)
    for _ in range(2):  # the entry's build, then a cached call
        le, ge = _loss_and_grads(eager, KW)
        lh, gh = _loss_and_grads(hybrid, KW)
        assert torch.equal(le, lh)
        assert all(torch.equal(a, b) for a, b in zip(ge, gh))
    assert len(hybrid._cached_graph._cache) == 1


def test_hybridized_equals_eager_on_cuda(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mxnet_tpu_torch.ops import _kernels

    kw = {"ctx": mx.gpu(0)}
    eager, hybrid = _hybrid_pair(tmp_path, kw)
    _kernels.LAUNCHES.clear()
    le, ge = _loss_and_grads(eager, kw)
    # 2 encoder self, 2 decoder causal self and 2 cross layers
    assert _kernels.LAUNCHES["flash_fwd"] == 3 * CFG["num_layers"]
    assert _kernels.LAUNCHES["flash_bwd_dq"] == 3 * CFG["num_layers"]
    assert _kernels.LAUNCHES["flash_bwd_dkv"] == 3 * CFG["num_layers"]
    for _ in range(2):
        lh, gh = _loss_and_grads(hybrid, kw)
    torch.cuda.synchronize()
    _close(lh.cpu().numpy(), le.cpu().numpy(), 1e-6)
    for a, b in zip(gh, ge):
        _close(a.cpu().numpy(), b.cpu().numpy(), 1e-6)
