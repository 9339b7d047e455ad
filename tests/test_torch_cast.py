"""Port parity: ``Block.cast`` and ``Parameter.cast`` against the JAX
package's.

- A 2-layer BERT (``test_torch_bert.py``'s CPU size) with the JAX net's
  weights, cast to bfloat16 in both packages: the forward's output within
  1e-2 of the reference output's largest magnitude (each side rounds every
  bfloat16 product and sum its own way; 2^-7 relative per rounding,
  compounded over two post-norm layers).
- ``Parameter.cast`` casts the data and the gradient buffer of every
  copy, keeps the handles and replaces their tensors, so a Trainer's
  fused plan rebuilds and the next update writes the cast weights; a
  deferred parameter is created in the new type.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import numpy as np
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from test_torch_bert import BATCH, SEQ, _nets

KW = {"ctx": mx.cpu()}


def test_bert_forward_in_bfloat16_matches_jax():
    jnet, tnet = _nets()
    jnet.cast("bfloat16")
    tnet.cast("bfloat16")
    ids = np.random.RandomState(1).randint(0, 1000, (BATCH, SEQ))
    jout = jnet(jmx.nd.array(ids, dtype="int32"))
    tout = tnet(mx.nd.array(ids, dtype="int32", **KW))
    assert len(jout) == len(tout)
    for j, t in zip(jout, tout):
        assert t.data.dtype == torch.bfloat16 and str(j.dtype) == "bfloat16"
        want = np.array(j.astype("float32").asnumpy())
        got = t.astype("float32").asnumpy()
        scale = float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= 1e-2 * scale
    for k, p in tnet.collect_params().items():
        assert p.dtype == "bfloat16" and p.data().data.dtype == \
            torch.bfloat16, k


def test_parameter_cast_casts_data_and_gradient_and_keeps_handles():
    p = mx.gluon.Parameter("w", shape=(3, 4))
    p.initialize(ctx=mx.cpu())
    h, g = p.data(), p.grad()
    w32 = h.data.clone()
    p.cast("bfloat16")
    assert p.data() is h and p.grad() is g and p.dtype == "bfloat16"
    assert h.data.dtype == g.data.dtype == torch.bfloat16
    assert h.data.requires_grad
    assert torch.equal(h.data, w32.to(torch.bfloat16))
    p.cast(np.float32)
    assert p.dtype == "float32" and h.data.dtype == torch.float32
    p.cast(torch.float16)
    assert p.dtype == "float16" and g.data.dtype == torch.float16
    q = mx.gluon.Parameter("q", shape=(2, 0), allow_deferred_init=True)
    q.initialize(ctx=mx.cpu())
    q.cast("bfloat16")
    q.shape = (2, 5)
    q._finish_deferred_init()
    assert q.data().data.dtype == torch.bfloat16


def test_cast_rebuilds_the_fused_plan():
    net = mx.gluon.nn.Dense(3, in_units=4)
    net.initialize(**KW)
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1, "momentum": 0.9,
                           "multi_precision": True})
    x = mx.nd.array(np.random.RandomState(0).randn(2, 4), **KW)

    def step(x):
        with mx.autograd.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        tr.step(2)

    step(x)
    plan = tr._fused
    net.cast("bfloat16")
    step(x.astype("bfloat16"))
    assert isinstance(tr._fused, dict) and tr._fused is not plan
    for p in net.collect_params().values():
        master = tr._fused_states[p.name][0]
        assert master.dtype == torch.float32
        assert torch.equal(p.data().data, master.to(torch.bfloat16))
