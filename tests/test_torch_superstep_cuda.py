"""The captured ``gluon.Superstep`` on a CUDA card (skipped without one).

The K iterations of a superstep are one CUDA graph on the card. These
tests hold a replay against the same iterations run eagerly on the card
(``Superstep._graphed = False``, the CPU's path), bit for bit: a 2-layer
BERT in bfloat16 under the AMP policy with Adam's fp32 masters; a float16
MLP whose second superstep has a NaN batch in slot 0 (that iteration
skips inside the graph, the other applies, the scale halves); a learning
rate changed between supersteps, which needs no new capture; and
``load_checkpoint`` into a net whose superstep is captured, which writes
the tensors the graph reads in place. This file imports no JAX.
"""

import gc

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import amp, gluon, resilience
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.data.prefetcher import stack_batches
from mxnet_tpu_torch.resilience import chaos


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # blocks hold their graphs in reference cycles: free what earlier
    # tests left before capturing
    gc.collect()
    torch.cuda.empty_cache()
    return mx.gpu(0)


@pytest.fixture(autouse=True)
def _clean():
    yield
    amp.disable()
    chaos.reset()


def _equal_params(a, b):
    """Every parameter equal bit for bit, matched by structural name (the
    global names' counters differ between two nets, and sort differently
    across a digit boundary)."""
    pa, pb = (n._collect_params_with_prefix() for n in (a, b))
    return pa.keys() == pb.keys() and all(
        torch.equal(pa[k].data().data, pb[k].data().data) for k in pa)


class _Pretrain(gluon.HybridBlock):
    """ids and token types stacked on axis 1 -> (NSP, MLM) logits."""

    def __init__(self, net, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.net = net

    def hybrid_forward(self, F, x):
        out = self.net(x[:, 0], x[:, 1])
        return out[-2], out[-1]


def _pretrain_loss(out, y):
    nsp, mlm = out
    T = mlm.shape[1]
    labels, mask, nsp_y = y[:, :T], y[:, T:2 * T], y[:, 2 * T]
    ce = -mx.nd.pick(mx.nd.log_softmax(mlm, axis=-1), labels, axis=-1)
    return (ce * mask).sum() / mask.sum() + \
        mx.nd.softmax_cross_entropy(nsp, nsp_y) / mlm.shape[0]


def _bert_batches(n, B=4, T=16, vocab=100, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rs.randint(0, vocab, (B, T))
        mask = (rs.rand(B, T) < 0.15).astype(np.float32)
        inputs = np.where(mask > 0, 3, ids)
        types = np.repeat((np.arange(T) >= T // 2)[None], B, 0)
        x = np.stack([inputs, types], 1).astype(np.int32)
        y = np.concatenate([ids, mask, rs.randint(0, 2, (B, 1))], 1)
        out.append((x, y.astype(np.float32)))
    return out


def _bert(ctx):
    mx.random.seed(0)
    net = mx.models.bert_base(num_layers=2, units=64, hidden_size=128,
                              num_heads=4, vocab_size=100, max_length=64,
                              dropout=0.0)
    net.initialize(init=mx.initializer.Normal(0.02, seed=0), ctx=ctx)
    block = _Pretrain(net)
    amp.convert_model(block, "bfloat16")
    block.hybridize()
    tr = gluon.Trainer(block.collect_params(), "adam",
                       {"learning_rate": 1e-3, "wd": 0.01,
                        "multi_precision": True})
    return block, tr


def _stack(batches, ctx):
    xs = stack_batches([mx.nd.array(x, dtype="int32", ctx=ctx)
                        for x, _ in batches])
    ys = stack_batches([mx.nd.array(y, ctx=ctx) for _, y in batches])
    return xs, ys


def test_captured_superstep_equals_eager_iterations_bf16_bert_on_cuda():
    ctx = _cuda()
    amp.init("bfloat16")
    batches = _bert_batches(8)
    runs = []
    for graphed in (True, False):
        block, tr = _bert(ctx)
        ss = gluon.Superstep(block, _pretrain_loss, tr, k=4)
        ss._graphed = graphed
        losses = [ss.step(*_stack(batches[i:i + 4], ctx), 4).data
                  for i in (0, 4)]
        torch.cuda.synchronize()
        runs.append((block, torch.cat(losses), ss))
    (a, la, sa), (b, lb, sb) = runs
    assert sa.replays == 2 and sb.replays == 0
    assert torch.equal(la, lb), (la, lb)
    assert torch.isfinite(la).all()
    assert _equal_params(a, b)
    qb = b._collect_params_with_prefix()
    for k, p in a._collect_params_with_prefix().items():
        sp = sa._trainer._fused_states.get(p.name)
        sq = sb._trainer._fused_states.get(qb[k].name)
        assert (sp is None) == (sq is None)
        if sp is not None:
            assert all(torch.equal(u, v) for u, v in zip(sp, sq))


def _mlp16(ctx):
    mx.random.seed(0)
    net = nn.HybridSequential()
    net.add(nn.Dense(32, activation="relu", in_units=16),
            nn.Dense(4, in_units=32))
    net.initialize(init=mx.initializer.Xavier(), ctx=ctx)
    amp.convert_model(net, "float16")
    net.hybridize()
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.05, "momentum": 0.9,
                        "multi_precision": True})
    tr._amp_loss_scaler = amp.LossScaler(init_scale=1024.0)
    return net, tr


def _mlp_batches(n, ctx, dtype="float16"):
    rs = np.random.RandomState(1)
    xs = [mx.nd.array(rs.randn(8, 16).astype(np.float32), ctx=ctx)
          .astype(dtype) for _ in range(n)]
    ys = [mx.nd.array(rs.randint(0, 4, (8,)).astype(np.float32), ctx=ctx)
          for _ in range(n)]
    return xs, ys


def test_fp16_skip_inside_the_graph_on_cuda():
    ctx = _cuda()
    amp.init("float16")
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    xs, ys = _mlp_batches(6, ctx)
    runs = []
    for graphed in (True, False):
        chaos.configure("nan@superstep:2")
        net, tr = _mlp16(ctx)
        ss = gluon.Superstep(net, loss_fn, tr, k=2)
        ss._graphed = graphed
        flags, scales, before = [], [], None
        for g in range(3):
            if g == 1:
                before = [p.data().data.clone() for _, p in
                          sorted(net._collect_params_with_prefix().items())]
            ss.step(stack_batches(xs[2 * g:2 * g + 2]),
                    stack_batches(ys[2 * g:2 * g + 2]), 8)
            flags.append(ss.last_overflow.tolist())
            scales.append(tr._amp_loss_scaler.loss_scale)
            if g == 1:
                moved = any(not torch.equal(b, p.data().data) for b, (_, p)
                            in zip(before, sorted(
                                net._collect_params_with_prefix().items())))
        runs.append((net, flags, scales, moved,
                     tr._amp_loss_scaler.overflow_total))
        chaos.reset()
    (a, fa, sa, ma, oa), (b, fb, sb, mb, ob) = runs
    assert fa == fb == [[0.0, 0.0], [1.0, 0.0], [0.0, 0.0]]
    assert sa == sb == [1024.0, 512.0, 512.0]
    assert oa == ob == 1
    assert ma and mb  # the other iteration of that superstep applied
    assert _equal_params(a, b)
    for _, p in a.collect_params().items():
        assert torch.isfinite(p.data().data.float()).all()


def test_lr_changed_between_supersteps_needs_no_capture_on_cuda():
    ctx = _cuda()
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    xs, ys = _mlp_batches(6, ctx, dtype="float32")
    runs = []
    for graphed in (True, False):
        mx.random.seed(0)
        net = nn.HybridSequential()
        net.add(nn.Dense(32, activation="relu", in_units=16),
                nn.Dense(4, in_units=32))
        net.initialize(init=mx.initializer.Xavier(), ctx=ctx)
        net.hybridize()
        tr = gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": 0.01})
        ss = gluon.Superstep(net, loss_fn, tr, k=2)
        ss._graphed = graphed
        graphs = []
        for g, lr in enumerate((0.01, 0.002, 0.02)):
            tr.set_learning_rate(lr)
            ss.step(stack_batches(xs[2 * g:2 * g + 2]),
                    stack_batches(ys[2 * g:2 * g + 2]), 8)
            graphs.append(ss._plan["graph"])
        runs.append((net, graphs))
    (a, ga), (b, _) = runs
    assert ga[0] is not None and ga[0] is ga[1] is ga[2]
    assert _equal_params(a, b)


def test_load_checkpoint_into_a_captured_superstep_on_cuda(tmp_path):
    ctx = _cuda()
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    xs, ys = _mlp_batches(4, ctx, dtype="float32")
    mx.random.seed(0)
    net = nn.HybridSequential()
    net.add(nn.Dense(32, activation="relu", in_units=16),
            nn.Dropout(0.3), nn.Dense(4, in_units=32))
    net.initialize(init=mx.initializer.Xavier(), ctx=ctx)
    net.hybridize()
    tr = gluon.Trainer(net.collect_params(), "adam", {"learning_rate": 0.01})
    ss = gluon.Superstep(net, loss_fn, tr, k=2)
    mgr = resilience.CheckpointManager(tmp_path, every_n_steps=2, net=net,
                                       trainer=tr, install_sigterm=False)
    mgr.attach()
    ss.step(stack_batches(xs[:2]), stack_batches(ys[:2]), 8)
    assert mgr.flush()
    graph = ss._plan["graph"]
    first = ss.step(stack_batches(xs[2:]), stack_batches(ys[2:]), 8)
    want = [p.data().data.clone() for _, p in
            sorted(net._collect_params_with_prefix().items())]
    mgr.close()
    resilience.load_checkpoint(str(tmp_path / "step_0000000002"), net=net,
                               trainer=tr)
    again = ss.step(stack_batches(xs[2:]), stack_batches(ys[2:]), 8)
    assert ss._plan["graph"] is graph  # restored in place: no capture
    assert torch.equal(first.data, again.data)
    for w, (_, p) in zip(want,
                         sorted(net._collect_params_with_prefix().items())):
        assert torch.equal(w, p.data().data)
