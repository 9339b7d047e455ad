"""Port parity: ``mx.kv`` against the JAX package's ``kvstore``.

Every case of ``tests/test_kvstore.py`` runs through both packages on the
same values (init/pull, push aggregation, ``pushpull``'s allreduce
semantics, an updater, ``set_optimizer``, list keys, ``dist_tpu_sync`` in
one process, the type aliases, the grouped pushpull over ``cpu(0)`` and
``cpu(1)``); ``row_sparse_pull`` raises in the port, naming A13 (the
sparse NDArray). The bucketed pushpull with and without 2-bit compression
follows ``tests/test_overlap_zero.py``'s per-key reference over three
iterations, and ``parallel.overlap.compress_bucket`` equals the JAX
package's bit for bit. The Trainer over two contexts (``kvstore="device"``
with ``split_and_load``) is held against the JAX package's on a two-layer
MLP and a two-layer, narrow BERT with SGD and Adam.

Tolerances: the store's sums of float32 terms round alike in both
packages (exact). The MLP's weights after three steps agree within 1e-6
relative + 1e-7 absolute: its matrix products sum in another order (one
float32 step apart after three SGD steps), and Adam's bias correction is
computed in double by the port and in float32 by the JAX package
(``optimizer/multi_tensor.py``). BERT's forward sums in another order
still, so its weights after two steps agree within 1e-5 absolute + 1e-4
relative. The copies on the two contexts are equal exactly.

The JAX package's eager multi-context update copies the first context's
new weight into the others without moving it to their device
(``gluon/trainer.py:_update_eager``), so its second step on ``cpu(1)``
fails on mixed devices; the comparison moves each copy back to its
context after every step on the JAX side only.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
import torch
from chip_smoke import pretrain_loss
from mxnet_tpu.parallel import overlap as joverlap
from mxnet_tpu_torch.parallel import overlap as toverlap

SHAPE = (4, 4)
PKGS = ((jmx, {}), (mx, {"ctx": mx.cpu()}))


def _np(a):
    return np.array(a.asnumpy())


def _both(fn):
    """``fn(m, kw)`` through both packages; the results as numpy."""
    out = []
    for m, kw in PKGS:
        res = fn(m, kw)
        out.append([_np(r) for r in res] if isinstance(res, list)
                   else _np(res))
    return out


def _case_init_pull(m, kw):
    kv = m.kv.create("local")
    kv.init(3, m.nd.ones(SHAPE, **kw))
    out = m.nd.zeros(SHAPE, **kw)
    kv.pull(3, out=out)
    return out


def _case_push_aggregation(m, kw):
    kv = m.kv.create("local")
    kv.init(3, m.nd.ones(SHAPE, **kw))
    kv.push(3, [m.nd.ones(SHAPE, **kw) * 2] * 4)
    out = m.nd.zeros(SHAPE, **kw)
    kv.pull(3, out=out)
    return out


def _case_pushpull(m, kw):
    kv = m.kv.create("device")
    kv.init("w", m.nd.ones(SHAPE, **kw))
    grads = [m.nd.ones(SHAPE, **kw) * i for i in range(1, 4)]
    kv.pushpull("w", grads, out=grads)
    stored = m.nd.zeros(SHAPE, **kw)
    kv.pull("w", out=stored)
    return grads + [stored]


def _case_updater(m, kw):
    kv = m.kv.create("local")
    kv.init(1, m.nd.ones(SHAPE, **kw))

    def updater(key, grad, weight):
        weight -= 0.1 * grad

    kv.set_updater(updater)
    kv.push(1, [m.nd.ones(SHAPE, **kw)] * 2)
    out = m.nd.zeros(SHAPE, **kw)
    kv.pull(1, out=out)
    return out


def _case_set_optimizer(m, kw):
    kv = m.kv.create("local")
    kv.init(0, m.nd.ones(SHAPE, **kw))
    kv.set_optimizer(m.optimizer.SGD(learning_rate=0.5))
    kv.push(0, [m.nd.ones(SHAPE, **kw)])
    out = m.nd.zeros(SHAPE, **kw)
    kv.pull(0, out=out)
    return out


def _case_list_kv(m, kw):
    kv = m.kv.create("local")
    keys = [5, 7, 9]
    kv.init(keys, [m.nd.ones(SHAPE, **kw)] * 3)
    kv.push(keys, [[m.nd.ones(SHAPE, **kw) * 4]] * 3)
    outs = [m.nd.zeros(SHAPE, **kw) for _ in keys]
    kv.pull(keys, out=outs)
    return outs


def _case_dist_single_process(m, kw):
    kv = m.kv.create("dist_tpu_sync")
    assert kv.rank == 0 and kv.num_workers == 1
    kv.init("x", m.nd.ones(SHAPE, **kw))
    kv.push("x", [m.nd.ones(SHAPE, **kw) * 3])
    out = m.nd.zeros(SHAPE, **kw)
    kv.pull("x", out=out)
    kv.barrier()
    g = [m.nd.ones(SHAPE, **kw) * 5]
    kv.pushpull(["x"], [g], out=[g])
    return [out, g[0]]


CASES = {"init_pull": _case_init_pull,
         "push_aggregation": _case_push_aggregation,
         "pushpull_allreduce_semantics": _case_pushpull,
         "updater": _case_updater, "set_optimizer": _case_set_optimizer,
         "list_kv": _case_list_kv,
         "dist_tpu_sync_single_process": _case_dist_single_process}


@pytest.mark.parametrize("case", list(CASES))
def test_kvstore_case_matches_jax(case):
    want, got = (r if isinstance(r, list) else [r]
                 for r in _both(CASES[case]))
    assert len(want) == len(got)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("name", ["local", "device", "nccl", "dist",
                                  "dist_sync", "dist_device_sync",
                                  "dist_sync_device", "dist_async",
                                  "horovod", "local_allreduce_cpu",
                                  "local_allreduce_device",
                                  "dist_tpu_sync"])
def test_type_aliases(name):
    a, b = jmx.kv.create(name), mx.kv.create(name)
    assert a.type == b.type == name
    assert type(a).__name__ == type(b).__name__
    assert a.rank == b.rank == 0 and a.num_workers == b.num_workers == 1


def test_unknown_type_and_non_string_raise():
    for m, _ in PKGS:
        with pytest.raises(m.MXNetError, match="unknown KVStore"):
            m.kv.create("ps_lite")
        with pytest.raises(m.MXNetError, match="must be a string"):
            m.kv.create(3)


def test_row_sparse_pull_raises_naming_a13():
    kv = mx.kv.create("local")
    kv.init("emb", mx.nd.zeros((4, 3), ctx=mx.cpu()))
    with pytest.raises(mx.MXNetError, match="A13"):
        kv.row_sparse_pull("emb", out=mx.nd.zeros((4, 3), ctx=mx.cpu()),
                           row_ids=mx.nd.array([1, 3], ctx=mx.cpu()))


def _two_context_values(m, arrs):
    return [[m.nd.array(a.copy(), ctx=m.cpu(d)) for d in (0, 1)]
            for a in arrs]


def test_grouped_pushpull_multidevice():
    rng = np.random.RandomState(0)
    shapes = [(4, 3), (5,), (2, 2)]
    arrs = [[rng.rand(*sh).astype(np.float32) for _ in range(2)]
            for sh in shapes]
    got = []
    for m, kw in PKGS:
        kv = m.kv.create("device")
        keys = ["a", "b", "c"]
        vals, outs = [], []
        for k, sh, pair in zip(keys, shapes, arrs):
            kv.init(k, m.nd.zeros(sh, **kw))
            vals.append([m.nd.array(a, ctx=m.cpu(d))
                         for d, a in enumerate(pair)])
            outs.append(m.nd.zeros(sh, **kw))
        kv.pushpull(keys, vals, out=outs)
        got.append([_np(o) for o in outs])
    for a, b, pair in zip(*got, arrs):
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(b, pair[0] + pair[1])


@pytest.mark.parametrize("compress", [None, 0.3])
def test_bucketed_pushpull_matches_per_key_reference(compress, monkeypatch):
    """The bucketed multi-key pushpull (several keys per bucket: a 1 KiB
    target) against the per-key merge -> quantize -> residual semantics
    over three iterations, in both packages."""
    monkeypatch.setenv("MXTPU_BUCKET_BYTES", "1024")
    rng = np.random.RandomState(0)
    arrs = [rng.uniform(-1, 1, (64,)).astype(np.float32) for _ in range(5)]
    outs_by_pkg = []
    for m, kw in PKGS:
        kv = m.kv.create("device")
        if compress is not None:
            kv.set_gradient_compression({"type": "2bit",
                                         "threshold": compress})
        keys = list(range(len(arrs)))
        for i in keys:
            kv.init(i, m.nd.zeros((64,), **kw))
        vals = _two_context_values(m, arrs)
        outs = [m.nd.zeros((64,), **kw) for _ in arrs]
        per_it = []
        for _ in range(3):
            kv.pushpull(keys, vals, out=outs)
            per_it.append([_np(o) for o in outs])
        assert len(kv._bucket_plans) == 1
        outs_by_pkg.append(per_it)
    res = [np.zeros_like(a) for a in arrs]
    for it in range(3):
        for i, a in enumerate(arrs):
            acc = 2 * a + res[i]
            if compress is None:
                want = 2 * a
            else:
                want = np.where(acc >= compress, compress, np.where(
                    acc <= -compress, -compress, 0.0)).astype(np.float32)
                res[i] = acc - want
            np.testing.assert_allclose(outs_by_pkg[1][it][i], want,
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_array_equal(outs_by_pkg[1][it][i],
                                          outs_by_pkg[0][it][i])


def test_bucket_plan_of_the_store_matches_jax(monkeypatch):
    monkeypatch.setenv("MXTPU_BUCKET_BYTES", "2048")
    shapes = [(16, 8), (8,), (32, 4), (4,), (200,), (3, 3)]
    sig = tuple((s, "float32", 2) for s in shapes)
    jplan = jmx.kv.create("device")._build_bucket_plan(sig)
    tplan = mx.kv.create("device")._build_bucket_plan(sig)
    assert [list(b) for b in tplan["plan"].buckets] == jplan["buckets"]
    assert tplan["res_shapes"] == jplan["res_shapes"]


@pytest.mark.parametrize("n,thr", [(7, 0.5), (1000, 0.05), (33, 1.0)])
def test_compress_bucket_bit_for_bit(n, thr):
    rs = np.random.RandomState(n)
    b = rs.randn(n).astype(np.float32)
    r = (rs.randn(n) * 0.3).astype(np.float32)
    jq, jr = joverlap.compress_bucket(jnp.asarray(b), thr, jnp.asarray(r))
    tq, tr = toverlap.compress_bucket(torch.from_numpy(b), thr,
                                      torch.from_numpy(r))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_compression_single_context_rides_bucketed_path():
    got = []
    for m, kw in PKGS:
        kv = m.kv.create("device")
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        kv.init(0, m.nd.zeros((8,), **kw))
        out = m.nd.zeros((8,), **kw)
        kv.pushpull([0], [[m.nd.ones((8,), **kw)]], out=[out])
        assert len(kv._bucket_plans) == 1
        got.append(_np(out))
    np.testing.assert_array_equal(got[1], got[0])
    np.testing.assert_array_equal(got[1], np.full((8,), 0.5, np.float32))


def test_unsupported_compression_raises():
    for m, _ in PKGS:
        with pytest.raises(m.MXNetError, match="unsupported compression"):
            m.kv.create("device").set_gradient_compression({"type": "1bit"})


def test_optimizer_states_save_load(tmp_path):
    """Update on the store: two pushes, the states saved and loaded into a
    fresh store, a third push equal to the uninterrupted store's."""
    def run(split):
        kv = mx.kv.create("local")
        kv.init(0, mx.nd.ones(SHAPE, ctx=mx.cpu()))
        kv.set_optimizer(mx.optimizer.Adam(learning_rate=0.1))
        for _ in range(2):
            kv.push(0, [mx.nd.ones(SHAPE, ctx=mx.cpu())])
        if split:
            path = str(tmp_path / "kv.states")
            kv.save_optimizer_states(path)
            stored = mx.nd.zeros(SHAPE, ctx=mx.cpu())
            kv.pull(0, out=stored)
            kv = mx.kv.create("local")
            kv.init(0, stored)
            kv.set_optimizer(mx.optimizer.Adam(learning_rate=0.1))
            kv._optimizer._index_update_count[0] = 2
            kv.load_optimizer_states(path)
        kv.push(0, [mx.nd.ones(SHAPE, ctx=mx.cpu()) * 3])
        out = mx.nd.zeros(SHAPE, ctx=mx.cpu())
        kv.pull(0, out=out)
        return _np(out)

    np.testing.assert_array_equal(run(True), run(False))


# ---------------------------------------------------------------------------
# the Trainer over two contexts
# ---------------------------------------------------------------------------

def _replace(m, net):
    """The JAX package only: move each copy back to its context (module
    docstring)."""
    if m is not jmx:
        return
    for p in net.collect_params().values():
        for c, d in zip(p.list_ctx(), p.list_data()):
            d._set_data(jax.device_put(d.data, c.jax_device))


def _mlp(m, w):
    net = m.gluon.nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(m.gluon.nn.Dense(8, in_units=5, activation="relu"),
                m.gluon.nn.Dense(3, in_units=8))
    net.initialize(ctx=[m.cpu(0), m.cpu(1)])
    for (k, p), a in zip(sorted(net.collect_params().items()), w):
        p.set_data(m.nd.array(a, ctx=m.cpu(0)))
    _replace(m, net)
    return net


@pytest.mark.parametrize("opt,params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("adam", {"learning_rate": 0.01, "wd": 0.01})])
@pytest.mark.parametrize("update_on_kvstore", [False, True])
def test_trainer_two_contexts_mlp_matches_jax(opt, params,
                                              update_on_kvstore):
    """``update_on_kvstore`` is kept and not read in both packages (the
    Trainer updates, the store sums): the same numbers either way."""
    rs = np.random.RandomState(0)
    w = [rs.randn(*s).astype(np.float32) * 0.3
         for s in ((8,), (8, 5), (3,), (3, 8))]
    x = rs.randn(6, 5).astype(np.float32)
    y = rs.randn(6, 3).astype(np.float32)
    got = []
    for m, _ in PKGS:
        net = _mlp(m, w)
        tr = m.gluon.Trainer(net.collect_params(), opt, dict(params),
                             kvstore="device",
                             update_on_kvstore=update_on_kvstore)
        ctxs = [m.cpu(0), m.cpu(1)]
        for _ in range(3):
            xs = m.gluon.utils.split_and_load(x, ctxs)
            ys = m.gluon.utils.split_and_load(y, ctxs)
            with m.autograd.record():
                losses = [m.gluon.loss.L2Loss()(net(a), b)
                          for a, b in zip(xs, ys)]
            for loss in losses:
                loss.backward()
            tr.step(6)
            _replace(m, net)
        got.append({k: [_np(d) for d in p.list_data()]
                    for k, p in sorted(net.collect_params().items())})
    for (k, want), have in zip(got[0].items(), got[1].values()):
        np.testing.assert_array_equal(have[0], have[1])
        np.testing.assert_allclose(have[0], want[0], rtol=1e-6, atol=1e-7,
                                   err_msg=k)


BERT_CFG = dict(vocab_size=1000, dropout=0.0, num_layers=2, units=64,
                hidden_size=128, num_heads=4, max_length=64)


def bert_batch(rows=4, seq=16, seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(5, 1000, (rows, seq)).astype(np.int32)
    types = (np.arange(seq) >= seq // 2).astype(np.int32)[None].repeat(
        rows, 0)
    mask = (rs.uniform(size=(rows, seq)) < 0.15).astype(np.float32)
    mask[:, 1] = 1.0
    nsp = rs.randint(0, 2, (rows,)).astype(np.float32)
    return ids, types, mask, nsp


def bert_shards(m, batch, ctxs):
    """Each context's half of the batch, on that context."""
    half = batch[0].shape[0] // len(ctxs)
    return [[m.nd.array(a[i * half:(i + 1) * half], dtype=a.dtype.name,
                        ctx=c) for a in batch] for i, c in enumerate(ctxs)]


@pytest.mark.parametrize("opt,params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 1e-3, "wd": 0.01})])
def test_trainer_two_contexts_bert_matches_jax(tmp_path, opt, params):
    jnet = jmx.models.get_bert_model("bert_12_768_12", **BERT_CFG)
    jnet.initialize(init=jmx.initializer.Normal(0.02))
    batch = bert_batch()
    jnet(jmx.nd.array(batch[0], dtype="int32"),
         jmx.nd.array(batch[1], dtype="int32"))
    path = str(tmp_path / "bert.params")
    jnet.save_parameters(path)
    got = []
    for m, _ in PKGS:
        ctxs = [m.cpu(0), m.cpu(1)]
        net = m.models.get_bert_model("bert_12_768_12", **BERT_CFG)
        net.load_parameters(path, ctx=ctxs)
        tr = m.gluon.Trainer(net.collect_params(), opt, dict(params),
                             kvstore="device")
        losses = []
        for _ in range(2):
            with m.autograd.record():
                ls = [pretrain_loss(m, net, *s, mask_id=3)[0]
                      for s in bert_shards(m, batch, ctxs)]
            for loss in ls:
                loss.backward()
            tr.step(1)
            _replace(m, net)
            losses.append([float(loss.asscalar()) for loss in ls])
        got.append((losses, [[_np(d) for d in p.list_data()] for p in
                             net.collect_params().values()]))
    np.testing.assert_allclose(got[1][0], got[0][0], rtol=1e-5)
    for want, have in zip(got[0][1], got[1][1]):
        np.testing.assert_array_equal(have[0], have[1])
        np.testing.assert_allclose(have[0], want[0], rtol=1e-4, atol=1e-5)


def test_superstep_over_a_kvstore_declines_like_jax(caplog):
    """A Trainer that sums through a store (``dist_tpu_sync`` in a world
    of one) makes ``Superstep`` decline, logged once, and run its K
    batches as single steps: the weights equal K ``trainer.step`` calls'
    bit for bit, in the port; the JAX package declines for the same
    reason."""
    from mxnet_tpu_torch import fusedstep

    rs = np.random.RandomState(0)
    xs = rs.randn(3, 4, 5).astype(np.float32)
    ys = rs.randint(0, 3, (3, 4)).astype(np.float32)
    w = [rs.randn(*s).astype(np.float32) * 0.3 for s in ((3,), (3, 5))]

    def build(m):
        net = m.gluon.nn.Dense(3, in_units=5, prefix="d_")
        net.initialize(ctx=m.cpu())
        for (_, p), a in zip(sorted(net.collect_params().items()), w):
            p.set_data(m.nd.array(a, ctx=m.cpu()))
        tr = m.gluon.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": 0.1, "momentum": 0.9},
                             kvstore="dist_tpu_sync")
        return net, tr

    fusedstep.reset_fallback_log()
    net, tr = build(mx)
    ss = mx.gluon.Superstep(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                            tr, k=3)
    with caplog.at_level("WARNING"):
        ss.step(mx.nd.array(xs, ctx=mx.cpu()), mx.nd.array(ys, ctx=mx.cpu()),
                4)
    assert any("kvstore-backed gradient aggregation" in r.getMessage()
               for r in caplog.records)
    ref, rtr = build(mx)
    for x, y in zip(xs, ys):
        with mx.autograd.record():
            loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(
                ref(mx.nd.array(x, ctx=mx.cpu())), mx.nd.array(y, ctx=mx.cpu()))
        loss.backward()
        rtr.step(4)
    for (_, p), (_, q) in zip(sorted(net.collect_params().items()),
                              sorted(ref.collect_params().items())):
        assert torch.equal(p.data().data, q.data().data)
    jnet, jtr = build(jmx)
    jss = jmx.gluon.Superstep(jnet, jmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                              jtr, k=3)
    assert jss._setup() is False and jtr._kvstore is not None
