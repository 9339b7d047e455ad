"""Port parity: ``Block.save_parameters`` / ``load_parameters`` of
``mxnet_tpu_torch`` against the JAX package's, in both directions.

A 2-layer BERT, a small ResNetV1 (its BatchNorm running statistics moved
by one training-mode forward, so the auxiliary state carries real values)
and a small Transformer are saved by one package and loaded by the other;
the file keys are the structural names of
``_collect_params_with_prefix`` in both, the bytes are equal for equal
weights, and the predict-mode forwards agree within 1e-6 relative to the
largest |value| (the same weights, float32 sums in other orders). Then
the cases of ``tests/test_gluon.py``'s ``test_save_load_parameters`` and
the loader's options, each against the JAX package: ``allow_missing``,
``ignore_extra`` and their errors (the same words, naming the
parameter), ``cast_dtype``/``dtype_source``, the legacy full-prefix
format, a load before deferred initialisation, and a load into a
hybridized net, which writes in place and captures no new entry.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError

KW = {"ctx": mx.cpu()}
RTOL = 1e-6
RS = np.random.RandomState(0)


def _np(a):
    return np.array(a.asnumpy())


def _close(got, want, rtol=RTOL):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


def _bert(m):
    return m.models.bert.get_bert_model(
        "bert_12_768_12", vocab_size=100, dropout=0.0, num_layers=2,
        units=32, hidden_size=64, num_heads=4, max_length=32,
        use_pooler=False, use_classifier=False)


def _resnet(m):
    zoo = m.gluon.model_zoo.vision.resnet
    return zoo.ResNetV1(zoo.BasicBlockV1, [1, 1, 1, 1], [8, 8, 16, 32, 64],
                        classes=5)


def _transformer(m):
    return m.models.transformer.Transformer(
        12, 9, num_layers=2, units=32, hidden_size=64, num_heads=4,
        dropout=0.0, max_length=16)


IDS = RS.randint(0, 100, (2, 12))
IMG = RS.rand(2, 3, 32, 32).astype(np.float32)
SRC, TGT = RS.randint(0, 12, (2, 7)), RS.randint(0, 9, (2, 5))

MODELS = {
    "bert": (_bert, lambda m, kw: (m.nd.array(IDS, dtype="int32", **kw),)),
    "resnet": (_resnet, lambda m, kw: (m.nd.array(IMG, **kw),)),
    "transformer": (_transformer, lambda m, kw: (
        m.nd.array(SRC, **kw), m.nd.array(TGT, **kw))),
}


def _out(net, m, inputs):
    with m.autograd.predict_mode():
        out = net(*inputs)
    out = out[-1] if isinstance(out, (tuple, list)) else out
    return _np(out)


def _move_running_stats(net, m, inputs):
    """One training-mode forward: BatchNorm's running statistics move."""
    with m.autograd.record():
        net(*inputs)


@pytest.mark.parametrize("name", list(MODELS))
def test_jax_file_loads_in_the_port(tmp_path, name):
    factory, mk = MODELS[name]
    jnet = factory(jmx)
    jnet.initialize(init=jmx.initializer.Normal(0.05))
    jin = mk(jmx, {})
    _move_running_stats(jnet, jmx, jin)
    want = _out(jnet, jmx, jin)
    path = str(tmp_path / "j.params")
    jnet.save_parameters(path)

    tnet = factory(mx)
    tnet.initialize(**KW)
    tin = mk(mx, KW)
    tnet(*tin)  # deferred shapes
    assert sorted(tnet._collect_params_with_prefix()) == \
        sorted(jmx.nd.load(path))
    tnet.load_parameters(path)
    _close(_out(tnet, mx, tin), want)
    if name == "resnet":
        stats = {k: p for k, p in tnet._collect_params_with_prefix().items()
                 if "running" in k}
        jstats = jnet._collect_params_with_prefix()
        assert stats
        for k, p in stats.items():
            np.testing.assert_array_equal(_np(p.data()),
                                          _np(jstats[k].data()))
    again = str(tmp_path / "t.params")
    tnet.save_parameters(again)
    with open(path, "rb") as a, open(again, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("name", list(MODELS))
def test_port_file_loads_in_jax(tmp_path, name):
    factory, mk = MODELS[name]
    torch.manual_seed(0)
    tnet = factory(mx)
    tnet.initialize(init=mx.initializer.Normal(0.05), **KW)
    tin = mk(mx, KW)
    _move_running_stats(tnet, mx, tin)
    want = _out(tnet, mx, tin)
    path = str(tmp_path / "t.params")
    tnet.save_parameters(path)

    jnet = factory(jmx)
    jnet.initialize()
    jin = mk(jmx, {})
    jnet(*jin)
    jnet.load_parameters(path)
    _close(_out(jnet, jmx, jin), want)


def _dense2(m, prefix=None, deferred=False, named=False):
    """Two Dense layers; ``named`` gives them fixed prefixes, so that
    under an empty ``prefix`` every instance has the same full names."""
    nn = m.gluon.nn
    net = nn.HybridSequential(prefix=prefix)
    kw = [{"prefix": "d0_"}, {"prefix": "d1_"}] if named else [{}, {}]
    with net.name_scope():
        if deferred:
            net.add(nn.Dense(5, **kw[0]), nn.Dense(2, **kw[1]))
        else:
            net.add(nn.Dense(5, in_units=4, **kw[0]),
                    nn.Dense(2, in_units=5, **kw[1]))
    return net


def test_gluon_save_load_parameters_case(tmp_path):
    """``tests/test_gluon.py::test_save_load_parameters`` on the port."""
    fname = str(tmp_path / "net.params")
    net = _dense2(mx)
    net.initialize(**KW)
    ref = _np(net(mx.nd.ones((1, 4), **KW)))
    net.save_parameters(fname)
    net2 = _dense2(mx)
    with mx.cpu():
        net2.load_parameters(fname)
    np.testing.assert_array_equal(_np(net2(mx.nd.ones((1, 4), **KW))), ref)
    assert net2[0].weight.list_ctx() == [mx.cpu()]


def _error(fn):
    try:
        fn()
    except Exception as err:  # noqa: BLE001
        return type(err).__name__, str(err)
    return None


def _with_extra_and_missing(m, path, kw):
    """A file holding ``0.weight`` and ``0.bias`` and an extra key."""
    net = _dense2(m)
    net.initialize(**kw)
    arrays = {k: p.data() for k, p in
              net._collect_params_with_prefix().items() if k.startswith("0.")}
    arrays["9.weight"] = m.nd.ones((1,), **kw)
    m.nd.save(path, arrays)


def test_missing_and_extra_errors_equal_the_jax_package(tmp_path):
    path = str(tmp_path / "p.params")
    outcomes = {}
    for tag, m, kw in (("jax", jmx, {}), ("port", mx, KW)):
        _with_extra_and_missing(m, path, kw)
        res = []
        for opts in ({}, {"allow_missing": True},
                     {"ignore_extra": True},
                     {"allow_missing": True, "ignore_extra": True}):
            net = _dense2(m)
            net.initialize(**kw)
            res.append(_error(lambda: net.load_parameters(path, **opts)))
        outcomes[tag] = res
    assert outcomes["port"] == outcomes["jax"]
    assert outcomes["port"][0] == (
        "MXNetError", f"Parameter 1.weight is missing in file {path}")
    assert outcomes["port"][1] == (
        "MXNetError", f"Parameter 9.weight loaded from file {path} is not "
        "present in the Block")
    assert outcomes["port"][3] is None


def test_shape_mismatch_names_the_parameter(tmp_path):
    path = str(tmp_path / "p.params")
    errs = []
    for m, kw in ((jmx, {}), (mx, KW)):
        small = _dense2(m)
        small.initialize(**kw)
        small.save_parameters(path)
        nn = m.gluon.nn
        wide = nn.HybridSequential()
        with wide.name_scope():
            wide.add(nn.Dense(6, in_units=4), nn.Dense(2, in_units=6))
        wide.initialize(**kw)
        name, msg = _error(lambda: wide.load_parameters(path))
        errs.append((name, msg.replace(wide[0].weight.name, "<name>")))
    assert errs[1] == errs[0]
    assert "shape mismatch saved (5, 4) vs expected (6, 4)" in errs[1][1]


@pytest.mark.parametrize("cast_dtype,source", [
    (False, "current"), (True, "current"), (True, "saved")])
def test_cast_dtype_equals_the_jax_package(tmp_path, cast_dtype, source):
    path = str(tmp_path / "p.params")
    got = {}
    for tag, m, kw in (("jax", jmx, {}), ("port", mx, KW)):
        net = _dense2(m)
        net.initialize(**kw)
        net.save_parameters(path)
        want = _np(net[0].weight.data())
        half = _dense2(m)
        half.initialize(**kw)
        half.cast("float16")
        half.load_parameters(path, cast_dtype=cast_dtype,
                             dtype_source=source)
        w = half[0].weight
        got[tag] = (str(w.dtype), str(np.dtype(w.data().dtype)))
        np.testing.assert_array_equal(
            _np(w.data()), want.astype(np.float16).astype(np.float32)
            if tag == "port" else want.astype(np.float16))
    assert got["port"] == got["jax"]


def test_legacy_full_prefix_format(tmp_path):
    """A file of full parameter names (``collect_params().save``) loads
    through ``collect_params().load`` with the block's prefix restored:
    whole for an empty prefix, and for a prefixed block the same error
    as in the JAX package."""
    path = str(tmp_path / "full.params")
    outcomes = []
    for m, kw in ((jmx, {}), (mx, KW)):
        net = _dense2(m, prefix="", named=True)
        net.initialize(**kw)
        net.collect_params().save(path)
        other = _dense2(m, prefix="", named=True)
        other.initialize(**kw)
        assert _error(lambda: other.load_parameters(path)) is None
        np.testing.assert_array_equal(_np(other[1].bias.data()),
                                      _np(net[1].bias.data()))
        pre = _dense2(m, prefix="blk_")
        pre.initialize(**kw)
        pre.collect_params().save(path)
        outcomes.append(_error(lambda: pre.load_parameters(path)))
        stripped = str(tmp_path / "stripped.params")
        pre.collect_params().save(stripped, strip_prefix="blk_")
        back = _dense2(m, prefix="blk_")
        back.initialize(**kw)
        back.collect_params().load(stripped, restore_prefix="blk_")
        np.testing.assert_array_equal(_np(back[0].weight.data()),
                                      _np(pre[0].weight.data()))
    assert outcomes[1] == outcomes[0] and outcomes[1] is not None


def test_arg_aux_prefixes_are_dropped(tmp_path):
    path = str(tmp_path / "export.params")
    net = _dense2(mx, prefix="", named=True)
    net.initialize(**KW)
    with mx.cpu():
        mx.nd.save(path, {("aux:" if "bias" in k else "arg:") + k: p.data()
                          for k, p in net.collect_params().items()})
    other = _dense2(mx, prefix="", named=True)
    other.initialize(**KW)
    other.collect_params().load(path)
    np.testing.assert_array_equal(_np(other[0].weight.data()),
                                  _np(net[0].weight.data()))


def test_load_before_deferred_init(tmp_path):
    path = str(tmp_path / "p.params")
    x = RS.rand(3, 4).astype(np.float32)
    src = _dense2(mx)
    src.initialize(**KW)
    want = _np(src(mx.nd.array(x, **KW)))
    src.save_parameters(path)
    net = _dense2(mx, deferred=True)
    net.initialize(**KW)
    assert net[0].weight.shape == (5, 0)
    net.load_parameters(path)
    assert net[0].weight.shape == (5, 4)
    assert net[0].weight.list_ctx() == [mx.cpu()]
    np.testing.assert_array_equal(_np(net(mx.nd.array(x, **KW))), want)
    jnet = _dense2(jmx, deferred=True)
    jnet.initialize()
    jnet.load_parameters(path)
    _close(_np(jnet(jmx.nd.array(x))), want)


def _load_into_hybridized(ctx_kw, path):
    x = RS.rand(3, 4).astype(np.float32)
    src = _dense2(mx)
    src.initialize(**ctx_kw)
    src.save_parameters(path)
    want = src(mx.nd.array(x, **ctx_kw))
    net = _dense2(mx)
    net.initialize(init=mx.initializer.Xavier(), **ctx_kw)
    net.hybridize()
    xa = mx.nd.array(x, **ctx_kw)
    before = net(xa)
    tensors = [p.data().data for p in net.collect_params().values()]
    graph = net._cached_graph
    net.load_parameters(path)
    after = net(xa)
    assert [p.data().data for p in net.collect_params().values()] == tensors
    assert net._cached_graph is graph and len(graph._cache) == 1
    assert graph.retrace_causes == []
    assert not torch.equal(before.data, after.data)
    assert torch.equal(after.data, want.data)


def test_load_into_hybridized_net_captures_nothing(tmp_path):
    _load_into_hybridized(KW, str(tmp_path / "p.params"))


def test_load_into_hybridized_net_on_cuda(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _load_into_hybridized({"ctx": mx.gpu(0)}, str(tmp_path / "p.params"))


def test_save_commits_atomically(tmp_path, monkeypatch):
    """A save that fails mid-write leaves the previous file whole and no
    temporary file behind."""
    path = str(tmp_path / "p.params")
    net = _dense2(mx)
    net.initialize(**KW)
    net.save_parameters(path)
    with open(path, "rb") as f:
        good = f.read()
    from mxnet_tpu_torch.ndarray import serialization

    def broken(f, t):
        raise OSError("disk full")

    monkeypatch.setattr(serialization, "_write_blob", broken)
    with pytest.raises(OSError):
        net.save_parameters(path)
    with open(path, "rb") as f:
        assert f.read() == good
    assert sorted(p.name for p in tmp_path.iterdir()) == ["p.params"]


def test_uninitialized_save_names_the_parameter(tmp_path):
    net = _dense2(mx, deferred=True)
    net.initialize(**KW)
    with pytest.raises(MXNetError, match="Parameter .*dense0_weight has not "
                       "been initialized yet"):
        net.save_parameters(str(tmp_path / "p.params"))
