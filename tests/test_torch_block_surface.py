"""Port parity: the ``Block`` surface of ``mxnet_tpu_torch`` against the JAX
package's, on the same nets: forward hooks (call counts, ``detach``,
hooks of hybridized children), ``apply``, ``collect_params(select)``,
``reset_ctx``, ``Constant`` and ``ParameterDict.get_constant``, and the
``repr`` and ``summary`` texts, equal character for character.

A hybridized block's children run their hooks while an entry of the
cached graph is built, not on its replays, as the JAX package runs them
at trace time: the counts are pinned equal to the JAX package's over the
same sequence of calls (eager, predict, recording, a new shape).
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import re

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.block import reset_names

KW = {"ctx": mx.cpu()}


def _mlp(m):
    nn = m.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(4, in_units=3, activation="relu"),
                nn.Dense(2, in_units=4))
    return net


def _resnetish(m):
    nn = m.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv2D(4, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.MaxPool2D(2), nn.Dropout(0.5),
                nn.Flatten(), nn.Embedding(10, 3), nn.Dense(3))
    return net


def _bert(m):
    return m.models.bert.get_bert_model(
        "bert_12_768_12", vocab_size=50, dropout=0.0, num_layers=2, units=16,
        hidden_size=32, num_heads=2, max_length=16)


def _transformer(m):
    return m.models.transformer.Transformer(
        12, 9, num_layers=2, units=16, hidden_size=32, num_heads=2,
        dropout=0.0, max_length=16)


def _counting(net, child):
    calls = {"top_pre": 0, "top": 0, "child_pre": 0, "child": 0}

    def bump(key):
        def hook(*_):
            calls[key] += 1
        return hook

    handles = [net.register_forward_pre_hook(bump("top_pre")),
               net.register_forward_hook(bump("top")),
               child.register_forward_pre_hook(bump("child_pre")),
               child.register_forward_hook(bump("child"))]
    return calls, handles


def _hook_trace(m, ctx_kw):
    """Call counts after each step of one sequence of calls."""
    net = _mlp(m)
    net.initialize(**ctx_kw)
    calls, handles = _counting(net, net[0])
    x, x2 = m.nd.ones((2, 3), **ctx_kw), m.nd.ones((5, 3), **ctx_kw)
    trace = []
    net(x)
    trace.append(dict(calls))
    net.hybridize()
    for _ in range(3):
        net(x)
        trace.append(dict(calls))
    for _ in range(3):
        with m.autograd.record():
            y = net(x)
        y.backward()
        trace.append(dict(calls))
    net(x2)
    trace.append(dict(calls))
    for h in handles:
        h.detach()
    h.detach()  # a second detach does nothing
    net(x2)
    net.hybridize(False)
    net(x2)
    trace.append(dict(calls))
    return trace


def test_hook_counts_equal_the_jax_package():
    want = _hook_trace(jmx, {})
    got = _hook_trace(mx, KW)
    assert got == want
    # hybridized children run their hooks only while an entry is built
    assert got[1]["child"] == 2 and got[3]["child"] == 2
    assert got[4]["child"] == 3 and got[6]["child"] == 3
    assert got[-1]["top"] == got[-2]["top"]  # detached


def test_hook_sees_args_and_output():
    net = _mlp(mx)
    net.initialize(**KW)
    seen = []
    net[1].register_forward_pre_hook(lambda b, a: seen.append(
        ("pre", b.name, a[0].shape)))
    net[1].register_forward_hook(lambda b, a, o: seen.append(
        ("post", b.name, o.shape)))
    net(mx.nd.ones((2, 3), **KW))
    assert [s[0] for s in seen] == ["pre", "post"]
    assert seen[0][2] == (2, 4) and seen[1][2] == (2, 2)
    assert seen[0][1] == net[1].name == net[1].prefix[:-1]


def test_hooks_on_cuda_run_at_capture_only():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    got = _hook_trace(mx, {"ctx": mx.gpu(0)})
    assert got == _hook_trace(jmx, {})


def test_apply_visits_children_first():
    for m in (jmx, mx):
        net = _resnetish(m)
        seen = []
        assert net.apply(lambda b: seen.append(type(b).__name__)) is net
        assert seen[-1] == "HybridSequential"
        assert seen[0] == "Conv2D"
    reset_names()


@pytest.mark.parametrize("select", [None, ".*weight", ".*dense.*_bias$",
                                    "(?!.*running).*"])
def test_collect_params_select_equals_the_jax_package(select):
    jnet, tnet = _bert(jmx), _bert(mx)

    def strip(keys):
        return [re.sub(r"\d+_", "_", k) for k in keys]

    jk = list(jnet.collect_params(select).keys())
    tk = list(tnet.collect_params(select).keys())
    assert strip(tk) == strip(jk) and tk


def test_reset_ctx_moves_values():
    net = _mlp(mx)
    net.initialize(**KW)
    before = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    handle = net[0].weight.data()
    net.reset_ctx(mx.cpu())
    for k, p in net.collect_params().items():
        assert p.list_ctx() == [mx.cpu()]
        np.testing.assert_array_equal(p.data().asnumpy(), before[k])
        assert p.grad() is not None
    assert net[0].weight.data() is not handle
    # a deferred parameter is deferred to the new context
    lazy = mx.gluon.nn.Dense(2)
    lazy.initialize(**KW)
    lazy.collect_params().reset_ctx([mx.cpu(1)])
    assert lazy.weight.list_ctx() == [mx.cpu(1)]
    with pytest.raises(MXNetError, match="has not been initialized"):
        mx.gluon.Parameter("never").list_ctx()


def test_constant_and_get_constant():
    value = np.arange(6, dtype=np.float32).reshape(2, 3)
    for m, kw in ((jmx, {}), (mx, KW)):
        pd = m.gluon.ParameterDict("blk_")
        c = pd.get_constant("const_weight", m.nd.array(value, **kw))
        assert pd.get_constant("const_weight") is c
        assert c.grad_req == "null" and c.shape == (2, 3)
        c.initialize(**kw)
        np.testing.assert_array_equal(c.data().asnumpy(), value)
        with pytest.raises(Exception, match="No constant named blk_nope"):
            pd.get_constant("nope")
    tc = mx.gluon.parameter.Constant("k_weight", value)
    tc.initialize(**KW)
    np.testing.assert_array_equal(tc.data().asnumpy(), value)
    with pytest.raises(MXNetError, match="grad_req='null'"):
        tc.grad()


def test_parameter_dict_setattr_and_repr():
    jnet, tnet = _mlp(jmx), _mlp(mx)
    tnet.collect_params().setattr("grad_req", "null")
    assert all(p.grad_req == "null" for p in tnet.collect_params().values())
    jr = repr(jnet[0].params)
    tr = repr(tnet[0].params)
    assert re.sub(r"\d+_", "_", tr) == re.sub(r"\d+_", "_", jr)
    assert "Parameter" in tr and "shape=(4, 3)" in tr


@pytest.mark.parametrize("factory", [_mlp, _resnetish, _bert, _transformer],
                         ids=["mlp", "conv", "bert", "transformer"])
def test_repr_and_summary_equal_the_jax_package(factory, capsys):
    jnet, tnet = factory(jmx), factory(mx)
    assert repr(tnet) == repr(jnet)
    assert tnet.summary() == jnet.summary()
    out = capsys.readouterr().out
    assert "Total params:" in out


def test_repr_after_shapes_resolve():
    x = np.random.RandomState(0).rand(2, 3, 8, 8).astype(np.float32)
    jnet, tnet = _resnetish(jmx), _resnetish(mx)
    jnet.initialize()
    tnet.initialize(**KW)
    for net, m, kw in ((jnet, jmx, {}), (tnet, mx, KW)):
        y = m.nd.array(x, **kw)
        for blk in list(net)[:6]:
            y = blk(y)
    assert repr(tnet) == repr(jnet)
    assert "BatchNorm(axis=1, in_channels=4)" in repr(tnet)
    assert tnet.summary() == jnet.summary()
