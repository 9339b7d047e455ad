"""C21: ``mx.cpu(i)`` for distinct ``i`` are distinct contexts in the port,
as in the JAX package (whose ids index distinct host devices; the test
run forces 8, tests/conftest.py) and in MXNet.

Before the repair the port's ``Context`` dropped the id of every host
context, so ``cpu(0) == cpu(1)``, a parameter initialised on both kept
one copy, and every host array reported ``cpu(0)``. Each check here holds
the port against the JAX package on the same calls; the training checks
compare values exactly (one SGD step of a ``Dense`` over two contexts,
whose sums of two float32 terms round alike in both packages).
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx
import mxnet_tpu_torch as mx


def test_host_contexts_are_distinct_like_jax():
    for m in (jmx, mx):
        assert m.cpu(0) != m.cpu(1)
        assert m.cpu(1) == m.cpu(1)
        assert len({m.cpu(0), m.cpu(1), m.cpu(1)}) == 2
        assert m.cpu_pinned(1) == m.cpu(1)
        assert repr(m.cpu(1)) == "cpu(1)"
    # every one of them is torch's one CPU device
    for i in range(3):
        assert mx.resolve_device(mx.cpu(i)) == torch.device("cpu")


def test_gpu_beyond_the_card_count_still_raises():
    n = mx.num_gpus()
    with pytest.raises(mx.MXNetError):
        mx.nd.zeros((1,), ctx=mx.gpu(n))


def test_multi_context_initialize_keeps_one_copy_each():
    for m in (jmx, mx):
        net = m.gluon.nn.Dense(2, in_units=3)
        net.initialize(ctx=[m.cpu(0), m.cpu(1)])
        assert net.weight.list_ctx() == [m.cpu(0), m.cpu(1)]
        assert len(net.weight.list_data()) == 2
        assert [d.context for d in net.weight.list_data()] == \
            [m.cpu(0), m.cpu(1)]
        assert net.weight.grad(m.cpu(1)).context == m.cpu(1)
    # the two copies of the port's parameter are two tensors
    a, b = net.weight.list_data()
    assert a.data.data_ptr() != b.data.data_ptr()


@pytest.mark.parametrize("how", ["array", "zeros", "as_in_context",
                                 "copyto", "op", "grad"])
def test_ndarray_context_after_placement_and_op(how):
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    got = []
    for m in (jmx, mx):
        c0, c1 = m.cpu(0), m.cpu(1)
        if how == "array":
            a = m.nd.array(x, ctx=c1)
        elif how == "zeros":
            a = m.nd.zeros((2, 3), ctx=c1)
        elif how == "as_in_context":
            a = m.nd.array(x, ctx=c0).as_in_context(c1)
        elif how == "copyto":
            a = m.nd.array(x, ctx=c0).copyto(c1)
        elif how == "op":
            a = m.nd.exp(m.nd.array(x, ctx=c1) * 2 + 1)
        else:
            a = m.nd.array(x, ctx=c1)
            a.attach_grad()
            with m.autograd.record():
                (a * a).sum().backward()
            a = a.grad
        got.append((str(a.context), np.array(a.asnumpy())))
    assert got[0][0] == got[1][0] == "cpu(1)"
    np.testing.assert_allclose(got[1][1], got[0][1], rtol=1e-6)


def test_split_and_load_places_each_slice_like_jax():
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    for m in (jmx, mx):
        parts = m.gluon.utils.split_and_load(x, [m.cpu(0), m.cpu(1)])
        assert [str(p.context) for p in parts] == ["cpu(0)", "cpu(1)"]


def _two_context_step(m, seed=0):
    ctxs = [m.cpu(0), m.cpu(1)]
    net = m.gluon.nn.Dense(2, in_units=3, use_bias=False)
    net.initialize(init=m.initializer.One(), ctx=ctxs)
    tr = m.gluon.Trainer(net.collect_params(), "sgd",
                         {"learning_rate": 0.1}, kvstore="device")
    rs = np.random.RandomState(seed)
    x = rs.randn(4, 3).astype(np.float32)
    y = rs.randn(4, 2).astype(np.float32)
    xs = m.gluon.utils.split_and_load(x, ctxs)
    ys = m.gluon.utils.split_and_load(y, ctxs)
    with m.autograd.record():
        losses = [m.gluon.loss.L2Loss()(net(a), b) for a, b in zip(xs, ys)]
    for loss in losses:
        loss.backward()
    tr.step(4)
    return [np.array(d.asnumpy()) for d in net.weight.list_data()]


def test_two_context_training_equals_jax():
    """The reference's ``test_trainer_multi_device_contexts``: both copies
    equal after a ``kvstore="device"`` step, and equal to the JAX
    package's, exactly."""
    assert len(jax.devices()) >= 2
    want = _two_context_step(jmx)
    got = _two_context_step(mx)
    assert len(got) == len(want) == 2
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
