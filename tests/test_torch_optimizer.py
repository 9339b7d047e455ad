"""Port parity: ``mxnet_tpu_torch.optimizer`` (SGD, Adam) and the Gluon
Trainer against the JAX package over 3 steps, with weight decay, gradient
rescaling, clipping and per-parameter lr/wd multipliers.

Tolerance: 1e-6 absolute and relative (float32; each update is a handful
of element-wise float32 operations, evaluated in another order on each
side: a few ulp of values of order 1).
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

TOL = 1e-6

CASES = {
    "sgd": ("sgd", dict(learning_rate=0.1, wd=0.01)),
    "sgd_momentum_clip": ("sgd", dict(learning_rate=0.1, momentum=0.9,
                                      wd=0.05, clip_gradient=0.5,
                                      rescale_grad=0.5)),
    "adam": ("adam", dict(learning_rate=0.01, wd=0.01)),
    "adam_rescale_clip": ("adam", dict(learning_rate=0.05, wd=0.1,
                                       rescale_grad=0.25, clip_gradient=0.3,
                                       beta1=0.8, beta2=0.99, epsilon=1e-6)),
}


def _steps(mxmod, name, kwargs, w0, grads, kw):
    opt = mxmod.optimizer.create(name, **kwargs)
    w = mxmod.nd.array(w0, **kw)
    state = opt.create_state(0, w)
    for g in grads:
        opt.update(0, w, mxmod.nd.array(g, **kw), state)
    return w.asnumpy(), opt


@pytest.mark.parametrize("case", list(CASES))
def test_three_updates_match_jax(case):
    name, kwargs = CASES[case]
    rs = np.random.RandomState(0)
    w0 = rs.randn(5, 4).astype(np.float32)
    grads = [rs.randn(5, 4).astype(np.float32) * 2 for _ in range(3)]
    want, jopt = _steps(jmx, name, kwargs, w0, grads, {})
    got, topt = _steps(mx, name, kwargs, w0, grads, {"ctx": mx.cpu()})
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert topt.num_update == jopt.num_update == 3


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_trainer_steps_match_jax(name):
    """Trainer.step(batch): rescale 1/batch, lr_mult/wd_mult on one
    parameter, 3 steps on a Dense layer fed the same batch."""
    rs = np.random.RandomState(1)
    x = rs.randn(6, 4).astype(np.float32)
    w0 = rs.randn(3, 4).astype(np.float32)
    b0 = rs.randn(3).astype(np.float32)
    out = []
    for mxmod, kw in ((jmx, {}), (mx, {"ctx": mx.cpu()})):
        net = mxmod.gluon.nn.Dense(3, in_units=4, prefix="d_")
        net.initialize(**kw)
        net.weight.set_data(mxmod.nd.array(w0, **kw))
        net.bias.set_data(mxmod.nd.array(b0, **kw))
        net.bias.lr_mult, net.weight.wd_mult = 0.5, 2.0
        trainer = mxmod.gluon.Trainer(
            net.collect_params(), name,
            {"learning_rate": 0.05, "wd": 0.01, "clip_gradient": 1.0})
        for _ in range(3):
            with mxmod.autograd.record():
                loss = (net(mxmod.nd.array(x, **kw)) ** 2).sum()
            loss.backward()
            trainer.step(x.shape[0])
        out.append((net.weight.data().asnumpy(), net.bias.data().asnumpy()))
    for got, want in zip(out[1], out[0]):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_unknown_optimizer_and_argument_raise():
    """An unknown optimizer raises in both packages; an unknown keyword
    is swallowed by both (the reference's ``Optimizer.__init__`` takes
    ``**kwargs``), so a misspelt ``learning_rat`` leaves the default
    learning rate and the same 3 updates."""
    for mxmod in (jmx, mx):
        with pytest.raises(mxmod.MXNetError, match="unknown optimizer"):
            mxmod.optimizer.create("lion")
    rs = np.random.RandomState(2)
    w0 = rs.randn(5, 4).astype(np.float32)
    grads = [rs.randn(5, 4).astype(np.float32) for _ in range(3)]
    kwargs = dict(learning_rat=0.1, momentum=0.9)
    want, jopt = _steps(jmx, "sgd", kwargs, w0, grads, {})
    got, topt = _steps(mx, "sgd", kwargs, w0, grads, {"ctx": mx.cpu()})
    assert topt.learning_rate == jopt.learning_rate == 0.01
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
