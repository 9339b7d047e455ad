"""Port parity: the twelve Gluon losses of ``mxnet_tpu_torch/gluon/loss.py``
against the JAX package's on the same numpy inputs, with and without
``sample_weight``, eager and (on the port) hybridized; ``ops/ctc.py``
against ``mxnet_tpu/ops/ctc.py`` with padded labels and explicit
lengths; the operators the losses call against the JAX package's.

Tolerances (float32, the same formulas evaluated in other orders):
values within 1e-6 relative to the largest |value| (1e-5 for CTC, whose
alpha recursion sums log-probabilities over every time step), input
gradients within 1e-5 of the largest |gradient|.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

KW = {"ctx": mx.cpu()}
VAL_TOL, GRAD_TOL, CTC_TOL = 1e-6, 1e-5, 1e-5
RS = np.random.RandomState(0)
N, C = 4, 5


def _f(*shape, scale=1.0):
    return (np.asarray(RS.randn(*shape)) * scale).astype(np.float32)


def _signs(*shape):
    return np.where(RS.rand(*shape) > 0.5, 1.0, -1.0).astype(np.float32)


def _probs(*shape):
    e = np.exp(_f(*shape))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _ctc_inputs():
    pred = _f(2, 6, C)  # NTC
    label = np.array([[1, 2, 0], [3, 3, 1]], np.float32)  # 0 = padding
    return pred, label


# name: (class name, kwargs, inputs (the first `n_grad` get gradients),
#        n_grad, sample_weight shape)
CASES = {
    "l2": ("L2Loss", {}, lambda: [_f(N, C), _f(N, C)], 1, (N, 1)),
    "l2_weight": ("L2Loss", {"weight": 3.0}, lambda: [_f(N, C), _f(N, C)],
                  1, (N, 1)),
    "l1": ("L1Loss", {}, lambda: [_f(N, C), _f(N, C)], 1, (N, 1)),
    "softmax_ce": ("SoftmaxCrossEntropyLoss", {},
                   lambda: [_f(N, C), RS.randint(0, C, (N,)).astype(
                       np.float32)], 1, (N, 1)),
    "softmax_ce_dense": ("SoftmaxCELoss", {"sparse_label": False},
                         lambda: [_f(N, C), _probs(N, C)], 1, (N, 1)),
    "softmax_ce_logits": ("SoftmaxCrossEntropyLoss", {"from_logits": True},
                          lambda: [np.log(_probs(N, C)),
                                   RS.randint(0, C, (N,)).astype(
                                       np.float32)], 1, (N, 1)),
    "sigmoid_bce": ("SigmoidBinaryCrossEntropyLoss", {},
                    lambda: [_f(N, C, scale=3), (RS.rand(N, C) > 0.5)
                             .astype(np.float32)], 1, (N, 1)),
    "sigmoid_bce_pos_weight": ("SigmoidBCELoss", {},
                               lambda: [_f(N, C, scale=3),
                                        (RS.rand(N, C) > 0.5).astype(
                                            np.float32), None,
                                        np.abs(_f(1, C)) + 0.5], 1, (N, 1)),
    "sigmoid_bce_from_sigmoid": (
        "SigmoidBCELoss", {"from_sigmoid": True},
        lambda: [RS.uniform(0.05, 0.95, (N, C)).astype(np.float32),
                 (RS.rand(N, C) > 0.5).astype(np.float32)], 1, (N, 1)),
    "sigmoid_bce_from_sigmoid_pos_weight": (
        "SigmoidBCELoss", {"from_sigmoid": True},
        lambda: [RS.uniform(0.05, 0.95, (N, C)).astype(np.float32),
                 (RS.rand(N, C) > 0.5).astype(np.float32), None,
                 np.abs(_f(1, C)) + 0.5], 1, (N, 1)),
    "kl_div": ("KLDivLoss", {}, lambda: [np.log(_probs(N, C)),
                                         _probs(N, C)], 1, (N, 1)),
    "kl_div_softmax": ("KLDivLoss", {"from_logits": False},
                       lambda: [_f(N, C), _probs(N, C)], 1, (N, 1)),
    "ctc": ("CTCLoss", {}, lambda: list(_ctc_inputs()), 1, (2,)),
    "huber": ("HuberLoss", {"rho": 1}, lambda: [_f(N, C, scale=2),
                                                _f(N, C)], 1, (N, 1)),
    "hinge": ("HingeLoss", {}, lambda: [_f(N, C), _signs(N, C)], 1, (N, 1)),
    "squared_hinge": ("SquaredHingeLoss", {"margin": 2},
                      lambda: [_f(N, C), _signs(N, C)], 1, (N, 1)),
    "logistic_signed": ("LogisticLoss", {}, lambda: [_f(N, C, scale=3),
                                                     _signs(N, C)], 1,
                        (N, 1)),
    "logistic_binary": ("LogisticLoss", {"label_format": "binary"},
                        lambda: [_f(N, C, scale=3), (RS.rand(N, C) > 0.5)
                                 .astype(np.float32)], 1, (N, 1)),
    "triplet": ("TripletLoss", {"margin": 2}, lambda: [_f(N, C), _f(N, C),
                                                       _f(N, C)], 3, (N,)),
    "cosine": ("CosineEmbeddingLoss", {"margin": 0.1},
               lambda: [_f(N, C), _f(N, C), _signs(N)], 2, (N, 1)),
}


def _run(m, cls, kwargs, inputs, n_grad, sw, kw, hybridize=False):
    loss_fn = getattr(m.gluon.loss, cls)(**kwargs)
    if hybridize:
        loss_fn.hybridize()
    arrays = [None if a is None else m.nd.array(a, **kw) for a in inputs]
    for a in arrays[:n_grad]:
        a.attach_grad()
    extra = []
    if sw is not None:
        # sample_weight comes after the optional positional inputs
        if cls == "CTCLoss":
            extra = [None, None, m.nd.array(sw, **kw)]
        elif len(arrays) == 4:  # pos_weight is after sample_weight
            arrays[2] = m.nd.array(sw, **kw)
        else:
            extra = [m.nd.array(sw, **kw)]
    with m.autograd.record():
        out = loss_fn(*arrays, *extra)
    if n_grad:
        out.backward()
    return (np.array(out.asnumpy()),
            [np.array(a.grad.asnumpy()) for a in arrays[:n_grad]])


def _jax_ctc_grad(inputs, sw):
    """d(sum of CTCLoss) / d(pred) through the JAX package's op."""
    import jax
    import jax.numpy as jnp

    from mxnet_tpu.ops import ctc as jctc

    pred, label = inputs
    weight = 1.0 if sw is None else sw

    def total(p):
        per = jctc.ctc_loss(jnp.swapaxes(p, 0, 1), label.astype(np.int32))
        return (per * weight).sum()

    return np.asarray(jax.grad(total)(pred))


def _close(got, want, tol):
    scale = max(float(np.abs(want).max()), 1e-30)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol * scale, \
        (float(np.abs(got - want).max()), scale)


@pytest.mark.parametrize("hybridize", [False, True], ids=["eager", "hybrid"])
@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("case", list(CASES))
def test_loss_matches_jax(case, weighted, hybridize):
    cls, kwargs, make, n_grad, sw_shape = CASES[case]
    inputs = make()
    sw = np.abs(_f(*sw_shape)) + 0.1 if weighted else None
    if cls == "CTCLoss":
        # the JAX package's CTCLoss computes on raw arrays, off its tape
        # (no gradient reaches pred); its gradient is taken from the op
        jv, _ = _run(jmx, cls, kwargs, inputs, 0, sw, {})
        jg = [_jax_ctc_grad(inputs, sw)]
    else:
        jv, jg = _run(jmx, cls, kwargs, inputs, n_grad, sw, {})
    tv, tg = _run(mx, cls, kwargs, inputs, n_grad, sw, KW, hybridize)
    _close(tv, jv, CTC_TOL if cls == "CTCLoss" else VAL_TOL)
    for got, want in zip(tg, jg):
        _close(got, want, GRAD_TOL)


def test_twelve_losses_and_repr():
    names = {CASES[c][0] for c in CASES} - {"SoftmaxCELoss", "SigmoidBCELoss"}
    assert len(names) == 12
    assert mx.gluon.loss.SigmoidBCELoss is \
        mx.gluon.loss.SigmoidBinaryCrossEntropyLoss
    for cls in sorted(names):
        assert repr(getattr(mx.gluon.loss, cls)()) == \
            repr(getattr(jmx.gluon.loss, cls)())
    assert repr(mx.gluon.loss.L2Loss()) == "L2Loss(batch_axis=0, w=1.0)"


@pytest.mark.parametrize("lengths", [False, True], ids=["counted",
                                                        "explicit"])
def test_ctc_op_matches_jax(lengths):
    from mxnet_tpu.ops import ctc as jctc
    from mxnet_tpu_torch.ops import ctc as tctc

    T, B, L = 9, 3, 4
    pred = _f(T, B, C)
    label = np.array([[1, 2, 2, 0], [4, 0, 0, 0], [3, 1, 3, 2]], np.int32)
    pl = np.array([9, 5, 7], np.int32) if lengths else None
    ll = np.array([3, 1, 4], np.int32) if lengths else None

    def jloss(p):
        return jctc.ctc_loss(p, label, None if pl is None else pl,
                             None if ll is None else ll)

    import jax

    want = np.asarray(jloss(pred))
    want_g = np.asarray(jax.grad(lambda p: jloss(p).sum())(pred))
    p = torch.from_numpy(pred).requires_grad_()
    got = tctc.ctc_loss(p, torch.from_numpy(label),
                        None if pl is None else torch.from_numpy(pl),
                        None if ll is None else torch.from_numpy(ll))
    got.sum().backward()
    _close(got.detach().numpy(), want, CTC_TOL)
    _close(p.grad.numpy(), want_g, GRAD_TOL)


def test_operators_match_jax():
    x = _f(3, 4)
    y = _f(3, 4)
    for name, args, kwargs in (
            ("abs", (x,), {}), ("square", (x,), {}),
            ("log", (np.abs(x) + 0.1,), {}),
            ("norm", (x,), {}), ("norm", (x,), {"axis": -1}),
            ("norm", (x,), {"axis": 1, "keepdims": True}),
            ("norm", (x,), {"ord": 1, "axis": 0}),
            ("broadcast_maximum", (x, y[:1]), {}),
            ("where", (x > 0, x, y), {})):
        j = getattr(jmx.nd, name)(*[jmx.nd.array(a) for a in args],
                                  **kwargs)
        t = getattr(mx.nd, name)(*[mx.nd.array(a, **KW) for a in args],
                                 **kwargs)
        _close(t.asnumpy(), np.array(j.asnumpy()), VAL_TOL)
    for op in ("__gt__", "__eq__", "__lt__", "__ge__", "__le__", "__ne__"):
        j = getattr(jmx.nd.array(x), op)(0.5)
        t = getattr(mx.nd.array(x, **KW), op)(0.5)
        np.testing.assert_array_equal(t.asnumpy(), np.array(j.asnumpy()))
        assert t.dtype == np.float32
    full = mx.nd.full((2, 3), 1e-12, **KW)
    np.testing.assert_array_equal(full.asnumpy(),
                                  jmx.nd.full((2, 3), 1e-12).asnumpy())
    np.testing.assert_array_equal(abs(mx.nd.array(x, **KW)).asnumpy(),
                                  np.abs(x))
