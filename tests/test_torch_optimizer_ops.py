"""Port parity: every optimizer update operator of the ``nd`` namespace
(``ops/optimizer_ops.py``: the ``*_update`` family, ``multi_sum_sq``,
``multi_lars``, the ``multi_*sgd*``/``preloaded_multi_*`` and
``multi_*lamb*`` updates, and the ``_sparse_adagrad_update`` alias)
against the JAX package's, called the same way: the reference's
interleaved positional layout, attributes as keywords and ``out=``
write-back, on the same numpy inputs from a seed.

Tolerance: float32 results within 1e-6 absolute and relative (a handful
of element-wise float32 operations in another order); float16 weights
within one float16 step (2^-10 relative, 1e-6 absolute near 0), since
each side rounds its own float32 result once.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops.optimizer_ops import OPS

TOL = 1e-6
F16_TOL = 2.0 ** -10
SHAPE = (4, 5)
PRE = dict(rescale_grad=0.5, clip_gradient=0.8)
MP = ("w16", "g16", "w32")

# op: (input roles, attributes, indices of the inputs written by out=
# (None: compare what the op returns))
CASES = {
    "sgd_update": (["w", "g"], dict(lr=0.1, wd=0.01, **PRE), [0]),
    "sgd_mom_update": (["w", "g", "s"], dict(lr=0.1, momentum=0.9,
                                             wd=0.01, **PRE), [0, 2]),
    "mp_sgd_update": (["w16", "g16", "w32"], dict(lr=0.1, wd=0.01, **PRE),
                      [0, 2]),
    "mp_sgd_mom_update": (["w16", "g16", "s", "w32"],
                          dict(lr=0.1, momentum=0.9, wd=0.01), [0, 2, 3]),
    "signsgd_update": (["w", "g"], dict(lr=0.1, wd=0.01), [0]),
    "signum_update": (["w", "g", "s"], dict(lr=0.1, momentum=0.9,
                                            wd_lh=0.01, **PRE), [0, 2]),
    "nag_mom_update": (["w", "g", "s"], dict(lr=0.1, momentum=0.9,
                                             wd=0.01, **PRE), [0, 2]),
    "mp_nag_mom_update": (["w16", "g16", "s", "w32"],
                          dict(lr=0.1, momentum=0.9, wd=0.01), [0, 2, 3]),
    "ftml_update": (["w", "g", "s", "p", "s"],
                    dict(lr=0.1, wd=0.01, t=2, clip_grad=0.8),
                    [0, 2, 3, 4]),
    "rmsprop_update": (["w", "g", "p"], dict(lr=0.01, wd=0.01,
                                             clip_weights=0.8, **PRE),
                       [0, 2]),
    "rmspropalex_update": (["w", "g", "p", "small", "s"],
                           dict(lr=0.01, wd=0.01, **PRE), [0, 2, 3, 4]),
    "adagrad_update": (["w", "g", "p"], dict(lr=0.1, wd=0.01, **PRE),
                       [0, 2]),
    "_sparse_adagrad_update": (["w", "g", "p"], dict(lr=0.1, epsilon=1e-6),
                               [0, 2]),
    "adadelta_update": (["w", "g", "p", "p"], dict(rho=0.8, wd=0.01, **PRE),
                        [0, 2, 3]),
    "ftrl_update": (["w", "g", "s", "p"], dict(lr=0.1, lamda1=0.05, wd=0.01,
                                               **PRE), [0, 2, 3]),
    "adam_update": (["w", "g", "s", "p"], dict(lr=0.01, wd=0.01, **PRE),
                    [0, 2, 3]),
    "dcasgd_update": (["w", "g", "s", "w"], dict(lr=0.1, momentum=0.9,
                                                 wd=0.01, **PRE), [0, 2, 3]),
    "lamb_update_phase1": (["w", "g", "s", "p", "w"],
                           dict(t=3, wd=0.01, **PRE), None),
    "lamb_update_phase2": (["w", "g", "r", "r"],
                           dict(lr=0.1, lower_bound=0.5, upper_bound=4.0),
                           [0]),
    "mp_lamb_update_phase1": (["w16", "g16", "s", "p", "w32"],
                              dict(t=2, wd=0.01, bias_correction=False),
                              None),
    "mp_lamb_update_phase2": (["w16", "g", "r", "r", "w32"], dict(lr=0.1),
                              [0, 4]),
    "multi_sum_sq": (["w", "g", "s"], dict(num_arrays=3), None),
    "multi_lars": (["v3", "v3", "v3", "v3"], dict(eta=0.01, eps=1e-6,
                                                  rescale_grad=0.5), None),
    "multi_sgd_update": (["w", "g"] * 2, dict(
        lrs=(0.1, 0.2), wds=(0.01, 0.0), num_weights=2, **PRE), [0, 2]),
    "multi_sgd_mom_update": (["w", "g", "s"] * 2, dict(
        lrs=(0.1, 0.2), wds=(0.01, 0.0), momentum=0.9, num_weights=2,
        **PRE), [0, 2, 3, 5]),
    "multi_mp_sgd_update": (list(MP) * 2, dict(
        lrs=(0.1, 0.2), wds=(0.01, 0.0), num_weights=2), [0, 2, 3, 5]),
    "multi_mp_sgd_mom_update": (["w16", "g16", "s", "w32"] * 2, dict(
        lrs=(0.1, 0.2), wds=(0.01, 0.0), momentum=0.9, num_weights=2),
        [0, 2, 3, 4, 6, 7]),
    "preloaded_multi_sgd_update": (["w", "g"] * 2 + ["v2", "v2"], dict(
        num_weights=2, **PRE), [0, 2]),
    "preloaded_multi_sgd_mom_update": (["w", "g", "s"] * 2 + ["v2", "v2"],
                                       dict(momentum=0.9, num_weights=2),
                                       [0, 2, 3, 5]),
    "preloaded_multi_mp_sgd_update": (list(MP) * 2 + ["v2", "v2"], dict(
        num_weights=2), [0, 2, 3, 5]),
    "preloaded_multi_mp_sgd_mom_update": (
        ["w16", "g16", "s", "w32"] * 2 + ["v2", "v2"],
        dict(momentum=0.9, num_weights=2), [0, 2, 3, 4, 6, 7]),
    "multi_lamb_update": (["w", "g", "s", "p"] * 2, dict(
        step_count=(1, 4), learning_rates=(0.01, 0.02), wds=(0.01, 0.0),
        num_tensors=2, **PRE), [0, 2, 3, 4, 6, 7]),
    "multi_mp_lamb_update": (["w16", "g16", "s", "p", "w32"] * 2, dict(
        step_count=(2, 3), learning_rates=(0.01, 0.02), wds=(0.01, 0.0),
        lower_bound=0.5, upper_bound=3.0, num_tensors=2),
        [0, 2, 3, 4, 5, 7, 8, 9]),
}


def _inputs(roles, seed):
    """One numpy array per role: w/g weights and gradients (``w16``/
    ``g16`` in float16, ``w32`` the float32 master of the ``w16`` before
    it), s a signed state, p a positive one, small a small signed one, r
    a norm, v2/v3 positive vectors."""
    rs = np.random.RandomState(seed)
    out, last16 = [], None
    for role in roles:
        if role in ("w", "g", "s", "w16", "g16"):
            a = rs.randn(*SHAPE).astype(np.float32)
        elif role == "w32":
            a = last16.astype(np.float32)
        elif role == "p":
            a = (rs.rand(*SHAPE) + 0.5).astype(np.float32)
        elif role == "small":
            a = (0.1 * rs.randn(*SHAPE)).astype(np.float32)
        elif role == "r":
            a = (rs.rand(1) * 3 + 0.1).astype(np.float32)
        else:
            a = (rs.rand(int(role[1:])) + 0.05).astype(np.float32)
        if role in ("w16", "g16"):
            a = a.astype(np.float16)
            if role == "w16":
                last16 = a
        out.append(a)
    return out


def _call(mxmod, name, arrays, attrs, out_idx, kw):
    nds = [mxmod.nd.array(a.astype(np.float32), **kw).astype(
        "float16") if a.dtype == np.float16 else mxmod.nd.array(a, **kw)
        for a in arrays]
    # underscore names live in the op module only, as in the reference
    op = getattr(mxmod.nd.op, name)
    if out_idx is None:
        res = op(*nds, **attrs)
        res = res if isinstance(res, (list, tuple)) else [res]
    else:
        outs = [nds[i] for i in out_idx]
        res = op(*nds, out=outs if len(outs) > 1 else outs[0], **attrs)
        res = res if isinstance(res, (list, tuple)) else [res]
        assert all(r is o for r, o in zip(res, outs))
    return [np.array(r.astype("float32").asnumpy()) for r in res], \
        [str(r.dtype) for r in res]


def test_every_reference_op_is_here():
    from mxnet_tpu.ops import optimizer_ops  # noqa: F401
    from mxnet_tpu.ops.registry import all_ops

    ref = {n for n, d in all_ops().items()
           if d.fn.__module__ == "mxnet_tpu.ops.optimizer_ops"}
    assert len(ref) == 33 and set(OPS) == ref == set(CASES)


@pytest.mark.parametrize("name", list(CASES))
def test_op_matches_jax(name):
    roles, attrs, out_idx = CASES[name]
    arrays = _inputs(roles, sorted(CASES).index(name))
    want, wdt = _call(jmx, name, arrays, attrs, out_idx, {})
    got, gdt = _call(mx, name, arrays, attrs, out_idx, {"ctx": mx.cpu()})
    assert len(got) == len(want)
    for g, w, dt in zip(got, want, wdt):
        if dt == "float16":
            np.testing.assert_allclose(g, w, rtol=F16_TOL, atol=TOL)
        else:
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    assert [d.replace("torch.", "") for d in gdt] == wdt
