"""Port parity: the operator registry of ``mxnet_tpu_torch`` against the
JAX package's ``ops/math.py``, ``ops/shape_ops.py``, ``ops/nn.py``,
``ops/ctc.py`` and ``ops/flash_attention.py``.

- Completeness: every name those five modules register (aliases too)
  exists in the port's registry and ``mx.nd``, and the names one JAX op
  carries name one op in the port. The one exception is ``RNN``, which
  raises ``MXNetError`` naming ROADMAP A13 (``gluon.rnn`` is queued
  there).
- Each op runs through both packages' ``ops.dispatch.invoke`` on the same
  numpy inputs (one ``RandomState`` per op, seeded by its name), forward
  and, where it is differentiable, gradient: every float input attached,
  the outputs weighted by a fixed random head and summed, ``backward()``.
  Tolerance (float32): 1e-5 relative with an absolute floor of 1e-5 of
  the output's (or gradient's) largest magnitude, for element-wise ops,
  reductions, products and shape ops alike; the special functions whose
  float32 implementations differ between XLA and ATen (``gamma``,
  ``gammaln``, ``erfinv``, ``cbrt``/``rcbrt``, ``linalg_potrf``) 1e-4.
  Integer and index outputs must be equal, and every output's dtype
  must be the JAX package's (C16; int32 and NaN variants of the
  reductions, ``cumsum`` and ``sign``).
- ``tests/test_operator.py``'s cases that the five modules reach.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import zlib

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.ops import dispatch as jdispatch
from mxnet_tpu.ops import registry as jregistry
from mxnet_tpu_torch.ops import dispatch as tdispatch
from mxnet_tpu_torch.ops import registry as tregistry

KW = {"ctx": mx.cpu()}
MODULES = ("math", "shape_ops", "nn", "ctc", "flash_attention")
WAITING = {"RNN": "A13"}  # name -> the ROADMAP item that brings it


def _jax_names():
    out = {}
    for n, o in jregistry.all_ops().items():
        mod = o.fn.__module__.rsplit(".", 1)[-1]
        if o.fn.__module__.startswith("mxnet_tpu.ops.") and mod in MODULES:
            out[n] = o
    return out


JAX_OPS = _jax_names()


def test_every_registry_name_is_in_the_port():
    def exported(n):
        if n.startswith("_"):  # as in the JAX package: nd.op, nd._internal
            return hasattr(mx.nd.op, n) and hasattr(mx.nd._internal, n)
        return hasattr(mx.nd, n)

    missing = sorted(n for n in JAX_OPS if n not in WAITING and (
        n not in tregistry.all_ops() or not exported(n)))
    assert not missing
    jnd = {n for n in dir(jmx.nd) if n in JAX_OPS}
    assert jnd - set(dir(mx.nd)) - set(WAITING) == set()
    for n, item in WAITING.items():
        with pytest.raises(mx.MXNetError, match=item):
            getattr(mx.nd, n)(mx.nd.ones((2,), **KW))


def test_aliases_name_one_op_as_in_jax():
    groups = {}
    for n, o in JAX_OPS.items():
        groups.setdefault(id(o), []).append(n)
    for names in groups.values():
        ports = {id(tregistry.get(n).fn) for n in names}
        assert len(ports) == 1, names


# ---------------------------------------------------------------------------
# specs: name -> (inputs, attrs, differentiable, rtol)
# ---------------------------------------------------------------------------

def _rs(name):
    return np.random.RandomState(zlib.crc32(name.encode()))


def u(r, shape=(2, 3), lo=-1.0, hi=1.0):
    return r.uniform(lo, hi, shape).astype(np.float32)


def pos(r, shape=(2, 3), lo=0.3, hi=1.5):
    return u(r, shape, lo, hi)


def away0(r, shape=(2, 3), lo=0.2, hi=1.0):
    return (r.uniform(lo, hi, shape) * r.choice([-1.0, 1.0], shape)) \
        .astype(np.float32)


def distinct(r, shape=(2, 3), step=0.3):
    n = int(np.prod(shape))
    return r.permutation((np.arange(n) * step - n * step / 2)
                         .astype(np.float32)).reshape(shape)


def ints(r, shape, hi):
    return r.randint(0, hi, shape).astype(np.int32)


def spd(r, n=3):
    a = u(r, (n, n))
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


SPECS = {}


def spec(name, make, diff=True, rtol=1e-5, **attrs):
    SPECS[name] = (make, attrs, diff, rtol)


for _n in ("sin", "cos", "tanh", "sinh", "cosh", "arctan", "arcsinh", "exp",
           "expm1", "sigmoid", "erf", "softsign", "square", "negative",
           "degrees", "radians"):
    spec(_n, lambda r: [u(r)])
for _n in ("sqrt", "rsqrt", "log", "log10", "log1p", "log2", "reciprocal"):
    spec(_n, lambda r: [pos(r)])
for _n in ("cbrt", "rcbrt", "gammaln", "gamma"):
    spec(_n, lambda r: [pos(r)], rtol=1e-4)
spec("tan", lambda r: [u(r, lo=-0.6, hi=0.6)])
for _n in ("arcsin", "arccos", "arctanh"):
    spec(_n, lambda r: [u(r, lo=-0.8, hi=0.8)])
spec("arccosh", lambda r: [pos(r, lo=1.3, hi=2.5)])
spec("erfinv", lambda r: [u(r, lo=-0.7, hi=0.7)], rtol=1e-4)
for _n in ("abs", "relu"):
    spec(_n, lambda r: [away0(r)])
spec("sign", lambda r: [np.array([[-1.5, 0.0, 2.0]], np.float32)], False)
for _n in ("rint", "round", "ceil", "floor", "trunc", "fix"):
    spec(_n, lambda r: [np.array([[-2.5, -1.5, -0.4, 0.5, 1.5, 2.7]],
                                 np.float32)], False)
for _n in ("logical_not", "isnan", "isinf", "isfinite"):
    spec(_n, lambda r: [np.array([[0.0, 1.0, np.nan, np.inf, -np.inf]],
                                 np.float32)], False)
spec("smooth_l1", lambda r: [away0(r, lo=0.3, hi=2.0)], scalar=1.5)
spec("clip", lambda r: [away0(r, lo=0.2, hi=0.9)], a_min=-0.5, a_max=0.5)
spec("cast", lambda r: [u(r)], False, dtype="float16")
for _n in ("broadcast_add", "broadcast_sub", "broadcast_mul"):
    spec(_n, lambda r: [u(r), u(r, (1, 3))])
spec("broadcast_div", lambda r: [u(r), away0(r, (1, 3))])
spec("broadcast_mod", lambda r: [u(r) * 3, pos(r, (1, 3))], False)
spec("broadcast_power", lambda r: [pos(r), u(r, (1, 3))])
for _n in ("broadcast_maximum", "broadcast_minimum"):
    spec(_n, lambda r: [distinct(r, step=0.4),
                        distinct(r, step=0.4) + 0.17])
spec("broadcast_hypot", lambda r: [away0(r), away0(r, (1, 3))])
spec("arctan2", lambda r: [u(r), pos(r, (1, 3))])
for _n in ("broadcast_logical_and", "broadcast_logical_or",
           "broadcast_logical_xor", "broadcast_equal",
           "broadcast_not_equal", "broadcast_greater",
           "broadcast_greater_equal", "broadcast_lesser",
           "broadcast_lesser_equal"):
    spec(_n, lambda r: [r.randint(0, 3, (2, 3)).astype(np.float32),
                        r.randint(0, 3, (1, 3)).astype(np.float32)], False)
for _n in ("sum", "mean", "nansum"):
    spec(_n, lambda r: [u(r, (2, 3, 4))], axis=(0, 2), keepdims=True)
for _n in ("prod", "nanprod"):
    spec(_n, lambda r: [away0(r, (2, 3, 4))], axis=1)
for _n in ("max", "min"):
    spec(_n, lambda r: [distinct(r, (2, 3, 4))], axis=2, exclude=True)
spec("norm", lambda r: [away0(r, (2, 3))], axis=1)
for _n in ("argmax", "argmin"):
    spec(_n, lambda r: [r.randint(0, 3, (3, 4)).astype(np.float32)], False,
         axis=1)
spec("argmax_channel", lambda r: [distinct(r, (3, 4))], False)
spec("topk", lambda r: [r.randint(0, 3, (3, 5)).astype(np.float32)], False,
     k=3)
spec("sort", lambda r: [distinct(r, (3, 4))], is_ascend=False)
spec("argsort", lambda r: [r.randint(0, 3, (3, 5)).astype(np.float32)],
     False, is_ascend=False)
spec("cumsum", lambda r: [u(r, (3, 4))], axis=0)
spec("dot", lambda r: [u(r, (4, 3)), u(r, (4, 5))], transpose_a=True)
spec("batch_dot", lambda r: [u(r, (2, 3, 4)), u(r, (2, 5, 4))],
     transpose_b=True)
spec("matmul", lambda r: [u(r, (2, 3, 4)), u(r, (4, 2))])
spec("khatri_rao", lambda r: [u(r, (3, 2)), u(r, (4, 2))])
spec("linalg_gemm2", lambda r: [u(r, (2, 3, 4)), u(r, (2, 3, 5))],
     transpose_a=True, alpha=0.5)
spec("linalg_gemm", lambda r: [u(r, (3, 4)), u(r, (4, 2)), u(r, (3, 2))],
     alpha=2.0, beta=0.5)
spec("linalg_potrf", lambda r: [spd(r)], rtol=1e-4)
spec("linalg_syrk", lambda r: [u(r, (3, 4))], transpose=True, alpha=0.7)
# shape_ops
spec("reshape", lambda r: [u(r, (2, 3, 4))], shape=(0, -1))
spec("reshape_like", lambda r: [u(r, (2, 6)), u(r, (3, 4))])
spec("flatten", lambda r: [u(r, (2, 3, 4))])
spec("transpose", lambda r: [u(r, (2, 3, 4))], axes=(1, 0, 2))
spec("swapaxes", lambda r: [u(r, (2, 3, 4))], dim1=0, dim2=2)
spec("expand_dims", lambda r: [u(r)], axis=1)
spec("squeeze", lambda r: [u(r, (2, 1, 3))], axis=1)
spec("concat", lambda r: [u(r), u(r, (2, 2))], dim=1)
spec("stack", lambda r: [u(r), u(r)], axis=1)
spec("split", lambda r: [u(r, (2, 4))], num_outputs=2, axis=1)
spec("split_v2", lambda r: [u(r, (4, 3))], indices=(1, 3), axis=0)
spec("slice", lambda r: [u(r, (4, 5))], begin=(1, 0), end=(4, 5),
     step=(2, 2))
spec("_slice_basic", lambda r: [u(r, (4, 5))],
     index=("tuple", ("slice", 1, 3, None), ("int", 2)))
spec("slice_axis", lambda r: [u(r, (3, 5))], axis=1, begin=1, end=-1)
spec("slice_like", lambda r: [u(r, (4, 5)), u(r, (2, 3))], axes=(0, 1))
spec("take", lambda r: [u(r, (4, 3)), ints(r, (2, 3), 6) - 1], axis=0)
spec("pick", lambda r: [u(r, (3, 4)), ints(r, (3,), 4).astype(np.float32)],
     axis=1)
spec("Embedding", lambda r: [ints(r, (2, 3), 5), u(r, (5, 4))],
     input_dim=5, output_dim=4)
spec("one_hot", lambda r: [ints(r, (2, 3), 5) - 1], False, depth=4,
     on_value=2.0, off_value=-1.0)
spec("gather_nd", lambda r: [u(r, (3, 4)),
                             np.array([[0, 2, 1], [3, 0, 3]], np.int32)])
spec("scatter_nd", lambda r: [u(r, (3,)),
                              np.array([[0, 2, 1], [3, 0, 1]], np.int32)],
     shape=(3, 4))
spec("where", lambda r: [r.randint(0, 2, (2, 3)).astype(np.float32), u(r),
                         u(r)])
spec("tile", lambda r: [u(r)], reps=(2, 1, 2))
spec("repeat", lambda r: [u(r)], repeats=2, axis=0)
spec("pad", lambda r: [u(r, (1, 2, 3, 4))], mode="reflect",
     pad_width=(0, 0, 0, 0, 1, 2, 2, 1))
spec("flip", lambda r: [u(r, (2, 3, 4))], axis=(0, 2))
spec("broadcast_to", lambda r: [u(r, (1, 3))], shape=(4, 0))
spec("broadcast_like", lambda r: [u(r, (1, 3)), u(r, (2, 3))])
spec("broadcast_axis", lambda r: [u(r, (1, 3, 1))], axis=(0, 2), size=(2, 4))
for _n in ("zeros_like", "ones_like"):
    spec(_n, lambda r: [u(r)], False)
spec("full_like", lambda r: [u(r)], False, fill_value=3.5)
for _n in ("shape_array", "size_array"):
    spec(_n, lambda r: [u(r, (2, 3, 4))], False)
spec("diag", lambda r: [u(r, (3, 4))], k=1)
spec("identity", lambda r: [u(r)])
spec("stop_gradient", lambda r: [u(r)], False)
spec("sequence_mask", lambda r: [u(r, (4, 2, 3)),
                                 np.array([2, 4], np.float32)],
     use_sequence_length=True, value=-1.0)
spec("SequenceLast", lambda r: [u(r, (4, 2, 3)),
                                np.array([2, 4], np.float32)],
     use_sequence_length=True)
spec("SequenceReverse", lambda r: [u(r, (4, 2, 3)),
                                   np.array([3, 4], np.float32)],
     use_sequence_length=True)
# nn
spec("FullyConnected", lambda r: [u(r, (2, 3, 2)), u(r, (4, 6)), u(r, (4,))],
     num_hidden=4)
spec("Convolution", lambda r: [u(r, (2, 3, 6, 6)), u(r, (4, 3, 3, 3)),
                               u(r, (4,))],
     kernel=(3, 3), stride=(2, 1), pad=(1, 0), num_filter=4)
spec("Deconvolution", lambda r: [u(r, (2, 3, 4, 4)), u(r, (3, 2, 3, 3))],
     kernel=(3, 3), stride=(2, 2), pad=(1, 1), adj=(1, 0), num_filter=2)
spec("Pooling", lambda r: [distinct(r, (2, 2, 5, 5), step=0.05)],
     kernel=(3, 3), stride=(2, 2), pool_type="max",
     pooling_convention="full")
spec("Activation", lambda r: [u(r)], act_type="softrelu")
spec("LeakyReLU", lambda r: [away0(r)], act_type="leaky", slope=0.1)
spec("softmax", lambda r: [u(r, (2, 5)) * 3], temperature=2.0)
spec("log_softmax", lambda r: [u(r, (2, 5)) * 3], axis=0)
spec("softmin", lambda r: [u(r, (2, 5)) * 3])
spec("softmax_cross_entropy", lambda r: [u(r, (3, 4)) * 2,
                                         ints(r, (3,), 4)])
spec("SoftmaxOutput", lambda r: [u(r, (4, 5)) * 2,
                                 np.array([1, 0, -1, 4], np.float32)],
     grad_scale=0.5, use_ignore=True, normalization="valid")
spec("BatchNorm", lambda r: [u(r, (2, 3, 4)), pos(r, (3,)), u(r, (3,)),
                             u(r, (3,)), pos(r, (3,))], fix_gamma=False)
spec("LayerNorm", lambda r: [u(r, (2, 3, 4)) * 2, pos(r, (4,)), u(r, (4,))])
spec("InstanceNorm", lambda r: [u(r, (2, 3, 4)) * 2, pos(r, (3,)),
                                u(r, (3,))])
spec("GroupNorm", lambda r: [u(r, (2, 4, 3)) * 2, pos(r, (4,)),
                             u(r, (4,))], num_groups=2)
spec("L2Normalization", lambda r: [u(r, (2, 3, 4))], mode="channel")
spec("LRN", lambda r: [u(r, (2, 5, 3, 3))], nsize=3, alpha=0.1)
spec("identity_with_attr_like_rhs", lambda r: [u(r), u(r)])
# ctc, flash_attention
spec("_ctc_loss", lambda r: [u(r, (6, 2, 4)) * 2,
                             np.array([[1, 2, 2], [3, 1, 0]], np.int32)])
spec("flash_attention", lambda r: [u(r, (1, 4, 6, 8)), u(r, (1, 2, 6, 8)),
                                   u(r, (1, 2, 6, 8))], causal=True)
spec("paged_decode_attention", lambda r: [
    u(r, (2, 4, 8)), u(r, (6, 4, 2, 8)), u(r, (6, 4, 2, 8)),
    np.array([[2, 5, 0], [1, 3, 4]], np.int32),
    np.array([7, 11], np.int32)], False)


def _canonical(name):
    return JAX_OPS[name].name if name in JAX_OPS else name


def test_every_jax_op_has_a_spec():
    """Each op of the five modules (by its JAX name) is held to the JAX
    package below, but Dropout (random: tests/test_torch_random.py), the
    waiting RNN and ``boolean_mask`` (data-dependent shape: the JAX
    package's ``invoke`` jits it and cannot run it, so it is held to
    numpy's ``compress``, which the JAX package calls)."""
    canon = {o.name for o in JAX_OPS.values()}
    untested = sorted(canon - set(SPECS) - set(WAITING)
                      - {"Dropout", "boolean_mask"})
    assert not untested


def _outs(res):
    return list(res) if isinstance(res, (list, tuple)) else [res]


def _run(mod, name, inputs, attrs, diff):
    invoke = (jdispatch if mod is jmx else tdispatch).invoke
    kw = {} if mod is jmx else KW
    arrays = [mod.nd.array(a, dtype=a.dtype.name, **kw) for a in inputs]
    floats = [a.dtype == np.float32 for a in inputs]
    if not diff:
        return [o.asnumpy() for o in _outs(invoke(name, *arrays, **attrs))], []
    for a, f in zip(arrays, floats):
        if f:
            a.attach_grad()
    r = np.random.RandomState(99)
    with mod.autograd.record():
        outs = _outs(invoke(name, *arrays, **attrs))
        head = None
        for o in outs:
            w = mod.nd.array(r.uniform(0.5, 1.5, o.shape).astype(np.float32),
                             **kw)
            term = (o * w).sum()
            head = term if head is None else head + term
    head.backward()
    return ([o.asnumpy() for o in outs],
            [a.grad.asnumpy() for a, f in zip(arrays, floats) if f])


def _agree(got, want, rtol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    if not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    scale = float(np.nanmax(np.abs(want[np.isfinite(want)]), initial=1.0))
    np.testing.assert_allclose(got.astype(np.float64),
                               want.astype(np.float64), rtol=rtol,
                               atol=rtol * scale, equal_nan=True,
                               err_msg=what)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_op_matches_jax(name):
    make, attrs, diff, rtol = SPECS[name]
    inputs = make(_rs(name))
    jout, jgrads = _run(jmx, name, inputs, attrs, diff)
    tout, tgrads = _run(mx, name, inputs, attrs, diff)
    assert len(jout) == len(tout)
    for i, (t, j) in enumerate(zip(tout, jout)):
        _agree(t, j, rtol, f"{name} output {i}")
    for i, (t, j) in enumerate(zip(tgrads, jgrads)):
        _agree(t, j, rtol, f"{name} gradient {i}")


TOPK = [dict(k=2, ret_typ="value"), dict(k=2, ret_typ="both"),
        dict(k=2, ret_typ="mask"), dict(k=3, is_ascend=True),
        dict(k=1, axis=0, ret_typ="both", dtype="int32"),
        dict(k=2, ret_typ="value", axis=0, is_ascend=True)]


@pytest.mark.parametrize("attrs", TOPK, ids=lambda a: "-".join(
    f"{k}{v}" for k, v in a.items()))
def test_topk_modes_and_ties_match_jax(attrs):
    """``topk``'s ``ret_typ``/``is_ascend``/``dtype``, ties taken in index
    order as ``lax.top_k`` takes them, indices float32 by default."""
    x = np.array([[1, 3, 3, 0, 3], [2, 2, 1, 2, 0], [0, 0, 0, 0, 0]],
                 np.float32)
    jout, _ = _run(jmx, "topk", [x], attrs, False)
    tout, _ = _run(mx, "topk", [x], attrs, False)
    for t, j in zip(tout, jout):
        assert t.dtype == j.dtype
        np.testing.assert_array_equal(t, j)


VARIANTS = {
    "pad_edge": ("pad", lambda r: [u(r, (1, 2, 3, 4))],
                 dict(mode="edge", pad_width=(0, 0, 0, 0, 2, 1, 1, 2))),
    "pad_constant": ("pad", lambda r: [u(r, (1, 2, 3, 4))],
                     dict(mode="constant", pad_width=(0, 0, 1, 0, 2, 1, 1, 2),
                          constant_value=0.5)),
    "take_wrap": ("take", lambda r: [u(r, (4, 3)), ints(r, (5,), 9) - 4],
                  dict(axis=0, mode="wrap")),
    "softmax_plain": ("softmax", lambda r: [u(r, (3, 4)) * 3], dict(axis=0)),
    "pool_avg": ("Pooling", lambda r: [u(r, (1, 2, 5, 5))],
                 dict(kernel=(2, 2), stride=(2, 2), pad=(1, 1),
                      pool_type="avg", count_include_pad=False)),
    "l2_instance": ("L2Normalization", lambda r: [u(r, (2, 3, 4))],
                    dict(mode="instance")),
    "l2_spatial": ("L2Normalization", lambda r: [u(r, (2, 3, 4))],
                   dict(mode="spatial")),
    "softmax_output_batch": (
        "SoftmaxOutput", lambda r: [u(r, (4, 5)),
                                    np.array([1, 0, 2, 4], np.float32)],
        dict(normalization="batch")),
    "split_squeeze": ("split", lambda r: [u(r, (2, 3))],
                      dict(num_outputs=3, axis=1, squeeze_axis=True)),
    "sum_all": ("sum", lambda r: [u(r, (2, 3))], {}),
    "max_keep": ("max", lambda r: [distinct(r, (2, 3))],
                 dict(axis=1, keepdims=True)),
    "dot_1d": ("dot", lambda r: [u(r, (4,)), u(r, (4, 3))], {}),
    "diag_1d": ("diag", lambda r: [u(r, (3,))], dict(k=-1)),
    "sequence_reverse_plain": ("SequenceReverse",
                               lambda r: [u(r, (3, 2))], {}),
    "argmax_flat": ("argmax", lambda r: [distinct(r, (3, 4))], {}),
    "batchnorm_global": ("BatchNorm", lambda r: [
        u(r, (2, 3, 2, 2)), pos(r, (3,)), u(r, (3,)), u(r, (3,)),
        pos(r, (3,))], dict(use_global_stats=True)),
    "layernorm_mean_var": ("LayerNorm", lambda r: [
        u(r, (2, 4)), pos(r, (4,)), u(r, (4,))],
        dict(output_mean_var=True, axis=-1)),
    "slice_negative_step": ("slice", lambda r: [u(r, (4, 5))],
                            dict(begin=(3, None), end=(0, None),
                                 step=(-1, 2))),
}

# C16: integer and bool reductions keep the reference's result types
# (int32, uint32 for unsigned, float32 for a mean), and sign keeps NaN;
# compared forward only (nothing integer is differentiable)
INT_VARIANTS = {
    "sum_int32": ("sum", lambda r: [ints(r, (2, 3, 4), 50)], dict(axis=1)),
    "sum_all_int32": ("sum", lambda r: [ints(r, (2, 3), 50)], {}),
    "nansum_int32": ("nansum", lambda r: [ints(r, (2, 3), 50)],
                     dict(axis=0)),
    "prod_int32": ("prod", lambda r: [ints(r, (2, 3), 4) + 1], {}),
    "nanprod_int32": ("nanprod", lambda r: [ints(r, (2, 3), 4) + 1],
                      dict(axis=1, keepdims=True)),
    "mean_int32": ("mean", lambda r: [ints(r, (2, 3), 50)], {}),
    "mean_axis_uint8": ("mean", lambda r: [ints(r, (2, 3), 250)
                                           .astype(np.uint8)], dict(axis=1)),
    "cumsum_int32": ("cumsum", lambda r: [ints(r, (3, 4), 50)],
                     dict(axis=1)),
    "cumsum_flat_int32": ("cumsum", lambda r: [ints(r, (2, 3), 50)], {}),
    "cumsum_uint8_wraps": ("cumsum", lambda r: [np.full((4,), 200,
                                                        np.uint8)], {}),
    "sum_uint8": ("sum", lambda r: [np.full((4,), 200, np.uint8)], {}),
    "prod_uint8": ("prod", lambda r: [np.full((4,), 2, np.uint8)], {}),
    "max_int32": ("max", lambda r: [ints(r, (2, 3), 50)], dict(axis=1)),
    "sign_nan": ("sign", lambda r: [np.array(
        [np.nan, 0.0, -0.0, -2.5, 3.0, -np.inf], np.float32)], {}),
    "sign_int32": ("sign", lambda r: [ints(r, (2, 3), 5) - 2], {}),
}


@pytest.mark.parametrize("key", sorted(INT_VARIANTS))
def test_int_and_nan_variants_match_jax(key):
    name, make, attrs = INT_VARIANTS[key]
    inputs = make(_rs(key))
    jout, _ = _run(jmx, name, inputs, attrs, False)
    tout, _ = _run(mx, name, inputs, attrs, False)
    for i, (t, j) in enumerate(zip(tout, jout)):
        _agree(t, j, 1e-5, f"{key} {i}")
        np.testing.assert_array_equal(np.signbit(t), np.signbit(j),
                                      err_msg=f"{key} {i} sign bits")


@pytest.mark.parametrize("key", sorted(VARIANTS))
def test_op_variants_match_jax(key):
    name, make, attrs = VARIANTS[key]
    diff = SPECS[_canonical(name)][2]
    inputs = make(_rs(key))
    jout, jgrads = _run(jmx, name, inputs, attrs, diff)
    tout, tgrads = _run(mx, name, inputs, attrs, diff)
    for i, (t, j) in enumerate(zip(tout + tgrads, jout + jgrads)):
        _agree(t, j, 1e-5, f"{key} {i}")


# ---------------------------------------------------------------------------
# test_operator.py's cases
# ---------------------------------------------------------------------------

def test_nd_namespace_positional_attrs_and_out():
    """The generated namespace binds a positional non-array argument to the
    op's parameter of that position, and writes ``out=`` in place."""
    for mod in (jmx, mx):
        kw = {} if mod is jmx else KW
        x = mod.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3), **kw)
        assert mod.nd.expand_dims(x, 0).shape == (1, 2, 3)
        np.testing.assert_allclose(mod.nd.clip(x, 1, 4).asnumpy(),
                                   np.clip(np.arange(6).reshape(2, 3), 1, 4))
        out = mod.nd.zeros((2, 3), **kw)
        r = mod.nd.broadcast_add(x, x, out=out)
        assert r is out
        np.testing.assert_allclose(out.asnumpy(), 2 * x.asnumpy())
        parts = [mod.nd.zeros((2, 1), **kw) for _ in range(3)]
        res = mod.nd.split(x, num_outputs=3, axis=1, out=parts)
        assert [a is b for a, b in zip(res, parts)] == [True] * 3
        np.testing.assert_allclose(parts[2].asnumpy().ravel(), [2, 5])
    assert mx.nd._internal._plus is mx.nd.op._plus
    assert mx.nd.op.broadcast_add is mx.nd.broadcast_add


def test_special_wrappers():
    x = mx.nd.ones((4, 6), **KW)
    assert (mx.nd.Dropout(x, p=0.5).asnumpy() == 1).all()  # predict mode
    d = mx.nd.Dropout(x, p=0.5, mode="always").asnumpy()
    assert set(np.unique(d)) <= {0.0, 2.0} and (d == 0).any()
    d = mx.nd.Dropout(x, p=0.5, mode="always", axes=(1,)).asnumpy()
    assert all(len(set(row)) == 1 for row in d)
    g = [mx.nd.ones((3,), **KW), mx.nd.ones((2, 2), **KW)]
    assert mx.nd.reset_arrays(*g, num_arrays=2) is None
    assert all((a.asnumpy() == 0).all() for a in g)
    out = mx.nd.zeros((3, 4), **KW)
    jout = jmx.nd.zeros((3, 4))
    idx = np.array([1, 3, 0], np.float32)
    assert mx.nd.onehot_encode(mx.nd.array(idx, **KW), out) is out
    jmx.nd.onehot_encode(jmx.nd.array(idx), jout)
    np.testing.assert_array_equal(out.asnumpy(), jout.asnumpy())
    rs = np.random.RandomState(0)
    data = rs.randn(4, 3, 2).astype(np.float32)
    for mod in (jmx, mx):
        kw = {} if mod is jmx else KW
        mm, mv = mod.nd.zeros((3,), **kw), mod.nd.ones((3,), **kw)
        with mod.autograd.record():
            y = mod.nd.BatchNormWithReLU(
                mod.nd.array(data, **kw), mod.nd.ones((3,), **kw),
                mod.nd.zeros((3,), **kw), mm, mv, fix_gamma=False)
        if mod is jmx:
            want = (y.asnumpy(), mm.asnumpy(), mv.asnumpy())
        else:
            for a, b in zip((y.asnumpy(), mm.asnumpy(), mv.asnumpy()), want):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert (want[0] >= 0).all()


def test_boolean_mask_and_softmax_length_against_numpy():
    """The two uses the JAX package's ``invoke`` cannot run (a
    data-dependent shape; an array attribute), held to the formulas its
    code computes."""
    rs = np.random.RandomState(4)
    x = rs.randn(4, 3).astype(np.float32)
    m = np.array([1, 0, 1, 1], np.float32)
    got = mx.nd.boolean_mask(mx.nd.array(x, **KW), mx.nd.array(m, **KW))
    np.testing.assert_array_equal(got.asnumpy(), np.compress(m, x, axis=0))
    z = rs.randn(2, 5).astype(np.float32)
    lens = np.array([3, 5], np.float32)
    t = mx.nd.array(z, **KW)
    t.attach_grad()
    with mx.autograd.record():
        p = mx.nd.softmax(t, length=mx.nd.array(lens, **KW), use_length=True,
                          temperature=2.0)
    want = np.zeros_like(z)
    for i, n in enumerate(lens.astype(int)):
        e = np.exp(z[i, :n] / 2.0 - (z[i, :n] / 2.0).max())
        want[i, :n] = e / e.sum()
    np.testing.assert_allclose(p.asnumpy(), want, rtol=1e-5, atol=1e-7)
    p.backward(mx.nd.array(rs.randn(2, 5).astype(np.float32), **KW))
    assert np.isfinite(t.grad.asnumpy()).all()
    assert (t.grad.asnumpy()[0, 3:] == 0).all()


def test_softmax_output_ignores_the_head_gradient():
    """SoftmaxOutput's backward is the CE gradient whatever the head (the
    legacy rule, copied from the JAX package's ``_so_bwd``)."""
    x_np = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    lab = np.array([0, 3, 1], np.float32)
    grads = []
    for head in (1.0, 7.0):
        x = mx.nd.array(x_np, **KW)
        x.attach_grad()
        with mx.autograd.record():
            p = mx.nd.SoftmaxOutput(x, mx.nd.array(lab, **KW))
        p.backward(mx.nd.ones((3, 4), **KW) * head)
        grads.append(x.grad.asnumpy())
    np.testing.assert_array_equal(grads[0], grads[1])
    e = np.exp(x_np - x_np.max(1, keepdims=True))
    p = e / e.sum(1, keepdims=True)
    np.testing.assert_allclose(grads[0], p - np.eye(4)[lab.astype(int)],
                               rtol=1e-5, atol=1e-6)


def test_numeric_gradient_check_agrees():
    """``test_utils.check_numeric_gradient`` against the tape on smooth
    ops (test_operator.py's workhorse)."""
    from mxnet_tpu_torch.test_utils import check_numeric_gradient

    rs = np.random.RandomState(3)
    for fn, xs in ((lambda a: mx.nd.tanh(a) * a, [rs.randn(2, 3)]),
                   (lambda a, b: mx.nd.dot(a, b),
                    [rs.randn(2, 3), rs.randn(3, 2)]),
                   (lambda a: mx.nd.softmax(a), [rs.randn(2, 4)])):
        check_numeric_gradient(
            fn, [mx.nd.array(x.astype(np.float32), **KW) for x in xs],
            eps=1e-3, rtol=1e-2, atol=1e-3)


def test_relu_and_clip_keep_the_tie_rule():
    """C8's rule stays: half the gradient at a tie, through the
    generated namespace as through the layer."""
    x = mx.nd.array(np.array([-1.0, 0.0, 2.0], np.float32), **KW)
    x.attach_grad()
    with mx.autograd.record():
        y = mx.nd.relu(x) + mx.nd.clip(x, a_min=-1.0, a_max=2.0)
    y.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), [0.5, 1.5, 1.5])


# ---------------------------------------------------------------------------
# on the card: chip_smoke.py's [nd-ops] cases, cut to a small width
# ---------------------------------------------------------------------------

CUT = dict(B=16, T=32, C=192, H=768, V=3000, N=128)


def _nd_cases_cut():
    import chip_smoke

    return chip_smoke._nd_cases(**CUT)


@pytest.mark.parametrize("name", sorted(_nd_cases_cut()))
def test_nd_op_matches_host_float64_on_cuda(name, monkeypatch):
    """Each op of ``[nd-ops]`` on the card in float32 against the same op
    on the host in float64, within its family's tolerance (chip_smoke's
    ND_TOL; gradients 10 times it)."""
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    failed = []
    monkeypatch.setattr(chip_smoke, "check",
                        lambda ok, what: ok or failed.append(what))
    chip_smoke.nd_op_check(name, _nd_cases_cut()[name],
                           torch.device("cuda", 0))
    assert not failed


# C22: sort and argsort with axis=None sort the flattened array, as the
# functions and as NDArray methods; exact
@pytest.mark.parametrize("form", ["nd", "method"])
def test_sort_argsort_axis_none(form):
    x = np.random.RandomState(3).randn(4, 5).astype(np.float32)

    def run(mod):
        a = mod.nd.array(x, **(KW if mod is mx else {}))
        if form == "nd":
            s = mod.nd.sort(a, axis=None)
            i = mod.nd.argsort(a, axis=None, dtype="int32")
        else:
            s, i = a.sort(axis=None), a.argsort(axis=None, dtype="int32")
        return s.asnumpy(), i.asnumpy()

    (js, ji), (ts, ti) = run(jmx), run(mx)
    assert ts.shape == (20,) and ti.dtype == np.int32
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(ti, ji)


#: C23's inputs: past each bound, halves, NaN and both infinities
CAST_VALUES = np.array([-300.7, -186.2, -1.5, -0.5, 0.7, 254.6, 255.5,
                        256.0, 300.2, 1000.0, np.nan, np.inf, -np.inf],
                       np.float32)


def _cast_forms(mod, a, dtype):
    return [mod.nd.Cast(a, dtype=dtype).asnumpy(),
            mod.nd.cast(a, dtype=dtype).asnumpy(),
            a.astype(dtype).asnumpy()]


# C23: a float cast to an integer type saturates at the type's bounds and
# sends NaN to 0, as the reference's XLA conversion does; exact
@pytest.mark.parametrize("dtype", ["uint8", "int8", "int32"])
def test_float_to_int_cast_saturates(dtype):
    want = _cast_forms(jmx, jmx.nd.array(CAST_VALUES), dtype)
    got = _cast_forms(mx, mx.nd.array(CAST_VALUES, **KW), dtype)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype == np.dtype(dtype)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype", ["uint8", "int8", "int32"])
def test_float_to_int_cast_saturates_on_cuda(dtype):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    want = _cast_forms(jmx, jmx.nd.array(CAST_VALUES), dtype)
    got = _cast_forms(mx, mx.nd.array(CAST_VALUES, ctx=mx.gpu(0)), dtype)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
