"""Element-wise, broadcast, comparison, reduction and product operators.

PyTorch counterpart of ``mxnet_tpu/ops/math.py`` (reference:
``src/operator/tensor/elemwise_*``, ``broadcast_reduce_op_*``, ``dot``,
``la_op``), registered under the same names and aliases. Each is a plain
torch function of tensors with MXNet's semantics: a Python scalar operand
takes the tensor's type (as the JAX package's weak types do),
comparisons return the input's floating type (float32 for integers),
reductions take MXNet's ``axis``/``keepdims``/``exclude``, and indices
come back as float32 unless a ``dtype`` says otherwise. Products stay
``torch.matmul`` (cuBLAS), as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import torch

from ..ndarray.ndarray import torch_dtype
from .registry import register


def _pair(a, b):
    """Both operands as tensors of their common type (a scalar takes the
    tensor's type, as a weakly typed JAX scalar does). A scalar becomes a
    0-d tensor made by a fill kernel on the device: a copy from the host
    would break a CUDA-graph capture."""
    ta, tb = isinstance(a, torch.Tensor), isinstance(b, torch.Tensor)
    if ta and tb:
        return a, b
    dt = torch.result_type(a, b)
    if ta:
        return a.to(dt), torch.full((), b, dtype=dt, device=a.device)
    if tb:
        return torch.full((), a, dtype=dt, device=b.device), b.to(dt)
    return torch.tensor(a), torch.tensor(b)


def _result_type(a, b):
    return torch.result_type(a, b)


# ---------------------------------------------------------------------------
# binary broadcast (MXNet's broadcast_* family and its aliases)
# ---------------------------------------------------------------------------


def _scalar_ok(fn):
    """A binary op torch takes with one tensor and one Python number."""
    def op(lhs, rhs):
        if isinstance(lhs, torch.Tensor):
            return fn(lhs, rhs)
        return fn(*_pair(lhs, rhs))

    return op


def _logical(fn):
    def op(lhs, rhs):
        a, b = _pair(lhs, rhs)
        return fn(a, b).to(torch.promote_types(a.dtype, b.dtype))

    return op


_BINARY = {
    "broadcast_add": _scalar_ok(torch.add),
    "broadcast_sub": _scalar_ok(torch.sub),
    "broadcast_mul": _scalar_ok(torch.mul),
    "broadcast_div": _scalar_ok(torch.true_divide),
    "broadcast_mod": _scalar_ok(torch.remainder),
    "broadcast_power": lambda a, b: torch.pow(a, b),
    "broadcast_maximum": lambda a, b: torch.maximum(*_pair(a, b)),
    "broadcast_minimum": lambda a, b: torch.minimum(*_pair(a, b)),
    "broadcast_hypot": lambda a, b: torch.hypot(*_pair(a, b)),
    "broadcast_logical_and": _logical(torch.logical_and),
    "broadcast_logical_or": _logical(torch.logical_or),
    "broadcast_logical_xor": _logical(torch.logical_xor),
    "arctan2": lambda a, b: torch.atan2(*_pair(a, b)),
}

_BINARY_ALIASES = {
    "broadcast_add": ("elemwise_add", "add", "_plus", "_add",
                      "broadcast_plus"),
    "broadcast_sub": ("elemwise_sub", "subtract", "_minus", "_sub",
                      "broadcast_minus"),
    "broadcast_mul": ("elemwise_mul", "multiply", "_mul"),
    "broadcast_div": ("elemwise_div", "divide", "_div"),
    "broadcast_mod": ("_mod",),
    "broadcast_power": ("_power", "pow"),
    "broadcast_maximum": ("maximum", "_maximum", "broadcast_max"),
    "broadcast_minimum": ("minimum", "_minimum", "broadcast_min"),
}


def _named(fn, name):
    def op(lhs, rhs):
        return fn(lhs, rhs)

    op.__name__ = name
    return op


for _name, _fn in _BINARY.items():
    globals()[_name] = register(
        _name, aliases=_BINARY_ALIASES.get(_name, ()))(_named(_fn, _name))

_COMPARE = {
    "broadcast_equal": torch.eq,
    "broadcast_not_equal": torch.ne,
    "broadcast_greater": torch.gt,
    "broadcast_greater_equal": torch.ge,
    "broadcast_lesser": torch.lt,
    "broadcast_lesser_equal": torch.le,
}


def _compare(fn):
    def op(lhs, rhs):
        # MXNet comparisons return the input float type (1.0 / 0.0)
        dt = _result_type(lhs, rhs)
        dt = dt if dt.is_floating_point else torch.float32
        if not isinstance(lhs, torch.Tensor):
            lhs, rhs = _pair(lhs, rhs)
        return fn(lhs, rhs).to(dt)

    return op


for _name, _fn in _COMPARE.items():
    globals()[_name] = register(
        _name, aliases=(_name.replace("broadcast_", ""),))(
            _named(_compare(_fn), _name))


# ---------------------------------------------------------------------------
# unary
# ---------------------------------------------------------------------------


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _float_of(x):
    return x.dtype if x.is_floating_point() else torch.float32


def _sign(x):
    """``jnp.sign``: NaN stays NaN and -0.0 stays -0.0 (``torch.sign``
    gives 0 for both); the gradient is 0 everywhere."""
    if not x.is_floating_point():
        return torch.sign(x)
    keep = (x == 0) | torch.isnan(x)
    return torch.where(keep, x.detach(), torch.sign(x))


class _Abs(torch.autograd.Function):
    """``|x|`` whose gradient is +1 at 0 and -1 at NaN, the JAX package's
    rule (``jnp.abs`` differentiates as ``x >= 0 ? 1 : -1``); torch's
    ``sign`` gives 0 at 0. The sign is a constant of the backward, so a
    second-order gradient through it is 0."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x.detach() >= 0, g, -g)


def _abs(x):
    return _Abs.apply(x) if x.requires_grad and x.is_floating_point() \
        else torch.abs(x)


_UNARY = {
    "abs": _abs,
    "sign": _sign,
    "rint": torch.round,  # half to even, as jnp.rint
    "round": torch.round,  # half to even, as the JAX package's jnp.round
    "ceil": torch.ceil,
    "floor": torch.floor,
    "trunc": torch.trunc,
    "fix": torch.trunc,
    "square": torch.square,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "cbrt": _cbrt,
    "rcbrt": lambda x: 1.0 / _cbrt(x),
    "exp": torch.exp,
    "log": torch.log,
    "log10": torch.log10,
    "log2": torch.log2,
    "log1p": torch.log1p,
    "expm1": torch.expm1,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "arcsin": torch.asin,
    "arccos": torch.acos,
    "arctan": torch.atan,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tanh": torch.tanh,
    "arcsinh": torch.asinh,
    "arccosh": torch.acosh,
    "arctanh": torch.atanh,
    "degrees": torch.rad2deg,
    "radians": torch.deg2rad,
    "sigmoid": torch.sigmoid,
    "softsign": lambda x: x / (1.0 + torch.abs(x)),
    "gamma": lambda x: torch.exp(torch.lgamma(x)),  # |Gamma|, as the JAX
    "gammaln": torch.lgamma,                        # package computes it
    "erf": torch.erf,
    "erfinv": torch.erfinv,
    "reciprocal": torch.reciprocal,
    "negative": torch.neg,
    "logical_not": lambda x: torch.logical_not(x).to(_float_of(x)),
    "isnan": lambda x: torch.isnan(x).to(torch.float32),
    "isinf": lambda x: torch.isinf(x).to(torch.float32),
    "isfinite": lambda x: torch.isfinite(x).to(torch.float32),
}


def _unary(fn, name):
    def op(data):
        return fn(data)

    op.__name__ = name
    return op


for _name, _fn in _UNARY.items():
    globals()["u_" + _name] = register(_name)(_unary(_fn, _name))


def _half(x):
    """A 0-d tensor of 1/2 on ``x``'s device, made by a fill kernel (a
    copy from the host would break a CUDA-graph capture)."""
    return torch.full((), 0.5, dtype=x.dtype, device=x.device)


class _Clip(torch.autograd.Function):
    """``min(max(x, a_min), a_max)`` whose gradient at a bound is 1/2, the
    JAX package's rule (``jnp.clip`` is ``jnp.maximum`` then
    ``jnp.minimum``, each splitting a tie); ``torch.clamp`` gives 1
    there. The mask is a constant of the backward, so a second-order
    gradient through it is 0."""

    @staticmethod
    def forward(ctx, x, a_min, a_max):
        ctx.save_for_backward(x)
        ctx.bounds = (a_min, a_max)
        return torch.clamp(x, a_min, a_max)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        x = x.detach()
        a_min, a_max = ctx.bounds
        half = _half(x)
        if a_min is not None:
            g = g * torch.heaviside(x - a_min if a_min else x, half)
        if a_max is not None:
            g = g * torch.heaviside(a_max - x, half)
        return g, None, None


@register("clip")
def clip(data, a_min=None, a_max=None):
    """Each value limited to ``[a_min, a_max]`` (either bound may be
    None), with the JAX package's gradient at a bound (1/2)."""
    if data.requires_grad:
        return _Clip.apply(data, a_min, a_max)
    return torch.clamp(data, a_min, a_max)


#: the largest float64 below 2**63: int64's bound as a clamp that converts
_INT64_CLAMP = float(2 ** 63 - 1024)


@register("cast", aliases=("Cast", "astype"))
def cast(data, dtype="float32"):
    """``data`` in ``dtype``. A float cast to an integer type saturates at
    the type's bounds and sends NaN to 0, as XLA's conversion does in the
    JAX package (torch's and numpy's wrap, on the CPU and on CUDA
    alike)."""
    dt = torch_dtype(dtype)
    if not data.is_floating_point() or dt == torch.bool or \
            dt.is_floating_point or dt.is_complex:
        return data.to(dt)
    info = torch.iinfo(dt)
    x = data.double()
    x = torch.where(torch.isnan(x), 0.0, x)
    hi = _INT64_CLAMP if dt == torch.int64 else float(info.max)
    out = x.clamp(float(info.min), hi).to(dt)
    if dt == torch.int64:
        out = torch.where(x >= 2.0 ** 63, info.max, out)
    return out


@register("smooth_l1")
def smooth_l1(data, scalar=1.0):
    s2 = scalar * scalar
    return torch.where(data.abs() < 1.0 / s2, 0.5 * s2 * data * data,
                       data.abs() - 0.5 / s2)


# ---------------------------------------------------------------------------
# reductions (MXNet axis semantics: axis=None -> all, ``exclude`` inverts)
# ---------------------------------------------------------------------------


def _axes(axis, exclude, ndim):
    """MXNet reduction axes: None means all, ``exclude`` inverts."""
    if axis is None or axis == ():
        ax = tuple(range(ndim))
        return tuple(sorted(set(range(ndim)) - set(ax))) if exclude else ax
    if isinstance(axis, int):
        axis = (axis,)
    ax = tuple(a % ndim for a in axis)
    if exclude:
        ax = tuple(i for i in range(ndim) if i not in ax)
    return ax


def _prod(data, dim, keepdim):
    out = data
    for a in sorted(dim, reverse=True):
        out = out.prod(dim=a, keepdim=keepdim)
    return out


_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32)


def _int_acc(x):
    """The type ``jnp.sum``/``jnp.prod`` give an integer or bool input (the
    JAX package runs with x64 off): int32, uint32 for an unsigned input;
    the port's int64 stays int64. None for a floating input."""
    if x.is_floating_point():
        return None
    if x.dtype == torch.int64:
        return torch.int64
    return torch.uint32 if x.dtype in _UNSIGNED else torch.int32


def _accumulated(fn):
    """``fn`` in the reference's result type: integers reduce in int64
    and wrap to their 32-bit type, as the 32-bit reduction wraps."""
    def run(x, ax, kd):
        acc = _int_acc(x)
        if acc is None:
            return fn(x, ax, kd)
        return fn(x.to(torch.int64), ax, kd).to(acc)

    return run


def _mean(x, ax, kd):
    """An integer or bool mean is float32, as ``jnp.mean``'s."""
    if not x.is_floating_point():
        x = x.to(torch.float32)
    return x.mean(dim=ax, keepdim=kd)


_REDUCE = {
    "sum": (_accumulated(lambda x, ax, kd: x.sum(dim=ax, keepdim=kd)),
            ("sum_axis",)),
    "nansum": (_accumulated(
        lambda x, ax, kd: torch.nansum(x, dim=ax, keepdim=kd)), ()),
    "mean": (_mean, ()),
    "prod": (_accumulated(_prod), ()),
    "nanprod": (_accumulated(lambda x, ax, kd: _prod(torch.where(
        torch.isnan(x), torch.ones_like(x), x), ax, kd)), ()),
    "max": (lambda x, ax, kd: torch.amax(x, dim=ax, keepdim=kd),
            ("max_axis",)),
    "min": (lambda x, ax, kd: torch.amin(x, dim=ax, keepdim=kd),
            ("min_axis",)),
}


def _reduce(fn, name):
    def op(data, axis=None, keepdims=False, exclude=False):
        ax = _axes(axis, exclude, data.dim())
        if ax:
            return fn(data, ax, keepdims)
        acc = _int_acc(data) if name in _TYPED else None
        return data if acc is None else data.to(acc)

    op.__name__ = name
    return op


_TYPED = ("sum", "nansum", "prod", "nanprod")

for _name, (_fn, _aliases) in _REDUCE.items():
    globals()[_name] = register(_name, aliases=_aliases)(
        _reduce(_fn, _name))


@register("norm")
def norm(data, ord=2, axis=None, keepdims=False):  # noqa: A002
    """The L2 norm (``ord=1``: the sum of absolute values) over ``axis``
    (every axis when None), as the JAX package's ``norm``."""
    ax = _axes(axis, False, data.dim())
    if ord == 1:
        return data.abs().sum(dim=ax, keepdim=keepdims)
    return torch.sqrt(torch.square(data).sum(dim=ax, keepdim=keepdims))


@register("logsumexp")
def logsumexp(data, axis=None, keepdims=False):
    ax = _axes(axis, False, data.dim())
    if type(data) is not torch.Tensor:
        from torch.distributed.tensor import DTensor, Replicate

        if isinstance(data, DTensor):
            # sharded along the reduced axis (a vocabulary-parallel head):
            # each rank reduces its part, and only the (B, T, 1) max and
            # sum cross the ranks, never the whole rows
            m = torch.amax(data.detach(), dim=ax, keepdim=True)
            m = m.redistribute(m.device_mesh,
                               [Replicate()] * m.device_mesh.ndim)
            m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
            out = torch.log(torch.sum(torch.exp(data - m), dim=ax,
                                      keepdim=True)) + m
            return out if keepdims else out.squeeze(ax)
    return torch.logsumexp(data, dim=ax, keepdim=keepdims)


def _arg(fn, data, axis, keepdims):
    if axis is None:
        r = fn(data.reshape(-1), dim=0)
        if keepdims:
            r = r.reshape((1,) * data.dim())
        return r.to(torch.float32)
    return fn(data, dim=axis, keepdim=keepdims).to(torch.float32)


@register("argmax")
def argmax(data, axis=None, keepdims=False):
    """The first index of the largest value, as float32."""
    return _arg(torch.argmax, data, axis, keepdims)


@register("argmin")
def argmin(data, axis=None, keepdims=False):
    return _arg(torch.argmin, data, axis, keepdims)


@register("argmax_channel")
def argmax_channel(data):
    return torch.argmax(data, dim=1).to(torch.float32)


@register("topk")
def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    """The ``k`` largest (``is_ascend``: smallest) along ``axis``, ties
    taken in index order (``lax.top_k``'s rule, through a stable sort).
    ``ret_typ``: ``"indices"`` (in ``dtype``), ``"value"``, ``"both"``
    (values, indices) or ``"mask"`` (1 at the chosen positions, in the
    data's type)."""
    x = data.movedim(axis, -1)
    vals, idx = torch.sort(x, dim=-1, descending=not is_ascend, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    if ret_typ == "mask":
        m = torch.zeros_like(x).scatter(-1, idx, 1.0)
        return m.movedim(-1, axis)
    vals, idx = vals.movedim(-1, axis), idx.movedim(-1, axis)
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, idx.to(torch_dtype(dtype))
    return idx.to(torch_dtype(dtype))


@register("sort")
def sort(data, axis=-1, is_ascend=True):
    """Sorted along ``axis``; ``axis=None`` sorts the flattened array."""
    if axis is None:
        data, axis = data.reshape(-1), 0
    r = torch.sort(data, dim=axis, stable=True).values
    return r if is_ascend else torch.flip(r, dims=(axis,))


@register("argsort")
def argsort(data, axis=-1, is_ascend=True, dtype="float32"):
    """The sorting indices along ``axis``; ``axis=None`` gives the flat
    indices of the flattened array."""
    if axis is None:
        data, axis = data.reshape(-1), 0
    r = torch.argsort(data, dim=axis, stable=True)
    if not is_ascend:
        r = torch.flip(r, dims=(axis,))
    return r.to(torch_dtype(dtype))


@register("cumsum")
def cumsum(a, axis=None, dtype=None):
    """``jnp.cumsum``: an integer input keeps its type (and wraps), a bool
    one sums to int32."""
    x = a.reshape(-1) if axis is None else a
    if dtype:
        dt = torch_dtype(dtype)
    elif x.dtype == torch.bool:
        dt = torch.int32
    else:
        dt = x.dtype
    return torch.cumsum(x, dim=0 if axis is None else axis, dtype=dt)


# ---------------------------------------------------------------------------
# products (reference: src/operator/tensor/dot*, la_op)
# ---------------------------------------------------------------------------


def _rev(t):
    return t.permute(*reversed(range(t.dim())))


@register("dot")
def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """MXNet's dot: the last axis of ``lhs`` against the first of
    ``rhs``; a transpose flag reverses ALL axes of its operand."""
    a = _rev(lhs) if transpose_a else lhs
    b = _rev(rhs) if transpose_b else rhs
    return torch.tensordot(a, b, dims=1)


@register("batch_dot")
def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    a = lhs.transpose(-1, -2) if transpose_a else lhs
    b = rhs.transpose(-1, -2) if transpose_b else rhs
    return torch.matmul(a, b)


@register("matmul")
def matmul(a, b):
    return torch.matmul(a, b)


@register("khatri_rao")
def khatri_rao(*args):
    out = args[0]
    for m in args[1:]:
        out = torch.einsum("i...,j...->ij...", out, m) \
            .reshape(-1, out.shape[-1])
    return out


@register("linalg_gemm2")
def linalg_gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0,
                 axis=-2):
    a = A.transpose(-1, -2) if transpose_a else A
    b = B.transpose(-1, -2) if transpose_b else B
    return alpha * torch.matmul(a, b)


@register("linalg_gemm")
def linalg_gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
                beta=1.0):
    a = A.transpose(-1, -2) if transpose_a else A
    b = B.transpose(-1, -2) if transpose_b else B
    return alpha * torch.matmul(a, b) + beta * C


@register("linalg_potrf")
def linalg_potrf(A):
    """The lower Cholesky factor."""
    return torch.linalg.cholesky(A)


@register("linalg_syrk")
def linalg_syrk(A, transpose=False, alpha=1.0):
    a = A.transpose(-1, -2) if transpose else A
    return alpha * torch.matmul(a, a.transpose(-1, -2))

