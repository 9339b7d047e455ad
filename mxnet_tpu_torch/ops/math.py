"""Math operators on tensors: reductions with MXNet's axis semantics, and
the few element-wise operators the loss needs.

PyTorch counterpart of the matching part of ``mxnet_tpu/ops/math.py``.
"""

from __future__ import annotations

import torch

from ..ndarray.ndarray import torch_dtype


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


def sum(data, axis=None, keepdims=False, exclude=False):  # noqa: A001
    ax = _axes(axis, exclude, data.dim())
    return data.sum(dim=ax, keepdim=keepdims) if ax else data


def mean(data, axis=None, keepdims=False, exclude=False):
    ax = _axes(axis, exclude, data.dim())
    return data.mean(dim=ax, keepdim=keepdims) if ax else data


def logsumexp(data, axis=None, keepdims=False):
    ax = _axes(axis, False, data.dim())
    return torch.logsumexp(data, dim=ax, keepdim=keepdims)


def log_softmax(data, axis=-1):
    return torch.log_softmax(data, dim=axis)


def cast(data, dtype="float32"):
    return data.to(torch_dtype(dtype))



def norm(data, ord=2, axis=None, keepdims=False):  # noqa: A002
    """The L2 norm (``ord=1``: the sum of absolute values) over ``axis``
    (every axis when None), as the JAX package's ``norm``."""
    ax = _axes(axis, False, data.dim())
    if ord == 1:
        return data.abs().sum(dim=ax, keepdim=keepdims)
    return torch.sqrt(torch.square(data).sum(dim=ax, keepdim=keepdims))


def where(condition, x, y):
    """``x`` where ``condition`` is non-zero, else ``y``."""
    return torch.where(condition.bool(), x, y)


def _half(x):
    """A 0-d tensor of 1/2 on ``x``'s device, made by a fill kernel (a
    copy from the host would break a CUDA-graph capture)."""
    return torch.full((), 0.5, dtype=x.dtype, device=x.device)


class _Clip(torch.autograd.Function):
    """``min(max(x, a_min), a_max)`` whose gradient at a bound is 1/2, the
    JAX package's rule (``jnp.clip`` is ``jnp.maximum`` then
    ``jnp.minimum``, each splitting a tie); ``torch.clamp`` gives 1
    there."""

    @staticmethod
    def forward(ctx, x, a_min, a_max):
        ctx.save_for_backward(x)
        ctx.bounds = (a_min, a_max)
        return torch.clamp(x, a_min, a_max)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        a_min, a_max = ctx.bounds
        half = _half(x)
        if a_min is not None:
            g = g * torch.heaviside(x - a_min if a_min else x, half)
        if a_max is not None:
            g = g * torch.heaviside(a_max - x, half)
        return g, None, None


def clip(data, a_min=None, a_max=None):
    """Each value limited to ``[a_min, a_max]`` (either bound may be
    None), with the JAX package's gradient at a bound (1/2)."""
    if data.requires_grad:
        return _Clip.apply(data, a_min, a_max)
    return torch.clamp(data, a_min, a_max)
