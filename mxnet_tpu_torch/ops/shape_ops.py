"""Shape operators on tensors, with MXNet's reshape codes.

PyTorch counterpart of the matching part of ``mxnet_tpu/ops/shape_ops.py``.
"""

from __future__ import annotations

import contextvars

import torch

from ..base import MXNetError

# True while a net converted by optimize_for("tpu_fused_conv_bn") runs:
# its 4-D activations are then NHWC, so axis 1 is H, not the channels
NHWC_INTERIOR = contextvars.ContextVar("nhwc_interior", default=False)


def _infer_reshape(src_shape, target):
    """MXNet reshape special values (reference: matrix_op ``ReshapeParam``):
    0 copy input dim; -1 infer; -2 copy all remaining; -3 merge next two
    input dims; -4 split an input dim by the following two target values."""
    out = []
    src = list(src_shape)
    i = 0
    t = 0
    target = list(target)
    while t < len(target):
        d = target[t]
        if d == 0:
            out.append(src[i])
            i += 1
        elif d == -1:
            out.append(-1)
            i += 1
        elif d == -2:
            out.extend(src[i:])
            i = len(src)
        elif d == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif d == -4:
            a, b = target[t + 1], target[t + 2]
            if a == -1:
                a = src[i] // b
            if b == -1:
                b = src[i] // a
            out.extend([a, b])
            i += 1
            t += 2
        else:
            out.append(d)
            i += 1
        t += 1
    return tuple(out)


def reshape(data, shape=None):
    return data.reshape(_infer_reshape(data.shape, tuple(shape)))


def transpose(data, axes=None):
    if not axes:
        axes = tuple(reversed(range(data.dim())))
    return data.permute(*axes)


def expand_dims(data, axis=0):
    return data.unsqueeze(axis)


def slice_axis(data, axis=0, begin=0, end=None):
    idx = [slice(None)] * data.dim()
    idx[axis] = slice(begin, end)
    return data[tuple(idx)]


def take(a, indices, axis=0):
    """Slices of ``a`` along ``axis`` at ``indices`` (clipped into range);
    the index shape replaces that axis."""
    idx = torch.clamp(indices.long(), 0, a.shape[axis] - 1)
    out = torch.index_select(a, axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


def pick(data, index, axis=-1, keepdims=False):
    """``data`` at ``index`` along ``axis`` (indices clipped; float
    labels are cast)."""
    idx = torch.clamp(index.long(), 0, data.shape[axis] - 1)
    r = torch.gather(data, axis, idx.unsqueeze(axis))
    return r if keepdims else r.squeeze(axis)


def flatten(data):
    """Collapse every axis but the first: ``(d0, d1 * d2 * ...)``."""
    return data.reshape(data.shape[0], -1)


def identity(data):
    return data.clone()


def concat(*args, dim=1):
    """The arrays joined along ``dim``. Inside the fused pass's NHWC
    interior a join of 4-D arrays on axis 1 would join on H where the net
    means channels (the JAX package does so, ROADMAP C7): it raises."""
    if NHWC_INTERIOR.get() and args[0].dim() == 4 and dim % 4 == 1:
        raise MXNetError(
            "concat on axis 1 of 4-D arrays inside "
            "optimize_for(tpu_fused_conv_bn)'s NHWC interior would join "
            "on H, not on channels (ROADMAP C7)")
    return torch.cat(args, dim=dim)


def _pad_index(n, before, after, mode, device):
    """Source positions of a padded axis of length ``n``: ``edge`` repeats
    the end values, ``reflect`` mirrors about them without repeating them
    (numpy's modes, periodic for pads longer than the axis)."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)
    if period == 0:
        return torch.zeros_like(i)
    j = i.remainder(period)
    return torch.where(j >= n, period - j, j)


def pad(data, mode="constant", pad_width=(), constant_value=0.0):
    """Pad every axis by ``pad_width = (before_0, after_0, before_1, ...)``
    in ``constant``, ``edge`` or ``reflect`` mode. The edge and reflect
    modes gather along each padded axis, so their gradient sums into the
    sources, as the JAX package's ``jnp.pad`` does."""
    pw = [(int(pad_width[2 * i]), int(pad_width[2 * i + 1]))
          for i in range(len(pad_width) // 2)]
    if mode == "constant":
        flat = []
        for before, after in reversed(pw):  # F.pad takes the last axis first
            flat += [before, after]
        return torch.nn.functional.pad(data, flat, value=constant_value)
    if mode not in ("edge", "reflect"):
        raise ValueError(f"unknown pad mode {mode}")
    out = data
    for axis, (before, after) in enumerate(pw):
        if before or after:
            idx = _pad_index(out.shape[axis], before, after, mode,
                             out.device)
            out = torch.index_select(out, axis, idx)
    return out
