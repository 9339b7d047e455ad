"""Shape-manipulation and indexing operators, with MXNet's reshape codes.

PyTorch counterpart of ``mxnet_tpu/ops/shape_ops.py`` (reference:
``src/operator/tensor/matrix_op*``, ``indexing_op*``), registered under
the same names and aliases. Many of these return torch views of their
input; ``ndarray.apply`` makes every result a new array for writes (copy
on write), as in the JAX package.
"""

from __future__ import annotations

import contextvars

import torch

from ..base import MXNetError
from ..ndarray.ndarray import torch_dtype
from .registry import register

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


def _resolve(shape, size):
    """A single -1 of an inferred shape resolved against ``size``."""
    out = list(shape)
    if -1 in out:
        known = 1
        for d in out:
            if d != -1:
                known *= d
        out[out.index(-1)] = size // known if known else 0
    return tuple(out)


@register("reshape", aliases=("Reshape",))
def reshape(data, shape=None, reverse=False):
    """MXNet's reshape codes (0, -1, -2, -3, -4); ``reverse`` reads them
    from the right."""
    shape = tuple(shape)
    if reverse:
        rs = _resolve(_infer_reshape(tuple(data.shape)[::-1],
                                     tuple(reversed(shape))), data.numel())
        return data.reshape(rs[::-1])
    return data.reshape(_infer_reshape(data.shape, shape))


@register("reshape_like")
def reshape_like(lhs, rhs):
    return lhs.reshape(rhs.shape)


@register("flatten", aliases=("Flatten",))
def flatten(data):
    """Collapse every axis but the first: ``(d0, d1 * d2 * ...)``."""
    return data.reshape(data.shape[0], -1)


@register("transpose")
def transpose(data, axes=None):
    if not axes:
        axes = tuple(reversed(range(data.dim())))
    return data.permute(*axes)


@register("swapaxes", aliases=("SwapAxis",))
def swapaxes(data, dim1=0, dim2=0):
    return data.transpose(dim1, dim2)


@register("expand_dims")
def expand_dims(data, axis=0):
    return data.unsqueeze(axis)


@register("squeeze")
def squeeze(data, axis=None):
    if axis is None:
        return data.squeeze()
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    return data.squeeze(tuple(a % data.dim() for a in axes))


@register("slice_axis")
def slice_axis(data, axis=0, begin=0, end=None):
    idx = [slice(None)] * data.dim()
    idx[axis] = slice(begin, end)
    return data[tuple(idx)]


@register("slice", aliases=("crop",))
def slice_op(data, begin=(), end=(), step=()):
    idx = []
    for i in range(len(begin)):
        st = step[i] if step and i < len(step) and step[i] is not None \
            else 1
        idx.append(slice(begin[i], end[i], st))
    if any(s.step < 0 for s in idx):  # torch slices step forward only
        return _numpy_slice(data, idx)
    return data[tuple(idx)]


def _numpy_slice(data, idx):
    """A slice with negative steps, gathered position by position."""
    out = data
    for axis, s in enumerate(idx):
        pos = list(range(out.shape[axis])[s])
        out = torch.index_select(out, axis, torch.tensor(
            pos, dtype=torch.long, device=data.device))
    return out


def _freeze_index(idx):
    """A basic index as a hashable attribute (``_slice_basic``)."""
    def f(i):
        if isinstance(i, slice):
            return ("slice", i.start, i.stop, i.step)
        if i is Ellipsis:
            return ("ellipsis",)
        if i is None:
            return ("newaxis",)
        return ("int", int(i))

    if isinstance(idx, tuple):
        return ("tuple",) + tuple(f(i) for i in idx)
    return f(idx)


def _thaw_index(fi):
    def t(e):
        if e[0] == "slice":
            return slice(e[1], e[2], e[3])
        if e[0] == "ellipsis":
            return Ellipsis
        if e[0] == "newaxis":
            return None
        return e[1]

    if fi[0] == "tuple":
        return tuple(t(e) for e in fi[1:])
    return t(fi)


@register("_slice_basic")
def _slice_basic(data, index=None):
    return data[_thaw_index(index)]


@register("slice_like")
def slice_like(data, shape_like, axes=()):
    axes = axes or range(data.dim())
    idx = [slice(None)] * data.dim()
    for a in axes:
        idx[a] = slice(0, shape_like.shape[a])
    return data[tuple(idx)]


@register("take")
def take(a, indices, axis=0, mode="clip"):
    """Slices of ``a`` along ``axis`` at ``indices`` (clipped into range,
    or wrapped with ``mode="wrap"``); the index shape replaces that
    axis."""
    n = a.shape[axis]
    idx = indices.long()
    idx = torch.remainder(idx, n) if mode == "wrap" else \
        torch.clamp(idx, 0, n - 1)
    # indexing, not index_select: its backward accumulates over sorted
    # indices (``index_put_``) and repeats bit for bit, where
    # ``index_add_``'s atomics do not
    return a.movedim(axis, 0)[idx].movedim(tuple(range(idx.dim())), tuple(
        range(axis, axis + idx.dim())))


@register("pick")
def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """``data`` at ``index`` along ``axis`` (indices clipped; float
    labels are cast)."""
    idx = torch.clamp(index.long(), 0, data.shape[axis] - 1)
    r = torch.gather(data, axis, idx.unsqueeze(axis))
    return r if keepdims else r.squeeze(axis)


@register("one_hot")
def one_hot(indices, depth=None, on_value=1.0, off_value=0.0,
            dtype="float32"):
    """Rows of ``depth`` with ``on_value`` at each index and
    ``off_value`` elsewhere; an index outside ``[0, depth)`` gives a row
    of ``off_value``."""
    idx = indices.long()
    hit = idx.unsqueeze(-1) == torch.arange(depth, device=idx.device)
    oh = hit.to(torch_dtype(dtype))
    return oh * (on_value - off_value) + off_value


@register("gather_nd")
def gather_nd(data, indices):
    """``data[indices[0], indices[1], ...]``: the first axis of
    ``indices`` indexes the leading axes of ``data``."""
    return data[tuple(indices.long())]


@register("scatter_nd")
def scatter_nd(data, indices, shape=None):
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(tuple(indices.long()), data)


@register("where")
def where(condition, x, y):
    """``x`` where ``condition`` is non-zero, else ``y``."""
    return torch.where(condition.bool(), x, y)


@register("tile")
def tile(data, reps=()):
    return torch.tile(data, tuple(reps))


@register("repeat")
def repeat(data, repeats=1, axis=None):
    if axis is None:
        return torch.repeat_interleave(data.reshape(-1), repeats)
    return torch.repeat_interleave(data, repeats, dim=axis)


@register("flip", aliases=("reverse",))
def flip(data, axis=()):
    if isinstance(axis, int):
        axis = (axis,)
    return torch.flip(data, dims=tuple(axis))


@register("broadcast_to")
def broadcast_to(data, shape=()):
    tgt = tuple(s if s != 0 else d for s, d in zip(shape, data.shape))
    return data.expand(tgt)


@register("broadcast_like")
def broadcast_like(lhs, rhs, lhs_axes=None, rhs_axes=None):
    if lhs_axes is None:
        return lhs.expand(rhs.shape)
    tgt = list(lhs.shape)
    for la, ra in zip(lhs_axes, rhs_axes):
        tgt[la] = rhs.shape[ra]
    return lhs.expand(tuple(tgt))


@register("broadcast_axis", aliases=("broadcast_axes",))
def broadcast_axis(data, axis=(), size=()):
    if isinstance(axis, int):
        axis, size = (axis,), (size,)
    tgt = list(data.shape)
    for a, s in zip(axis, size):
        tgt[a] = s
    return data.expand(tuple(tgt))


@register("zeros_like")
def zeros_like(data):
    return torch.zeros_like(data)


@register("ones_like")
def ones_like(data):
    return torch.ones_like(data)


@register("full_like")
def full_like(data, fill_value=0.0):
    return torch.full_like(data, fill_value)


@register("shape_array")
def shape_array(data):
    return torch.tensor(data.shape, dtype=torch.int32, device=data.device)


@register("size_array")
def size_array(data):
    return torch.tensor([data.numel()], dtype=torch.int32,
                        device=data.device)


@register("diag")
def diag(data, k=0):
    if data.dim() == 1:
        return torch.diag(data, k)
    return torch.diagonal(data, offset=k, dim1=-2, dim2=-1)


@register("identity", aliases=("_copy", "copy"))
def identity(data):
    return data.clone()


@register("stop_gradient", aliases=("BlockGrad", "make_loss", "MakeLoss"))
def stop_gradient(data):
    """The same values with no gradient (a view of the input's storage;
    ``ndarray.apply`` makes it a new array for writes)."""
    return data.detach().view_as(data)


@register("boolean_mask", aliases=("_contrib_boolean_mask",))
def boolean_mask(data, index, axis=0):
    """The slices along ``axis`` where ``index`` is non-zero (a
    data-dependent shape, computed eagerly as in the JAX package)."""
    keep = torch.nonzero(index.reshape(-1).bool()).reshape(-1)
    return torch.index_select(data, axis, keep)


def _length_mask(data, sequence_length, axis):
    """(T, B) on axis 0 or (B, T) on axis 1: step < length, shaped to
    broadcast against ``data``."""
    steps = torch.arange(data.shape[axis], device=data.device)
    mask = steps[:, None] < sequence_length[None, :]  # (T, B)
    if axis == 1:
        mask = mask.T
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    shape[1 - axis] = data.shape[1 - axis]
    return mask.reshape(shape)


@register("sequence_mask", aliases=("SequenceMask",))
def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    if not use_sequence_length or sequence_length is None:
        return data
    mask = _length_mask(data, sequence_length, axis)
    return torch.where(mask, data, torch.full((), value, dtype=data.dtype,
                                              device=data.device))


@register("SequenceLast")
def sequence_last(data, sequence_length=None, use_sequence_length=False,
                  axis=0):
    if not use_sequence_length or sequence_length is None:
        idx = [slice(None)] * data.dim()
        idx[axis] = -1
        return data[tuple(idx)]
    last = sequence_length.long() - 1
    moved = data.movedim(axis, 0)  # (T, B, ...)
    idx = last.reshape((1, -1) + (1,) * (moved.dim() - 2)) \
        .expand((1,) + tuple(moved.shape[1:]))
    return torch.gather(moved, 0, idx)[0]


@register("SequenceReverse")
def sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                     axis=0):
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, dims=(axis,))
    moved = data.movedim(axis, 0)
    steps = torch.arange(moved.shape[0], device=data.device)[:, None]
    lens = sequence_length.long()[None, :]
    src = torch.where(steps < lens, lens - 1 - steps, steps)
    src = src.reshape(src.shape + (1,) * (moved.dim() - 2)) \
        .expand(moved.shape)
    return torch.gather(moved, 0, src).movedim(0, axis)


@register("concat", aliases=("Concat",))
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


@register("stack")
def stack(*args, axis=0):
    return torch.stack(args, dim=axis)


@register("split", aliases=("SliceChannel",))
def split(data, num_outputs=1, axis=1, squeeze_axis=False):
    parts = torch.chunk(data, num_outputs, dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts) if num_outputs > 1 else parts[0]


@register("split_v2")
def split_v2(data, indices=(), axis=0, squeeze_axis=False, sections=0):
    n = data.shape[axis]
    if sections:
        parts = torch.chunk(data, sections, dim=axis)
    else:
        bounds = [0] + [int(i) for i in indices] + [n]
        parts = [data.narrow(axis, a, b - a)
                 for a, b in zip(bounds[:-1], bounds[1:])]
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts) if len(parts) > 1 else parts[0]


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


@register("pad", aliases=("Pad",))
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
