"""Shape operators on tensors, with MXNet's reshape codes.

PyTorch counterpart of the matching part of ``mxnet_tpu/ops/shape_ops.py``.
"""

from __future__ import annotations

import torch


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


def identity(data):
    return data.clone()
