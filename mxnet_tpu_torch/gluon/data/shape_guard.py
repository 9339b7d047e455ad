"""Batch-shape stabilization: pad partial batches, bucket variable
lengths.

PyTorch counterpart of ``mxnet_tpu/gluon/data/shape_guard.py``
(reference analog: ``io.py``'s ``last_batch_handle="pad"`` and GluonNLP's
``FixedBucketSampler``). A captured CUDA graph, like an XLA executable,
runs one input shape, so every distinct input shape is another capture;
the guard keeps the set of shapes small and known:

- :func:`pad_batch` pads a partial final batch up to ``batch_size`` and
  returns the validity mask, so metrics and losses can leave the pad rows
  out exactly;
- :func:`pad_to_shape` pads any number of trailing edges up to a shape
  (the serving engine lifts each request onto its bucket with it);
- :class:`SequenceBucketer` pads variable-length sequences to a small
  fixed set of lengths, bounding the shapes at ``len(buckets)``.

Each takes a numpy array, an ``NDArray`` or a ``torch.Tensor`` and
returns the same kind, on the same device.
"""

from __future__ import annotations

import numpy as _np
import torch

from ...base import MXNetError, is_int
from ...ndarray.ndarray import NDArray


def _check_shape(shape) -> tuple:
    if is_int(shape):
        return (int(shape),)
    return tuple(int(d) for d in shape)


def _pad_leaf(arr, batch_size):
    """Pad ``arr``'s leading axis to ``batch_size`` by repeating its
    first row (finite values, safe under any loss once masked)."""
    n = arr.shape[0]
    if n == batch_size:
        return arr
    if n > batch_size:
        raise MXNetError(
            f"pad_batch: batch of {n} rows exceeds batch_size {batch_size}")
    if n == 0:
        raise MXNetError("pad_batch: cannot pad an empty batch")
    reps = (batch_size - n,) + (1,) * (arr.ndim - 1)
    if isinstance(arr, NDArray):
        t = arr.data
        return NDArray(torch.cat([t, t[:1].repeat(reps)]))
    if isinstance(arr, torch.Tensor):
        return torch.cat([arr, arr[:1].repeat(reps)])
    return _np.concatenate([arr, _np.tile(arr[:1], reps)])


def pad_batch(batch, batch_size):
    """Pad every array in ``batch`` (leading axis) to ``batch_size``.

    Returns ``(padded, mask)`` where ``mask`` is a float32 ``NDArray``
    of shape ``(batch_size,)`` with 1.0 on original rows and 0.0 on pad
    rows, on the batch's device (the CPU for numpy arrays). Feed the mask
    as the loss ``sample_weight`` (and divide by ``mask.sum()`` instead of
    the batch size) and the padded batch gives the same gradients and
    metrics as discarding the tail, at one shape every step.

    ``batch``: an array, or a (possibly nested) list/tuple of arrays (the
    DataLoader ``[data, label]`` convention). Structure is preserved.
    """
    first = batch
    while isinstance(first, (list, tuple)):
        first = first[0]
    n = first.shape[0]

    def walk(obj):
        if isinstance(obj, (list, tuple)):
            return type(obj)(walk(o) for o in obj)
        if obj.shape[0] != n:
            raise MXNetError(
                f"pad_batch: leading axes disagree ({obj.shape[0]} vs {n})")
        return _pad_leaf(obj, batch_size)

    padded = walk(batch)
    mask = torch.zeros((batch_size,), dtype=torch.float32)
    mask[:n] = 1.0
    if isinstance(first, NDArray):
        mask = mask.to(first.data.device)
    elif isinstance(first, torch.Tensor):
        mask = mask.to(first.device)
    return padded, NDArray(mask)


def _pad_widths(shape, target):
    """``torch.nn.functional.pad``'s widths (last axis first) and numpy's
    for growing ``shape`` to ``target``."""
    widths = [(0, t - d) for d, t in zip(shape, target)]
    flat = []
    for lo, hi in reversed(widths):
        flat += [lo, hi]
    return widths, flat


def _pad(arr, target, pad_value):
    widths, flat = _pad_widths(arr.shape, target)
    if isinstance(arr, NDArray):
        return NDArray(torch.nn.functional.pad(arr.data, flat,
                                               value=pad_value))
    if isinstance(arr, torch.Tensor):
        return torch.nn.functional.pad(arr, flat, value=pad_value)
    return _np.pad(_np.asarray(arr), widths, constant_values=pad_value)


def pad_to_shape(arr, shape, pad_value=0):
    """Pad ``arr`` (trailing edge, any number of axes) up to ``shape``.

    The general-rank sibling of :class:`SequenceBucketer`: the serving
    batcher lifts each request's rows onto its shape bucket with it
    before stacking, so ragged traffic reaches the engine in at most
    ``len(buckets)`` shapes. A rank mismatch and a dimension LARGER than
    the target raise (implicit truncation would silently change the
    math, the same contract as ``bucket_for``).
    """
    if not isinstance(arr, (NDArray, torch.Tensor)):
        arr = _np.asarray(arr)
    shape = tuple(int(s) for s in shape)
    if len(arr.shape) != len(shape):
        raise MXNetError(
            f"pad_to_shape: rank {len(arr.shape)} input cannot pad to "
            f"{shape}")
    if any(d > t for d, t in zip(arr.shape, shape)):
        raise MXNetError(
            f"pad_to_shape: input shape {tuple(arr.shape)} exceeds target "
            f"{shape}; add a bucket (truncation is never implicit)")
    if tuple(arr.shape) == shape:
        return arr
    return _pad(arr, shape, pad_value)


class SequenceBucketer:
    """Pad variable-length sequences to a fixed set of bucket lengths.

    >>> bucketer = SequenceBucketer([32, 64, 128])
    >>> x_padded, valid_len = bucketer(x)   # x: (batch, T<=128, ...)

    Every emitted array has one of ``len(buckets)`` shapes, so a
    hybridized block captures AT MOST ``len(buckets)`` graphs. Sequences
    longer than the largest bucket raise (truncation would silently
    change the math; pick buckets to cover the corpus).

    ``axis``: the sequence axis (default 1, the ``(batch, T)`` layout);
    ``pad_value``: fill for the padded tail (default 0, the usual
    ``<pad>`` token id / zero embedding row).
    """

    def __init__(self, buckets, axis=1, pad_value=0):
        lens = sorted({int(b) for b in _check_shape(buckets)})
        if not lens or lens[0] <= 0:
            raise MXNetError(f"invalid bucket lengths {buckets!r}")
        self.buckets = tuple(lens)
        self.axis = axis
        self.pad_value = pad_value

    def bucket_for(self, length: int) -> int:
        """Smallest bucket >= ``length``."""
        for b in self.buckets:
            if length <= b:
                return b
        raise MXNetError(
            f"sequence length {length} exceeds the largest bucket "
            f"{self.buckets[-1]}; add a bucket (truncation is never "
            "implicit)")

    def __call__(self, arr):
        """Pad ``arr`` along ``axis`` to its bucket length.

        Returns ``(padded, valid_length)``: ``valid_length`` is the
        original length (a host int), for masks / ``SequenceMask``.
        """
        if not isinstance(arr, (NDArray, torch.Tensor)):
            arr = _np.asarray(arr)
        length = int(arr.shape[self.axis])
        target = self.bucket_for(length)
        if target == length:
            return arr, length
        shape = list(arr.shape)
        shape[self.axis] = target
        return _pad(arr, tuple(shape), self.pad_value), length
