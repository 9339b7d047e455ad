"""Gluon utilities of the port (reference: ``mxnet_tpu/gluon/utils.py``):
splitting a batch over contexts, clipping by the global norm, checking a
file's SHA-1, and carrying weights in from numpy."""

from __future__ import annotations

import hashlib
import warnings

import numpy as _np
import torch

from ..base import MXNetError
from ..ndarray.ndarray import NDArray, array as _array


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``data`` cut into ``num_slice`` pieces along ``batch_axis``; with
    ``even_split=False`` the last piece takes the remainder."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise MXNetError(
            f"data with shape {data.shape} cannot be evenly split into "
            f"{num_slice} slices along axis {batch_axis}")
    step = size // num_slice
    ends = [(i + 1) * step for i in range(num_slice)]
    if not even_split:
        ends[-1] = size
    return [data.slice_axis(axis=batch_axis, begin=i * step, end=e)
            for i, e in enumerate(ends)]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """One piece of ``data`` on each context of ``ctx_list``: how a
    multi-device Gluon loop feeds its contexts."""
    if not isinstance(data, NDArray):
        data = _array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` in place so that their joint L2 norm is at most
    ``max_norm``; returns the norm before scaling (a float)."""
    total = sum(float(torch.sum(torch.square(a.data.detach())))
                for a in arrays)
    total_norm = total ** 0.5
    if check_isfinite and not _np.isfinite(total_norm):
        warnings.warn("nan or inf found in clip_global_norm")
    scale = max_norm / (total_norm + 1e-8)
    if scale < 1.0:
        for a in arrays:
            a._set_data(a.data.detach() * scale)
    return total_norm


def check_sha1(filename, sha1_hash):
    """Whether the file's SHA-1 hex digest is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            sha1.update(chunk)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    """The reference's ``download``: this package fetches nothing, so it
    raises; place the file locally and pass its path instead."""
    raise MXNetError(
        f"download({url}) is unavailable: no network egress. Place files "
        "locally and pass a local path instead.")


def shape_is_known(shape):
    """Whether every dimension of ``shape`` is known (positive)."""
    if shape is None:
        return False
    return all(s is not None and s > 0 for s in shape)


def load_numpy(params, arrays):
    """Copy ``{name: np.ndarray}`` into ``params`` (a ``ParameterDict``,
    e.g. ``net.collect_params()``) in place, each array cast to its
    parameter's type. The names must match exactly: a missing or extra
    name, or a shape that differs, raises before anything is written.
    A parameter whose initialisation is still deferred takes the array's
    shape and is initialised by it."""
    missing = sorted(set(params.keys()) - set(arrays))
    extra = sorted(set(arrays) - set(params.keys()))
    if missing or extra:
        raise MXNetError(f"load_numpy: missing {missing[:5]} (of "
                         f"{len(missing)}), extra {extra[:5]} (of "
                         f"{len(extra)})")
    for name, a in arrays.items():
        shape = params[name].shape
        if shape is not None and (len(a.shape) != len(shape) or any(
                s > 0 and s != n for s, n in zip(shape, a.shape))):
            raise MXNetError(f"load_numpy: {name} has shape {a.shape}, the "
                             f"parameter {shape}")
    for name, a in arrays.items():
        params[name].set_data(a)
