"""Misc utilities (reference: ``python/mxnet/util.py``; the port's copy
of ``mxnet_tpu/util.py``)."""

from __future__ import annotations

import functools
import os

import torch

_np_array = False
_np_shape = False


def is_np_array():
    return _np_array


def is_np_shape():
    return _np_shape


def set_np(shape=True, array=True):
    """Set the NumPy-semantics flags (the ``mx.np`` front end itself is
    ROADMAP A13's)."""
    global _np_array, _np_shape
    _np_array, _np_shape = array, shape


def reset_np():
    set_np(False, False)


def use_np(func):
    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        return func(*args, **kwargs)

    return wrapper


def makedirs(d):
    os.makedirs(os.path.expanduser(d), exist_ok=True)


def get_gpu_count():
    from .context import num_gpus

    return num_gpus()


def get_gpu_memory(dev_id=0):
    """``(bytes in use by this process's tensors, the card's bytes)``;
    ``(0, 0)`` without that card."""
    if not torch.cuda.is_available() or dev_id >= torch.cuda.device_count():
        return (0, 0)
    return (torch.cuda.memory_allocated(dev_id),
            torch.cuda.get_device_properties(dev_id).total_memory)
