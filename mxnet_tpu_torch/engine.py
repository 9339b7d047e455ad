"""Engine control surface (reference: ``python/mxnet/engine.py``).

PyTorch counterpart of ``mxnet_tpu/engine.py``. CUDA streams run work
asynchronously, as the reference's dependency engine did: :func:`wait`
and :func:`waitall` are the sync points, CUDA synchronisations of the
devices the arrays live on, where a deferred device error surfaces.
``bulk``/``set_bulk_size`` keep the API and change nothing (a hybridized
block's CUDA graph is the port's bulk execution). ``MXTPU_SYNC_EXEC=1``
waits after every op (``ops/dispatch.py``), the reference NaiveEngine's
debugging role.
"""

from __future__ import annotations

import contextlib
import os

import torch

from .base import getenv

_BULK = {"size": 15}


def set_bulk_size(size):
    prev, _BULK["size"] = _BULK["size"], size
    return prev


@contextlib.contextmanager
def bulk(size):
    prev = set_bulk_size(size)
    try:
        yield
    finally:
        set_bulk_size(prev)


# os.environ's own bytes mapping and the variable's key in it: the check
# runs once per op, and os.environ[...] encodes its key on every call
_ENV = getattr(os.environ, "_data", None)
_SYNC_KEY = os.environ.encodekey("MXTPU_SYNC_EXEC") \
    if _ENV is not None else None


def sync_exec_enabled() -> bool:
    """NaiveEngine analog: ``MXTPU_SYNC_EXEC=1`` waits after every op
    (read at every call, as the JAX package reads it)."""
    if _ENV is None:
        return bool(getenv("MXTPU_SYNC_EXEC", False, dtype=bool))
    v = _ENV.get(_SYNC_KEY)
    return v is not None and v not in (b"0", b"false", b"False", b"")


def _devices(tree, into):
    from .ndarray.ndarray import NDArray

    if isinstance(tree, NDArray):
        tree = tree._t
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            into.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _devices(v, into)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _devices(v, into)
    return into


def wait(tree):
    """Block until the work producing every array in ``tree`` (NDArrays
    and tensors, nested in lists, tuples and dicts) has finished: one
    CUDA synchronisation per device they live on (reference:
    ``Engine::WaitForVar``). Returns ``tree``."""
    for dev in _devices(tree, set()):
        torch.cuda.synchronize(dev)
    return tree


def waitall():
    """Block until all queued device work has finished (reference:
    ``MXNDArrayWaitAll``); nothing to wait for without CUDA."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
