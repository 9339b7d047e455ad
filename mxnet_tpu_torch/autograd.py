"""MXNet's autograd surface over ``torch.autograd``.

PyTorch counterpart of ``mxnet_tpu/autograd.py``. ``record()`` turns
recording on for the thread: operators of the ``nd`` namespace then build
a ``torch.autograd`` graph (outside it they run under ``torch.no_grad()``).
``train_mode``/``predict_mode`` only set the flag that layers such as
``Dropout`` read.

:func:`backward` keeps MXNet's gradient semantics, which differ from
torch's ``.grad``: each array that called ``attach_grad`` owns a gradient
buffer, ``grad_req="write"`` OVERWRITES it on every backward and only
``"add"`` accumulates; a buffer that receives no gradient is left as it
was; a head that is not a scalar is seeded with ones.
"""

from __future__ import annotations

import threading
import weakref

import torch

from .base import MXNetError


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_STATE = _State()

# every live NDArray with an attached gradient buffer
_LEAVES: "weakref.WeakSet" = weakref.WeakSet()


def _register_leaf(arr):
    _LEAVES.add(arr)


def is_recording() -> bool:
    return _STATE.recording


def is_training() -> bool:
    return _STATE.training


class _RecordingStateScope:
    def __init__(self, is_record, train_mode):
        self._enter = (is_record, train_mode)
        self._prev = None

    def __enter__(self):
        self._prev = (_STATE.recording, _STATE.training)
        is_record, train = self._enter
        if is_record is not None:
            _STATE.recording = is_record
        if train is not None:
            _STATE.training = train
        return self

    def __exit__(self, *exc):
        _STATE.recording, _STATE.training = self._prev
        return False


def record(train_mode: bool = True):
    """Scope in which operators are recorded for :func:`backward`."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode: bool = False):
    """Scope in which nothing is recorded (inside ``record()``)."""
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


def backward(heads, head_grads=None, retain_graph: bool = False,
             train_mode: bool = True):
    """Gradients of ``heads`` (NDArrays) into the buffers of every array
    that called ``attach_grad`` and lies on their graph.

    ``head_grads`` default to ones of each head's shape (MXNet seeds a
    non-scalar head that way). Reference: ``Imperative::Backward``."""
    from .ndarray.ndarray import NDArray

    del train_mode  # the forward already ran in its mode
    if isinstance(heads, NDArray):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, NDArray):
        head_grads = [head_grads]
    outs, seeds = [], []
    for h, hg in zip(heads, head_grads):
        if not h._t.requires_grad:
            raise MXNetError(
                "cannot differentiate a head that is not on the tape; run "
                "inside autograd.record() and/or attach_grad()")
        outs.append(h._t)
        seeds.append(torch.ones_like(h._t) if hg is None
                     else hg._t.to(h._t.dtype))
    leaves = [a for a in list(_LEAVES)
              if a._grad is not None and a._t.requires_grad]
    grads = torch.autograd.grad(outs, [a._t for a in leaves], seeds,
                                retain_graph=retain_graph, allow_unused=True)
    with torch.no_grad():
        for arr, g in zip(leaves, grads):
            if g is None:
                continue
            if arr._grad_req == "add":
                arr._grad._t.add_(g)
            else:
                arr._grad._t.copy_(g)
