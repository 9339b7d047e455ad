"""Device contexts: ``mx.gpu(i)`` (alias ``mx.tpu(i)``) is the i-th CUDA
card, ``mx.cpu()`` the host.

PyTorch counterpart of ``mxnet_tpu/context.py``. A :class:`Context` names
a device; :func:`resolve_device` turns it (or ``None``, a string or a
``torch.device``) into a ``torch.device``. The default is the first CUDA
card, and the CPU is used only when the caller asks for it (the CPU tests
do): MXNet's own default context was the CPU, the port's is the card.
There is no quiet fallback from CUDA to the CPU: without a card, a CUDA
context raises when it is used.

``with ctx:`` pushes a default context for the thread, as in MXNet; it is
what ``current_context()`` returns, and what ``nd.array`` and
``net.initialize()`` place on when no ``ctx`` is given.
"""

from __future__ import annotations

import threading

import torch

from .base import MXNetError

_ALIASES = {"cpu": "cpu", "gpu": "cuda", "tpu": "cuda", "cuda": "cuda"}


class Context:
    """A device context: ``Context("gpu", 0)``, ``Context(other)`` or
    ``Context(torch.device(...))``. ``gpu`` and ``tpu`` both name CUDA
    cards and compare equal; a context also compares equal to the
    ``torch.device`` it names."""

    _stack = threading.local()

    def __init__(self, device_type, device_id: int = 0):
        if isinstance(device_type, Context):
            device_type, device_id = device_type.device_type, \
                device_type.device_id
        elif isinstance(device_type, torch.device):
            device_type, device_id = device_type.type, device_type.index or 0
        if device_type not in _ALIASES:
            raise MXNetError(f"unknown device type {device_type!r}")
        self.device_type = "gpu" if device_type == "cuda" else device_type
        self.device_id = int(device_id)

    def _key(self):
        kind = _ALIASES[self.device_type]
        return (kind, 0 if kind == "cpu" else self.device_id)

    def __eq__(self, other):
        if isinstance(other, (Context, torch.device)):
            return self._key() == Context(other)._key()
        return NotImplemented

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__

    def __enter__(self):
        stack = getattr(Context._stack, "items", None)
        if stack is None:
            stack = Context._stack.items = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        Context._stack.items.pop()
        return False


def gpu(device_id: int = 0) -> Context:
    """The ``device_id``-th CUDA card."""
    return Context("gpu", device_id)


def tpu(device_id: int = 0) -> Context:
    """Alias of :func:`gpu`, so scripts written for the JAX package run
    unchanged on the card."""
    return Context("tpu", device_id)


def cpu(device_id: int = 0) -> Context:
    """The host CPU (``device_id`` is accepted for API symmetry)."""
    return Context("cpu", device_id)


def current_context() -> Context:
    """The innermost ``with ctx:`` context of this thread, else
    ``gpu(0)``."""
    stack = getattr(Context._stack, "items", None)
    return stack[-1] if stack else gpu(0)


def resolve_device(device=None) -> torch.device:
    """Map ``None`` / a :class:`Context` / a string / a ``torch.device``
    to a concrete ``torch.device``.

    ``None`` means ``cuda:0``. A CUDA device is checked against what this
    process can see and raises :class:`MXNetError` when there is none:
    the port never runs on the CPU unless ``device="cpu"`` was asked for.
    """
    if device is None:
        dev = torch.device("cuda", 0)
    elif isinstance(device, Context):
        dev = torch.device(_ALIASES[device.device_type], device.device_id)
    else:
        dev = torch.device(device)
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.type != "cuda":
        raise MXNetError(f"unsupported device {dev}; use 'cuda[:i]' or 'cpu'")
    if not torch.cuda.is_available():
        raise MXNetError(
            f"device {dev} requested but no CUDA device is available; pass "
            "device='cpu' (ctx=mx.cpu()) to run on the host explicitly")
    index = 0 if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise MXNetError(f"device {dev} requested but only "
                         f"{torch.cuda.device_count()} CUDA device(s) exist")
    return torch.device("cuda", index)
