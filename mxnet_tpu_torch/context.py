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

``mx.cpu(i)`` for distinct ``i`` are distinct contexts, as in the JAX
package and in MXNet: each names a host device of its own (a parameter
initialised on ``[cpu(0), cpu(1)]`` keeps two copies), though every one of
them resolves to ``torch.device("cpu")``. An ``NDArray`` remembers the
context it was placed on, so ``x.context`` tells ``cpu(1)`` from
``cpu(0)``.

In a world of several processes (``kvstore.init_distributed``) each rank
owns one card: card ``rank % device_count``, which ``mx.gpu(0)`` names
inside that rank (device ids index process-local devices, as in the JAX
package), and ``num_gpus()`` is 1. On a machine with one card every rank
owns ``cuda:0``.
"""

from __future__ import annotations

import threading

import torch

from .base import MXNetError

_ALIASES = {"cpu": "cpu", "cpu_pinned": "cpu", "gpu": "cuda", "tpu": "cuda",
            "cuda": "cuda"}

#: The card this process owns in a world of several ranks (set by
#: ``kvstore.dist.init_distributed``); None: every card is visible.
_LOCAL_CARD = [None]


def set_local_card(index):
    """Make ``mx.gpu(0)`` name CUDA card ``index`` (None: undo)."""
    _LOCAL_CARD[0] = None if index is None else int(index)


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
            if device_type == "cuda" and _LOCAL_CARD[0] is not None:
                device_id -= _LOCAL_CARD[0]
        if device_type not in _ALIASES:
            raise MXNetError(f"unknown device type {device_type!r}")
        self.device_type = "gpu" if device_type == "cuda" else device_type
        self.device_id = int(device_id)

    def _key(self):
        return (_ALIASES[self.device_type], self.device_id)

    def _places(self, device: torch.device) -> bool:
        """Whether a tensor on ``device`` can belong to this context:
        every host context resolves to the one CPU device."""
        kind = _ALIASES[self.device_type]
        return kind == device.type and (
            kind == "cpu" or Context(device).device_id == self.device_id)

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
    """The ``device_id``-th host device; all of them are the host CPU to
    torch, and distinct contexts to Gluon."""
    return Context("cpu", device_id)


def cpu_pinned(device_id: int = 0) -> Context:
    """Host memory the card copies from directly (reference:
    ``cpu_pinned``); arrays on it live on the CPU."""
    return Context("cpu_pinned", device_id)


def num_gpus() -> int:
    """The number of CUDA cards this process sees (reference:
    ``context.py:num_gpus``): one in a rank of a distributed world."""
    if not torch.cuda.is_available():
        return 0
    return 1 if _LOCAL_CARD[0] is not None else torch.cuda.device_count()


def num_tpus() -> int:
    """Alias of :func:`num_gpus`: ``mx.tpu(i)`` names the i-th card."""
    return num_gpus()


def current_context() -> Context:
    """The innermost ``with ctx:`` context of this thread, else
    ``gpu(0)``."""
    stack = getattr(Context._stack, "items", None)
    return stack[-1] if stack else gpu(0)


def resolve_device(device=None) -> torch.device:
    """Map ``None`` / a :class:`Context` / a string / a ``torch.device``
    to a concrete ``torch.device``.

    ``None`` means ``gpu(0)``: ``cuda:0``, or the rank's own card in a
    distributed world. A CUDA device is checked against what this process
    can see and raises :class:`MXNetError` when there is none: the port
    never runs on the CPU unless ``device="cpu"`` was asked for.
    """
    if device is None:
        device = Context("gpu", 0)
    if isinstance(device, Context):
        kind = _ALIASES[device.device_type]
        if kind == "cpu":
            return torch.device("cpu")
        local = _LOCAL_CARD[0]
        if local is not None and device.device_id != 0:
            raise MXNetError(f"{device} requested, but a rank of a "
                             "distributed world owns one card, gpu(0)")
        dev = torch.device(kind, device.device_id + (local or 0))
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
    index = (_LOCAL_CARD[0] or 0) if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise MXNetError(f"device {dev} requested but only "
                         f"{torch.cuda.device_count()} CUDA device(s) exist")
    return torch.device("cuda", index)
