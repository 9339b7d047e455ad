"""Device contexts: ``mx.gpu(i)`` is ``torch.device("cuda", i)``.

PyTorch counterpart of the part of ``mxnet_tpu/context.py`` that the
serving slice needs. Every entry point of the port resolves its
``device`` argument through :func:`resolve_device`: the default is the
first CUDA card, and the CPU is used only when the caller asks for it
(the CPU tests do). There is no quiet fallback from CUDA to the CPU.
"""

from __future__ import annotations

import torch

from .base import MXNetError


def gpu(device_id: int = 0) -> torch.device:
    """The ``device_id``-th CUDA card."""
    return torch.device("cuda", int(device_id))


def cpu(device_id: int = 0) -> torch.device:
    """The host CPU (``device_id`` is accepted for API symmetry)."""
    del device_id
    return torch.device("cpu")


def resolve_device(device=None) -> torch.device:
    """Map ``None`` / a string / a ``torch.device`` to a concrete device.

    ``None`` means ``cuda:0``. A CUDA device is checked against what this
    process can see and raises :class:`MXNetError` when there is none:
    the port never runs on the CPU unless ``device="cpu"`` was asked for.
    """
    dev = gpu(0) if device is None else torch.device(device)
    if dev.type == "cpu":
        return cpu()
    if dev.type != "cuda":
        raise MXNetError(f"unsupported device {dev}; use 'cuda[:i]' or 'cpu'")
    if not torch.cuda.is_available():
        raise MXNetError(
            f"device {dev} requested but no CUDA device is available; pass "
            "device='cpu' to run on the host explicitly")
    index = 0 if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise MXNetError(f"device {dev} requested but only "
                         f"{torch.cuda.device_count()} CUDA device(s) exist")
    return gpu(index)
