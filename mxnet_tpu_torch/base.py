"""Base utilities: the framework error type and env helpers.

PyTorch counterpart of ``mxnet_tpu/base.py`` (kept as its own copy: the
port imports nothing of the JAX package).
"""

from __future__ import annotations

import os

import numpy as _np


class MXNetError(RuntimeError):
    """Error raised by the framework (reference: ``base.py:MXNetError``)."""


def getenv(name: str, default=None, *, dtype=str):
    """Read an ``MXTPU_*`` env var (reference analog: ``dmlc::GetEnv``)."""
    v = os.environ.get(name)
    if v is None:
        return default
    if dtype is bool:
        return v not in ("0", "false", "False", "")
    return dtype(v)


def is_int(x) -> bool:
    """True for Python and numpy integers (never for bools)."""
    return isinstance(x, (int, _np.integer)) and not isinstance(x, bool)
