"""``mx.contrib`` (reference: ``python/mxnet/contrib/``).

Only ``amp`` is ported; the reference's ``onnx``, ``quantization``,
``text``, ``svrg_optimization`` and ``io`` are ROADMAP A13's and raise
``MXNetError`` naming it.
"""

from __future__ import annotations

from ..base import MXNetError
from . import amp  # noqa: F401

_LATER = ("onnx", "quantization", "text", "svrg_optimization", "io")


def __getattr__(name):
    if name in _LATER:
        raise MXNetError(f"mx.contrib.{name} is not ported yet (ROADMAP "
                         "A13); mx.contrib holds amp")
    raise AttributeError(name)
