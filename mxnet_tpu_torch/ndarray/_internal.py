"""``mx.nd._internal`` (reference: ``python/mxnet/ndarray/_internal.py``).

PyTorch counterpart of ``mxnet_tpu/ndarray/_internal.py``: the
underscore-prefixed op names (``_plus``, ``_copy``, ``_slice_basic``
...), the same wrappers as ``mx.nd.op``'s.
"""

from __future__ import annotations

import sys

from ..ops import registry as _registry
from . import op as _op

_THIS = sys.modules[__name__]

for _name in list(_registry.all_ops()):
    if _name.startswith("_") and hasattr(_op, _name) \
            and not hasattr(_THIS, _name):
        setattr(_THIS, _name, getattr(_op, _name))
