"""``mx.nd``: NDArray, its constructors and the operator namespace.

PyTorch counterpart of ``mxnet_tpu/ndarray``. Constructors place on the
current context (the first CUDA card by default; ``ctx=mx.cpu()`` for the
host).
"""

from .ndarray import (  # noqa: F401
    NDArray,
    array,
    ones,
    waitall,
    zeros,
)
from .op import *  # noqa: F401,F403
from .op import (  # noqa: F401
    _contrib_fused_matmul_stats,
    _contrib_fused_scaled_matmul_stats,
)
from . import op  # noqa: F401
