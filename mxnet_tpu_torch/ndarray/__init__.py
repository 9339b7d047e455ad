"""``mx.nd``: NDArray, its constructors and the operator namespace.

PyTorch counterpart of ``mxnet_tpu/ndarray``. Constructors place on the
current context (the first CUDA card by default; ``ctx=mx.cpu()`` for the
host). The operator namespace is generated from the registry
(``op.py``), and the common operators are attached as NDArray methods,
as in the reference. ``nd.contrib``, ``nd.sparse``, ``nd.image`` and
``nd.linalg`` are ROADMAP A13's.
"""

from .ndarray import (  # noqa: F401
    NDArray,
    arange,
    array,
    concatenate,
    empty,
    eye,
    full,
    imdecode,
    linspace,
    load,
    ones,
    ones_like,
    save,
    waitall,
    zeros,
    zeros_like,
)
from . import op  # noqa: F401
from . import _internal  # noqa: F401
from .op import *  # noqa: F401,F403
from .op import (  # noqa: F401
    _contrib_fused_matmul_stats,
    _contrib_fused_scaled_matmul_stats,
)
from . import random  # noqa: F401

# ---------------------------------------------------------------------------
# method attachment (reference: NDArray methods generated over the same ops)
# ---------------------------------------------------------------------------

_METHODS = [
    "sum", "nansum", "mean", "prod", "nanprod", "max", "min", "norm",
    "argmax", "argmin", "abs", "sign", "round", "rint", "ceil", "floor",
    "trunc", "fix", "square", "sqrt", "rsqrt", "cbrt", "rcbrt", "exp",
    "log", "log10", "log2", "log1p", "expm1", "sin", "cos", "tan",
    "arcsin", "arccos", "arctan", "sinh", "cosh", "tanh", "arcsinh",
    "arccosh", "arctanh", "degrees", "radians", "sigmoid", "softmax",
    "log_softmax", "relu", "clip", "expand_dims", "squeeze", "flatten",
    "transpose", "swapaxes", "flip", "tile", "repeat", "split",
    "slice_axis", "slice_like", "take", "pick", "one_hot", "topk", "sort",
    "argsort", "broadcast_to", "broadcast_like", "reshape_like",
    "diag", "pad",
]


def _attach_method(name):
    fn = getattr(op, name)

    def method(self, *args, **kwargs):
        return fn(self, *args, **kwargs)

    method.__name__ = name
    setattr(NDArray, name, method)


for _m in _METHODS:
    if getattr(NDArray, _m, None) is None:
        _attach_method(_m)


def _reshape_method(self, *shape, **kwargs):
    """``x.reshape(2, 3)``, ``x.reshape((2, 3))`` or ``x.reshape(shape=
    (2, 3))``, with MXNet's reshape codes."""
    if "shape" in kwargs:
        shape = kwargs.pop("shape")
    elif len(shape) == 1 and isinstance(shape[0], (list, tuple)):
        shape = tuple(shape[0])
    return op.reshape(self, shape=tuple(shape), **kwargs)


NDArray.reshape = _reshape_method
