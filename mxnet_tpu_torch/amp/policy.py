"""AMP cast-policy state and the op-dispatch cast wrapper.

PyTorch counterpart of ``mxnet_tpu/amp/policy.py``. It imports only
``torch``: the op dispatch (``ops/dispatch.py``) and a hybridized block's
cache key (``gluon/block.py``) read it, and both sit below the rest of the
``amp`` package.

The policy is the reference MXNet's ``contrib/amp/lists/symbol_fp16.py``:
ops whose accumulation goes wrong in half precision (reductions, the
softmax family, norm layers, exp/log) run in fp32 while the network
around them computes in bfloat16 or float16. The wrapper upcasts an op's
low-precision inputs, runs the op and casts its fp32 outputs back, as
part of the op's own call; a hybridized block captures by running its
ops, so the casts land in its CUDA graph.

``BatchNorm`` is on the documented list but enforced by the op itself:
its moments accumulate in fp32 inside it (``ops/nn.py``), and its running
statistics keep their storage type (a downcast here would turn the fp32
statistics that ``convert_model`` pins into bfloat16).
"""

from __future__ import annotations

import torch

#: op families the reference forces to fp32 (lists/symbol_fp16.py);
#: ``amp.init(fp32_ops=...)`` extends it
FP32_OPS = (
    "softmax", "log_softmax", "softmin", "SoftmaxOutput",
    "softmax_cross_entropy", "norm", "mean", "sum", "nansum",
    "logsumexp", "BatchNorm", "LayerNorm", "InstanceNorm", "GroupNorm",
    "L2Normalization", "exp", "log", "smooth_l1",
)

#: FP32_OPS members enforced inside their op rather than by the wrapper
_STRUCTURAL = frozenset({"BatchNorm"})

#: THE shared state: ``target_dtype`` None means AMP is off (callers may
#: flip this key directly, so every check reads the dict)
_STATE = {
    "target_dtype": None,
    "cast_ops": frozenset(FP32_OPS) - _STRUCTURAL,
}

_LOW = ("bfloat16", "float16")


def is_low_precision_dtype(dtype) -> bool:
    """THE {float16, bfloat16} predicate for master-weight and cast
    decisions, single-sourced here so the fused update, the eager
    optimizer and the cast policy agree. Takes torch dtypes and names."""
    return str(dtype).replace("torch.", "") in _LOW


def target_dtype():
    return _STATE["target_dtype"]


def is_enabled() -> bool:
    return _STATE["target_dtype"] is not None


def set_policy(target_dtype, fp32_ops=None):
    """Activate AMP with the default FP32 set plus ``fp32_ops``."""
    ops = frozenset(FP32_OPS) | frozenset(fp32_ops or ())
    _STATE["cast_ops"] = ops - _STRUCTURAL
    _STATE["target_dtype"] = target_dtype


def clear_policy():
    _STATE["target_dtype"] = None


def _is_low(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point() \
        and is_low_precision_dtype(x.dtype)


def wrap_fp32(fn):
    """``fn`` under the fp32 cast policy: low-precision float inputs are
    upcast to fp32, the op runs, and its fp32 outputs are cast back to
    the low input type. bfloat16 mixed with float16 promotes to fp32 by
    itself, so such a call runs untouched. Gradients flow through the
    casts."""

    def wrapped(*xs, **kwargs):
        low = None
        for x in xs:
            if _is_low(x):
                low = x.dtype if low is None \
                    else torch.promote_types(low, x.dtype)
        if low is None or not is_low_precision_dtype(low):
            return fn(*xs, **kwargs)
        out = fn(*[x.float() if _is_low(x) else x for x in xs], **kwargs)

        def back(o):
            if isinstance(o, torch.Tensor) and o.dtype == torch.float32:
                return o.to(low)
            return o

        if isinstance(out, (tuple, list)):
            return type(out)(back(o) for o in out)
        return back(out)

    return wrapped
