"""Imperative op dispatch.

PyTorch counterpart of ``mxnet_tpu/ops/dispatch.py``. One Python hop:
:func:`apply_op` runs a registered op through ``ndarray.apply`` (which
unwraps the NDArrays, records a ``torch.autograd`` graph only inside
``autograd.record()`` and wraps the results), writes the result(s) into
``out=`` when given (in place, as the JAX package's ``_wrap_result``
rebinds them), and with ``MXTPU_SYNC_EXEC=1`` waits for the device after
every op, so an error surfaces at the op that raised it (the reference's
NaiveEngine). While the AMP policy is on, an op of its fp32 list runs
through ``amp.policy.wrap_fp32`` (the reference's ``registry.jitted``
picks its cast-policy executable the same way). The per-op monitor tap and timing of the JAX package wait
for the observability layer (ROADMAP A12).
"""

from __future__ import annotations

from .. import engine
from ..amp.policy import _STATE as _AMP_STATE
from ..amp.policy import wrap_fp32
from ..ndarray.ndarray import apply
from .registry import OpDef, get


def _write_out(res, out):
    if isinstance(res, (tuple, list)):
        outs = out if isinstance(out, (tuple, list)) else [out]
        for o, r in zip(outs, res):
            o._set_data(r)
        return list(outs)
    out = out[0] if isinstance(out, (tuple, list)) else out
    out._set_data(res)
    return out


def apply_op(opdef: OpDef, args, kwargs, out=None):
    """Execute a registered op on NDArray/scalar args; returns NDArray(s)
    (``out`` when given)."""
    fn = opdef.fn
    if _AMP_STATE["target_dtype"] is not None \
            and opdef.name in _AMP_STATE["cast_ops"]:
        fn = wrap_fp32(fn)
    res = apply(fn, *args, **kwargs)
    if out is not None:
        res = _write_out(res, out)
    if engine.sync_exec_enabled():
        engine.wait(res)
    return res


def invoke(name, *args, **kwargs):
    """Invoke an op by registry name."""
    out = kwargs.pop("out", None)
    return apply_op(get(name), args, kwargs, out=out)
