"""The generated ``mx.nd.*`` operator namespace.

PyTorch counterpart of ``mxnet_tpu/ndarray/op.py`` (reference:
``python/mxnet/ndarray/register.py``, op stubs generated at import time).
The namespace is made from :mod:`mxnet_tpu_torch.ops.registry` (the
operator modules, the image operators, flash attention, CTC, the fused matmul-stats operators
and the optimizer updates): each op takes NDArrays positionally, binds a
positional non-array argument to the op's parameter of that position
(``x.expand_dims(0)``), passes keywords through, and writes ``out=`` in
place. It is the ``F`` that ``HybridBlock.hybrid_forward`` receives. The
special wrappers below (Dropout's training gate, BatchNorm's
running-statistic write-back, ``reset_arrays``, ``onehot_encode``) are
written out.
"""

from __future__ import annotations

import inspect
import sys

import torch

from .. import autograd
from ..ops import ctc as _ctc  # noqa: F401  (these modules register
from ..ops import flash_attention as _fa  # noqa: F401  # their operators)
from ..ops import fused_conv_bn as _fcbn  # noqa: F401
from ..ops import image_ops as _image_ops  # noqa: F401
from ..ops import math as _math  # noqa: F401
from ..ops import nn as _nn
from ..ops import optimizer_ops as _optimizer_ops  # noqa: F401
from ..ops import registry as _registry
from ..ops import shape_ops as _shape  # noqa: F401
from ..ops.dispatch import apply_op as _apply
from .ndarray import NDArray, apply

_THIS = sys.modules[__name__]


def _param_names(opdef):
    """Positional parameter names of the op (None for ``*args`` ops)."""
    try:
        sig = inspect.signature(opdef.fn)
    except (TypeError, ValueError):
        return None
    names = []
    for p in sig.parameters.values():
        if p.kind == p.VAR_POSITIONAL:
            return None  # concat/stack: every positional is an array
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
            names.append(p.name)
    return names


def _hashable(v):
    if isinstance(v, list):
        return tuple(_hashable(x) for x in v)
    return v


_ARRAYS = (NDArray, torch.Tensor, type(None))


def _make_op(opdef):
    pnames = _param_names(opdef)
    npos = len(pnames) if pnames is not None else 0

    def fn(*args, out=None, name=None, **kwargs):
        arrays = args
        for i, a in enumerate(args):
            if i < npos and not isinstance(a, _ARRAYS):
                # a positional attribute (x.expand_dims(0)): bound by name
                arrays = [b for b in args[:i]]
                for j in range(i, len(args)):
                    b = args[j]
                    if j < npos and not isinstance(b, _ARRAYS):
                        kwargs[pnames[j]] = b
                    else:
                        arrays.append(b)
                break
        for k, v in kwargs.items():
            if type(v) is list:
                kwargs[k] = _hashable(v)
        return _apply(opdef, arrays, kwargs, out=out)

    fn.__name__ = opdef.name
    fn.__qualname__ = opdef.name
    fn.__doc__ = opdef.fn.__doc__
    return fn


for _name, _opdef in list(_registry.all_ops().items()):
    if not hasattr(_THIS, _name):
        setattr(_THIS, _name, _make_op(_opdef))


# ---- special wrappers -----------------------------------------------------


def Dropout(data, p=0.5, mode="training", axes=(), cudnn_off=False,
            out=None, **kw):
    """Dropout in training mode (``autograd.record()`` or
    ``train_mode()``), or always with ``mode="always"``; the identity
    otherwise. The mask comes from the device's ``mx.random`` stream."""
    if p <= 0.0 or (mode != "always" and not autograd.is_training()):
        return _apply(_registry.get("identity"), (data,), {}, out=out)
    return _apply(_registry.get("Dropout"), (data,),
                  {"p": p, "axes": tuple(axes)}, out=out)


dropout = Dropout


def _with_stats(opname, data, gamma, beta, moving_mean, moving_var, eps,
                momentum, fix_gamma, use_global_stats, output_mean_var, axis,
                out):
    training = autograd.is_training() and not use_global_stats
    res = _apply(_registry.get(opname),
                 (data, gamma, beta, moving_mean, moving_var),
                 dict(eps=eps, momentum=momentum, fix_gamma=fix_gamma,
                      use_global_stats=use_global_stats,
                      output_mean_var=output_mean_var, axis=axis,
                      training=training), out=out)
    if training:
        out_, new_mean, new_var = res
        # written back in place, as MXNet mutates its auxiliary states
        moving_mean._set_data(new_mean)
        moving_var._set_data(new_var)
        return out_
    return res


def BatchNorm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
              momentum=0.9, fix_gamma=True, use_global_stats=False,
              output_mean_var=False, axis=1, cudnn_off=False, out=None,
              **kw):
    """Batch normalisation (``ops.nn.batch_norm``). In training mode
    (``autograd.record()`` or ``train_mode()``, and not
    ``use_global_stats``) the running statistics ``moving_mean`` and
    ``moving_var`` are written back in place, as MXNet mutates its
    auxiliary states."""
    return _with_stats("BatchNorm", data, gamma, beta, moving_mean,
                       moving_var, eps, momentum, fix_gamma,
                       use_global_stats, output_mean_var, axis, out)


batch_norm = BatchNorm


def BatchNormWithReLU(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                      momentum=0.9, fix_gamma=True, use_global_stats=False,
                      output_mean_var=False, axis=1, cudnn_off=False,
                      out=None, **kw):
    """BatchNorm then relu, with BatchNorm's training gate and running
    statistic write-back."""
    return _with_stats("BatchNormWithReLU", data, gamma, beta, moving_mean,
                       moving_var, eps, momentum, fix_gamma,
                       use_global_stats, output_mean_var, axis, out)


def reset_arrays(*arrays, num_arrays=None, **kw):
    """Zero a list of arrays in place (reference: ``contrib/
    reset_arrays.cc``, an op kept for its side effect of clearing
    gradient buffers)."""
    n = num_arrays if num_arrays is not None else len(arrays)
    for a in arrays[:n]:
        if isinstance(a, NDArray):
            a._set_data(0.0)


def onehot_encode(indices, out):
    """Legacy one-hot into ``out`` (reference: ``ndarray_function.cc``
    ``_onehot_encode``): writes ``out[i, indices[i]] = 1`` (0 elsewhere)
    and returns it."""
    k = out.shape[1]
    res = apply(lambda i: (i.long().unsqueeze(-1) == torch.arange(
        k, device=i.device)).to(out.data.dtype), indices)
    out._set_data(res)
    return out


_onehot_encode = onehot_encode


def RNN(*args, **kwargs):
    """The fused RNN operator comes with ``gluon.rnn`` (ROADMAP A13)."""
    return _nn.rnn(*args, **kwargs)


# creation functions are part of the op namespace too (F.zeros, ...)
from .ndarray import (  # noqa: E402,F401
    arange, array, concatenate, eye, full, linspace, ones, zeros,
)

__all__ = sorted(n for n in dir(_THIS) if not n.startswith("_")
                 and n not in ("annotations", "autograd", "inspect", "sys",
                               "torch", "apply", "NDArray"))
