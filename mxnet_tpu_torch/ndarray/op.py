"""The ``nd`` operator namespace: the tensor operators of ``ops/`` wrapped
for NDArrays. It is the ``F`` that ``HybridBlock.hybrid_forward``
receives, as the JAX package's ``ndarray/op.py`` is there. Only what the
slices' models call is here; the JAX package's 737-name registry is not
ported yet.
"""

from __future__ import annotations

import torch

from .. import autograd
from ..ops import ctc as _ctc
from ..ops import flash_attention as _fa
from ..ops import fused_conv_bn as _fcbn
from ..ops import math as _math
from ..ops import nn as _nn
from ..ops import optimizer_ops as _optimizer_ops
from ..ops import shape_ops as _shape
from .ndarray import apply


def _wrapped(fn, name):
    def op(*args, **kwargs):
        return apply(fn, *args, **kwargs)

    op.__name__ = name
    op.__doc__ = fn.__doc__
    return op


FullyConnected = _wrapped(_nn.fully_connected, "FullyConnected")
Activation = _wrapped(_nn.activation, "Activation")
LeakyReLU = _wrapped(_nn.leaky_relu, "LeakyReLU")
LayerNorm = _wrapped(_nn.layer_norm, "LayerNorm")
Embedding = _wrapped(_nn.embedding, "Embedding")
reshape = _wrapped(_shape.reshape, "reshape")
transpose = _wrapped(_shape.transpose, "transpose")
expand_dims = _wrapped(_shape.expand_dims, "expand_dims")
slice_axis = _wrapped(_shape.slice_axis, "slice_axis")
take = _wrapped(_shape.take, "take")
pick = _wrapped(_shape.pick, "pick")
identity = _wrapped(_shape.identity, "identity")
sum = _wrapped(_math.sum, "sum")  # noqa: A001
mean = _wrapped(_math.mean, "mean")
logsumexp = _wrapped(_math.logsumexp, "logsumexp")
log_softmax = _wrapped(_math.log_softmax, "log_softmax")
cast = _wrapped(_math.cast, "cast")
flash_attention = _wrapped(_fa.flash_attention, "flash_attention")
Convolution = _wrapped(_nn.convolution, "Convolution")
Deconvolution = _wrapped(_nn.deconvolution, "Deconvolution")
InstanceNorm = _wrapped(_nn.instance_norm, "InstanceNorm")
GroupNorm = _wrapped(_nn.group_norm, "GroupNorm")
concat = _wrapped(_shape.concat, "concat")
Concat = concat
pad = _wrapped(_shape.pad, "pad")
Pad = pad
clip = _wrapped(_math.clip, "clip")
Pooling = _wrapped(_nn.pooling, "Pooling")
flatten = _wrapped(_shape.flatten, "flatten")
Flatten = flatten
norm = _wrapped(_math.norm, "norm")
where = _wrapped(_math.where, "where")
abs = _wrapped(torch.abs, "abs")  # noqa: A001
square = _wrapped(torch.square, "square")
log = _wrapped(torch.log, "log")
broadcast_maximum = _wrapped(torch.maximum, "broadcast_maximum")
ctc_loss = _wrapped(_ctc.ctc_loss, "ctc_loss")
relu = _wrapped(_nn.relu, "relu")
sigmoid = _wrapped(torch.sigmoid, "sigmoid")
maximum = _wrapped(torch.maximum, "maximum")
zeros_like = _wrapped(torch.zeros_like, "zeros_like")
_contrib_fused_matmul_stats = _wrapped(_fcbn.matmul_stats,
                                       "_contrib_fused_matmul_stats")
_contrib_fused_scaled_matmul_stats = _wrapped(
    _fcbn.scaled_matmul_stats, "_contrib_fused_scaled_matmul_stats")


def _update_op(fn, name):
    """An optimizer update operator: its result(s) written back into
    ``out`` (an NDArray or a list, zipped with the results) when given,
    as the JAX package's ``_wrap_result`` does."""
    def op(*args, out=None, **kwargs):
        res = apply(fn, *args, **kwargs)
        if out is None:
            return res
        if isinstance(res, (tuple, list)):
            outs = out if isinstance(out, (tuple, list)) else [out]
            for o, r in zip(outs, res):
                o._set_data(r)
            return list(outs)
        out = out[0] if isinstance(out, (tuple, list)) else out
        out._set_data(res)
        return out

    op.__name__ = name
    op.__doc__ = fn.__doc__
    return op


globals().update({name: _update_op(fn, name)
                  for name, fn in _optimizer_ops.OPS.items()})


def reshape_like(lhs, rhs):
    return apply(lambda a, b: a.reshape(b.shape), lhs, rhs)


def broadcast_mul(lhs, rhs):
    return lhs * rhs



def Dropout(data, p=0.5, axes=()):
    """Dropout in training mode (``autograd.record()`` or
    ``train_mode()``); the identity otherwise."""
    if p <= 0.0 or not autograd.is_training():
        return identity(data)
    return apply(_nn.dropout, data, p=p, axes=tuple(axes))


def BatchNorm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
              momentum=0.9, fix_gamma=True, use_global_stats=False,
              output_mean_var=False, axis=1, cudnn_off=False):
    """Batch normalisation (``ops.nn.batch_norm``). In training mode
    (``autograd.record()`` or ``train_mode()``, and not
    ``use_global_stats``) the running statistics ``moving_mean`` and
    ``moving_var`` are written back in place, as MXNet mutates its
    auxiliary states."""
    training = autograd.is_training() and not use_global_stats
    res = apply(_nn.batch_norm, data, gamma, beta, moving_mean, moving_var,
                eps=eps, momentum=momentum, fix_gamma=fix_gamma,
                use_global_stats=use_global_stats,
                output_mean_var=output_mean_var, axis=axis,
                cudnn_off=cudnn_off, training=training)
    if training:
        out, new_mean, new_var = res
        moving_mean._set_data(new_mean)
        moving_var._set_data(new_var)
        return out
    return res


__all__ = ["Activation", "BatchNorm", "Concat", "Convolution",
           "Deconvolution", "Dropout", "Embedding", "Flatten",
           "FullyConnected", "GroupNorm", "InstanceNorm", "LayerNorm",
           "LeakyReLU", "Pad", "Pooling", "abs", "broadcast_maximum",
           "broadcast_mul", "cast", "clip", "concat", "ctc_loss",
           "expand_dims",
           "flash_attention", "flatten", "identity", "log", "log_softmax",
           "logsumexp", "maximum", "mean", "norm", "pad", "pick", "relu",
           "reshape", "reshape_like", "sigmoid", "slice_axis", "square",
           "sum", "take", "transpose", "where", "zeros_like"] + sorted(
               n for n in _optimizer_ops.OPS if not n.startswith("_"))
