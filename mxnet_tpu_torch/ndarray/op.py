"""The ``nd`` operator namespace: the tensor operators of ``ops/`` wrapped
for NDArrays. It is the ``F`` that ``HybridBlock.hybrid_forward``
receives, as the JAX package's ``ndarray/op.py`` is there. Only what the
slice's models call is here; the JAX package's 737-name registry is not
ported yet.
"""

from __future__ import annotations

from .. import autograd
from ..ops import flash_attention as _fa
from ..ops import math as _math
from ..ops import nn as _nn
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


__all__ = ["Activation", "Dropout", "Embedding", "FullyConnected",
           "LayerNorm", "LeakyReLU", "broadcast_mul", "cast",
           "expand_dims", "flash_attention", "identity", "log_softmax",
           "logsumexp", "mean", "pick", "reshape", "reshape_like",
           "slice_axis", "sum", "take", "transpose"]
