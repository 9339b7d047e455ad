"""Neural-network operators on tensors (what BERT training calls).

PyTorch counterpart of the matching part of ``mxnet_tpu/ops/nn.py`` and
``ops/shape_ops.py`` (``Embedding``). The ``nd`` namespace wraps these for
NDArrays; ``hybrid_forward`` receives that namespace as ``F``. Dense
products go to ``torch.nn.functional.linear``, as the JAX package leaves
them to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as tF


def fully_connected(data, weight, bias=None, num_hidden=None, no_bias=False,
                    flatten=True):
    """``y = x W^T + b`` with MXNet's weight layout ``(units, in_units)``;
    ``flatten`` folds all but the first axis into the input features."""
    del num_hidden
    x = data.reshape(data.shape[0], -1) if flatten else data
    return tF.linear(x, weight, None if no_bias else bias)


def activation(data, act_type="relu"):
    if act_type == "relu":
        return torch.relu(data)
    if act_type == "sigmoid":
        return torch.sigmoid(data)
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        return tF.softplus(data)
    if act_type == "softsign":
        return data / (1 + data.abs())
    raise ValueError(f"unknown act_type {act_type}")


def leaky_relu(data, act_type="leaky", slope=0.25):
    """``gelu`` is the exact erf form (``approximate=False`` in the JAX
    package), not the tanh form of the serving decoder."""
    if act_type == "leaky":
        return torch.where(data >= 0, data, slope * data)
    if act_type == "gelu":
        return tF.gelu(data, approximate="none")
    raise ValueError(f"unknown act_type {act_type}")


def layer_norm(data, gamma, beta, axis=-1, eps=1e-5):
    """Normalise over ``axis`` with fp32 moments, E[x^2] - E[x]^2 floored
    at 0 (the JAX package's one-pass form), then scale and shift."""
    xf = data.float()
    mean = xf.mean(dim=axis, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=axis, keepdim=True) - mean * mean,
                      min=0.0)
    inv = torch.rsqrt(var + eps).to(data.dtype)
    out = (data - mean.to(data.dtype)) * inv
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    return out * gamma.reshape(shape) + beta.reshape(shape)


def embedding(data, weight, input_dim=None, output_dim=None,
              dtype="float32", sparse_grad=False):
    """Rows of ``weight`` at ``data`` (any integer or float type), clipped
    into range as in the JAX package."""
    del input_dim, output_dim, dtype, sparse_grad
    idx = torch.clamp(data.long(), 0, weight.shape[0] - 1)
    return tF.embedding(idx, weight)


def dropout(data, p=0.5, axes=()):
    """Zero each element (or each slice along ``axes``) with probability
    ``p`` and scale the rest by ``1 / (1 - p)``; the mask is drawn from
    the device's default ``torch.Generator`` (``torch.manual_seed``)."""
    if p <= 0.0:
        return data
    shape = list(data.shape)
    for a in axes:
        shape[a] = 1
    keep = 1.0 - p
    mask = torch.rand(shape, device=data.device) < keep
    return data * mask.to(data.dtype) / keep
