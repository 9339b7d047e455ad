"""Neural-network operators on tensors (what BERT and ResNet training
call).

PyTorch counterpart of the matching part of ``mxnet_tpu/ops/nn.py`` and
``ops/shape_ops.py`` (``Embedding``). The ``nd`` namespace wraps these for
NDArrays; ``hybrid_forward`` receives that namespace as ``F``. Dense
products go to ``torch.nn.functional.linear`` and convolutions to
``torch.nn.functional.conv{1,2,3}d``, as the JAX package leaves them to
XLA.
"""

from __future__ import annotations

import math

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


def convolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                pad=(), num_filter=0, num_group=1, no_bias=False, layout=None,
                workspace=0, cudnn_tune=None, cudnn_off=False):
    """N-d convolution, weights ``(O, I / groups, *kernel)`` in every
    layout. A channels-last ``layout`` (``NWC``, ``NHWC``, ``NDHWC``) keeps
    the activations channels-last: the input is viewed as channels-first
    with channels-last strides, which cuDNN reads as it lies."""
    del num_filter, workspace, cudnn_tune, cudnn_off
    nd = len(kernel)
    conv = {1: tF.conv1d, 2: tF.conv2d, 3: tF.conv3d}[nd]
    channels_last = bool(layout) and layout.endswith("C")
    x = data.movedim(-1, 1) if channels_last else data
    y = conv(x, weight, None if no_bias else bias,
             tuple(stride) or (1,) * nd, tuple(pad) or (0,) * nd,
             tuple(dilate) or (1,) * nd, num_group)
    return y.movedim(1, -1) if channels_last else y


def _window_sum(x, kernel, stride):
    """Sum over each pooling window (no padding: the caller pads)."""
    if len(kernel) == 1:
        return tF.avg_pool2d(x.unsqueeze(-2), (1, kernel[0]), (1, stride[0]),
                             divisor_override=1).squeeze(-2)
    pool = tF.avg_pool2d if len(kernel) == 2 else tF.avg_pool3d
    return pool(x, kernel, stride, divisor_override=1)


def pooling(data, kernel=(), pool_type="max", global_pool=False, stride=(),
            pad=(), pooling_convention="valid", count_include_pad=True,
            cudnn_off=False, p_value=2, layout=None):
    """max / avg / sum / lp pooling over the spatial axes. ``full``
    convention pads the right edge so the last partial window counts
    (ceil mode); ``count_include_pad=False`` divides an average by the
    window's elements inside the data. Padding never wins a max."""
    del cudnn_off
    nd = data.dim() - 2
    channels_last = bool(layout) and layout.endswith("C")
    x = data.movedim(-1, 1) if channels_last else data
    if global_pool:
        kernel, stride, pad = tuple(x.shape[2:]), (1,) * nd, (0,) * nd
    kernel = tuple(kernel)
    stride = tuple(stride) or (1,) * nd
    pad = tuple(pad) or (0,) * nd
    extra = [0] * nd
    if pooling_convention == "full":
        for i in range(nd):
            size = x.shape[2 + i] + 2 * pad[i]
            rem = (size - kernel[i]) % stride[i]
            extra[i] = (stride[i] - rem) % stride[i] if size > kernel[i] \
                else 0
    widths = []
    for i in reversed(range(nd)):  # F.pad takes the last axis first
        widths += [pad[i], pad[i] + extra[i]]
    if pool_type == "max":
        fill = -math.inf if x.is_floating_point() \
            else torch.iinfo(x.dtype).min
        pool = {1: tF.max_pool1d, 2: tF.max_pool2d, 3: tF.max_pool3d}[nd]
        out = pool(tF.pad(x, widths, value=fill), kernel, stride)
    elif pool_type in ("avg", "sum"):
        out = _window_sum(tF.pad(x, widths), kernel, stride)
        if pool_type == "avg":
            if count_include_pad:
                out = out / math.prod(kernel)
            else:
                ones = tF.pad(torch.ones_like(x), widths)
                out = out / _window_sum(ones, kernel, stride)
    elif pool_type == "lp":
        out = _window_sum(tF.pad(x.abs() ** p_value, widths), kernel,
                          stride) ** (1.0 / p_value)
    else:
        raise ValueError(f"unknown pool_type {pool_type}")
    return out.movedim(1, -1) if channels_last else out


def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, cudnn_off=False,
               training=False):
    """Batch normalisation over ``axis``. In training (and not
    ``use_global_stats``) the batch moments are one-pass fp32
    ``E[x^2] - E[x]^2`` floored at 0 and the result is ``(out, new_mean,
    new_var)``: the running statistics moved by ``momentum`` toward the
    batch's (biased variance), in their own storage type. Otherwise the
    running statistics normalise and only ``out`` returns (with the
    statistics used when ``output_mean_var``)."""
    del cudnn_off
    g = torch.ones_like(gamma) if fix_gamma else gamma
    axis = axis % data.dim()
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    train = training and not use_global_stats
    if train:
        red = [i for i in range(data.dim()) if i != axis]
        xf = data.to(torch.promote_types(data.dtype, torch.float32))
        mean = xf.mean(dim=red)
        var = torch.clamp((xf * xf).mean(dim=red) - mean * mean, min=0.0)
        new_mean = (momentum * moving_mean + (1 - momentum) * mean) \
            .to(moving_mean.dtype)
        new_var = (momentum * moving_var + (1 - momentum) * var) \
            .to(moving_var.dtype)
    else:
        mean, var = moving_mean, moving_var
    inv = torch.rsqrt(var + eps).to(data.dtype)
    out = (data - mean.reshape(shape).to(data.dtype)) * inv.reshape(shape) \
        * g.reshape(shape).to(data.dtype) + beta.reshape(shape).to(data.dtype)
    if train:
        return out, new_mean, new_var
    if output_mean_var:
        return out, mean, var
    return out
