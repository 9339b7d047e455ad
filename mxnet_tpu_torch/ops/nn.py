"""Neural-network operators on tensors.

PyTorch counterpart of ``mxnet_tpu/ops/nn.py`` and of ``Embedding`` in
``ops/shape_ops.py`` (reference: ``src/operator/nn/``), registered under
the same names and aliases. The ``nd`` namespace wraps these for
NDArrays; ``hybrid_forward`` receives that namespace as ``F``. Dense
products go to ``torch.nn.functional.linear`` and convolutions to
``torch.nn.functional.conv{1,2,3}d``, as the JAX package leaves them to
XLA. Dropout draws from the device's ``mx.random`` stream
(``random.generator``). The fused ``RNN`` operator comes with
``gluon.rnn`` (ROADMAP A13).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as tF

from .. import random as _random
from ..autograd import recompute_grads
from ..base import MXNetError
from .math import clip
from ._sharded import replicate
from .registry import register


@register("FullyConnected", aliases=("fully_connected",))
def fully_connected(data, weight, bias=None, num_hidden=None, no_bias=False,
                    flatten=True):
    """``y = x W^T + b`` with MXNet's weight layout ``(units, in_units)``;
    ``flatten`` folds all but the first axis into the input features."""
    del num_hidden
    x = data.reshape(data.shape[0], -1) if flatten else data
    b = None if no_bias else bias
    y = _sharded_linear(x, weight, b)
    return y if y is not None else _reduced(tF.linear(x, weight, b))


def _sharded_linear(x, weight, bias):
    """``FullyConnected`` of a weight split over one mesh axis (DTensor),
    computed on the local blocks with Megatron's collectives: a weight
    split along its output features (column-parallel) takes the whole
    input and gives its block of the output features, whose input
    gradient is a partial sum; one split along its input features
    (row-parallel) takes its block of the input features and sums the
    partial products over the axis. None for any other layout, which
    DTensor's own rules compute."""
    if type(weight) is torch.Tensor:  # the plain path, at no import
        return None
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(weight, DTensor) or weight.device_mesh.ndim != 1:
        return None
    mesh, pw = weight.device_mesh, weight.placements[0]
    if not isinstance(pw, Shard):
        return None
    if bias is not None and not isinstance(bias, DTensor):
        bias = DTensor.from_local(bias, mesh, [Replicate()], run_check=False)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()], run_check=False)
    last = x.ndim - 1
    if pw.dim == 0:
        if bias is not None and bias.placements[0] != Shard(0):
            return None
        xl = replicate(x).to_local(grad_placements=[Partial()])
        yl = tF.linear(xl, weight.to_local(),
                       None if bias is None else bias.to_local())
        return DTensor.from_local(yl, mesh, [Shard(last)], run_check=False)
    xl = x.redistribute(mesh, [Shard(last)]).to_local()
    y = DTensor.from_local(tF.linear(xl, weight.to_local()), mesh,
                           [Partial()], run_check=False)
    y = y.redistribute(mesh, [Replicate()])
    return y if bias is None else y + bias


def _reduced(t):
    """A sharded product's partial sums (a row-parallel layer's, whose
    weight is split along its input features) summed over the ranks at
    once, as Megatron's row-parallel layer does: what follows takes a
    whole tensor. Sharded and plain results pass through."""
    if type(t) is torch.Tensor:
        return t
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not isinstance(t, DTensor) or \
            not any(isinstance(p, Partial) for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [
        Replicate() if isinstance(p, Partial) else p for p in t.placements])


@register("relu")
def relu(data):
    """``max(x, 0)``, with the JAX package's gradient at 0 (1/2): a clip
    whose only bound is 0. Ties are real: a bias-free conv over a pixel
    whose relu'd inputs are all zero outputs exactly 0."""
    return clip(data, 0, None)


@register("Activation", aliases=("activation",))
def activation(data, act_type="relu"):
    if act_type == "relu":
        return relu(data)
    if act_type == "sigmoid":
        return torch.sigmoid(data)
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        return tF.softplus(data)
    if act_type == "softsign":
        return data / (1 + data.abs())
    raise ValueError(f"unknown act_type {act_type}")


# SELU's constants (Klambauer et al. 2017), as the JAX package writes them
_SELU_ALPHA, _SELU_SCALE = 1.6732632423543772, 1.0507009873554805


@register("LeakyReLU")
def leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334):
    """The ``LeakyReLU`` family. ``prelu`` takes its learned slopes from
    ``gamma``, one per channel (axis 1) of an input of more than two axes,
    else broadcast against the last axis; ``rrelu`` is its evaluation form
    (the mean of the slope's bounds). ``gelu`` is the exact erf form
    (``approximate=False`` in the JAX package), not the tanh form of the
    serving decoder."""
    if act_type == "leaky":
        return torch.where(data >= 0, data, slope * data)
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.dim() - 2)) \
            if gamma.dim() == 1 and data.dim() > 2 else gamma
        return torch.where(data >= 0, data, g * data)
    if act_type == "elu":
        return torch.where(data >= 0, data, slope * torch.expm1(data))
    if act_type == "selu":
        return _SELU_SCALE * torch.where(
            data >= 0, data, _SELU_ALPHA * torch.expm1(data))
    if act_type == "gelu":
        return tF.gelu(data, approximate="none")
    if act_type == "rrelu":
        return torch.where(data >= 0, data,
                           (lower_bound + upper_bound) / 2 * data)
    raise ValueError(f"unknown act_type {act_type}")


@register("LayerNorm", aliases=("layer_norm",))
def layer_norm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False):
    """Normalise over ``axis`` with fp32 moments, E[x^2] - E[x]^2 floored
    at 0 (the JAX package's one-pass form), then scale and shift; with
    ``output_mean_var`` also the moments (axis dropped, data's type)."""
    xf = data.float()
    mean = xf.mean(dim=axis, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=axis, keepdim=True) - mean * mean,
                      min=0.0)
    inv = torch.rsqrt(var + eps).to(data.dtype)
    out = (data - mean.to(data.dtype)) * inv
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    out = out * gamma.reshape(shape) + beta.reshape(shape)
    if output_mean_var:
        return (out, mean.to(data.dtype).squeeze(axis),
                var.to(data.dtype).squeeze(axis))
    return out


@register("Embedding", aliases=("embedding",))
def embedding(data, weight, input_dim=None, output_dim=None,
              dtype="float32", sparse_grad=False):
    """Rows of ``weight`` at ``data`` (any integer or float type), clipped
    into range as in the JAX package; the weight's gradient repeats bit
    for bit (``_Embedding``)."""
    del input_dim, output_dim, dtype, sparse_grad
    idx = torch.clamp(data.long(), 0, weight.shape[0] - 1)
    local = _sharded_lookup(idx, weight)
    if local is not None:
        return local
    if weight.requires_grad:
        out = _Embedding.apply(idx, weight)
    else:
        out = tF.embedding(idx, weight)
    # a sharded table's lookup is made whole: the tensor-parallel layers
    # after it (norms, column-parallel products) take a replicated input
    return replicate(out)


def _sharded_lookup(idx, weight):
    """The lookup of a table split along its features (or replicated)
    over one mesh axis, on the local block (``_Embedding``'s repeatable
    gradient), made whole (``_sharded.replicate``). None for any other
    layout."""
    if type(weight) is torch.Tensor:
        return None
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(weight, DTensor) or weight.device_mesh.ndim != 1:
        return None
    mesh, pw = weight.device_mesh, weight.placements[0]
    if not (isinstance(pw, Replicate) or pw == Shard(1)):
        return None
    if isinstance(idx, DTensor):
        idx = idx.redistribute(mesh, [Replicate()]).to_local()
    wl = weight.to_local()
    out = _Embedding.apply(idx, wl) if wl.requires_grad \
        else tF.embedding(idx, wl)
    return replicate(DTensor.from_local(out, mesh, [
        Shard(out.ndim - 1) if pw == Shard(1) else Replicate()],
        run_check=False))


class _Embedding(torch.autograd.Function):
    """``F.embedding`` whose weight gradient repeats bit for bit. Its CUDA
    backward sums a row's repeats in an order that changes from run to run
    when a small table is hit thousands of times (BERT's two token types
    over a batch of 64 x 128) unless torch's deterministic algorithms are
    on; they are, for this backward only, and warn-only, so that no other
    thread's operator can raise meanwhile (its cost: PERF.md, PR 15)."""

    @staticmethod
    def forward(ctx, idx, weight):
        ctx.save_for_backward(idx)
        ctx.rows = weight.shape[0]
        return tF.embedding(idx, weight)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        if torch.is_grad_enabled():  # create_graph: linear in g
            w = torch.zeros((ctx.rows, g.shape[-1]), dtype=g.dtype,
                            device=g.device, requires_grad=True)
            return (None, *recompute_grads(
                lambda w: tF.embedding(idx, w), (w,), (g,)))
        was = torch.are_deterministic_algorithms_enabled()
        warn = torch.is_deterministic_algorithms_warn_only_enabled()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            gw = torch.ops.aten.embedding_dense_backward(
                g, idx, ctx.rows, -1, False)
        finally:
            torch.use_deterministic_algorithms(was, warn_only=warn)
        return None, gw


@register("Dropout", aliases=("dropout",))
def dropout(data, p=0.5, mode="training", axes=(), cudnn_off=False):
    """Zero each element (or each slice along ``axes``) with probability
    ``p`` and scale the rest by ``1 / (1 - p)``; the mask is drawn from
    the device's ``mx.random`` stream (``random.generator``), so
    ``mx.random.seed`` repeats it. Training-mode gating is the ``nd``
    wrapper's."""
    del mode, cudnn_off
    if p <= 0.0:
        return data
    shape = list(data.shape)
    for a in axes:
        shape[a] = 1
    keep = 1.0 - p
    mask = torch.rand(shape, device=data.device,
                      generator=_random.generator(data.device)) < keep
    return data * mask.to(data.dtype) / keep


@register("Convolution", aliases=("convolution", "Convolution_v1"))
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


@register("Deconvolution", aliases=("deconvolution",))
def deconvolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                  pad=(), adj=(), target_shape=(), num_filter=0, num_group=1,
                  no_bias=True, layout=None, workspace=0, cudnn_tune=None,
                  cudnn_off=False):
    """N-d transposed convolution (the gradient of a convolution with
    respect to its input), weights ``(in, out / groups, *kernel)``. The
    output along each spatial axis is ``(n - 1) * stride + (kernel - 1) *
    dilate + 1 - 2 * pad + adj``; ``target_shape`` is accepted and
    ignored, as in the JAX package."""
    del target_shape, num_filter, layout, workspace, cudnn_tune, cudnn_off
    nd = len(kernel)
    deconv = {1: tF.conv_transpose1d, 2: tF.conv_transpose2d,
              3: tF.conv_transpose3d}[nd]
    return deconv(data, weight, None if no_bias else bias,
                  tuple(stride) or (1,) * nd, tuple(pad) or (0,) * nd,
                  tuple(adj) or (0,) * nd, num_group,
                  tuple(dilate) or (1,) * nd)


def _window_sum(x, kernel, stride):
    """Sum over each pooling window (no padding: the caller pads)."""
    if len(kernel) == 1:
        return tF.avg_pool2d(x.unsqueeze(-2), (1, kernel[0]), (1, stride[0]),
                             divisor_override=1).squeeze(-2)
    pool = tF.avg_pool2d if len(kernel) == 2 else tF.avg_pool3d
    return pool(x, kernel, stride, divisor_override=1)


@register("Pooling", aliases=("pooling", "Pooling_v1"))
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


@register("BatchNorm", aliases=("batch_norm", "BatchNorm_v1"))
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


def _f32_moments(data, axes):
    """One-pass mean and variance over ``axes`` (kept), accumulated in
    fp32 or wider: ``E[x^2] - E[x]^2`` floored at 0, the JAX package's
    form."""
    xf = data.to(torch.promote_types(data.dtype, torch.float32))
    mean = xf.mean(dim=axes, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=axes, keepdim=True) - mean * mean,
                      min=0.0)
    return mean, var


@register("InstanceNorm")
def instance_norm(data, gamma, beta, eps=1e-3):
    """Normalise each sample's channel (axis 1) over the spatial axes,
    then scale and shift per channel."""
    mean, var = _f32_moments(data, tuple(range(2, data.dim())))
    out = (data - mean.to(data.dtype)) \
        * torch.rsqrt(var + eps).to(data.dtype)
    shape = (1, -1) + (1,) * (data.dim() - 2)
    return out * gamma.reshape(shape) + beta.reshape(shape)


@register("GroupNorm")
def group_norm(data, gamma, beta, num_groups=1, eps=1e-5):
    """Normalise each sample over groups of ``C / num_groups`` channels
    (axis 1) and the spatial axes, then scale and shift per channel."""
    n, c = data.shape[0], data.shape[1]
    x = data.reshape((n, num_groups, c // num_groups) + tuple(data.shape[2:]))
    mean, var = _f32_moments(x, tuple(range(2, x.dim())))
    x = (x - mean.to(x.dtype)) * torch.rsqrt(var + eps).to(x.dtype)
    shape = (1, -1) + (1,) * (data.dim() - 2)
    return x.reshape(data.shape) * gamma.reshape(shape) + beta.reshape(shape)


@register("BatchNormWithReLU", aliases=("_contrib_BatchNormWithReLU",))
def batch_norm_with_relu(data, gamma, beta, moving_mean, moving_var,
                         eps=1e-3, momentum=0.9, fix_gamma=True,
                         use_global_stats=False, output_mean_var=False,
                         axis=1, cudnn_off=False, training=False):
    """BatchNorm then relu, with BatchNorm's contract: in training the
    result is ``(out, new_mean, new_var)`` for the ``nd`` wrapper to
    write back."""
    res = batch_norm(data, gamma, beta, moving_mean, moving_var, eps=eps,
                     momentum=momentum, fix_gamma=fix_gamma,
                     use_global_stats=use_global_stats,
                     output_mean_var=output_mean_var, axis=axis,
                     training=training)
    if isinstance(res, tuple):
        return (relu(res[0]),) + res[1:]
    return relu(res)


def _length_mask(x, length, axis):
    steps = torch.arange(x.shape[axis], device=x.device)
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    return steps.reshape(shape) < length.unsqueeze(axis)


@register("softmax", aliases=("Softmax", "SoftmaxActivation"))
def softmax(data, axis=-1, temperature=None, length=None, use_length=False,
            dtype=None):
    """Softmax over ``axis`` of ``data / temperature``; with
    ``use_length`` only the first ``length`` positions of each row take
    part, and the rest are 0."""
    del dtype
    x = data / temperature if temperature not in (None, 1.0) else data
    if use_length and length is not None:
        mask = _length_mask(x, length, axis)
        x = torch.where(mask, x, torch.full((), -math.inf, dtype=x.dtype,
                                            device=x.device))
        out = torch.softmax(x, dim=axis)
        return torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                                  device=out.device))
    return torch.softmax(x, dim=axis)


@register("log_softmax")
def log_softmax(data, axis=-1, temperature=None, dtype=None):
    del dtype
    x = data / temperature if temperature not in (None, 1.0) else data
    return torch.log_softmax(x, dim=axis)


@register("softmin")
def softmin(data, axis=-1, temperature=None, dtype=None):
    return softmax(-data, axis=axis, temperature=temperature)


def _one_hot(label, depth, dtype):
    idx = label.long()
    return (idx.unsqueeze(-1) == torch.arange(depth, device=idx.device)) \
        .to(dtype)


@register("softmax_cross_entropy")
def softmax_cross_entropy(data, label):
    """The summed cross-entropy of softmax(data) (last axis) against
    integer ``label``s: one scalar."""
    lsm = torch.log_softmax(data, dim=-1)
    return -(lsm * _one_hot(label, data.shape[-1], data.dtype)).sum()


class _SoftmaxOutput(torch.autograd.Function):
    """Forward: softmax over the last axis. Backward: the cross-entropy
    gradient ``softmax - one_hot(label)``, scaled by ``grad_scale``, with
    ``ignore_label`` rows zeroed (``use_ignore``) and ``normalization``
    "batch" (over the batch) or "valid" (over the rows kept); the head
    gradient is ignored, the legacy MXNet rule (reference:
    ``softmax_output-inl.h``; the JAX package's ``_so_bwd``)."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, use_ignore,
                norm):
        ctx.save_for_backward(data, label)
        ctx.args = (grad_scale, ignore_label, use_ignore, norm)
        return torch.softmax(data, dim=-1)

    @staticmethod
    def backward(ctx, g):
        del g  # the legacy rule ignores the head gradient
        data, label = ctx.saved_tensors
        p = torch.softmax(data, dim=-1)  # differentiable under create_graph
        grad_scale, ignore_label, use_ignore, norm = ctx.args
        grad = p - _one_hot(label, p.shape[-1], p.dtype)
        if use_ignore:
            keep = (label != ignore_label).to(p.dtype)
            grad = grad * keep.unsqueeze(-1)
        if norm == "batch":
            grad = grad / p.shape[0]
        elif norm == "valid" and use_ignore:
            keep = (label != ignore_label).to(p.dtype)
            grad = grad / torch.clamp(keep.sum(), min=1.0)
        return grad * grad_scale, None, None, None, None, None


@register("SoftmaxOutput", aliases=("softmax_output",))
def softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                   multi_output=False, use_ignore=False, preserve_shape=False,
                   normalization="null", out_grad=False, smooth_alpha=0.0):
    """Legacy Module-era loss layer: forward = softmax over the last axis;
    its backward injects the cross-entropy gradient (``_SoftmaxOutput``)."""
    del multi_output, preserve_shape, out_grad, smooth_alpha
    return _SoftmaxOutput.apply(data, label, grad_scale, ignore_label,
                                use_ignore, normalization)


@register("L2Normalization")
def l2_normalization(data, eps=1e-10, mode="instance"):
    """``data`` over its L2 norm: per sample (``instance``), per position
    across channels (``channel``, axis 1) or per channel over the spatial
    axes (``spatial``)."""
    if mode == "instance":
        red = tuple(range(1, data.dim()))
    elif mode == "channel":
        red = (1,)
    else:
        red = tuple(range(2, data.dim()))
    n = torch.sqrt(torch.square(data).sum(dim=red, keepdim=True) + eps)
    return data / n


@register("LRN")
def lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Local response normalisation across ``nsize`` channels (axis 1)."""
    sq = torch.square(data)
    half = nsize // 2
    padded = tF.pad(sq, (0, 0, 0, 0, half, half))
    acc = sum(padded[:, i:i + data.shape[1]] for i in range(nsize))
    return data / torch.pow(knorm + alpha / nsize * acc, beta)


@register("identity_with_attr_like_rhs")
def identity_with_attr_like_rhs(lhs, rhs):
    return lhs


@register("RNN")
def rnn(*args, **kwargs):
    """The fused RNN operator comes with ``gluon.rnn`` (ROADMAP A13)."""
    raise MXNetError("the fused RNN operator is not in the port yet: it "
                     "comes with gluon.rnn (ROADMAP A13)")
