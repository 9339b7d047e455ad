"""The conv+BN fusion pass (``HybridBlock.optimize_for`` backend
``"tpu_fused_conv_bn"``).

PyTorch counterpart of ``mxnet_tpu/gluon/nn/tpu_fusion.py``; the backend
keeps its name so scripts run unchanged. There is no graph IR to rewrite,
so fusion happens through cooperating blocks that hand each other lazily
applied tensors:

- ``optimize_for(net)`` walks the tree, switches every Conv2D and pooling
  block to NHWC activations (parameter layouts are untouched, so
  checkpoints stay interchangeable), marks every stride-1 1x1 convolution
  without a fused activation, and wraps the net in an adapter that keeps
  the NCHW interface.
- A marked conv emits a :class:`StatsArray`: its raw matmul output plus
  the per-channel sum and sum of squares taken in the kernel's epilogue
  (``ops/fused_conv_bn.py``), so the following BatchNorm never re-reads
  the tensor for its batch moments.
- That BatchNorm returns a :class:`PendingApply`: the raw tensor plus
  folded per-channel scale and shift. A following marked conv consumes it
  unmaterialised (normalise + relu run in the matmul's prologue); any
  other consumer materialises it at its first read, through recorded ops,
  so autograd sees ordinary operators.

Both lazy arrays are NDArrays whose tensor slot ``_t`` is a property that
computes the tensor at its first read. Every path to the tensor of an
NDArray goes through ``_t`` (``apply``'s unwrapping, ``.data``,
``asnumpy``), so no consumer can see a placeholder; ``shape``, ``dtype``
and ``context`` answer from the raw tensor without materialising.
"""

from __future__ import annotations

from ... import autograd
from ...base import MXNetError
from ...ndarray.ndarray import NDArray

# NDArray's own tensor slot, which the lazy arrays read and fill
_SLOT = NDArray.__dict__["_t"]


class _LazyArray(NDArray):
    """An NDArray whose tensor is made by ``_materialize()`` at the first
    read of ``_t``."""

    __slots__ = ("raw",)

    def __init__(self, raw: NDArray):
        super().__init__(None)
        self.raw = raw

    @property
    def _t(self):
        t = _SLOT.__get__(self)
        if t is None:
            t = self._materialize()
            _SLOT.__set__(self, t)
        return t

    @_t.setter
    def _t(self, value):
        _SLOT.__set__(self, value)

    def _pending(self) -> bool:
        return _SLOT.__get__(self) is None

    @property
    def shape(self):
        return self.raw.shape if self._pending() else tuple(self._t.shape)

    @property
    def dtype(self):
        return self.raw.dtype if self._pending() else super().dtype

    @property
    def context(self):
        return self.raw.context

    ctx = context

    def _materialize(self):
        raise NotImplementedError

    def _channel_shape(self):
        return (1,) * (len(self.raw.shape) - 1) + (self.raw.shape[-1],)


class StatsArray(_LazyArray):
    """A conv output that carries its own batch statistics.

    ``raw`` is the bias-free matmul output; ``bias`` (or None) is the
    conv's additive bias, kept UNAPPLIED because a following batch-stat
    BatchNorm cancels it exactly (it only shifts the recorded running
    mean). ``bn_stats = (ysum, yssq, count)`` are the kernel-epilogue sums
    of ``raw``. Mathematically this array is ``raw + bias``; other
    consumers materialise that at their first read."""

    __slots__ = ("bias", "bn_stats")

    def __init__(self, y: NDArray, ysum: NDArray, yssq: NDArray,
                 count: int, bias: NDArray = None):
        super().__init__(y)
        self.bias = bias
        self.bn_stats = (ysum, yssq, count)

    def _materialize(self):
        if self.bias is None:
            return self.raw._t
        out = self.raw + self.bias.astype(self.raw.dtype) \
            .reshape(self._channel_shape())
        return out._t


class PendingApply(_LazyArray):
    """A BatchNorm output in deferred form: the raw tensor and per-channel
    ``scale``/``shift`` (+ relu) not yet applied. Cooperating convs consume
    the raw form in their kernel prologue; every other consumer
    materialises it (the apply runs as recorded ops, so gradients flow)."""

    __slots__ = ("scale", "shift", "relu_flag")

    def __init__(self, raw: NDArray, scale: NDArray, shift: NDArray,
                 relu: bool):
        super().__init__(raw)
        self.scale = scale
        self.shift = shift
        self.relu_flag = relu

    def with_relu(self) -> "PendingApply":
        return PendingApply(self.raw, self.scale, self.shift, True)

    def _materialize(self):
        from ...ndarray import op as F

        bshape = self._channel_shape()
        out = self.raw * self.scale.astype(self.raw.dtype).reshape(bshape) \
            + self.shift.astype(self.raw.dtype).reshape(bshape)
        if self.relu_flag:
            out = F.relu(out)
        return out._t


def fused_batch_norm(x: StatsArray, gamma, beta, running_mean, running_var,
                     eps, momentum, fix_gamma, use_global_stats):
    """BatchNorm over a StatsArray: the batch moments come from the conv
    kernel's epilogue sums, with no pass over the tensor. Returns a
    PendingApply; in training the running statistics are written back in
    place (MXNet mutates its auxiliary states)."""
    from ...ndarray import op as F

    ysum, yssq, count = x.bn_stats
    training = autograd.is_training() and not use_global_stats
    if training:
        mean = ysum / float(count)  # of the bias-free raw output
        var = F.maximum(yssq / float(count) - mean * mean,
                        F.zeros_like(ysum))
        with autograd.pause():
            m = float(momentum)
            # the recorded running mean is of conv-out = raw + bias
            rm_new = mean if x.bias is None \
                else mean + x.bias.astype(mean.dtype)
            running_mean._set_data(
                (m * running_mean + (1.0 - m) * rm_new)
                .astype(running_mean.dtype))
            running_var._set_data(
                (m * running_var + (1.0 - m) * var)
                .astype(running_var.dtype))
    else:
        mean, var = running_mean, running_var
    acc = str(ysum.dtype)  # the promoted stat type (float32)
    inv = (var.astype(acc) + float(eps)) ** -0.5
    s = inv if fix_gamma else gamma.astype(acc) * inv
    # shift for the BIAS-FREE raw tensor: in training the conv bias
    # cancels against the batch mean; in eval it survives as (+bias)
    t = beta.astype(acc) - mean.astype(acc) * s
    if not training and x.bias is not None:
        t = t + x.bias.astype(acc) * s
    return PendingApply(x.raw, s, t, False)


# ---------------------------------------------------------------------------
# the optimize_for pass
# ---------------------------------------------------------------------------


def _agnostic_types():
    """Parameterised block types that are layout-agnostic (safe to leave
    as they are)."""
    from . import activations, basic_layers

    # Dense/Flatten are NOT here: they are layout-sensitive (implicit
    # flatten over NHWC vs NCHW feature order) and convert_block handles
    # them explicitly
    types = [basic_layers.Activation, basic_layers.Dropout]
    for name in ("LeakyReLU", "PReLU", "ELU", "SELU", "GELU", "Swish"):
        if hasattr(activations, name):
            types.append(getattr(activations, name))
    return tuple(types)


def convert_block(block) -> bool:
    """Switch one block's activation layout to NHWC / mark it for fusion.
    Returns True if handled."""
    from . import basic_layers, conv_layers

    if isinstance(block, conv_layers.Conv2D):
        block._kwargs["layout"] = "NHWC"
        k = block._kwargs
        block._tpu_fused = (
            tuple(k["kernel"]) == (1, 1) and tuple(k["stride"]) == (1, 1)
            and tuple(k["pad"]) == (0, 0) and tuple(k["dilate"]) == (1, 1)
            and k["num_group"] == 1 and block.act is None)
        return True
    if isinstance(block, basic_layers.BatchNorm):
        # 4-D inputs normalise the last axis; 2-D (post-Dense) BNs keep
        # their configured axis
        block._tpu_nhwc = True
        return True
    if isinstance(block, basic_layers.Dense):
        # a Dense fed a 4-D NHWC interior tensor (conv -> Dense without a
        # Flatten) must see NCHW feature order before its implicit
        # flatten, or its NCHW-trained weights silently mismatch
        block._tpu_nchw = True
        return True
    if isinstance(block, conv_layers._Pooling):
        block._kwargs["layout"] = "NHWC"
        return True
    if isinstance(block, basic_layers.Flatten):
        # flattening an NHWC interior tensor would permute features
        # against the NCHW parameter order; transpose back first (a no-op
        # for the common post-global-pool (b, 1, 1, c) case)
        block._tpu_nchw_flatten = True
        return True
    return False


class NCHWAdapter:
    """Callable facade keeping the external NCHW interface of a net whose
    interior was switched to NHWC. Forward transposes a 4-D input once;
    4-D outputs, including each 4-D element of tuple/list outputs
    (multi-feature-map nets), are transposed back."""

    def __init__(self, net):
        self._net = net

    @staticmethod
    def _back(out):
        from ...ndarray import op as F

        if isinstance(out, NDArray) and out.ndim == 4:
            return F.transpose(out, axes=(0, 3, 1, 2))
        return out

    def __call__(self, x):
        from ...ndarray import op as F

        if getattr(x, "ndim", 0) == 4:
            x = F.transpose(x, axes=(0, 2, 3, 1))
        out = self._net(x)
        if isinstance(out, (tuple, list)):
            mapped = [self._back(o) for o in out]
            if hasattr(out, "_fields"):  # namedtuple: positional fields
                return type(out)(*mapped)
            return type(out)(mapped)
        return self._back(out)

    def __getattr__(self, name):  # delegate (collect_params, ...)
        return getattr(self._net, name)


def optimize_for(net, backend="tpu_fused_conv_bn", strict=True):
    """Walk ``net`` converting conv/BN/pooling blocks to the NHWC fused
    pipeline; returns an adapter preserving the NCHW interface.

    ``strict=False`` skips unknown parameterised block types instead of
    raising (the reference backend falls back to the default graph the
    same way)."""
    if backend != "tpu_fused_conv_bn":
        raise MXNetError(f"unknown optimize_for backend '{backend}'")

    seen = set()

    def walk(b):
        if id(b) in seen:
            return
        seen.add(id(b))
        handled = convert_block(b)
        if not handled and strict and b._reg_params \
                and not isinstance(b, _agnostic_types()):
            # a block with its OWN parameters that the pass does not
            # understand is likely layout-sensitive: refuse rather than
            # silently compute the wrong thing
            raise MXNetError(
                "optimize_for(tpu_fused_conv_bn): unsupported "
                f"parameterised block {type(b).__name__}; pass "
                "strict=False to skip it (at your own risk)")
        for child in b._children.values():
            walk(child)

    walk(net)
    return NCHWAdapter(net)
