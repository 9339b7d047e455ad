"""Convolution and pooling Gluon layers.

PyTorch counterpart of ``mxnet_tpu/gluon/nn/conv_layers.py`` (reference:
``python/mxnet/gluon/nn/conv_layers.py``): the 1-, 2- and 3-D
convolutions and transposed convolutions, the max, average and global
pools, and ``ReflectionPad2D``, with the same parameter names
(``weight`` ``(channels, in_channels / groups, *kernel)``, a transposed
convolution's ``(in_channels, channels / groups, *kernel)``, ``bias``).
Activations are NCHW unless the ``optimize_for`` pass (``tpu_fusion.py``)
switched a block to NHWC; weights keep their layout either way.
"""

from __future__ import annotations

from ..block import HybridBlock
from .basic_layers import Activation
from .tpu_fusion import PendingApply, StatsArray


def _tuple(x, n):
    if isinstance(x, (list, tuple)):
        return tuple(x)
    return (x,) * n


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="Convolution", adj=None,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._channels = channels
        self._in_channels = in_channels
        self._kwargs = {
            "kernel": kernel_size, "stride": strides, "dilate": dilation,
            "pad": padding, "num_filter": channels, "num_group": groups,
            "no_bias": not use_bias, "layout": layout,
        }
        if adj is not None:
            self._kwargs["adj"] = adj
        self._op_name = op_name
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=self._weight_shape(in_channels),
                init=weight_initializer, allow_deferred_init=True)
            self.bias = self.params.get(
                "bias", shape=(channels,), init=bias_initializer,
                allow_deferred_init=True) if use_bias else None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None

    def _weight_shape(self, in_channels):
        groups = max(self._kwargs["num_group"], 1)
        kernel = tuple(self._kwargs["kernel"])
        if self._op_name == "Deconvolution":
            return (in_channels, self._channels // groups) + kernel
        return (self._channels, in_channels // groups) + kernel

    def infer_shape(self, x):
        layout = self._kwargs.get("layout") or ""
        in_c = x.shape[-1] if layout.endswith("C") else x.shape[1]
        self._in_channels = in_c
        self.weight.shape = self._weight_shape(in_c)

    def hybrid_forward(self, F, x, weight, bias=None):
        if getattr(self, "_tpu_fused", False):
            out = self._fused_forward(F, x, weight, bias)
            if out is not None:
                return out
        op = getattr(F, self._op_name)
        if bias is None:
            out = op(x, weight, **self._kwargs)
        else:
            out = op(x, weight, bias, **self._kwargs)
        return self.act(out) if self.act is not None else out

    def _fused_forward(self, F, x, weight, bias=None):
        """The fused 1x1-conv path (``optimize_for`` backend): an NHWC
        matmul with the BN-statistics epilogue (K4 on the card), taking a
        PendingApply input through the kernel's prologue. A conv bias stays
        unapplied on the StatsArray (a batch-stat BatchNorm cancels it).
        See gluon/nn/tpu_fusion.py."""
        if x.ndim != 4:
            return None
        b, h, wd, c = x.shape
        o = self._channels
        wt = F.transpose(weight.reshape((o, c)))
        if isinstance(x, PendingApply):
            raw2 = x.raw.reshape((b * h * wd, c))
            y2, ysum, yssq = F._contrib_fused_scaled_matmul_stats(
                raw2, x.scale, x.shift, wt, relu=x.relu_flag)
        else:
            y2, ysum, yssq = F._contrib_fused_matmul_stats(
                x.reshape((b * h * wd, c)), wt)
        y = y2.reshape((b, h, wd, o))
        return StatsArray(y, ysum, yssq, b * h * wd, bias=bias)

    def __repr__(self):
        return (f"{self.__class__.__name__}({self._in_channels} -> "
                f"{self._channels}, kernel_size={self._kwargs['kernel']}, "
                f"stride={self._kwargs['stride']})")


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuple(kernel_size, 1), _tuple(strides, 1),
                         _tuple(padding, 1), _tuple(dilation, 1), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuple(kernel_size, 2), _tuple(strides, 2),
                         _tuple(padding, 2), _tuple(dilation, 2), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _tuple(kernel_size, 3), _tuple(strides, 3),
                         _tuple(padding, 3), _tuple(dilation, 3), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class _ConvTranspose(_Conv):
    """A transposed convolution of ``nd`` spatial axes; ``output_padding``
    (the operator's ``adj``) adds to the far end of each output axis."""

    def __init__(self, nd, channels, kernel_size, strides, padding,
                 output_padding, dilation, groups, layout, activation,
                 use_bias, weight_initializer, bias_initializer, in_channels,
                 **kwargs):
        super().__init__(channels, _tuple(kernel_size, nd),
                         _tuple(strides, nd), _tuple(padding, nd),
                         _tuple(dilation, nd), groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, op_name="Deconvolution",
                         adj=_tuple(output_padding, nd), **kwargs)


class Conv1DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(1, channels, kernel_size, strides, padding,
                         output_padding, dilation, groups, layout,
                         activation, use_bias, weight_initializer,
                         bias_initializer, in_channels, **kwargs)


class Conv2DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(2, channels, kernel_size, strides, padding,
                         output_padding, dilation, groups, layout,
                         activation, use_bias, weight_initializer,
                         bias_initializer, in_channels, **kwargs)


class Conv3DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(3, channels, kernel_size, strides, padding,
                         output_padding, dilation, groups, layout,
                         activation, use_bias, weight_initializer,
                         bias_initializer, in_channels, **kwargs)


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, count_include_pad=None, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "global_pool": global_pool, "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid",
        }
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)

    def __repr__(self):
        return (f"{self.__class__.__name__}(size={self._kwargs['kernel']}, "
                f"stride={self._kwargs['stride']}, "
                f"padding={self._kwargs['pad']})")


def _pool(nd, pool_type, pool_size, strides, padding, ceil_mode,
          count_include_pad=None):
    """``_Pooling``'s arguments for an ``nd``-D window: ``strides`` None
    means the window's size."""
    return (_tuple(pool_size, nd),
            _tuple(strides, nd) if strides is not None else None,
            _tuple(padding, nd), ceil_mode, False, pool_type,
            count_include_pad)


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        del layout
        super().__init__(*_pool(1, "max", pool_size, strides, padding,
                                ceil_mode), **kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        del layout
        super().__init__(*_pool(2, "max", pool_size, strides, padding,
                                ceil_mode), **kwargs)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, **kwargs):
        del layout
        super().__init__(*_pool(3, "max", pool_size, strides, padding,
                                ceil_mode), **kwargs)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, **kwargs):
        del layout
        super().__init__(*_pool(1, "avg", pool_size, strides, padding,
                                ceil_mode, count_include_pad), **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        del layout
        super().__init__(*_pool(2, "avg", pool_size, strides, padding,
                                ceil_mode, count_include_pad), **kwargs)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        del layout
        super().__init__(*_pool(3, "avg", pool_size, strides, padding,
                                ceil_mode, count_include_pad), **kwargs)


class _GlobalPool(_Pooling):
    """A pool over every spatial axis of an ``nd``-D input."""

    def __init__(self, nd, pool_type, **kwargs):
        super().__init__((1,) * nd, (1,) * nd, (0,) * nd, True, True,
                         pool_type, **kwargs)


class GlobalMaxPool1D(_GlobalPool):
    def __init__(self, layout="NCW", **kwargs):
        del layout
        super().__init__(1, "max", **kwargs)


class GlobalMaxPool2D(_GlobalPool):
    def __init__(self, layout="NCHW", **kwargs):
        del layout
        super().__init__(2, "max", **kwargs)


class GlobalMaxPool3D(_GlobalPool):
    def __init__(self, layout="NCDHW", **kwargs):
        del layout
        super().__init__(3, "max", **kwargs)


class GlobalAvgPool1D(_GlobalPool):
    def __init__(self, layout="NCW", **kwargs):
        del layout
        super().__init__(1, "avg", **kwargs)


class GlobalAvgPool2D(_GlobalPool):
    def __init__(self, layout="NCHW", **kwargs):
        del layout
        super().__init__(2, "avg", **kwargs)


class GlobalAvgPool3D(_GlobalPool):
    def __init__(self, layout="NCDHW", **kwargs):
        del layout
        super().__init__(3, "avg", **kwargs)


class ReflectionPad2D(HybridBlock):
    """Mirror-pad the two spatial axes of an NCHW input; an int pads all
    four sides by that many."""

    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = tuple(padding)

    def hybrid_forward(self, F, x):
        return F.pad(x, mode="reflect", pad_width=self._padding)
