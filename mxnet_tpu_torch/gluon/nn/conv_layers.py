"""Convolution and pooling Gluon layers.

PyTorch counterpart of the 2-D layers of
``mxnet_tpu/gluon/nn/conv_layers.py`` (reference:
``python/mxnet/gluon/nn/conv_layers.py``): ``Conv2D``, ``MaxPool2D``,
``AvgPool2D``, ``GlobalMaxPool2D``, ``GlobalAvgPool2D``, with the same
parameter names (``weight`` ``(channels, in_channels / groups, kh, kw)``,
``bias``). Activations are NCHW unless the ``optimize_for`` pass
(``tpu_fusion.py``) switched a block to NHWC; weights keep their layout
either way.
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
                 bias_initializer="zeros", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._channels = channels
        self._in_channels = in_channels
        self._kwargs = {
            "kernel": kernel_size, "stride": strides, "dilate": dilation,
            "pad": padding, "num_filter": channels, "num_group": groups,
            "no_bias": not use_bias, "layout": layout,
        }
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(channels, in_channels // max(groups, 1))
                + tuple(kernel_size), init=weight_initializer,
                allow_deferred_init=True)
            self.bias = self.params.get(
                "bias", shape=(channels,), init=bias_initializer,
                allow_deferred_init=True) if use_bias else None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None

    def infer_shape(self, x):
        layout = self._kwargs.get("layout") or ""
        in_c = x.shape[-1] if layout.endswith("C") else x.shape[1]
        self._in_channels = in_c
        groups = self._kwargs["num_group"]
        self.weight.shape = (self._channels, in_c // groups) \
            + tuple(self._kwargs["kernel"])

    def hybrid_forward(self, F, x, weight, bias=None):
        if getattr(self, "_tpu_fused", False):
            out = self._fused_forward(F, x, weight, bias)
            if out is not None:
                return out
        if bias is None:
            out = F.Convolution(x, weight, **self._kwargs)
        else:
            out = F.Convolution(x, weight, bias, **self._kwargs)
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


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuple(kernel_size, 2), _tuple(strides, 2),
                         _tuple(padding, 2), _tuple(dilation, 2), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


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


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        del layout
        super().__init__(_tuple(pool_size, 2),
                         _tuple(strides, 2) if strides is not None else None,
                         _tuple(padding, 2), ceil_mode, False, "max",
                         **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        del layout
        super().__init__(_tuple(pool_size, 2),
                         _tuple(strides, 2) if strides is not None else None,
                         _tuple(padding, 2), ceil_mode, False, "avg",
                         count_include_pad=count_include_pad, **kwargs)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        del layout
        super().__init__((1, 1), (1, 1), (0, 0), True, True, "max", **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        del layout
        super().__init__((1, 1), (1, 1), (0, 0), True, True, "avg", **kwargs)
