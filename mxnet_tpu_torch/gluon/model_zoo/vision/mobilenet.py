"""MobileNet v1 and v2 (reference: ``gluon/model_zoo/vision/mobilenet.py``).

PyTorch counterpart of ``mxnet_tpu/gluon/model_zoo/vision/mobilenet.py``
with its parameter names (v2's ``features_`` and ``output_`` prefixes and
its ``pred_`` classifier conv). The reference's quirk is kept: v2's last
conv has 1280 channels unless the multiplier is above 1.0.

Under ``optimize_for("tpu_fused_conv_bn")`` every 1x1 conv runs the fused
conv + BN-statistics kernel; in v2 a bottleneck without a shortcut hands
its projection BN's pending apply (relu off) to the next 1x1 conv's
prologue, while ``RELU6`` (a clip) materialises its input.
"""

from __future__ import annotations

from ...block import HybridBlock
from ...nn import (
    Activation,
    BatchNorm,
    Conv2D,
    Dense,
    Flatten,
    GlobalAvgPool2D,
    HybridSequential,
)
from ._common import refuse_pretrained


class RELU6(HybridBlock):
    """``min(max(x, 0), 6)``."""

    def hybrid_forward(self, F, x):
        return F.clip(x, a_min=0.0, a_max=6.0)


def _add_conv(out, channels=1, kernel=1, stride=1, pad=0, num_group=1,
              active=True, relu6=False):
    out.add(Conv2D(channels, kernel, stride, pad, groups=num_group,
                   use_bias=False))
    out.add(BatchNorm(scale=True))
    if active:
        out.add(RELU6() if relu6 else Activation("relu"))


def _add_conv_dw(out, dw_channels, channels, stride, relu6=False):
    """A depthwise 3x3 conv, then a pointwise 1x1 conv, each with BN and
    relu."""
    _add_conv(out, dw_channels, kernel=3, stride=stride, pad=1,
              num_group=dw_channels, relu6=relu6)
    _add_conv(out, channels, relu6=relu6)


class LinearBottleneck(HybridBlock):
    """Sandler et al. 2018's inverted residual: a 1x1 expansion by ``t``,
    a depthwise 3x3, a linear 1x1 projection, and the input added back
    when the shapes allow."""

    def __init__(self, in_channels, channels, t, stride, **kwargs):
        super().__init__(**kwargs)
        self.use_shortcut = stride == 1 and in_channels == channels
        with self.name_scope():
            self.out = HybridSequential()
            _add_conv(self.out, in_channels * t, relu6=True)
            _add_conv(self.out, in_channels * t, kernel=3, stride=stride,
                      pad=1, num_group=in_channels * t, relu6=True)
            _add_conv(self.out, channels, active=False, relu6=True)

    def hybrid_forward(self, F, x):
        out = self.out(x)
        if self.use_shortcut:
            out = out + x
        return out


class MobileNet(HybridBlock):
    """Howard et al. 2017: a 3x3 stem and 13 depthwise-separable
    convolutions, channels scaled by ``multiplier``."""

    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            with self.features.name_scope():
                _add_conv(self.features, int(32 * multiplier), kernel=3,
                          stride=2, pad=1)
                dw_channels = [int(x * multiplier) for x in
                               [32, 64] + [128] * 2 + [256] * 2 + [512] * 6
                               + [1024]]
                channels = [int(x * multiplier) for x in
                            [64] + [128] * 2 + [256] * 2 + [512] * 6
                            + [1024] * 2]
                strides = [1, 2, 1, 2, 1, 2] + [1] * 5 + [2, 1]
                for dwc, c, s in zip(dw_channels, channels, strides):
                    _add_conv_dw(self.features, dwc, c, s)
                self.features.add(GlobalAvgPool2D())
                self.features.add(Flatten())
            self.output = Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


class MobileNetV2(HybridBlock):
    """Sandler et al. 2018: a 3x3 stem, 17 linear bottlenecks, a 1x1 conv
    to ``last_channels`` and a 1x1 conv classifier."""

    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = HybridSequential(prefix="features_")
            with self.features.name_scope():
                _add_conv(self.features, int(32 * multiplier), kernel=3,
                          stride=2, pad=1, relu6=True)
                in_channels_group = [int(x * multiplier) for x in
                                     [32] + [16] + [24] * 2 + [32] * 3
                                     + [64] * 4 + [96] * 3 + [160] * 3]
                channels_group = [int(x * multiplier) for x in
                                  [16] + [24] * 2 + [32] * 3 + [64] * 4
                                  + [96] * 3 + [160] * 3 + [320]]
                ts = [1] + [6] * 16
                strides = [1, 2] + [1, 2] + [1] * 2 + [2] + [1] * 3 \
                    + [1] * 3 + [2] + [1] * 2 + [1]
                for in_c, c, t, s in zip(in_channels_group, channels_group,
                                         ts, strides):
                    self.features.add(LinearBottleneck(in_c, c, t, s))
                last_channels = int(1280 * multiplier) \
                    if multiplier > 1.0 else 1280
                _add_conv(self.features, last_channels, relu6=True)
                self.features.add(GlobalAvgPool2D())
            self.output = HybridSequential(prefix="output_")
            with self.output.name_scope():
                self.output.add(Conv2D(classes, 1, use_bias=False,
                                       prefix="pred_"))
                self.output.add(Flatten())

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_mobilenet(multiplier, pretrained=False, **kwargs):
    refuse_pretrained(pretrained)
    return MobileNet(multiplier, **kwargs)


def get_mobilenet_v2(multiplier, pretrained=False, **kwargs):
    refuse_pretrained(pretrained)
    return MobileNetV2(multiplier, **kwargs)


def mobilenet1_0(**kwargs):
    return get_mobilenet(1.0, **kwargs)


def mobilenet0_75(**kwargs):
    return get_mobilenet(0.75, **kwargs)


def mobilenet0_5(**kwargs):
    return get_mobilenet(0.5, **kwargs)


def mobilenet0_25(**kwargs):
    return get_mobilenet(0.25, **kwargs)


def mobilenet_v2_1_0(**kwargs):
    return get_mobilenet_v2(1.0, **kwargs)


def mobilenet_v2_0_75(**kwargs):
    return get_mobilenet_v2(0.75, **kwargs)


def mobilenet_v2_0_5(**kwargs):
    return get_mobilenet_v2(0.5, **kwargs)


def mobilenet_v2_0_25(**kwargs):
    return get_mobilenet_v2(0.25, **kwargs)
