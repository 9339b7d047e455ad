"""SqueezeNet 1.0 and 1.1 (reference:
``gluon/model_zoo/vision/squeezenet.py``).

PyTorch counterpart of ``mxnet_tpu/gluon/model_zoo/vision/squeezenet.py``
with its parameter names. The head's ``AvgPool2D(13)`` fixes the input
at 224 x 224; the max pools are ceil-mode (the ``full`` convention).
"""

from __future__ import annotations

from ...block import HybridBlock
from ...nn import (
    Activation,
    AvgPool2D,
    Conv2D,
    Dropout,
    Flatten,
    HybridSequential,
    MaxPool2D,
)
from ....base import MXNetError
from ._common import refuse_pretrained


def _make_fire(squeeze_channels, expand1x1_channels, expand3x3_channels):
    """A Fire module: a 1x1 squeeze, then 1x1 and 3x3 expands side by
    side, joined on channels."""
    out = HybridSequential(prefix="")
    out.add(_make_fire_conv(squeeze_channels, 1))
    out.add(_FireExpand(expand1x1_channels, expand3x3_channels))
    return out


def _make_fire_conv(channels, kernel_size, padding=0):
    out = HybridSequential(prefix="")
    out.add(Conv2D(channels, kernel_size, padding=padding))
    out.add(Activation("relu"))
    return out


class _FireExpand(HybridBlock):
    def __init__(self, e1, e3, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.p1 = _make_fire_conv(e1, 1)
            self.p3 = _make_fire_conv(e3, 3, 1)

    def hybrid_forward(self, F, x):
        return F.concat(self.p1(x), self.p3(x), dim=1)


# (version: stem conv (channels, kernel), then the body: a Fire's
# (squeeze, expand 1x1, expand 3x3) or "pool" for a ceil-mode 3x3 max pool)
_SPEC = {
    "1.0": ((96, 7), ["pool", (16, 64, 64), (16, 64, 64), (32, 128, 128),
                      "pool", (32, 128, 128), (48, 192, 192),
                      (48, 192, 192), (64, 256, 256), "pool",
                      (64, 256, 256)]),
    "1.1": ((64, 3), ["pool", (16, 64, 64), (16, 64, 64), "pool",
                      (32, 128, 128), (32, 128, 128), "pool",
                      (48, 192, 192), (48, 192, 192), (64, 256, 256),
                      (64, 256, 256)]),
}


class SqueezeNet(HybridBlock):
    """Iandola et al. 2016; version 1.1 has a 3x3 stem and pools earlier
    (2.4x less computation, the same accuracy)."""

    def __init__(self, version, classes=1000, **kwargs):
        super().__init__(**kwargs)
        if version not in _SPEC:
            raise MXNetError("version must be 1.0 or 1.1")
        (stem, kernel), body = _SPEC[version]
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            self.features.add(Conv2D(stem, kernel_size=kernel, strides=2))
            self.features.add(Activation("relu"))
            for item in body:
                if item == "pool":
                    self.features.add(MaxPool2D(pool_size=3, strides=2,
                                                ceil_mode=True))
                else:
                    self.features.add(_make_fire(*item))
            self.features.add(Dropout(0.5))

            self.output = HybridSequential(prefix="")
            self.output.add(Conv2D(classes, kernel_size=1))
            self.output.add(Activation("relu"))
            self.output.add(AvgPool2D(13))
            self.output.add(Flatten())

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_squeezenet(version, pretrained=False, **kwargs):
    refuse_pretrained(pretrained)
    return SqueezeNet(version, **kwargs)


def squeezenet1_0(**kwargs):
    return get_squeezenet("1.0", **kwargs)


def squeezenet1_1(**kwargs):
    return get_squeezenet("1.1", **kwargs)
