"""VGG 11/13/16/19 with and without BatchNorm (reference:
``gluon/model_zoo/vision/vgg.py``).

PyTorch counterpart of ``mxnet_tpu/gluon/model_zoo/vision/vgg.py`` with
its parameter names and initializers (Xavier convolutions, Normal(0.01)
dense layers, zero biases).
"""

from __future__ import annotations

from ...block import HybridBlock
from ...nn import (
    Activation,
    BatchNorm,
    Conv2D,
    Dense,
    Dropout,
    HybridSequential,
    MaxPool2D,
)
from ....base import MXNetError
from ._common import refuse_pretrained


class VGG(HybridBlock):
    """Simonyan and Zisserman 2014: ``layers[i]`` 3x3 convolutions of
    ``filters[i]`` channels per stage, each stage closed by a 2x2 max
    pool, then two dense layers of 4096 and the classifier."""

    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 **kwargs):
        super().__init__(**kwargs)
        assert len(layers) == len(filters)
        with self.name_scope():
            self.features = self._make_features(layers, filters, batch_norm)
            for _ in range(2):
                self.features.add(Dense(4096, activation="relu",
                                        weight_initializer="normal",
                                        bias_initializer="zeros"))
                self.features.add(Dropout(rate=0.5))
            self.output = Dense(classes, weight_initializer="normal",
                                bias_initializer="zeros")

    @staticmethod
    def _make_features(layers, filters, batch_norm):
        featurizer = HybridSequential(prefix="")
        for num, channels in zip(layers, filters):
            for _ in range(num):
                featurizer.add(Conv2D(channels, kernel_size=3, padding=1,
                                      weight_initializer="xavier",
                                      bias_initializer="zeros"))
                if batch_norm:
                    featurizer.add(BatchNorm())
                featurizer.add(Activation("relu"))
            featurizer.add(MaxPool2D(strides=2))
        return featurizer

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


vgg_spec = {
    11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
    13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
    16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
    19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512]),
}


def get_vgg(num_layers, pretrained=False, **kwargs):
    if num_layers not in vgg_spec:
        raise MXNetError(f"invalid vgg depth {num_layers}")
    refuse_pretrained(pretrained)
    layers, filters = vgg_spec[num_layers]
    return VGG(layers, filters, **kwargs)


def vgg11(**kwargs):
    return get_vgg(11, **kwargs)


def vgg13(**kwargs):
    return get_vgg(13, **kwargs)


def vgg16(**kwargs):
    return get_vgg(16, **kwargs)


def vgg19(**kwargs):
    return get_vgg(19, **kwargs)


def vgg11_bn(**kwargs):
    return get_vgg(11, batch_norm=True, **kwargs)


def vgg13_bn(**kwargs):
    return get_vgg(13, batch_norm=True, **kwargs)


def vgg16_bn(**kwargs):
    return get_vgg(16, batch_norm=True, **kwargs)


def vgg19_bn(**kwargs):
    return get_vgg(19, batch_norm=True, **kwargs)
