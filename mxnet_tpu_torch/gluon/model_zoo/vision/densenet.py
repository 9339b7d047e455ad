"""DenseNet 121/161/169/201 (reference:
``gluon/model_zoo/vision/densenet.py``).

PyTorch counterpart of ``mxnet_tpu/gluon/model_zoo/vision/densenet.py``
with its parameter names (``densenet0_stage1_conv0_weight`` ...).
"""

from __future__ import annotations

from ...block import HybridBlock
from ...nn import (
    Activation,
    AvgPool2D,
    BatchNorm,
    Conv2D,
    Dense,
    Dropout,
    GlobalAvgPool2D,
    HybridSequential,
    MaxPool2D,
)
from ....base import MXNetError
from ._common import refuse_pretrained


class _DenseLayer(HybridBlock):
    """BN-relu-1x1 conv to ``bn_size * growth_rate`` channels, BN-relu-3x3
    conv to ``growth_rate``, joined to the input on channels."""

    def __init__(self, growth_rate, bn_size, dropout, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.body = HybridSequential(prefix="")
            self.body.add(BatchNorm())
            self.body.add(Activation("relu"))
            self.body.add(Conv2D(bn_size * growth_rate, kernel_size=1,
                                 use_bias=False))
            self.body.add(BatchNorm())
            self.body.add(Activation("relu"))
            self.body.add(Conv2D(growth_rate, kernel_size=3, padding=1,
                                 use_bias=False))
            if dropout:
                self.body.add(Dropout(dropout))

    def hybrid_forward(self, F, x):
        return F.concat(x, self.body(x), dim=1)


def _make_dense_block(num_layers, bn_size, growth_rate, dropout, stage_index):
    out = HybridSequential(prefix=f"stage{stage_index}_")
    with out.name_scope():
        for _ in range(num_layers):
            out.add(_DenseLayer(growth_rate, bn_size, dropout))
    return out


def _make_transition(num_output_features):
    out = HybridSequential(prefix="")
    out.add(BatchNorm())
    out.add(Activation("relu"))
    out.add(Conv2D(num_output_features, kernel_size=1, use_bias=False))
    out.add(AvgPool2D(pool_size=2, strides=2))
    return out


class DenseNet(HybridBlock):
    """Huang et al. 2017 (DenseNet-BC): dense blocks joined by transitions
    that halve the channels and the resolution."""

    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            self.features.add(Conv2D(num_init_features, kernel_size=7,
                                     strides=2, padding=3, use_bias=False))
            self.features.add(BatchNorm())
            self.features.add(Activation("relu"))
            self.features.add(MaxPool2D(pool_size=3, strides=2, padding=1))
            num_features = num_init_features
            for i, num_layers in enumerate(block_config):
                self.features.add(_make_dense_block(
                    num_layers, bn_size, growth_rate, dropout, i + 1))
                num_features += num_layers * growth_rate
                if i != len(block_config) - 1:
                    num_features //= 2
                    self.features.add(_make_transition(num_features))
            self.features.add(BatchNorm())
            self.features.add(Activation("relu"))
            self.features.add(GlobalAvgPool2D())
            self.output = Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


# depth: (initial features, growth rate, layers per dense block)
densenet_spec = {
    121: (64, 32, [6, 12, 24, 16]),
    161: (96, 48, [6, 12, 36, 24]),
    169: (64, 32, [6, 12, 32, 32]),
    201: (64, 32, [6, 12, 48, 32]),
}


def get_densenet(num_layers, pretrained=False, **kwargs):
    if num_layers not in densenet_spec:
        raise MXNetError(f"invalid densenet depth {num_layers}")
    refuse_pretrained(pretrained)
    return DenseNet(*densenet_spec[num_layers], **kwargs)


def densenet121(**kwargs):
    return get_densenet(121, **kwargs)


def densenet161(**kwargs):
    return get_densenet(161, **kwargs)


def densenet169(**kwargs):
    return get_densenet(169, **kwargs)


def densenet201(**kwargs):
    return get_densenet(201, **kwargs)
