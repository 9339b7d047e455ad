"""AlexNet (reference: ``gluon/model_zoo/vision/alexnet.py``).

PyTorch counterpart of ``mxnet_tpu/gluon/model_zoo/vision/alexnet.py``
with its parameter names (``alexnet0_conv0_weight`` ...).
"""

from __future__ import annotations

from ...block import HybridBlock
from ...nn import Conv2D, Dense, Dropout, Flatten, HybridSequential, MaxPool2D
from ._common import refuse_pretrained


class AlexNet(HybridBlock):
    """Krizhevsky et al. 2012, one-tower form: five convolutions and three
    dense layers, 224 x 224 inputs."""

    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            with self.features.name_scope():
                for channels, kernel, stride, pad, pool in (
                        (64, 11, 4, 2, True), (192, 5, 1, 2, True),
                        (384, 3, 1, 1, False), (256, 3, 1, 1, False),
                        (256, 3, 1, 1, True)):
                    self.features.add(Conv2D(channels, kernel_size=kernel,
                                             strides=stride, padding=pad,
                                             activation="relu"))
                    if pool:
                        self.features.add(MaxPool2D(pool_size=3, strides=2))
                self.features.add(Flatten())
                for _ in range(2):
                    self.features.add(Dense(4096, activation="relu"))
                    self.features.add(Dropout(0.5))
            self.output = Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def alexnet(pretrained=False, **kwargs):
    refuse_pretrained(pretrained)
    return AlexNet(**kwargs)
