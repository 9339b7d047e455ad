"""Inception V3 (reference: ``gluon/model_zoo/vision/inception.py``).

PyTorch counterpart of ``mxnet_tpu/gluon/model_zoo/vision/inception.py``
with its parameter names (``inception30_A1_conv0_weight`` ...). The
head's ``AvgPool2D(8)`` fixes the input at 299 x 299; the branches'
``AvgPool2D(3, 1, 1)`` counts the padding.
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
    HybridSequential,
    MaxPool2D,
)
from ._common import refuse_pretrained


def _make_basic_conv(**kwargs):
    out = HybridSequential(prefix="")
    out.add(Conv2D(use_bias=False, **kwargs))
    out.add(BatchNorm(epsilon=0.001))
    out.add(Activation("relu"))
    return out


def _make_branch(use_pool, *conv_settings):
    """An optional pool (``"avg"``: 3x3 stride 1 padded; ``"max"``: 3x3
    stride 2), then a basic conv per ``(channels, kernel_size, strides,
    padding)``, None meaning the default."""
    out = HybridSequential(prefix="")
    if use_pool == "avg":
        out.add(AvgPool2D(pool_size=3, strides=1, padding=1))
    elif use_pool == "max":
        out.add(MaxPool2D(pool_size=3, strides=2))
    for setting in conv_settings:
        kwargs = {k: v for k, v in zip(
            ("channels", "kernel_size", "strides", "padding"), setting)
            if v is not None}
        out.add(_make_basic_conv(**kwargs))
    return out


class _Concurrent(HybridBlock):
    """Parallel branches joined on ``axis`` (reference:
    ``gluon.contrib.nn.HybridConcurrent``)."""

    def __init__(self, axis=1, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis

    def add(self, block):
        self.register_child(block)

    def hybrid_forward(self, F, x):
        return F.concat(*[block(x) for block in self._children.values()],
                        dim=self._axis)


def _concurrent(prefix, *branches):
    """A ``_Concurrent`` of ``_make_branch(*b)`` for each of ``branches``,
    named under ``prefix``."""
    out = _Concurrent(prefix=prefix)
    with out.name_scope():
        for b in branches:
            out.add(_make_branch(*b))
    return out


def _make_A(pool_features, prefix):
    return _concurrent(
        prefix, (None, (64, 1, None, None)),
        (None, (48, 1, None, None), (64, 5, None, 2)),
        (None, (64, 1, None, None), (96, 3, None, 1), (96, 3, None, 1)),
        ("avg", (pool_features, 1, None, None)))


def _make_B(prefix):
    return _concurrent(
        prefix, (None, (384, 3, 2, None)),
        (None, (64, 1, None, None), (96, 3, None, 1), (96, 3, 2, None)),
        ("max",))


def _make_C(channels_7x7, prefix):
    c7 = channels_7x7
    return _concurrent(
        prefix, (None, (192, 1, None, None)),
        (None, (c7, 1, None, None), (c7, (1, 7), None, (0, 3)),
         (192, (7, 1), None, (3, 0))),
        (None, (c7, 1, None, None), (c7, (7, 1), None, (3, 0)),
         (c7, (1, 7), None, (0, 3)), (c7, (7, 1), None, (3, 0)),
         (192, (1, 7), None, (0, 3))),
        ("avg", (192, 1, None, None)))


def _make_D(prefix):
    return _concurrent(
        prefix, (None, (192, 1, None, None), (320, 3, 2, None)),
        (None, (192, 1, None, None), (192, (1, 7), None, (0, 3)),
         (192, (7, 1), None, (3, 0)), (192, 3, 2, None)),
        ("max",))


class _InceptionE(HybridBlock):
    """The 8 x 8 block: its second and third branches each split into a
    1x3 and a 3x1 conv, joined on channels."""

    def __init__(self, prefix=None, **kwargs):
        super().__init__(prefix=prefix, **kwargs)
        with self.name_scope():
            self.b1 = _make_branch(None, (320, 1, None, None))
            self.b2_stem = _make_basic_conv(channels=384, kernel_size=1)
            self.b2_a = _make_basic_conv(channels=384, kernel_size=(1, 3),
                                         padding=(0, 1))
            self.b2_b = _make_basic_conv(channels=384, kernel_size=(3, 1),
                                         padding=(1, 0))
            self.b3_stem = _make_branch(None, (448, 1, None, None),
                                        (384, 3, None, 1))
            self.b3_a = _make_basic_conv(channels=384, kernel_size=(1, 3),
                                         padding=(0, 1))
            self.b3_b = _make_basic_conv(channels=384, kernel_size=(3, 1),
                                         padding=(1, 0))
            self.b4 = _make_branch("avg", (192, 1, None, None))

    def hybrid_forward(self, F, x):
        b1 = self.b1(x)
        s2 = self.b2_stem(x)
        b2 = F.concat(self.b2_a(s2), self.b2_b(s2), dim=1)
        s3 = self.b3_stem(x)
        b3 = F.concat(self.b3_a(s3), self.b3_b(s3), dim=1)
        return F.concat(b1, b2, b3, self.b4(x), dim=1)


class Inception3(HybridBlock):
    """Szegedy et al. 2016 (Inception-v3), without the auxiliary head."""

    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            self.features.add(_make_basic_conv(channels=32, kernel_size=3,
                                               strides=2))
            self.features.add(_make_basic_conv(channels=32, kernel_size=3))
            self.features.add(_make_basic_conv(channels=64, kernel_size=3,
                                               padding=1))
            self.features.add(MaxPool2D(pool_size=3, strides=2))
            self.features.add(_make_basic_conv(channels=80, kernel_size=1))
            self.features.add(_make_basic_conv(channels=192, kernel_size=3))
            self.features.add(MaxPool2D(pool_size=3, strides=2))
            self.features.add(_make_A(32, "A1_"))
            self.features.add(_make_A(64, "A2_"))
            self.features.add(_make_A(64, "A3_"))
            self.features.add(_make_B("B_"))
            self.features.add(_make_C(128, "C1_"))
            self.features.add(_make_C(160, "C2_"))
            self.features.add(_make_C(160, "C3_"))
            self.features.add(_make_C(192, "C4_"))
            self.features.add(_make_D("D_"))
            self.features.add(_InceptionE("E1_"))
            self.features.add(_InceptionE("E2_"))
            self.features.add(AvgPool2D(pool_size=8))
            self.features.add(Dropout(0.5))
            self.output = Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def inception_v3(pretrained=False, **kwargs):
    refuse_pretrained(pretrained)
    return Inception3(**kwargs)
