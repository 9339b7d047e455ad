"""Gluon layers (``gluon.nn``) of the port."""

from .activations import GELU  # noqa: F401
from .basic_layers import (  # noqa: F401
    Activation,
    BatchNorm,
    Dense,
    Dropout,
    Embedding,
    Flatten,
    HybridSequential,
    LayerNorm,
    Sequential,
)
from .conv_layers import (  # noqa: F401
    AvgPool2D,
    Conv2D,
    GlobalAvgPool2D,
    GlobalMaxPool2D,
    MaxPool2D,
)
from ..block import Block, HybridBlock  # noqa: F401
