"""Gluon layers (``gluon.nn``) of the port."""

from .activations import GELU  # noqa: F401
from .basic_layers import (  # noqa: F401
    Activation,
    Dense,
    Dropout,
    Embedding,
    HybridSequential,
    LayerNorm,
    Sequential,
)
from ..block import Block, HybridBlock  # noqa: F401
