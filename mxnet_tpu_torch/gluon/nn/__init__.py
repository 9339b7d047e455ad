"""Gluon layers (``gluon.nn``) of the port: every name of the JAX
package's ``gluon.nn`` but ``SymbolBlock`` (ROADMAP A13)."""

from ..block import Block, HybridBlock  # noqa: F401
from .activations import ELU, GELU, LeakyReLU, PReLU, SELU, Swish  # noqa: F401
from .basic_layers import (  # noqa: F401
    Activation,
    BatchNorm,
    Dense,
    Dropout,
    Embedding,
    Flatten,
    GroupNorm,
    HybridLambda,
    HybridSequential,
    InstanceNorm,
    Lambda,
    LayerNorm,
    Sequential,
    SyncBatchNorm,
)
from .conv_layers import (  # noqa: F401
    AvgPool1D,
    AvgPool2D,
    AvgPool3D,
    Conv1D,
    Conv1DTranspose,
    Conv2D,
    Conv2DTranspose,
    Conv3D,
    Conv3DTranspose,
    GlobalAvgPool1D,
    GlobalAvgPool2D,
    GlobalAvgPool3D,
    GlobalMaxPool1D,
    GlobalMaxPool2D,
    GlobalMaxPool3D,
    MaxPool1D,
    MaxPool2D,
    MaxPool3D,
    ReflectionPad2D,
)
