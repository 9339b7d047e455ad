"""Gluon of the port: blocks, layers, losses, Trainer, Superstep, model
zoo, and ``contrib.nn.MoEDense``."""

from . import contrib, data, loss, model_zoo, nn, utils  # noqa: F401
from .block import Block, HybridBlock  # noqa: F401
from .parameter import (  # noqa: F401
    Constant,
    DeferredInitializationError,
    Parameter,
    ParameterDict,
)
from .trainer import Superstep, Trainer  # noqa: F401
