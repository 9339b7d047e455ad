"""Gluon of the port: blocks, layers, losses, Trainer, model zoo."""

from . import data, loss, model_zoo, nn, utils  # noqa: F401
from .block import Block, HybridBlock  # noqa: F401
from .parameter import (  # noqa: F401
    Constant,
    DeferredInitializationError,
    Parameter,
    ParameterDict,
)
from .trainer import Trainer  # noqa: F401
