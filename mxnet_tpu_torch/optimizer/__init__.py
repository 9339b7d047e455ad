"""Optimizers of the port (``mx.optimizer``)."""

from .optimizer import SGD, Adam, Optimizer, create, register  # noqa: F401
