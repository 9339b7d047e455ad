"""Activation layers (reference: ``gluon/nn/activations.py``)."""

from __future__ import annotations

from ..block import HybridBlock


class GELU(HybridBlock):
    """The exact (erf) GELU."""

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="gelu")
