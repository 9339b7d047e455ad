"""Activation layers (reference: ``gluon/nn/activations.py``)."""

from __future__ import annotations

from ... import initializer
from ..block import HybridBlock


class LeakyReLU(HybridBlock):
    """``x`` where ``x >= 0``, else ``alpha * x``."""

    def __init__(self, alpha, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)

    def __repr__(self):
        return f"LeakyReLU({self._alpha})"


class PReLU(HybridBlock):
    """LeakyReLU with learned slopes ``alpha``, one per channel (axis 1)
    or a single one (``in_channels=1``); 0.25 at initialisation."""

    def __init__(self, alpha_initializer=None, in_channels=1, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.alpha = self.params.get(
                "alpha", shape=(in_channels,),
                init=alpha_initializer or initializer.Constant(0.25))

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, gamma=alpha, act_type="prelu")


class ELU(HybridBlock):
    """``x`` where ``x >= 0``, else ``alpha * (exp(x) - 1)``."""

    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    """The scaled ELU of Klambauer et al. 2017."""

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class GELU(HybridBlock):
    """The exact (erf) GELU."""

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="gelu")


class Swish(HybridBlock):
    """``x * sigmoid(beta * x)``."""

    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)
