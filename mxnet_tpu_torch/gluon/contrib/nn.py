"""``gluon.contrib.nn`` of the port: the mixture-of-experts layer.

Counterpart of ``mxnet_tpu/gluon/contrib/nn.py``'s ``MoEDense``. The
module's other layers (``Concurrent``, ``HybridConcurrent``,
``Identity``, ``SparseEmbedding``, ``PixelShuffle2D``, ``SpectralNorm``,
``SyncBatchNorm``) are ROADMAP A13 (d): asking for one raises
``MXNetError`` naming it.
"""

from __future__ import annotations

from ...base import MXNetError
from ..block import HybridBlock

_WAITING = ("Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
            "PixelShuffle2D", "SpectralNorm", "SyncBatchNorm", "Sequential",
            "HybridSequential")


def __getattr__(name):
    if name in _WAITING:
        raise MXNetError(f"gluon.contrib.nn.{name} is not ported yet "
                         "(ROADMAP A13 (d))")
    raise AttributeError(name)


class MoEDense(HybridBlock):
    """Mixture-of-experts FFN layer over tokens: the ``_contrib_moe``
    operator (GShard top-1 routing with capacity and the load-balance aux
    loss, ``parallel.moe``). Input ``(B, T, d)`` or ``(T, d)``; returns
    ``(out, aux_loss)``: add ``aux_loss * coef`` to the objective. With
    ``mesh=`` (a mesh with an ``ep`` axis) the experts split over its
    ranks."""

    def __init__(self, units, hidden_units, num_experts,
                 capacity_factor=1.5, mesh=None, axis_name="ep",
                 dtype="float32", weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._cf = capacity_factor
        self._mesh = mesh
        self._axis = axis_name
        with self.name_scope():
            self.gate = self.params.get(
                "gate", shape=(units, num_experts), dtype=dtype,
                init=weight_initializer)
            self.w1 = self.params.get(
                "w1", shape=(num_experts, units, hidden_units), dtype=dtype,
                init=weight_initializer)
            self.w2 = self.params.get(
                "w2", shape=(num_experts, hidden_units, units), dtype=dtype,
                init=weight_initializer)

    def hybrid_forward(self, F, x, gate, w1, w2):
        tokens = F.reshape(x, (-1, self._units))
        out, aux = F._contrib_moe(tokens, gate, w1, w2, mesh=self._mesh,
                                  axis_name=self._axis,
                                  capacity_factor=self._cf)
        return F.reshape_like(out, x), aux
