"""Ring attention over a sequence axis: not ported yet (ROADMAP A11).

Counterpart of ``mxnet_tpu/parallel/ring_attention.py``. Its port runs
K1 on each block with its log-sum-exp and K2 with the global one in the
backward; until then both entry points raise ``MXNetError`` naming A11.
"""

from __future__ import annotations

from ..base import MXNetError


def _not_ported(name):
    return MXNetError(f"parallel.{name}: ring attention over a sequence "
                      "axis is not ported yet (ROADMAP A11)")


def ring_attention(*args, **kwargs):
    """Attention with the sequence split over a mesh axis: raises (A11)."""
    raise _not_ported("ring_attention")


def shard_sequence(*args, **kwargs):
    """A batch split along its sequence axis: raises (A11)."""
    raise _not_ported("shard_sequence")
