"""Live elasticity: not ported yet (ROADMAP A11, its last part).

Counterpart of ``mxnet_tpu/resilience/elastic.py``: ``ElasticTrainer``,
``MembershipMonitor`` and ``snapshot_descriptor`` raise ``MXNetError``
naming A11. What they would stand on is here: a step's state as
logical-coordinate chunks (``parallel.spmd_state_snapshot``) restores
onto another mesh (``parallel.spmd_restore_chunks``), and a committed
sharded checkpoint restores onto any world size
(``resume.load_checkpoint(spmd_step=...)``).
"""

from __future__ import annotations

from ..base import MXNetError


def _elastic(name):
    def stub(*args, **kwargs):
        raise MXNetError(f"resilience.{name}: live elasticity over a "
                         "device mesh is not ported yet (ROADMAP A11)")

    stub.__name__ = name
    return stub


ElasticTrainer = _elastic("ElasticTrainer")
MembershipMonitor = _elastic("MembershipMonitor")
snapshot_descriptor = _elastic("snapshot_descriptor")
