"""``mx.resilience``: fault-tolerant training in one process.

PyTorch counterpart of ``mxnet_tpu/resilience/``:

- :mod:`.checkpoint`: checkpoints of a Gluon training loop
  (``MXTPU_CHECKPOINT``): parameters, optimizer state, fp32 masters, the
  loss scaler, update counts, random state and data cursor, copied on
  the device at a step boundary and written by a thread with an atomic
  rename commit, manifest, checksums, retention and a SIGTERM final save;
- :mod:`.resume`: restore one, bit for bit on one device;
- :mod:`.chaos`: deterministic fault injection (``MXTPU_CHAOS``).

Live elasticity (``ElasticTrainer``, ``MembershipMonitor``,
``snapshot_descriptor``) and sharded checkpoints are ROADMAP A11's and
raise.
"""

from __future__ import annotations

from ..base import MXNetError
from . import chaos  # noqa: F401
from . import checkpoint  # noqa: F401
from . import resume  # noqa: F401
from .checkpoint import (  # noqa: F401
    CheckpointManager,
    atomic_replace,
    default_commit_barrier,
    latest_checkpoint,
    maybe_checkpointing,
    verify,
    verify_descriptor,
    write_checkpoint,
)
from .resume import (  # noqa: F401
    ResumeReport,
    list_checkpoints,
    load_checkpoint,
    save_spmd_checkpoint,
    skip_batches,
)


def _elastic(name):
    def stub(*args, **kwargs):
        raise MXNetError(f"resilience.{name}: live elasticity over a "
                         "device mesh is not ported yet (ROADMAP A11)")

    stub.__name__ = name
    return stub


ElasticTrainer = _elastic("ElasticTrainer")
MembershipMonitor = _elastic("MembershipMonitor")
snapshot_descriptor = _elastic("snapshot_descriptor")

# MXTPU_CHAOS arms faults at import (one getenv when unset)
chaos.maybe_configure()
