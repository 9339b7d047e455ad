"""``mx.resilience``: fault-tolerant training.

PyTorch counterpart of ``mxnet_tpu/resilience/``:

- :mod:`.checkpoint`: checkpoints of a Gluon training loop
  (``MXTPU_CHECKPOINT``): parameters, optimizer state, fp32 masters, the
  loss scaler, update counts, random state and data cursor, copied on
  the device at a step boundary and written by a thread with an atomic
  rename commit, manifest, checksums, retention and a SIGTERM final save
  (in a world of several ranks, rank 0 writes the replicated state);
- :mod:`.resume`: restore one, bit for bit, on every rank; write and
  restore a sharded ``SPMDTrainStep`` checkpoint (``save_spmd_checkpoint``,
  one commit for every rank) onto any mesh;
- :mod:`.chaos`: deterministic fault injection (``MXTPU_CHAOS``);
- :mod:`.elastic`: live elasticity, a running data-parallel job resized
  over the ranks of its world at a step boundary (``ElasticTrainer``,
  ``MembershipMonitor``, ``snapshot_descriptor``).
"""

from __future__ import annotations

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
from .elastic import (ElasticTrainer, MembershipMonitor,  # noqa: F401
                      snapshot_descriptor)

# MXTPU_CHAOS arms faults at import (one getenv when unset)
chaos.maybe_configure()
