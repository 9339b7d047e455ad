"""``mx.parallel``: meshes, the bucketed gradient communication and the
train-step harness.

PyTorch counterpart of ``mxnet_tpu/parallel``. A mesh spans the ranks of
the ``torch.distributed`` world, one process per device (``mesh.py``);
``SPMDTrainStep`` trains on one device, data-parallel over a mesh's
``dp`` axis with ZeRO 0-3, and tensor-parallel over the axes its
``param_sharding`` specs name (``spmd.py``), its gradients reduced in
buckets (``overlap.py``); its state saves and restores as shard files in
logical coordinates (``spmd_save_states``). Pipelines, MoE, ring attention
and elastic training wait (ROADMAP A11).
"""

from .mesh import (MESH_AXES, Mesh, P, PartitionSpec,  # noqa: F401
                   axis_size, composed_mesh, current_mesh,
                   data_parallel_mesh, make_mesh, validate_mesh_axes)
from . import overlap  # noqa: F401
from .overlap import (BucketPlan, build_bucket_plan,  # noqa: F401
                      bucket_allreduce, bucket_reduce_scatter,
                      first_use_order, measure_overlap)
from .ring_attention import ring_attention, shard_sequence  # noqa: F401
from .spmd import (SPMDTrainStep, replicate, shard_batch,  # noqa: F401
                   spmd_load_states, spmd_restore_chunks, spmd_save_states,
                   spmd_state_snapshot)
