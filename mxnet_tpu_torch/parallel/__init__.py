"""``mx.parallel``: meshes, the bucketed gradient communication and the
train-step harness.

PyTorch counterpart of ``mxnet_tpu/parallel``. A mesh spans the ranks of
the ``torch.distributed`` world, one process per device (``mesh.py``);
``SPMDTrainStep`` trains on one device or data-parallel over a mesh's
``dp`` axis with ZeRO 0-3 (``spmd.py``), its gradients reduced in buckets
(``overlap.py``). Tensor parallelism, pipelines, MoE, ring attention,
the superstep on a mesh and sharded checkpoints wait (ROADMAP A11).
"""

from .mesh import (MESH_AXES, Mesh, axis_size, composed_mesh,  # noqa: F401
                   current_mesh, data_parallel_mesh, make_mesh,
                   validate_mesh_axes)
from . import overlap  # noqa: F401
from .overlap import (BucketPlan, build_bucket_plan,  # noqa: F401
                      bucket_allreduce, bucket_reduce_scatter,
                      first_use_order, measure_overlap)
from .spmd import (SPMDTrainStep, replicate, shard_batch,  # noqa: F401
                   spmd_load_states, spmd_save_states)
