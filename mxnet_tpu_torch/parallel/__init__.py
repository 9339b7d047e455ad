"""``mx.parallel``: meshes, the bucketed gradient communication, the train
steps over a mesh, ring attention, pipelines and mixture-of-experts.

PyTorch counterpart of ``mxnet_tpu/parallel``. A mesh spans the ranks of
the ``torch.distributed`` world, one process per device (``mesh.py``);
``SPMDTrainStep`` trains on one device, data-parallel over a mesh's
``dp`` axis with ZeRO 0-3, and tensor-parallel over the axes its
``param_sharding`` specs name (``spmd.py``), its gradients reduced in
buckets (``overlap.py``); its state saves and restores as shard files in
logical coordinates (``spmd_save_states``). ``ring_attention`` splits the
sequence over an ``sp`` axis, ``PipelineTrainStep`` runs the GPipe, 1F1B
and interleaved schedules over a ``pp`` axis (``pipeline.py``), ``moe``
splits experts over an ``ep`` axis, and ``Composed4DStep`` trains over
dp x pp x tp (``composed.py``); their tensors move through
``transport.py``. Elastic training waits (ROADMAP A11).
"""

from .mesh import (MESH_AXES, Mesh, P, PartitionSpec,  # noqa: F401
                   axis_size, composed_mesh, current_mesh,
                   data_parallel_mesh, make_mesh, validate_mesh_axes)
from .spmd import (SPMDTrainStep, bucketed_psum, replicate,  # noqa: F401
                   shard_batch, spmd_load_states, spmd_restore_chunks,
                   spmd_save_states, spmd_state_snapshot)
from . import overlap  # noqa: F401
from .overlap import (BucketPlan, build_bucket_plan,  # noqa: F401
                      bucket_allreduce, bucket_reduce_scatter,
                      first_use_order, measure_overlap)
from .ring_attention import ring_attention, shard_sequence  # noqa: F401
from .pipeline import (PipelineTrainStep, pipeline_apply,  # noqa: F401
                       shard_stages, stack_stage_params,
                       build_pipeline_schedule, stage_permutation,
                       measure_pipeline_bubble)
from .composed import (Composed4DStep, tp_copy,  # noqa: F401
                       tp_all_gather)
from . import moe  # noqa: F401
from .moe import (top2_routing, moe_apply_a2a,  # noqa: F401
                  measure_moe_overlap)
