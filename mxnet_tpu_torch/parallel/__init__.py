"""``mx.parallel``: the train-step harness.

PyTorch counterpart of ``mxnet_tpu/parallel``. Only the single-device
path of ``SPMDTrainStep`` (``mesh=None``) is ported; meshes, tensor and
ZeRO sharding, overlap and the other parallel modules wait for the
distributed work (ROADMAP A11).
"""

from .spmd import SPMDTrainStep  # noqa: F401
