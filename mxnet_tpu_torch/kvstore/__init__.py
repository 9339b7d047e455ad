"""``mx.kv`` (reference: ``mxnet_tpu/kvstore``): the stores that sum
gradients across the contexts of one process (``local``/``device``) and
across the ranks of a ``torch.distributed`` world (``dist_tpu_sync``)."""

from .base import KVStoreBase, create, register_kvstore  # noqa: F401
from .local import KVStoreLocal  # noqa: F401
from .dist import (CollectiveTimeoutError, KVStoreDistTPU,  # noqa: F401
                   all_gather_bytes, init_distributed, reset_world,
                   shutdown_distributed)

KVStore = KVStoreBase
