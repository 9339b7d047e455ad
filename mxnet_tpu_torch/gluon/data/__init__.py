"""``mx.gluon.data`` of the port (reference: ``python/mxnet/gluon/data/``):
datasets, samplers, ``DataLoader``, ``DevicePrefetcher`` and the K-deep
``SuperstepRing`` of ``gluon.Superstep``, the batch-shape guard and
``vision``. The streaming reader's names (``stream.py``) raise naming
ROADMAP A13."""

from .dataset import (  # noqa: F401
    Dataset,
    SimpleDataset,
    ArrayDataset,
    RecordFileDataset,
)
from .sampler import (  # noqa: F401
    Sampler,
    SequentialSampler,
    RandomSampler,
    BatchSampler,
    IntervalSampler,
)
from .dataloader import DataLoader  # noqa: F401
from .prefetcher import (DevicePrefetcher, SuperstepRing,  # noqa: F401
                         prefetch_depth, stack_batches)  # noqa: F401
from .shape_guard import SequenceBucketer, pad_batch, pad_to_shape  # noqa: F401
from .stream import (GlobalOrder, ShardIndex, ShardSet,  # noqa: F401
                     StreamReader, device_augment,  # noqa: F401
                     write_recordio_shards)  # noqa: F401
from . import vision  # noqa: F401
