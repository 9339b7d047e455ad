"""``mx.gluon.data`` of the port (reference: ``python/mxnet/gluon/data/``).

Only the batch-shape guard is here so far, which the serving engine
needs; the datasets, samplers, ``DataLoader`` and the prefetcher come
with ROADMAP A6.
"""

from .shape_guard import SequenceBucketer, pad_batch, pad_to_shape  # noqa: F401
