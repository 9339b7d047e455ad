"""``mx.io``: the legacy DataIter API (reference: ``python/mxnet/io/io.py``)."""

from .io import (  # noqa: F401
    DataDesc,
    DataBatch,
    DataIter,
    NDArrayIter,
    ResizeIter,
    PrefetchingIter,
    MXDataIter,
    CSVIter,
    LibSVMIter,
    ImageRecordIter,
    MNISTIter,
)
