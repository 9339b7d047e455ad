"""Datasets (reference: ``python/mxnet/gluon/data/dataset.py``; the
port's copy of ``mxnet_tpu/gluon/data/dataset.py``)."""

from __future__ import annotations

import os

from ...base import MXNetError
from ...ndarray.ndarray import NDArray


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        return _FilteredDataset(self, fn)

    def shard(self, num_shards, index):
        if not 0 <= index < num_shards:
            raise MXNetError(f"shard index {index} out of range for "
                             f"{num_shards} shards")
        length = len(self)
        shard_len = length // num_shards
        rest = length % num_shards
        start = shard_len * index + min(index, rest)
        end = start + shard_len + (index < rest)
        return _ShardedDataset(self, start, end)

    def take(self, count):
        if count is None or count > len(self):
            count = len(self)
        return _ShardedDataset(self, 0, count)

    def transform(self, fn, lazy=True):
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        return self.transform(_TransformFirstClosure(fn), lazy)


class _TransformFirstClosure:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class _FilteredDataset(Dataset):
    def __init__(self, data, fn):
        self._indices = [i for i in range(len(data)) if fn(data[i])]
        self._data = data

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, idx):
        return self._data[self._indices[idx]]


class _ShardedDataset(Dataset):
    def __init__(self, data, start, end):
        self._data = data
        self._start, self._end = start, end

    def __len__(self):
        return self._end - self._start

    def __getitem__(self, idx):
        return self._data[self._start + idx]


class ArrayDataset(Dataset):
    """Zip of arrays/datasets (reference: ``ArrayDataset``)."""

    def __init__(self, *args):
        if not args:
            raise MXNetError("ArrayDataset needs at least one array")
        self._length = len(args[0])
        self._data = []
        for data in args:
            if len(data) != self._length:
                raise MXNetError("all arrays must have same length")
            if isinstance(data, NDArray) and data.ndim == 1:
                data = data.asnumpy()
            self._data.append(data)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(data[idx] for data in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """Dataset over an indexed RecordIO file (reference:
    ``RecordFileDataset`` over ``MXIndexedRecordIO``)."""

    def __init__(self, filename):
        from ...recordio import IndexedRecordIO

        self.idx_file = os.path.splitext(filename)[0] + ".idx"
        self.filename = filename
        self._record = IndexedRecordIO(self.idx_file, self.filename, "r")

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)
