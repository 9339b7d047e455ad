"""Samplers (reference: ``python/mxnet/gluon/data/sampler.py``; the
port's copy of ``mxnet_tpu/gluon/data/sampler.py``). ``RandomSampler``
shuffles with numpy's global stream, as both packages do."""

from __future__ import annotations

import numpy as _np


class Sampler:
    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    def __init__(self, length, start=0):
        self._length = length
        self._start = start

    def __iter__(self):
        return iter(range(self._start, self._start + self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    def __init__(self, length):
        self._length = length

    def __iter__(self):
        indices = _np.arange(self._length)
        _np.random.shuffle(indices)
        return iter(indices.tolist())

    def __len__(self):
        return self._length


class BatchSampler(Sampler):
    def __init__(self, sampler, batch_size, last_batch="keep"):
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        head = []  # first batch_size indices, for "pad" wrap-around
        for i in self._sampler:
            if len(head) < self._batch_size:
                head.append(i)
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "discard":
                return
            elif self._last_batch == "rollover":
                self._prev = batch
            elif self._last_batch == "pad":
                # shape-stable epochs (NDArrayIter last_batch_handle=
                # "pad" semantics): wrap indices from the epoch start so
                # the final batch is full and nothing downstream
                # retraces; wraps repeat when the dataset is shorter
                # than one batch
                while len(batch) < self._batch_size:
                    batch.extend(head[:self._batch_size - len(batch)])
                yield batch
            else:
                raise ValueError("last_batch must be keep/discard/rollover/"
                                 f"pad, got {self._last_batch}")

    def __len__(self):
        if self._last_batch in ("keep", "pad"):
            return (len(self._sampler) + self._batch_size - 1) // self._batch_size
        if self._last_batch == "discard":
            return len(self._sampler) // self._batch_size
        if self._last_batch == "rollover":
            return (len(self._prev) + len(self._sampler)) // self._batch_size
        raise ValueError("last_batch must be keep/discard/rollover/pad, "
                         f"got {self._last_batch}")


class IntervalSampler(Sampler):
    def __init__(self, length, interval, rollover=True):
        self._length = length
        self._interval = interval
        self._rollover = rollover

    def __iter__(self):
        for i in range(self._interval if self._rollover else 1):
            for j in range(i, self._length, self._interval):
                yield j

    def __len__(self):
        return self._length
