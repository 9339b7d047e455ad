"""DataLoader (reference: ``python/mxnet/gluon/data/dataloader.py``,
``DataLoader``/``_MultiWorkerIter``; the port's copy of
``mxnet_tpu/gluon/data/dataloader.py``).

Batches are host tensors. ``num_workers > 0`` runs the batchify in worker
processes (forkserver where the platform has it, else spawn: a process
that already runs threads must not fork); a worker runs torch on one
thread, never touches CUDA, and hands its batch back in shared memory
(the reference pickled the batch's bytes through the pool's pipe; MXNet
1.x used shared memory). ``thread_pool=True`` runs the batchify in
threads of this process. ``pin_memory=True`` pins every batch's host
tensors when a CUDA card is present, so a ``non_blocking`` copy reads
them directly (MXNet 1.x's meaning); without a card it warns once and
does nothing. ``device=ctx`` stages each batch on ``ctx`` ahead of the
consumer through :class:`~.prefetcher.DevicePrefetcher`.
"""

from __future__ import annotations

import logging
import multiprocessing
import os

import numpy as _np
import torch

from ...base import MXNetError
from ...context import cpu, resolve_device
from ...ndarray.ndarray import NDArray, array as _array
from .sampler import BatchSampler, RandomSampler, SequentialSampler

_logger = logging.getLogger(__name__)
_PIN_MEMORY_WARNED = [False]


def _warn_pin_memory_once():
    """Without a CUDA card there is nothing to pin for: warn once per
    process, not per loader or per batch."""
    if not _PIN_MEMORY_WARNED[0]:
        _PIN_MEMORY_WARNED[0] = True
        _logger.warning(
            "DataLoader(pin_memory=True) pins host memory for a CUDA card, "
            "and this process sees none; batches stay in pageable memory")


def default_batchify_fn(data):
    """Stack samples into a host batch (reference: ``default_batchify_fn``);
    NDArray samples stack on their own device."""
    if isinstance(data[0], NDArray):
        return NDArray(torch.stack([d.data for d in data]))
    if isinstance(data[0], tuple):
        data = zip(*data)
        return [default_batchify_fn(list(i)) for i in data]
    data = _np.asarray(data)
    return _array(data, ctx=cpu(),
                  dtype=data.dtype if data.dtype != _np.float64 else _np.float32)


def default_mp_batchify_fn(data):
    """Worker-side batchify: numpy (host) buffers."""
    if isinstance(data[0], NDArray):
        return _np.stack([d.asnumpy() for d in data])
    if isinstance(data[0], tuple):
        data = zip(*data)
        return [default_mp_batchify_fn(list(i)) for i in data]
    return _np.asarray(data)


def _as_in_context(data, ctx):
    if isinstance(data, torch.Tensor):
        return NDArray(data if data.dtype != torch.float64 else data.float())
    if isinstance(data, _np.ndarray):
        return _array(data, ctx=ctx,
                      dtype=_np.float32 if data.dtype == _np.float64 else None)
    if isinstance(data, NDArray):
        return data.as_in_context(ctx)
    if isinstance(data, (list, tuple)):
        return [_as_in_context(d, ctx) for d in data]
    return data


def _pin(data):
    """Host NDArrays of ``data`` in pinned memory (other leaves as they
    are)."""
    if isinstance(data, NDArray) and data.data.device.type == "cpu":
        return NDArray(data.data.pin_memory())
    if isinstance(data, (list, tuple)):
        return [_pin(d) for d in data]
    return data


_worker_dataset = None


def _worker_initializer(dataset):
    global _worker_dataset
    _worker_dataset = dataset


def _process_worker_initializer(dataset):
    """A worker process runs its torch operators on one thread, as
    PyTorch's own DataLoader workers do: ``num_workers`` processes each
    spinning up the host's full thread pool oversubscribe its cores."""
    torch.set_num_threads(1)
    _worker_initializer(dataset)


def _shared(data):
    """numpy leaves as CPU tensors in shared memory: the pool then sends
    the parent a handle to each, not its bytes through the pipe."""
    if isinstance(data, _np.ndarray):
        a = _np.ascontiguousarray(data)
        return torch.from_numpy(a if a.flags.writeable else a.copy()
                                ).share_memory_()
    if isinstance(data, (list, tuple)):
        return [_shared(d) for d in data]
    return data


def _worker_fn(samples, batchify_fn, dataset=None):
    ds = dataset if dataset is not None else _worker_dataset
    return batchify_fn([ds[i] for i in samples])


def _process_worker_fn(samples, batchify_fn, dataset=None):
    return _shared(_worker_fn(samples, batchify_fn, dataset))


class _MultiWorkerIter:
    def __init__(self, worker_pool, batchify_fn, batch_sampler,
                 pin_memory=False, worker_fn=_worker_fn, prefetch=0,
                 dataset=None, timeout=120):
        self._worker_pool = worker_pool
        self._batchify_fn = batchify_fn
        self._batch_sampler = batch_sampler
        self._data_buffer = {}
        self._rcvd_idx = 0
        self._sent_idx = 0
        self._iter = iter(self._batch_sampler)
        self._worker_fn = worker_fn
        self._pin_memory = pin_memory
        self._dataset = dataset
        self._timeout = timeout
        for _ in range(prefetch):
            self._push_next()

    def __len__(self):
        return len(self._batch_sampler)

    def _push_next(self):
        r = next(self._iter, None)
        if r is None:
            return
        async_ret = self._worker_pool.apply_async(
            self._worker_fn, (r, self._batchify_fn, self._dataset))
        self._data_buffer[self._sent_idx] = async_ret
        self._sent_idx += 1

    def __next__(self):
        self._push_next()
        if self._rcvd_idx == self._sent_idx:
            if self._data_buffer:
                raise MXNetError("DataLoader: batches left unreceived at "
                                 "the end of the epoch")
            raise StopIteration
        ret = self._data_buffer.pop(self._rcvd_idx)
        try:
            batch = ret.get(self._timeout)
        except multiprocessing.TimeoutError as e:
            raise MXNetError(f"DataLoader: a worker gave no batch within "
                             f"{self._timeout} s") from e
        batch = _as_in_context(batch, cpu())
        if self._pin_memory:
            batch = _pin(batch)
        self._rcvd_idx += 1
        return batch

    def next(self):
        return self.__next__()

    def __iter__(self):
        return self


class DataLoader:
    """Loads data from a Dataset and returns mini-batches (reference:
    ``gluon.data.DataLoader``)."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=False, timeout=120, device=None):
        # __del__ must survive an __init__ that raised before the pool
        # (or anything else) was assigned
        self._worker_pool = None
        self._dataset = dataset
        self._pin_memory = bool(pin_memory) and torch.cuda.is_available()
        if pin_memory and not self._pin_memory:
            _warn_pin_memory_once()
        self._thread_pool = thread_pool
        self._timeout = timeout
        if device is not None:
            resolve_device(device)  # a CUDA device without a card raises
        self._device = device

        if batch_sampler is None:
            if batch_size is None:
                raise ValueError(
                    "batch_size must be specified unless batch_sampler is")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must not be specified if sampler is")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif (batch_size is not None or shuffle or sampler is not None
              or last_batch is not None):
            raise ValueError(
                "batch_size, shuffle, sampler and last_batch must not be "
                "specified if batch_sampler is")
        self._batch_sampler = batch_sampler
        self._num_workers = max(0, num_workers)
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * self._num_workers)
        if self._num_workers > 0:
            if thread_pool:
                from multiprocessing.pool import ThreadPool

                self._worker_pool = ThreadPool(self._num_workers,
                                               initializer=_worker_initializer,
                                               initargs=(self._dataset,))
            else:
                # non-fork start methods import __main__ in the worker:
                # a script that builds such a loader at top level needs an
                # ``if __name__ == "__main__"`` guard
                method = "forkserver" if hasattr(os, "fork") else "spawn"
                ctx = multiprocessing.get_context(method)
                self._worker_pool = ctx.Pool(
                    self._num_workers,
                    initializer=_process_worker_initializer,
                    initargs=(self._dataset,))
        if batchify_fn is None:
            self._batchify_fn = (default_mp_batchify_fn if self._num_workers > 0
                                 else default_batchify_fn)
        else:
            self._batchify_fn = batchify_fn

    def _base_iter(self):
        if self._num_workers == 0:

            def same_process_iter():
                for batch in self._batch_sampler:
                    ret = self._batchify_fn([self._dataset[i] for i in batch])
                    yield _pin(ret) if self._pin_memory else ret

            return same_process_iter()
        return _MultiWorkerIter(
            self._worker_pool, self._batchify_fn, self._batch_sampler,
            pin_memory=self._pin_memory,
            worker_fn=_worker_fn if self._thread_pool else _process_worker_fn,
            prefetch=self._prefetch,
            dataset=self._dataset if self._thread_pool else None,
            timeout=self._timeout)

    def __iter__(self):
        if self._device is None:
            return self._base_iter()
        from .prefetcher import DevicePrefetcher

        # one prefetcher per epoch over a fresh single-use iterator; its
        # close() joins the staging thread when the epoch ends
        return iter(DevicePrefetcher(self._base_iter(), device=self._device))

    def __len__(self):
        return len(self._batch_sampler)

    def __del__(self):
        if getattr(self, "_worker_pool", None) is not None:
            try:
                self._worker_pool.terminate()
            except Exception:  # noqa: BLE001 - interpreter teardown
                pass
