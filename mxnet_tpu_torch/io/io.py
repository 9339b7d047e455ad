"""Legacy data iterators (reference: ``python/mxnet/io/io.py`` and the
C++ iterators of ``src/io/``; the port's copy of ``mxnet_tpu/io/io.py``).

Batches are host arrays (``ctx=cpu``), as in MXNet 1.x: a training loop
moves them with ``as_in_context`` or stages them on the card ahead of the
step with ``gluon.data.DevicePrefetcher``. ``ImageRecordIter`` runs the
native C++ pipeline (``_native.py``); ``LibSVMIter`` waits for sparse
storage (ROADMAP A13).
"""

from __future__ import annotations

import threading
from collections import namedtuple

import numpy as _np
import torch

from ..base import MXNetError
from ..context import cpu
from ..ndarray.ndarray import NDArray, array as _array

DataDesc = namedtuple("DataDesc", ["name", "shape", "dtype", "layout"])
DataDesc.__new__.__defaults__ = ("float32", "NCHW")


class DataBatch:
    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None and not isinstance(data, (list, tuple)):
            data = [data]
        if label is not None and not isinstance(label, (list, tuple)):
            label = [label]
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        data_shapes = [d.shape for d in self.data] if self.data else None
        label_shapes = [l.shape for l in self.label] if self.label else None
        return f"{self.__class__.__name__}: data shapes: {data_shapes} label shapes: {label_shapes}"


class DataIter:
    """Iterator protocol: next/reset/provide_data/provide_label."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


class NDArrayIter(DataIter):
    """Iterate over NDArray/numpy data (reference: ``NDArrayIter``)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False, default_name=data_name)
        self.label = _init_data(label, allow_empty=True, default_name=label_name)
        self.idx = _np.arange(self.data[0][1].shape[0])
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.num_data = self.idx.shape[0]
        self.num_source = len(self.data)
        self.cursor = -batch_size
        self._cache_data = None
        self._cache_label = None
        self.reset()

    @property
    def provide_data(self):
        return [
            DataDesc(k, (self.batch_size,) + tuple(v.shape[1:]), str(v.dtype))
            for k, v in self.data
        ]

    @property
    def provide_label(self):
        return [
            DataDesc(k, (self.batch_size,) + tuple(v.shape[1:]), str(v.dtype))
            for k, v in self.label
        ]

    def reset(self):
        if self.shuffle:
            _np.random.shuffle(self.idx)
        if self.last_batch_handle == "roll_over" and \
                0 < self.cursor < self.num_data:
            self.cursor = self.cursor - self.num_data - self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if not self.iter_next():
            raise StopIteration
        if self.last_batch_handle == "discard" and \
                self.cursor + self.batch_size > self.num_data:
            raise StopIteration
        return DataBatch(data=self.getdata(), label=self.getlabel(),
                         pad=self.getpad(), index=None)

    def _getdata(self, data_source):
        end = min(self.cursor + self.batch_size, self.num_data)
        sel = self.idx[self.cursor:end]
        pad = self.batch_size - len(sel)
        if pad and self.last_batch_handle == "pad":
            sel = _np.concatenate([sel, self.idx[:pad]])
        out = []
        for _, arr in data_source:
            np_arr = arr[sel] if isinstance(arr, _np.ndarray) else arr.asnumpy()[sel]
            out.append(_array(np_arr, ctx=cpu(), dtype=str(np_arr.dtype)
                              if np_arr.dtype != _np.float64 else "float32"))
        return out

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


def _init_data(data, allow_empty, default_name):
    if data is None:
        if not allow_empty:
            raise ValueError("data must not be None")
        return []
    if isinstance(data, (NDArray, _np.ndarray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {f"_{i}_{default_name}": d for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, list or dict")
    out = []
    for k, v in data.items():
        if isinstance(v, NDArray):
            v = v.asnumpy()
        out.append((k, _np.asarray(v)))
    return out


class ResizeIter(DataIter):
    """Resize (truncate/loop) another iterator to a fixed #batches."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Background-thread prefetch (reference: ``PrefetchingIter``)."""

    #: machine-checked lock protocol (mxtpu-lint thread-guard): the
    #: started flag flips only under the close lock, so exactly ONE
    #: closer signals and joins the prefetch threads (close() racing
    #: __del__ both joined — and a late consumer could then wait on
    #: data_ready events nobody would ever set again)
    _GUARDED_BY = {"started": "_close_lock"}

    def __init__(self, iters, rename_data=None, rename_label=None):
        super().__init__()
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        self._close_lock = threading.Lock()
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = iters[0].batch_size
        self.n_iter = len(iters)
        self.data_ready = [threading.Event() for _ in range(self.n_iter)]
        self.data_taken = [threading.Event() for _ in range(self.n_iter)]
        for e in self.data_taken:
            e.set()
        self.started = True
        self.current_batch = [None] * self.n_iter
        self.next_batch = [None] * self.n_iter
        self.error = [None] * self.n_iter

        def prefetch(i):
            while True:
                self.data_taken[i].wait()
                if not self.started:
                    break
                try:
                    self.next_batch[i] = self.iters[i].next()
                except StopIteration:
                    self.next_batch[i] = None
                except BaseException as e:  # noqa: BLE001 - must never
                    # leave the consumer blocked on data_ready forever;
                    # park the exception for next() to re-raise
                    self.error[i] = e
                    self.next_batch[i] = None
                self.data_taken[i].clear()
                self.data_ready[i].set()
            self.data_ready[i].set()  # unblock a consumer racing close()

        self.prefetch_threads = [
            threading.Thread(target=prefetch, args=(i,), daemon=True)
            for i in range(self.n_iter)
        ]
        for t in self.prefetch_threads:
            t.start()

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum((i.provide_data for i in self.iters), [])
        return sum(
            ([DataDesc(r.get(d.name, d.name), d.shape, d.dtype)
              if isinstance(d, DataDesc) else (r.get(d[0], d[0]), d[1])
              for d in i.provide_data]
             for r, i in zip(self.rename_data, self.iters)), [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum((i.provide_label for i in self.iters), [])
        return sum(
            ([DataDesc(r.get(d.name, d.name), d.shape, d.dtype)
              if isinstance(d, DataDesc) else (r.get(d[0], d[0]), d[1])
              for d in i.provide_label]
             for r, i in zip(self.rename_label, self.iters)), [])

    def close(self):
        """Idempotent shutdown: signal the prefetch threads and JOIN
        them (the seed leaked daemon threads that were never joined).
        Exactly one closer wins the flag flip under the lock; the joins
        run outside it."""
        with self._close_lock:
            if not self.started:
                return
            self.started = False
        for e in self.data_taken:
            e.set()
        for t in self.prefetch_threads:
            if t is not threading.current_thread():
                t.join(timeout=5.0)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _raise_pending(self):
        for i, err in enumerate(self.error):
            if err is not None:
                self.error[i] = None
                self.close()
                raise err

    def reset(self):
        for e in self.data_ready:
            e.wait()
        self._raise_pending()
        for i in self.iters:
            i.reset()
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()

    def iter_next(self):
        for e in self.data_ready:
            e.wait()
        self._raise_pending()
        if self.next_batch[0] is None:
            return False
        self.current_batch = DataBatch(
            sum((b.data for b in self.next_batch), []),
            sum((b.label for b in self.next_batch), []) if self.next_batch[0].label else None,
            self.next_batch[0].pad,
            self.next_batch[0].index)
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


def MXDataIter(*args, **kwargs):
    raise MXNetError("MXDataIter is C-backed in the reference; use the named "
                     "iterators (ImageRecordIter, CSVIter, NDArrayIter)")


class CSVIter(DataIter):
    """CSV iterator (reference: ``src/io/iter_csv.cc``)."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, dtype="float32", **kwargs):
        super().__init__(batch_size)
        data = _np.loadtxt(data_csv, delimiter=",", dtype=dtype, ndmin=2)
        self._data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = _np.loadtxt(label_csv, delimiter=",", dtype=dtype, ndmin=2)
            self._label = label.reshape((-1,) + tuple(label_shape))
        else:
            self._label = _np.zeros((len(self._data), 1), dtype=dtype)
        self._inner = NDArrayIter(self._data, self._label, batch_size,
                                  last_batch_handle="roll_over" if round_batch else "pad")
        self.provide_data = self._inner.provide_data
        self.provide_label = self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


class LibSVMIter(DataIter):
    """LibSVM iterator (reference: ``src/io/iter_libsvm.cc``). Its batches
    are ``CSRNDArray``; sparse storage is ROADMAP A13's, so it raises."""

    def __init__(self, *args, **kwargs):
        raise MXNetError("mx.io.LibSVMIter yields CSRNDArray batches; sparse "
                         "storage is not in the port yet (ROADMAP A13)")


class _NativeImageRecordIter(DataIter):
    """The C++ RecordIO image pipeline (the reference's ``ImageRecordIter2``
    role: decode, augment and batch on native threads). Each batch is
    copied out of the pipeline's reused buffer into a new host tensor,
    pinned when a CUDA card is present, so a ``non_blocking`` copy to the
    card reads it directly."""

    def __init__(self, pipeline, batch_size, data_shape, label_width):
        super().__init__(batch_size)
        self._pipe = pipeline
        self._pin = torch.cuda.is_available()
        self.provide_data = [DataDesc("data", (batch_size,) + tuple(data_shape))]
        self.provide_label = [DataDesc("softmax_label",
                                       (batch_size, label_width))]

    def reset(self):
        self._pipe.reset()

    def _host(self, buf):
        t = torch.empty(buf.shape, dtype=torch.float32, pin_memory=self._pin)
        t.copy_(torch.from_numpy(buf))
        return NDArray(t)

    def next(self):
        res = self._pipe.next_batch()
        if res is None:
            raise StopIteration
        data, label, n = res
        return DataBatch(data=[self._host(data)], label=[self._host(label)],
                         pad=self.batch_size - n)


def ImageRecordIter(path_imgrec=None, data_shape=(3, 224, 224), batch_size=1,
                    label_width=1, shuffle=False, rand_crop=False,
                    rand_mirror=False, mean_r=0, mean_g=0, mean_b=0,
                    std_r=1, std_g=1, std_b=1, resize=0, preprocess_threads=4,
                    prefetch_buffer=4, seed=0, **kwargs):
    """Threaded RecordIO image pipeline (reference:
    ``src/io/iter_image_recordio_2.cc`` via factory registration).

    An indexed pack (its ``.idx`` beside it, or ``path_imgidx``) with no
    ``aug_list`` runs through the native C++ pipeline
    (``_native.NativeImagePipeline``); a failed build of that library
    raises. Without an index, or with an ``aug_list``, the Python
    ``image.ImageIter`` behind a ``PrefetchingIter`` serves, as in the
    reference.
    """
    import os

    import numpy as np

    from .. import _native

    mean = None
    if mean_r or mean_g or mean_b:
        mean = np.array([mean_r, mean_g, mean_b])

    if path_imgrec and not kwargs.get("aug_list"):
        idx_path = kwargs.get("path_imgidx") or \
            os.path.splitext(path_imgrec)[0] + ".idx"
        if os.path.exists(idx_path):
            std = [std_r, std_g, std_b] if (std_r != 1 or std_g != 1
                                            or std_b != 1) else None
            pipe = _native.NativeImagePipeline(
                path_imgrec, idx_path, batch_size, tuple(data_shape),
                shuffle=shuffle, num_threads=preprocess_threads,
                rand_crop=rand_crop, rand_mirror=rand_mirror,
                mean=list(mean) if mean is not None else None, std=std,
                label_width=label_width, seed=seed)
            return _NativeImageRecordIter(pipe, batch_size, data_shape,
                                          label_width)

    from ..image import ImageIter

    it = ImageIter(batch_size=batch_size, data_shape=tuple(data_shape),
                   label_width=label_width, path_imgrec=path_imgrec,
                   shuffle=shuffle, rand_crop=rand_crop,
                   rand_mirror=rand_mirror, mean=mean, resize=resize,
                   **{k: v for k, v in kwargs.items()
                      if k in ("path_imglist", "path_root", "aug_list")})
    return PrefetchingIter(it)


def MNISTIter(image=None, label=None, batch_size=1, shuffle=True, flat=False,
              **kwargs):
    """MNIST idx-file iterator (reference: ``src/io/iter_mnist.cc``)."""
    import gzip
    import struct

    def opener(p):
        return gzip.open(p, "rb") if p.endswith(".gz") else open(p, "rb")

    with opener(label) as fin:
        struct.unpack(">II", fin.read(8))
        lbl = _np.frombuffer(fin.read(), dtype=_np.uint8).astype("float32")
    with opener(image) as fin:
        _, n, rows, cols = struct.unpack(">IIII", fin.read(16))
        img = _np.frombuffer(fin.read(), dtype=_np.uint8)
        img = img.reshape(n, rows, cols).astype("float32") / 255.0
    if flat:
        img = img.reshape(n, rows * cols)
    else:
        img = img.reshape(n, 1, rows, cols)
    return NDArrayIter(img, lbl, batch_size, shuffle=shuffle)
