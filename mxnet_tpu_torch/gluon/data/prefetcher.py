"""Device prefetcher: stage batches on the card ahead of the step (the
port's copy of ``mxnet_tpu/gluon/data/prefetcher.py``).

A background thread pulls batches from any source (``DataLoader``, an
``io.DataIter``, a generator), copies each array leaf to the device and
queues the result ``depth`` batches ahead (``MXTPU_DEVICE_PREFETCH``,
default 2), so the consumer's ``next()`` returns a batch that is already
on the card, or on its way there, while the previous step runs.

On a CUDA device the copy runs on a side stream:

- a pageable host leaf is copied into a pinned host buffer; a leaf that
  is already pinned (``DataLoader(pin_memory=True)``,
  ``io.ImageRecordIter``) is copied from directly;
- the host-to-device copy is enqueued ``non_blocking`` on a side
  ``torch.cuda.Stream``, and an event is recorded after the batch's
  copies;
- a pinned buffer is reused only once its copy has completed: torch's
  caching host allocator, which every pinned allocation comes from,
  records an event on the stream of each ``non_blocking`` copy that
  reads a block and hands the block out again only after that event;
- ``next()`` makes the consumer's current stream wait on the batch's
  event (the host does not wait for the copy) and calls ``record_stream``
  on the delivered tensors, so the caching allocator does not reuse their
  memory while the consumer's stream may still read them.

``device=None`` keeps batches on the host, as the reference does. A
``mesh`` (sharded staging) is ROADMAP A11's and raises ``MXNetError``
naming it. ``resilience.chaos``'s ``nan`` fault at site ``prefetch``
poisons the float leaves of a staged batch. :class:`SuperstepRing` groups
the staged batches K at a time for ``gluon.Superstep``.

Error contract: an exception raised by the source (or the copy) reaches
the consumer's ``next()``, never a silent hang; ``close()`` is idempotent
and joins the thread (also via ``__del__``).
"""

from __future__ import annotations

import queue
import threading
import time
from contextlib import nullcontext as _nullcontext

import numpy as _np
import torch

from ... import observability as _obs
from ...base import MXNetError, getenv
from ...context import Context, resolve_device
from ...ndarray.ndarray import NDArray

_DEPTH_DEFAULT = 2


def prefetch_depth() -> int:
    """Queue depth (batches staged ahead) from ``MXTPU_DEVICE_PREFETCH``
    (default 2 = double buffering; 0 disables auto-wrapping)."""
    return max(0, int(getenv("MXTPU_DEVICE_PREFETCH", _DEPTH_DEFAULT,
                             dtype=int)))


class DevicePrefetcher:
    """Wrap a batch source and stage its batches ``depth`` ahead on
    ``device``.

    >>> loader = DataLoader(dataset, batch_size=64, last_batch="pad")
    >>> for x, y in DevicePrefetcher(loader, device=mx.gpu()):
    ...     train_step(x, y)   # x, y on the card

    ``device``: a Context (or anything ``resolve_device`` takes), or None
    to keep batches on the host (the batchify work still overlaps). Batch
    structure (tuple/list/dict/``DataBatch``) is kept leaf-wise; scalars
    and strings ride through.
    """

    #: lock protocol: the epoch's thread, queue and stop flag swap only
    #: under the lifecycle lock, so close() racing _start_epoch() (a
    #: consumer restart against __del__) never orphans a producer blocked
    #: on a queue nobody drains
    _GUARDED_BY = {"_thread": "_lifecycle_lock",
                   "_queue": "_lifecycle_lock",
                   "_stop": "_lifecycle_lock"}

    def __init__(self, source, device=None, mesh=None, depth=None,
                 batch_axis="dp"):
        if device is not None and mesh is not None:
            raise ValueError("pass device OR mesh, not both")
        if mesh is not None:
            raise MXNetError("DevicePrefetcher(mesh=...): sharded staging "
                             "over a device mesh is ROADMAP A11's; in a "
                             "world of several ranks stage each rank's rows "
                             "(parallel.shard_batch) with device=")
        self._lifecycle_lock = threading.Lock()
        self._source = source
        self._batch_axis = batch_axis
        self._depth = max(1, depth if depth is not None
                          else (prefetch_depth() or _DEPTH_DEFAULT))
        self._queue = None
        self._thread = None
        self._stop = threading.Event()
        self._exhausted = False
        self._delivered = 0  # batches handed to the consumer this epoch
        self._placement_gen = 0  # bumped by repartition(): a batch staged
        # before it is staged again onto the new device at delivery
        self._set_device(device)

    def _set_device(self, device):
        self._device = device
        self._dev = resolve_device(device) if device is not None else None
        self._stream = None
        if self._dev is not None and self._dev.type == "cuda":
            self._stream = torch.cuda.Stream(device=self._dev)

    # -- conversion -------------------------------------------------------
    def _convert_leaf(self, obj, box):
        """``obj`` with every array leaf on the target device. ``box``
        accumulates the bytes moved."""
        if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
            return type(obj)(self._convert_leaf(o, box) for o in obj)
        if isinstance(obj, dict):
            return {k: self._convert_leaf(v, box)
                    for k, v in obj.items()}
        if obj.__class__.__name__ == "DataBatch" and hasattr(obj, "data"):
            from ...io.io import DataBatch

            return DataBatch(
                data=self._convert_leaf(obj.data, box),
                label=self._convert_leaf(obj.label, box),
                pad=obj.pad, index=obj.index, bucket_key=obj.bucket_key,
                provide_data=obj.provide_data,
                provide_label=obj.provide_label)
        if isinstance(obj, NDArray):
            t = obj.data.detach()
        elif isinstance(obj, _np.ndarray):
            t = torch.from_numpy(_np.ascontiguousarray(obj))
        elif isinstance(obj, torch.Tensor):
            t = obj.detach()
        else:
            return obj  # scalars / strings ride through untouched
        if self._dev is None or t.device == self._dev:
            return NDArray(t)
        box[0] += t.numel() * t.element_size()
        if self._stream is None or t.device.type != "cpu":
            return NDArray(t.to(self._dev))
        host = t
        if not (t.is_pinned() and t.is_contiguous()):
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t)
        with torch.cuda.stream(self._stream):
            out = torch.empty(host.shape, dtype=host.dtype, device=self._dev)
            out.copy_(host, non_blocking=True)
        return NDArray(out)

    def _stage(self, batch):
        """``(batch on the device, event after its copies or None)``."""
        box = [0]
        t0 = time.perf_counter()
        out = self._convert_leaf(batch, box)
        from ...resilience import chaos as _chaos

        if _chaos.ENABLED and _chaos.nan_due("prefetch"):
            # an injected bad batch (MXTPU_CHAOS=nan@prefetch:N): the
            # float leaves of the Nth staged batch become NaN
            with torch.cuda.stream(self._stream) if self._stream \
                    is not None else _nullcontext():
                out = _chaos.poison_struct(out)
        event = None
        if self._stream is not None:
            event = torch.cuda.Event()
            event.record(self._stream)
        if _obs.ENABLED:
            _obs.record_h2d(box[0], time.perf_counter() - t0,
                            self._queue.qsize())
        return out, event

    # -- producer ---------------------------------------------------------
    def _produce(self, q, stop):
        def put(item):
            # bounded put that aborts promptly on close(): never leaves
            # the thread blocked on a full queue nobody will drain
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        try:
            if self._dev is not None and self._dev.type == "cuda":
                torch.cuda.set_device(self._dev)
            for batch in self._source:
                if stop.is_set():
                    return
                gen = self._placement_gen
                if not put(("ok", (gen,) + self._stage(batch))):
                    return
            put(("end", None))
        except BaseException as e:  # noqa: BLE001 - reaches next()
            put(("err", e))

    def _start_epoch(self):
        self.close()
        if self._exhausted and hasattr(self._source, "reset"):
            self._source.reset()
        self._exhausted = False
        self._delivered = 0
        with self._lifecycle_lock:
            self._stop = threading.Event()
            self._queue = queue.Queue(maxsize=self._depth)
            self._thread = threading.Thread(
                target=self._produce, args=(self._queue, self._stop),
                name="mxtpu-device-prefetch", daemon=True)
            self._thread.start()

    # -- consumer protocol ------------------------------------------------
    def __iter__(self):
        # iter() on an IN-FLIGHT epoch returns self untouched
        # (list(it)/enumerate(it) call iter again and must not restart:
        # close() would drop the staged batches); a fresh or exhausted
        # wrapper starts the next epoch
        if self._thread is None or self._exhausted:
            self._start_epoch()
        return self

    def _deliver(self, batch, event):
        """Order the consumer's stream after the batch's copies and tie
        the delivered tensors' memory to that stream."""
        if event is None:
            return batch
        stream = torch.cuda.current_stream(self._dev)
        stream.wait_event(event)
        for t in _leaf_tensors(batch):
            if t.device == self._dev:
                t.record_stream(stream)
        return batch

    def __next__(self):
        if self._exhausted:
            # stay exhausted until iter()/reset(), like any iterator:
            # restarting here would hand a consumer draining past the
            # epoch's end its batches again
            raise StopIteration
        if self._thread is None:
            self._start_epoch()
        t0 = time.perf_counter()
        kind, payload = self._queue.get()
        if _obs.ENABLED:
            _obs.DATA_PREFETCH_WAIT_SECONDS.inc(time.perf_counter() - t0)
            _obs.DATA_PREFETCH_QUEUE_DEPTH.set(self._queue.qsize())
        if kind == "ok":
            gen, batch, event = payload
            batch = self._deliver(batch, event)
            if gen != self._placement_gen:
                # staged before a repartition(): staged again, on the
                # consumer's thread, onto the current device
                batch, event = self._stage(batch)
                batch = self._deliver(batch, event)
            self._delivered += 1
            return batch
        self._exhausted = True
        self.close()
        if kind == "err":
            raise payload
        raise StopIteration

    def next(self):
        return self.__next__()

    def repartition(self, mesh=None, device=None, batch_axis=None,
                    world=None, rank=None):
        """Move the pipeline to another device without losing position:
        batches already staged are staged again onto ``device`` at
        delivery, and everything after lands there directly. A ``mesh``
        is ROADMAP A11's; re-sharding a streaming source (``world``/
        ``rank``) waits for its reader, ROADMAP A13."""
        if mesh is not None and device is not None:
            raise ValueError("pass device OR mesh, not both")
        if mesh is not None:
            raise MXNetError("DevicePrefetcher.repartition(mesh=...): "
                             "device meshes are ROADMAP A11's")
        if world is not None or rank is not None:
            raise MXNetError("DevicePrefetcher.repartition(world=, rank=): "
                             "streaming sources are ROADMAP A13's")
        if batch_axis is not None:
            self._batch_axis = batch_axis
        if device is not None:
            self._set_device(device)
        self._placement_gen += 1
        return self

    @property
    def cursor(self):
        """Batches delivered to the consumer this epoch (staged-ahead
        batches are not counted): the input position a checkpoint
        records."""
        return self._delivered

    def __len__(self):
        return len(self._source)

    def __getattr__(self, name):
        # transparent wrapper: provide_data / provide_label / batch_size /
        # ... fall through to the source (DataIter protocol consumers)
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self.__dict__["_source"], name)

    def reset(self):
        """DataIter-protocol reset: stop the in-flight epoch, reset the
        source (when it supports it), arm a fresh epoch."""
        self.close()
        if hasattr(self._source, "reset"):
            self._source.reset()
        self._exhausted = False

    def close(self):
        """Idempotent shutdown: unblock and join the producer thread. The
        thread and queue swap out under the lifecycle lock; the drain and
        the join run outside it."""
        if "_lifecycle_lock" not in self.__dict__:
            return  # partially-constructed instance (GC during __init__)
        with self._lifecycle_lock:
            thread, q, stop = self._thread, self._queue, self._stop
            self._thread = None
            self._queue = None
        if thread is None:
            return
        stop.set()
        while True:  # drain so a producer blocked on put() wakes up
            try:
                q.get_nowait()
            except queue.Empty:
                break
        thread.join(timeout=5.0)

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass


def _leaf_tensors(obj):
    """Every tensor behind the NDArray leaves of a batch."""
    if isinstance(obj, NDArray):
        return [obj.data]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _leaf_tensors(o)]
    if isinstance(obj, dict):
        return [t for o in obj.values() for t in _leaf_tensors(o)]
    if obj.__class__.__name__ == "DataBatch" and hasattr(obj, "data"):
        return _leaf_tensors(obj.data) + _leaf_tensors(obj.label or [])
    return []


def _stack_leaves(batches):
    """Leaf-wise stack of structurally identical batches into ``[K, ...]``
    arrays (tuple/list/dict/NDArray structure kept)."""
    first = batches[0]
    if isinstance(first, tuple) and hasattr(first, "_fields"):  # namedtuple
        return type(first)(*(_stack_leaves([b[i] for b in batches])
                             for i in range(len(first))))
    if isinstance(first, (list, tuple)):
        return type(first)(_stack_leaves([b[i] for b in batches])
                           for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _stack_leaves([b[k] for b in batches]) for k in first}
    if first.__class__.__name__ == "DataBatch" and hasattr(first, "data"):
        from ...io.io import DataBatch

        return DataBatch(
            data=_stack_leaves([b.data for b in batches]),
            label=_stack_leaves([b.label for b in batches]),
            pad=first.pad, index=first.index, bucket_key=first.bucket_key,
            provide_data=first.provide_data,
            provide_label=first.provide_label)
    if isinstance(first, NDArray):
        return NDArray(torch.stack([b.data for b in batches]))
    if isinstance(first, torch.Tensor):
        return torch.stack(list(batches))
    if hasattr(first, "shape"):
        return NDArray(torch.stack([torch.as_tensor(_np.asarray(b))
                                    for b in batches]))
    if isinstance(first, (int, float, str, bool, type(None))):
        return first  # scalar metadata: assumed slot-invariant
    raise TypeError(f"cannot stack batch leaf of type {type(first)!r}")


def stack_batches(batches):
    """Stack structurally identical batches into one batch whose every
    array leaf gains a leading ``[K]`` slot axis. Raises ``ValueError``
    on a shape or structure mismatch (pad partial batches first:
    ``DataLoader(last_batch="pad")``)."""
    if not batches:
        raise ValueError("stack_batches: empty batch list")
    try:
        return _stack_leaves(batches)
    except (RuntimeError, TypeError, ValueError, IndexError, KeyError) as e:
        raise ValueError(
            f"stack_batches: batches are not shape/structure stable "
            f"({e}); pad partial batches and bucket variable-length "
            f"inputs") from e


class SuperstepRing:
    """The K-deep staging ring of a training superstep.

    Wraps a batch source in a :class:`DevicePrefetcher` whose queue is at
    least ``k`` deep, so the thread stages the next superstep's K batches
    while the current one runs. Iterating yields ``(group, n)``: with
    ``n == k``, ``group`` is the stacked ``[K, ...]`` batch
    (:func:`stack_batches`); a short last group (the source ran out) is
    the list of its staged batches with ``n < k``, for the consumer to
    single-step.

    Error contract: a source or copy error reaches ``next()`` after the
    batches staged before it (a group interrupted by an error is yielded
    short, and the error is raised at the next ``next()``);
    ``KeyboardInterrupt`` and ``SystemExit`` are not deferred.
    ``close()`` is idempotent and joins the thread.

    >>> ring = SuperstepRing(loader, k=8, device=mx.gpu())
    >>> for group, n in ring:
    ...     if n == ring.k:
    ...         sstep.step(group[0], group[1], batch_size)
    """

    def __init__(self, source, k, device=None, mesh=None, depth=None):
        self.k = max(1, int(k))
        if isinstance(source, DevicePrefetcher):
            if device is not None or mesh is not None or depth is not None:
                raise ValueError(
                    "SuperstepRing: device/mesh/depth apply only when "
                    "the ring builds its own prefetcher; configure them "
                    "on the DevicePrefetcher you passed in")
            if source._depth < self.k:
                import logging

                logging.getLogger(__name__).warning(
                    "SuperstepRing: wrapped DevicePrefetcher depth %d "
                    "< k=%d: the next superstep's batches cannot all "
                    "stage while the current one runs; build the "
                    "prefetcher with depth >= k", source._depth, self.k)
            self._pf = source
            self._own = False
        else:
            d = depth if depth is not None \
                else self.k + (prefetch_depth() or _DEPTH_DEFAULT)
            self._pf = DevicePrefetcher(source, device=device, mesh=mesh,
                                        depth=d)
            self._own = True
        self._err = None

    def __iter__(self):
        iter(self._pf)
        return self

    def __next__(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise err
        group = []
        for _ in range(self.k):
            try:
                group.append(next(self._pf))
            except StopIteration:
                break
            except Exception as e:
                if not group:
                    raise
                self._err = e
                break
        if not group:
            raise StopIteration
        if self._err is not None or len(group) < self.k:
            return group, len(group)
        return stack_batches(group), self.k

    @property
    def cursor(self):
        """Batches delivered through the ring this epoch (a stacked group
        counts its K): the input position a checkpoint records."""
        return self._pf.cursor

    def repartition(self, mesh=None, device=None, batch_axis=None,
                    world=None, rank=None):
        """Delegate to the prefetcher; the cursor is kept."""
        self._pf.repartition(mesh=mesh, device=device,
                             batch_axis=batch_axis, world=world, rank=rank)
        return self

    def reset(self):
        self._err = None
        self._pf.reset()

    def close(self):
        if self._own:
            self._pf.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass


def wrap_for_fit(source, ctx=None, depth=None):
    """Wrap a fit loop's training data in a DevicePrefetcher (the
    estimator / ``Module.fit`` seam). Returns ``source`` unchanged when
    prefetch is off (``MXTPU_DEVICE_PREFETCH=0``) or it already stages to
    a device."""
    d = depth if depth is not None else prefetch_depth()
    if d <= 0 or isinstance(source, DevicePrefetcher):
        return source
    if getattr(source, "_device", None) is not None:
        # DataLoader(device=...) already prefetches: a second wrapper
        # would stage every batch twice
        return source
    device = ctx if isinstance(ctx, Context) else None
    return DevicePrefetcher(source, device=device, depth=d)
