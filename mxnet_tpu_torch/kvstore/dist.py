"""``dist_tpu_sync``: the synchronous data-parallel store over
``torch.distributed``.

PyTorch counterpart of ``mxnet_tpu/kvstore/dist.py``. There are no
server processes: every worker is one rank of a ``torch.distributed``
world, one process per device (the multi-controller design of
``parallel/mesh.py``), bootstrapped by :func:`init_distributed` from the
launcher's environment contract (``tools/launch.py`` sets
``MXTPU_COORDINATOR``, ``MXTPU_NUM_PROCESSES`` and ``MXTPU_PROCESS_ID``).
``pushpull`` sums each key (or each flat bucket of keys) across the ranks
with one ``all_reduce``; ``init`` broadcasts rank 0's value; ``rank`` and
``num_workers`` are the process group's. In a world of one every
reduction is the identity.

The backend is NCCL when the rank's device is a CUDA card and gloo on
the host, unless ``init_distributed(backend=...)`` names one. A group
NCCL cannot form raises with NCCL's own words: nothing switches backend
on its own. (NCCL refuses two ranks on one card, "Duplicate GPU
detected"; two ranks sharing the one card of a machine name gloo, whose
collectives take CUDA tensors through the host.)
"""

from __future__ import annotations

import datetime
import logging
import threading

import torch

from ..base import MXNetError, getenv
from ..ndarray.ndarray import NDArray
from .base import register_kvstore
from .local import KVStoreLocal

_logger = logging.getLogger("mxnet_tpu_torch.kvstore.dist")

def _dist():
    import torch.distributed as dist

    return dist


def _world():
    """``(rank, size)``: ``(0, 1)`` without a process group."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier_timeout_s() -> float:
    """``MXTPU_BARRIER_TIMEOUT_S`` (default 600): how long one barrier may
    block before it fails loudly instead of hanging (a peer that is gone
    never arrives). 0 disables the watchdog."""
    return float(getenv("MXTPU_BARRIER_TIMEOUT_S", 600.0, dtype=float))


class CollectiveTimeoutError(MXNetError):
    """A collective's watchdog expired: a peer is gone. Never retried:
    the abandoned watchdog thread may still be blocked in the original
    call."""


def _call_with_timeout(fn, timeout, desc):
    """Run ``fn`` on a worker thread and wait at most ``timeout`` seconds;
    a hang raises :class:`CollectiveTimeoutError` (the stuck daemon
    thread is abandoned: the caller is expected to fail)."""
    if not timeout or timeout <= 0:
        return fn()
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # surfaced on the caller's thread
            box["err"] = e

    t = threading.Thread(target=run, daemon=True,
                         name="mxtpu-collective-watchdog")
    t.start()
    t.join(timeout)
    if t.is_alive():
        rank, size = _world()
        _logger.error("%s timed out after %.0fs: a peer process is gone; "
                      "failing loudly instead of hanging "
                      "(MXTPU_BARRIER_TIMEOUT_S)", desc, timeout)
        raise CollectiveTimeoutError(
            f"{desc} timed out after {timeout:.0f}s (rank {rank}/{size})")
    if "err" in box:
        raise box["err"]
    return box.get("out")


def reset_world():
    """The reference's hook for a world torn down and formed anew: it
    drops its cached reduce mesh. The port caches nothing about the
    world (every collective reads the current process group), so there is
    nothing to drop."""


def _comm_device():
    """Where a tensor made only to be communicated lives: the rank's card
    under NCCL, the host otherwise."""
    if _dist().get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _accum_sum_(t, group=None):
    """Sum ``t`` across the ranks of ``group`` in place. bfloat16 and
    float16 payloads go on the wire in their own type and are added in
    float32 (gathered, then summed here): a low-precision sum over many
    ranks would lose low bits at every hop."""
    dist = _dist()
    if t.dtype in (torch.bfloat16, torch.float16):
        n = dist.get_world_size(group)
        rows = torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                           device=t.device)
        dist.all_gather_into_tensor(rows, t.contiguous(), group=group)
        t.copy_(rows.float().sum(0).to(t.dtype))
        return t
    dist.all_reduce(t, group=group)
    return t


def _global_allreduce(raw):
    """``raw`` summed across every rank: a new tensor (``raw`` itself in
    a world of one)."""
    if _world()[1] == 1:
        return raw
    return _accum_sum_(raw.detach().clone())


def all_gather_bytes(payload: bytes) -> list:
    """One opaque byte blob from every rank, as a list indexed by rank
    (``[payload]`` in a world of one). Call it where every rank reaches
    the same point in the same order; both collectives run under the
    ``MXTPU_BARRIER_TIMEOUT_S`` watchdog."""
    payload = bytes(payload)
    rank, n = _world()
    if n == 1:
        return [payload]
    dist = _dist()
    dev = _comm_device()
    timeout = _barrier_timeout_s()
    lens = torch.zeros(n, dtype=torch.int64, device=dev)

    def gather_lengths():
        dist.all_gather_into_tensor(
            lens, torch.tensor([len(payload)], dtype=torch.int64,
                               device=dev))
        return lens.cpu()

    lengths = _call_with_timeout(gather_lengths, timeout,
                                 "all_gather_bytes (lengths)")
    width = max(int(lengths.max()), 1)
    mine = torch.zeros(width, dtype=torch.uint8)
    if payload:
        mine[:len(payload)] = torch.frombuffer(bytearray(payload),
                                               dtype=torch.uint8)
    rows = torch.empty(n * width, dtype=torch.uint8, device=dev)

    def gather_payloads():
        dist.all_gather_into_tensor(rows, mine.to(dev))
        return rows.cpu().reshape(n, width)

    got = _call_with_timeout(gather_payloads, timeout,
                             "all_gather_bytes (payload)")
    return [bytes(got[i, :int(lengths[i])].numpy().tobytes())
            for i in range(n)]


@register_kvstore("dist_tpu_sync")
class KVStoreDistTPU(KVStoreLocal):
    """Synchronous data-parallel store over the ranks of the
    ``torch.distributed`` world."""

    def __init__(self):
        super().__init__()
        self._barrier_count = 0

    @property
    def rank(self):
        return _world()[0]

    @property
    def num_workers(self):
        return _world()[1]

    def init(self, key, value):
        """Init with rank 0's value on every rank (reference: worker 0
        pushes the init value; the others pull it). A list of keys is
        broadcast in flat buckets (``MXTPU_BUCKET_BYTES``), one
        ``broadcast`` each, not one per key."""
        if not isinstance(key, (list, tuple)):
            key, value = [key], [value]
        if _world()[1] > 1:
            value = self._broadcast(list(value))
        for k, v in zip(key, value):
            super().init(k, v)

    def _broadcast(self, values):
        """Rank 0's ``values``, one ``broadcast`` per bucket of the plan
        (keys in their order; one device and type a bucket)."""
        from .. import fusedstep as _fusedstep
        from ..parallel import overlap as _overlap

        raws = [v.data.detach() for v in values]
        plan = _overlap.build_bucket_plan(
            [tuple(r.shape) for r in raws],
            [f"{r.device}/{str(r.dtype).split('.')[1]}" for r in raws],
            order=list(range(len(raws))),
            bucket_bytes=max(_fusedstep.bucket_bytes(), 1),
            itemsizes=[r.element_size() for r in raws])
        out = [None] * len(raws)
        for bi in range(len(plan.buckets)):
            b = _overlap.pack_bucket(plan, bi, raws, False).clone()
            _dist().broadcast(b, 0)
            _overlap.unpack_bucket(plan, bi, b, out, False)
        return [NDArray(t, v.context) for t, v in zip(out, values)]

    def _reduce(self, key, merged):
        if _world()[1] > 1:
            return NDArray(_global_allreduce(merged.data), merged.context)
        return merged

    def _reduce_raw(self, raw):
        """One ``all_reduce`` of one flat gradient bucket (``_reduce`` is
        one per key)."""
        if _world()[1] > 1:
            return _accum_sum_(raw)
        return raw

    def _reduce_raw_is_identity(self):
        return _world()[1] == 1

    def barrier(self):
        """Barrier of every rank, under the ``MXTPU_BARRIER_TIMEOUT_S``
        watchdog and with ``MXTPU_BARRIER_RETRIES`` tries with backoff for
        failures that return; a timeout raises
        :class:`CollectiveTimeoutError` at once (the peers are gone)."""
        if _world()[1] == 1:
            return
        from .. import runtime

        tag = f"mxtpu_kv_barrier_{self._barrier_count}"
        timeout = _barrier_timeout_s()
        runtime.retry_with_backoff(
            lambda: _call_with_timeout(_dist().barrier, timeout,
                                       f"kvstore barrier {tag!r}"),
            attempts=int(getenv("MXTPU_BARRIER_RETRIES", 3, dtype=int)),
            base_delay=0.5, desc=f"kvstore barrier {tag!r}",
            no_retry=(CollectiveTimeoutError,), logger=_logger)
        self._barrier_count += 1


def _default_backend():
    return "nccl" if torch.cuda.is_available() else "gloo"


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, **kwargs):
    """Join the ``torch.distributed`` world of this job.

    The arguments default to the launcher's environment contract
    (``MXTPU_COORDINATOR`` = ``host:port`` of rank 0,
    ``MXTPU_NUM_PROCESSES``, ``MXTPU_PROCESS_ID``), so a worker under
    ``tools/launch.py`` calls ``init_distributed()``. ``kwargs`` go to
    ``torch.distributed.init_process_group`` (``backend``, ``timeout``
    in seconds or a ``timedelta``, ...); the rendezvous is retried with
    backoff (``MXTPU_DIST_INIT_ATTEMPTS``, default 3). The backend
    defaults to NCCL when the rank's device is a CUDA card, gloo on the
    host. In a world of several ranks, each owns card ``rank %
    device_count``, which ``mx.gpu(0)`` then names. A NCCL group is formed
    at once (one small ``all_reduce``): if NCCL refuses it, this raises
    :class:`MXNetError` with NCCL's words, and nothing falls back to
    another backend. Returns the backend's name."""
    from .. import context, runtime

    if coordinator_address is None:
        coordinator_address = getenv("MXTPU_COORDINATOR")
    if num_processes is None:
        num_processes = getenv("MXTPU_NUM_PROCESSES", 1, dtype=int)
    if process_id is None:
        process_id = getenv("MXTPU_PROCESS_ID", 0, dtype=int)
    if coordinator_address is None:
        raise MXNetError(
            "init_distributed: no coordinator; run under tools/launch.py or "
            "set MXTPU_COORDINATOR=<host:port>, MXTPU_NUM_PROCESSES and "
            "MXTPU_PROCESS_ID")
    num_processes, process_id = int(num_processes), int(process_id)
    backend = kwargs.pop("backend", None) or _default_backend()
    timeout = kwargs.pop("timeout", None)
    if timeout is not None and not isinstance(timeout, datetime.timedelta):
        timeout = datetime.timedelta(seconds=float(timeout))
    if timeout is not None:
        kwargs["timeout"] = timeout
    card = None
    if torch.cuda.is_available():
        card = process_id % torch.cuda.device_count()
        torch.cuda.set_device(card)
        if num_processes > 1:
            context.set_local_card(card)
    if backend == "nccl":
        if card is None:
            raise MXNetError("init_distributed: backend 'nccl' needs a CUDA "
                             "card; this process has none")
        kwargs.setdefault("device_id", torch.device("cuda", card))
    dist = _dist()
    try:
        runtime.retry_with_backoff(
            lambda: dist.init_process_group(
                backend, init_method=f"tcp://{coordinator_address}",
                world_size=num_processes, rank=process_id, **kwargs),
            attempts=int(getenv("MXTPU_DIST_INIT_ATTEMPTS", 3, dtype=int)),
            base_delay=2.0, desc="torch.distributed.init_process_group",
            no_retry=(dist.DistBackendError,), logger=_logger)
        if backend == "nccl":
            probe = torch.ones(1, device=torch.device("cuda", card))
            dist.all_reduce(probe)
            torch.cuda.synchronize(card)
    except dist.DistBackendError as e:
        if dist.is_initialized():
            dist.destroy_process_group()
        context.set_local_card(None)
        raise MXNetError(
            f"init_distributed: {backend} could not form the group of "
            f"{num_processes} rank(s): {e}") from e
    return backend


def shutdown_distributed():
    """Leave the world (``destroy_process_group``); ``mx.gpu(0)`` names
    card 0 again."""
    from .. import context

    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    context.set_local_card(None)
