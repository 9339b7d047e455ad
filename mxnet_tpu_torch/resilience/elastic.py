"""Live elasticity: grow/shrink a RUNNING job without a restart.

PyTorch counterpart of ``mxnet_tpu/resilience/elastic.py``: the same
module functions, :class:`MembershipMonitor`, :func:`snapshot_descriptor`
(format ``mxtpu-snapshot-v1``) and :class:`ElasticTrainer`, with the
reference's signal rules, metrics and trace event.

The port is multi-controller (one process per rank, joined by
``torch.distributed``), so where the reference's single controller holds
a list of devices, the port holds a list of the world's ranks, each
owning its card:

- ``devices`` / ``device_pool`` are rank ids (default: every rank of the
  world) and ``min_devices`` counts ranks. A topology is a data-parallel
  ``parallel.make_mesh({"dp": n}, devices=ranks)``, built on every rank
  of the pool (its groups are collective over the world,
  ``parallel/mesh.py``), so in a world of several ranks the pool is the
  whole world.
- Every rank of the pool calls :meth:`ElasticTrainer.step` every step
  with the same global batch. A rank outside the current topology runs
  no forward or backward; it receives the step's loss from the
  topology's first rank (one broadcast over the pool), so ``step``
  returns the same value on every rank, and its ``committed_steps``
  moves with the others.
- **Agreement on signals.** Each rank has its own monitor: a preemption
  notice file may be seen on one host, a straggler's latency measured
  on another. At every step boundary each pool rank's drained signals,
  and its heartbeat latency when the straggler policy probes, are
  exchanged in one small collective over the pool
  (``kvstore.dist.all_gather_bytes``) and merged in one fixed order (by
  rank, then by enqueue order); the latencies are fed to every rank's
  monitor in rank order, so the straggler verdicts agree too. Every
  rank thus computes the same new topology. In a pool of one rank no
  collective is added.
- **Resize**, in order: the old topology's members take
  ``spmd_state_snapshot`` of their blocks; the blocks each one writes
  (together they tile every tensor once) are gathered on every pool
  rank, so a rank of the new topology gets the ZeRO shards the leaving
  ranks held; the new topology's cached or new ``SPMDTrainStep``
  restores them (``spmd_restore_chunks``) in its own layout;
  ``kvstore.dist.reset_world``; an attached ``DevicePrefetcher`` or
  ``SuperstepRing`` is repartitioned with its cursor kept. The restored
  state is bit for bit the state the old topology produced: no
  committed step is lost or run twice. Returning to a topology seen
  before reuses its cached step object (``warm``; torch compiles
  nothing, so warm means its mesh, groups and mode are reused).
- **A dead peer.** As in the reference, the kvstore barrier watchdog's
  ``CollectiveTimeoutError`` calls :func:`notify_dead_peer` with no rank
  and raises; an eviction needs a rank (``report_dead_peer(rank)``, a
  notice ``evict:<rank>``, or the straggler policy). A dead process is
  not recovered here.

The Gluon (kvstore) training path has no mesh to rebuild; there the
monitor's pause points (``Trainer.step`` / ``Superstep.step`` call
:func:`pause_point` behind one module-bool read) turn a preemption
notice into a proactive asynchronous checkpoint at the next step
boundary.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import threading
import time
import zlib
from collections import deque

from .. import fusedstep as _fusedstep
from .. import observability as _obs
from ..base import MXNetError, getenv
from . import chaos as _chaos

_logger = logging.getLogger("mxnet_tpu_torch.elastic")

#: THE pause-point switch (``MXTPU_ELASTIC``, default off, or armed when
#: a MembershipMonitor attaches): when False, the Trainer/Superstep
#: step-boundary hooks cost one module-bool read.
ENABLED = _fusedstep.elastic_enabled()

_ACTIVE = None  # the attached MembershipMonitor (module singleton)

DESCRIPTOR_FORMAT = "mxtpu-snapshot-v1"


def straggler_factor():
    """``MXTPU_STRAGGLER_FACTOR`` (default 0 = straggler detection
    off): a rank whose recent mean barrier/heartbeat latency exceeds
    ``factor x`` the median of the OTHER ranks' (and the absolute
    floor, see :class:`MembershipMonitor`) is flagged for proactive
    eviction."""
    return float(getenv("MXTPU_STRAGGLER_FACTOR", 0.0, dtype=float))


def notice_path():
    """``MXTPU_PREEMPT_NOTICE``: path of the preemption-notice file the
    monitor polls (a scheduler integration touches the file, optionally
    writing ``shrink:<n>`` / ``grow:<n>`` / ``evict:<rank>``)."""
    return getenv("MXTPU_PREEMPT_NOTICE", None)


def monitor():
    """The attached :class:`MembershipMonitor`, or None."""
    return _ACTIVE


def set_enabled(on):
    """Arm/disarm the step-boundary pause points at runtime; returns
    the previous state."""
    global ENABLED
    prev, ENABLED = ENABLED, bool(on)
    return prev


def observe_barrier(rank, seconds):
    """Feed one barrier-latency sample into the active monitor's
    histogram (the kvstore barrier calls this after every timed sync
    when elasticity is armed)."""
    if _ACTIVE is not None:
        _ACTIVE.observe_latency(rank, seconds)


def notify_dead_peer(rank=None, detail=""):
    """A collective/barrier watchdog diagnosed a dead peer: queue the
    membership-change signal (called right before
    ``CollectiveTimeoutError`` propagates)."""
    if _ACTIVE is not None:
        _ACTIVE.report_dead_peer(rank=rank, detail=detail)


def pause_point(site, trainer=None):
    """Safe elasticity pause point at a training-step boundary.

    ``Trainer.step`` / ``Superstep.step`` call this behind one
    module-bool read (``ENABLED``), so membership signals are only ever
    processed where pausing is safe. On the Gluon/kvstore path there is
    no mesh to rebuild: a pending preemption notice turns into a
    proactive asynchronous checkpoint through the trainer's attached
    :class:`~mxnet_tpu_torch.resilience.checkpoint.CheckpointManager`.
    Resize signals stay queued for an elastic controller
    (:class:`ElasticTrainer` drains them at ITS step boundary)."""
    mon = _ACTIVE
    if mon is None:
        return
    mon.poll()
    sigs = mon.drain(kinds=("preempt",))
    if not sigs or trainer is None:
        return
    mgr = getattr(trainer, "_ckpt_manager", None)
    if mgr is not None:
        mgr.save_async(reason="preempt_notice")
        _logger.warning(
            "elastic: preemption notice — proactive checkpoint queued "
            "at the %s step boundary", site)
    else:
        _logger.warning(
            "elastic: preemption notice at the %s step boundary, but "
            "no CheckpointManager is attached — nothing to save "
            "proactively (MXTPU_CHECKPOINT?)", site)


class MembershipMonitor:
    """Membership-change detection + straggler policy.

    Signals are plain dicts ``{"kind", "reason", "target", "rank",
    "detail"}`` with kinds ``preempt`` / ``dead_peer`` / ``straggler``
    / ``resize``; producers enqueue from any thread, a controller
    drains them at a step boundary.

    The straggler policy is fed by :meth:`observe_latency` (barrier wait
    times from the kvstore barrier, or the elastic trainer's per-rank
    heartbeat probes, exchanged across the pool) into a rolling per-rank
    window. A rank is flagged once when its mean exceeds
    ``straggler_factor x`` the median of the OTHER ranks' means AND the
    absolute floor ``min_latency_s``, with at least ``min_samples``
    samples per rank.
    """

    def __init__(self, straggler_factor=None, notice_path=None,
                 window=32, min_samples=3, min_latency_s=0.01):
        self.straggler_factor = (
            globals()["straggler_factor"]() if straggler_factor is None
            else float(straggler_factor))
        self._notice = (globals()["notice_path"]()
                        if notice_path is None else notice_path)
        self._notice_seen = None
        self._window = int(window)
        self._min_samples = int(min_samples)
        self._min_latency_s = float(min_latency_s)
        self._lock = threading.Lock()
        self._signals = []
        self._lat = {}       # rank -> deque of recent latencies
        self._flagged = set()

    # -- lifecycle -------------------------------------------------------
    def attach(self):
        """Become THE active monitor: the kvstore barrier and the
        Trainer/Superstep pause points feed/drain this instance. Arms
        ``ENABLED``. Returns self."""
        global _ACTIVE
        _ACTIVE = self
        set_enabled(True)
        return self

    def detach(self):
        global _ACTIVE
        if _ACTIVE is self:
            _ACTIVE = None
            set_enabled(_fusedstep.elastic_enabled())

    # -- signal producers ------------------------------------------------
    def _enqueue(self, sig):
        with self._lock:
            self._signals.append(sig)
        _logger.warning("elastic: membership signal %s", sig)

    def notify_preempt(self, detail="", target=None):
        """A preemption notice arrived (file poll, SIGTERM chain, or a
        scheduler integration calling this directly)."""
        self._enqueue({"kind": "preempt", "reason": "preempt",
                       "target": target, "rank": None, "detail": detail})

    def report_dead_peer(self, rank=None, detail=""):
        self._enqueue({"kind": "dead_peer", "reason": "dead_peer",
                       "target": None, "rank": rank, "detail": detail})

    def request_resize(self, target, reason="manual"):
        """Ask for a resize to ``target`` ranks (spot add = a target
        above the current extent; chaos ``resize`` faults land here)."""
        self._enqueue({"kind": "resize", "reason": reason,
                       "target": int(target), "rank": None, "detail": ""})

    def poll(self):
        """Check the preemption-notice file (``MXTPU_PREEMPT_NOTICE``):
        a new mtime/size enqueues one signal. File contents steer it:
        empty = plain preemption notice (proactive checkpoint),
        ``shrink:<n>``/``grow:<n>`` = resize to n, ``evict:<rank>`` =
        drop one rank."""
        p = self._notice
        if not p:
            return
        try:
            st = os.stat(p)
        except OSError:
            return
        tag = (st.st_mtime_ns, st.st_size)
        if tag == self._notice_seen:
            return
        self._notice_seen = tag
        try:
            with open(p) as f:
                body = f.read().strip()
        except OSError:
            body = ""
        kind, _, arg = body.partition(":")
        if kind in ("shrink", "grow") and arg.strip().isdigit():
            self.request_resize(int(arg), reason="notice")
        elif kind == "evict" and arg.strip().isdigit():
            self._enqueue({"kind": "dead_peer", "reason": "notice",
                           "target": None, "rank": int(arg),
                           "detail": body})
        else:
            self.notify_preempt(detail=body or p)

    # -- straggler policy ------------------------------------------------
    def observe_latency(self, rank, seconds):
        """One barrier/heartbeat latency sample for ``rank``; feeds the
        histogram and (when the policy is armed) may enqueue a one-shot
        ``straggler`` signal for that rank."""
        rank = int(rank)
        with self._lock:
            dq = self._lat.setdefault(rank, deque(maxlen=self._window))
            dq.append(float(seconds))
        if _obs.ENABLED:
            _obs.ELASTIC_PEER_LATENCY_SECONDS.observe(
                float(seconds), rank=str(rank))
        if self.straggler_factor <= 0 or rank in self._flagged:
            return
        if rank in self.straggler_ranks():
            self._flagged.add(rank)
            self._enqueue({"kind": "straggler", "reason": "straggler",
                           "target": None, "rank": rank,
                           "detail": f"mean latency {self._mean(rank):.4f}s"})

    def _mean(self, rank):
        dq = self._lat.get(rank)
        return sum(dq) / len(dq) if dq else 0.0

    def straggler_ranks(self):
        """Ranks currently over the policy line (see class docstring).
        Pure read: enqueuing happens in :meth:`observe_latency`."""
        with self._lock:
            means = {r: sum(d) / len(d) for r, d in self._lat.items()
                     if len(d) >= self._min_samples}
        if self.straggler_factor <= 0 or len(means) < 2:
            return []
        out = []
        for r, m in means.items():
            others = sorted(v for rr, v in means.items() if rr != r)
            med = others[len(others) // 2]
            if m > self.straggler_factor * max(med, 1e-9) \
                    and m > self._min_latency_s:
                out.append(r)
        return out

    def reset_latency(self):
        """Forget all latency windows + straggler flags (rank indices
        remap after every resize, so stale samples would be attributed
        to the wrong rank)."""
        with self._lock:
            self._lat.clear()
        self._flagged.clear()

    # -- consumers -------------------------------------------------------
    def pending(self):
        with self._lock:
            return list(self._signals)

    def drain(self, kinds=None):
        """Pop (and return) pending signals: all of them, or only the
        given kinds (the pause points take just ``preempt``, leaving
        resizes for the elastic controller)."""
        with self._lock:
            if kinds is None:
                out, self._signals = self._signals, []
            else:
                out = [s for s in self._signals if s["kind"] in kinds]
                self._signals = [s for s in self._signals
                                 if s["kind"] not in kinds]
        return out


def _spans(idx):
    """A chunk's index as ``((start, stop), ...)``: the port's snapshots
    carry pairs, the reference's slices."""
    return tuple((sl.start, sl.stop) if isinstance(sl, slice)
                 else (int(sl[0]), int(sl[1])) for sl in idx)


def snapshot_descriptor(chunks, extents=None, step=None, reason="resize",
                        from_devices=None, to_devices=None, cursor=None):
    """Auditable descriptor of an in-memory snapshot: per-chunk
    shape/dtype/nbytes/CRC32 plus opt-state completeness info, what a
    resize hands over, minus the payload. ``verify_descriptor`` (and
    ``tools/verify_checkpoint.py --from-json``) lint it. ``chunks`` is
    ``{key: [(index, array)]}``, an index being the port's ``(start,
    stop)`` pairs or the reference's slices; the same chunks give the
    reference's descriptor."""
    import numpy as onp

    tensors = {}
    opt_leaves = {}
    param_names = []
    for key in sorted(chunks):
        for idx, data in chunks[key]:
            host = onp.asarray(data)
            spans = ";".join(f"{a}:{b}" for a, b in _spans(idx))
            tensors[f"{key}|{spans}"] = {
                "shape": list(host.shape),
                "dtype": str(host.dtype),
                "nbytes": int(host.nbytes),
                "crc32": zlib.crc32(host.tobytes()) & 0xFFFFFFFF}
        if key.startswith("opt::"):
            name, _, li = key[len("opt::"):].rpartition("::")
            opt_leaves[name] = max(opt_leaves.get(name, 0), int(li) + 1)
        elif key.startswith("param::"):
            param_names.append(key[len("param::"):])
    return {"format": DESCRIPTOR_FORMAT, "kind": "spmd-snapshot",
            "step": None if step is None else int(step),
            "reason": reason,
            "cursor": (None if cursor is None else
                       dict(cursor) if isinstance(cursor, dict) else
                       int(cursor)),
            "topology": {"from_devices": from_devices,
                         "to_devices": to_devices},
            "residual_extents": {k: int(v)
                                 for k, v in (extents or {}).items()},
            "extras": {"opt_leaves": opt_leaves,
                       "param_names": param_names},
            "tensors": tensors}


class ElasticTrainer:
    """The runtime-elasticity control loop around ``SPMDTrainStep``.

    >>> et = ElasticTrainer(net, loss_fn, "adam", {}, zero_stage=2)
    >>> for x, y in stream:
    ...     loss = et.step(x, y, lr=0.01)   # resizes happen HERE,
    ...                                     # at step boundaries

    Every rank of the pool calls it with the same GLOBAL batch (whose
    size every rank count the job may resize through divides);
    ``shard_batch`` gives each member its rows of whatever topology is
    current. One :class:`MembershipMonitor` per rank drives membership;
    chaos ``resize`` faults are polled per boundary when armed, so the
    whole loop is chaos-certifiable. See the module docstring for what
    the multi-controller port adds.
    """

    def __init__(self, block, loss_fn, optimizer="sgd",
                 optimizer_params=None, devices=None, device_pool=None,
                 batch_axis="dp", monitor=None, min_devices=1,
                 ring=None, on_resize=None, heartbeat_every=1,
                 **step_kwargs):
        from ..parallel.mesh import world

        self.block = block
        self.loss_fn = loss_fn
        self._optimizer = optimizer
        self._hyper = dict(optimizer_params or {})
        self._batch_axis = batch_axis
        self._kwargs = dict(step_kwargs)
        self._rank, size = world()
        self._pool = [int(r) for r in (device_pool if device_pool
                                       is not None else range(size))]
        self._devices = [int(r) for r in (devices if devices is not None
                                          else self._pool)]
        if not self._devices:
            raise MXNetError("ElasticTrainer: empty device set")
        if self._rank not in self._pool:
            raise MXNetError(f"ElasticTrainer: rank {self._rank} is not in "
                             f"the pool {self._pool}")
        if not set(self._devices) <= set(self._pool):
            raise MXNetError(f"ElasticTrainer: ranks {self._devices} are "
                             f"not all in the pool {self._pool}")
        if size > 1 and sorted(self._pool) != list(range(size)):
            raise MXNetError(
                f"ElasticTrainer: the pool {self._pool} must be the world's "
                f"{size} ranks (every rank joins each topology's groups)")
        self._meshes = {}  # topology key -> Mesh, made on every pool rank
        self._min_devices = max(1, int(min_devices))
        self._monitor = monitor if monitor is not None \
            else MembershipMonitor()
        self._monitor.attach()
        self._steps = {}  # topology key -> SPMDTrainStep (warm re-entry)
        self._step_obj = self._get_step(self._devices)
        self._committed = 0
        self._ring = ring
        self._on_resize = on_resize
        self._heartbeat_every = max(1, int(heartbeat_every))
        self._hb_x = None
        self.resize_events = []
        self.last_descriptor = None
        self.last_snapshot = None
        if _obs.ENABLED:
            _obs.ELASTIC_WORLD_SIZE.set(len(self._devices))

    # -- topology --------------------------------------------------------
    @property
    def devices(self):
        """The ranks of the current topology."""
        return list(self._devices)

    @property
    def committed_steps(self):
        """Training steps completed (committed) so far: continues
        monotonically across resizes, on every rank of the pool."""
        return self._committed

    @property
    def spmd_step(self):
        """The live ``SPMDTrainStep`` of the current topology (None on a
        rank outside it)."""
        return self._step_obj

    @property
    def monitor(self):
        return self._monitor

    @property
    def is_member(self):
        """Does this rank train in the current topology."""
        return self._rank in self._devices

    def _topo_key(self, devices):
        return tuple(devices)

    def _get_step(self, devices):
        """The topology's step: cached, or built on its members (None
        elsewhere). Its mesh is made on every pool rank: the groups are
        collective."""
        key = self._topo_key(devices)
        if key not in self._meshes:
            from ..parallel.mesh import make_mesh

            self._meshes[key] = make_mesh({self._batch_axis: len(devices)},
                                          devices=list(devices))
        if self._rank not in devices:
            return None
        st = self._steps.get(key)
        if st is None:
            from ..parallel.spmd import SPMDTrainStep

            st = SPMDTrainStep(self.block, self.loss_fn, self._optimizer,
                               dict(self._hyper), mesh=self._meshes[key],
                               batch_axis=self._batch_axis, **self._kwargs)
            self._steps[key] = st
        return st

    # -- collectives over the pool -----------------------------------------
    def _gather(self, obj):
        """Every pool rank's ``obj`` in rank order (one
        ``all_gather_bytes`` over the pool; ``[obj]`` in a pool of one)."""
        if len(self._pool) == 1:
            return [obj]
        from ..kvstore.dist import all_gather_bytes

        blobs = all_gather_bytes(pickle.dumps(obj, protocol=4))
        return [pickle.loads(b) for b in blobs]

    def _share_loss(self, loss):
        """The step's loss from the topology's first rank to every pool
        rank outside the topology (one broadcast over the pool, in
        float64: the member's float32 loss converts exactly)."""
        import torch
        import torch.distributed as dist

        from ..kvstore.dist import _comm_device

        src = self._devices[0]
        dev = _comm_device()
        if self.is_member:
            t = loss.detach().reshape(1).to(dev, torch.float64)
        else:
            t = torch.empty(1, dtype=torch.float64, device=dev)
        dist.broadcast(t, src=src)
        return loss if self.is_member else t[0]

    # -- the control loop ------------------------------------------------
    def step(self, x, y, lr=0.01, sync=True):
        """One training step, with membership processed at the boundary
        FIRST: chaos ``resize`` faults, heartbeat/straggler probing, the
        preemption-notice poll, the pool's agreement on the signals, then
        any pending resize; and only then the step on whatever topology is
        now current (on its members; the others receive its loss)."""
        if _chaos.ENABLED:
            target = _chaos.resize_due("elastic")
            if target is not None:
                self._monitor.request_resize(target, reason="chaos")
        latency = None
        if self._monitor.straggler_factor > 0 \
                and len(self._devices) > self._min_devices \
                and self._committed % self._heartbeat_every == 0:
            latency = self._heartbeat()
        self._monitor.poll()
        sigs = self._agree(self._monitor.drain(), latency)
        if sigs:
            self._apply_signals(sigs)
        loss = None
        if self.is_member:
            loss = self._step_obj(x, y, lr=lr, sync=False)
        if set(self._devices) != set(self._pool):
            loss = self._share_loss(loss)
        self._committed += 1
        return float(loss) if sync else loss

    def _heartbeat(self):
        """This rank's health probe: a tiny host->device copy, timed (the
        multi-controller analog of the reference's per-device probes).
        Chaos ``stall@rank<k>`` faults stall the probe of the topology's
        k-th rank inside the timed window. Returns the seconds (None on a
        rank outside the topology)."""
        import torch

        if not self.is_member:
            return None
        if self._hb_x is None:
            self._hb_x = torch.zeros(8, dtype=torch.float32)
        dev = self._step_obj._device
        k = self._devices.index(self._rank)
        t0 = time.perf_counter()
        if _chaos.ENABLED:
            _chaos.step_point(f"rank{k}")
        out = self._hb_x.to(dev)
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        return time.perf_counter() - t0

    def _agree(self, sigs, latency):
        """The pool's merged signals: every rank's drained ``sigs`` and
        heartbeat ``latency`` exchanged (one collective over the pool),
        the latencies fed to this rank's monitor in rank order (so its
        straggler verdicts match every other rank's), the signals merged
        by rank, then enqueue order, then the straggler signals those
        latencies raised."""
        if len(self._pool) == 1:
            if latency is not None:
                self._monitor.observe_latency(0, latency)
            return sigs + self._monitor.drain()
        merged = []
        for rank, (their_sigs, lat) in zip(
                self._pool, self._gather((sigs, latency))):
            merged.extend(their_sigs)
            if lat is not None and rank in self._devices:
                self._monitor.observe_latency(self._devices.index(rank), lat)
        return merged + self._monitor.drain()

    def _apply_signals(self, sigs):
        # rank-bearing signals all refer to the ENQUEUE-time index
        # space (self._devices as it was when flagged), so evictions
        # are collected as a set and applied in one pass: popping a
        # mutating list would evict the wrong rank the moment two
        # ranks are flagged in the same drain
        evict = set()
        targets = []
        reason = None
        ckpt_only = False
        for s in sigs:
            k = s["kind"]
            if k == "resize":
                targets.append((int(s["target"]),
                                s.get("reason") or "manual"))
            elif k in ("straggler", "dead_peer"):
                r = s.get("rank")
                if r is not None and 0 <= r < len(self._devices):
                    evict.add(int(r))
                    reason = k
            elif k == "preempt":
                t = s.get("target")
                if t:
                    targets.append((int(t), "preempt"))
                else:
                    ckpt_only = True
        devices = list(self._devices)
        evicted = set()
        if evict:
            allowed = len(devices) - self._min_devices
            kept, removed = [], 0
            for i, d in enumerate(devices):
                if i in evict and removed < allowed:
                    removed += 1
                    evicted.add(d)
                    continue
                kept.append(d)
            devices = kept
        for t, why in targets:  # resize targets apply to the survivors
            n = max(self._min_devices, min(t, len(self._pool)))
            if n <= len(devices):
                devices = devices[:n]
            else:
                for d in self._pool:  # spot add: extend from the pool,
                    if len(devices) >= n:  # never re-adding a rank
                        break              # evicted in this same drain
                    if d not in devices and d not in evicted:
                        devices.append(d)
            reason = why
        if self._topo_key(devices) != self._topo_key(self._devices):
            self.resize(devices, reason=reason or "signal")
        elif ckpt_only:
            # a targetless preemption notice: proactive in-memory
            # snapshot + descriptor (a disk manager, if any, rides the
            # Trainer pause-point path instead)
            self.snapshot(reason="preempt")

    # -- resize ----------------------------------------------------------
    def _pool_snapshot(self, step):
        """The state of the topology whose member this rank's ``step`` is
        (None: not a member) as one chunk set on every pool rank: each
        member's written blocks (which tile every tensor once), gathered
        and merged by key in rank order; and the carries' extents."""
        from ..parallel import spmd as _spmd

        mine = ({}, {})
        if step is not None:
            if step._state is None:
                step.init_state()
            mine = _spmd._clipped_shard_chunks(step, only_written=True)
        chunks, extents = {}, {}
        for their_chunks, their_extents in self._gather(mine):
            for key, parts in their_chunks.items():
                chunks.setdefault(key, []).extend(parts)
            extents.update(their_extents)
        return chunks, extents

    def snapshot(self, reason="manual"):
        """Proactive checkpoint-in-memory of the CURRENT state; stores
        ``last_snapshot`` / ``last_descriptor`` (on every pool rank: all
        of them call it). Returns the descriptor."""
        chunks, extents = self._pool_snapshot(self._step_obj)
        self.last_snapshot = (chunks, extents)
        self.last_descriptor = snapshot_descriptor(
            chunks, extents, step=self._committed, reason=reason,
            from_devices=len(self._devices),
            to_devices=len(self._devices), cursor=self._cursor())
        return self.last_descriptor

    def _cursor(self):
        if self._ring is not None:
            c = getattr(self._ring, "cursor", None)
            if c is not None:
                return c if isinstance(c, dict) else int(c)
        return None

    def resize(self, new_devices, reason="manual"):
        """Move training onto the ranks ``new_devices``, in process, on
        every pool rank at once: the old topology's state gathered in
        memory, the new topology's cached or new step restored from it in
        its own layout, the kvstore world reset, an attached prefetcher
        or ring repartitioned with its cursor kept. Returns the resize
        event record."""
        from ..parallel import spmd as _spmd

        new_devices = [int(r) for r in new_devices]
        if len(new_devices) < self._min_devices:
            raise MXNetError(
                f"resize: {len(new_devices)} ranks is below "
                f"min_devices={self._min_devices}")
        if self._topo_key(new_devices) == self._topo_key(self._devices):
            return None
        t0 = time.perf_counter()
        old = self._step_obj
        old_n = len(self._devices)
        chunks, extents = self._pool_snapshot(old)
        self.last_snapshot = (chunks, extents)
        self.last_descriptor = snapshot_descriptor(
            chunks, extents, step=self._committed, reason=reason,
            from_devices=old_n, to_devices=len(new_devices),
            cursor=self._cursor())
        warm = self._rank in new_devices \
            and self._topo_key(new_devices) in self._steps
        new = self._get_step(new_devices)
        if new is not None:
            if new._state is None:
                new.init_state()
            _spmd.spmd_restore_chunks(new, chunks, extents=extents)
        if old is not None:
            # drop the OLD topology's state: warm re-entry needs only the
            # step object, and its copy of the parameters and optimizer
            # state would otherwise pin one model's worth of memory per
            # topology visited; a re-entry re-initialises and restores
            old._state = None
            old._last_loss = None
        self._devices = new_devices
        self._step_obj = new
        self._monitor.reset_latency()
        from ..kvstore import dist as _kvd

        _kvd.reset_world()
        if self._ring is not None and new is not None:
            rp = getattr(self._ring, "repartition", None)
            if rp is not None:
                # the cursor is kept; staged batches are staged again
                rp(mesh=new.mesh)
        dt = time.perf_counter() - t0
        ev = {"reason": str(reason), "from": old_n,
              "to": len(new_devices), "step": self._committed,
              "seconds": dt, "warm": warm}
        self.resize_events.append(ev)
        if _obs.ENABLED:
            _obs.ELASTIC_RESIZES_TOTAL.inc(1, reason=str(reason))
            if reason == "straggler":
                _obs.ELASTIC_STRAGGLER_EVICTIONS_TOTAL.inc()
            _obs.ELASTIC_RESIZE_SECONDS.observe(dt)
            _obs.ELASTIC_WORLD_SIZE.set(len(new_devices))
            _obs.tracer().record("elastic.resize", cat="resilience",
                                 ts=t0, dur=dt, args=dict(ev))
        _logger.warning(
            "elastic: resized %d -> %d ranks (%s) in %.3fs at committed "
            "step %d — no restart, state re-sharded in memory (%s "
            "re-entry)", old_n, len(new_devices), reason, dt,
            self._committed, "warm" if warm else "cold")
        if self._on_resize is not None:
            self._on_resize(ev, chunks)
        return ev

    def dump_descriptor(self, path):
        """Write ``last_descriptor`` as JSON (the ``--from-json``
        verification handoff). Returns the path, or None when no
        snapshot was taken yet."""
        if self.last_descriptor is None:
            return None
        from .checkpoint import atomic_replace

        def write(tmp):
            with open(tmp, "w") as f:
                json.dump(self.last_descriptor, f, indent=1)
                f.write("\n")

        atomic_replace(str(path), write)
        return str(path)

    def sync_to_block(self):
        """Write the live step's parameters back into the Gluon handles
        (on the topology's members)."""
        if self._step_obj is not None and self._step_obj._state is not None:
            self._step_obj.sync_to_block()

    def close(self):
        self._monitor.detach()

