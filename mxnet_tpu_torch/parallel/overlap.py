"""Bucketed gradient communication and the ZeRO shard arithmetic.

PyTorch counterpart of ``mxnet_tpu/parallel/overlap.py``. Gradients are
packed into flat, dtype-homogeneous buckets of about ``bucket_bytes``,
composed in readiness order (the order backward produces them, from each
parameter's first use in the forward: :func:`first_use_order`), and each
bucket is reduced by one collective on the data axis's process group:

- :func:`bucket_reduce_scatter` — one ``reduce_scatter_tensor`` per
  bucket, handing each rank only its 1/dp shard of every summed gradient
  (ZeRO 2/3);
- :func:`bucket_allreduce` — the same reduce-scatter followed by one
  ``all_gather_into_tensor`` per bucket (ZeRO 0/1): the two halves of a
  ring all-reduce, so the sums of every stage round alike for any number
  of ranks (a backend's own ``all_reduce`` may add the ranks' terms in
  another order than its reduce-scatter: with three or more ranks the
  reference's stage parity would not hold bit for bit);
- either through 2-bit compression (:func:`compress_bucket`) with a
  residual carried per bucket, and either in a reduced wire type.

The plan (:func:`build_bucket_plan`) is pure shape arithmetic and gives
the reference's buckets for the same shapes, dtypes, order and target
bytes. Where the reference places its collectives inside one compiled
step and lets XLA's scheduler overlap them with the backward, the port
starts each bucket's collective as an ``async_op`` from a gradient hook
as soon as the bucket's last gradient exists (``SPMDTrainStep``'s
``ready`` mode) and waits on it before the update. Every collective here
is the backend's own (gloo and NCCL both have all of them for the tensors
the port gives them); nothing is substituted.
"""

from __future__ import annotations

import logging
import time

import torch
from torch.overrides import TorchFunctionMode

_logger = logging.getLogger("mxnet_tpu_torch.parallel.overlap")

def _itemsize(name):
    """Bytes per element of the dtype named ``name`` ("float32", ...)."""
    return getattr(torch, name).itemsize


# ---------------------------------------------------------------------------
# readiness order from the forward
# ---------------------------------------------------------------------------

class _FirstUse(TorchFunctionMode):
    """Records, for each watched tensor, the index of the first torch call
    that takes it."""

    def __init__(self, targets):
        super().__init__()
        self.ids = {id(t): k for k, t in enumerate(targets)}
        self.first = {}
        self.calls = 0

    def _see(self, x):
        k = self.ids.get(id(x))
        if k is not None and k not in self.first:
            self.first[k] = self.calls
        elif isinstance(x, (list, tuple)):
            for y in x:
                self._see(y)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.calls += 1
        for a in args:
            self._see(a)
        for a in kwargs.values():
            self._see(a)
        return func(*args, **kwargs)


class first_use_recorder:
    """Context manager: ``with first_use_recorder(params) as rec: fwd()``,
    then ``rec.order()`` is :func:`first_use_order`'s result for that
    forward (the step records its own first forward, so finding the order
    costs no extra pass)."""

    def __init__(self, targets):
        self._mode = _FirstUse(list(targets))
        self._n = len(self._mode.ids)

    def __enter__(self):
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)

    def order(self):
        first = self._mode.first
        idxs = [first.get(k, -1) for k in range(self._n)]
        if len(set(idxs)) <= 1:
            return None  # no signal
        return sorted(range(self._n), key=lambda k: (-idxs[k], k))


def first_use_order(fn, example_args, n_diff):
    """Gradient readiness order for ``fn(diff_params, *rest)``.

    Runs ``fn`` once, without recording a graph, and notes for each of
    the ``n_diff`` tensors of ``example_args[0]`` the index of the first
    torch call that takes it. Reverse-mode AD produces each gradient near
    the reversed position of its first use, so sorting by DESCENDING
    first-use index approximates the order gradients become available.
    Returns a permutation of ``range(n_diff)``, or None when the run fails
    or gives no signal (callers then take the reversed parameter order)."""
    try:
        with torch.no_grad(), first_use_recorder(
                list(example_args[0])[:n_diff]) as rec:
            fn(*example_args)
        return rec.order()
    except Exception as e:  # noqa: BLE001 - a failed probe has a fallback
        _logger.debug("first_use_order: run failed (%s: %s)",
                      type(e).__name__, e)
        return None


# ---------------------------------------------------------------------------
# bucket plan
# ---------------------------------------------------------------------------

class BucketPlan:
    """Readiness-ordered, dtype-homogeneous gradient bucketing.

    ``buckets``: tuple of tuples of gradient indices, in the order their
    collectives start.
    ``shapes``/``dtypes``/``sizes`` are per gradient (original order);
    ``pad_sizes`` is each flat length padded up to a multiple of ``dp``
    (``sizes`` when ``dp`` is 1; the padding is the reduce-scatter
    layout)."""

    __slots__ = ("buckets", "shapes", "dtypes", "sizes", "pad_sizes",
                 "order", "dp")

    def __init__(self, buckets, shapes, dtypes, sizes, pad_sizes, order,
                 dp):
        self.buckets = tuple(tuple(b) for b in buckets)
        self.shapes = tuple(tuple(s) for s in shapes)
        self.dtypes = tuple(dtypes)
        self.sizes = tuple(sizes)
        self.pad_sizes = tuple(pad_sizes)
        self.order = tuple(order)
        self.dp = int(dp)

    def __len__(self):
        return len(self.buckets)


def _ceil_to(n, m):
    return ((int(n) + m - 1) // m) * m if m > 1 else int(n)


def build_bucket_plan(shapes, dtypes, order=None, bucket_bytes=None,
                      dp=1, itemsizes=None):
    """Greedy ~``bucket_bytes`` dtype-homogeneous packing in readiness
    order ``order`` (default: reversed index order — the last parameter's
    gradient is produced first). ``dp`` > 1 pads every gradient's flat
    length to a multiple of ``dp``, so a reduce-scatter shard never
    straddles two gradients. ``dtypes`` are dtype names, or any labels
    that tell the buckets apart when ``itemsizes`` gives each tensor's
    bytes per element."""
    from .. import fusedstep as _fusedstep

    n = len(shapes)
    if order is None:
        order = list(range(n - 1, -1, -1))
    target = max(int(bucket_bytes if bucket_bytes is not None
                     else _fusedstep.overlap_bucket_bytes()), 1)
    sizes = []
    for shape in shapes:
        c = 1
        for d in shape:
            c *= int(d)
        sizes.append(c)
    pad_sizes = [_ceil_to(s, dp) for s in sizes]
    buckets = []
    open_by_dtype = {}
    for gi in order:
        dt = str(dtypes[gi]).replace("torch.", "")
        nbytes = pad_sizes[gi] * (itemsizes[gi] if itemsizes is not None
                                  else _itemsize(dt))
        cur = open_by_dtype.get(dt)
        if cur is None or (cur[1] and cur[1] + nbytes > target):
            cur = [[], 0]
            open_by_dtype[dt] = cur
            buckets.append(cur)
        cur[0].append(gi)
        cur[1] += nbytes
    return BucketPlan([b for b, _ in buckets], shapes, dtypes, sizes,
                      pad_sizes, order, dp)


def residual_shapes(plan, reduce_scatter):
    """Per-bucket residual lengths of the compression carry (the packed
    bucket's element count: padded when the bucket feeds a
    reduce-scatter, exact otherwise)."""
    sizes = plan.pad_sizes if reduce_scatter else plan.sizes
    return [sum(sizes[i] for i in idxs) for idxs in plan.buckets]


# ---------------------------------------------------------------------------
# flat-shard arithmetic (ZeRO-2/3 layout)
# ---------------------------------------------------------------------------

def pad_flat(arr, pad_size):
    """Flatten and zero-pad one tensor to ``pad_size`` elements."""
    flat = arr.reshape(-1)
    if pad_size > flat.shape[0]:
        flat = torch.nn.functional.pad(flat, (0, pad_size - flat.shape[0]))
    return flat


def unpad_reshape(flat, size, shape):
    """Inverse of :func:`pad_flat` (drops the pad tail)."""
    return flat[:size].reshape(shape)


def shard_of(full, plan_or_dp, index, gi=None):
    """Rank ``index``'s ``[pad/dp]`` flat shard of one full tensor (the
    reference takes the rank from ``lax.axis_index``; a controller of one
    rank passes its coordinate on the data axis)."""
    if isinstance(plan_or_dp, BucketPlan):
        dp = plan_or_dp.dp
        pad = plan_or_dp.pad_sizes[gi]
    else:
        dp = int(plan_or_dp)
        pad = _ceil_to(full.numel(), dp)
    n = pad // dp
    return pad_flat(full, pad)[index * n:(index + 1) * n]


def chaos_point(site):
    """Chaos fault point of a bucket collective (``bucket_psum``,
    ``bucket_psum_scatter``, ``bucket_allgather``): a due one-shot
    ``collective`` fault (``MXTPU_CHAOS=collective@<site>:<n>``) raises
    before the collective is issued, so it surfaces as a loud step
    failure, never as wrong numbers; one module-bool read when chaos is
    off."""
    from ..resilience import chaos as _chaos

    if _chaos.ENABLED:
        _chaos.collective_point(site)


def gather_shard(shard, group=None, dp=None):
    """Every rank's ``[pad/dp]`` shard -> the full ``[pad]`` flat tensor
    (``all_gather_into_tensor`` on ``group``; chaos site
    ``bucket_allgather``)."""
    import torch.distributed as dist

    chaos_point("bucket_allgather")
    dp = dp or dist.get_world_size(group)
    out = torch.empty(shard.numel() * dp, dtype=shard.dtype,
                      device=shard.device)
    dist.all_gather_into_tensor(out, shard.contiguous(), group=group)
    return out


# ---------------------------------------------------------------------------
# 2-bit compression (the kvstore's 2bit scheme, bucket-shaped)
# ---------------------------------------------------------------------------

def compress_bucket(bucket, threshold, residual):
    """Quantize one flat bucket to ``{-t, 0, +t}`` with error feedback:
    the quantization error carries to the next step through ``residual``.
    Returns ``(q, new_residual)``."""
    t = torch.tensor(threshold, dtype=bucket.dtype, device=bucket.device)
    acc = bucket + residual
    zero = torch.zeros((), dtype=bucket.dtype, device=bucket.device)
    q = torch.where(acc >= t, t, torch.where(acc <= -t, -t, zero))
    return q, acc - q


# ---------------------------------------------------------------------------
# bucketed collectives
# ---------------------------------------------------------------------------

def pack_bucket(plan, bi, grads, reduce_scatter):
    """The flat payload of bucket ``bi``: its gradients concatenated, for
    a reduce-scatter each padded to ``[dp, pad/dp]`` rows and joined along
    the rows, so rank r's chunk is row r (its shard of every gradient)."""
    idxs = plan.buckets[bi]
    if reduce_scatter:
        parts = [pad_flat(grads[i], plan.pad_sizes[i]).reshape(plan.dp, -1)
                 for i in idxs]
        b = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        return b.reshape(-1)
    parts = [grads[i].reshape(-1) for i in idxs]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def unpack_bucket(plan, bi, red, out, reduce_scatter):
    """Slice a reduced bucket back into ``out`` (per gradient: its full
    shape, or its ``[pad/dp]`` shard after a reduce-scatter)."""
    off = 0
    for i in plan.buckets[bi]:
        n = plan.pad_sizes[i] // plan.dp if reduce_scatter \
            else plan.sizes[i]
        piece = red[off:off + n]
        out[i] = piece if reduce_scatter else piece.reshape(plan.shapes[i])
        off += n


class BucketComm:
    """The collectives of one step over ``plan`` (whose ``dp`` is the
    group's size). Every bucket is packed in the reduce-scatter layout
    and reduce-scattered; for ``reduce_scatter=False`` the summed shards
    are then all-gathered, so the all-reduce's sums are the
    reduce-scatter's, element for element, whatever the number of ranks:
    ZeRO 0/1 and ZeRO 2/3 round alike. ``start(bi, grads)`` packs bucket
    ``bi`` (compressing it and casting it to the wire type) and starts
    its reduce-scatter (``async_op`` unless ``sync``); ``finish(grads)``
    starts what was not yet started, waits on every collective in the
    order they started and returns the reduced gradients (whole, or this rank's
    ``[pad/dp]`` shards), each times ``postscale``, and the new
    residuals."""

    def __init__(self, plan, group, reduce_scatter, postscale=None,
                 compress=None, residuals=None, wire_dtype=None,
                 sync=False, nocomm=False, index=0):
        self.plan, self.group = plan, group
        self.rs = bool(reduce_scatter)
        self.postscale = postscale
        self.compress, self.residuals = compress, residuals
        self.new_res = [None] * len(plan.buckets) \
            if compress is not None else None
        self.wire = wire_dtype
        self.sync, self.nocomm, self.index = sync, nocomm, index
        self.pending = {}  # bucket -> (work, shard tensor, its dtype)
        self.order = []

    def start(self, bi, grads):
        import torch.distributed as dist

        # the all-reduce's and the reduce-scatter's chaos sites
        chaos_point("bucket_psum_scatter" if self.rs else "bucket_psum")
        plan = self.plan
        b = pack_bucket(plan, bi, grads, True)
        if self.compress is not None:
            b, self.new_res[bi] = compress_bucket(b, self.compress,
                                                  self.residuals[bi])
        odt = b.dtype
        if self.wire is not None and b.dtype != self.wire:
            b = b.to(self.wire)
        if self.nocomm:
            # the exposed-comm measurement's floor: wrong on purpose
            out, work = b.reshape(plan.dp, -1)[self.index], None
        else:
            out = torch.empty(b.numel() // plan.dp, dtype=b.dtype,
                              device=b.device)
            work = dist.reduce_scatter_tensor(out, b, group=self.group,
                                              async_op=not self.sync)
        self.pending[bi] = (work, out, odt)
        self.order.append(bi)

    def finish(self, grads):
        import torch.distributed as dist

        plan = self.plan
        for bi in range(len(plan.buckets)):
            if bi not in self.pending:
                self.start(bi, grads)
        shards = {}
        for bi in self.order:
            work, red, odt = self.pending[bi]
            if work is not None and not self.sync:
                work.wait()
            if red.dtype != odt:
                red = red.to(odt)
            if self.postscale is not None:
                red = red * torch.tensor(self.postscale, dtype=red.dtype,
                                         device=red.device)
            shards[bi] = red
        out = [None] * len(grads)
        if self.rs:
            for bi, red in shards.items():
                unpack_bucket(plan, bi, red, out, True)
        else:
            gathered = {}
            for bi, red in shards.items():
                if self.nocomm:
                    gathered[bi] = (None, red.repeat(plan.dp))
                    continue
                full = torch.empty(red.numel() * plan.dp, dtype=red.dtype,
                                   device=red.device)
                gathered[bi] = (dist.all_gather_into_tensor(
                    full, red, group=self.group, async_op=not self.sync),
                    full)
            for bi, (work, full) in gathered.items():
                if work is not None and not self.sync:
                    work.wait()
                _unpack_rows(plan, bi, full, out)
        self.pending.clear()
        return out, self.new_res


def _unpack_rows(plan, bi, full, out):
    """Each gradient of bucket ``bi`` back from an all-gathered
    ``[dp, S]`` reduce-scatter layout: its columns, its pad dropped."""
    rows = full.reshape(plan.dp, -1)
    off = 0
    for i in plan.buckets[bi]:
        n = plan.pad_sizes[i] // plan.dp
        out[i] = unpad_reshape(rows[:, off:off + n].reshape(-1),
                               plan.sizes[i], plan.shapes[i])
        off += n


def bucket_allreduce(grads, group, plan, postscale=None, compress=None,
                     residuals=None, wire_dtype=None):
    """The sum over ``group`` of every gradient, bucket by bucket in the
    plan's order: a ``reduce_scatter_tensor`` and an ``all_gather_into_tensor``
    per bucket (the halves of a ring all-reduce), so the sums are
    :func:`bucket_reduce_scatter`'s bit for bit. ``plan.dp`` must be the
    group's size. Returns (reduced gradients in original order, new
    residuals or None). ``postscale`` multiplies each reduced bucket (the
    1/dp of a mean-loss step); ``compress`` is a 2-bit threshold applied
    per bucket before the reduction with the ``residuals`` carry (lengths
    ``residual_shapes(plan, True)``); ``wire_dtype`` casts each bucket for
    the collective and back."""
    comm = BucketComm(plan, group, False, postscale, compress, residuals,
                      wire_dtype)
    return comm.finish(list(grads))


def bucket_reduce_scatter(grads, group, plan, postscale=None, compress=None,
                          residuals=None, wire_dtype=None):
    """One ``reduce_scatter_tensor`` per plan bucket (ZeRO-2/3): each rank
    receives its ``[pad/dp]`` shard of every summed gradient. Returns
    (per-gradient shards in original order, new residuals or None)."""
    comm = BucketComm(plan, group, True, postscale, compress, residuals,
                      wire_dtype)
    return comm.finish(list(grads))


# ---------------------------------------------------------------------------
# overlap measurement probe
# ---------------------------------------------------------------------------

def measure_overlap(block_factory, loss_fn, optimizer, optimizer_params,
                    mesh, x, y, lr=0.01, steps=20, warmup=3,
                    modes=("nocomm", "ready", "barrier", "staged")):
    """How much gradient-communication time each schedule exposes, on
    the same model, batch and mesh: ``nocomm`` (no collectives —
    numerically wrong on purpose) is the compute-only floor, and each
    mode's exposed comm is its mean step time minus the floor's.
    ``hidden_fraction`` is ``1 - exposed[ready] / exposed[staged]``.
    ``block_factory`` builds an identically initialised fresh block per
    call. Returns ``step_seconds``, ``exposed_comm_seconds`` and
    ``hidden_fraction``."""
    from .spmd import SPMDTrainStep

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    step_seconds = {}
    for mode in modes:
        step = SPMDTrainStep(block_factory(), loss_fn, optimizer,
                             optimizer_params, mesh, overlap=mode,
                             zero_stage=0)
        for _ in range(warmup):
            step(x, y, lr=lr, sync=False)
        sync()
        t0 = time.perf_counter()
        for _ in range(steps):
            step(x, y, lr=lr, sync=False)
        sync()
        step_seconds[mode] = (time.perf_counter() - t0) / steps
    floor = step_seconds.get("nocomm")
    exposed = {}
    if floor is not None:
        for mode, t in step_seconds.items():
            if mode != "nocomm":
                exposed[mode] = max(t - floor, 0.0)
    hidden = None
    base = exposed.get("staged") if "staged" in exposed \
        else exposed.get("barrier")
    if base is not None and "ready" in exposed:
        hidden = (max(0.0, min(1.0, 1.0 - exposed["ready"] / base))
                  if base > 0.0 else 0.0)
    from .. import observability as _obs

    _obs.record_overlap_probe(exposed, hidden)
    return {"step_seconds": step_seconds,
            "exposed_comm_seconds": exposed,
            "hidden_fraction": hidden}
