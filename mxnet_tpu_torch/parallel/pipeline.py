"""Pipeline parallelism: GPipe, 1F1B and interleaved 1F1B schedules over a
``pp`` mesh axis.

PyTorch counterpart of ``mxnet_tpu/parallel/pipeline.py``. Stage
parameters are a pytree (tuple, list or dict) of tensors with a leading
stage axis; each rank of the ``pp`` axis holds its own stages
(:func:`shard_stages`), and activations hop from stage to stage with
point-to-point sends on the axis's group (``transport.ring_shift``: +1
around the ring forward, -1 backward), where the reference rides
``lax.ppermute``.

The three schedules are realized from one dependency-simulated tick table
(:func:`build_pipeline_schedule`, host numpy, the reference's tables bit
for bit), so ``bubble_fraction`` is measured from the realized table:

- ``gpipe``: fill-drain; autograd through the forward loop
  (:func:`pipeline_apply`), as the reference's ``jax.value_and_grad``;
- ``1f1b``: the same bubble, the activation stash capped at the stage
  depth;
- ``interleaved``: 1F1B over ``v`` virtual chunks per rank (stage ``g``
  on rank ``g mod S``), dividing the ramps by ``v``.

``1f1b`` and ``interleaved`` run the tick-table executor
(:func:`_run_schedule`): each rank walks its column of the tables, one
forward and one backward at most a tick, the backward recomputing its
stage from the stashed input and taking ``torch.autograd.grad`` of it
(the reference's ``jax.vjp``, remat semantics). Every rank takes part in
each tick's exchange that any rank needs, sending zeros where it has
nothing, as the reference's uniform ``ppermute`` does, so the ranks post
their sends and receives in one order.

The port is one process per rank: a stage function is a torch function
of one stage's parameters and an activation, and ``PipelineTrainStep``
takes the global batch on every rank, as ``SPMDTrainStep`` does on a
mesh.
"""

from __future__ import annotations

import threading

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from . import transport

#: schedule tick tables are built once per (name, S, M, v): the build is a
#: host simulation that train steps, probes and reports all ask for
_SCHEDULE_CACHE = {}
_CACHE_LOCK = threading.Lock()

_GUARDED_BY = {"_SCHEDULE_CACHE": "_CACHE_LOCK"}


def _tensor(a, device=None):
    """The tensor behind ``a`` (an NDArray, a tensor, or numpy data placed
    on ``device``, default the current context's device)."""
    if isinstance(a, (NDArray, torch.Tensor)):
        t = a.data if isinstance(a, NDArray) else a
        return t if device is None else t.to(device)
    from ..context import current_context, resolve_device

    return torch.as_tensor(np.asarray(a)).to(resolve_device(
        device if device is not None else current_context()))


class _Hop(torch.autograd.Function):
    """An activation sent ``shift`` places around the ring of ``ranks``;
    its cotangent goes back the other way."""

    @staticmethod
    def forward(ctx, x, ranks, group, shift):
        ctx.args = (ranks, group, shift)
        return transport.ring_shift([x], ranks, shift, group)[0]

    @staticmethod
    def backward(ctx, g):
        ranks, group, shift = ctx.args
        return (transport.ring_shift([g.contiguous()], ranks, -shift,
                                     group)[0], None, None, None)


class _FromLast(torch.autograd.Function):
    """The last stage's outputs summed over the ``pp`` ranks (zeros
    elsewhere): every rank gets them, as the reference's ``psum`` of its
    masked bank does; the cotangent of the replicated result comes back
    once, as ``psum``'s transpose gives it."""

    @staticmethod
    def forward(ctx, x, mesh, axis_name):
        return transport.all_reduce(x.clone(), mesh, axis_name)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _check_stage_axis(leaves, S, axis_name):
    for leaf in leaves:
        if leaf.shape[0] not in (1, S):
            raise MXNetError(
                f"stage axis {leaf.shape[0]} != mesh {axis_name}={S}: "
                "each device must hold exactly one stage")


def pipeline_apply(stage_fn, stage_params, x, mesh, axis_name="pp",
                   num_microbatches=None):
    """Apply ``S`` pipelined stages to ``x`` (fill-drain forward),
    differentiable.

    ``stage_fn(params_one_stage, activation) -> activation`` (same shape);
    ``stage_params``: pytree whose leaves lead with this rank's stage axis
    of 1 (:func:`shard_stages`), or with all ``S`` stages, of which the
    rank takes its own; ``x``: the ``(B, ...)`` global batch on every
    rank, B divisible by ``num_microbatches``. Returns the ``(B, ...)``
    output of the last stage on every rank. Every rank runs its stage at
    each of the ``M + S - 1`` ticks, as the reference does, so that each
    hop is on every rank's graph and the backward's hops pair up."""
    S = transport.axis_size(mesh, axis_name)
    leaves, spec = pytree.tree_flatten(stage_params)
    _check_stage_axis(leaves, S, axis_name)
    M = num_microbatches or S
    x = _tensor(x)
    B = x.shape[0]
    if B % M:
        raise MXNetError(
            f"num_microbatches {M} must divide the batch size {B}")
    mb = B // M
    xs = x.reshape(M, mb, *x.shape[1:])
    stage = mesh.axis_index(axis_name)
    ranks, group = mesh.axis_ranks(axis_name), mesh.group(axis_name)
    params_one = pytree.tree_unflatten(
        [leaf[stage if leaf.shape[0] == S and S > 1 else 0]
         for leaf in leaves], spec)
    first = torch.tensor(stage == 0, device=x.device)
    last = stage == S - 1
    state = torch.zeros_like(xs[0])
    outputs = torch.zeros_like(xs)
    for t in range(M + S - 1):
        # stage 0 takes microbatch t; the others the handed-over state,
        # which stays on every rank's graph (``where``)
        inp = torch.where(first, xs[min(t, M - 1)], state)
        out = stage_fn(params_one, inp)
        oidx = t - (S - 1)
        live = torch.tensor(oidx >= 0 and last, device=x.device)
        row = torch.zeros(M, dtype=torch.bool, device=x.device)
        row[min(max(oidx, 0), M - 1)] = True
        outputs = torch.where(live & row.reshape((M,) + (1,) *
                                                 out.dim()),
                              out.unsqueeze(0), outputs)
        if t < M + S - 2:
            state = _Hop.apply(out, ranks, group, 1)
    outputs = _FromLast.apply(
        torch.where(torch.tensor(last, device=x.device), outputs,
                    torch.zeros_like(outputs)), mesh, axis_name)
    return outputs.reshape(B, *x.shape[1:])


def stack_stage_params(per_stage_params):
    """``[pytree_per_stage, ...]`` -> one pytree with a leading stage
    axis."""
    flat = [pytree.tree_flatten(p) for p in per_stage_params]
    spec = flat[0][1]
    return pytree.tree_unflatten(
        [torch.stack([_tensor(f[0][i]) for f in flat])
         for i in range(len(flat[0][0]))], spec)


def shard_stages(stacked, mesh, axis_name="pp"):
    """This rank's block of stacked stage parameters: the stage axis split
    over ``pp`` (rank ``r`` of ``S`` takes rows ``[r*L/S, (r+1)*L/S)``),
    the reference's ``P(axis_name)`` placement."""
    S = transport.axis_size(mesh, axis_name)
    r = mesh.axis_index(axis_name)

    def take(leaf):
        leaf = _tensor(leaf)
        if leaf.shape[0] % S:
            raise MXNetError(f"{leaf.shape[0]} stages do not tile the "
                             f"{axis_name}={S} axis")
        n = leaf.shape[0] // S
        return leaf[r * n:(r + 1) * n]

    return pytree.tree_map(take, stacked)


# ---------------------------------------------------------------------------
# schedule tables: dependency-simulated tick programs (host numpy, the
# reference's code)
# ---------------------------------------------------------------------------


def stage_permutation(num_ranks, virtual):
    """Stacked position -> global stage, rank-major chunk layout.

    Position ``p = r*v + c`` (rank r's c-th local chunk) holds global
    stage ``g = c*S + r``, so splitting the permuted stack over ``pp``
    gives rank r exactly its interleaved chunks, and every forward hop
    g -> g+1 is the uniform +1 ring."""
    S, v = num_ranks, virtual
    return [(p % v) * S + (p // v) for p in range(S * v)]


class PipelineSchedule:
    """A realized pipeline schedule: per-tick work tables and the measured
    bubble. Built by :func:`build_pipeline_schedule`."""

    def __init__(self, name, num_ranks, num_microbatches, virtual,
                 ticks, tables, stash_slots, bstash_slots):
        self.name = name
        self.num_ranks = num_ranks
        self.num_microbatches = num_microbatches
        self.virtual = virtual
        self.num_stages = num_ranks * virtual
        self.ticks = ticks
        self.tables = tables
        #: peak live forward-activation stash entries on any rank: the
        #: 1F1B memory win over gpipe is this number (S against M)
        self.stash_slots = stash_slots
        self.bstash_slots = bstash_slots
        busy = 2 * num_microbatches * virtual  # F+B units per rank
        #: measured from the realized table: the fraction of (rank, tick)
        #: slots with no scheduled work
        self.bubble_fraction = 1.0 - busy / float(ticks)

    def report(self):
        return {"schedule": self.name, "ranks": self.num_ranks,
                "virtual": self.virtual,
                "microbatches": self.num_microbatches,
                "ticks": self.ticks,
                "bubble_fraction": round(self.bubble_fraction, 6),
                "stash_slots": self.stash_slots}


def _rank_order(name, S, v, M, r):
    """This rank's work order: the classic per-rank sequences."""
    if name == "gpipe":
        return ([("F", r, m) for m in range(M)] +
                [("B", r, m) for m in reversed(range(M))])
    if name == "1f1b":
        W = min(M, S - 1 - r)
        order = [("F", r, m) for m in range(W)]
        for i in range(M - W):
            order.append(("F", r, W + i))
            order.append(("B", r, i))
        order += [("B", r, i) for i in range(M - W, M)]
        return order
    if name == "interleaved":
        if M % S:
            raise MXNetError(
                f"interleaved schedule needs microbatches ({M}) to be a "
                f"multiple of the pp axis ({S})")
        total = M * v

        def fwd_unit(k):
            rnd, within = divmod(k, S * v)
            return ("F", (within // S) * S + r, rnd * S + within % S)

        def bwd_unit(j):
            rnd, within = divmod(j, S * v)
            c = v - 1 - within // S
            return ("B", c * S + r, rnd * S + within % S)

        W = min(total, (v - 1) * S + 2 * (S - r - 1) + 1)
        order = [fwd_unit(k) for k in range(W)]
        for i in range(total - W):
            order.append(fwd_unit(W + i))
            order.append(bwd_unit(i))
        order += [bwd_unit(j) for j in range(total - W, total)]
        return order
    raise MXNetError(f"unknown pipeline schedule {name!r} "
                     "(gpipe | 1f1b | interleaved)")


class _Slots:
    """Greedy interval slot allocator (per rank): reuse a slot whose
    previous tenant was last read strictly before the new deposit."""

    def __init__(self):
        self.ends = []  # slot -> last read tick of current tenant

    def alloc(self, start, end):
        for i, e in enumerate(self.ends):
            if e <= start:  # last read happens before the new deposit
                self.ends[i] = end
                return i
        self.ends.append(end)
        return len(self.ends) - 1

    @property
    def n(self):
        return len(self.ends)


def build_pipeline_schedule(num_ranks, num_microbatches, name="gpipe",
                            virtual=1):
    """Simulate ``name`` over S ranks / M microbatches / v virtual chunks
    and return the realized :class:`PipelineSchedule`.

    The simulator walks the classic per-rank work orders tick by tick,
    releasing each unit only when its producer finished on an earlier
    tick (cross-rank messages ride the end-of-tick exchange), so the
    table, its bubble fraction and the stash liveness are measured
    properties of the realized schedule."""
    key = (name, int(num_ranks), int(num_microbatches), int(virtual))
    with _CACHE_LOCK:
        hit = _SCHEDULE_CACHE.get(key)
    if hit is not None:
        return hit

    S, M, v = int(num_ranks), int(num_microbatches), int(virtual)
    L = S * v
    if name != "interleaved" and v != 1:
        raise MXNetError(f"schedule {name!r} runs one stage per rank; "
                         f"got {L} stages on {S} ranks — use "
                         "schedule='interleaved' for virtual chunks")
    orders = [_rank_order(name, S, v, M, r) for r in range(S)]
    done = {}
    ptr = [0] * S
    exec_at = {}  # (kind, g, m) -> (tick, rank)
    t, limit = 0, 4 * (2 * M * L + L + S) + 16
    while any(ptr[r] < len(orders[r]) for r in range(S)):
        for r in range(S):
            if ptr[r] >= len(orders[r]):
                continue
            kind, g, m = orders[r][ptr[r]]
            if kind == "F":
                dep = None if g == 0 else ("F", g - 1, m)
            else:
                dep = ("F", L - 1, m) if g == L - 1 else ("B", g + 1, m)
            if dep is None or done.get(dep, limit) < t:
                done[(kind, g, m)] = t
                exec_at[(kind, g, m)] = (t, r)
                ptr[r] += 1
        t += 1
        if t > limit:  # pragma: no cover - schedule bug guard
            raise MXNetError(f"pipeline schedule {name!r} deadlocked "
                             f"(S={S}, M={M}, v={v})")
    T = t

    cols = ("f_on f_mb f_chunk f_src f_slot bank_on bank_mb "
            "b_on b_mb b_chunk b_src b_slot bx_src bx_slot "
            "rf_on rf_slot rb_on rb_slot").split()
    tbl = {c: np.zeros((T, S), np.int32) for c in cols}
    fslots = [_Slots() for _ in range(S)]
    bslots = [_Slots() for _ in range(S)]

    for (kind, g, m), (tick, r) in sorted(exec_at.items(),
                                          key=lambda kv: kv[1]):
        c = g // S
        if kind == "F":
            tbl["f_on"][tick, r] = 1
            tbl["f_mb"][tick, r] = m
            tbl["f_chunk"][tick, r] = c
            if g == L - 1:
                tbl["bank_on"][tick, r] = 1
                tbl["bank_mb"][tick, r] = m
            if g > 0:
                arrive = done[("F", g - 1, m)]
                last_read = exec_at[("B", g, m)][0]
                slot = fslots[r].alloc(arrive, last_read)
                tbl["rf_on"][arrive, r] = 1
                tbl["rf_slot"][arrive, r] = slot
                tbl["f_src"][tick, r] = 1
                tbl["f_slot"][tick, r] = slot
                tbl["bx_src"][exec_at[("B", g, m)][0], r] = 1
                tbl["bx_slot"][exec_at[("B", g, m)][0], r] = slot
        else:
            tbl["b_on"][tick, r] = 1
            tbl["b_mb"][tick, r] = m
            tbl["b_chunk"][tick, r] = c
            if g < L - 1:
                arrive = done[("B", g + 1, m)]
                slot = bslots[r].alloc(arrive, tick)
                tbl["rb_on"][arrive, r] = 1
                tbl["rb_slot"][arrive, r] = slot
                tbl["b_src"][tick, r] = 1
                tbl["b_slot"][tick, r] = slot

    n_f = max((s.n for s in fslots), default=0)
    n_b = max((s.n for s in bslots), default=0)
    # idle rows point their slot reads/deposits at the scratch slot
    for slot_col, on_col in (("f_slot", "f_on"), ("b_slot", "b_on"),
                             ("bx_slot", "b_on"), ("rf_slot", "rf_on"),
                             ("rb_slot", "rb_on")):
        scratch = n_f if slot_col in ("f_slot", "bx_slot", "rf_slot") \
            else n_b
        tbl[slot_col][tbl[on_col] == 0] = scratch
    sched = PipelineSchedule(name, S, M, v, T, tbl, n_f, n_b)
    with _CACHE_LOCK:
        _SCHEDULE_CACHE[key] = sched
    return sched


def measure_pipeline_bubble(num_ranks, num_microbatches, virtual=2,
                            schedules=("gpipe", "1f1b", "interleaved")):
    """Realize each schedule's tick table at this configuration: the
    measured bubble fractions and stash depths. Returns ``{schedule:
    report dict}``; each is also published as the bubble and stash
    gauges (``observability.record_pipeline_schedule``)."""
    from .. import observability as _obs

    out = {}
    for name in schedules:
        v = virtual if name == "interleaved" else 1
        sched = build_pipeline_schedule(num_ranks, num_microbatches,
                                        name, virtual=v)
        out[name] = sched.report()
        _obs.record_pipeline_schedule(name, sched.bubble_fraction,
                                      sched.stash_slots, ticks=sched.ticks)
    return out


# ---------------------------------------------------------------------------
# schedule executor: each rank walks its column of the tick tables
# ---------------------------------------------------------------------------


def _grad_leaves(leaves):
    return [t.detach().requires_grad_(True) for t in leaves]


def _run_schedule(stage_fn, loss_fn, sched, mesh, axis_name, params_local,
                  xs, ys, head_fn=None, head_params=None, embed_fn=None,
                  embed_params=None):
    """One forward and backward pass of ``sched`` on this rank.
    ``params_local``: leaves ``[v, ...]`` (this rank's chunks, in
    :func:`stage_permutation`'s order); ``xs``/``ys``: ``[M, mb, ...]``
    microbatches of the global batch (the same on every rank). Optional
    ``embed_fn(embed_params, x_mb)`` feeds stage 0 (recomputed at the
    stage-0 backward ticks, whose input gradient flows into it) and
    ``head_fn(head_params, h)`` sits between the last stage and the loss
    (folded into the loss seed). Returns ``(loss, grads_local, {"head":
    g or None, "embed": g or None})``: the loss summed over ``pp`` and
    the head's and embed's gradients summed over ``pp`` (each is nonzero
    on one rank), as the reference's ``psum``s give them on every rank.

    Per tick: at most one forward (its input from the feed or the
    activation stash, run without a graph) and one backward (the stage
    recomputed from the stashed input and differentiated, seeded from the
    loss at the last stage), then one +1-ring exchange of activations and
    one -1-ring exchange of cotangents on the ticks where any rank
    receives; slots, chunks and microbatches come from the host-built
    tables."""
    S, M, T = sched.num_ranks, sched.num_microbatches, sched.ticks
    tbl = sched.tables
    r = mesh.axis_index(axis_name)
    ranks, group = mesh.axis_ranks(axis_name), mesh.group(axis_name)
    leaves, spec = pytree.tree_flatten(params_local)
    h_leaves, h_spec = pytree.tree_flatten(head_params) \
        if head_params is not None else ([], None)
    e_leaves, e_spec = pytree.tree_flatten(embed_params) \
        if embed_params is not None else ([], None)
    inv_m = 1.0 / M

    def chunk(c, ls):
        return pytree.tree_unflatten([leaf[c] for leaf in ls], spec)

    def feed(m, e_ls=None):
        if embed_fn is None:
            return xs[m]
        return embed_fn(pytree.tree_unflatten(e_ls or e_leaves, e_spec),
                        xs[m])

    with torch.no_grad():
        a0 = feed(0)
    act_shape, act_dtype, dev = a0.shape, a0.dtype, a0.device
    del a0

    def zeros():
        return torch.zeros(act_shape, dtype=act_dtype, device=dev)

    stash = [None] * (sched.stash_slots + 1)
    bstash = [None] * (sched.bstash_slots + 1)
    out_bank = [None] * M
    grads = [torch.zeros_like(leaf) for leaf in leaves]
    # the head's and the embedding's gradients accumulate on the rank that
    # computes them, from its first one (a vocabulary table's zeros on
    # every rank would cost their bytes through the whole schedule)
    head_grads = [None] * len(h_leaves)
    embed_grads = [None] * len(e_leaves)
    loss_acc = torch.zeros((), dtype=torch.float32, device=dev)

    def seed_of(out_m, y_m):
        """Loss value and cotangent at the last stage (head folded in)."""
        o = out_m.detach().requires_grad_(True)
        hp = _grad_leaves(h_leaves)
        with torch.enable_grad():
            pred = head_fn(pytree.tree_unflatten(hp, h_spec), o) \
                if head_fn is not None else o
            val = loss_fn(pred, y_m)
            got = torch.autograd.grad(
                val, [o] + hp, torch.full_like(val, inv_m))
        return val.detach(), got[0].to(act_dtype), got[1:]

    for t in range(T):
        f_out = None
        if tbl["f_on"][t, r]:
            m = int(tbl["f_mb"][t, r])
            with torch.no_grad():
                inp = feed(m) if tbl["f_src"][t, r] == 0 \
                    else stash[int(tbl["f_slot"][t, r])]
                f_out = stage_fn(chunk(int(tbl["f_chunk"][t, r]), leaves),
                                 inp.to(act_dtype)).to(act_dtype)
            if tbl["bank_on"][t, r]:
                out_bank[int(tbl["bank_mb"][t, r])] = f_out

        b_msg = None
        if tbl["b_on"][t, r]:
            m, c = int(tbl["b_mb"][t, r]), int(tbl["b_chunk"][t, r])
            if tbl["b_src"][t, r] == 0:
                loss_m, g_out, g_head = seed_of(out_bank[m], ys[m])
                out_bank[m] = None
                loss_acc += loss_m.float() * inv_m
                _accumulate(head_grads, g_head)
            else:
                g_out = bstash[int(tbl["b_slot"][t, r])]
            p = _grad_leaves([leaf[c] for leaf in leaves])
            from_stash = tbl["bx_src"][t, r] != 0
            ep = _grad_leaves(e_leaves) \
                if embed_fn is not None and not from_stash else []
            with torch.enable_grad():
                if from_stash:
                    bx = stash[int(tbl["bx_slot"][t, r])].detach() \
                        .requires_grad_(True)
                elif ep:
                    bx = feed(m, ep).to(act_dtype)
                else:
                    bx = xs[m].to(act_dtype)
                out = stage_fn(pytree.tree_unflatten(p, spec), bx)
                wrt = p + ([bx] if from_stash else ep)
                got = torch.autograd.grad(out, wrt, g_out.to(out.dtype),
                                          allow_unused=True)
            for acc, g in zip(grads, got[:len(p)]):
                if g is not None:
                    acc[c] += g
            rest = got[len(p):]
            if from_stash:
                b_msg = rest[0] if rest[0] is not None else zeros()
            else:
                _accumulate(embed_grads, rest)

        if tbl["rf_on"][t].any():
            recv = transport.ring_shift(
                [f_out if f_out is not None else zeros()], ranks, 1,
                group)[0]
            if tbl["rf_on"][t, r]:
                stash[int(tbl["rf_slot"][t, r])] = recv
        if tbl["rb_on"][t].any():
            recv = transport.ring_shift(
                [b_msg.to(act_dtype) if b_msg is not None else zeros()],
                ranks, -1, group)[0]
            if tbl["rb_on"][t, r]:
                bstash[int(tbl["rb_slot"][t, r])] = recv

    loss = transport.all_reduce(loss_acc, mesh, axis_name)
    aux = {"head": None, "embed": None}
    for part, acc, ls, sp in (("head", head_grads, h_leaves, h_spec),
                              ("embed", embed_grads, e_leaves, e_spec)):
        if ls:
            aux[part] = pytree.tree_unflatten(
                [transport.all_reduce(
                    g if g is not None else torch.zeros_like(leaf), mesh,
                    axis_name) for g, leaf in zip(acc, ls)], sp)
    return loss, pytree.tree_unflatten(grads, spec), aux


def _accumulate(acc, grads):
    """Add each of ``grads`` (fresh tensors, None for none) into ``acc``
    in place; an empty slot takes the gradient itself."""
    for i, g in enumerate(grads):
        if g is None:
            continue
        if acc[i] is None:
            acc[i] = g
        else:
            acc[i] += g


def _microbatch(x, y, M):
    B = x.shape[0]
    if B % M:
        raise MXNetError(
            f"num_microbatches {M} must divide the batch size {B}")
    mb = B // M
    return (x.reshape(M, mb, *x.shape[1:]),
            y.reshape(M, mb, *y.shape[1:]))


def _amp_wrap(stage_fn, amp_dtype):
    """Low-precision compute wrapper: parameters and activation cast down
    for the stage's products, the output back in fp32 for the hop and the
    stash."""
    if not amp_dtype:
        return stage_fn
    from ..ndarray.ndarray import torch_dtype

    dt = torch_dtype(amp_dtype)

    def wrapped(params_one, h):
        lo = pytree.tree_map(lambda p: p.to(dt), params_one)
        return stage_fn(lo, h.to(dt)).to(torch.float32)

    return wrapped


#: an element-wise rule updates a leaf in place this many elements at a
#: time: its temporaries stay small beside a large leaf (an embedding)
_UPDATE_CHUNK = 1 << 24


def _update_leaves(rule_update, leaves, grads, states, lr,
                   elementwise=False):
    """``rule_update`` on each leaf, in the lists given (each gradient let
    go as soon as its leaf is done). With ``elementwise`` (every rule but
    LAMB's, whose state leaves are scalars or the leaf's shape) the leaf
    and its state are updated in place, one flat slab of _UPDATE_CHUNK
    elements at a time, a small leaf being one slab: the rule's numbers
    without its full-size temporaries. LAMB's trust ratio spans the whole
    leaf, which it replaces."""
    for i in range(len(leaves)):
        w, g, st = leaves[i], grads[i], tuple(states[i])
        grads[i] = None
        if not elementwise:
            w2, st2 = rule_update(w, g, st, lr)
            leaves[i], states[i] = w2, tuple(st2)
            continue
        w = leaves[i] = w.contiguous()
        st = tuple(x.contiguous() for x in st)
        w_f, g_f = w.view(-1), g.reshape(-1)
        st_f = [x if x.dim() == 0 else x.view(-1) for x in st]
        new_st = list(st)
        for a in range(0, max(w_f.numel(), 1), _UPDATE_CHUNK):
            cut = slice(a, a + _UPDATE_CHUNK)
            w2, st2 = rule_update(
                w_f[cut], g_f[cut],
                tuple(x if x.dim() == 0 else x[cut] for x in st_f), lr)
            w_f[cut].copy_(w2)
            for j, (x, y) in enumerate(zip(st_f, st2)):
                if x.dim() == 0:
                    new_st[j] = y
                else:
                    x[cut].copy_(y)
        states[i] = tuple(new_st)
    return leaves, states


class PipelineTrainStep:
    """Pipelined training over the ``pp`` axis.

    ``schedule``: ``gpipe`` (default; fill-drain through autograd),
    ``1f1b`` or ``interleaved`` (both the tick-table executor;
    ``interleaved`` wants the stage count to be a multiple of the pp
    axis, running v = L/S chunks per rank). ``optimizer``: any of the SPMD
    rule names (sgd, adam, ...). ``stage_params`` are the global stacked
    parameters, the same on every rank (each keeps its own chunks);
    ``device``: where numpy parameters go (default: the current context).

    >>> step = PipelineTrainStep(stage_fn, stage_params, mesh, loss_fn)
    >>> loss = step(x, y, lr=0.1)
    """

    def __init__(self, stage_fn, stage_params, mesh, loss_fn,
                 axis_name="pp", num_microbatches=None, schedule=None,
                 optimizer="sgd", optimizer_params=None, amp_dtype=None,
                 device=None):
        from .. import fusedstep
        from .spmd import _RULES, _lamb_rule_sharded

        self._mesh = mesh
        self._axis = axis_name
        self._loss_fn = loss_fn
        S = transport.axis_size(mesh, axis_name)
        leaves, spec = pytree.tree_flatten(stage_params)
        leaves = [_tensor(a, device) for a in leaves]
        L = leaves[0].shape[0]
        schedule = schedule or fusedstep.pipeline_schedule()
        M = num_microbatches or fusedstep.pipeline_microbatches() or S
        self._M = M
        if optimizer not in _RULES:
            raise MXNetError(f"pipeline step supports {sorted(_RULES)}; "
                             f"got {optimizer}")
        hyper = dict(optimizer_params or {})
        rule_init, self._rule_update = _RULES[optimizer](hyper)
        self._elementwise = optimizer != "lamb"
        self._fn = _amp_wrap(stage_fn, amp_dtype)
        self._spec = spec
        if schedule == "gpipe":
            if L != S:
                raise MXNetError(
                    f"gpipe runs one stage per rank: {L} stages != "
                    f"{axis_name}={S} (use schedule='interleaved')")
            self.schedule = build_pipeline_schedule(S, M, "gpipe")
            if optimizer == "lamb":
                # the reference's jit updates the whole stacked leaf: its
                # trust-ratio norms span every stage
                self._rule_update = _lamb_rule_sharded(
                    hyper, [mesh.group(axis_name)] if S > 1 else [])[1]
            self._params = pytree.tree_flatten(
                shard_stages(pytree.tree_unflatten(leaves, spec), mesh,
                             axis_name))[0]
        else:
            if L % S:
                raise MXNetError(
                    f"{L} stages do not tile the {axis_name}={S} axis")
            v = L // S
            if schedule == "1f1b" and v != 1:
                raise MXNetError(
                    f"1f1b runs one stage per rank: {L} stages != "
                    f"{axis_name}={S} (use schedule='interleaved')")
            self.schedule = build_pipeline_schedule(S, M, schedule,
                                                    virtual=v)
            perm = torch.as_tensor(stage_permutation(S, v))
            permuted = [a[perm.to(a.device)] for a in leaves]
            self._params = pytree.tree_flatten(shard_stages(
                pytree.tree_unflatten(permuted, spec), mesh,
                axis_name))[0]
        self._params = [p.detach().clone() for p in self._params]
        self._opt = [tuple(rule_init(p)) for p in self._params]
        from .. import observability as _obs

        _obs.record_pipeline_schedule(
            self.schedule.name, self.schedule.bubble_fraction,
            self.schedule.stash_slots, ticks=self.schedule.ticks)

    def schedule_report(self):
        return self.schedule.report()

    def params(self):
        """This rank's stage parameters (leaves ``[v, ...]``, in
        :func:`stage_permutation`'s order) as the stage pytree."""
        return pytree.tree_unflatten(self._params, self._spec)

    def __call__(self, x, y, lr=0.01):
        """One step on the global batch; the loss (a 0-d tensor, the same
        on every rank)."""
        dev = self._params[0].device
        x, y = _tensor(x, dev), _tensor(y, dev)
        lr = torch.tensor(lr, dtype=torch.float32, device=dev)
        if self.schedule.name == "gpipe":
            p = [t.detach().requires_grad_(True) for t in self._params]
            with torch.enable_grad():
                out = pipeline_apply(self._fn,
                                     pytree.tree_unflatten(p, self._spec),
                                     x, self._mesh, self._axis, self._M)
                loss = self._loss_fn(out, y)
                grads = torch.autograd.grad(loss, p)
            loss = loss.detach()
        else:
            xs, ys = _microbatch(x, y, self._M)
            loss, grads, _ = _run_schedule(
                self._fn, self._loss_fn, self.schedule, self._mesh,
                self._axis, self.params(), xs, ys)
            grads = pytree.tree_flatten(grads)[0]
        with torch.no_grad():
            _update_leaves(self._rule_update, self._params, list(grads),
                           self._opt, lr, self._elementwise)
        return loss
