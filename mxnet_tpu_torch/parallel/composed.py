"""The composed train step: dp x pp x tp with ZeRO on the dp axis.

PyTorch counterpart of ``mxnet_tpu/parallel/composed.py``. The reference
runs one ``shard_map`` over ``Mesh(dp, pp, tp, sp, ep)``; the port runs
the same program in each rank of a world laid out as that mesh:

* **pp**: the tick-table pipeline executor (``pipeline._run_schedule``)
  with any of the three schedules (``1f1b`` by default at one chunk a
  rank, ``interleaved`` when the stages tile the axis more than once,
  ``gpipe`` for comparison runs);
* **tp**: each stage parameter may carry a ``PartitionSpec`` over its
  stage dimensions (``tp_specs``); the rank holds its block and the stage
  function owns its tensor collectives (Megatron's :func:`tp_copy` and
  :func:`tp_all_gather` over the ``tp`` group);
* **dp**: each microbatch's rows split over ``dp``; the gradients are
  averaged (ZeRO 0/1) or flattened, padded, reduce-scattered and updated
  shard by shard (ZeRO 2/3, the parameters then gathered, or kept as
  shards at rest for 3), applied per (pp, tp) cell. LAMB keeps stages 2/3
  through the shard-norm rule (``spmd._lamb_rule_sharded``), its norms
  summed over ``pp``, over ``dp`` once the leaf is a flat shard, and over
  ``tp`` for a tensor-parallel leaf.

``sp`` and ``ep`` must be 1 inside the step: sequence sharding rides
``ring_attention`` and expert parallelism ``moe.moe_apply_a2a``, which a
stage function can call.

Snapshots are topology-independent: :meth:`Composed4DStep.state_snapshot`
gives every tensor in natural per-stage form (``param::p<i>::s<g>`` is
global stage ``g`` of leaf ``i``), so a snapshot taken at (dp=4, pp=1)
restores bit for bit into (dp=2, pp=2) and back.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import observability as _obs
from ..base import MXNetError
from .mesh import PartitionSpec, axis_size, current_mesh, validate_mesh_axes
from .pipeline import (_amp_wrap, _microbatch, _run_schedule, _tensor,
                       _update_leaves, build_pipeline_schedule,
                       stage_permutation)
from . import transport


def _prod(shape):
    out = 1
    for s in shape:
        out *= int(s)
    return out


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis_name):
        ctx.args = (mesh, axis_name)
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return transport.all_reduce(g.clone(), *ctx.args), None, None


def tp_copy(x, axis_name="tp", mesh=None):
    """Megatron's *f*: identity forward, sum over the ``tp`` ranks
    backward. Put it on a stage input consumed by a column-parallel
    product: each rank back-propagates its block's part of the input
    gradient and the sum restores the whole. ``mesh`` defaults to the
    mesh ``make_mesh`` made last."""
    mesh = mesh if mesh is not None else current_mesh()
    return _Copy.apply(x, mesh, axis_name)


def tp_all_gather(x, axis_name="tp", axis=-1, mesh=None):
    """Megatron's *g*: the ``tp`` ranks' blocks gathered along ``axis``
    forward, this rank's block sliced out of the cotangent backward (the
    right adjoint when every rank consumes the gathered tensor)."""
    from ..ops._sharded import _Gather

    mesh = mesh if mesh is not None else current_mesh()
    n = axis_size(mesh, axis_name)
    if n == 1:
        return x
    return _Gather.apply(x, axis % x.dim(), mesh.group(axis_name), n,
                         mesh.axis_index(axis_name))


def _gather_axis(t, mesh, name):
    """Each rank's ``t`` along axis ``name``, in axis order."""
    import torch.distributed as dist

    if axis_size(mesh, name) == 1:
        return [t]
    parts = [torch.empty_like(t) for _ in range(axis_size(mesh, name))]
    dist.all_gather(parts, t.contiguous(), group=mesh.group(name))
    return parts


def _is_spec(x):
    return x is None or isinstance(x, PartitionSpec)


class Composed4DStep:
    """Train over the composed ``(dp, pp, tp)`` mesh in one step.

    ``stage_params``: pytree whose leaves have a leading stage axis
    ``[L, ...]`` (``L`` a multiple of the ``pp`` size; ``L/pp`` virtual
    chunks a rank), the same on every rank. ``tp_specs``: optional
    matching pytree of ``PartitionSpec`` over the stage dimensions
    (``P(None, "tp")`` ...); leaves without one are whole on every tp
    rank. ``embed_fn(p, x_mb)`` / ``head_fn(p, h)`` bracket the pipeline
    with whole parameters. Each rank passes the global batch.

    >>> mesh = composed_mesh(dp=2, pp=2, tp=2)   # in a world of 8
    >>> step = Composed4DStep(stage_fn, params, mesh, loss_fn,
    ...                       optimizer="adam", zero_stage=2)
    >>> loss = step(x, y, lr=1e-3)
    """

    def __init__(self, stage_fn, stage_params, mesh, loss_fn, *,
                 optimizer="sgd", optimizer_params=None,
                 num_microbatches=None, schedule=None, zero_stage=0,
                 amp_dtype=None, tp_specs=None, embed_fn=None,
                 embed_params=None, head_fn=None, head_params=None,
                 device=None):
        from .. import fusedstep
        from .spmd import _RULES, _lamb_rule_sharded

        validate_mesh_axes(mesh, "Composed4DStep")
        if "pp" not in mesh.shape or "dp" not in mesh.shape:
            raise MXNetError(
                "Composed4DStep wants the composed mesh contract "
                "(dp, pp, ...); build it with composed_mesh()")
        for ax in ("sp", "ep"):
            if axis_size(mesh, ax) != 1:
                raise MXNetError(
                    f"Composed4DStep: {ax}={axis_size(mesh, ax)} — "
                    "sequence sharding rides ring_attention and expert "
                    "parallelism rides moe.moe_apply_a2a (call them "
                    f"from the stage function); keep {ax}=1 here")
        self._mesh = mesh
        S, dp, tp = (axis_size(mesh, a) for a in ("pp", "dp", "tp"))
        self._S, self._dp, self._tp = S, dp, tp
        self._r = mesh.axis_index("pp")
        self._j = mesh.axis_index("tp")
        self._k = mesh.axis_index("dp")

        leaves, spec = pytree.tree_flatten(stage_params)
        if not leaves:
            raise MXNetError("Composed4DStep: empty stage_params")
        leaves = [_tensor(a, device) for a in leaves]
        L = int(leaves[0].shape[0])
        for a in leaves:
            if int(a.shape[0]) != L:
                raise MXNetError(
                    "Composed4DStep: every stage_params leaf needs the "
                    f"same leading stage axis (got {a.shape[0]} vs {L})")
        if L % S:
            raise MXNetError(f"{L} stages do not tile the pp={S} axis")
        v = L // S
        self._L, self._v, self._spec = L, v, spec
        if schedule is None:
            schedule = "interleaved" if v > 1 else "1f1b"
        if schedule in ("gpipe", "1f1b") and v != 1:
            raise MXNetError(
                f"{schedule} runs one stage per rank: {L} stages != "
                f"pp={S} (use schedule='interleaved')")
        M = num_microbatches or fusedstep.pipeline_microbatches() or S
        self.schedule = build_pipeline_schedule(S, M, schedule, virtual=v)
        _obs.record_pipeline_schedule(
            self.schedule.name, self.schedule.bubble_fraction,
            self.schedule.stash_slots, ticks=self.schedule.ticks)
        self._M = M
        if optimizer not in _RULES:
            raise MXNetError(
                f"Composed4DStep supports {sorted(_RULES)}; got "
                f"{optimizer}")
        zero_stage = int(zero_stage)
        if zero_stage not in (0, 1, 2, 3):
            raise MXNetError(f"zero_stage must be 0..3; got {zero_stage}")
        self.zero_stage = zero_stage
        hyper = dict(optimizer_params or {})
        self._rule_init, self._rule_update = _RULES[optimizer](hyper)
        self._elementwise = optimizer != "lamb"
        self._fn = _amp_wrap(stage_fn, amp_dtype)
        self._loss_fn = loss_fn

        # --- per-leaf tp layout -------------------------------------
        if tp_specs is None:
            entries = [()] * len(leaves)
        else:
            got, _ = pytree.tree_flatten(tp_specs, is_leaf=_is_spec)
            if len(got) != len(leaves):
                raise MXNetError("tp_specs must match stage_params' "
                                 f"leaves ({len(got)} vs {len(leaves)})")
            entries = [tuple(s) if s is not None else () for s in got]
        self._tp_dim, self._stage_shapes, self._local_shapes = [], [], []
        for i, a in enumerate(leaves):
            ent = entries[i]
            bad = [e for e in ent if e not in (None, "tp")]
            if bad:
                raise MXNetError(
                    f"tp_specs leaf {i}: only the 'tp' axis may appear "
                    f"in stage specs (got {bad})")
            d = ent.index("tp") if "tp" in ent else None
            stage_shape = tuple(int(s) for s in a.shape[1:])
            local = list(stage_shape)
            if d is not None:
                if "tp" not in mesh.shape:
                    raise MXNetError("tp_specs name 'tp' but the mesh "
                                     "has no tp axis")
                if local[d] % tp:
                    raise MXNetError(
                        f"stage dim {d} ({local[d]}) of leaf {i} does "
                        f"not tile tp={tp}")
                local[d] //= tp
            self._tp_dim.append(d)
            self._stage_shapes.append(stage_shape)
            self._local_shapes.append(tuple(local))
        self._n_local = [v * _prod(sh) for sh in self._local_shapes]
        self._npad = [-(-n // dp) * dp for n in self._n_local]
        self._shard = [n // dp for n in self._npad]
        self._perm = stage_permutation(S, v)

        # --- storage ------------------------------------------------
        self._params, self._opt = [], []
        for i, a in enumerate(leaves):
            self._params.append(self._from_nat(i, a))
            self._opt.append(self._init_opt(i))

        self._extra = {}
        for part, p0 in (("embed", embed_params), ("head", head_params)):
            if p0 is None:
                continue
            fl, tdef = pytree.tree_flatten(p0)
            fl = [_tensor(t, device).detach().clone() for t in fl]
            self._extra[part] = (fl, tdef,
                                 [tuple(self._rule_init(t)) for t in fl])
        self._embed_fn, self._head_fn = embed_fn, head_fn

        # --- per-leaf update rules ------------------------------------
        if optimizer == "lamb":
            # the trust-ratio norms span the whole stacked leaf: summed
            # over every axis that splits it (pp always; dp once the leaf
            # is a flat shard; tp where tp_specs split it)
            self._leaf_update = []
            for i in range(len(leaves)):
                groups = [mesh.group(a) for a, on in (
                    ("pp", True), ("dp", zero_stage >= 2),
                    ("tp", self._tp_dim[i] is not None))
                    if on and axis_size(mesh, a) > 1]
                self._leaf_update.append(_lamb_rule_sharded(hyper,
                                                            groups)[1])
        else:
            self._leaf_update = [self._rule_update] * len(leaves)

    # --- storage layout ---------------------------------------------

    def _local_nat(self, i, nat):
        """``[L, *stage_shape]`` (natural order) -> this rank's chunks
        ``[v, *local_shape]``: its stages in permuted order, its tp
        block."""
        rows = [self._perm[self._r * self._v + c] for c in range(self._v)]
        t = nat[torch.as_tensor(rows, device=nat.device)]
        d = self._tp_dim[i]
        if d is not None:
            k = t.shape[d + 1] // self._tp
            t = t.narrow(d + 1, self._j * k, k)
        return t.contiguous()

    def _flat_shard(self, i, local):
        """This rank's ``[shard]`` of the padded flat ``local`` block."""
        flat = torch.nn.functional.pad(local.reshape(-1),
                                       (0, self._npad[i] - self._n_local[i]))
        return flat.narrow(0, self._k * self._shard[i],
                           self._shard[i]).clone()

    def _from_nat(self, i, nat):
        local = self._local_nat(i, nat.detach())
        if self.zero_stage >= 3:
            return self._flat_shard(i, local)
        return local.clone()

    def _init_opt(self, i):
        p = self._params[i]
        if self.zero_stage >= 2 and self.zero_stage < 3:
            p = self._flat_shard(i, p)
        return tuple(self._rule_init(p))

    def _gather_flat(self, i, shard):
        """The whole ``[v, *local_shape]`` block from the dp ranks'
        shards."""
        flat = torch.cat(_gather_axis(shard, self._mesh, "dp"))
        return flat[:self._n_local[i]].reshape(
            (self._v,) + self._local_shapes[i])

    # --- stepping ---------------------------------------------------

    def _rows(self, t):
        """This rank's rows of each microbatch ``[M, mb, ...]``."""
        mbl = t.shape[1] // self._dp
        return t.narrow(1, self._k * mbl, mbl)

    def _step(self, x, y, lr):
        mesh, dp = self._mesh, self._dp
        xs, ys = _microbatch(x, y, self._M)
        xs, ys = self._rows(xs), self._rows(ys)
        if self.zero_stage >= 3:
            nat = [self._gather_flat(i, p) for i, p in
                   enumerate(self._params)]
        else:
            nat = self._params
        embed = self._extra.get("embed")
        head = self._extra.get("head")
        loss, grads, aux = _run_schedule(
            self._fn, self._loss_fn, self.schedule, mesh, "pp",
            pytree.tree_unflatten(list(nat), self._spec), xs, ys,
            head_fn=self._head_fn if head else None,
            head_params=pytree.tree_unflatten(head[0], head[1])
            if head else None,
            embed_fn=self._embed_fn if embed else None,
            embed_params=pytree.tree_unflatten(embed[0], embed[1])
            if embed else None)
        loss = self._dp_mean(loss)
        grads = pytree.tree_flatten(grads)[0]
        del nat
        with torch.no_grad():
            for i in range(len(grads)):
                g, grads[i] = grads[i], None
                self._update_leaf(i, g, lr)
            for part in ("embed", "head"):
                if aux[part] is None:
                    continue
                fl, _, opt = self._extra[part]
                gs = [self._dp_mean(g)
                      for g in pytree.tree_flatten(aux[part])[0]]
                aux[part] = None
                _update_leaves(self._rule_update, fl, gs, opt, lr,
                               self._elementwise)
        return loss

    def _dp_mean(self, t):
        """``t`` (this step's own) averaged over ``dp`` in place."""
        if self._dp == 1:
            return t
        return transport.all_reduce(t, self._mesh, "dp").div_(self._dp)

    def _update_leaf(self, i, g, lr):
        import torch.distributed as dist

        mesh, dp = self._mesh, self._dp
        update = self._leaf_update[i]
        if self.zero_stage < 2:
            ps, opts = self._params[i:i + 1], self._opt[i:i + 1]
            _update_leaves(update, ps, [self._dp_mean(g)], opts, lr,
                           self._elementwise)
            self._params[i], self._opt[i] = ps[0], opts[0]
            return
        gflat = torch.nn.functional.pad(
            g.reshape(-1), (0, self._npad[i] - self._n_local[i]))
        if dp > 1:
            gsh = torch.empty(self._shard[i], dtype=g.dtype,
                              device=g.device)
            dist.reduce_scatter_tensor(gsh, gflat,
                                       group=mesh.group("dp"))
            gsh = gsh / dp
        else:
            gsh = gflat
        wsh = self._params[i] if self.zero_stage >= 3 \
            else self._flat_shard(i, self._params[i])
        w2, st2 = update(wsh, gsh, self._opt[i], lr)
        self._opt[i] = tuple(st2)
        self._params[i] = w2 if self.zero_stage >= 3 \
            else self._gather_flat(i, w2).reshape(self._params[i].shape)

    def __call__(self, x, y, lr=0.01):
        """One step on the global batch; the loss (a 0-d tensor, the same
        on every rank)."""
        dev = self._params[0].device
        x, y = _tensor(x, dev), _tensor(y, dev)
        if (x.shape[0] // self._M) % self._dp:
            raise MXNetError(
                f"microbatch size {x.shape[0] // self._M} does not "
                f"tile the dp={self._dp} axis")
        return self._step(x, y, torch.tensor(lr, dtype=torch.float32,
                                             device=dev))

    def run_superstep(self, x, y, lr=0.01):
        """``k`` steps, one per slot of ``x``/``y`` (leading with the step
        axis ``[k, B, ...]``), with no host synchronisation between them.
        Returns the ``k`` losses, one tensor."""
        dev = self._params[0].device
        x, y = _tensor(x, dev), _tensor(y, dev)
        k, B = x.shape[0], x.shape[1]
        if B % self._M or (B // self._M) % self._dp:
            raise MXNetError(
                f"superstep batch {B} must tile microbatches {self._M} x "
                f"dp={self._dp}")
        lr = torch.tensor(lr, dtype=torch.float32, device=dev)
        return torch.stack([self._step(x[i], y[i], lr) for i in range(k)])

    def schedule_report(self):
        return self.schedule.report()

    def memory_report(self):
        """This rank's bytes by storage plane, and the schedule's stash
        cost: what a layout trades."""
        def nbytes(ts):
            return int(sum(t.numel() * t.element_size()
                           for t in pytree.tree_flatten(ts)[0]))

        extra = [(fl, opt) for fl, _, opt in self._extra.values()]
        return {"zero_stage": self.zero_stage,
                "schedule": self.schedule.name,
                "bubble_fraction": round(self.schedule.bubble_fraction, 6),
                "stash_slots": self.schedule.stash_slots,
                "param_bytes_per_device": nbytes(self._params),
                "opt_bytes_per_device": nbytes(self._opt),
                "extra_bytes_per_device": nbytes(extra)}

    # --- topology-independent snapshot and restore ------------------

    def _whole(self, i, local):
        """Leaf ``i``'s ``[L, *stage_shape]`` in natural stage order from
        every rank's ``[v, *local_shape]`` block (collective)."""
        d = self._tp_dim[i]
        if d is not None:
            local = torch.cat(_gather_axis(local, self._mesh, "tp"),
                              dim=d + 1)
        per_rank = _gather_axis(local, self._mesh, "pp")
        nat = torch.empty((self._L,) + tuple(local.shape[1:]),
                          dtype=local.dtype, device=local.device)
        for r, blk in enumerate(per_rank):
            for c in range(self._v):
                nat[self._perm[r * self._v + c]] = blk[c]
        return nat

    def state_snapshot(self):
        """``(chunks, extents)``: every tensor in natural per-stage form,
        keyed independently of the layout (``param::p<i>::s<g>``,
        ``opt::p<i>::s<g>::<li>``, a scalar state leaf at ``s0``,
        ``embed::p<j>``/``head::p<j>`` and ``embed_opt::p<j>``/
        ``head_opt::p<j>``), the same on every rank. Every rank calls it:
        it gathers over the mesh. A snapshot from any (dp, pp, tp)
        restores into any other."""
        chunks, extents = {}, {}

        def put(key, t):
            a = np.array(t.detach().cpu().numpy(), copy=True)
            chunks[key] = [(tuple(slice(0, s) for s in a.shape), a)]
            extents[key] = a.shape

        for i in range(len(self._params)):
            p = self._params[i]
            local = self._gather_flat(i, p) if self.zero_stage >= 3 else p
            nat = self._whole(i, local)
            for g in range(self._L):
                put(f"param::p{i}::s{g}", nat[g])
            for li, leaf in enumerate(self._opt[i]):
                if leaf.dim() == 0:
                    put(f"opt::p{i}::s0::{li}", leaf)
                    continue
                local = self._gather_flat(i, leaf) \
                    if self.zero_stage >= 2 else leaf
                nat_o = self._whole(i, local)
                for g in range(self._L):
                    put(f"opt::p{i}::s{g}::{li}", nat_o[g])
        for part, (fl, _, opt) in self._extra.items():
            for j, leaf in enumerate(fl):
                put(f"{part}::p{j}", leaf)
            for j, leaf in enumerate(x for st in opt for x in st):
                put(f"{part}_opt::p{j}", leaf)
        return chunks, extents

    def restore_chunks(self, chunks, extents=None):
        """Load a :meth:`state_snapshot` (possibly taken on another
        (dp, pp, tp) layout) into this step's storage."""
        del extents  # implied by this step's own shapes

        def paste(key, like, shape):
            if key not in chunks:
                raise MXNetError(f"restore: missing snapshot key {key}")
            out = np.zeros(shape, like.detach().cpu().numpy().dtype)
            for idx, data in chunks[key]:
                out[idx] = data
            return torch.as_tensor(out).to(like.device)

        for i in range(len(self._params)):
            like = self._params[i]
            nat = torch.stack([paste(f"param::p{i}::s{g}", like,
                                     self._stage_shapes[i])
                               for g in range(self._L)])
            self._params[i] = self._from_nat(i, nat)
            new_st = []
            for li, leaf in enumerate(self._opt[i]):
                if leaf.dim() == 0:
                    new_st.append(paste(f"opt::p{i}::s0::{li}", leaf, ()))
                    continue
                nat_o = torch.stack([paste(f"opt::p{i}::s{g}::{li}", leaf,
                                           self._stage_shapes[i])
                                     for g in range(self._L)])
                local = self._local_nat(i, nat_o)
                new_st.append(self._flat_shard(i, local)
                              if self.zero_stage >= 2 else local)
            self._opt[i] = tuple(new_st)
        for part, (fl, tdef, opt) in self._extra.items():
            new_p = [paste(f"{part}::p{j}", leaf, tuple(leaf.shape))
                     for j, leaf in enumerate(fl)]
            flat_o = [x for st in opt for x in st]
            got = [paste(f"{part}_opt::p{j}", leaf, tuple(leaf.shape))
                   for j, leaf in enumerate(flat_o)]
            new_o, at = [], 0
            for st in opt:
                new_o.append(tuple(got[at:at + len(st)]))
                at += len(st)
            self._extra[part] = (new_p, tdef, new_o)
