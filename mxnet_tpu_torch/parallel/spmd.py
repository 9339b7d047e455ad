"""The train step of a Gluon block, on one device or data-parallel over
the ranks of a mesh.

PyTorch counterpart of ``mxnet_tpu/parallel/spmd.py``. On one device
(``mesh=None``): the block's forward, the mean loss, the gradients of the
differentiable parameters and the optimizer rule on each, over the step's
own copy of the parameters, which goes back into the block at
``sync_to_block``. The JAX package compiles that step into one XLA
executable; here it runs eagerly, with no host synchronisation inside a
step or between the steps of ``run_steps``. The update rules (``_RULES``,
``mp_rule``) are pure functions of tensors, as in the JAX package; the
step applies them to all parameters at once through the multi-tensor
update it shares with ``gluon.Trainer`` (``optimizer/multi_tensor.py``),
or one parameter at a time under ``MXTPU_FUSED_STEP=0``.

On a mesh (``parallel.make_mesh({"dp": n})``) the step is one controller
per rank (``parallel/mesh.py``): each rank passes the global batch, runs
the forward and backward on its rows (:func:`shard_batch`), and the
gradients are summed over the data axis's process group in buckets
(``parallel/overlap.py``) and scaled by 1/dp: the loss is the mean over
the global batch, as the reference's postscale computes it. ZeRO stage 0
keeps everything replicated; 1 shards the optimizer state (each rank
updates its ``[pad/dp]`` flat shard of every parameter and the shards are
all-gathered back); 2 also reduce-scatters the gradients; 3 also keeps
the parameters as flat shards at rest, gathered at the start of each
step. The update is elementwise, so every stage gives stage 0's numbers
bit for bit. ``overlap``: ``ready`` starts each bucket's collective
(``async_op``) from a gradient hook as soon as the bucket's last
gradient exists and waits before the update; ``barrier`` starts them all
after the backward; ``staged`` runs them one by one after it, each waited
on (the exposed-comm baseline).

Tensor parallelism (``param_sharding``: parameter name ->
:class:`~.mesh.PartitionSpec` over the mesh's other axes, e.g.
``Llama.tp_sharding_map()``) is the counterpart of the reference's GSPMD
path. Each parameter is held at rest as this rank's block of it; the
forward binds each block as a ``torch.distributed.tensor.DTensor`` on the
mesh's sharded axes (``Shard(d)`` where the spec names an axis,
``Replicate()`` elsewhere), and the block's forward and backward run
unchanged on those tensors. The operators that would otherwise gather
(``FullyConnected``, ``Embedding``, ``flash_attention``, ``logsumexp``)
compute on their local blocks with Megatron's collectives; the gradient
of each block comes back through ``DTensor.from_local``, which sums a
replicated parameter's partial gradients over its ranks. The data axis's
sum and the update act on the local blocks, and ZeRO stages 1-3 shard the
optimizer state as the reference's ``_opt_state_spec`` lays it out: the
tensor-parallel spec extended along the first free dimension that divides
by dp. :func:`spmd_save_states` writes the reference's shard files, in
logical coordinates, which either package reads onto any mesh. A ``pp``
axis is the pipeline executor's (``parallel.PipelineTrainStep``,
``parallel.Composed4DStep``): the step declines it, as the reference
does.
"""

from __future__ import annotations

import time

import torch
from torch.overrides import TorchFunctionMode

import numpy as _np

from .. import autograd
from .. import fusedstep as _fusedstep
from .. import observability as _obs
from ..base import MXNetError
from ..gluon.block import _bound
from ..ndarray.ndarray import NDArray, array, torch_dtype
from ..optimizer import multi_tensor
from ..amp.policy import is_low_precision_dtype
from . import overlap as _overlap


def _state_dtype(w):
    """Multi-precision rule (reference: ``mp_sgd_update``/``mp_adam_update``
    in optimizer_op): low-precision weights carry fp32 optimizer state and
    update in fp32 master math, casting back on write."""
    return torch.float32 if w.dtype in (torch.bfloat16, torch.float16) \
        else w.dtype


def _sgd_rule(hyper):
    mom = hyper.get("momentum", 0.0)
    wd_const = hyper.get("wd", 0.0)

    def init(w):
        return (torch.zeros(w.shape, dtype=_state_dtype(w),
                            device=w.device),) if mom else ()

    def update(w, g, state, lr, wd=wd_const):
        dt = _state_dtype(w)
        w32, g32, lr32 = w.to(dt), g.to(dt), lr.to(dt)
        g32 = g32 + wd * w32
        if mom:
            m = mom * state[0] - lr32 * g32
            return (w32 + m).to(w.dtype), (m,)
        return (w32 - lr32 * g32).to(w.dtype), ()

    return init, update


def _moments_init(w):
    dt = _state_dtype(w)
    return (torch.zeros(w.shape, dtype=dt, device=w.device),
            torch.zeros(w.shape, dtype=dt, device=w.device),
            torch.zeros((), dtype=torch.int32, device=w.device))


def _adam_rule(hyper):
    beta1 = hyper.get("beta1", 0.9)
    beta2 = hyper.get("beta2", 0.999)
    eps = hyper.get("epsilon", 1e-8)
    wd_const = hyper.get("wd", 0.0)

    def update(w, g, state, lr, wd=wd_const):
        dt = _state_dtype(w)
        m, v, t = state
        t = t + 1
        w32, g32, lr32 = w.to(dt), g.to(dt), lr.to(dt)
        g32 = g32 + wd * w32
        m = beta1 * m + (1 - beta1) * g32
        v = beta2 * v + (1 - beta2) * torch.square(g32)
        tf = t.to(dt)
        lr_t = lr32 * torch.sqrt(1 - beta2 ** tf) / (1 - beta1 ** tf)
        return (w32 - lr_t * m / (torch.sqrt(v) + eps)).to(w.dtype), \
            (m, v, t)

    return _moments_init, update


def _lamb_rule(hyper):
    beta1 = hyper.get("beta1", 0.9)
    beta2 = hyper.get("beta2", 0.999)
    eps = hyper.get("epsilon", 1e-6)
    wd_const = hyper.get("wd", 0.0)

    def update(w, g, state, lr, wd=wd_const):
        dt = _state_dtype(w)
        m, v, t = state
        t = t + 1
        w32, g32, lr32 = w.to(dt), g.to(dt), lr.to(dt)
        m = beta1 * m + (1 - beta1) * g32
        v = beta2 * v + (1 - beta2) * torch.square(g32)
        tf = t.to(dt)
        m_hat = m / (1 - beta1 ** tf)
        v_hat = v / (1 - beta2 ** tf)
        r = m_hat / (torch.sqrt(v_hat) + eps) + wd * w32
        w_norm = torch.linalg.norm(w32)
        r_norm = torch.linalg.norm(r)
        ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        return (w32 - lr32 * ratio * r).to(w.dtype), (m, v, t)

    return _moments_init, update


def _nag_rule(hyper):
    """Nesterov momentum, matching ``optimizer.NAG.update``."""
    mom = hyper.get("momentum", 0.0)
    wd_const = hyper.get("wd", 0.0)

    def init(w):
        return (torch.zeros(w.shape, dtype=_state_dtype(w),
                            device=w.device),) if mom else ()

    def update(w, g, state, lr, wd=wd_const):
        dt = _state_dtype(w)
        w32, g32, lr32 = w.to(dt), g.to(dt), lr.to(dt)
        g32 = g32 + wd * w32
        if mom:
            m = mom * state[0] + g32
            return (w32 - lr32 * (g32 + mom * m)).to(w.dtype), (m,)
        return (w32 - lr32 * g32).to(w.dtype), ()

    return init, update


def _lamb_rule_sharded(hyper, group):
    """LAMB over a flat dp-shard (ZeRO 1-3) or a tensor-parallel block:
    :func:`_lamb_rule`'s arithmetic with the trust-ratio norms summed over
    the ranks of ``group`` (a list: over each group in turn; one
    ``all_reduce`` each); the pad region is zeros in both the weight and
    the step, so the norms are the whole parameter's."""
    groups = list(group) if isinstance(group, (list, tuple)) else [group]
    beta1 = hyper.get("beta1", 0.9)
    beta2 = hyper.get("beta2", 0.999)
    eps = hyper.get("epsilon", 1e-6)
    wd_const = hyper.get("wd", 0.0)

    def norm(t):
        import torch.distributed as dist

        sq = torch.sum(t * t).reshape(1)
        for g in groups:
            dist.all_reduce(sq, group=g)
        return torch.sqrt(sq[0])

    def update(w, g, state, lr, wd=wd_const):
        dt = _state_dtype(w)
        m, v, t = state
        t = t + 1
        w32, g32, lr32 = w.to(dt), g.to(dt), lr.to(dt)
        m = beta1 * m + (1 - beta1) * g32
        v = beta2 * v + (1 - beta2) * torch.square(g32)
        tf = t.to(dt)
        m_hat = m / (1 - beta1 ** tf)
        v_hat = v / (1 - beta2 ** tf)
        r = m_hat / (torch.sqrt(v_hat) + eps) + wd * w32
        w_norm, r_norm = norm(w32), norm(r)
        ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        return (w32 - lr32 * ratio * r).to(w.dtype), (m, v, t)

    return _moments_init, update


_RULES = {"sgd": _sgd_rule, "nag": _nag_rule, "adam": _adam_rule,
          "adamw": _adam_rule, "lamb": _lamb_rule}

_MP_SENTINEL = object()


def mp_rule(rule_init, rule_update):
    """fp32 master-weight wrapper around a ``_RULES`` pair (reference:
    ``mp_sgd_update``/``mp_adam_update``): for bf16/fp16 params the fp32
    master copy becomes state leaf 0, updates accumulate in the master
    across steps and the stored weight is a rounded copy of it. fp32
    params pass through untouched."""

    def init(w):
        if not is_low_precision_dtype(w.dtype):
            return rule_init(w)
        master = w.to(torch.float32)
        return (master,) + tuple(rule_init(master))

    def update(w, g, state, lr, wd=_MP_SENTINEL):
        kw = {} if wd is _MP_SENTINEL else {"wd": wd}
        if not is_low_precision_dtype(w.dtype):
            return rule_update(w, g, state, lr, **kw)
        master, inner = state[0], tuple(state[1:])
        new_master, new_inner = rule_update(
            master, g.to(torch.float32), inner, lr, **kw)
        return new_master.to(w.dtype), (new_master,) + tuple(new_inner)

    return init, update


def _raw(x):
    """The tensor behind ``x``: an NDArray's, a tensor itself, or an
    array-like placed on the current context (``nd.array``)."""
    if isinstance(x, NDArray):
        return x.data
    return x if isinstance(x, torch.Tensor) else array(x).data


def bucketed_psum(grads, axis_name, bucket_bytes=None, mesh=None):
    """Bucketed gradient sum over ``mesh``'s axis ``axis_name`` (default:
    the mesh ``make_mesh`` made last): one ``all_reduce`` per
    ~``bucket_bytes`` (default ``MXTPU_BUCKET_BYTES``) dtype-homogeneous
    flat bucket instead of one per tensor, greedy in the gradients' order
    within a dtype, as the reference's in-graph ``lax.psum`` buckets.
    Returns new tensors in the original order, shapes and dtypes; an axis
    of one rank returns copies."""
    from . import transport
    from .mesh import current_mesh

    mesh = mesh if mesh is not None else current_mesh()
    target = int(bucket_bytes if bucket_bytes is not None
                 else _fusedstep.bucket_bytes())
    flat = [g.reshape(-1) for g in grads]
    buckets, open_by_dtype = [], {}
    for i, f in enumerate(flat):
        nbytes = f.numel() * f.element_size()
        cur = open_by_dtype.get(f.dtype)
        if cur is None or (cur[1] + nbytes > target and cur[0]):
            cur = [[], 0]
            open_by_dtype[f.dtype] = cur
            buckets.append(cur)
        cur[0].append(i)
        cur[1] += nbytes
    out = [None] * len(grads)
    for idxs, _ in buckets:
        red = transport.all_reduce(torch.cat([flat[i] for i in idxs]),
                                   mesh, axis_name)
        off = 0
        for i in idxs:
            n = flat[i].numel()
            out[i] = red[off:off + n].reshape(grads[i].shape)
            off += n
    return out


def shard_batch(arr, mesh, axis_name="dp", device=None):
    """This rank's rows of the global batch ``arr`` (an NDArray, tensor or
    numpy array, the same on every rank), on ``device`` (default: where
    ``arr`` lies; the current context for numpy): rank ``r`` of the data
    axis takes rows ``[r*B/dp, (r+1)*B/dp)``. The multi-controller
    counterpart of the reference's global array sharded along its leading
    axis: the global batch is the concatenation of the ranks' rows."""
    raw = arr.data if isinstance(arr, NDArray) else arr
    if not isinstance(raw, torch.Tensor):
        raw = array(_np.asarray(arr), dtype=_np.asarray(arr).dtype).data
    n = int(mesh.shape.get(axis_name, 1)) if mesh is not None else 1
    if raw.shape[0] % n:
        raise MXNetError(f"shard_batch: batch of {raw.shape[0]} rows does "
                         f"not split over {axis_name}={n}")
    b = raw.shape[0] // n
    r = mesh.axis_index(axis_name) if mesh is not None else 0
    part = raw[r * b:(r + 1) * b]
    return part if device is None else part.to(device)


def replicate(arr, mesh, device=None):
    """``arr`` as a tensor on ``device``, the same on every rank: in the
    multi-controller port each rank holds its own full copy (the
    reference's replicated global array)."""
    del mesh
    raw = arr.data if isinstance(arr, NDArray) else arr
    if not isinstance(raw, torch.Tensor):
        raw = array(_np.asarray(arr), dtype=_np.asarray(arr).dtype).data
    return raw if device is None else raw.to(device)


class _ReplicatePlain(TorchFunctionMode):
    """While a tensor-parallel forward runs: a plain tensor that meets a
    DTensor in one call (a constant such as RoPE's angles, a mask, an
    index) joins it as a replicated DTensor, so that the graph saves
    DTensors only and the backward, which may run on another thread,
    never mixes the two."""

    def __init__(self, mesh):
        super().__init__()
        self.mesh = mesh

    def __torch_function__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor, Replicate
        from torch.utils._pytree import tree_flatten, tree_unflatten

        kwargs = kwargs or {}
        flat, tree = tree_flatten((args, kwargs))
        if any(isinstance(a, DTensor) for a in flat) and \
                any(type(a) is torch.Tensor for a in flat):
            rep = [Replicate()] * self.mesh.ndim
            flat = [DTensor.from_local(a, self.mesh, rep, run_check=False)
                    if type(a) is torch.Tensor else a for a in flat]
            args, kwargs = tree_unflatten(flat, tree)
        return func(*args, **kwargs)


def _meta_like(t):
    """``t``'s shape, dtype and ``requires_grad`` with no storage."""
    return torch.empty_like(t, device="meta").requires_grad_(
        t.requires_grad)


def _take(t, spans):
    """The block ``spans`` (a ``(start, stop)`` per dimension) of ``t``."""
    return t[tuple(slice(a, b) for a, b in spans)] if spans else t


class SPMDTrainStep:
    """Train step for a Gluon block, on one device or over a mesh.

    >>> step = SPMDTrainStep(net, loss_fn, "adam", {}, mesh=None)
    >>> loss = step(batch_x, batch_y, lr=1e-4)       # a float
    >>> loss = step.run_steps(batch_x, batch_y, 10)  # on the device
    >>> losses = step.run_superstep(xs, ys, lr=[1e-4] * 4)  # K batches
    >>> mesh = parallel.make_mesh({"dp": 2})         # in a world of 2
    >>> step = SPMDTrainStep(net, loss_fn, "adam", {}, mesh, zero_stage=2)

    The loss is the mean over the (global) batch of ``loss_fn(block(x),
    y)``. The step keeps its own copy of the parameters and the optimizer
    state; the Gluon parameters keep their values until
    :meth:`sync_to_block`. Auxiliary state that the forward writes
    (BatchNorm's running statistics) is carried in the step's copy, and on
    a mesh averaged over the ranks. Dropout draws from the device's
    ``mx.random`` stream, so ``mx.random.seed`` repeats a run.

    On one device (``mesh=None`` or a data axis of 1) ZeRO shards
    nothing, ``overlap``, ``compression_params`` and ``grad_dtype`` have
    nothing to act on (as in the JAX package's single-device path), and
    ``donate`` has nothing to donate: the step replaces its tensors. The
    mesh path is the module docstring's.
    """

    def __init__(self, block, loss_fn, optimizer="sgd", optimizer_params=None,
                 mesh=None, batch_axis="dp", param_sharding=None,
                 shard_opt_states=False, grad_dtype=None, donate=True,
                 multi_precision=False, zero_stage=None, overlap=None,
                 compression_params=None):
        del donate
        if mesh is not None:
            from .mesh import Mesh, axis_size, validate_mesh_axes

            if not isinstance(mesh, Mesh):
                raise MXNetError("SPMDTrainStep: mesh must come from "
                                 "parallel.make_mesh")
            validate_mesh_axes(mesh, "SPMDTrainStep")
            if axis_size(mesh, "pp") > 1:
                raise MXNetError(
                    "SPMDTrainStep shards data/tensor axes only; a "
                    f"pp={axis_size(mesh, 'pp')} mesh needs the "
                    "pipeline executor — use Composed4DStep (or "
                    "PipelineTrainStep for pp alone)")
        from .mesh import PartitionSpec

        self._param_sharding = {n: PartitionSpec(*tuple(spec))
                                for n, spec in (param_sharding or {}).items()}
        if mesh is not None:
            for n, spec in self._param_sharding.items():
                for ax in spec:
                    for a in (ax if isinstance(ax, tuple) else (ax,)):
                        if a is None:
                            continue
                        if a not in mesh.shape:
                            raise MXNetError(
                                f"param_sharding[{n!r}] = {spec}: the mesh "
                                f"{mesh.shape} has no axis {a!r}")
                        if a == batch_axis:
                            raise MXNetError(
                                f"param_sharding[{n!r}] = {spec}: a "
                                f"parameter sharded over the batch axis "
                                f"{a!r} is ZeRO's (zero_stage), not a spec")
                    if isinstance(ax, tuple):
                        raise MXNetError(
                            f"param_sharding[{n!r}] = {spec}: one axis per "
                            "dimension")
        if optimizer not in _RULES:
            raise MXNetError(
                f"SPMD step supports {sorted(_RULES)}; got {optimizer}. "
                "Use gluon.Trainer for other optimizers.")
        if zero_stage is None:
            zero_stage = 1 if shard_opt_states else _fusedstep.zero_stage()
        if int(zero_stage) not in (0, 1, 2, 3):
            raise MXNetError(f"zero_stage must be 0-3, got {zero_stage}")
        self.zero_stage = int(zero_stage)
        # the reference's ZeRO-1 flag; the tensor-parallel path also sets
        # it from stage 2 (``_mesh_mode``)
        self._shard_opt_states = bool(shard_opt_states) or \
            self.zero_stage == 1
        self._overlap_explicit = overlap is not None
        if overlap is None:
            self._overlap_mode = _fusedstep.overlap_mode()
        elif overlap is True:
            self._overlap_mode = "ready"
        elif overlap is False:
            self._overlap_mode = "barrier"
        else:
            self._overlap_mode = str(overlap)
        if self._overlap_mode not in ("ready", "barrier", "staged",
                                      "nocomm"):
            raise MXNetError(f"overlap mode {overlap!r} not one of "
                             "ready/barrier/staged (True/False ok)")
        self._grad_dtype = None if grad_dtype is None \
            else torch_dtype(grad_dtype)
        self._compress_thr = None
        if compression_params:
            ctype = compression_params.get("type", "2bit")
            if ctype != "2bit":
                raise MXNetError(f"unsupported compression type {ctype}")
            self._compress_thr = float(
                compression_params.get("threshold", 0.5))
        self.block = block
        self.loss_fn = loss_fn
        self.mesh = mesh
        self.batch_axis = batch_axis
        self._optimizer = optimizer
        self._hyper = dict(optimizer_params or {})
        self._multi_precision = multi_precision
        self._num_update = 0  # steps since init_state: the bias correction
        self._rule_init, self._rule_update = _RULES[optimizer](self._hyper)
        if multi_precision:
            self._rule_init, self._rule_update = mp_rule(
                self._rule_init, self._rule_update)
        self._state = None  # ([param tensors], [optimizer state tuples])
        self._device = None  # the parameters' device, from init_state
        self._names = self._handles = self._diff = None
        self._last_loss = None
        self._mode = None  # resolved at init_state: jit|overlap|staged|tp
        self._plan = None  # the bucket plan, from the first mesh step
        self._residuals = None  # per-bucket 2-bit compression carry
        self._pending_residual_chunks = None  # restored before the plan

    # -- mode resolution ----------------------------------------------------
    def _dp_size(self):
        if self.mesh is None:
            return 1
        return int(self.mesh.shape.get(self.batch_axis, 1))

    def _mesh_mode(self):
        """``jit`` (one device, or ZeRO-1: the reference's single-executable
        GSPMD path; the port sums after the backward), ``overlap`` (bucket
        collectives in the ``ready``/``barrier`` schedule, ZeRO 0/2/3) or
        ``staged`` (the exposed-comm baseline), with the reference's
        logged fallbacks."""
        def _jit(reason):
            if self._overlap_explicit and self._overlap_mode != "ready":
                _fusedstep.log_fallback(
                    "spmd", f"overlap={self._overlap_mode!r} has no "
                    f"effect on the {reason} path; running the "
                    "single-schedule step")
            return "jit"

        if self._tp_axes():
            if self.zero_stage >= 2:
                # the reference composes dp's optimizer-state shard with
                # the tensor partition (``_opt_state_spec``)
                self._shard_opt_states = True
            if self._overlap_explicit and self._overlap_mode != "ready":
                _fusedstep.log_fallback(
                    "spmd", f"overlap={self._overlap_mode!r} has no "
                    "effect on the tensor-parallel path; its data-axis sum "
                    "runs after the backward")
            return "tp"
        if self.mesh is None or self._dp_size() <= 1:
            return _jit("single-device")
        if self.zero_stage == 1:
            return _jit("ZeRO-1")
        if self._overlap_mode == "staged":
            if self.zero_stage >= 2:
                _fusedstep.log_fallback(
                    "spmd", "staged mode has no ZeRO-2/3 layout; "
                    "running the barrier mode instead")
                self._overlap_mode = "barrier"
                return "overlap"
            if self._compress_thr is not None:
                _fusedstep.log_fallback(
                    "spmd", "staged mode has no compressed-comm path "
                    "(it is the uncompressed measurement baseline); "
                    "running the barrier mode instead")
                self._overlap_mode = "barrier"
                return "overlap"
            return "staged"
        return "overlap"

    def _on_mesh(self):
        return self._mode == "tp" or (self.mesh is not None
                                      and self._dp_size() > 1)

    def _tp_axes(self):
        """The mesh axes (of more than one rank) that some parameter's
        spec names, in the mesh's order."""
        if self.mesh is None:
            return ()
        named = {a for spec in self._param_sharding.values() for a in spec
                 if a is not None}
        return tuple(a for a in self.mesh.axis_names
                     if a in named and self.mesh.shape[a] > 1)

    def _spec(self, name, ndim):
        """The parameter's spec, one entry per dimension (None: whole),
        with the axes of one rank dropped."""
        spec = tuple(self._param_sharding.get(name, ()))
        spec = spec + (None,) * (ndim - len(spec))
        return tuple(a if a is not None and self.mesh.shape.get(a, 1) > 1
                     else None for a in spec[:ndim])

    def _opt_state_spec(self, name, shape):
        """The spec of a moment tensor of parameter ``name`` (reference:
        ``_opt_state_spec``): the parameter's own, or at ZeRO >= 1 that
        spec with the batch axis on the first free dimension whose
        tensor-parallel extent divides by dp, or dim 0 of an unsharded
        parameter when it divides."""
        import logging

        from .mesh import PartitionSpec

        pspec = self._spec(name, len(shape))
        dp = self._dp_size()
        if not self._shard_opt_states or dp <= 1:
            return PartitionSpec(*pspec)
        if any(a is not None for a in pspec):
            for d, a in enumerate(pspec):
                if a is None and shape[d] % dp == 0:
                    return PartitionSpec(*(pspec[:d] + (self.batch_axis,)
                                           + pspec[d + 1:]))
            logging.getLogger(__name__).warning(
                "ZeRO-%d: opt state for %r (shape %s, tp spec %s) has no "
                "free dp-divisible dim; this moment stays on the param "
                "sharding (replicated over dp)", self.zero_stage, name,
                tuple(shape), pspec)
            return PartitionSpec(*pspec)
        if len(shape) >= 1 and shape[0] % dp == 0:
            return PartitionSpec(self.batch_axis, *pspec[1:])
        logging.getLogger(__name__).warning(
            "ZeRO-1: opt state for %r (shape %s) not divisible by dp=%d; "
            "falling back to the param sharding %s", name, tuple(shape),
            dp, pspec)
        return PartitionSpec(*pspec)

    def _spans(self, shape, spec):
        """This rank's block of a tensor of ``shape`` laid out by
        ``spec``: a ``(start, stop)`` per dimension, in global
        coordinates."""
        out = []
        for d, n in enumerate(shape):
            a = spec[d] if d < len(spec) else None
            if a is None:
                out.append((0, int(n)))
                continue
            k = int(self.mesh.shape[a])
            if n % k:
                raise MXNetError(f"a dimension of {n} does not split over "
                                 f"{a}={k}")
            i = self.mesh.axis_index(a)
            out.append((i * (n // k), (i + 1) * (n // k)))
        return tuple(out)

    # -- state ------------------------------------------------------------
    def _collect(self):
        items = sorted(self.block.collect_params().items())
        names = [n for n, _ in items]
        handles = [p.data() for _, p in items]
        diff = [p.grad_req != "null" for _, p in items]
        return names, handles, diff

    def init_state(self):
        """Copy the block's parameters into the step and initialise the
        optimizer state of each differentiable one: whole on one device
        and at ZeRO stage 0; from stage 1 each state leaf the size of its
        parameter is this rank's ``[pad/dp]`` flat shard, and at stage 3
        the parameter itself too."""
        if self._mode == "tp" and self._state is not None and any(
                h.data.is_meta for h in self._handles):
            # the step holds the values the block released to it
            self.sync_to_block()
        names, handles, diff = self._collect()
        self._names, self._handles, self._diff = names, handles, diff
        self._device = handles[0].data.device
        self._mode = self._mesh_mode()
        self._num_update = 0
        self._plan = self._residuals = None
        if not self._on_mesh():
            params = [h.data.detach().clone().requires_grad_(d)
                      for h, d in zip(handles, diff)]
            opt_states = [tuple(self._rule_init(p.detach())) if d else ()
                          for p, d in zip(params, diff)]
            self._state = (params, opt_states)
            self._opt_sharded = [[False] * len(st) for st in opt_states]
            return
        from .mesh import world

        dp = self._dp_size()
        if self._mode == "tp":
            return self._init_state_tp()
        if self.mesh.size > world()[1]:
            raise MXNetError(
                f"SPMDTrainStep: a mesh of {self.mesh.size} ranks in a world "
                f"of {world()[1]}; join the world first "
                "(kvstore.init_distributed)")
        # a data-parallel mesh may cover part of the world (an elastic
        # topology); its members step, the other ranks build no state
        self.mesh._member("SPMDTrainStep.init_state")
        self._group = self.mesh.group(self.batch_axis)
        self._rank = self.mesh.axis_index(self.batch_axis)
        self._pads = [_overlap._ceil_to(h.data.numel(), dp) for h in handles]
        params, opt_states = [], []
        for i, (h, d) in enumerate(zip(handles, diff)):
            full = h.data.detach().clone()
            shard = self._shard(full, i).clone() \
                if d and self.zero_stage >= 1 else None
            params.append(shard.requires_grad_() if self.zero_stage == 3
                          and d else full.requires_grad_(d))
            basis = shard if shard is not None else full
            opt_states.append(tuple(self._rule_init(basis)) if d else ())
        self._state = (params, opt_states)
        # a leaf is a shard when it is the size of its parameter's shard
        self._opt_sharded = [
            [self.zero_stage >= 1 and d and leaf.dim() == 1
             and leaf.numel() * dp == self._pads[i] for leaf in st]
            for i, (st, d) in enumerate(zip(opt_states, diff))]
        if _obs.ENABLED:
            rep = self.zero_memory_report()
            _obs.ZERO_STATE_BYTES.set(rep["opt_bytes_per_device"],
                                      kind="opt")
            _obs.ZERO_STATE_BYTES.set(rep["param_bytes_per_device"],
                                      kind="param")

    def _init_state_tp(self):
        """The tensor-parallel layout: each parameter as this rank's block
        of its spec (``_specs``), bound as a DTensor with ``_placements``
        on the sharded axes' device mesh; each moment-shaped optimizer
        leaf as this rank's block of ``_opt_state_spec`` (which may also
        split it over the data axis), scalar leaves whole."""
        from torch.distributed.tensor import Replicate, Shard

        from .mesh import world

        if self.mesh.size != world()[1]:
            raise MXNetError(
                f"SPMDTrainStep: a mesh of {self.mesh.size} ranks in a world "
                f"of {world()[1]}; join the world first "
                "(kvstore.init_distributed)")
        dp = self._dp_size()
        self._group = self.mesh.group(self.batch_axis) if dp > 1 else None
        self._rank = self.mesh.axis_index(self.batch_axis)
        axes = self._tp_axes()
        self._tp_mesh = self.mesh.device_mesh(axes, self._device.type)
        self._specs, self._placements, self._opt_specs = [], [], []
        params, opt_states = [], []
        for n, h, d in zip(self._names, self._handles, self._diff):
            full = h.data.detach()
            spec = self._spec(n, full.dim())
            self._specs.append(spec)
            self._placements.append(tuple(
                Shard(spec.index(a)) if a in spec else Replicate()
                for a in axes))
            local = _take(full, self._spans(full.shape, spec)).clone()
            params.append(local.requires_grad_(d))
            if not d:
                opt_states.append(())
                self._opt_specs.append(())
                continue
            ospec = tuple(self._opt_state_spec(n, tuple(full.shape)))
            basis = _take(full, self._spans(full.shape, ospec))
            state = tuple(self._rule_init(basis.clone()))
            opt_states.append(state)
            self._opt_specs.append(tuple(
                ospec if tuple(leaf.shape) == tuple(basis.shape)
                and leaf.dim() else () for leaf in state))
        self._state = (params, opt_states)
        self._opt_sharded = [
            [self.batch_axis in sp for sp in specs]
            for specs in self._opt_specs]
        self._release_block()

    def _release_block(self):
        """Hand the block's whole parameter tensors and gradient buffers
        back to the allocator: on the tensor-parallel path the step holds
        each parameter as this rank's block, and :meth:`sync_to_block`
        gathers the whole values back. A released tensor keeps its shape
        and dtype on the ``meta`` device, which holds no storage."""
        for h in self._handles:
            if h.data.is_meta:
                continue
            h._t = _meta_like(h._t)
            if h._grad is not None:
                h._grad._t = _meta_like(h._grad._t)

    def _shard(self, full, i):
        """This rank's ``[pad/dp]`` flat shard of parameter ``i``."""
        n = self._pads[i] // self._dp_size()
        return _overlap.pad_flat(full.detach(), self._pads[i])[
            self._rank * n:(self._rank + 1) * n]

    def zero_memory_report(self):
        """This rank's at-rest bytes against a fully replicated layout:
        what ZeRO buys (reference: ``zero_memory_report``).
        ``grad_bytes_per_device`` is what the gradient communication
        leaves on a rank: whole gradients after an all-reduce, 1/dp shards
        after the ZeRO-2/3 reduce-scatter."""
        params, opt_states = self._state
        dp = self._dp_size()

        def nb(t):
            return t.numel() * t.element_size()

        if self._mode == "tp":
            return dict(self._tp_memory_report(nb),
                        block_bytes_per_device=self._block_bytes())

        par_sh = [self._on_mesh() and self.zero_stage == 3 and d
                  for d in self._diff]
        opt_dev = sum(nb(leaf) for st in opt_states for leaf in st)
        opt_full = sum(nb(leaf) * (dp if sh else 1)
                       for st, shs in zip(opt_states, self._opt_sharded)
                       for leaf, sh in zip(st, shs))
        par_dev = sum(nb(p) for p in params)
        par_full = sum(nb(p) * (dp if sh else 1)
                       for p, sh in zip(params, par_sh))
        grad_full = sum(nb(p) * (dp if sh else 1)
                        for p, sh, d in zip(params, par_sh, self._diff) if d)
        grad_dev = grad_full // dp if self.zero_stage >= 2 and dp > 1 \
            else grad_full
        return {"zero_stage": self.zero_stage, "dp": dp,
                "opt_bytes_per_device": opt_dev,
                "opt_bytes_replicated": opt_full,
                "param_bytes_per_device": par_dev,
                "param_bytes_replicated": par_full,
                "grad_bytes_per_device": grad_dev,
                "grad_bytes_replicated": grad_full,
                "block_bytes_per_device": self._block_bytes()}

    def _block_bytes(self):
        """What the block's own parameter tensors and gradient buffers
        hold on this device beside the step's state (nothing once the
        tensor-parallel step has released them)."""
        def held(t):
            return 0 if t.is_meta else t.numel() * t.element_size()

        return sum(held(h.data) + (held(h._grad.data) if h._grad is not None
                                   else 0) for h in self._handles)

    def _tp_memory_report(self, nb):
        """:meth:`zero_memory_report` of the tensor-parallel layout: what
        this rank holds against the whole tensors of one process."""
        params, opt_states = self._state
        dp = self._dp_size()

        def whole(t, spec):
            n = nb(t)
            for a in spec:
                if a is not None:
                    n *= int(self.mesh.shape[a])
            return n

        opt_full = sum(whole(leaf, sp) for st, sps in
                       zip(opt_states, self._opt_specs)
                       for leaf, sp in zip(st, sps or [()] * len(st)))
        par_full = sum(whole(p, sp) for p, sp in zip(params, self._specs))
        grad_dev = sum(nb(p) for p, d in zip(params, self._diff) if d)
        return {"zero_stage": self.zero_stage, "dp": dp,
                "tp": {a: int(self.mesh.shape[a]) for a in self._tp_axes()},
                "opt_bytes_per_device": sum(nb(leaf) for st in opt_states
                                            for leaf in st),
                "opt_bytes_replicated": opt_full,
                "param_bytes_per_device": sum(nb(p) for p in params),
                "param_bytes_replicated": par_full,
                "grad_bytes_per_device": grad_dev,
                "grad_bytes_replicated": sum(
                    whole(p, sp) for p, sp, d in
                    zip(params, self._specs, self._diff) if d)}

    # -- the step ---------------------------------------------------------
    def _run_forward(self, params, x, y):
        """The Gluon forward over ``params`` (bound into the parameter
        handles for the call) and the mean loss, recorded for backward.
        Hybridized blocks inside run eagerly, as in the JAX step's trace:
        a captured graph reads the tensors the handles held when it was
        captured, not the step's own."""
        if self._mode == "tp":
            return self._run_forward_tp(params, x, y)
        with _bound(self._handles, params), \
                autograd._RecordingStateScope(True, True):
            loss = self.loss_fn(self.block(NDArray(x)), NDArray(y))
        return loss.data.mean()

    def _run_forward_tp(self, params, x, y):
        """:meth:`_run_forward` over DTensors: each local block bound as
        its DTensor (``from_local``, through which its gradient comes back
        as this rank's block, summed over the ranks that replicate it),
        plain tensors taken as replicated. Returns the local 0-d loss."""
        from torch.distributed.tensor import DTensor, Replicate

        mesh = self._tp_mesh
        bound = [DTensor.from_local(p, mesh, pl, run_check=False)
                 for p, pl in zip(params, self._placements)]
        with _bound(self._handles, bound), _ReplicatePlain(mesh), \
                autograd._RecordingStateScope(True, True):
            loss = self.loss_fn(self.block(NDArray(x)), NDArray(y))
            loss = loss.data.mean()
            if isinstance(loss, DTensor):
                loss = loss.redistribute(
                    mesh, [Replicate()] * mesh.ndim).to_local()
        return loss

    def _loss_and_grads(self, x, y):
        """The loss (a 0-d tensor on the device) and the gradients of the
        differentiable parameters, in ``_diff`` order."""
        params, _ = self._state
        loss = self._run_forward(params, x, y)
        diff = [p for p, d in zip(params, self._diff) if d]
        grads = list(torch.autograd.grad(loss, diff, allow_unused=True))
        return loss.detach(), grads

    def _apply(self, grads, lr):
        """The update of every differentiable parameter at learning rate
        ``lr`` (a float): one multi-tensor update (``MXTPU_FUSED_STEP``,
        default on), else the rule on each parameter in turn. The list
        ``grads`` is emptied: by the rule, one gradient as it is used; by
        the multi-tensor update, all after it."""
        params, opt_states = self._state
        diff_idx = [i for i, d in enumerate(self._diff) if d]
        for k, i in enumerate(diff_idx):
            if grads[k] is None:
                grads[k] = torch.zeros_like(params[i])
        self._num_update += 1
        n = len(diff_idx)
        with torch.no_grad():
            if _fusedstep.ENABLED:
                multi_tensor.update(
                    self._optimizer, self._hyper,
                    [params[i] for i in diff_idx], grads,
                    [opt_states[i] for i in diff_idx], [lr] * n,
                    [self._hyper.get("wd", 0.0)] * n,
                    # every state starts at init_state and steps with
                    # the others: one step count for all
                    self._multi_precision, t_uniform=True)
                grads.clear()
                return
            lr_t = torch.full((), lr, dtype=torch.float32,
                              device=params[diff_idx[0]].device) \
                if n else None
            for k, i in enumerate(diff_idx):
                g, grads[k] = grads[k], None
                w, s = self._rule_update(params[i].detach(), g,
                                         opt_states[i], lr_t)
                params[i] = w.requires_grad_()
                opt_states[i] = tuple(s)

    def _step(self, x, y, lr):
        if self._mode == "tp":
            return self._tp_step(x, y, lr)
        if self._on_mesh():
            return self._mesh_step(x, y, lr)
        loss, grads = self._loss_and_grads(x, y)
        self._apply(grads, lr)
        return loss

    # -- the data-parallel step -------------------------------------------
    def _gather_buckets(self, shards, place=None):
        """Every rank's part of each differentiable parameter -> its whole
        tensor, one ``all_gather_into_tensor`` per plan bucket, all started
        before the first is waited on (``shards`` and the result in
        ``_diff`` order; a None part is skipped). ``place(k, rows)`` makes
        entry ``k``'s whole tensor of its ``[dp, n]`` rows; by default the
        parts are the ``[pad/dp]`` flat shards."""
        import torch.distributed as dist

        _overlap.chaos_point("bucket_allgather")
        plan, dp = self._plan, self._dp_size()
        out = [None] * len(shards)
        if place is None:
            def place(k, rows):
                return _overlap.unpad_reshape(
                    rows.reshape(-1), plan.sizes[k], plan.shapes[k])
        with torch.no_grad():
            started = []
            for idxs in plan.buckets:
                idxs = [k for k in idxs if shards[k] is not None]
                if not idxs:
                    continue
                b = torch.cat([shards[k].detach().reshape(-1)
                               for k in idxs]) if len(idxs) > 1 \
                    else shards[idxs[0]].detach().reshape(-1).contiguous()
                rows = torch.empty(dp * b.numel(), dtype=b.dtype,
                                   device=b.device)
                started.append((idxs, rows, dist.all_gather_into_tensor(
                    rows, b, group=self._group, async_op=True)))
            for idxs, rows, work in started:
                work.wait()
                rows = rows.reshape(dp, -1)
                off = 0
                for k in idxs:
                    n = shards[k].numel()
                    out[k] = place(k, rows[:, off:off + n]).detach()
                    off += n
        return out

    def _build_plan(self, order):
        """The bucket plan of the differentiable parameters in readiness
        order (from the first step's forward; None: reversed parameter
        order), padded for the reduce-scatter layout every stage's
        collectives use; over the local blocks on the tensor-parallel
        path."""
        params, _ = self._state
        didx = [i for i, d in enumerate(self._diff) if d]
        shapes = [tuple(params[i].shape) if self._mode == "tp"
                  else tuple(self._handles[i].data.shape) for i in didx]
        dtypes = [str(params[i].dtype).split(".")[1] for i in didx]
        dp = self._dp_size()
        self._plan = _overlap.build_bucket_plan(shapes, dtypes, order=order,
                                                dp=dp)
        if _obs.ENABLED:
            _obs.OVERLAP_BUCKETS.set(len(self._plan.buckets), site="spmd_step")
        if self._compress_thr is not None and self._residuals is None:
            dev = params[didx[0]].device
            self._residuals = [
                torch.zeros(n, dtype=params[didx[b[0]]].dtype, device=dev)
                for n, b in zip(_overlap.residual_shapes(self._plan, True),
                                self._plan.buckets)]

    def _mesh_step(self, x, y, lr):
        """One data-parallel step on this rank's rows ``x``/``y``: the
        module docstring's schedule. Returns the loss over the global
        batch (a 0-d device tensor)."""
        import torch.distributed as dist

        params, opt_states = self._state
        dp, stage = self._dp_size(), self.zero_stage
        didx = [i for i, d in enumerate(self._diff) if d]
        full = list(params)
        if stage == 3 and self._plan is not None:
            whole = self._gather_buckets([params[i] for i in didx])
            for k, i in enumerate(didx):
                full[i] = whole[k].requires_grad_()
        elif stage == 3:
            # the first step's forward needs whole parameters before the
            # plan (built from that forward) exists: the block's own
            for i in didx:
                full[i] = self._handles[i].data.detach().clone() \
                    .requires_grad_()
        diff_t = [full[i] for i in didx]
        aux = [i for i, d in enumerate(self._diff) if not d]
        versions = [full[i]._version for i in aux]
        if self._plan is None:
            with _overlap.first_use_recorder(diff_t) as rec:
                loss_local = self._run_forward(full, x, y)
            self._build_plan(rec.order())
            self._restore_pending_residuals()
        else:
            loss_local = self._run_forward(full, x, y)
        mode = self._overlap_mode if self._mode == "overlap" else (
            "staged" if self._mode == "staged" else "barrier")
        comm = _overlap.BucketComm(
            self._plan, self._group, stage >= 2, postscale=1.0 / dp,
            compress=self._compress_thr, residuals=self._residuals,
            wire_dtype=self._grad_dtype, sync=mode == "staged",
            nocomm=mode == "nocomm", index=self._rank)
        grads = [None] * len(didx)
        hooks = []
        if mode == "ready":
            left = [len(b) for b in self._plan.buckets]
            bucket_of = {k: bi for bi, b in enumerate(self._plan.buckets)
                         for k in b}

            def arrived(k):
                def hook(g):
                    grads[k] = g
                    bi = bucket_of[k]
                    left[bi] -= 1
                    if left[bi] == 0:
                        comm.start(bi, grads)
                return hook

            hooks = [t.register_hook(arrived(k))
                     for k, t in enumerate(diff_t)]
        try:
            got = torch.autograd.grad(loss_local, diff_t, allow_unused=True)
        finally:
            for h in hooks:
                h.remove()
        for k, g in enumerate(got):
            grads[k] = g if g is not None else torch.zeros_like(diff_t[k])
        reduced, new_res = comm.finish(grads)
        if self._compress_thr is not None:
            self._residuals = new_res
        loss = loss_local.detach().clone().reshape(1)
        dist.all_reduce(loss, group=self._group)
        loss = loss[0] * (1.0 / dp)
        with torch.no_grad():
            for i, v in zip(aux, versions):
                if full[i]._version != v:
                    # state the forward wrote (BatchNorm's statistics):
                    # the ranks' mean, so the replicas stay equal
                    dist.all_reduce(full[i], group=self._group)
                    full[i].mul_(torch.tensor(1.0 / dp, dtype=full[i].dtype,
                                              device=full[i].device))
        self._apply_mesh(reduced, lr)
        return loss.detach()

    # -- the tensor-parallel step ---------------------------------------
    def _tp_step(self, x, y, lr):
        """One step over DTensor-bound blocks on this rank's rows: the
        forward and backward (tensor-parallel collectives inside them),
        then the data axis's bucketed sum of the local gradients and the
        update (:meth:`_apply_tp`). Returns the global batch's loss."""
        import torch.distributed as dist

        self._release_block()  # whole again after a sync_to_block
        params, _ = self._state
        dp = self._dp_size()
        didx = [i for i, d in enumerate(self._diff) if d]
        diff_t = [params[i] for i in didx]
        if self._plan is None and dp > 1:
            with _overlap.first_use_recorder(diff_t) as rec:
                loss_local = self._run_forward(params, x, y)
            self._build_plan(rec.order())
            self._restore_pending_residuals()
        else:
            loss_local = self._run_forward(params, x, y)
        got = torch.autograd.grad(loss_local, diff_t, allow_unused=True)
        grads = [g if g is not None else torch.zeros_like(t)
                 for g, t in zip(got, diff_t)]
        if dp > 1:
            grads, new_res = _overlap.bucket_allreduce(
                grads, self._group, self._plan, postscale=1.0 / dp,
                compress=self._compress_thr, residuals=self._residuals,
                wire_dtype=self._grad_dtype)
            if self._compress_thr is not None:
                self._residuals = new_res
            loss = loss_local.detach().clone().reshape(1)
            dist.all_reduce(loss, group=self._group)
            loss = loss[0] * (1.0 / dp)
        else:
            loss = loss_local.detach()
        self._apply_tp(list(grads), lr)
        return loss

    def _restore_pending_residuals(self):
        """A checkpoint restored before the first step left its 2-bit
        carry here (the carry is made with the bucket plan)."""
        if self._pending_residual_chunks is not None and self._residuals:
            chunks, extents = self._pending_residual_chunks
            self._pending_residual_chunks = None
            _restore_residuals(self, chunks, extents)

    def _apply_tp(self, grads, lr):
        """The update of the local blocks: whole at ZeRO 0 (and for a
        moment that ``_opt_state_spec`` leaves on the parameter's spec);
        else each rank updates its data-axis slice of the block and the
        slices are all-gathered back along that dimension, one collective
        a bucket of the plan (:meth:`_gather_buckets`)."""
        params, opt_states = self._state
        didx = [i for i, d in enumerate(self._diff) if d]
        dp, r = self._dp_size(), self._rank
        cut = []  # (dimension, length of a slice) or None per parameter
        ws, gs = [], []
        for k, i in enumerate(didx):
            ospec = next((sp for sp in self._opt_specs[i] if sp), ())
            d = next((j for j, a in enumerate(ospec)
                      if a == self.batch_axis), None)
            if d is None:
                cut.append(None)
                ws.append(params[i])
                gs.append(grads[k])
                continue
            n = params[i].shape[d] // dp
            cut.append((d, n))
            ws.append(params[i].detach().narrow(d, r * n, n).clone())
            gs.append(grads[k].narrow(d, r * n, n))
        grads.clear()
        self._num_update += 1
        sts = [opt_states[i] for i in didx]
        with torch.no_grad():
            if self._optimizer == "lamb":
                # the trust ratio's norms are the whole parameter's:
                # summed over the axes that shard its block
                for k, i in enumerate(didx):
                    groups = [self.mesh.group(a) for a in self._specs[i]
                              if a is not None] + (
                        [self._group] if cut[k] is not None else [])
                    rule = _lamb_rule_sharded(self._hyper, groups)[1] \
                        if groups else self._rule_update
                    if self._multi_precision and groups:
                        rule = mp_rule(_moments_init, rule)[1]
                    self._rule_each(rule, ws[k:k + 1], gs[k:k + 1],
                                    sts[k:k + 1], lr, [i])
            elif _fusedstep.ENABLED:
                multi_tensor.update(
                    self._optimizer, self._hyper, [w.detach() for w in ws],
                    gs, sts, [lr] * len(didx),
                    [self._hyper.get("wd", 0.0)] * len(didx),
                    self._multi_precision, t_uniform=True)
            else:
                self._rule_each(self._rule_update, ws, gs, sts, lr, didx)
            if not any(cut):
                return

            def place(k, rows):
                # the ranks' slices of the block, in rank order along the
                # dimension that ``_opt_state_spec`` split
                return torch.cat(rows.reshape(dp, *ws[k].shape).unbind(0),
                                 dim=cut[k][0])

            whole = self._gather_buckets(
                [w if c is not None else None for w, c in zip(ws, cut)],
                place)
            for k, i in enumerate(didx):
                if cut[k] is not None:
                    params[i].detach().copy_(whole[k])

    def _apply_mesh(self, grads, lr):
        """The update of this rank's part of every differentiable
        parameter: whole at stage 0, its flat shard from stage 1 on (then
        all-gathered back into the whole parameter at stages 1 and 2;
        stage 3 keeps the shard)."""
        params, opt_states = self._state
        stage = self.zero_stage
        didx = [i for i, d in enumerate(self._diff) if d]
        if stage in (0, 3):
            ws = [params[i] for i in didx]  # whole, or the shard at rest
        else:
            ws = [self._shard(params[i], i).clone() for i in didx]
            if stage == 1:
                grads = [_overlap.shard_of(g, self._plan, self._rank, k)
                         for k, g in enumerate(grads)]
        self._num_update += 1
        n = len(didx)
        sts = [opt_states[i] for i in didx]
        with torch.no_grad():
            if self._optimizer == "lamb" and stage >= 1:
                rule = _lamb_rule_sharded(self._hyper, self._group)[1]
                if self._multi_precision:
                    rule = mp_rule(_moments_init, rule)[1]
                self._rule_each(rule, ws, grads, sts, lr, didx)
            elif _fusedstep.ENABLED:
                ws_d = [w.detach() for w in ws]
                multi_tensor.update(
                    self._optimizer, self._hyper, ws_d, list(grads), sts,
                    [lr] * n, [self._hyper.get("wd", 0.0)] * n,
                    self._multi_precision, t_uniform=True)
            else:
                self._rule_each(self._rule_update, ws, grads, sts, lr, didx)
            if stage in (1, 2):
                whole = self._gather_buckets(ws)
                for k, i in enumerate(didx):
                    params[i].detach().copy_(whole[k])

    def _rule_each(self, rule, ws, grads, sts, lr, didx):
        """The rule on one parameter (part) after another, written back
        into ``ws`` and the states in place."""
        _, opt_states = self._state
        lr_t = torch.full((), lr, dtype=torch.float32,
                          device=ws[0].device) if ws else None
        for k, i in enumerate(didx):
            w, st = rule(ws[k].detach(), grads[k], sts[k], lr_t)
            ws[k].detach().copy_(w)
            for old, new in zip(sts[k], st):
                old.copy_(new)
            opt_states[i] = sts[k]

    def _prepare(self, x, y, lr):
        raw_x, raw_y = _raw(x), _raw(y)
        if raw_x.dtype == torch.bfloat16:
            # the JAX step carries lr in a bfloat16 batch's dtype
            lr = float(torch.tensor(lr, dtype=torch.bfloat16))
        return raw_x, raw_y, float(lr)

    def _local(self, x, y):
        """On a mesh, this rank's rows of the global batch, on the
        parameters' device."""
        if self.mesh is None or self._dp_size() <= 1:
            return _raw(x), _raw(y)
        return (shard_batch(x, self.mesh, self.batch_axis, self._device),
                shard_batch(y, self.mesh, self.batch_axis, self._device))

    def __call__(self, x, y, lr=0.01, sync=True):
        if self._state is None:
            # resolve deferred init with one predict-mode pass on one row,
            # eager even in a hybridized block (nothing worth capturing)
            raw = _raw(x)
            with _bound(), autograd.predict_mode():
                self.block(NDArray(raw[0:1] if raw.shape[0] > 1 else raw))
            self.init_state()
        args = self._prepare(*self._local(x, y), lr)
        if not (_obs.ENABLED or _obs.introspect.ENABLED
                or _obs.flight.INSTALLED):
            loss = self._step(*args)
        else:
            loss = self._step_instrumented(args)
        return float(loss) if sync else loss

    def _step_instrumented(self, args):
        """One step with its telemetry: the introspection site
        ``spmd_step`` on its first run, the flight recorder's in-flight
        mark, one ``spmd_step`` dispatch and the attribution record."""
        t0 = time.perf_counter()
        with _obs.introspect.site("spmd_step", self._device):
            if _obs.flight.INSTALLED:
                with _obs.flight.dispatch("spmd_step"):
                    loss = self._step(*args)
            else:
                loss = self._step(*args)
        if _obs.ENABLED:
            _obs.record_xla_dispatch("spmd_step")
            if _obs.attribution.ENABLED:
                _obs.attribution.record_step(
                    t0, time.perf_counter(), site="spmd",
                    comm_mode=self._mode)
        return loss

    def run_steps(self, x, y, n, lr=0.01):
        """Run ``n`` steps on one batch with no host synchronisation
        between them (the JAX package runs them in one executable, a
        ``lax.fori_loop``); returns the last loss, a 0-d tensor on the
        device."""
        if self._state is None:
            # one plain step resolves deferred init
            self._last_loss = self(x, y, lr=lr, sync=False)
            n -= 1
        args = self._prepare(*self._local(x, y), lr)
        for _ in range(int(n)):
            self._last_loss = self._step(*args)
        return self._last_loss

    def run_superstep(self, xs, ys, lr=0.01):
        """K distinct batches, stacked on a leading ``[K]`` axis
        (``gluon.data.stack_batches``), one step each, with no host
        synchronisation between them (the JAX package scans its compiled
        step over them). ``lr`` is a scalar or K values (iteration ``i``
        takes ``lr[i]``). The first call resolves deferred shapes with a
        predict pass on one row, consuming no update. Returns the K
        losses, one device tensor. On a mesh each slot is one mesh step
        on this rank's rows of that slot's global batch, with its own
        collectives: K single mesh steps' numbers."""
        raw_x, raw_y = _raw(xs), _raw(ys)
        if self._state is None:
            row = raw_x[0]
            with _bound(), autograd.predict_mode():
                self.block(NDArray(row[0:1] if row.dim() and
                                   row.shape[0] > 1 else row))
            self.init_state()
        k = int(raw_x.shape[0])
        lrs = [float(v) for v in torch.as_tensor(
            lr, dtype=torch.float64).reshape(-1).tolist()]
        if len(lrs) == 1:
            lrs = lrs * k
        if len(lrs) != k:
            raise MXNetError(f"run_superstep: lr must be a scalar or {k} "
                             f"values; got {len(lrs)}")
        losses = [self._step(*self._prepare(*self._local(raw_x[i], raw_y[i]),
                                            lrs[i]))
                  for i in range(k)]
        out = torch.stack(losses)
        self._last_loss = out[-1]
        return out

    def _full_tp(self, i, local):
        """Parameter ``i``'s whole tensor from every rank's block (one
        all-gather per sharded axis; a replicated one is its own)."""
        from ..ops._sharded import gather_local

        return gather_local(local.detach(), self._tp_mesh,
                            self._placements[i])

    def sync_to_block(self):
        """Write the step's parameters back into the Gluon parameters
        (copies: the step goes on replacing its own tensors)."""
        params, _ = self._state
        if self._mode == "tp":
            with torch.no_grad():
                for i, (h, p) in enumerate(zip(self._handles, params)):
                    full = self._full_tp(i, p)
                    if not h.data.is_meta:
                        h._set_data(full)
                        continue
                    # released (:meth:`_release_block`): whole again, with
                    # a gradient buffer where it had one
                    h._t = full.clone().requires_grad_(h._t.requires_grad)
                    if h._grad is not None:
                        h._grad._t = torch.zeros_like(full)
            return
        if self._on_mesh() and self.zero_stage == 3:
            didx = [i for i, d in enumerate(self._diff) if d]
            params = list(params)
            with torch.no_grad():
                for k, t in zip(didx, self._gather_buckets(
                        [params[i] for i in didx])):
                    params[k] = t
        for h, p in zip(self._handles, params):
            h._set_data(p)


# ---------------------------------------------------------------------------
# sharded checkpoints (reference: the same section of
# ``mxnet_tpu/parallel/spmd.py``). Every tensor of the step's state is
# written in LOGICAL coordinates: a natural block ``a:b;c:d`` of the
# parameter's shape, or a flat span ``a:b`` of its elements for the ZeRO
# flat shards, clipped to the element count (the pad is layout, not
# state). Each rank writes ``{prefix}.shard{rank}.npz`` with the blocks it
# holds, a replicated one only where its coordinate is 0 on every axis
# that does not shard the tensor, so the files tile every tensor once; a
# restore reads the chunks that overlap this rank's blocks in the step's
# CURRENT layout, which may differ from the saved one in dp, tp, ZeRO
# stage or world size.
# ---------------------------------------------------------------------------


def _shard_key(name, spans):
    """``name|a:b;c:d`` (``name|`` for a scalar)."""
    return name + "|" + ";".join(f"{a}:{b}" for a, b in spans)


def _parse_key(k):
    name, _, spans = k.rpartition("|")
    return name, tuple((int(a), int(b)) for a, b in
                       (s.split(":") for s in spans.split(";") if s))


def _layouts(step):
    """``(key, tensor, shape, target, axes)`` for every tensor of the
    step's state (params, optimizer leaves, the compression carry):
    ``shape`` the logical one; ``target`` ``("nat", spans)`` for a
    natural block or ``("flat", start, length)`` for a flat ZeRO shard
    of the padded elements; ``axes`` the mesh axes that split it."""
    params, opt_states = step._state
    tp = step._mode == "tp"
    dp = step._dp_size()
    mesh_on = step._on_mesh()
    rank = step._rank if mesh_on else 0
    out = []

    def flat(n_pad_shard, numel):
        return ("flat", rank * n_pad_shard, n_pad_shard)

    for i, (n, p) in enumerate(zip(step._names, params)):
        shape = tuple(step._handles[i].data.shape)
        if tp:
            spec = step._specs[i]
            out.append((f"param::{n}", p, shape,
                        ("nat", step._spans(shape, spec)),
                        {a for a in spec if a is not None}))
        elif mesh_on and step.zero_stage == 3 and step._diff[i]:
            out.append((f"param::{n}", p, shape,
                        flat(p.numel(), _np.prod(shape, dtype=_np.int64)),
                        {step.batch_axis}))
        else:
            out.append((f"param::{n}", p, shape,
                        ("nat", tuple((0, s) for s in shape)), set()))
    for i, (n, st) in enumerate(zip(step._names, opt_states)):
        shape = tuple(step._handles[i].data.shape)
        for li, leaf in enumerate(st):
            key = f"opt::{n}::{li}"
            if leaf.dim() == 0:
                out.append((key, leaf, (), ("nat", ()), set()))
            elif tp:
                spec = step._opt_specs[i][li] or step._specs[i]
                out.append((key, leaf, shape,
                            ("nat", step._spans(shape, spec)),
                            {a for a in spec if a is not None}))
            elif step._opt_sharded[i][li]:
                out.append((key, leaf, shape, flat(leaf.numel(), None),
                            {step.batch_axis}))
            else:
                out.append((key, leaf, tuple(leaf.shape),
                            ("nat", tuple((0, s) for s in leaf.shape)),
                            set()))
    for bi, r in enumerate(step._residuals or ()):
        # per-rank error feedback: rank r's carry is span r of [dp * L]
        out.append((f"residual::{bi}", r, (dp * r.numel(),),
                    ("nat", ((rank * r.numel(), (rank + 1) * r.numel()),)),
                    {step.batch_axis}))
    return out


def _writes(step, axes):
    """Is this rank the one that writes a tensor split over ``axes``:
    its coordinate is 0 on every other axis of the mesh."""
    if step.mesh is None or not step._on_mesh():
        return True
    return all(step.mesh.axis_index(a) == 0 for a in step.mesh.axis_names
               if a not in axes)


def _held_chunk(t, shape, target):
    """``(spans, tensor)`` of a held tensor in logical coordinates (a flat
    shard clipped to the element count), or None for pure pad."""
    if target[0] == "nat":
        return target[1], t
    _, start, n = target
    numel = int(_np.prod(shape, dtype=_np.int64)) if shape else 1
    stop = min(start + n, numel)
    if start >= numel:
        return None
    return ((start, stop),), t.reshape(-1)[:stop - start]


def _host(t):
    from ..gluon.trainer import _to_numpy

    return _to_numpy(t)


def _iter_state_tensors(step):
    """Stable ``(key, tensor)`` walk over params + optimizer states + any
    2-bit compression residual carry (this rank's blocks)."""
    for key, t, _, _, _ in _layouts(step):
        yield key, t


def _clipped_shard_chunks(step, only_written=True):
    """``{key: [(spans, host array)]}`` of this rank's blocks in logical
    coordinates (flat ZeRO spans clipped to the element count), and the
    compression carries' global lengths; with ``only_written`` just the
    blocks this rank writes (:func:`_writes`)."""
    chunks, extents = {}, {}
    for key, t, shape, target, axes in _layouts(step):
        if key.startswith("residual::"):
            extents[key] = shape[0]
        if only_written and not _writes(step, axes):
            continue
        held = _held_chunk(t, shape, target)
        if held is not None:
            chunks.setdefault(key, []).append((held[0], _host(held[1])))
    return chunks, extents


def spmd_state_snapshot(step, copy=True):
    """The step's state as this rank's blocks in logical coordinates,
    ``{key: [(spans, np.ndarray)]}``, and the compression carries' global
    lengths: what :func:`spmd_save_states` writes, every block this rank
    holds, without the disk. :func:`spmd_restore_chunks` restores it onto
    the step's layout. ``copy`` is accepted for the reference's
    signature: the host arrays are copies."""
    del copy
    if step._state is None:
        raise MXNetError("state_snapshot: call init_state()/step first")
    return _clipped_shard_chunks(step, only_written=False)


def spmd_save_states(step, prefix):
    """Write this rank's blocks of the step's params + optimizer states
    to ``{prefix}.shard{rank}.npz`` (rank: the world's); together the
    ranks' files tile every tensor exactly once. A rank that reads them
    back waits for every rank's file first (a barrier;
    ``resilience.save_spmd_checkpoint`` has its own). Returns the file
    name."""
    from .mesh import world

    if step is None or step._state is None:
        raise MXNetError("save_states: call init_state()/step first")
    chunks, _ = _clipped_shard_chunks(step)
    store = {_shard_key(key, spans): data for key, parts in chunks.items()
             for spans, data in parts}
    fname = f"{prefix}.shard{world()[0]}.npz"
    _np.savez(fname, **store)
    return fname


def _overlaps(src, tgt):
    return all(a < d and c < b for (a, b), (c, d) in zip(src, tgt))


def spmd_load_states(step, prefix):
    """Restore a checkpoint of ``spmd_save_states`` (either package's)
    into the step's state, laid out as the step lays it out NOW (the
    mesh, the specs or the ZeRO stage may differ from save time). Only
    the chunks that overlap this rank's blocks are read."""
    import glob as _glob

    if step is None:
        raise MXNetError("load_states: no step")
    if step._state is None:
        step.init_state()
    files = sorted(_glob.glob(f"{prefix}.shard*.npz"))
    if not files:
        raise MXNetError(f"no checkpoint shards match {prefix}.shard*.npz")
    wanted = {}
    for key, t, shape, target, _ in _layouts(step):
        wanted[key] = (shape, target)
    chunks, extents = {}, {}
    for f in files:
        with _np.load(f) as z:
            for k in z.files:
                name, spans = _parse_key(k)
                if name.startswith("residual::") and spans:
                    extents[name] = max(extents.get(name, 0), spans[0][1])
                if name not in wanted:
                    continue
                shape, target = wanted[name]
                mine = _target_logical(shape, target)
                if mine is not None and _comparable(spans, shape, target) \
                        and not _overlaps(spans, mine):
                    continue  # a chunk of other ranks' blocks
                chunks.setdefault(name, []).append((spans, z[k]))
    spmd_restore_chunks(step, chunks, extents=extents)


def _comparable(spans, shape, target):
    """Are a chunk's spans in the coordinates of ``target``'s layout: a
    natural block for a natural target, a flat span for a flat one (the
    two coincide for a 1-D tensor)."""
    if target[0] == "nat":
        return len(spans) == len(shape)
    return len(spans) == 1


def _target_logical(shape, target):
    """This rank's block of a tensor in the coordinates of its own
    layout (None: pure pad)."""
    if target[0] == "nat":
        return target[1]
    _, start, n = target
    numel = int(_np.prod(shape, dtype=_np.int64)) if shape else 1
    return ((start, min(start + n, numel)),) if start < numel else None


def spmd_restore_chunks(step, chunks, extents=None, allow_empty=()):
    """Restore a logical-coordinate chunk set (an in-memory
    :func:`spmd_state_snapshot` or the chunks of a shard-file set) into
    the step's CURRENT layout, then push the parameters back into the
    Gluon block. ``extents`` maps ``residual::N`` keys to their saved
    global lengths; ``allow_empty`` names keys allowed to be absent
    (their blocks are pure pad)."""
    if step._state is None:
        step.init_state()
    extents = extents or {}
    layouts = _layouts(step)
    with torch.no_grad():
        for key, t, shape, target, _ in layouts:
            if key.startswith("residual::"):
                continue
            if _target_logical(shape, target) is None or (
                    key not in chunks and key in allow_empty):
                t.zero_()  # this rank's block is pure pad, or allowed out
                continue
            t.copy_(_reassemble(key, shape, target, chunks, t).to(t.device))
    res = {k: v for k, v in chunks.items() if k.startswith("residual::")}
    if step._residuals:
        _restore_residuals(step, res, extents)
    elif res and step._compress_thr is not None:
        # the carry is made with the bucket plan at the first step
        step._pending_residual_chunks = (res, extents)
    if step._mode != "tp" and step._on_mesh() and step.zero_stage == 3 \
            and step._plan is None:
        _whole_into_block(step, chunks)
    else:
        step.sync_to_block()


def _whole_into_block(step, chunks):
    """A ZeRO-3 step with no bucket plan yet (its first step builds the
    plan, from a forward over the block's own parameters): the whole
    parameters into the Gluon block, from the chunks themselves (they
    cover every element: a snapshot of the whole state)."""
    from ..gluon.trainer import _from_numpy

    params, _ = step._state
    with torch.no_grad():
        for i, (h, p) in enumerate(zip(step._handles, params)):
            if not step._diff[i]:
                h._set_data(p)
                continue
            key = f"param::{step._names[i]}"
            shape = tuple(h.data.shape)
            whole = _reassemble_cross(key, shape, chunks[key])
            h._set_data(_from_numpy(whole, "cpu").to(h.data.device,
                                                      h.data.dtype))


def _restore_residuals(step, chunks, extents):
    """The 2-bit error-feedback carry (``residual::N``): per-rank state in
    the ``[dp * L]`` layout, restored only onto the same dp layout; any
    other restarts it from zeros (one warning; a quantization step's
    worth of error)."""
    import logging

    dp = step._dp_size()
    rank = step._rank if step._on_mesh() else 0
    new = []
    for bi, r in enumerate(step._residuals):
        key = f"residual::{bi}"
        L = r.numel()
        if chunks.get(key) and extents.get(key) == dp * L:
            new.append(_reassemble(key, (dp * L,), (
                "nat", ((rank * L, (rank + 1) * L),)), chunks, r)
                .to(r.device))
        else:
            logging.getLogger(__name__).warning(
                "load_states: compression residual %s does not match the "
                "current dp layout; restarting the error-feedback carry "
                "from zeros", key)
            new.append(r)
    step._residuals = new


def _reassemble_cross(key, shape, saved):
    """The whole logical tensor from chunks of either layout (natural
    blocks, or flat spans of the elements): the layout-crossing restore
    (flat ZeRO shards into a natural target or back)."""
    numel = int(_np.prod(shape, dtype=_np.int64)) if shape else 1
    nds = {len(s) for s, _ in saved if s}
    if len(nds) > 1 and len(shape) != 1:
        raise MXNetError(f"checkpoint tensor {key!r}: mixed chunk layouts "
                         f"{sorted(nds)}")
    dtype = _np.asarray(saved[0][1]).dtype
    if nds == {len(shape)}:
        full = _np.zeros(shape, dtype)
        for spans, data in saved:
            full[tuple(slice(a, b) for a, b in spans)] = data
        return full
    flat = _np.zeros((numel,), dtype)
    for spans, data in saved:
        a, b = spans[0]
        b = min(b, numel)
        if a < b:
            flat[a:b] = _np.asarray(data).reshape(-1)[:b - a]
    return flat.reshape(shape)


def _reassemble(key, shape, target, chunks, like):
    """This rank's block (``target``) of tensor ``key`` as a tensor of
    ``like``'s type, from the chunks that overlap it; a chunk set that
    does not cover the block raises."""
    from ..gluon.trainer import _from_numpy

    if key not in chunks:
        raise MXNetError(f"checkpoint missing tensor {key!r}")
    saved = chunks[key]
    mine = _target_logical(shape, target)
    if not shape:
        return _from_numpy(_np.asarray(saved[0][1]), "cpu").to(like.dtype) \
            .reshape(())
    if not all(_comparable(s, shape, target) for s, _ in saved):
        full = _reassemble_cross(key, shape, saved)
        block = _cut(full, shape, target)
    else:
        dtype = _np.asarray(saved[0][1]).dtype
        block = _np.zeros(tuple(b - a for a, b in mine), dtype)
        covered = 0
        for spans, data in saved:
            inter = [(max(a, c), min(b, d))
                     for (a, b), (c, d) in zip(spans, mine)]
            if any(b <= a for a, b in inter):
                continue
            dst = tuple(slice(a - c, b - c)
                        for (a, b), (c, _) in zip(inter, mine))
            src = tuple(slice(a - c, b - c)
                        for (a, b), (c, _) in zip(inter, spans))
            block[dst] = _np.asarray(data)[src]
            covered += int(_np.prod([b - a for a, b in inter]))
        if covered < block.size:
            raise MXNetError(
                f"checkpoint tensor {key!r}: the shard files cover "
                f"{covered} of the {block.size} elements of this rank's "
                "block")
        if target[0] == "flat":
            pad = _np.zeros((target[2],), dtype)
            pad[:block.size] = block.reshape(-1)
            block = pad
    t = _from_numpy(block, "cpu").to(like.dtype)
    return t.reshape(like.shape)


def _cut(full, shape, target):
    """``target``'s block of the whole logical tensor ``full``."""
    if target[0] == "nat":
        return full[tuple(slice(a, b) for a, b in target[1])]
    _, start, n = target
    out = _np.zeros((n,), full.dtype)
    flat = full.reshape(-1)[start:start + n]
    out[:flat.size] = flat
    return out


# method-style access, matching Trainer.save_states naming
SPMDTrainStep.save_states = spmd_save_states
SPMDTrainStep.load_states = spmd_load_states
