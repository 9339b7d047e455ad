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
on (the exposed-comm baseline). Tensor parallelism
(``param_sharding``), the superstep on a mesh, sharded checkpoints
(``spmd_save_states``) and a ``pp`` axis raise (ROADMAP A11).
"""

from __future__ import annotations

import torch

import numpy as _np

from .. import autograd
from .. import fusedstep as _fusedstep
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
    """LAMB over a flat dp-shard (ZeRO 1-3): :func:`_lamb_rule`'s
    arithmetic with the trust-ratio norms summed over the data axis's
    ranks (one ``all_reduce`` each); the pad region is zeros in both the
    weight and the step, so the norms are the whole parameter's."""
    beta1 = hyper.get("beta1", 0.9)
    beta2 = hyper.get("beta2", 0.999)
    eps = hyper.get("epsilon", 1e-6)
    wd_const = hyper.get("wd", 0.0)

    def norm(t):
        import torch.distributed as dist

        sq = torch.sum(t * t).reshape(1)
        dist.all_reduce(sq, group=group)
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


def _not_ported(what):
    return MXNetError(f"SPMDTrainStep: {what} is not ported yet (ROADMAP "
                      "A11: tensor parallelism, the superstep on a mesh, "
                      "sharded checkpoints and pipelines come next)")


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


def spmd_save_states(step, prefix):
    """Sharded save of a mesh step's state: ROADMAP A11's sharded half
    of A9, not ported yet."""
    raise _not_ported("spmd_save_states (sharded checkpoints)")


def spmd_load_states(step, prefix):
    """Sharded restore of a mesh step's state: not ported yet (A11)."""
    raise _not_ported("spmd_load_states (sharded checkpoints)")


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
                raise _not_ported(f"a pp={axis_size(mesh, 'pp')} axis "
                                  "(the pipeline executor)")
        if param_sharding and any(
                len(tuple(spec)) and any(x is not None for x in spec)
                for spec in param_sharding.values()):
            raise _not_ported("param_sharding (tensor parallelism)")
        if optimizer not in _RULES:
            raise MXNetError(
                f"SPMD step supports {sorted(_RULES)}; got {optimizer}. "
                "Use gluon.Trainer for other optimizers.")
        if zero_stage is None:
            zero_stage = 1 if shard_opt_states else _fusedstep.zero_stage()
        if int(zero_stage) not in (0, 1, 2, 3):
            raise MXNetError(f"zero_stage must be 0-3, got {zero_stage}")
        self.zero_stage = int(zero_stage)
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
        self._names = self._handles = self._diff = None
        self._last_loss = None
        self._mode = None  # resolved at init_state: jit|overlap|staged
        self._plan = None  # the bucket plan, from the first mesh step
        self._residuals = None  # per-bucket 2-bit compression carry

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
        return self.mesh is not None and self._dp_size() > 1

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
        names, handles, diff = self._collect()
        self._names, self._handles, self._diff = names, handles, diff
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
        if self.mesh.size != world()[1]:
            raise MXNetError(
                f"SPMDTrainStep: a mesh of {self.mesh.size} ranks in a world "
                f"of {world()[1]}; join the world first "
                "(kvstore.init_distributed)")
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
                "grad_bytes_replicated": grad_full}

    # -- the step ---------------------------------------------------------
    def _run_forward(self, params, x, y):
        """The Gluon forward over ``params`` (bound into the parameter
        handles for the call) and the mean loss, recorded for backward.
        Hybridized blocks inside run eagerly, as in the JAX step's trace:
        a captured graph reads the tensors the handles held when it was
        captured, not the step's own."""
        with _bound(self._handles, params), \
                autograd._RecordingStateScope(True, True):
            loss = self.loss_fn(self.block(NDArray(x)), NDArray(y))
        return loss.data.mean()

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
        if self._on_mesh():
            return self._mesh_step(x, y, lr)
        loss, grads = self._loss_and_grads(x, y)
        self._apply(grads, lr)
        return loss

    # -- the data-parallel step -------------------------------------------
    def _gather_buckets(self, shards):
        """Every rank's ``[pad/dp]`` shard of each differentiable
        parameter -> its whole tensor, one ``all_gather_into_tensor`` per
        plan bucket, all started before the first is waited on (``shards``
        and the result in ``_diff`` order)."""
        import torch.distributed as dist

        plan, dp = self._plan, self._dp_size()
        out = [None] * len(shards)
        with torch.no_grad():
            started = []
            for idxs in plan.buckets:
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
                    n = plan.pad_sizes[k] // dp
                    out[k] = _overlap.unpad_reshape(
                        rows[:, off:off + n].reshape(-1), plan.sizes[k],
                        plan.shapes[k]).detach()
                    off += n
        return out

    def _build_plan(self, order):
        """The bucket plan of the differentiable parameters in readiness
        order (from the first step's forward; None: reversed parameter
        order), padded for the reduce-scatter layout every stage's
        collectives use."""
        params, _ = self._state
        didx = [i for i, d in enumerate(self._diff) if d]
        shapes = [tuple(self._handles[i].data.shape) for i in didx]
        dtypes = [str(params[i].dtype).split(".")[1] for i in didx]
        dp = self._dp_size()
        self._plan = _overlap.build_bucket_plan(shapes, dtypes, order=order,
                                                dp=dp)
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
            return x, y
        dev = self._handles[0].data.device
        return (shard_batch(x, self.mesh, self.batch_axis, dev),
                shard_batch(y, self.mesh, self.batch_axis, dev))

    def __call__(self, x, y, lr=0.01, sync=True):
        if self._state is None:
            # resolve deferred init with one predict-mode pass on one row,
            # eager even in a hybridized block (nothing worth capturing)
            raw = _raw(x)
            with _bound(), autograd.predict_mode():
                self.block(NDArray(raw[0:1] if raw.shape[0] > 1 else raw))
            self.init_state()
        loss = self._step(*self._prepare(*self._local(x, y), lr))
        return float(loss) if sync else loss

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
        losses, one device tensor."""
        if self._on_mesh() or (self.mesh is not None
                               and self._dp_size() > 1):
            raise _not_ported("run_superstep on a mesh")
        raw_x, raw_y = _raw(xs), _raw(ys)
        if self._state is None:
            row = raw_x[0]
            with _bound(), autograd.predict_mode():
                self.block(NDArray(row[0:1] if row.dim() and
                                   row.shape[0] > 1 else row))
            self.init_state()
        k = int(raw_x.shape[0])
        lrs = [float(v) for v in torch.as_tensor(lr).reshape(-1).tolist()]
        if len(lrs) == 1:
            lrs = lrs * k
        if len(lrs) != k:
            raise MXNetError(f"run_superstep: lr must be a scalar or {k} "
                             f"values; got {len(lrs)}")
        losses = [self._step(*self._prepare(raw_x[i], raw_y[i], lrs[i]))
                  for i in range(k)]
        out = torch.stack(losses)
        self._last_loss = out[-1]
        return out

    def sync_to_block(self):
        """Write the step's parameters back into the Gluon parameters
        (copies: the step goes on replacing its own tensors)."""
        params, _ = self._state
        if self._on_mesh() and self.zero_stage == 3:
            didx = [i for i, d in enumerate(self._diff) if d]
            params = list(params)
            with torch.no_grad():
                for k, t in zip(didx, self._gather_buckets(
                        [params[i] for i in didx])):
                    params[k] = t
        for h, p in zip(self._handles, params):
            h._set_data(p)
