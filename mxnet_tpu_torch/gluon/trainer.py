"""Gluon Trainer: applies an optimizer to a set of parameters.

PyTorch counterpart of the single-device part of
``mxnet_tpu/gluon/trainer.py``. ``step(batch_size)`` sets ``rescale_grad
= scale / batch_size``, reduces gradients across devices (the identity on
one device: no kvstore is made) and updates every parameter whose
``grad_req`` is not ``"null"``. Parameters are ordered by name, as in the
JAX package, so an optimizer's per-index state lines up with it.

Fused update (``MXTPU_FUSED_STEP``, default on): for SGD, NAG, Adam and
LAMB every parameter is updated by one multi-tensor update per step
(``optimizer/multi_tensor.py``, a constant number of ``torch._foreach_*``
calls), the counterpart of the JAX package's one jitted executable. The
learning rate (scheduled or set), weight decay, ``rescale_grad``,
``clip_gradient`` and the per-parameter ``lr_mult``/``wd_mult`` are
values of each step, so changing them never rebuilds the plan; a change
of the optimizer's constants (momentum, betas, epsilon), of which
parameters are trained, or of a parameter's tensors does. Everything else
(other optimizers, sparse or multi-device parameters, missing gradient
buffers) takes the per-parameter path, logged once
(``fusedstep.log_fallback``). Optimizer state moves between the two paths
without resetting momentum or Adam's step count.

``save_states``/``load_states`` write and read the JAX package's file
(format 2: a pickle of numpy leaves), so either package resumes the
other's run.

float16 AMP (``amp.init_trainer``): the fused update checks the whole
gradient set for non-finite values in one reduction, unscales an fp32
copy of the gradients by the combined ``(1/batch)/loss_scale`` factor,
skips the whole update on an overflow (weights, fp32 masters and every
state leaf stay bit for bit) and backs the scale off or grows it, on the
device; the per-parameter path does the same with one synchronisation.

``step`` is a fault point of ``resilience.chaos`` (site ``trainer``),
runs inside ``resilience.checkpoint.step_critical_section()`` and ticks
an attached ``CheckpointManager`` once.

:class:`Superstep` runs K forward + backward + update iterations over
stacked batches; on a CUDA card the K iterations are one captured CUDA
graph.

Several contexts and several ranks (reference: ``_init_kvstore``,
``_allreduce_grads``): parameters on more than one context (``cpu(0)``
and ``cpu(1)``, or one card per rank of a ``torch.distributed`` world)
sum their gradients through a store, made from ``kvstore`` (``"device"``,
``"local"``, a ``dist*`` name or a store object) with
``compression_params`` handed to it. ``step`` sets ``rescale_grad =
scale / batch_size`` and the store sums, exactly as in the JAX package.
The fused update declines several contexts (logged once), and the
per-parameter path updates the first context's copy and copies it to the
others. ``update_on_kvstore`` is kept and, as in the JAX package, not
read: the Trainer updates and the store only sums. ``Superstep``
declines a store (logged), running K single steps.

Telemetry (``observability.ENABLED``): each ``Trainer.step`` records its
span and the global L2 norm of the summed gradients as a lazy device
scalar (``mxtpu_trainer_grad_norm``: no synchronisation until the gauge
is read), each superstep its K, amortized time and per-iteration loss
series; the watchdog and the federation beat run at the step boundary.
``MXTPU_PROFILE`` windows wrap the covered steps, and the live-elasticity
pause point (``resilience.elastic.pause_point``) runs first when armed.
"""

from __future__ import annotations

import pickle
import re
import time

import numpy as _np
import torch

from .. import autograd
from .. import fusedstep as _fusedstep
from .. import observability as _obs
from .. import optimizer as opt
from ..amp.policy import is_low_precision_dtype
from ..base import MXNetError
from ..context import current_context, resolve_device
from ..ndarray.ndarray import NDArray
from ..optimizer import multi_tensor
from ..resilience import chaos as _chaos
from ..resilience import checkpoint as _ckptmod
from ..resilience import elastic as _elastic
from ..resilience.checkpoint import _flatten_state, _unflatten_state
from . import _capture
from .parameter import Parameter, ParameterDict


def _to_numpy(t):
    """A host copy of ``t``; bfloat16 as ``ml_dtypes.bfloat16`` (what the
    JAX package's files hold) where that package is installed, else as
    float32."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        try:
            import ml_dtypes
        except ImportError:
            return t.float().numpy()
        return t.view(torch.int16).numpy().copy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def _from_numpy(a, device):
    a = _np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(_np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(_np.array(a))
    return t.to(device)


def _natural_key(name):
    """Digit-aware sort key: construction order, not lexicographic
    (``dense9_`` was created before ``dense10_`` but sorts after it)."""
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", name)]


# -- the fused update of one iteration ---------------------------------
# Shared by Trainer.step's fused path and by each iteration of a
# Superstep (eager or captured), so the two agree bit for bit. Values of
# the step reach it as 0-d float64 tensors on the device (``_scalars``):
# the superstep's captured graph reads them from buffers, and both paths
# then round them alike.

def _scalars(device):
    """A function giving the 0-d float64 device tensor of a value, one
    per distinct value; 0.0 stays a Python zero, so a rule skips its
    weight decay term exactly where the host value is 0."""
    cache = {}

    def get(v):
        v = float(v)
        if v == 0.0:
            return 0.0
        t = cache.get(v)
        if t is None:
            t = cache[v] = torch.full((), v, dtype=torch.float64,
                                      device=device)
        return t

    return get


def _rescaled(gs, rescale, clip):
    """The gradients times ``rescale`` (a 0-d tensor), clipped: new
    tensors (the buffers stay as the backward wrote them)."""
    out = multi_tensor._mul(gs, [rescale] * len(gs))
    if clip is not None:
        torch._foreach_clamp_min_(out, -clip)
        torch._foreach_clamp_max_(out, clip)
    return out


def _amp_scale_step(finite, scale, unskipped, ovf_total, factor, window):
    """The device twin of ``LossScaler.update_scale``, in place: back off
    on an overflow (floor 1.0), grow after ``window`` clean updates, count
    the overflows."""
    ovf = torch.logical_not(finite)
    unsk1 = unskipped + 1
    grow = unsk1 >= window
    new_scale = torch.where(
        ovf, torch.clamp(scale / factor, min=1.0),
        torch.where(grow, scale * factor, scale))
    unskipped.copy_(torch.where(torch.logical_or(ovf, grow),
                                torch.zeros_like(unsk1), unsk1))
    scale.copy_(new_scale)
    ovf_total.add_(ovf.to(ovf_total.dtype))


def _state_leaves(states):
    return [leaf for st in states for leaf in st]


@torch.no_grad()
def _fused_apply(name, hyper, ws, gs, states, lrs, wds, rescale, clip,
                 multi_precision, amp=None, t_uniform=False):
    """One fused update of the weights ``ws`` (in place) from the
    gradients ``gs`` (never written). ``amp``: None, or a dict of the
    loss scaler's device tensors ``scale``, ``unskipped``, ``overflow``
    (updated in place), the divisor ``div`` still to take out of the
    gradients (the scale, or 1 after ``amp.unscale``), ``factor`` and
    ``window``. Under ``amp`` the gradients are copied to fp32 and checked
    for non-finite values in one reduction while the combined
    ``rescale / div`` factor multiplies them (in fp32: at batch 512 and
    scale 2^16 that factor is below float16's smallest subnormal); an
    overflow leaves the weights and every state leaf as they were, bit
    for bit, through a copy taken before the rule runs. Returns the
    device flag "all finite" under ``amp``, else None."""
    if amp is None:
        multi_tensor.update(name, hyper, ws, _rescaled(gs, rescale, clip),
                            states, lrs, wds, multi_precision, t_uniform)
        return None
    g32 = multi_tensor._cast_list(gs, torch.float32)
    found = torch.zeros(1, dtype=torch.float32, device=ws[0].device)
    inv = rescale.to(torch.float32).reshape(1) / amp["div"].reshape(1)
    torch._amp_foreach_non_finite_check_and_unscale_(g32, found, inv)
    if clip is not None:
        torch._foreach_clamp_min_(g32, -clip)
        torch._foreach_clamp_max_(g32, clip)
    finite = found[0] == 0
    leaves = list(ws) + _state_leaves(states)
    saved = [t.clone() for t in leaves]
    multi_tensor.update(name, hyper, ws, g32, states, lrs, wds,
                        multi_precision, t_uniform)
    for t, old in zip(leaves, saved):
        torch.where(finite, t, old, out=t)
    _amp_scale_step(finite, amp["scale"], amp["unskipped"], amp["overflow"],
                    amp["factor"], amp["window"])
    return finite


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = [params[k] for k in sorted(params.keys())]
        if not isinstance(params, (list, tuple)):
            raise MXNetError(
                "params must be a list/dict/ParameterDict of Parameter")
        self._params = []
        self._param2idx = {}
        for i, p in enumerate(params):
            if not isinstance(p, Parameter):
                raise MXNetError(f"invalid parameter {p}")
            self._params.append(p)
            self._param2idx[p.name] = i
        self._compression_params = compression_params
        self._kvstore_type = kvstore
        # kept and not read, as in the JAX package: the Trainer updates,
        # the store only sums
        self._update_on_kvstore = update_on_kvstore
        self._kvstore = None
        self._kv_initialized = False
        self._params_to_init = list(self._params)
        self._contexts = self._check_contexts()
        self._init_optimizer(optimizer, optimizer_params or {})
        self._scale = self._optimizer.rescale_grad
        self._fused = None  # fused-update plan (None = undecided)
        self._fused_states = {}  # param name -> optimizer-state tuple
        # checkpoint restores written into the states in place (their
        # tuples keep their identity): a Superstep plan checks its step
        # leaves again after one
        self._restores = 0

    def _check_contexts(self):
        """The contexts every parameter lives on (or is deferred to); they
        must be the same for all."""
        contexts = None
        for p in self._params:
            if p._data is not None:
                ctx = list(p._data)
            elif p._deferred_init is not None:
                ctx = p._deferred_init[1]
            else:
                continue
            if contexts is not None and set(map(str, ctx)) \
                    != set(map(str, contexts)):
                raise MXNetError("All Parameters must be initialized on "
                                 "the same contexts")
            contexts = ctx
        return contexts or []

    def _init_kvstore(self):
        """The store (reference: ``Trainer._init_kvstore``): a store object
        as given; a name makes one when the parameters live on several
        contexts or the name is a ``dist*`` one; one context needs none.
        ``compression_params`` go to the store."""
        from ..kvstore import create as _create_kvstore
        from ..kvstore.base import KVStoreBase

        if isinstance(self._kvstore_type, KVStoreBase):
            self._kvstore = self._kvstore_type
        elif self._kvstore_type is None:
            self._kvstore = None
        else:
            n_dev = max(len(self._contexts), 1)
            if n_dev > 1 or (isinstance(self._kvstore_type, str)
                             and self._kvstore_type.startswith("dist")):
                self._kvstore = _create_kvstore(self._kvstore_type)
            else:
                self._kvstore = None
        if self._kvstore is not None and self._compression_params:
            self._kvstore.set_gradient_compression(self._compression_params)
        self._kv_initialized = True

    def _init_params(self):
        """Give the store each parameter that is initialised by now (its
        first context's copy; ``dist_tpu_sync`` takes rank 0's)."""
        if not self._kv_initialized:
            self._init_kvstore()
        remaining, keys, values = [], [], []
        for param in self._params_to_init:
            if param._deferred_init is not None:
                remaining.append(param)
                continue
            if self._kvstore is not None and param._data is not None:
                keys.append(self._param2idx[param.name])
                values.append(param.list_data()[0])
        initialized_any = len(remaining) < len(self._params_to_init)
        if keys:
            # one call: a dist store broadcasts rank 0's values in buckets
            self._kvstore.init(keys, values)
        self._params_to_init = remaining
        if not self._contexts:
            self._contexts = self._check_contexts()
        if initialized_any:
            self._invalidate_fused()

    def _ready(self):
        if not self._kv_initialized:
            self._init_kvstore()
        if self._params_to_init:
            self._init_params()

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise MXNetError("optimizer_params must be empty if "
                                 "optimizer is an instance")
            self._optimizer = optimizer
            optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)
        # lr is a value of each step: a valid plan needs no rebuild; only
        # a cached "not eligible" verdict is looked at again
        if self._fused is False:
            self._invalidate_fused()

    def step(self, batch_size, ignore_stale_grad=False):
        """Scale gradients by ``1 / batch_size``, sum them across contexts
        and ranks through the store and update every parameter.
        ``batch_size`` is what the caller passes, as in the JAX package:
        with ``dist_tpu_sync`` the gradients are the sum over every rank's
        batch, so passing one rank's batch size scales the step by the
        number of ranks. A fault
        point of ``resilience.chaos`` (site ``trainer``); the update runs
        inside ``step_critical_section()`` (a SIGTERM's final checkpoint
        waits for its end) and ticks an attached ``CheckpointManager``."""
        if _chaos.ENABLED:
            _chaos.step_point("trainer")
        if _elastic.ENABLED:
            # membership signals (a preemption notice: a proactive
            # checkpoint) are taken at the boundary, never mid-step
            _elastic.pause_point("trainer", trainer=self)
        with _ckptmod.step_critical_section():
            if _obs.introspect.PROFILING:
                with _obs.introspect.profile_step():
                    self._step_instrumented(batch_size, ignore_stale_grad)
            else:
                self._step_instrumented(batch_size, ignore_stale_grad)
            mgr = getattr(self, "_ckpt_manager", None)
            if mgr is not None:
                mgr.on_step(1)

    def _step_instrumented(self, batch_size, ignore_stale_grad):
        if not _obs.ENABLED:
            self._step_impl(batch_size, ignore_stale_grad)
            return
        t0 = time.perf_counter()
        self._step_impl(batch_size, ignore_stale_grad)
        t1 = time.perf_counter()
        _obs.record_trainer_step(t0, t1, self._grad_norm())
        if _obs.watchdog.ENABLED:
            _obs.watchdog.poll()
        # the federation exchange's collectives run here, in step order
        # on every rank (no-op unless armed in a world of several)
        _obs.federation.poll()

    def _step_impl(self, batch_size, ignore_stale_grad):
        self._ready()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._allreduce_grads()
        self._update(ignore_stale_grad)

    @torch.no_grad()
    def _grad_norm(self):
        """Global L2 norm of the summed gradients after the update's
        inputs are final: a 0-d float32 device tensor (the gauge stores
        it lazily), 0.0 with no gradient."""
        grads = [p.list_grad()[0] for p in self._params
                 if p.grad_req != "null" and p._data is not None]
        grads = [g.data for g in grads if g is not None]
        if not grads:
            return 0.0
        norms = torch._foreach_norm([g.float() for g in grads])
        return torch.linalg.vector_norm(torch.stack(norms))

    def allreduce_grads(self):
        """Sum every gradient across the contexts and ranks its parameter
        lives on (one multi-key ``pushpull``); with no store, nothing."""
        self._ready()
        self._allreduce_grads()

    def _grad_keys(self):
        keys, params = [], []
        for i, param in enumerate(self._params):
            if param.grad_req == "null" or param._data is None:
                continue
            keys.append(i)
            params.append(param)
        return keys, params

    def _allreduce_grads(self):
        if self._kvstore is None:
            return
        keys, params = self._grad_keys()
        if not keys:
            return
        grads = [p.list_grad() for p in params]
        self._kvstore.pushpull(keys, grads, out=grads)

    def update(self, batch_size, ignore_stale_grad=False):
        """The update alone, after :meth:`allreduce_grads`."""
        self._ready()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    # -- fused update -----------------------------------------------------
    # sgd/nag/adam/lamb map onto one multi-tensor rule; the hyper names
    # besides wd are constants of the plan (AdamW is left out: its
    # decoupled decay differs from the adam rule)
    _FUSABLE = {"sgd": ("momentum", "wd"),
                "nag": ("momentum", "wd"),
                "adam": ("beta1", "beta2", "epsilon", "wd"),
                "lamb": ("beta1", "beta2", "epsilon", "wd")}

    def _invalidate_fused(self):
        """Drop the plan (the states survive in ``_fused_states``); the
        next step decides eligibility again."""
        self._fused = None

    def _fused_setup(self):
        if self._fused is not None:
            return self._fused
        active = [p for p in self._params if p.grad_req != "null"]
        if not active or any(p._data is None or p._deferred_init is not None
                             for p in active):
            # shapes not known yet: decide later (a cached False would
            # disable the fused path for good)
            return False
        self._fused = self._build_fused_plan(active)
        return self._fused

    def _fused_rules(self):
        """``(name, hyper, rule_init)`` of the optimizer's multi-tensor
        rule, or the reason it has none."""
        o = self._optimizer
        name = type(o).__name__.lower()
        if name not in self._FUSABLE:
            return f"optimizer '{name}' has no fused rule"
        if name == "lamb" and (
                getattr(o, "lower_bound", None) is not None
                or getattr(o, "upper_bound", None) is not None
                or not getattr(o, "bias_correction", True)):
            return "lamb with bounds/bias_correction=False"
        from ..parallel.spmd import _RULES, mp_rule

        hyper = {k: getattr(o, k) for k in self._FUSABLE[name]
                 if hasattr(o, k)}
        hyper["wd"] = o.wd
        rule_init, rule_update = _RULES[name](hyper)
        if o.multi_precision:
            # fp32 masters of bf16/fp16 weights are state leaf 0
            rule_init, rule_update = mp_rule(rule_init, rule_update)
        return name, hyper, rule_init

    def _fused_sig(self):
        """What a plan is built for: the optimizer's kind, its
        ``multi_precision`` and the loss scaler's constants."""
        o = self._optimizer
        scaler = getattr(self, "_amp_loss_scaler", None)
        return (type(o).__name__.lower(), o.multi_precision,
                None if scaler is None
                else (scaler._factor, scaler._window))

    def _build_fused_plan(self, active):
        def no(reason):
            _fusedstep.log_fallback("trainer", reason)
            return False

        rules = self._fused_rules()
        if isinstance(rules, str):
            return no(rules)
        name, hyper, rule_init = rules
        if any(p._stype != "default" or p._grad_stype != "default"
               for p in active):
            return no("sparse parameters/gradients")
        if any(len(p._data) != 1 for p in active):
            return no("multi-device parameters")
        handles = [p.data() for p in active]
        grads = [h.grad for h in handles]
        if any(g is None for g in grads):
            return no("gradient buffers not attached")
        idx = [self._param2idx[p.name] for p in active]
        states = [self._restore_fused_state(name, p, i, h.data, rule_init)
                  for p, i, h in zip(active, idx, handles)]
        # the states live in _fused_states from now on, so a rebuilt plan
        # and the eager path find them there
        for p, st in zip(active, states):
            self._fused_states[p.name] = st
        return {"active": active, "idx": idx, "name": name, "hyper": hyper,
                "t_uniform": multi_tensor.uniform_steps(name, states),
                "handles": handles, "grads": grads,
                "weights": [h.data for h in handles],
                "grad_tensors": [g.data for g in grads], "states": states,
                "sig": self._fused_sig(),
                "req_sig": tuple(p.grad_req for p in self._params),
                "static_hyper": {k: v for k, v in hyper.items()
                                 if k != "wd"}}

    def _plan_is_stale(self, plan):
        """Pure host compares: the optimizer's kind or constants or the
        loss scaler changed, a parameter was frozen or unfrozen, a
        parameter's handle, tensor or gradient buffer was replaced
        (re-initialized, cast), or another path replaced a state
        (``_fused_states``, shared with ``Superstep`` and the restore of a
        checkpoint)."""
        o = self._optimizer
        return (self._fused_sig() != plan["sig"]
                or any(self._fused_states.get(p.name) is not st
                       for p, st in zip(plan["active"], plan["states"]))
                or tuple(p.grad_req for p in self._params) != plan["req_sig"]
                or any(getattr(o, k, None) != v
                       for k, v in plan["static_hyper"].items())
                or any(p._data is None or p.data() is not h
                       or h.data is not w or h.grad is not g
                       or g.data is not gt
                       for p, h, w, g, gt in zip(
                           plan["active"], plan["handles"], plan["weights"],
                           plan["grads"], plan["grad_tensors"])))

    def _amp_operands(self, device):
        """The loss scaler's operands of a fused update (None without a
        scaler). A pending ``scale_loss`` hands in the scaler's tensors;
        without one, stand-ins take the scale arithmetic (the gradients
        are still checked and an overflow still skips, but the scale stays
        as it is). ``div``: what is left to divide out of the gradients,
        the scale, or 1 after ``amp.unscale`` or without ``scale_loss``."""
        scaler = getattr(self, "_amp_loss_scaler", None)
        if scaler is None:
            return None
        scaler._on(device)
        pending = getattr(self, "_amp_pending", False)
        one = torch.ones((), dtype=torch.float32, device=device)
        if pending:
            self._amp_pending = False
            scale, unsk = scaler._scale_arr, scaler._unskipped_arr
            div = scale if pending == "scaled" else one
        else:
            scale, unsk, div = one, torch.zeros(
                (), dtype=torch.int32, device=device), one
        return {"scale": scale, "unskipped": unsk, "div": div,
                "overflow": scaler._overflow_total_arr,
                "factor": scaler._factor, "window": scaler._window}

    @torch.no_grad()
    def _maybe_fused_update(self):
        """Run the multi-tensor update; False when the per-parameter path
        must run instead."""
        if not _fusedstep.ENABLED:
            return False
        plan = self._fused_setup()
        if plan and self._plan_is_stale(plan):
            self._invalidate_fused()
            plan = self._fused_setup()
        if not plan:
            return False
        o = self._optimizer
        # advance the update counts on the host exactly as the eager path
        for i in plan["idx"]:
            o._index_update_count[i] = o._index_update_count.get(
                i, o.begin_num_update) + 1
            o.num_update = max(o.num_update, o._index_update_count[i])
        lr = o.learning_rate  # scheduler-aware, after the counts moved
        device = plan["weights"][0].device
        sc = _scalars(device)
        with _obs.introspect.site("trainer_fused", device):
            _fused_apply(
                plan["name"], plan["hyper"], plan["weights"],
                plan["grad_tensors"], plan["states"],
                [sc(lr * p.lr_mult) for p in plan["active"]],
                [sc(o.wd * p.wd_mult) for p in plan["active"]],
                sc(o.rescale_grad), o.clip_gradient, o.multi_precision,
                self._amp_operands(device), plan["t_uniform"])
        if _obs.ENABLED:
            _obs.record_xla_dispatch("trainer_fused")
        return True

    def _restore_fused_state(self, name, p, idx, raw, rule_init):
        """The fused state of one parameter: the one a previous plan left
        in ``_fused_states``; else a copy of its eager state
        (``param._opt_state``, whose ownership moves here); else a fresh
        one whose Adam/LAMB step leaf continues from the update count.
        Under ``multi_precision`` a bf16/fp16 weight's fp32 master is leaf
        0 both ways."""
        expected = tuple(rule_init(raw.detach()))
        cached = self._fused_states.get(p.name)
        if cached is not None and len(cached) == len(expected) and all(
                c.shape == e.shape and c.dtype == e.dtype
                for c, e in zip(cached, expected)):
            return cached
        o = self._optimizer
        t = o._index_update_count.get(idx, o.begin_num_update)
        st = getattr(p, "_opt_state", None)
        if st is not None:
            copy = lambda a, like: a.data.detach().to(  # noqa: E731
                like.dtype, copy=True)
            prefix, inner_expected, inner_st = (), expected, st
            ok = True
            if o.multi_precision and is_low_precision_dtype(raw.dtype):
                # eager mp state: (fp32 master, inner state)
                ok = isinstance(st, tuple) and len(st) == 2 and \
                    st[0].shape == tuple(expected[0].shape)
                if ok:
                    prefix = (copy(st[0], expected[0]),)
                    inner_expected, inner_st = expected[1:], st[1]
            migrated = None
            if ok and name in ("sgd", "nag"):
                if len(inner_expected) == 0 and inner_st is None:
                    migrated = prefix
                elif len(inner_expected) == 1 and isinstance(
                        inner_st, NDArray) and inner_st.shape == tuple(
                        inner_expected[0].shape):
                    migrated = prefix + (copy(inner_st, inner_expected[0]),)
            elif ok and name in ("adam", "lamb") and isinstance(
                    inner_st, tuple) and len(inner_st) == 2 \
                    and inner_st[0].shape == tuple(inner_expected[0].shape):
                m, v = inner_st
                migrated = prefix + (
                    copy(m, inner_expected[0]), copy(v, inner_expected[1]),
                    torch.tensor(t, dtype=torch.int32, device=raw.device))
            if migrated is not None:
                del p._opt_state
                return migrated
        if name in ("adam", "lamb") and t:
            # the step leaf is last (leaf 3 behind a master)
            expected = expected[:-1] + (
                torch.tensor(t, dtype=torch.int32, device=raw.device),)
        return expected

    def _migrate_fused_to_eager(self, param, idx, weight):
        """The eager state of a parameter whose state the fused path
        holds, so that a flip to the per-parameter path keeps momentum
        and Adam's step count (moved into the update counts). Ownership
        moves: the fused copy is dropped."""
        st = self._fused_states.pop(param.name, None)
        if st is None:
            return None
        o = self._optimizer
        name = type(o).__name__.lower()

        def mk(t, dtype):
            return NDArray(t.detach().to(dtype, copy=True))

        def take_count(t):
            o._index_update_count[idx] = max(
                o._index_update_count.get(idx, o.begin_num_update), int(t))

        if o.multi_precision and is_low_precision_dtype(weight.data.dtype):
            if not st:
                return None
            master, inner = mk(st[0], torch.float32), tuple(st[1:])
            if name in ("sgd", "nag") and len(inner) <= 1:
                return (master,
                        mk(inner[0], torch.float32) if inner else None)
            if name in ("adam", "lamb") and len(inner) == 3:
                take_count(inner[2])
                return (master, (mk(inner[0], torch.float32),
                                 mk(inner[1], torch.float32)))
            return None
        wdt = weight.data.dtype
        if name in ("sgd", "nag") and len(st) == 1:
            return mk(st[0], wdt)
        if name in ("adam", "lamb") and len(st) == 3:
            take_count(st[2])
            return (mk(st[0], wdt), mk(st[1], wdt))
        return None

    def _amp_eager_pending(self):
        """The per-parameter path's loss scaling after a ``scale_loss``
        block: one reduction (and one synchronisation) decides skip or
        update, the gradient buffers are divided by the scale
        (``amp.unscale``), and the scale moves on the host. True: skip."""
        scaler = getattr(self, "_amp_loss_scaler", None)
        pending = getattr(self, "_amp_pending", False)
        if scaler is None or not pending:
            return False
        active = [p for p in self._params
                  if p.grad_req != "null" and p._data is not None]
        overflow = scaler.has_overflow(active)
        if not overflow and pending == "scaled":
            from .. import amp as _amp

            _amp.unscale(self)
        self._amp_pending = False
        scaler.update_scale(overflow)
        return overflow

    def _update(self, ignore_stale_grad=False):
        if self._maybe_fused_update():
            return
        if isinstance(self._fused, dict):
            # the eager loop advances states the plan does not see: a
            # later re-enable must rebuild (and migrate) the plan
            self._invalidate_fused()
        if self._amp_eager_pending():
            return  # the skip: nothing moves, as on the fused path
        self._update_eager(ignore_stale_grad)

    def _update_eager(self, ignore_stale_grad=False):
        del ignore_stale_grad
        for i, param in enumerate(self._params):
            if param.grad_req == "null" or param._data is None:
                continue
            datas = param.list_data()
            weight, grad = datas[0], param.list_grad()[0]
            if not hasattr(param, "_opt_state"):
                param._opt_state = (
                    self._migrate_fused_to_eager(param, i, weight)
                    if param.name in self._fused_states else None)
                if param._opt_state is None:
                    param._opt_state = \
                        self._optimizer.create_state_multi_precision(
                            i, weight)
            self._optimizer.update_multi_precision(i, weight, grad,
                                                   param._opt_state)
            # after the allreduce every context holds the summed gradient:
            # update once, copy the weight to the others
            for d in datas[1:]:
                d._set_data(weight.data.to(d.data.device))

    # -- optimizer state files --------------------------------------------
    def _state_index_map(self, saved_names):
        """saved-state index -> current-param index, aligned by
        construction order (natural sort of names on each side). With no
        saved names the map is the identity."""
        n = len(self._params)
        if not saved_names or len(saved_names) != n:
            return {i: i for i in range(n)}
        s_order = sorted(range(n), key=lambda i: _natural_key(saved_names[i]))
        c_order = sorted(range(n),
                         key=lambda i: _natural_key(self._params[i].name))
        return dict(zip(s_order, c_order))

    @staticmethod
    def _eager_state_to_np(st, key):
        if st is None:
            return None
        import itertools

        sink = {}
        desc = _flatten_state(st, key, sink, itertools.count())
        return {"desc": desc,
                "tensors": {k: _to_numpy(v) for k, v in sink.items()}}

    @staticmethod
    def _eager_state_from_np(st, device):
        if st is None:
            return None
        if isinstance(st, dict) and "desc" in st:
            return _unflatten_state(
                st["desc"], st["tensors"],
                lambda raw: NDArray(_from_numpy(raw, device)))
        return st  # format-1 file: a pickled state rides through

    @staticmethod
    def _device_of(p):
        if p is not None and p._data is not None:
            return next(iter(p._data.values())).data.device
        return resolve_device(current_context())

    def save_states(self, fname):
        """Save the optimizer state of both update paths: the fused state
        tuples (momentum, Adam/LAMB's step leaf) keyed by parameter index,
        any eager ``_opt_state``, the parameter names and the update
        counts, as the JAX package's format-2 file."""
        states = {i: self._eager_state_to_np(
            getattr(p, "_opt_state", None), f"s{i}")
            for i, p in enumerate(self._params)}
        fused_states = {
            i: tuple(_to_numpy(leaf) for leaf in self._fused_states[p.name])
            for i, p in enumerate(self._params)
            if p.name in self._fused_states}
        with open(fname, "wb") as f:
            pickle.dump({
                "format": 2,
                "states": states,
                "param_names": [p.name for p in self._params],
                "update_counts": dict(self._optimizer._index_update_count),
                "num_update": self._optimizer.num_update,
                "fused_states": fused_states,
            }, f)

    def load_states(self, fname):
        """Inverse of :meth:`save_states`, for files of either package.
        A parameter whose state the file holds in fused form loses any
        eager ``_opt_state`` (the eager path would prefer it); the next
        step on either path goes on from the restored states."""
        with open(fname, "rb") as f:
            blob = pickle.load(f)
        fmt = blob.get("format", 1)
        n = len(self._params)
        saved_n = len(blob.get("param_names", [])) or \
            len(blob.get("states", {}))
        if fmt >= 2 and saved_n and saved_n != n:
            raise MXNetError(
                f"load_states: file holds state for {saved_n} params, "
                f"this trainer has {n} — the model structure differs")
        idx_map = self._state_index_map(blob.get("param_names")) \
            if fmt >= 2 else {i: i for i in range(n)}
        inv_map = {ci: si for si, ci in idx_map.items()}
        for i, p in enumerate(self._params):
            st = blob["states"].get(inv_map.get(i, i))
            if st is not None:
                p._opt_state = st if fmt < 2 else \
                    self._eager_state_from_np(st, self._device_of(p))
            elif hasattr(p, "_opt_state"):
                del p._opt_state
        by_name = {p.name: p for p in self._params}
        fused = {}
        for key, st in blob.get("fused_states", {}).items():
            # format-1 files were keyed by name, later ones by index
            p = self._params[idx_map.get(int(key), int(key))] \
                if fmt >= 2 else by_name.get(key)
            dev = self._device_of(p)
            fused[p.name if p is not None else key] = tuple(
                _from_numpy(leaf, dev) for leaf in st)
        self._fused_states = fused
        self._optimizer._index_update_count = {
            idx_map.get(int(k), int(k)): int(v)
            for k, v in blob["update_counts"].items()}
        self._optimizer.num_update = int(blob["num_update"])
        self._invalidate_fused()


def _stacked_raw(a):
    if isinstance(a, NDArray):
        return a.data
    if isinstance(a, torch.Tensor):
        return a
    return torch.as_tensor(_np.asarray(a))


class Superstep:
    """K forward + backward + update iterations of the Gluon loop over
    stacked batches (reference: ``gluon.Superstep``, one ``lax.scan``).

    >>> sstep = gluon.Superstep(net, loss_fn, trainer, k=8)
    >>> for group, n in gluon.data.SuperstepRing(loader, 8, device=ctx):
    ...     if n == 8:
    ...         losses = sstep.step(group[0], group[1], batch_size)
    ...     else:                       # short tail: single steps
    ...         sstep.run_single(group, batch_size)

    or ``sstep.run(loader, batch_size)`` for a whole pass.

    Iteration ``i`` reads slot ``i`` of the ``[K, ...]`` block: the
    block's forward in training mode and the loss under ``record()``,
    the gradients of the summed loss (what ``loss.backward()`` gives),
    and the Trainer's fused update (``_fused_apply``: the same arithmetic
    as ``trainer.step``, bit for bit) at that iteration's learning rate.
    BatchNorm's running statistics move from one iteration to the next.
    Under a float16 loss scaler each iteration scales its loss, checks
    its gradients, skips only itself on an overflow and adjusts the
    scale; ``last_overflow`` holds the K per-iteration flags (device
    tensor). The update counts advance by K, and the learning-rate
    schedule is sampled on the host once per covered update count.

    On a CUDA card the K iterations are ONE captured CUDA graph (through
    ``gluon/_capture.py``, thread-local, the default generator
    registered, so dropout draws the next numbers of the stream at each
    replay): the host touches the loop once per K steps. The values that
    change between supersteps reach the graph through device buffers
    filled by one host-to-device copy (the ``[K]`` learning rates, weight
    decay, ``rescale_grad``; the batches and the loss scaler's counters
    by device copies). A change of K, of the batch shapes or types, of
    the per-parameter multipliers' grouping, of which weight decays are
    zero, of ``clip_gradient`` or of the tensors the graph read captures
    again. A capture or replay that fails raises; on the CPU the K
    iterations run eagerly with the same arithmetic.

    Optimizer state is shared with ``trainer.step`` (``_fused_states``,
    updated in place), so the two interleave without resetting momentum
    or Adam's ``t``. An optimizer without a fused rule, a Trainer that
    sums through a kvstore, sparse or multi-device parameters, parameters
    outside the block and a block with nothing to train decline (logged through
    ``fusedstep.log_fallback``): the K batches then run as single steps.
    """

    #: on a card, replay one captured graph (False: run the K
    #: iterations eagerly on the card, as on the CPU; for tests that hold
    #: the graph against them)
    _graphed = True

    def __init__(self, block, loss_fn, trainer, k=None):
        self._block = block
        self._loss_fn = loss_fn
        self._trainer = trainer
        self._k = max(1, int(k)) if k is not None \
            else _fusedstep.superstep_k()
        self._plan = None  # None = undecided, False = declined (sticky)
        #: graph replays so far (one per superstep on a card)
        self.replays = 0
        #: the per-iteration overflow flags of the last superstep (a
        #: float device tensor of K entries; zeros without a scaler)
        self.last_overflow = None

    @property
    def k(self):
        return self._k

    def invalidate(self):
        """Drop the plan (a declined verdict too) and its captured graph;
        the next step decides again and captures again."""
        self._plan = None

    # -- plan ------------------------------------------------------------
    def _setup(self):
        if self._plan is not None:
            return self._plan
        tr = self._trainer
        tr._ready()

        def no(reason):
            _fusedstep.log_fallback("superstep", reason)
            self._plan = False
            return False

        if tr._kvstore is not None:
            return no("kvstore-backed gradient aggregation")
        rules = tr._fused_rules()
        if isinstance(rules, str):
            return no(rules)
        name, hyper, rule_init = rules
        items = sorted(self._block.collect_params().items())
        if not items:
            return no("block has no parameters")
        if any(p._data is None or p._deferred_init is not None
               for _, p in items):
            return False  # deferred init: decide later (not sticky)
        if any(p._stype != "default" or p._grad_stype != "default"
               for _, p in items):
            return no("sparse parameters/gradients")
        if any(len(p._data) != 1 for _, p in items):
            return no("multi-device parameters")
        block_names = {p.name for _, p in items}
        if any(p.grad_req != "null" and p.name not in block_names
               for p in tr._params):
            return no("trainer updates params outside the captured block")
        tr_names = {p.name for p in tr._params}
        diff = [p.grad_req != "null" and p.name in tr_names
                for _, p in items]
        if not any(diff):
            return no("no trainable parameters in the captured block")
        handles = [p.data() for _, p in items]
        diff_pos = [i for i, d in enumerate(diff) if d]
        idx = [tr._param2idx[items[i][1].name] for i in diff_pos]
        states = [tr._restore_fused_state(name, items[i][1], ix,
                                          handles[i].data, rule_init)
                  for i, ix in zip(diff_pos, idx)]
        for i, st in zip(diff_pos, states):
            tr._fused_states[items[i][1].name] = st
        self._plan = {
            "items": items, "handles": handles,
            "tensors": [h._t for h in handles], "diff": diff,
            "diff_pos": diff_pos, "idx": idx, "states": states,
            "name": name, "hyper": hyper, "sig": tr._fused_sig(),
            "t_uniform": multi_tensor.uniform_steps(name, states),
            "restores": tr._restores,
            "req_sig": tuple(p.grad_req for _, p in items),
            "static_hyper": {h: v for h, v in hyper.items() if h != "wd"},
            "key": None, "graph": None, "bufs": None}
        return self._plan

    def _plan_ok(self):
        """Build or validate the plan; the plan or False."""
        plan = self._setup()
        if not plan:
            return False
        tr = self._trainer
        o = tr._optimizer
        params = [plan["items"][i][1] for i in plan["diff_pos"]]
        if (tr._fused_sig() != plan["sig"]
                or tuple(p.grad_req for _, p in plan["items"])
                != plan["req_sig"]
                or any(getattr(o, h, None) != v
                       for h, v in plan["static_hyper"].items())
                or any(p._data is None or p.data() is not h
                       or h._t is not t for (_, p), h, t in zip(
                           plan["items"], plan["handles"],
                           plan["tensors"]))
                or any(tr._fused_states.get(p.name) is not st
                       for p, st in zip(params, plan["states"]))):
            self.invalidate()
            plan = self._setup()
        elif plan["restores"] != tr._restores:
            # a checkpoint was written into the states in place: the
            # captured graph stays valid unless their step leaves no
            # longer agree as the plan assumed
            if multi_tensor.uniform_steps(plan["name"], plan["states"]) \
                    != plan["t_uniform"]:
                self.invalidate()
                plan = self._setup()
            else:
                plan["restores"] = tr._restores
        return plan

    # -- one superstep -----------------------------------------------------
    def step(self, xs, ys, batch_size):
        """One superstep over stacked batches (a leading ``[K]`` slot
        axis, ``gluon.data.stack_batches``); returns the K per-iteration
        mean losses as one device NDArray. A fault point of
        ``resilience.chaos`` (site ``superstep``; a ``nan`` fault poisons
        slot 0)."""
        raw_x, raw_y = _stacked_raw(xs), _stacked_raw(ys)
        k = int(raw_x.shape[0])
        poison = False
        if _chaos.ENABLED:
            _chaos.step_point("superstep")
            # the type first: nan_due consumes its one-shot fault
            poison = raw_x.is_floating_point() \
                and _chaos.nan_due("superstep")
        if _elastic.ENABLED:
            _elastic.pause_point("superstep", trainer=self._trainer)
        if self._plan is None and any(
                p._data is None
                for _, p in self._block.collect_params().items()):
            # resolve deferred shapes with one predict pass on one row
            with autograd.predict_mode():
                self._block(NDArray(raw_x[0][:1]))
        plan = self._plan_ok() if _fusedstep.ENABLED else False
        if not plan:
            if poison:
                raw_x = raw_x.clone()
                raw_x[0] = float("nan")
            losses = self.run_single(
                [(NDArray(raw_x[i]), NDArray(raw_y[i])) for i in range(k)],
                batch_size)
            return NDArray(torch.stack([l.data.float() for l in losses]))
        with _ckptmod.step_critical_section():
            t0 = time.perf_counter()
            if _obs.introspect.PROFILING:
                with _obs.introspect.profile_step(k, name="superstep"):
                    out = self._step_fused(plan, raw_x, raw_y, k,
                                           batch_size, poison)
            else:
                with _obs.introspect.site("superstep", raw_x.device):
                    out = self._step_fused(plan, raw_x, raw_y, k,
                                           batch_size, poison)
            if _obs.ENABLED:
                self._record(out, k, t0)
            mgr = getattr(self._trainer, "_ckpt_manager", None)
            if mgr is not None:
                mgr.on_step(k)
        return out

    def _record(self, losses, k, t0):
        """A superstep's telemetry: one dispatch of K iterations, its
        amortized time and the K losses as a lazy series."""
        _obs.record_xla_dispatch("superstep")
        _obs.record_superstep(k, t0, time.perf_counter())
        _obs.record_superstep_series(losses.data)
        if _obs.watchdog.ENABLED:
            _obs.watchdog.poll()
        _obs.federation.poll()

    def _host_values(self, plan, k, batch_size):
        """Advance the update counts by K and sample the schedule once per
        covered count: ``(key, values)``, the capture key and the float64
        values of the hyper buffer (``[K, G]`` learning rates per
        multiplier group, the nonzero weight decays, ``rescale_grad``)."""
        tr = self._trainer
        o = tr._optimizer
        first = None
        for ix in plan["idx"]:
            c = o._index_update_count.get(ix, o.begin_num_update) + k
            o._index_update_count[ix] = c
            o.num_update = max(o.num_update, c)
            first = c - k + 1 if first is None else max(first, c - k + 1)
        o.rescale_grad = tr._scale / batch_size
        if o.lr_scheduler is not None:
            lrs = [o.lr_scheduler(first + i) for i in range(k)]
        else:
            lrs = [o.learning_rate] * k
        params = [plan["items"][i][1] for i in plan["diff_pos"]]
        lr_mults = tuple(dict.fromkeys(p.lr_mult for p in params))
        wd_vals = [o.wd * p.wd_mult for p in params]
        wd_groups = tuple(dict.fromkeys(v for v in wd_vals if v != 0.0))
        lr_index = tuple(lr_mults.index(p.lr_mult) for p in params)
        wd_index = tuple(wd_groups.index(v) if v != 0.0 else -1
                         for v in wd_vals)
        values = [lr * m for lr in lrs for m in lr_mults] \
            + list(wd_groups) + [o.rescale_grad]
        clip = o.clip_gradient
        return (k, len(lr_mults), lr_index, wd_index, clip), values

    def _step_fused(self, plan, raw_x, raw_y, k, batch_size, poison):
        tr = self._trainer
        o = tr._optimizer
        counts = dict(o._index_update_count)
        num_update = o.num_update
        key, values = self._host_values(plan, k, batch_size)
        key = key + ((tuple(raw_x.shape), raw_x.dtype),
                     (tuple(raw_y.shape), raw_y.dtype))
        scaler = getattr(tr, "_amp_loss_scaler", None)
        # the superstep scales its losses itself: a scale_loss block
        # left pending would divide the next trainer.step's gradients
        tr._amp_pending = False
        device = plan["tensors"][plan["diff_pos"][0]].device
        try:
            if plan["key"] != key:
                self._build_buffers(plan, key, raw_x, raw_y, scaler,
                                    device)
            bufs = plan["bufs"]
            self._fill(bufs, values, raw_x, raw_y, scaler, poison, device)
            if device.type == "cuda" and self._graphed:
                if plan["graph"] is None:
                    self._capture(plan)
                plan["graph"].replay()
                self.replays += 1
            else:
                for i in range(k):
                    self._iterate(plan, i)
        except Exception:
            # nothing was applied (or the error is raised as it came):
            # the host's bookkeeping goes back to what ran
            o._index_update_count = counts
            o.num_update = num_update
            raise
        if scaler is not None:
            with torch.no_grad():
                scaler._scale_arr.copy_(bufs["scale"])
                scaler._unskipped_arr.copy_(bufs["unskipped"])
                scaler._overflow_total_arr.copy_(bufs["overflow"])
        self.last_overflow = bufs["flags"].clone()
        return NDArray(bufs["losses"].clone())

    def _build_buffers(self, plan, key, raw_x, raw_y, scaler, device):
        """The static buffers the iterations read, for a new capture key
        (the graph, if any, is captured again)."""
        k, n_lr, lr_index, wd_index, clip = key[:5]
        n_wd = max(wd_index) + 1 if wd_index else 0
        hyper = torch.zeros(k * n_lr + n_wd + 1, dtype=torch.float64,
                            device=device)
        lr = hyper[:k * n_lr].view(k, n_lr)
        lr_views = [[lr[i, g] for g in range(n_lr)] for i in range(k)]
        wd_views = [hyper[k * n_lr + g] for g in range(n_wd)]
        bufs = {
            "hyper": hyper,
            "lrs": [[lr_views[i][g] for g in lr_index] for i in range(k)],
            "wds": [wd_views[g] if g >= 0 else 0.0 for g in wd_index],
            "rescale": hyper[k * n_lr + n_wd],
            "clip": clip,
            "xs": torch.empty(raw_x.shape, dtype=raw_x.dtype, device=device),
            "ys": torch.empty(raw_y.shape, dtype=raw_y.dtype, device=device),
            "losses": torch.zeros(k, dtype=torch.float32, device=device),
            "flags": torch.zeros(k, dtype=torch.float32, device=device),
            "amp": scaler is not None}
        if scaler is not None:
            scaler._on(device)
            bufs.update(scale=torch.ones((), dtype=torch.float32,
                                         device=device),
                        unskipped=torch.zeros((), dtype=torch.int32,
                                              device=device),
                        overflow=torch.zeros((), dtype=torch.int32,
                                             device=device),
                        factor=scaler._factor, window=scaler._window)
        plan["bufs"], plan["key"], plan["graph"] = bufs, key, None

    @staticmethod
    def _fill(bufs, values, raw_x, raw_y, scaler, poison, device):
        """Copy this superstep's values into the static buffers: one
        host-to-device copy of the hyper values (from pinned memory on a
        card, so the host does not wait), device copies of the batches
        and the scaler's counters."""
        host = torch.tensor(values, dtype=torch.float64)
        with torch.no_grad():
            if device.type == "cuda":
                host = host.pin_memory()
            bufs["hyper"].copy_(host, non_blocking=True)
            bufs["xs"].copy_(raw_x, non_blocking=True)
            bufs["ys"].copy_(raw_y, non_blocking=True)
            if poison:
                bufs["xs"][0].fill_(float("nan"))
            if scaler is not None:
                bufs["scale"].copy_(scaler._scale_arr)
                bufs["unskipped"].copy_(scaler._unskipped_arr)
                bufs["overflow"].copy_(scaler._overflow_total_arr)

    def _iterate(self, plan, i):
        """Iteration ``i``: forward, loss and gradients of slot ``i``,
        then the fused update in place."""
        from .block import _bound

        bufs = plan["bufs"]
        diff_h = [plan["handles"][j] for j in plan["diff_pos"]]
        leaves = [h._t.detach().requires_grad_() for h in diff_h]
        with _bound(diff_h, leaves), \
                autograd._RecordingStateScope(True, True):
            loss = self._loss_fn(self._block(NDArray(bufs["xs"][i])),
                                 NDArray(bufs["ys"][i]))
        lt = loss.data
        with torch.enable_grad():
            lsum = lt.sum()
            if bufs["amp"]:
                # the float16 loss meets the fp32 scale, as scale_loss's
                lsum = lsum.float() * bufs["scale"]
            grads = torch.autograd.grad(lsum, leaves, allow_unused=True)
        grads = [g if g is not None else torch.zeros_like(w)
                 for g, w in zip(grads, leaves)]
        amp = None
        if bufs["amp"]:
            amp = {"scale": bufs["scale"], "unskipped": bufs["unskipped"],
                   "overflow": bufs["overflow"], "div": bufs["scale"],
                   "factor": bufs["factor"], "window": bufs["window"]}
        with torch.no_grad():
            bufs["losses"][i].copy_(lt.detach().mean())
            finite = _fused_apply(
                plan["name"], plan["hyper"], [h._t for h in diff_h], grads,
                plan["states"], bufs["lrs"][i], bufs["wds"],
                bufs["rescale"], bufs["clip"],
                self._trainer._optimizer.multi_precision, amp,
                plan["t_uniform"])
            if finite is not None:
                bufs["flags"][i].copy_(torch.logical_not(finite))

    def _capture(self, plan):
        """Warm up one iteration on a side stream (everything it wrote is
        put back, the random state too), then capture the K iterations
        into one CUDA graph."""
        from .block import _hooks_muted, _rng_state, _set_rng_state

        bufs = plan["bufs"]
        live = list(plan["tensors"]) + _state_leaves(plan["states"]) + [
            bufs[n] for n in ("losses", "flags", "scale", "unskipped",
                              "overflow") if n in bufs]
        saved = [t.clone() for t in live]
        rng = _rng_state()
        _capture.warm_up(lambda: self._iterate(plan, 0))
        with torch.no_grad():
            for t, s in zip(live, saved):
                t.copy_(s)
        del saved
        graph = _capture.Graph(torch.cuda.graph_pool_handle(),
                               f"the superstep of {type(self._block)}"
                               f" (k={len(bufs['lrs'])})")
        try:
            with _hooks_muted():
                graph.capture(lambda: [self._iterate(plan, i)
                                       for i in range(len(bufs["lrs"]))])
        finally:
            _set_rng_state(rng)
        plan["graph"] = graph

    # -- single steps ------------------------------------------------------
    def run_single(self, batches, batch_size):
        """``(x, y)`` batches through the plain single-step loop (the
        short tail of an epoch, or the fallback of a declined plan), with
        the superstep's arithmetic; returns per-batch mean-loss
        NDArrays."""
        tr = self._trainer
        scaler = getattr(tr, "_amp_loss_scaler", None)
        losses = []
        for x, y in batches:
            with autograd.record():
                loss = self._loss_fn(self._block(x), y)
                if scaler is not None:
                    from .. import amp as _amp

                    with _amp.scale_loss(loss, tr) as scaled:
                        scaled.backward()
            if scaler is None:
                loss.backward()
            tr.step(batch_size)
            losses.append(NDArray(loss.data.detach().mean()))
        return losses

    @staticmethod
    def _split_xy(batch):
        if isinstance(batch, (list, tuple)) and len(batch) >= 2:
            return batch[0], batch[1]
        if batch.__class__.__name__ == "DataBatch" \
                and hasattr(batch, "data"):
            return batch.data[0], batch.label[0]
        raise MXNetError(
            "Superstep.run expects (x, y) batches or DataBatch; use "
            "step(xs, ys, batch_size) for other structures")

    def run(self, source, batch_size, device=None, mesh=None):
        """One pass over ``source`` (DataLoader, DataIter, iterable, or a
        ``SuperstepRing``): each full group of K is one superstep, a
        short tail runs as single steps. Returns the per-step mean losses
        as floats (one synchronisation, at the end)."""
        from .data.prefetcher import SuperstepRing

        ring = source if isinstance(source, SuperstepRing) \
            else SuperstepRing(source, self._k, device=device, mesh=mesh)
        out = []
        try:
            for group, n in ring:
                # the ring's own k decides: it yields a list only for a
                # short tail (the stacked batch itself may be a list)
                if n == ring.k:
                    x, y = self._split_xy(group)
                    out.append(self.step(x, y, batch_size))
                else:
                    out.extend(self.run_single(
                        [self._split_xy(b) for b in group], batch_size))
        finally:
            ring.close()
        if not out:
            return []
        return torch.cat([l.data.float().reshape(-1) for l in out]) \
            .cpu().tolist()
