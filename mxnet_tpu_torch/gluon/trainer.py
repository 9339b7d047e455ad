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

Multi-device training is not ported: a ``dist*`` kvstore, a store
object, ``compression_params`` or a parameter on more than one device
raises (ROADMAP A11). The AMP loss scaler inside the update waits for
A7, the grad-norm gauge for A12 and ``Superstep`` for A8.
"""

from __future__ import annotations

import pickle
import re

import numpy as _np
import torch

from .. import fusedstep as _fusedstep
from .. import optimizer as opt
from ..base import MXNetError
from ..context import current_context, resolve_device
from ..ndarray.ndarray import NDArray
from ..optimizer import multi_tensor
from .parameter import Parameter, ParameterDict


def _no_multi_device(what):
    return MXNetError(f"Trainer: {what} needs multi-device training, which "
                      "is not ported yet (ROADMAP A11); this port trains on "
                      "one device")


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


def _flatten_state(obj, key_prefix, sink, counter):
    """Tuples/lists/NDArrays/tensors/None -> a JSON structure descriptor;
    array leaves land in ``sink`` under ``<key_prefix>::<n>`` (the port's
    copy of ``resilience/checkpoint.py::_flatten_state``)."""
    if obj is None:
        return None
    if isinstance(obj, (tuple, list)):
        return [_flatten_state(o, key_prefix, sink, counter) for o in obj]
    if isinstance(obj, (int, float)):
        return {"__v": obj}
    key = f"{key_prefix}::{next(counter)}"
    sink[key] = obj.data if isinstance(obj, NDArray) else obj
    return {"__t": key}


def _unflatten_state(desc, tensors, wrap):
    if desc is None:
        return None
    if isinstance(desc, list):
        return tuple(_unflatten_state(d, tensors, wrap) for d in desc)
    if "__v" in desc:
        return desc["__v"]
    return wrap(tensors[desc["__t"]])


def _natural_key(name):
    """Digit-aware sort key: construction order, not lexicographic
    (``dense9_`` was created before ``dense10_`` but sorts after it)."""
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", name)]


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
        if compression_params:
            raise _no_multi_device("compression_params")
        if kvstore is not None and not isinstance(kvstore, str):
            raise _no_multi_device("a kvstore object")
        if isinstance(kvstore, str) and kvstore.startswith("dist"):
            raise _no_multi_device(f"kvstore={kvstore!r}")
        # one device: "device", "local" and None are all the identity
        self._kvstore_type = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._check_contexts()
        self._init_optimizer(optimizer, optimizer_params or {})
        self._scale = self._optimizer.rescale_grad
        self._fused = None  # fused-update plan (None = undecided)
        self._fused_states = {}  # param name -> optimizer-state tuple

    def _check_contexts(self):
        contexts = None
        for p in self._params:
            if p._data is not None:
                ctx = list(p._data)
            elif p._deferred_init is not None:
                ctx = p._deferred_init[1]
            else:
                continue
            if len(ctx) > 1:
                raise _no_multi_device(f"{p.name} on {len(ctx)} devices")
            if contexts is not None and set(map(str, ctx)) \
                    != set(map(str, contexts)):
                raise MXNetError("All Parameters must be initialized on "
                                 "the same contexts")
            contexts = ctx

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
        """Scale gradients by ``1 / batch_size``, reduce them across
        devices and update every parameter."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads()
        self._update(ignore_stale_grad)

    def allreduce_grads(self):
        """Sum gradients across the devices a parameter lives on; one
        device has nothing to reduce."""
        self._check_contexts()

    def update(self, batch_size, ignore_stale_grad=False):
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
        o = self._optimizer
        return type(o).__name__.lower(), o.multi_precision

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
                "handles": handles, "grads": grads,
                "weights": [h.data for h in handles],
                "grad_tensors": [g.data for g in grads], "states": states,
                "sig": self._fused_sig(),
                "req_sig": tuple(p.grad_req for p in self._params),
                "static_hyper": {k: v for k, v in hyper.items()
                                 if k != "wd"}}

    def _plan_is_stale(self, plan):
        """Pure host compares: the optimizer's kind or constants changed,
        a parameter was frozen or unfrozen, or a parameter's handle,
        tensor or gradient buffer was replaced (re-initialized, cast)."""
        o = self._optimizer
        return (self._fused_sig() != plan["sig"]
                or tuple(p.grad_req for p in self._params) != plan["req_sig"]
                or any(getattr(o, k, None) != v
                       for k, v in plan["static_hyper"].items())
                or any(p._data is None or p.data() is not h
                       or h.data is not w or h.grad is not g
                       or g.data is not gt
                       for p, h, w, g, gt in zip(
                           plan["active"], plan["handles"], plan["weights"],
                           plan["grads"], plan["grad_tensors"])))

    def _grads_for_update(self, grads):
        """The gradients times ``rescale_grad``, clipped, as new tensors
        (the buffers stay as the backward wrote them)."""
        o = self._optimizer
        clip = o.clip_gradient
        if o.rescale_grad != 1.0 or clip is not None:
            grads = torch._foreach_mul(grads, o.rescale_grad)
            if clip is not None:
                torch._foreach_clamp_min_(grads, -clip)
                torch._foreach_clamp_max_(grads, clip)
        return grads

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
        multi_tensor.update(
            plan["name"], plan["hyper"], plan["weights"],
            self._grads_for_update(plan["grad_tensors"]), plan["states"],
            [lr * p.lr_mult for p in plan["active"]],
            [o.wd * p.wd_mult for p in plan["active"]],
            [o._index_update_count[i] for i in plan["idx"]],
            o.multi_precision)
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
            if o.multi_precision and multi_tensor.is_low_precision_dtype(
                    raw.dtype):
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

        if o.multi_precision and multi_tensor.is_low_precision_dtype(
                weight.data.dtype):
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

    def _update(self, ignore_stale_grad=False):
        if self._maybe_fused_update():
            return
        if isinstance(self._fused, dict):
            # the eager loop advances states the plan does not see: a
            # later re-enable must rebuild (and migrate) the plan
            self._invalidate_fused()
        self._update_eager(ignore_stale_grad)

    def _update_eager(self, ignore_stale_grad=False):
        del ignore_stale_grad
        for i, param in enumerate(self._params):
            if param.grad_req == "null" or param._data is None:
                continue
            weight, grad = param.list_data()[0], param.list_grad()[0]
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
