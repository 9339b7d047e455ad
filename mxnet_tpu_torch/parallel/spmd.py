"""The train step of a Gluon block on one device.

PyTorch counterpart of the single-device path of
``mxnet_tpu/parallel/spmd.py`` (``SPMDTrainStep(..., mesh=None)``): the
block's forward, the mean loss, the gradients of the differentiable
parameters and the optimizer rule on each, over the step's own copy of
the parameters, which goes back into the block at ``sync_to_block``. The
JAX package compiles that step into one XLA executable; here it runs
eagerly, with no host synchronisation inside a step or between the steps
of ``run_steps``. The update rules (``_RULES``, ``mp_rule``) are pure
functions of tensors, as in the JAX package, so each returns new tensors;
the step applies them to all parameters at once through the multi-tensor
update it shares with ``gluon.Trainer`` (``optimizer/multi_tensor.py``),
or one parameter at a time under ``MXTPU_FUSED_STEP=0``.
"""

from __future__ import annotations

import torch

from .. import autograd
from .. import fusedstep as _fusedstep
from ..base import MXNetError
from ..gluon.block import _bound
from ..ndarray.ndarray import NDArray, array
from ..optimizer import multi_tensor
from ..optimizer.multi_tensor import is_low_precision_dtype


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


class SPMDTrainStep:
    """Train step for a Gluon block on one device.

    >>> step = SPMDTrainStep(net, loss_fn, "adam", {}, mesh=None)
    >>> loss = step(batch_x, batch_y, lr=1e-4)       # a float
    >>> loss = step.run_steps(batch_x, batch_y, 10)  # on the device

    The loss is the mean over the batch of ``loss_fn(block(x), y)``. The
    step keeps its own copy of the parameters and the optimizer state;
    the Gluon parameters keep their values until :meth:`sync_to_block`.
    Auxiliary state that the forward writes (BatchNorm's running
    statistics) is carried in the step's copy. Dropout draws from torch's
    default generator (``torch.manual_seed``), the port's global stream.

    Only the single-device path is ported: a ``mesh``, a
    ``param_sharding``, ``zero_stage`` 2 or 3, ``overlap``,
    ``compression_params`` or ``grad_dtype`` raises. On one device
    ZeRO-1 (``zero_stage=1``, ``shard_opt_states``) shards nothing, and
    ``donate`` has nothing to donate: the step replaces its tensors.
    """

    def __init__(self, block, loss_fn, optimizer="sgd", optimizer_params=None,
                 mesh=None, batch_axis="dp", param_sharding=None,
                 shard_opt_states=False, grad_dtype=None, donate=True,
                 multi_precision=False, zero_stage=None, overlap=None,
                 compression_params=None):
        del batch_axis, shard_opt_states, donate
        if zero_stage is not None and int(zero_stage) not in (0, 1, 2, 3):
            raise MXNetError(f"zero_stage must be 0-3, got {zero_stage}")
        wanted = {"a mesh": mesh is not None,
                  "param_sharding": bool(param_sharding),
                  f"zero_stage={zero_stage}": zero_stage is not None
                  and int(zero_stage) >= 2,
                  "overlap": overlap is not None,
                  "compression_params": bool(compression_params),
                  "grad_dtype": grad_dtype is not None}
        wanted = [k for k, v in wanted.items() if v]
        if wanted:
            raise MXNetError(
                f"SPMDTrainStep: {', '.join(wanted)} needs the mesh path, "
                "which is not ported yet (ROADMAP A11); this port runs "
                "the single-device step (mesh=None)")
        if optimizer not in _RULES:
            raise MXNetError(
                f"SPMD step supports {sorted(_RULES)}; got {optimizer}. "
                "Use gluon.Trainer for other optimizers.")
        self.block = block
        self.loss_fn = loss_fn
        self.mesh = None
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

    # -- state ------------------------------------------------------------
    def _collect(self):
        items = sorted(self.block.collect_params().items())
        names = [n for n, _ in items]
        handles = [p.data() for _, p in items]
        diff = [p.grad_req != "null" for _, p in items]
        return names, handles, diff

    def init_state(self):
        """Copy the block's parameters into the step and initialise the
        optimizer state of each differentiable one."""
        names, handles, diff = self._collect()
        self._names, self._handles, self._diff = names, handles, diff
        params = [h.data.detach().clone().requires_grad_(d)
                  for h, d in zip(handles, diff)]
        opt_states = [tuple(self._rule_init(p.detach())) if d else ()
                      for p, d in zip(params, diff)]
        self._state = (params, opt_states)
        self._num_update = 0

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
                    [self._num_update] * n, self._multi_precision)
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
        loss, grads = self._loss_and_grads(x, y)
        self._apply(grads, lr)
        return loss

    def _prepare(self, x, y, lr):
        raw_x, raw_y = _raw(x), _raw(y)
        if raw_x.dtype == torch.bfloat16:
            # the JAX step carries lr in a bfloat16 batch's dtype
            lr = float(torch.tensor(lr, dtype=torch.bfloat16))
        return raw_x, raw_y, float(lr)

    def __call__(self, x, y, lr=0.01, sync=True):
        if self._state is None:
            # resolve deferred init with one predict-mode pass on one row,
            # eager even in a hybridized block (nothing worth capturing)
            raw = _raw(x)
            with _bound(), autograd.predict_mode():
                self.block(NDArray(raw[0:1] if raw.shape[0] > 1 else raw))
            self.init_state()
        loss = self._step(*self._prepare(x, y, lr))
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
        args = self._prepare(x, y, lr)
        for _ in range(int(n)):
            self._last_loss = self._step(*args)
        return self._last_loss

    def sync_to_block(self):
        """Write the step's parameters back into the Gluon parameters
        (copies: the step goes on replacing its own tensors)."""
        params, _ = self._state
        for h, p in zip(self._handles, params):
            h._set_data(p)
