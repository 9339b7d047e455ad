"""The multi-tensor optimizer update: every parameter of a step in a
constant number of ``torch._foreach_*`` calls.

PyTorch counterpart of the update the JAX package compiles into one XLA
executable for ``gluon.Trainer``'s fused path (``_apply_fused_update``,
gluon/trainer.py) over the pure rules of ``parallel/spmd.py``
(``_RULES``, ``mp_rule``). It has no kernel of its own: torch's
multi-tensor ops launch one kernel per op for a whole list of tensors on
the card (on the CPU they loop over the tensors). ``gluon.Trainer`` and
``parallel.SPMDTrainStep`` both update through :func:`update`.

The arithmetic is the rules' term for term: coupled weight decay
(``g + wd * w``), Adam's bias correction folded into its learning rate
with epsilon outside the square root, LAMB's trust ratio from the two
norms, computed on the device. Values that change from step to step
(learning rate, weight decay, with the per-parameter multipliers folded
in) arrive one per tensor, as Python floats or as 0-d tensors on the
device (``gluon.Superstep``'s captured graph reads them from buffers), so
nothing is synchronised and nothing is rebuilt when they change. Adam's
and LAMB's bias correction reads each state's step leaf ``t`` on the
device, as the JAX package's fused rule does: a skipped float16 step
(``gluon.Trainer`` under a loss scaler) leaves ``t`` where it was while
the host's update count moves on, and the next step must use ``t``. The
correction is computed in double, as the eager optimizers compute it, and
rounded to float32 once. (The JAX package computes it in float32, where
``1 - 0.999`` keeps fewer digits: its first Adam step is up to 6.4e-6
smaller, relative, than its eager path's and this one's.) The state
tuples keep the rules' layout, ``(m, v, t)`` with an int32 ``t`` for
Adam and LAMB, and an fp32 master copy as leaf 0 of a bfloat16/float16
weight's state under ``multi_precision``. Weights and states are updated
in place; gradients are never written.
"""

from __future__ import annotations

import torch

from ..amp.policy import is_low_precision_dtype

#: the rules this update computes, by optimizer name (AdamW's step rule
#: is Adam's, as in ``parallel/spmd.py``'s ``_RULES``)
RULE_OF = {"sgd": "sgd", "nag": "nag", "adam": "adam", "adamw": "adam",
           "lamb": "lamb"}


def _mul(tensors, scalars, inplace=False):
    """``tensors[i] * scalars[i]``, each scalar a float or a 0-d tensor
    (taken in its tensor's type): one fused call when every scalar is the
    same value (the common case: no per-parameter multiplier)."""
    if not tensors:
        return None if inplace else []
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) > 1:
        out = [None] * len(tensors)
        for dt in dtypes:
            idx = [i for i, t in enumerate(tensors) if t.dtype == dt]
            res = _mul([tensors[i] for i in idx], [scalars[i] for i in idx],
                       inplace)
            for i, r in zip(idx, res or ()):
                out[i] = r
        return None if inplace else out
    op = torch._foreach_mul_ if inplace else torch._foreach_mul
    dt, dev = tensors[0].dtype, tensors[0].device
    conv = {}

    def as_dt(v):
        if not isinstance(v, torch.Tensor):
            return torch.full((), v, dtype=dt, device=dev)
        got = conv.get(id(v))
        if got is None:
            got = conv[id(v)] = v.to(dt)
        return got

    first = scalars[0]
    if all(v is first for v in scalars):
        return op(tensors, as_dt(first)
                  if isinstance(first, torch.Tensor) else first)
    if not any(isinstance(v, torch.Tensor) for v in scalars):
        return op(tensors, list(scalars))
    return op(tensors, [as_dt(v) for v in scalars])


def _nonzero(scalars):
    """Whether any of ``scalars`` may be nonzero (a tensor always may)."""
    return any(isinstance(s, torch.Tensor) or s for s in scalars)


def _bias_lrs(lrs, ts, b1, b2, uniform=False):
    """``lr * sqrt(1 - b2 ** t) / (1 - b1 ** t)`` per tensor, ``t`` the
    state's step leaf on the device, in double; 0-d float32 tensors.
    ``uniform``: every ``t`` holds one value, so one correction serves
    all, and tensors of one learning rate share one scalar (one fused
    multiply downstream)."""
    if uniform:
        t = ts[0].to(torch.float64)
        num, den = torch.sqrt(1.0 - b2 ** t), 1.0 - b1 ** t
        memo, out = {}, []
        for lr in lrs:
            key = id(lr) if isinstance(lr, torch.Tensor) else lr
            got = memo.get(key)
            if got is None:
                scale = lr.to(torch.float64) \
                    if isinstance(lr, torch.Tensor) else lr
                got = memo[key] = ((num * scale) / den).to(torch.float32)
            out.append(got)
        return out
    t = torch.stack(ts).to(torch.float64)
    num = torch.sqrt(1.0 - b2 ** t)
    if all(not isinstance(lr, torch.Tensor) for lr in lrs) \
            and len(set(lrs)) == 1:
        num = num * lrs[0]
    else:
        num = num * torch.stack([
            lr.to(num) if isinstance(lr, torch.Tensor)
            else torch.full((), lr, dtype=torch.float64, device=num.device)
            for lr in lrs])
    return list((num / (1.0 - b1 ** t)).to(torch.float32).unbind(0))


def _cast_list(tensors, dtype):
    """Copies of ``tensors`` in ``dtype``, in one ``_foreach_copy_``."""
    out = [torch.empty_like(t, dtype=dtype) for t in tensors]
    if out:
        torch._foreach_copy_(out, tensors)
    return out


def _decayed(gs, ws, wds):
    """``g + wd * w`` per tensor: new tensors, or ``gs`` itself when no
    tensor decays (callers never write into the result)."""
    if not _nonzero(wds):
        return gs
    out = _mul(ws, wds)
    torch._foreach_add_(out, gs)
    return out


def _sgd(ws, gs, states, lrs, wds, hyper, uniform):
    mom = hyper.get("momentum", 0.0)
    step = _mul(_decayed(gs, ws, wds), lrs)
    if not mom:
        torch._foreach_sub_(ws, step)
        return
    ms = [s[0] for s in states]
    torch._foreach_mul_(ms, mom)
    torch._foreach_sub_(ms, step)
    torch._foreach_add_(ws, ms)


def _nag(ws, gs, states, lrs, wds, hyper, uniform):
    mom = hyper.get("momentum", 0.0)
    g = _decayed(gs, ws, wds)
    if not mom:
        torch._foreach_sub_(ws, _mul(g, lrs))
        return
    ms = [s[0] for s in states]
    torch._foreach_mul_(ms, mom)
    torch._foreach_add_(ms, g)
    step = torch._foreach_mul(ms, mom)
    torch._foreach_add_(step, g)
    _mul(step, lrs, inplace=True)
    torch._foreach_sub_(ws, step)


def _moments(gs, states, hyper):
    """Adam's and LAMB's moment updates and step leaves, in place;
    returns the lists of m and v."""
    b1, b2 = hyper.get("beta1", 0.9), hyper.get("beta2", 0.999)
    ms = [s[0] for s in states]
    vs = [s[1] for s in states]
    torch._foreach_mul_(ms, b1)
    torch._foreach_add_(ms, gs, alpha=1 - b1)
    torch._foreach_mul_(vs, b2)
    torch._foreach_addcmul_(vs, gs, gs, value=1 - b2)
    torch._foreach_add_([s[2] for s in states], 1)
    return ms, vs


def _adam(ws, gs, states, lrs, wds, hyper, uniform):
    b1, b2 = hyper.get("beta1", 0.9), hyper.get("beta2", 0.999)
    eps = hyper.get("epsilon", 1e-8)
    g = _decayed(gs, ws, wds)
    ms, vs = _moments(g, states, hyper)
    denom = torch._foreach_sqrt(vs)
    torch._foreach_add_(denom, eps)
    lr_t = _bias_lrs(lrs, [s[2] for s in states], b1, b2, uniform)
    # (lr_t * m) / denom, rounded as the per-parameter Adam rounds it
    step = _mul(ms, lr_t)
    torch._foreach_div_(step, denom)
    torch._foreach_sub_(ws, step)


def _lamb(ws, gs, states, lrs, wds, hyper, uniform):
    b1, b2 = hyper.get("beta1", 0.9), hyper.get("beta2", 0.999)
    eps = hyper.get("epsilon", 1e-6)
    ms, vs = _moments(gs, states, hyper)
    if uniform:
        t = states[0][2].to(torch.float64)
        m_hat = torch._foreach_div(ms, (1.0 - b1 ** t).to(torch.float32))
        denom = torch._foreach_div(vs, (1.0 - b2 ** t).to(torch.float32))
    else:
        t = torch.stack([s[2] for s in states]).to(torch.float64)
        m_hat = torch._foreach_div(
            ms, list((1.0 - b1 ** t).to(torch.float32).unbind(0)))
        denom = torch._foreach_div(
            vs, list((1.0 - b2 ** t).to(torch.float32).unbind(0)))
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    r = torch._foreach_div(m_hat, denom)
    if _nonzero(wds):
        torch._foreach_add_(r, _mul(ws, wds))
    w_norm = torch.stack(torch._foreach_norm(ws))
    r_norm = torch.stack(torch._foreach_norm(r))
    ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                        torch.ones_like(w_norm))
    torch._foreach_mul_(r, list(ratio.unbind(0)))
    _mul(r, lrs, inplace=True)
    torch._foreach_sub_(ws, r)


_UPDATES = {"sgd": _sgd, "nag": _nag, "adam": _adam, "lamb": _lamb}


@torch.no_grad()
def update(name, hyper, ws, gs, states, lrs, wds, multi_precision=False,
           t_uniform=False):
    """Update every weight of ``ws`` in place by rule ``name`` (a key of
    :data:`RULE_OF`).

    ``gs`` are the gradients, already rescaled and clipped; ``states``
    the state tuples of the rule's ``init``; ``lrs``/``wds`` one float
    or 0-d tensor per tensor; ``t_uniform``: every state's step leaf
    (Adam, LAMB) holds one value (see :func:`uniform_steps`). Tensors are
    grouped by
    dtype: float32 (and float64) weights update in place; a bfloat16 or
    float16 weight updates its fp32 master (state leaf 0) under
    ``multi_precision``, else an fp32 copy of itself, and takes the
    rounded result."""
    rule = _UPDATES[RULE_OF[name]]
    groups = {}
    for i, w in enumerate(ws):
        groups.setdefault(w.dtype, []).append(i)
    for dtype, idx in groups.items():
        pick = lambda seq: [seq[i] for i in idx]  # noqa: E731
        w_lo, g_in, st = pick(ws), pick(gs), pick(states)
        if not is_low_precision_dtype(dtype):
            g_in = [g if g.dtype == dtype else g.to(dtype) for g in g_in]
            rule(w_lo, g_in, st, pick(lrs), pick(wds), hyper, t_uniform)
            continue
        g32 = _cast_list(g_in, torch.float32)
        if multi_precision:
            w32 = [s[0] for s in st]
            st = [tuple(s[1:]) for s in st]
        else:
            w32 = _cast_list(w_lo, torch.float32)
        rule(w32, g32, st, pick(lrs), pick(wds), hyper, t_uniform)
        torch._foreach_copy_(w_lo, w32)


def uniform_steps(name, states):
    """Whether every state's step leaf holds one value (always, for a
    rule without one): one synchronisation, paid where a plan is built.
    The states of one plan step together (or all skip), so the answer
    holds until a checkpoint is restored into them in place, after which
    ``Superstep`` asks again."""
    if RULE_OF.get(name) not in ("adam", "lamb") or len(states) < 2:
        return True
    ts = torch.stack([st[-1] for st in states])
    return bool((ts == ts[0]).all())
