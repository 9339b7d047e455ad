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
in) arrive as Python floats, one per tensor, so nothing is synchronised
and nothing is rebuilt when they change; the step counts that Adam's and
LAMB's bias correction read come from the host as well, and the
correction is computed there in double, as the eager optimizers compute
it. (The JAX package's fused update computes it in float32 on the
device, where ``1 - 0.999`` keeps fewer digits: its first Adam step is
up to 6.4e-6 smaller, relative, than its eager path's and this one's.)
The state tuples keep the rules' layout, ``(m, v, t)`` with an int32
``t`` for Adam and LAMB, and an fp32 master copy as leaf 0 of a
bfloat16/float16 weight's state under ``multi_precision``. Weights and states are updated in place;
gradients are never written.
"""

from __future__ import annotations

import torch

#: the rules this update computes, by optimizer name (AdamW's step rule
#: is Adam's, as in ``parallel/spmd.py``'s ``_RULES``)
RULE_OF = {"sgd": "sgd", "nag": "nag", "adam": "adam", "adamw": "adam",
           "lamb": "lamb"}


def is_low_precision_dtype(dtype) -> bool:
    """The {float16, bfloat16} predicate for master-weight decisions (the
    port's copy of ``amp/policy.py::is_low_precision_dtype``; AMP itself
    is not ported). Takes torch dtypes and their names."""
    return str(dtype).replace("torch.", "") in ("bfloat16", "float16")


def _cast_list(tensors, dtype):
    """Copies of ``tensors`` in ``dtype``, in one ``_foreach_copy_``."""
    out = [torch.empty_like(t, dtype=dtype) for t in tensors]
    if out:
        torch._foreach_copy_(out, tensors)
    return out


def _decayed(gs, ws, wds):
    """``g + wd * w`` per tensor: new tensors, or ``gs`` itself when no
    tensor decays (callers never write into the result)."""
    if not any(wds):
        return gs
    out = torch._foreach_mul(ws, wds)
    torch._foreach_add_(out, gs)
    return out


def _sgd(ws, gs, states, lrs, wds, counts, hyper):
    mom = hyper.get("momentum", 0.0)
    step = torch._foreach_mul(_decayed(gs, ws, wds), lrs)
    if not mom:
        torch._foreach_sub_(ws, step)
        return
    ms = [s[0] for s in states]
    torch._foreach_mul_(ms, mom)
    torch._foreach_sub_(ms, step)
    torch._foreach_add_(ws, ms)


def _nag(ws, gs, states, lrs, wds, counts, hyper):
    mom = hyper.get("momentum", 0.0)
    g = _decayed(gs, ws, wds)
    if not mom:
        torch._foreach_sub_(ws, torch._foreach_mul(g, lrs))
        return
    ms = [s[0] for s in states]
    torch._foreach_mul_(ms, mom)
    torch._foreach_add_(ms, g)
    step = torch._foreach_mul(ms, mom)
    torch._foreach_add_(step, g)
    torch._foreach_mul_(step, lrs)
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


def _adam(ws, gs, states, lrs, wds, counts, hyper):
    b1, b2 = hyper.get("beta1", 0.9), hyper.get("beta2", 0.999)
    eps = hyper.get("epsilon", 1e-8)
    g = _decayed(gs, ws, wds)
    ms, vs = _moments(g, states, hyper)
    denom = torch._foreach_sqrt(vs)
    torch._foreach_add_(denom, eps)
    lr_t = [lr * (1.0 - b2 ** t) ** 0.5 / (1.0 - b1 ** t)
            for lr, t in zip(lrs, counts)]
    # (lr_t * m) / denom, rounded as the per-parameter Adam rounds it
    step = torch._foreach_mul(ms, lr_t)
    torch._foreach_div_(step, denom)
    torch._foreach_sub_(ws, step)


def _lamb(ws, gs, states, lrs, wds, counts, hyper):
    b1, b2 = hyper.get("beta1", 0.9), hyper.get("beta2", 0.999)
    eps = hyper.get("epsilon", 1e-6)
    ms, vs = _moments(gs, states, hyper)
    m_hat = torch._foreach_div(ms, [1.0 - b1 ** t for t in counts])
    denom = torch._foreach_div(vs, [1.0 - b2 ** t for t in counts])
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    r = torch._foreach_div(m_hat, denom)
    if any(wds):
        torch._foreach_add_(r, torch._foreach_mul(ws, wds))
    w_norm = torch.stack(torch._foreach_norm(ws))
    r_norm = torch.stack(torch._foreach_norm(r))
    ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                        torch.ones_like(w_norm))
    torch._foreach_mul_(r, list(ratio.unbind(0)))
    torch._foreach_mul_(r, lrs)
    torch._foreach_sub_(ws, r)


_UPDATES = {"sgd": _sgd, "nag": _nag, "adam": _adam, "lamb": _lamb}


@torch.no_grad()
def update(name, hyper, ws, gs, states, lrs, wds, counts=None,
           multi_precision=False):
    """Update every weight of ``ws`` in place by rule ``name`` (a key of
    :data:`RULE_OF`).

    ``gs`` are the gradients, already rescaled and clipped; ``states``
    the state tuples of the rule's ``init``; ``lrs``/``wds`` one float
    per tensor; ``counts`` the step number each tensor's bias correction
    reads (Adam, LAMB), counted on the host. Tensors are grouped by
    dtype: float32 (and float64) weights update in place; a bfloat16 or
    float16 weight updates its fp32 master (state leaf 0) under
    ``multi_precision``, else an fp32 copy of itself, and takes the
    rounded result."""
    rule = _UPDATES[RULE_OF[name]]
    if counts is None:
        counts = [1] * len(ws)
    groups = {}
    for i, w in enumerate(ws):
        groups.setdefault(w.dtype, []).append(i)
    for dtype, idx in groups.items():
        pick = lambda seq: [seq[i] for i in idx]  # noqa: E731
        w_lo, g_in, st = pick(ws), pick(gs), pick(states)
        if not is_low_precision_dtype(dtype):
            g_in = [g if g.dtype == dtype else g.to(dtype) for g in g_in]
            rule(w_lo, g_in, st, pick(lrs), pick(wds), pick(counts), hyper)
            continue
        g32 = _cast_list(g_in, torch.float32)
        if multi_precision:
            w32 = [s[0] for s in st]
            st = [tuple(s[1:]) for s in st]
        else:
            w32 = _cast_list(w_lo, torch.float32)
        rule(w32, g32, st, pick(lrs), pick(wds), pick(counts), hyper)
        torch._foreach_copy_(w_lo, w32)
