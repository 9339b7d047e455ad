"""Mixture-of-Experts with expert parallelism.

PyTorch counterpart of ``mxnet_tpu/parallel/moe.py``: top-1 and top-2
gating with capacity (GShard), einsum dispatch and combine, and experts
split over an ``ep`` mesh axis so each rank runs only its own.

- :func:`moe_apply`: tokens the same on every rank; with a mesh each rank
  runs its ``E/ep`` experts on their queues and the expert outputs are
  gathered over ``ep`` (in the reference the compiler moves them).
- :func:`moe_apply_a2a`: tokens split over ``ep``; each rank routes its
  own tokens, an all-to-all carries the per-expert queues to their owners
  (``torch.distributed.all_to_all_single`` on the axis's group, through
  ``transport.all_to_all``), the experts run, and a second all-to-all
  brings the results home. The capacity axis is cut into ``chunks``
  segments, one exchange and expert product each.

The all-to-alls are ``torch.autograd.Function``s whose backward is the
transposed all-to-all (with equal blocks, the same exchange), so the
gradients flow as the reference's do. The einsums stay ``torch.einsum``:
the reference computes them in XLA, outside any Pallas kernel.

Gradients are each rank's: an expert's weights get their whole gradient
on the rank that holds them; in :func:`moe_apply_a2a` the gate (the same
on every rank) gets this rank's tokens' part, which the caller sums over
``ep`` as a data-parallel step sums a replicated parameter's, and the
returned aux loss is the mean over ``ep``, whose gradient comes back as
1/ep to each rank's term (the reference's ``pmean``).
"""

from __future__ import annotations

import time

import torch

from ..base import MXNetError
from . import transport


def _one_hot(idx, n):
    """``jax.nn.one_hot``: float rows, an index outside ``[0, n)`` a zero
    row."""
    return (idx.long()[..., None] ==
            torch.arange(n, device=idx.device)).to(torch.float32)


def top1_routing(gate_logits, num_experts, capacity):
    """Top-1 router with capacity (GShard): ``(dispatch (T, E, C), combine
    (T, E, C), aux_loss)``. Tokens past an expert's capacity drop; on a
    tie the first expert wins (``argmax``'s first index, as in JAX)."""
    probs = torch.softmax(gate_logits.float(), dim=-1)     # (T, E)
    expert = torch.argmax(probs, dim=-1)                   # (T,)
    onehot = _one_hot(expert, num_experts)                 # (T, E)
    # position of each token within its expert's queue (0-based)
    pos = (torch.cumsum(onehot, dim=0) - 1.0) * onehot
    pos_in_expert = pos.sum(dim=-1)                        # (T,)
    keep = pos_in_expert < capacity
    pos_oh = _one_hot(pos_in_expert, capacity)
    dispatch = onehot[:, :, None] * pos_oh[:, None, :] \
        * keep[:, None, None]                              # (T, E, C)
    gate_val = (probs * onehot).sum(dim=-1)                # (T,)
    combine = dispatch * gate_val[:, None, None]
    # load-balance auxiliary loss (Shazeer et al.): E * <fraction, prob>
    frac = onehot.mean(dim=0)
    mean_prob = probs.mean(dim=0)
    aux = num_experts * (frac * mean_prob).sum()
    return dispatch, combine, aux


def top2_routing(gate_logits, num_experts, capacity):
    """Top-2 router with capacity (GShard section 3.2): each token goes to
    its two most probable experts with renormalized combine weights;
    second choices queue behind every first choice of their expert, so
    congestion drops them first. ``(dispatch, combine, aux)``, aux over
    the first choices."""
    probs = torch.softmax(gate_logits.float(), dim=-1)     # (T, E)
    e1 = torch.argmax(probs, dim=-1)
    oh1 = _one_hot(e1, num_experts)
    e2 = torch.argmax(probs * (1.0 - oh1), dim=-1)
    oh2 = _one_hot(e2, num_experts)
    pos1 = ((torch.cumsum(oh1, dim=0) - 1.0) * oh1).sum(dim=-1)
    cnt1 = oh1.sum(dim=0)                                  # (E,)
    pos2 = (((torch.cumsum(oh2, dim=0) - 1.0) + cnt1[None, :])
            * oh2).sum(dim=-1)
    keep1 = pos1 < capacity
    keep2 = pos2 < capacity
    d1 = oh1[:, :, None] * _one_hot(pos1, capacity)[:, None, :] \
        * keep1[:, None, None]
    d2 = oh2[:, :, None] * _one_hot(pos2, capacity)[:, None, :] \
        * keep2[:, None, None]
    dispatch = d1 + d2
    g1 = (probs * oh1).sum(dim=-1)
    g2 = (probs * oh2).sum(dim=-1)
    denom = g1 + g2 + 1e-9
    combine = d1 * (g1 / denom)[:, None, None] \
        + d2 * (g2 / denom)[:, None, None]
    frac = oh1.mean(dim=0)
    mean_prob = probs.mean(dim=0)
    aux = num_experts * (frac * mean_prob).sum()
    return dispatch, combine, aux


_ROUTERS = {"top1": top1_routing, "top2": top2_routing}


def _router_fn(router):
    from .. import fusedstep

    name = router or fusedstep.moe_router()
    if name not in _ROUTERS:
        raise MXNetError(f"unknown MoE router {name!r} "
                         f"(one of {sorted(_ROUTERS)})")
    return name, _ROUTERS[name]


def init_moe_params(generator, d_model, d_hidden, num_experts, device=None):
    """Gate ``(d, E)`` and expert weights ``w1 (E, d, h)``, ``w2 (E, h,
    d)`` from Normal(0, 1) scaled by ``1/sqrt`` of the fan-in, drawn from
    ``generator`` (a ``torch.Generator``, or an int seeding one on
    ``device``, default the current context's device)."""
    if not isinstance(generator, torch.Generator):
        from ..context import current_context, resolve_device

        dev = resolve_device(device if device is not None
                             else current_context())
        generator = torch.Generator(device=dev).manual_seed(int(generator))
    dev = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    return {"gate": normal(d_model, num_experts) / d_model ** 0.5,
            "w1": normal(num_experts, d_model, d_hidden) / d_model ** 0.5,
            "w2": normal(num_experts, d_hidden, d_model) / d_hidden ** 0.5}


def _run_experts(w1, w2, ein):
    h = torch.relu(torch.einsum("ecd,edh->ech", ein, w1))
    return torch.einsum("ech,ehd->ecd", h, w2)


def _local_experts(params, mesh, axis_name):
    """This rank's expert weights: the whole stack sliced to its experts,
    or already its slice (:func:`shard_moe_params`)."""
    E = params["gate"].shape[-1]
    ep = transport.axis_size(mesh, axis_name)
    if E % ep:
        raise MXNetError(f"experts {E} must divide mesh axis {axis_name} "
                         f"({ep})")
    w1, w2 = params["w1"], params["w2"]
    if w1.shape[0] == E and ep > 1:
        i, n = mesh.axis_index(axis_name), E // ep
        w1, w2 = w1[i * n:(i + 1) * n], w2[i * n:(i + 1) * n]
    return E, ep, w1, w2


def moe_apply(params, x, mesh=None, axis_name="ep", capacity_factor=1.5,
              router="top1"):
    """MoE FFN over tokens ``x (T, d)``, the same on every rank. Experts
    split over ``axis_name`` when a mesh is given (each rank runs its own
    and the outputs are gathered over the axis); one device otherwise.
    ``router``: ``top1`` (default) or ``top2``; None reads
    ``MXTPU_MOE_ROUTER``. Returns ``(out (T, d), aux_loss)``."""
    from ..ops._sharded import _Gather

    E = params["gate"].shape[-1]
    T = x.shape[0]
    capacity = int(max(1, (T / E) * capacity_factor))
    gate_logits = x @ params["gate"]
    _, route = _router_fn(router)
    dispatch, combine, aux = route(gate_logits, E, capacity)
    expert_in = torch.einsum("td,tec->ecd", x, dispatch.to(x.dtype))
    if mesh is None or transport.axis_size(mesh, axis_name) == 1:
        _, _, w1, w2 = _local_experts(params, None, axis_name)
        expert_out = _run_experts(w1, w2, expert_in)
    else:
        E, ep, w1, w2 = _local_experts(params, mesh, axis_name)
        i, n = mesh.axis_index(axis_name), E // ep
        local = _run_experts(w1, w2, expert_in[i * n:(i + 1) * n])
        expert_out = _Gather.apply(local, 0, mesh.group(axis_name), ep, i)
    out = torch.einsum("ecd,tec->td", expert_out, combine.to(x.dtype))
    return out, aux


def shard_moe_params(params, mesh, axis_name="ep"):
    """This rank's part of MoE parameters: its ``E/ep`` experts of ``w1``
    and ``w2`` (the reference's ``P(axis_name)``), the whole gate."""
    out = dict(params)
    _, _, out["w1"], out["w2"] = _local_experts(params, mesh, axis_name)
    return out


class _AllToAll(torch.autograd.Function):
    """``transport.all_to_all`` over the axis; the backward is the same
    exchange of the cotangent (with equal blocks it is its own
    transpose)."""

    @staticmethod
    def forward(ctx, x, mesh, axis_name):
        ctx.args = (mesh, axis_name)
        return transport.all_to_all(x, mesh, axis_name)

    @staticmethod
    def backward(ctx, g):
        return transport.all_to_all(g.contiguous(), *ctx.args), None, None


class _AxisMean(torch.autograd.Function):
    """The mean over the axis's ranks (``lax.pmean``); each rank's term
    gets 1/n of the cotangent, as ``pmean``'s transpose gives it."""

    @staticmethod
    def forward(ctx, x, mesh, axis_name):
        ctx.n = transport.axis_size(mesh, axis_name)
        return transport.all_reduce(x.clone(), mesh, axis_name) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def moe_apply_a2a(params, x, mesh, axis_name="ep", capacity_factor=None,
                  router=None, chunks=None, comm="chunked"):
    """MoE FFN with tokens split over ``axis_name`` and the expert
    exchange as explicit all-to-alls.

    ``x``: this rank's ``(T/ep, d)`` tokens; ``params``: the whole gate and
    this rank's experts (:func:`shard_moe_params`; the whole stack is
    sliced). Each rank routes its tokens (capacity is per shard per
    expert), builds its ``(E, C, d)`` queues, and the all-to-all regroups
    them so each rank holds the whole inbound queue of its ``E/ep``
    experts. The capacity axis is cut into ``chunks`` segments (default
    ``MXTPU_MOE_A2A_CHUNKS``), one exchange, expert product and return
    exchange each.

    ``comm``: ``chunked`` (default), ``serial`` (one exchange) or
    ``nocomm`` (the exchange replaced by a local relayout of the same
    shape: the pure-compute baseline of :func:`measure_moe_overlap`).
    Returns ``(out (T/ep, d), aux_loss)``, aux the mean over ``ep``."""
    from .. import fusedstep

    E, ep, w1, w2 = _local_experts(params, mesh, axis_name)
    T_l, D = x.shape
    cf = capacity_factor if capacity_factor is not None \
        else fusedstep.moe_capacity_factor()
    k = chunks if chunks is not None else fusedstep.moe_a2a_chunks()
    if comm != "chunked":
        k = 1
    if comm not in ("chunked", "serial", "nocomm"):
        raise MXNetError(f"unknown MoE comm {comm!r} "
                         "(chunked | serial | nocomm)")
    E_l = E // ep
    cap = int(max(1, (T_l / E) * cf))
    cap = -(-cap // k) * k  # padded to the chunk count
    c = cap // k
    _, route = _router_fn(router)
    logits = x @ params["gate"]
    dispatch, combine, aux = route(logits, E, cap)
    ein = torch.einsum("td,tec->ecd", x, dispatch.to(x.dtype))
    segs = ein.reshape(E, k, c, D)
    outs = []
    for i in range(k):
        seg = segs[:, i].contiguous()                      # (E, c, d)
        if comm != "nocomm":
            seg = _AllToAll.apply(seg, mesh, axis_name)    # by source rank
        inb = seg.reshape(ep, E_l, c, D).transpose(0, 1).reshape(
            E_l, ep * c, D)
        o = _run_experts(w1, w2, inb)                      # (E_l, ep*c, d)
        o = o.reshape(E_l, ep, c, D).transpose(0, 1).contiguous()
        if comm != "nocomm":
            o = _AllToAll.apply(o, mesh, axis_name)
        outs.append(o.reshape(E, c, D))
    expert_out = torch.stack(outs, dim=1).reshape(E, cap, D)
    out = torch.einsum("ecd,tec->td", expert_out, combine.to(x.dtype))
    return out, _AxisMean.apply(aux, mesh, axis_name)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def measure_moe_overlap(mesh, axis_name="ep", d_model=64, d_hidden=128,
                        num_experts=None, tokens=None, steps=10, warmup=3,
                        chunks=None, seed=0, device=None):
    """Time the a2a MoE forward under ``nocomm``/``chunked``/``serial``
    dispatch and give the hidden fraction: exposed(mode) = step(mode) -
    step(nocomm), hidden = 1 - exposed(chunked) / exposed(serial). On the
    card the steps are timed with CUDA events, on the host with its clock;
    the ranks meet at a barrier before each mode. ``tokens`` are global
    (``T/ep`` a rank). Returns ``{"exposed": {mode: seconds},
    "hidden_fraction": float, "step_seconds": {mode: seconds}}``."""
    import torch.distributed as dist

    ep = transport.axis_size(mesh, axis_name)
    E = num_experts or 2 * ep
    T = tokens or 128 * ep
    params = shard_moe_params(
        init_moe_params(seed, d_model, d_hidden, E, device=device), mesh,
        axis_name)
    dev = params["gate"].device
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    x = torch.randn((T, d_model), generator=gen, device=dev)
    i = mesh.axis_index(axis_name)
    x = x[i * (T // ep):(i + 1) * (T // ep)]
    step_s = {}
    with torch.no_grad():
        for mode in ("nocomm", "chunked", "serial"):
            def run():
                return moe_apply_a2a(params, x, mesh, axis_name,
                                     chunks=chunks, comm=mode)[0]

            for _ in range(warmup):
                run()
            if ep > 1 and dist.is_initialized():
                dist.barrier(group=mesh.group(axis_name))
            _sync(dev)
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(steps):
                    run()
                end.record()
                end.synchronize()
                step_s[mode] = start.elapsed_time(end) / 1e3 / steps
            else:
                t0 = time.perf_counter()
                for _ in range(steps):
                    run()
                step_s[mode] = (time.perf_counter() - t0) / steps
    exposed = {m: max(0.0, step_s[m] - step_s["nocomm"])
               for m in ("chunked", "serial")}
    hidden = 1.0 - exposed["chunked"] / exposed["serial"] \
        if exposed["serial"] > 1e-9 else 0.0
    hidden = max(-1.0, min(1.0, hidden))
    from .. import observability as _obs

    _obs.record_moe_probe(exposed, hidden)
    return {"exposed": exposed, "hidden_fraction": hidden,
            "step_seconds": step_s}
