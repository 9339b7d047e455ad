"""Collectives of the tensor-parallel operators on sharded tensors
(``torch.distributed.tensor.DTensor``).

Making a sharded tensor whole goes through ``torch.distributed``'s
``all_gather`` on the mesh dimension's process group, in a differentiable
function whose backward takes this rank's block of the gradient: the
functional collectives that DTensor's own redistribution calls crash in
their gather over gloo with CUDA tensors (the two-rank world that shares
one card, PERF.md), while ``all_gather`` is the collective that the
data-parallel step already runs there. A partial sum is reduced by
DTensor's ``all_reduce``.
"""

from __future__ import annotations

import torch


class _Gather(torch.autograd.Function):
    """Every rank's block along dimension ``dim`` of the ranks of
    ``group``, concatenated; the gradient of the whole goes back as this
    rank's block of it."""

    @staticmethod
    def forward(ctx, local, dim, group, n, index):
        import torch.distributed as dist

        ctx.dim, ctx.n, ctx.index = dim, n, index
        local = local.contiguous()
        parts = [torch.empty_like(local) for _ in range(n)]
        dist.all_gather(parts, local, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        m = g.shape[ctx.dim] // ctx.n
        return g.narrow(ctx.dim, ctx.index * m, m), None, None, None, None


def gather_local(local, mesh, placements):
    """The whole tensor of which ``local`` is this rank's block under
    ``placements`` on ``mesh`` (a plain tensor; differentiable)."""
    from torch.distributed.tensor import Shard

    for md, p in enumerate(placements):
        if isinstance(p, Shard):
            local = _Gather.apply(local, p.dim, mesh.get_group(md),
                                  mesh.size(md), mesh.get_local_rank(md))
    return local


def replicate(t):
    """``t`` replicated on every dimension of its mesh: partial sums
    reduced, shards gathered (:class:`_Gather`). A plain tensor passes
    through."""
    if type(t) is torch.Tensor:
        return t
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not isinstance(t, DTensor):
        return t
    mesh, pl = t.device_mesh, tuple(t.placements)
    if any(isinstance(p, Partial) for p in pl):
        t = t.redistribute(mesh, [Replicate() if isinstance(p, Partial)
                                  else p for p in pl])
        pl = tuple(t.placements)
    if all(isinstance(p, Replicate) for p in pl):
        return t
    whole = gather_local(t.to_local(), mesh, pl)
    return DTensor.from_local(whole, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)
