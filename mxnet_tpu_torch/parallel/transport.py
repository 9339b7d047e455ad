"""Point-to-point and all-to-all between the ranks of a mesh axis: the
transport of ring attention, the pipelines and expert parallelism.

The JAX package moves these tensors with ``lax.ppermute`` and
``lax.all_to_all`` inside one compiled program. The port is one process
per rank, so each move is a ``torch.distributed`` call on the axis's
process group: :func:`exchange` posts every send and receive of one
rank in one ``batch_isend_irecv`` (every rank posts its half of the same
exchange, in one order, so a ring cannot deadlock), and
:func:`all_to_all` is ``all_to_all_single``.

Gloo's point-to-point calls take host memory only: its send hands the
tensor's pointer to the socket, and a CUDA tensor fails there with
``writev ... Bad address`` (``tools/dist_probe.py p2p`` on the H100;
NCCL refuses two ranks on one card, so the two-rank worlds on the card
are gloo). So for a gloo group :func:`exchange` stages a CUDA tensor
explicitly through pinned host buffers, on every call, and counts the
staged bytes in ``STATS``; NCCL takes device tensors as they are. The
choice is made from the group's backend before the call, never by
catching an error. Gloo's ``all_to_all_single`` takes CUDA tensors (it
copies through the host itself), so :func:`all_to_all` hands them over
as they are.
"""

from __future__ import annotations

import torch

#: what the transport moved since the last :func:`reset_stats`: calls,
#: bytes sent (each rank its own), and the bytes staged through the host
STATS = {"p2p_calls": 0, "p2p_bytes": 0, "a2a_calls": 0, "a2a_bytes": 0,
         "staged_bytes": 0}


def reset_stats():
    for k in STATS:
        STATS[k] = 0


def _nbytes(t):
    return t.numel() * t.element_size()


def staged(group, device):
    """Whether a tensor on ``device`` crosses ``group`` through pinned host
    buffers: a CUDA tensor on a gloo group."""
    import torch.distributed as dist

    return torch.device(device).type == "cuda" and \
        dist.get_backend(group) == "gloo"


def _to_host(t):
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    STATS["staged_bytes"] += _nbytes(t)
    return h


def exchange(sends, recvs, group=None):
    """Send each ``(tensor, peer)`` of ``sends`` and receive, for each
    ``(like, peer)`` of ``recvs``, a tensor of ``like``'s shape, type and
    device from ``peer`` (global ranks). Returns the received tensors in
    ``recvs``' order. A peer that is this rank itself hands the matching
    send over unchanged (a world or an axis of one)."""
    import torch.distributed as dist

    from .mesh import world

    me = world()[0]
    own = [t.detach().clone() for t, peer in sends if peer == me]
    sends = [(t, peer) for t, peer in sends if peer != me]
    ops, outs, landing = [], [], []
    for t, peer in sends:
        t = t.detach().contiguous()
        STATS["p2p_bytes"] += _nbytes(t)
        buf = _to_host(t) if staged(group, t.device) else t
        ops.append(dist.P2POp(dist.isend, buf, peer, group))
    for like, peer in recvs:
        if peer == me:
            outs.append(own.pop(0))
            landing.append(None)
            continue
        host = staged(group, like.device)
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if host else like.device,
                          pin_memory=host)
        ops.append(dist.P2POp(dist.irecv, buf, peer, group))
        outs.append(buf)
        landing.append(like.device if host else None)
    if ops:
        STATS["p2p_calls"] += 1
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for i, dev in enumerate(landing):
        if dev is not None:
            STATS["staged_bytes"] += _nbytes(outs[i])
            outs[i] = outs[i].to(dev)
    return outs


def ring_shift(tensors, ranks, shift=1, group=None):
    """Each tensor of ``tensors`` sent ``shift`` places along the ring of
    ``ranks`` (this rank among them), and the ones ``-shift`` places away
    received in their place."""
    from .mesh import world

    n = len(ranks)
    i = ranks.index(world()[0])
    dst, src = ranks[(i + shift) % n], ranks[(i - shift) % n]
    return exchange([(t, dst) for t in tensors],
                    [(t, src) for t in tensors], group)


def all_to_all(inp, mesh, axis_name):
    """``all_to_all_single`` over ``mesh``'s axis ``axis_name``: ``inp``'s
    leading axis cut into one equal block per rank of the axis, block
    ``j`` sent to its ``j``-th rank, the blocks received stacked in rank
    order. An axis of one rank returns a copy."""
    import torch.distributed as dist

    if axis_size(mesh, axis_name) == 1:
        return inp.clone()
    inp = inp.contiguous()
    STATS["a2a_calls"] += 1
    STATS["a2a_bytes"] += _nbytes(inp)
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=mesh.group(axis_name))
    return out


def axis_size(mesh, axis_name):
    return int(mesh.shape.get(axis_name, 1)) if mesh is not None else 1


def all_reduce(t, mesh, axis_name):
    """``t`` summed in place over ``mesh``'s axis ``axis_name`` (the
    reference's ``lax.psum``); an axis of one rank leaves it."""
    import torch.distributed as dist

    if axis_size(mesh, axis_name) > 1:
        dist.all_reduce(t, group=mesh.group(axis_name))
    return t
