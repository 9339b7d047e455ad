"""Ring attention: attention with the sequence split over a mesh axis.

PyTorch counterpart of ``mxnet_tpu/parallel/ring_attention.py``. Each
rank of the axis (``sp`` by default) holds ``(B, H, T/n, D)`` of q, k and
v, the rank at axis position ``i`` the ``i``-th run of positions. The
rank attends its queries to its own kv block, then to each block that
arrives as k and v rotate one place around the ring per step
(:func:`transport.ring_shift`, ``batch_isend_irecv`` on the axis's
group), merging the blocks with the online-softmax combine on their
log-sum-exps; after ``n`` blocks it holds its rows of the whole result.

Causal masks are global positions, as in the reference: the diagonal
block (the rank's own, always first) is causal, a block of an earlier
rank is attended in full, and a block of a later rank is skipped. In the
reference such a block's rows are wholly masked, so it merges with
weight ``exp(-1e30 - m) = 0`` exactly: skipping it computes the same
function and launches nothing for it.

On CUDA each block runs K1 (``ops.flash_attention._cuda_flash_fwd``),
which gives the block's O and fp32 LSE, causal on the diagonal block.
The backward is a ``torch.autograd.Function``: k and v go around the ring
again with a dk/dv accumulator each; every rank runs K2 on each block
with the merged O and LSE (so the kernels' delta = rowsum(dO * O) and
P = exp(S - LSE) are the whole row's) and adds the block's dk and dv into
the accumulators, which reach their own rank after ``n`` hops. Under
``MXTPU_FLASH_BWD=fused`` the blocks run K6 instead, as
``flash_attention._bwd_kernel_for`` picks. CPU tensors run the plain
versions of both kernels per block.
"""

from __future__ import annotations

import torch

from ..base import MXNetError, getenv
from ..ndarray.ndarray import NDArray, apply
from ..ops import flash_attention as _fa
from . import transport


def _local_attn_with_lse(q, k, v, scale, causal):
    """One block: O (q's type) and the fp32 LSE ``(B, H, T)``; K1 on CUDA
    tensors, its plain version on CPU tensors."""
    if q.device.type == "cuda":
        return _fa._cuda_flash_fwd(q, k, v, scale, causal, 0)
    return _fa._torch_flash_fwd(q, k, v, scale, causal, 0)


def _local_attn_bwd(q, k, v, out, lse, g, scale, causal):
    """One block's (dq, dk, dv) from the merged O and LSE: K2 (or K6 where
    ``_bwd_kernel_for`` says so) on CUDA tensors, the plain backward on
    CPU tensors."""
    if q.device.type != "cuda":
        return _fa._torch_flash_bwd(q, k, v, out, lse, g, scale, causal)
    fused = getenv("MXTPU_FLASH_BWD", "split") == "fused"
    bwd = _fa._cuda_flash_bwd_fused \
        if _fa._bwd_kernel_for(q.shape[2], fused) == "fused" \
        else _fa._cuda_flash_bwd
    return bwd(q, k, v, out, lse, g, scale, causal, 0)


def _ring(mesh, axis_name):
    ranks = mesh.axis_ranks(axis_name)
    return ranks, mesh.axis_index(axis_name), mesh.group(axis_name)


def _ring_forward(q, k, v, mesh, axis_name, scale, causal):
    """This rank's rows of the result and their fp32 LSE."""
    ranks, my, group = _ring(mesh, axis_name)
    n = len(ranks)
    out = lse = None
    k_cur, v_cur = k, v
    for r in range(n):
        owner = (my - r) % n
        if not (causal and owner > my):
            o_b, lse_b = _local_attn_with_lse(q, k_cur, v_cur, scale,
                                              causal and owner == my)
            if out is None:  # the diagonal block, always first
                out, lse = o_b.float(), lse_b
            else:
                new = torch.logaddexp(lse, lse_b)
                out = out * torch.exp(lse - new)[..., None] + \
                    o_b.float() * torch.exp(lse_b - new)[..., None]
                lse = new
        if r < n - 1:
            k_cur, v_cur = transport.ring_shift([k_cur, v_cur], ranks, 1,
                                                group)
    return out.to(q.dtype), lse


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mesh, axis_name, scale, causal):
        out, lse = _ring_forward(q, k, v, mesh, axis_name, scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (mesh, axis_name, scale, causal)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        mesh, axis_name, scale, causal = ctx.args
        ranks, my, group = _ring(mesh, axis_name)
        n = len(ranks)
        g = g.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        k_cur, v_cur = k, v
        dk_cur = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_cur = torch.zeros_like(dk_cur)
        for r in range(n):
            owner = (my - r) % n
            if not (causal and owner > my):
                dq_b, dk_b, dv_b = _local_attn_bwd(
                    q, k_cur, v_cur, out, lse, g, scale,
                    causal and owner == my)
                dq += dq_b.float()
                dk_cur += dk_b.float()
                dv_cur += dv_b.float()
            # the accumulators travel with their block: after n hops the
            # block of rank i is home with every rank's dk and dv in it
            moving = [dk_cur, dv_cur] if r == n - 1 else \
                [k_cur, v_cur, dk_cur, dv_cur]
            moved = transport.ring_shift(moving, ranks, 1, group)
            if r < n - 1:
                k_cur, v_cur, dk_cur, dv_cur = moved
            else:
                dk_cur, dv_cur = moved
        return (dq.to(q.dtype), dk_cur.to(k.dtype), dv_cur.to(v.dtype),
                None, None, None, None)


def _check(q, k, v, mesh):
    if mesh is None:
        raise MXNetError("ring_attention needs a mesh (parallel.make_mesh)")
    if q.dim() != 4 or tuple(k.shape) != tuple(q.shape) or \
            tuple(v.shape) != tuple(q.shape):
        raise MXNetError("ring_attention takes (B, H, T, D) query, key and "
                         f"value of one shape; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")


def ring_attention(query, key, value, mesh, axis_name="sp", scale=None,
                   causal=False, global_view=False):
    """Sequence-parallel attention over ``mesh[axis_name]``.

    ``query``/``key``/``value``: this rank's ``(B, H, T/n, D)`` shards (its
    run of positions along the axis, :func:`shard_sequence`); returns its
    ``(B, H, T/n, D)`` rows of the result, differentiable. NDArrays give
    an NDArray (recorded on the tape), tensors a tensor. With
    ``global_view=True`` every rank passes the same global ``(B, H, T, D)``
    arrays and gets the global result, as the reference's call does."""
    if isinstance(query, NDArray):
        return apply(lambda q, k, v: ring_attention(
            q, k, v, mesh, axis_name, scale, causal, global_view),
            query, key, value)
    _check(query, key, value, mesh)
    if scale is None:
        scale = 1.0 / (query.shape[-1] ** 0.5)
    n = transport.axis_size(mesh, axis_name)
    if global_view:
        T = query.shape[2]
        if T % n:
            raise MXNetError(f"seq len {T} must divide ring size {n}")
        local = [shard_sequence(t, mesh, axis_name)
                 for t in (query, key, value)]
        out = _RingAttention.apply(*local, mesh, axis_name, float(scale),
                                   bool(causal))
        return _gather_sequence(out, mesh, axis_name)
    return _RingAttention.apply(query, key, value, mesh, axis_name,
                                float(scale), bool(causal))


def _gather_sequence(local, mesh, axis_name):
    """Every rank's run of positions concatenated along axis 2; the
    gradient of the whole goes back as this rank's run."""
    from ..ops._sharded import _Gather

    n = transport.axis_size(mesh, axis_name)
    if n == 1:
        return local
    return _Gather.apply(local, 2, mesh.group(axis_name), n,
                         mesh.axis_index(axis_name))


def shard_sequence(arr, mesh, axis_name="sp", seq_axis=2):
    """This rank's run of positions of the global array ``arr`` (the same
    on every rank) along ``seq_axis``: the reference's placement of ``arr``
    with that axis sharded over the ring axis. NDArrays give an
    NDArray."""
    if isinstance(arr, NDArray):
        return apply(lambda t: shard_sequence(t, mesh, axis_name, seq_axis),
                     arr)
    n = transport.axis_size(mesh, axis_name)
    T = arr.shape[seq_axis]
    if T % n:
        raise MXNetError(f"seq len {T} must divide ring size {n}")
    i = mesh.axis_index(axis_name)
    return arr.narrow(seq_axis, i * (T // n), T // n)
