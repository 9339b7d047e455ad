"""Attention operators: flash attention (training) and paged decode
attention (serving).

PyTorch counterpart of ``mxnet_tpu/ops/flash_attention.py``. On CUDA
tensors each operator launches a hand-written Hopper kernel from
``csrc/`` (float32, bfloat16 or float16 storage); on CPU tensors it runs
the plain PyTorch version of the same function beside it. A CUDA tensor
takes the plain version only where the JAX package's routing does
(``_use_pallas``): head_dim > 128, chosen by shape before any launch and
counted in ``_kernels.LAUNCHES["flash_plain_fwd"]``,
``["flash_plain_bwd"]`` and ``["paged_decode_plain"]``. A kernel that
fails to build or launch raises; nothing falls back.

- :func:`flash_attention` is a ``torch.autograd.Function``: its forward
  launches ``csrc/flash_fwd.cu`` (the port of the TPU kernel
  ``_flash_fwd_kernel``) and saves O and the fp32 log-sum-exp; its
  backward launches, by default, the two kernels of ``csrc/flash_bwd.cu``
  (the ports of ``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``)
  and, with ``MXTPU_FLASH_BWD=fused`` up to ``_FUSED_BWD_MAX_T`` query
  rows, the one kernel of ``csrc/flash_bwd_fused.cu`` (the port of
  ``_flash_bwd_kernel``); :func:`_bwd_kernel_for` is the rule. The plain
  versions are :func:`_torch_flash_fwd` (the port of ``_jnp_flash_fwd``)
  and :func:`_torch_flash_bwd` (the port of the blockwise scan backward
  in ``_flash_bwd_rule``, the plain version of both backwards).
- :func:`paged_decode_attention` launches the two kernels of
  ``csrc/paged_decode.cu`` (the port of ``_paged_decode_kernel``, split
  across the context, then combined in a fixed order); its plain version is
  :func:`_torch_paged_decode` (the port of ``_jnp_paged_decode``).

Each kernel's bound on an H100 SXM, and what its design does about it,
is in the note at the top of its CUDA source. The flash kernels (K1, K2,
K6) multiply on the tensor cores in fp32 accuracy (3xTF32,
``csrc/flash_mma.cuh``); :func:`_kernel_resources` reports their
registers, shared memory and blocks per SM.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..autograd import recompute_grads
from ..base import getenv
from . import _kernels
from .registry import register

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the kernels' largest head dim; past it the JAX package runs its jnp path
# (``_use_pallas``), and so does the port its plain versions
_MAX_HEAD_DIM = 128
# query rows (and key rows) of a flash kernel's tile (``kBQ``, ``kBK``)
_FLASH_TILE = 64


def _torch_paged_decode(q, k_pool, v_pool, tables, lens, scale):
    """Plain version: gather each slot's context through the same table
    indirection, then a masked fp32 softmax. Fully masked rows (empty or
    inactive slots) produce zeros."""
    B, H, D = q.shape
    _, bs, KVH, _ = k_pool.shape
    mb = tables.shape[1]
    S = mb * bs
    idx = tables.long()
    k = k_pool[idx].reshape(B, S, KVH, D).float()
    v = v_pool[idx].reshape(B, S, KVH, D).float()
    # GQA: query heads h*G .. h*G+G-1 share kv head h (jnp.repeat order)
    qg = q.float().reshape(B, KVH, H // KVH, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k) * scale
    mask = torch.arange(S, device=q.device)[None, :] < lens[:, None]
    s = torch.where(mask[:, None, None, :], s, _NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bkgs,bskd->bkgd", p, v).reshape(B, H, D)
    out = torch.where((lens > 0)[:, None, None], out, 0.0)
    return out.to(q.dtype)


def _lib():
    lib = _kernels.library("paged_decode")
    if not getattr(lib, "_mxtpu_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.mxtpu_paged_decode.restype = i32
        lib.mxtpu_paged_decode.argtypes = (
            [i32] + [ptr] * 7 + [i32] * 7 + [ctypes.c_float, ptr])
        lib.mxtpu_paged_decode_smem_bytes.restype = ctypes.c_size_t
        lib.mxtpu_paged_decode_smem_bytes.argtypes = [i32, i32]
        lib._mxtpu_typed = True
    return lib


# query rows one block of K3's split kernel takes (``kBlockRows``)
_PAGED_BLOCK_ROWS = 16


def _paged_decode_splits(B, H, KVH, max_blocks, sm_count):
    """How many ranges K3 splits each context into: enough blocks for two
    on every SM, at most one per table entry. It depends on shapes and the
    card alone, never on the context lengths, which live on the device."""
    per_split = B * KVH * -(-(H // KVH) // _PAGED_BLOCK_ROWS)
    return max(1, min(max_blocks, -(-2 * sm_count // per_split)))


def _int32(t):
    return t if t.dtype == torch.int32 and t.is_contiguous() \
        else t.to(torch.int32).contiguous()


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _cuda_paged_decode(q, k_pool, v_pool, tables, lens, scale):
    """Validate, then launch K3's split kernel and its combine kernel on
    the current stream; past ``_MAX_HEAD_DIM`` run the plain version on
    the card instead."""
    B, H, D = q.shape
    nb, bs, KVH, Dk = k_pool.shape
    if q.dtype not in _DTYPE_CODES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError("paged decode takes float32, bfloat16 or float16, "
                        "the same for q and both pools; got "
                        f"{q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    if Dk != D or tuple(v_pool.shape) != tuple(k_pool.shape):
        raise ValueError(f"pool shapes {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not match q {tuple(q.shape)}")
    if tables.dim() != 2 or tables.shape[0] != B or tuple(lens.shape) != (B,):
        raise ValueError(f"tables {tuple(tables.shape)} / lens "
                         f"{tuple(lens.shape)} do not match batch {B}")
    dev = q.device
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", tables), ("context_lens", lens)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, query on {dev}")
    if not (q.is_contiguous() and k_pool.is_contiguous()
            and v_pool.is_contiguous()):
        raise ValueError("paged decode kernel needs contiguous q and pools")
    tables, lens = _int32(tables), _int32(lens)
    if D > _MAX_HEAD_DIM:
        _kernels.LAUNCHES["paged_decode_plain"] += 1
        return _torch_paged_decode(q, k_pool, v_pool, tables, lens, scale)
    out = torch.empty_like(q)
    if B == 0:
        return out
    mb = tables.shape[1]
    nsplit = _paged_decode_splits(B, H, KVH, mb, _sm_count(dev.index))
    # per (sequence, query head, split): acc[D], then (m, l)
    ws = torch.empty(B * H * nsplit * (D + 2), dtype=torch.float32,
                     device=dev)
    lib = _lib()
    args = (_DTYPE_CODES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), tables.data_ptr(), lens.data_ptr(),
            ws.data_ptr(), out.data_ptr(), B, H, KVH, D, bs, mb, nsplit,
            float(scale), torch.cuda.current_stream(dev).cuda_stream)
    # the launch goes to the current device: make it q's (a decode step
    # calls this once a layer, so the common case skips the switch)
    if dev.index == torch.cuda.current_device():
        err = lib.mxtpu_paged_decode(*args)
    else:
        with torch.cuda.device(dev):
            err = lib.mxtpu_paged_decode(*args)
    _kernels.check(lib, err, "paged_decode launch")
    # one C call launches both kernels
    _kernels.LAUNCHES["paged_decode"] += 1
    _kernels.LAUNCHES["paged_decode_combine"] += 1
    return out


def paged_decode_attention(query, k_pool, v_pool, block_tables,
                           context_lens, scale=None):
    """Decode-specialized attention: ``query`` is one new token per
    sequence, ``(B, H, D)``; K/V live in ONE layer's slice of the paged
    pool, ``(num_blocks, block_size, KVH, D)``; ``block_tables``
    ``(B, max_blocks)`` names each sequence's pool blocks in logical
    order and ``context_lens`` ``(B,)`` is how many positions are valid
    (rows past it — padding and the null block — are masked). Sequences
    with ``context_lens == 0`` return zeros.

    CUDA tensors go through the Hopper kernels, a split kernel and a
    combine kernel (counted in ``_kernels.LAUNCHES["paged_decode"]`` and
    ``["paged_decode_combine"]``), or past head_dim 128 through
    the plain version on the card (``["paged_decode_plain"]``), as the JAX
    package routes them; CPU tensors through the plain version."""
    if scale is None:
        scale = 1.0 / (query.shape[-1] ** 0.5)
    if query.shape[1] % k_pool.shape[2] != 0:
        raise ValueError("query heads must be a multiple of kv heads; got "
                         f"{query.shape[1]} vs {k_pool.shape[2]}")
    if query.device.type == "cuda":
        return _cuda_paged_decode(query, k_pool, v_pool, block_tables,
                                  context_lens, float(scale))
    if query.device.type != "cpu":
        raise ValueError(f"paged decode runs on cuda or cpu, not "
                         f"{query.device}")
    return _torch_paged_decode(query, k_pool, v_pool, block_tables,
                               context_lens.to(torch.int32), float(scale))


# ---------------------------------------------------------------------------
# flash attention: plain versions
# ---------------------------------------------------------------------------


def _repeat_kv(q, k, v):
    """Expand grouped kv heads to the query head count (query heads
    h*G .. h*G+G-1 share kv head h, ``jnp.repeat`` order)."""
    if k.shape[1] != q.shape[1]:
        rep = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    return k, v


def _visible(T, S, cols, window, device):
    """(T, len(cols)) bool: which key columns each query row sees under
    the causal mask aligned bottom-right (``tril(k=S-T)``) and, for
    ``window > 0``, the band of the last ``window`` positions."""
    rows = torch.arange(T, device=device)[:, None]
    rel = rows + (S - T) - cols[None, :]
    ok = rel >= 0
    if window > 0:
        ok = ok & (rel < window)
    return ok


def _torch_flash_fwd(q, k, v, scale, causal, window=0):
    """Plain version of the forward: the full fp32 score matrix, masked
    scores -1e30, then O (in the input type) and the fp32 LSE
    ``(B, H, T)``. Grouped kv heads are repeated."""
    T, S = q.shape[2], k.shape[2]
    k, v = _repeat_kv(q, k, v)
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) * scale
    if causal or window > 0:
        ok = _visible(T, S, torch.arange(S, device=q.device), window,
                      q.device)
        s = torch.where(ok, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhts,bhsd->bhtd", p / l, v.float())
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def _torch_flash_bwd(q, k, v, out, lse, g, scale, causal, window=0,
                     block_size=1024):
    """Plain version of the backward, of the split kernels (K2) and of the
    fused one (K6) alike: recompute p from the LSE one block of
    ``block_size`` key rows at a time, all in fp32, accumulate dq over the
    blocks; grouped kv heads are repeated and their dk/dv summed over each
    group."""
    B, H, T, D = q.shape
    KVH, S = k.shape[1], k.shape[2]
    kf, vf = _repeat_kv(q, k, v)
    g32, q32 = g.float(), q.float()
    delta = (g32 * out.float()).sum(dim=-1)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for j0 in range(0, S, block_size):
        ks = kf[:, :, j0:j0 + block_size].float()
        vs = vf[:, :, j0:j0 + block_size].float()
        s = torch.einsum("bhtd,bhsd->bhts", q32, ks) * scale
        if causal or window > 0:
            cols = torch.arange(j0, j0 + ks.shape[2], device=q.device)
            s = torch.where(_visible(T, S, cols, window, q.device), s,
                            _NEG_INF)
        p = torch.exp(s - lse[..., None])
        dvs.append(torch.einsum("bhts,bhtd->bhsd", p, g32))
        dp = torch.einsum("bhtd,bhsd->bhts", g32, vs)
        ds = p * (dp - delta[..., None]) * scale
        dq += torch.einsum("bhts,bhsd->bhtd", ds, ks)
        dks.append(torch.einsum("bhts,bhtd->bhsd", ds, q32))
    dk, dv = torch.cat(dks, dim=2), torch.cat(dvs, dim=2)
    if H != KVH:
        dk = dk.reshape(B, KVH, H // KVH, S, D).sum(dim=2)
        dv = dv.reshape(B, KVH, H // KVH, S, D).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# flash attention: the Hopper kernels
# ---------------------------------------------------------------------------


def _flash_lib(stem):
    lib = _kernels.library(stem)
    if getattr(lib, "_mxtpu_typed", False):
        return lib
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # B, H, KVH, T, S, D, causal, window; scale; strides; stream
    dims = [i32] * 8 + [ctypes.c_float, ptr, ptr]
    if stem == "flash_fwd":
        fns = {"mxtpu_flash_fwd": [i32] + [ptr] * 5 + dims,
               "mxtpu_flash_fwd_resources": [i32] * 2 + [ptr]}
    elif stem == "flash_bwd_fused":
        fns = {"mxtpu_flash_bwd_fused": [i32] + [ptr] * 10 + dims,
               "mxtpu_flash_bwd_resources": [i32] * 3 + [ptr]}
    else:
        fns = {"mxtpu_flash_bwd_dq": [i32] + [ptr] * 8 + dims,
               "mxtpu_flash_bwd_dkv": [i32] + [ptr] * 8 + dims,
               "mxtpu_flash_bwd_resources": [i32] * 3 + [ptr]}
    for name, argtypes in fns.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    lib._mxtpu_typed = True
    return lib


def _kernel_resources(kernel, dtype, head_dim):
    """What the runtime reports for a flash kernel (``"fwd"``, ``"dq"``,
    ``"dkv"`` or ``"fused"``) at a storage type and a head-dim bucket (32,
    64 or 128): registers per thread, static and dynamic shared bytes per
    block, blocks per SM, local (spill) bytes per thread and threads per
    block."""
    out = (ctypes.c_int * 6)()
    if kernel == "fwd":
        lib = _flash_lib("flash_fwd")
        err = lib.mxtpu_flash_fwd_resources(_DTYPE_CODES[dtype], head_dim,
                                            out)
    else:
        lib = _flash_lib("flash_bwd_fused" if kernel == "fused"
                         else "flash_bwd")
        err = lib.mxtpu_flash_bwd_resources(
            {"dq": 0, "dkv": 1, "fused": 0}[kernel], _DTYPE_CODES[dtype],
            head_dim, out)
    _kernels.check(lib, err, f"flash_{kernel} resources")
    return dict(zip(("regs", "static_smem", "dynamic_smem", "blocks_per_sm",
                     "local_bytes", "threads"), out))


def _check_operands(q, k, v, g=None):
    """Refuse what neither route takes: q, k, v (and dO) in mixed or
    unsupported types, shapes that do not match, tensors on other
    devices."""
    B, H, T, D = q.shape
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype or (g is not None and g.dtype != q.dtype):
        raise TypeError("flash attention takes float32, bfloat16 or "
                        "float16, the same for q, k, v (and dO); got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != D \
            or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    for name, t in (("key", k), ("value", v), ("grad", g)):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, query on {q.device}")


def _kernel_operands(q, k, v, g=None):
    """Check what the kernels take and return the tensors (last dim made
    contiguous) with their (batch, head, row) element strides, 12 int64s
    (dO's three are zeros when there is no dO)."""
    _check_operands(q, k, v, g)
    if q.shape[-1] > _MAX_HEAD_DIM:
        raise ValueError(f"flash attention kernels take head_dim <= "
                         f"{_MAX_HEAD_DIM}; got {q.shape[-1]}")
    ts = [t if t.stride(-1) == 1 else t.contiguous()
          for t in (q, k, v, g if g is not None else q)]
    strides = [s for t in ts for s in t.stride()[:3]]
    if g is None:
        strides[9:] = [0, 0, 0]
    return ts, (ctypes.c_longlong * 12)(*strides)


def _cuda_flash_fwd(q, k, v, scale, causal, window):
    """Launch K1 on the current stream: O (input type) and LSE (fp32)."""
    (q, k, v, _), strides = _kernel_operands(q, k, v)
    B, H, T, D = q.shape
    KVH, S = k.shape[1], k.shape[2]
    out = torch.empty((B, H, T, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    lib = _flash_lib("flash_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mxtpu_flash_fwd(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), B, H, KVH, T, S, D, int(causal),
            int(window), float(scale), strides, stream)
    _kernels.check(lib, err, "flash_fwd launch")
    _kernels.LAUNCHES["flash_fwd"] += 1
    return out, lse


def _bwd_operands(q, k, v, out, lse, g):
    """Checked backward operands (O contiguous in q's type and shape) and
    the strides."""
    (q, k, v, g), strides = _kernel_operands(q, k, v, g)
    if out.dtype != q.dtype or tuple(out.shape) != tuple(q.shape) \
            or out.device != q.device:
        raise ValueError(f"O {out.dtype} {tuple(out.shape)} on "
                         f"{out.device} does not match q")
    return q, k, v, g, out.contiguous(), lse.contiguous(), strides


def _launch_flash_bwd(kernel, q, k, v, g, out, lse, delta, strides, outs,
                      scale, causal, window):
    """Launch one kernel of K2 on the current stream: ``"dq"`` writes
    ``outs = (dq,)`` and ``delta`` = rowsum(dO * O) (fp32, (B, H, T)) from
    O; ``"dkv"`` reads that ``delta`` and writes ``outs = (dk, dv)``."""
    B, H, T, D = q.shape
    KVH, S = k.shape[1], k.shape[2]
    lib = _flash_lib("flash_bwd")
    if kernel == "dq":
        fn, ptrs = lib.mxtpu_flash_bwd_dq, (out.data_ptr(), lse.data_ptr())
    else:
        fn, ptrs = lib.mxtpu_flash_bwd_dkv, (lse.data_ptr(),)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), g.data_ptr(), *ptrs, delta.data_ptr(),
                 *(o.data_ptr() for o in outs), B, H, KVH, T, S, D,
                 int(causal), int(window), float(scale), strides, stream)
    _kernels.check(lib, err, f"flash_bwd_{kernel} launch")
    _kernels.LAUNCHES[f"flash_bwd_{kernel}"] += 1


def _cuda_flash_bwd(q, k, v, out, lse, g, scale, causal, window):
    """Launch K2 on the current stream: the dq kernel (which also forms
    delta), then the dk/dv kernel."""
    q, k, v, g, out, lse, strides = _bwd_operands(q, k, v, out, lse, g)
    B, H, T, D = q.shape
    KVH, S = k.shape[1], k.shape[2]
    dq = torch.empty((B, H, T, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, KVH, S, D), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    args = (q, k, v, g, out, lse, delta, strides)
    _launch_flash_bwd("dq", *args, (dq,), scale, causal, window)
    _launch_flash_bwd("dkv", *args, (dk, dv), scale, causal, window)
    return dq, dk, dv


def _cuda_flash_bwd_fused(q, k, v, out, lse, g, scale, causal, window):
    """Launch K6 on the current stream: one kernel emits dk and dv in the
    storage type and adds dq into a zeroed fp32 workspace in ascending
    key-tile order (a zeroed int32 turn per (batch * head, query tile)
    keeps the order, so dq repeats bit for bit), rounded afterwards for a
    16-bit type. delta = rowsum(dO * O) in fp32 is one torch expression
    beforehand, as in the JAX package."""
    q, k, v, g, out, lse, strides = _bwd_operands(q, k, v, out, lse, g)
    B, H, T, D = q.shape
    KVH, S = k.shape[1], k.shape[2]
    dq = torch.zeros((B, H, T, D), dtype=torch.float32, device=q.device)
    dk = torch.empty((B, KVH, S, D), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.to(q.dtype), dk.zero_(), dv.zero_()
    delta = (g.float() * out.float()).sum(dim=-1)
    turn = torch.zeros((B * H, -(-T // _FLASH_TILE)), dtype=torch.int32,
                       device=q.device)
    lib = _flash_lib("flash_bwd_fused")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mxtpu_flash_bwd_fused(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            turn.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, KVH, T, S,
            D, int(causal),
            int(window), float(scale), strides, stream)
    _kernels.check(lib, err, "flash_bwd_fused launch")
    _kernels.LAUNCHES["flash_bwd_fused"] += 1
    return dq.to(q.dtype), dk, dv


def _plain_flash_fwd_on_cuda(q, k, v, scale, causal, window):
    """The plain forward on CUDA tensors, where the JAX package runs its
    jnp path (head_dim > 128); counted as ``flash_plain_fwd``."""
    _check_operands(q, k, v)
    _kernels.LAUNCHES["flash_plain_fwd"] += 1
    return _torch_flash_fwd(q, k, v, scale, causal, window)


def _plain_flash_bwd_on_cuda(q, k, v, out, lse, g, scale, causal, window):
    """The plain backward on CUDA tensors (head_dim > 128); counted as
    ``flash_plain_bwd``."""
    _check_operands(q, k, v, g)
    _kernels.LAUNCHES["flash_plain_bwd"] += 1
    return _torch_flash_bwd(q, k, v, out, lse, g, scale, causal, window)


# The JAX package's cap on its fused backward (``_PALLAS_BWD_MAX_T``), kept
# so that both packages send the same shapes to the same kernel. The TPU
# kernel needs it for its full-T dq scratch in VMEM; K6 here adds dq into
# a workspace in device memory and could run past it, which is left for
# later work.
_FUSED_BWD_MAX_T = 8192


def _bwd_kernel_for(T, fused):
    """``"fused"`` (K6) or ``"split"`` (K2) for a backward of ``T`` query
    rows, ``fused`` being ``MXTPU_FLASH_BWD == "fused"``. The JAX
    package's routing (``_flash_bwd_rule``) comes down to this rule
    whatever ``native_gqa`` says: over its cap, native GQA repeats kv and
    the repeated grad runs the fused kernel while ``T`` itself fits."""
    return "fused" if fused and T <= _FUSED_BWD_MAX_T else "split"


class _FlashAttention(torch.autograd.Function):
    """Forward K1 on CUDA tensors; backward K2, or K6 where
    :func:`_bwd_kernel_for` says so; the plain versions on CPU tensors
    and, by shape, on CUDA tensors past ``_MAX_HEAD_DIM``. Saves q, k, v,
    O and the fp32 LSE."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window):
        if q.device.type == "cuda":
            fwd = _cuda_flash_fwd if q.shape[-1] <= _MAX_HEAD_DIM \
                else _plain_flash_fwd_on_cuda
            out, lse = fwd(q, k, v, scale, causal, window)
        elif q.device.type == "cpu":
            out, lse = _torch_flash_fwd(q, k, v, scale, causal, window)
        else:
            raise ValueError(f"flash attention runs on cuda or cpu, not "
                             f"{q.device}")
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, causal, window)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        if torch.is_grad_enabled():
            # create_graph: the plain forward recomputed and differentiated,
            # so the gradient is differentiable again (no kernel runs)
            return (*recompute_grads(
                lambda q, k, v: _torch_flash_fwd(q, k, v, *ctx.args)[0],
                (q, k, v), (g,)), None, None, None)
        if q.device.type != "cuda":
            bwd = _torch_flash_bwd
        elif q.shape[-1] > _MAX_HEAD_DIM:
            bwd = _plain_flash_bwd_on_cuda
        else:
            # read at backward time, as the JAX package does
            fused = getenv("MXTPU_FLASH_BWD", "split") == "fused"
            bwd = _cuda_flash_bwd_fused \
                if _bwd_kernel_for(q.shape[2], fused) == "fused" \
                else _cuda_flash_bwd
        return (*bwd(q, k, v, out, lse, g, *ctx.args), None, None, None)


@register("flash_attention")
def flash_attention(query, key, value, scale=None, causal=False,
                    block_size=1024, window=0, native_gqa=False):
    """Memory-efficient attention, differentiable. ``query`` is
    ``(B, H, T, D)``, ``key``/``value`` ``(B, KVH, S, D)`` with
    ``KVH | H`` (grouped-query heads); the result is ``(B, H, T, D)`` in
    the input type.

    ``causal`` masks bottom-right aligned (row ``t`` sees columns up to
    ``t + S - T``); ``window > 0`` turns causal on and lets each position
    see only the last ``window`` positions, and needs ``T == S``.

    CUDA tensors (float32, bfloat16 or float16) run the Hopper kernels,
    counted in ``_kernels.LAUNCHES["flash_fwd"]``, then
    ``["flash_bwd_dq"]`` and ``["flash_bwd_dkv"]`` (the split backward,
    the default) or ``["flash_bwd_fused"]`` (``MXTPU_FLASH_BWD=fused`` and
    ``T <= 8192``, read when the backward runs); with ``D > 128`` they run
    the plain versions on the card, as the JAX package runs its jnp path
    there, counted in ``["flash_plain_fwd"]`` and ``["flash_plain_bwd"]``.
    CPU tensors run the plain versions. ``block_size`` and ``native_gqa``
    are accepted for parity with the JAX package: the kernels pick their
    own tiles and always read grouped kv heads unrepeated, so both values
    compute the same function."""
    del block_size, native_gqa
    if scale is None:
        scale = 1.0 / (query.shape[-1] ** 0.5)
    if window and window < 0:
        raise ValueError(f"window must be >= 0 (0 disables); got {window}")
    if query.shape[1] % key.shape[1] != 0:
        raise ValueError("query heads must be a multiple of kv heads; got "
                         f"{query.shape[1]} vs {key.shape[1]}")
    if window and window > 0:
        causal = True
        if query.shape[2] != key.shape[2]:
            raise ValueError("window attention expects self-attention "
                             "(T == S)")
    return _FlashAttention.apply(query, key, value, float(scale),
                                 bool(causal), int(window or 0))
