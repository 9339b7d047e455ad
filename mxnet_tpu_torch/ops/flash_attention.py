"""Paged decode attention: the serving fast path's one kernel.

PyTorch counterpart of ``paged_decode_attention`` in
``mxnet_tpu/ops/flash_attention.py``. On a CUDA tensor it launches the
hand-written Hopper kernel ``csrc/paged_decode.cu`` (the port of the TPU
kernel ``_paged_decode_kernel``); on a CPU tensor it runs
:func:`_torch_paged_decode`, the plain PyTorch version of the same
function (the port of ``_jnp_paged_decode``). A CUDA tensor never takes
the plain version: the kernel launches or the call raises.

The kernel's bound on an H100 SXM is the bytes of K and V in context,
read once, over 3.35 TB/s; see the note at the top of the CUDA source for
why this first version stays far from it at the serving shape.
"""

from __future__ import annotations

import ctypes

import torch

from . import _kernels

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128
_MAX_SMEM_BYTES = 232448  # per-block dynamic shared memory on Hopper


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
        ptr = ctypes.c_void_p
        lib.mxtpu_paged_decode.restype = ctypes.c_int
        lib.mxtpu_paged_decode.argtypes = (
            [ctypes.c_int] + [ptr] * 6 + [ctypes.c_int] * 6
            + [ctypes.c_float, ptr])
        lib.mxtpu_paged_decode_smem_bytes.restype = ctypes.c_size_t
        lib.mxtpu_paged_decode_smem_bytes.argtypes = [ctypes.c_int,
                                                      ctypes.c_int]
        lib._mxtpu_typed = True
    return lib


def _cuda_paged_decode(q, k_pool, v_pool, tables, lens, scale):
    """Validate, then launch the Hopper kernel on the current stream."""
    B, H, D = q.shape
    nb, bs, KVH, Dk = k_pool.shape
    if q.dtype not in _DTYPE_CODES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError("paged decode kernel takes float32 or bfloat16, the "
                        f"same for q and both pools; got {q.dtype}, "
                        f"{k_pool.dtype}, {v_pool.dtype}")
    if Dk != D or tuple(v_pool.shape) != tuple(k_pool.shape):
        raise ValueError(f"pool shapes {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not match q {tuple(q.shape)}")
    if D > _MAX_HEAD_DIM:
        raise ValueError(f"paged decode kernel takes head_dim <= "
                         f"{_MAX_HEAD_DIM}; got {D}")
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
    tables = tables.to(torch.int32).contiguous()
    lens = lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if B == 0:
        return out
    lib = _lib()
    if lib.mxtpu_paged_decode_smem_bytes(H // KVH, D) > _MAX_SMEM_BYTES:
        raise ValueError(f"group {H // KVH} x head_dim {D} needs more shared "
                         "memory than one Hopper block has")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mxtpu_paged_decode(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), tables.data_ptr(), lens.data_ptr(),
            out.data_ptr(), B, H, KVH, D, bs, tables.shape[1], float(scale),
            stream)
    _kernels.check(lib, err, "paged_decode launch")
    _kernels.LAUNCHES["paged_decode"] += 1
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

    CUDA tensors go through the Hopper kernel (counted in
    ``_kernels.LAUNCHES["paged_decode"]``); CPU tensors through the
    plain version."""
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
