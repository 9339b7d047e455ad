"""Fused 1x1-convolution (matmul) + BatchNorm-statistics operators.

PyTorch counterpart of ``mxnet_tpu/ops/fused_conv_bn.py``. A 1x1
convolution over NHWC activations is a matmul over the flattened
``(N*H*W, C)`` rows, so the fusion pass (``gluon/nn/tpu_fusion.py``) runs
it as

    y, ysum, yssq = matmul_stats(x, w)
    y, ysum, yssq = scaled_matmul_stats(x, scale, shift, w, relu)

with the per-output-channel sum and sum of squares of the fp32
accumulator taken in the product's epilogue (the following BatchNorm's
batch moments, without a second read of ``y``) and, in the second form,
the previous BatchNorm's normalise + shift (+ relu) applied to the raw
``x`` as it is read. Both are ``torch.autograd.Function``\\ s. The stat
outputs' cotangents come back as per-channel vectors, so the backward
forms ``dY = dy + dsum + 2 y dssq`` as it reads ``dy`` and runs the two
products dW and dX with that correction folded in.

On CUDA tensors every call launches the hand-written Hopper kernels of
``csrc/fused_conv_bn.cu`` (any M, K, N; float32, bfloat16 or float16):
the forward K4 (the port of ``_fwd_kernel``), then in the backward K5's
dW kernel (the port of ``_dw_kernel``) and dX kernel (the port of
``_dx_kernel``),
counted in ``_kernels.LAUNCHES["fused_fwd"]``, ``["fused_dw"]`` and
``["fused_dx"]`` (one count per call of a launcher, which enqueues the
tile kernel and its fixed-order reduction). K4 and K5 multiply on the
tensor cores as 3xTF32 (fp32 accuracy); :func:`_kernel_resources` reports
each kernel's registers, shared memory and blocks per SM. On CPU tensors they run the
plain versions :func:`_torch_fused_fwd` and :func:`_torch_fused_bwd` (the
ports of ``_fused_fwd_reference`` and ``_fused_bwd_reference``, cast for
cast). A CUDA tensor never takes the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from ..autograd import recompute_grads
from . import _kernels
from .registry import register

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _acc_dtype(dtype):
    return torch.promote_types(dtype, torch.float32)


def _prologue(x, scale, shift, relu, acc):
    """``relu?(x * scale + shift)`` in the accumulation type."""
    xf = x.to(acc) * scale.to(acc).reshape(1, -1) \
        + shift.to(acc).reshape(1, -1)
    return torch.relu(xf) if relu else xf


def _torch_fused_fwd(x, w, scale, shift, relu=False, exact=False):
    """Plain version of K4: ``(y, ysum, yssq)``, y in x's type, the sums of
    the fp32 (accumulation-type) product. With ``exact`` the prologue and
    its rounding run as without, and the product and both sums in float64
    on the same operands, each output then cast to its usual type (a
    yardstick of the kernel's accuracy; the port never sets it)."""
    acc = _acc_dtype(x.dtype)
    prod = torch.float64 if exact else acc
    if scale is not None:
        x = _prologue(x, scale, shift, relu, acc).to(x.dtype)
    y = torch.matmul(x.to(prod), w.to(prod))
    return (y.to(x.dtype), y.sum(dim=0).to(acc),
            (y * y).sum(dim=0).to(acc))


def _form_dy(y, dy, dsum, dssq, acc, mm):
    """``dY = dy + dsum + 2 y dssq`` rounded to the matmul type."""
    return (dy.to(acc) + dsum.to(acc).reshape(1, -1)
            + 2.0 * y.to(acc) * dssq.to(acc).reshape(1, -1)).to(mm)


def _torch_fused_dw(x, y, scale, shift, dy, dsum, dssq, relu, w_dtype,
                    exact=False):
    """Plain version of K5's dW kernel: ``xa^T dY`` in w's type. With
    ``exact`` the product runs in float64 on the same operands (a yardstick
    of the kernels' accuracy; the port never sets it)."""
    acc = _acc_dtype(x.dtype)
    prod = torch.float64 if exact else acc
    d_y = _form_dy(y, dy, dsum, dssq, acc, x.dtype)
    xa = x if scale is None \
        else _prologue(x, scale, shift, relu, acc).to(x.dtype)
    return torch.matmul(xa.to(prod).t(), d_y.to(prod)).to(w_dtype)


def _torch_fused_dx(x, w, y, scale, shift, dy, dsum, dssq, relu,
                    exact=False):
    """Plain version of K5's dX kernel: ``(dx, dscale, dbias)``; the last
    two are None without a prologue. With ``exact`` the product and the
    statistics run in float64 on the same operands (as ``_torch_fused_dw``),
    each output then cast to its usual type."""
    acc = _acc_dtype(x.dtype)
    prod = torch.float64 if exact else acc
    d_y = _form_dy(y, dy, dsum, dssq, acc, x.dtype)
    dxa = torch.matmul(d_y.to(prod), w.to(prod).t())
    if scale is None:
        return dxa.to(x.dtype), None, None
    if relu:
        xf = _prologue(x, scale, shift, False, acc)
        dxa = torch.where(xf > 0.0, dxa, 0.0)
    dx = (dxa * scale.to(prod).reshape(1, -1)).to(x.dtype)
    return (dx, (dxa * x.to(prod)).sum(dim=0).to(acc),
            dxa.sum(dim=0).to(acc))


def _torch_fused_bwd(x, w, y, scale, shift, dy, dsum, dssq, relu=False,
                     exact=False):
    """Plain version of K5: ``(dx, dw, dscale, dbias)`` (``exact``: the
    products and sums in float64, as above)."""
    dw = _torch_fused_dw(x, y, scale, shift, dy, dsum, dssq, relu, w.dtype,
                         exact)
    dx, dsc, dbi = _torch_fused_dx(x, w, y, scale, shift, dy, dsum, dssq,
                                   relu, exact)
    return dx, dw, dsc, dbi


# ---------------------------------------------------------------------------
# the Hopper kernels
# ---------------------------------------------------------------------------


def _lib():
    lib = _kernels.library("fused_conv_bn")
    if getattr(lib, "_mxtpu_typed", False):
        return lib
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # M, K, N, apply, relu, stream
    tail = [i32] * 5 + [ptr]
    for name, n_ptrs in (("mxtpu_fused_fwd", 8), ("mxtpu_fused_dw", 9),
                         ("mxtpu_fused_dx", 12)):
        fn = getattr(lib, name)
        fn.restype = i32
        fn.argtypes = [i32] + [ptr] * n_ptrs + tail
    lib.mxtpu_fused_workspace.restype = ctypes.c_longlong
    lib.mxtpu_fused_workspace.argtypes = [i32] * 5
    lib.mxtpu_fused_resources.restype = i32
    lib.mxtpu_fused_resources.argtypes = [i32] * 4 + [ptr]
    lib._mxtpu_typed = True
    return lib


_RESOURCE_KERNELS = {"fused_fwd": 0, "fused_dw": 1, "fused_dw_t": 2,
                     "fused_dx": 3}


def _kernel_resources(kernel, dtype, apply=False, relu=False):
    """What the runtime reports for one kernel (``"fused_fwd"``,
    ``"fused_dw"`` for K >= N, ``"fused_dw_t"`` for K < N, or
    ``"fused_dx"``) at a storage type and prologue mode: registers per
    thread, static and dynamic shared bytes per block, blocks per SM, local
    (spill) bytes per thread and threads per block."""
    lib = _lib()
    out = (ctypes.c_int * 6)()
    err = lib.mxtpu_fused_resources(_RESOURCE_KERNELS[kernel],
                                    _DTYPE_CODES[dtype], int(apply),
                                    int(relu), out)
    _kernels.check(lib, err, f"{kernel} resources")
    return dict(zip(("regs", "static_smem", "dynamic_smem", "blocks_per_sm",
                     "local_bytes", "threads"), out))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _vec(v, n, dev, what):
    """A (n,) fp32 contiguous vector on ``dev`` (None stays None)."""
    if v is None:
        return None
    if v.shape != (n,):
        raise ValueError(f"{what} must have shape ({n},), got "
                         f"{tuple(v.shape)}")
    if v.device != dev:
        raise ValueError(f"{what} is on {v.device}, x on {dev}")
    return v.to(torch.float32).contiguous()


def _operands(x, w, extra=()):
    """Check what the kernels take; return x, w (and ``extra``, each of
    shape (M, N)) contiguous with the problem size."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"fused matmul takes x (M, K) and w (K, N); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError("fused conv+BN kernels take float32, bfloat16 or "
                        f"float16, the same for x and w; got {x.dtype}, "
                        f"{w.dtype}")
    M, K = x.shape
    N = w.shape[1]
    for name, t in [("w", w)] + list(extra):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if name != "w" and (tuple(t.shape) != (M, N) or t.dtype != x.dtype):
            raise ValueError(f"{name} must be ({M}, {N}) {x.dtype}; got "
                             f"{tuple(t.shape)} {t.dtype}")
    return ([x.contiguous(), w.contiguous()]
            + [t.contiguous() for _, t in extra]), (M, K, N)


def _launch(lib, name, *args):
    """Call one launcher on x's current stream and check its error."""
    err = getattr(lib, name)(*args)
    _kernels.check(lib, err, f"{name} launch")
    _kernels.count(name[len("mxtpu_"):])


def _workspace(lib, kernel, M, K, N, apply, dev):
    n = lib.mxtpu_fused_workspace(kernel, M, K, N, int(apply))
    return torch.empty((max(n, 1),), dtype=torch.float32, device=dev)


def _cuda_fused_fwd(x, w, scale, shift, relu=False):
    """Launch K4: ``(y, ysum, yssq)``."""
    (x, w), (M, K, N) = _operands(x, w)
    dev = x.device
    scale = _vec(scale, K, dev, "scale")
    shift = _vec(shift, K, dev, "shift")
    apply = scale is not None
    y = torch.empty((M, N), dtype=x.dtype, device=dev)
    ysum = torch.empty((N,), dtype=torch.float32, device=dev)
    yssq = torch.empty((N,), dtype=torch.float32, device=dev)
    if M == 0 or N == 0 or K == 0:
        return y.zero_(), ysum.zero_(), yssq.zero_()
    lib = _lib()
    ws = _workspace(lib, 0, M, K, N, apply, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch(lib, "mxtpu_fused_fwd", _DTYPE_CODES[x.dtype], _ptr(x),
                _ptr(w), _ptr(scale), _ptr(shift), _ptr(y), _ptr(ysum),
                _ptr(yssq), _ptr(ws), M, K, N, int(apply), int(relu), stream)
        if _kernels.FLOP_SINKS:  # introspection: the launch's 2 M K N
            _kernels.note_flops(2 * M * K * N)
    return y, ysum, yssq


def _bwd_operands(x, w, y, scale, shift, dy, dsum, dssq):
    (x, w, y, dy), (M, K, N) = _operands(x, w, (("y", y), ("dy", dy)))
    dev = x.device
    vecs = (_vec(scale, K, dev, "scale"), _vec(shift, K, dev, "shift"),
            _vec(dsum, N, dev, "dsum"), _vec(dssq, N, dev, "dssq"))
    return (x, w, y, dy) + vecs, (M, K, N)


def _cuda_fused_dw(x, w, y, scale, shift, dy, dsum, dssq, relu=False):
    """Launch K5's dW kernel: ``dw`` (K, N) in w's type."""
    (x, w, y, dy, scale, shift, dsum, dssq), (M, K, N) = _bwd_operands(
        x, w, y, scale, shift, dy, dsum, dssq)
    dev = x.device
    dw = torch.empty((K, N), dtype=w.dtype, device=dev)
    if M == 0 or N == 0 or K == 0:
        return dw.zero_()
    lib = _lib()
    with torch.cuda.device(dev):
        # the split count, and so the workspace, follows the device's SMs
        ws = _workspace(lib, 1, M, K, N, scale is not None, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch(lib, "mxtpu_fused_dw", _DTYPE_CODES[x.dtype], _ptr(x),
                _ptr(dy), _ptr(y), _ptr(dsum), _ptr(dssq), _ptr(scale),
                _ptr(shift), _ptr(dw), _ptr(ws), M, K, N,
                int(scale is not None), int(relu), stream)
        if _kernels.FLOP_SINKS:  # introspection: the launch's 2 M K N
            _kernels.note_flops(2 * M * K * N)
    return dw


def _cuda_fused_dx(x, w, y, scale, shift, dy, dsum, dssq, relu=False):
    """Launch K5's dX kernel: ``(dx, dscale, dbias)``, the last two None
    without a prologue."""
    (x, w, y, dy, scale, shift, dsum, dssq), (M, K, N) = _bwd_operands(
        x, w, y, scale, shift, dy, dsum, dssq)
    dev = x.device
    apply = scale is not None
    dx = torch.empty((M, K), dtype=x.dtype, device=dev)
    dsc = torch.empty((K,), dtype=torch.float32, device=dev) \
        if apply else None
    dbi = torch.empty_like(dsc) if apply else None
    if M == 0 or N == 0 or K == 0:
        return (dx.zero_(), dsc.zero_() if apply else None,
                dbi.zero_() if apply else None)
    lib = _lib()
    ws = _workspace(lib, 2, M, K, N, apply, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch(lib, "mxtpu_fused_dx", _DTYPE_CODES[x.dtype], _ptr(dy),
                _ptr(y), _ptr(w), _ptr(dsum), _ptr(dssq), _ptr(x),
                _ptr(scale), _ptr(shift), _ptr(dx), _ptr(dsc), _ptr(dbi),
                _ptr(ws), M, K, N, int(apply), int(relu), stream)
        if _kernels.FLOP_SINKS:  # introspection: the launch's 2 M K N
            _kernels.note_flops(2 * M * K * N)
    return dx, dsc, dbi


def _fused_fwd(x, w, scale, shift, relu):
    if x.device.type == "cuda":
        return _cuda_fused_fwd(x, w, scale, shift, relu)
    if x.device.type != "cpu":
        raise ValueError(f"fused conv+BN runs on cuda or cpu, not "
                         f"{x.device}")
    return _torch_fused_fwd(x, w, scale, shift, relu)


def _fused_bwd(x, w, y, scale, shift, dy, dsum, dssq, relu):
    if x.device.type == "cuda":
        dw = _cuda_fused_dw(x, w, y, scale, shift, dy, dsum, dssq, relu)
        dx, dsc, dbi = _cuda_fused_dx(x, w, y, scale, shift, dy, dsum, dssq,
                                      relu)
        return dx, dw, dsc, dbi
    return _torch_fused_bwd(x, w, y, scale, shift, dy, dsum, dssq, relu)


# ---------------------------------------------------------------------------
# public autograd operators
# ---------------------------------------------------------------------------


class _MatmulStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        y, ysum, yssq = _fused_fwd(x, w, None, None, False)
        ctx.save_for_backward(x, w, y)
        return y, ysum, yssq

    @staticmethod
    def backward(ctx, dy, dsum, dssq):
        x, w, y = ctx.saved_tensors
        if torch.is_grad_enabled():  # create_graph: the plain version's
            return tuple(recompute_grads(
                lambda x, w: _torch_fused_fwd(x, w, None, None),
                (x, w), (dy, dsum, dssq)))
        dx, dw, _, _ = _fused_bwd(x, w, y, None, None, dy, dsum, dssq, False)
        return dx, dw


class _ScaledMatmulStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, shift, w, relu):
        y, ysum, yssq = _fused_fwd(x, w, scale, shift, relu)
        ctx.save_for_backward(x, scale, shift, w, y)
        ctx.relu = relu
        return y, ysum, yssq

    @staticmethod
    def backward(ctx, dy, dsum, dssq):
        x, scale, shift, w, y = ctx.saved_tensors
        if torch.is_grad_enabled():  # create_graph: the plain version's
            return (*recompute_grads(
                lambda x, scale, shift, w: _torch_fused_fwd(
                    x, w, scale, shift, ctx.relu),
                (x, scale, shift, w), (dy, dsum, dssq)), None)
        dx, dw, dsc, dbi = _fused_bwd(x, w, y, scale, shift, dy, dsum, dssq,
                                      ctx.relu)
        return dx, dsc.to(scale.dtype), dbi.to(shift.dtype), dw, None


@register("_contrib_fused_matmul_stats")
def matmul_stats(x, w):
    """``(M, K) @ (K, N)`` with the per-output-channel sum and sum of
    squares of the fp32 product: ``(y, ysum, yssq)``, y in x's type."""
    return _MatmulStats.apply(x, w)


@register("_contrib_fused_scaled_matmul_stats")
def scaled_matmul_stats(x, scale, bias, w, relu=True):
    """Normalise + shift (+ relu) a RAW conv output ``x`` per channel
    (``scale``, ``bias`` of shape (K,)) as it is read, then
    :func:`matmul_stats`: the producer's BatchNorm never materialises its
    applied tensor."""
    return _ScaledMatmulStats.apply(x, scale, bias, w, bool(relu))
