"""The precision scheme of K4's and K5's Hopper kernels (the fused 1x1-conv
+ BN-statistics forward, and dW and dX of its backward), checked on the
CPU: an emulation of their 3xTF32 tensor-core products against the JAX
package's ``_fused_fwd_reference`` and ``_fused_bwd_reference``.

The kernels (``mxnet_tpu_torch/csrc/fused_conv_bn.cu``) split each fp32
operand ``x`` into ``big = tf32(x)`` and ``small = tf32(x - big)`` (round
to nearest, ties away from zero, as ``csrc/flash_mma.cuh`` does), and
take a product one mma step of 8 contraction indices at a time: the
step's sum starts at zero, gathers small.big, big.small and big.big, and
is added to the running fp32 sum in k order. dW contracts over M in
splits of ``dw_chunk`` rows (the kernel's rule, mirrored below), each
split summed alone and the splits then added in split order; for K < N
the kernel computes dW^T = dY^T xa, so dY takes the A side. K4 contracts
over K in the same mma steps, and its column statistics are the sums of
the fp32 product over one 128-row tile at a time, then over the tiles in
order (the kernel's order within a tile is another fixed one). Here each
TF32 product is an fp32 matmul of TF32 values (a product of two 11-bit
significands is exact in fp32), so a step's sum rounds to nearest where
the tensor cores truncate (``tests/test_torch_flash_tf32x3.py`` models
that). The emulation lives in this file only; the port never uses it.

Tolerance (float32): 1e-5 of the largest value of each output, as the
port's other fused conv + BN parity tests; and the emulated products may
be no farther from the float64 product of the same fp32 operands than
twice the distance of torch's fp32 matmul (the plain version's product).
One TF32 product alone misses by about 2^-11, which the tolerance
catches.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import fused_conv_bn as J
from mxnet_tpu_torch.ops import fused_conv_bn as F

TOL = 1e-5
KC = 32                 # kKC: contraction per k-tile (dW splits' unit)
STEP = 8                # one mma step: each step's product starts at zero
TILE_R, TILE_C = 128, 64  # kBM, kBN: dW's tile, the larger of K, N on R
DW_BLOCKS_PER_SM = 2    # kDwBlocksPerSm: one wave of resident blocks
H100_SMS = 132
STEPS_AT_ONCE = 1 << 23  # elements of the step sums formed at once (32 MiB)

# name: (M, K, N): ResNet-like widths at a small M, one ragged shape
SHAPES = {"k64_n64": (2048, 64, 64), "k64_n256": (4096, 64, 256),
          "k256_n64": (4096, 256, 64), "k256_n256": (8192, 256, 256),
          "ragged_72_40": (2048, 72, 40)}
MODES = {"plain": (False, False), "prologue": (True, False),
         "prologue_relu": (True, True)}


def tf32(x):
    """fp32 -> TF32 (kept in fp32), round to nearest, ties away from zero
    (finite inputs)."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (u + 0x1000) & 0xFFFFE000
    r = torch.where(r >= 2 ** 31, r - 2 ** 32, r)
    return r.to(torch.int32).view(torch.float32)


def split(x):
    big = tf32(x)
    return big, tf32(x - big)


def cdiv(a, b):
    return -(-a // b)


def dw_chunk(M, K, N, sms=H100_SMS):
    """Rows of dW's contraction per split, as the kernel's dw_chunk() on a
    card of ``sms`` multiprocessors."""
    tiles = cdiv(max(K, N), TILE_R) * cdiv(min(K, N), TILE_C)
    splits = DW_BLOCKS_PER_SM * sms // tiles
    splits = max(1, min(splits, cdiv(M, 256)))
    return cdiv(cdiv(M, splits), KC) * KC


def step_sums(a_big, a_small, b_big, b_small, products):
    """The per-step sums of a (..., R, L) @ b (..., L, C), L a multiple of
    STEP: (..., L // STEP, R, C), each from zero, small.big + big.small +
    big.big (``products=1``: big.big only), in one batched product each."""
    S = a_big.shape[-1] // STEP

    def mm(x, y):
        x = x.unflatten(-1, (S, STEP)).movedim(-2, -3)
        return x @ y.unflatten(-2, (S, STEP))

    acc = mm(a_big, b_big)
    if products == 3:
        acc = (mm(a_small, b_big) + mm(a_big, b_small)) + acc
    return acc


def ktile_mm(a, b, products=3):
    """a (..., R, L) @ b (..., L, C) as the kernels take it: per mma step of
    STEP, from zero, small.big + big.small + big.big (``products=1``:
    big.big only), each step's sum added to the fp32 total in k order.
    The steps' sums are formed in groups of at most STEPS_AT_ONCE
    elements (a few large products instead of one small one per step);
    only the adds to the total run one step at a time."""
    pad = -a.shape[-1] % STEP  # zero products add exact zeros
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    a_big, a_small = split(a)
    b_big, b_small = split(b)
    total = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    group = STEP * max(1, STEPS_AT_ONCE // total.numel())
    for l0 in range(0, a.shape[-1], group):
        ks = slice(l0, l0 + group)
        sums = step_sums(a_big[..., ks], a_small[..., ks], b_big[..., ks, :],
                         b_small[..., ks, :], products)
        for s in sums.unbind(-3):
            total = total + s
    return total


def model_dw(xa, d_y, products=3):
    """dW = xa^T dY over splits of dw_chunk rows, added in split order (the
    splits' products taken as one batch)."""
    M, K = xa.shape
    N = d_y.shape[1]
    chunk = dw_chunk(M, K, N)
    pad = -M % chunk  # zero rows add exact zeros to the last split
    pad_rows = torch.nn.functional.pad
    xa = pad_rows(xa, (0, 0, 0, pad)).unflatten(0, (-1, chunk))
    d_y = pad_rows(d_y, (0, 0, 0, pad)).unflatten(0, (-1, chunk))
    if K >= N:
        parts = ktile_mm(xa.transpose(1, 2), d_y, products)
    else:
        parts = ktile_mm(d_y.transpose(1, 2), xa, products).transpose(1, 2)
    total = torch.zeros(K, N, dtype=torch.float32)
    for part in parts.unbind(0):
        total = total + part
    return total


def operands(x, w, y, s, t, dy, dsum, dssq, relu):
    """The fp32 operands the kernels multiply: xa and dY (both rounded to
    the storage type, here float32) and w."""
    acc = torch.float32
    d_y = F._form_dy(y, dy, dsum, dssq, acc, x.dtype)
    xa = x if s is None else F._prologue(x, s, t, relu, acc).to(x.dtype)
    return xa, d_y, w


def model_bwd(x, w, y, s, t, dy, dsum, dssq, relu, products=3):
    """K5's function with the kernels' products: (dx, dw, dscale,
    dbias); the epilogue as the plain version computes it."""
    xa, d_y, w = operands(x, w, y, s, t, dy, dsum, dssq, relu)
    dw = model_dw(xa, d_y, products)
    dxa = ktile_mm(d_y, w.T, products)
    if s is None:
        return dxa, dw, None, None
    if relu:
        dxa = torch.where(F._prologue(x, s, t, False, torch.float32) > 0.0,
                          dxa, 0.0)
    dx = dxa * s.reshape(1, -1)
    return dx, dw, (dxa * x).sum(dim=0), dxa.sum(dim=0)


def model_fwd(x, w, s, t, relu, products=3):
    """K4's function with the kernel's products: (y, ysum, yssq); the
    statistics summed per 128-row tile, then over the tiles in order."""
    xa = x if s is None else F._prologue(x, s, t, relu, torch.float32)
    y = ktile_mm(xa, w, products)
    tiles = [y[m0:m0 + TILE_R] for m0 in range(0, y.shape[0], TILE_R)]
    ysum = torch.zeros(y.shape[1], dtype=torch.float32)
    yssq = torch.zeros_like(ysum)
    for tile in tiles:
        ysum = ysum + tile.sum(dim=0)
        yssq = yssq + (tile * tile).sum(dim=0)
    return y, ysum, yssq


def _fwd_case(shape, mode, seed=5):
    """K4's operands (x, w, scale, shift) as torch tensors, relu, and the
    JAX package's ``_fused_fwd_reference`` on the same numpy inputs."""
    M, K, N = SHAPES[shape]
    pro, relu = MODES[mode]
    rs = np.random.RandomState(seed)
    d = {"x": rs.randn(M, K), "w": rs.randn(K, N) * K ** -0.5,
         "s": rs.rand(K) + 0.5, "t": rs.randn(K) * 0.1}
    d = {k: v.astype(np.float32) for k, v in d.items()}
    if not pro:
        d["s"] = d["t"] = None
    order = ("x", "w", "s", "t")
    jargs = [None if d[k] is None else jnp.asarray(d[k]) for k in order]
    want = J._fused_fwd_reference(*jargs, relu=relu)
    targs = [None if d[k] is None else torch.from_numpy(d[k]) for k in order]
    return targs, relu, want


def _case(shape, mode, seed=3):
    M, K, N = SHAPES[shape]
    pro, relu = MODES[mode]
    rs = np.random.RandomState(seed)
    d = {"x": rs.randn(M, K), "w": rs.randn(K, N) * K ** -0.5,
         "y": rs.randn(M, N), "dy": rs.randn(M, N), "dsum": rs.randn(N),
         "dssq": rs.randn(N) * 0.01, "s": rs.rand(K) + 0.5,
         "t": rs.randn(K) * 0.1}
    d = {k: v.astype(np.float32) for k, v in d.items()}
    if not pro:
        d["s"] = d["t"] = None
    order = ("x", "w", "y", "s", "t", "dy", "dsum", "dssq")
    jargs = [None if d[k] is None else jnp.asarray(d[k]) for k in order]
    want = J._fused_bwd_reference(*jargs, relu=relu)
    targs = [None if d[k] is None else torch.from_numpy(d[k]) for k in order]
    return targs, relu, want


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


def test_tf32_rounds_to_nearest_ties_away():
    base = 0x3F800000  # 1.0
    bits = np.array([base, base + 0x0FFF, base + 0x1000, base + 0x1FFF,
                     (base + 0x1000) | 0x80000000], dtype=np.uint32)
    got = tf32(torch.from_numpy(bits.view(np.float32).copy()))
    want = np.array([base, base, base + 0x2000, base + 0x2000,
                     (base + 0x2000) | 0x80000000], dtype=np.uint32)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("M,K,N,chunk", [
    (401408, 64, 64, 1536), (401408, 64, 256, 3072), (6272, 2048, 512, 3136),
    (1000, 37, 23, 256), (100, 8, 8, 128)])
def test_dw_chunk_follows_the_kernel_rule(M, K, N, chunk):
    """Whole k-tiles, at least 256 rows where M allows, one wave of two
    blocks per SM of an H100 (132 SMs)."""
    assert dw_chunk(M, K, N) == chunk


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_3xtf32_backward_matches_jax_reference(shape, mode):
    args, relu, want = _case(shape, mode)
    got = model_bwd(*args, relu)
    for name, g, w in zip(("dx", "dw", "dscale", "dbias"), got, want):
        if w is None:
            assert g is None, name
            continue
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, name
        assert _rel(g, w) <= TOL, (name, _rel(g, w))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_3xtf32_products_as_close_to_float64_as_fp32_matmul(shape, mode):
    """dW and dxa against the float64 products of the same fp32 operands:
    the emulated kernels within twice torch's fp32 matmul distance."""
    args, relu, _ = _case(shape, mode)
    xa, d_y, w = operands(*args, relu)
    products = {
        "dw": (model_dw(xa, d_y), xa.T @ d_y, xa.double().T @ d_y.double()),
        "dxa": (ktile_mm(d_y, w.T), d_y @ w.T, d_y.double() @ w.double().T),
    }
    for name, (model, plain, exact) in products.items():
        m, p = _rel(model, exact), _rel(plain, exact)
        assert m <= 2 * p, (name, m, p)


def test_one_tf32_product_misses_the_tolerance():
    """big.big alone (TF32) misses the 1e-5 the 3xTF32 products meet."""
    args, relu, want = _case("k256_n256", "plain")
    got = model_bwd(*args, relu, products=1)
    worst = max(_rel(g, w) for g, w in zip(got[:2], want[:2]))
    assert worst > 10 * TOL, worst


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_3xtf32_forward_matches_jax_reference(shape, mode):
    args, relu, want = _fwd_case(shape, mode)
    got = model_fwd(*args, relu)
    for name, g, w in zip(("y", "ysum", "yssq"), got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, name
        assert _rel(g, w) <= TOL, (name, _rel(g, w))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_3xtf32_forward_as_close_to_float64_as_fp32_matmul(shape, mode):
    """K4's product against the float64 product of the same fp32 operands:
    the emulated kernel within twice torch's fp32 matmul distance."""
    (x, w, s, t), relu, _ = _fwd_case(shape, mode)
    xa = x if s is None else F._prologue(x, s, t, relu, torch.float32)
    m = _rel(ktile_mm(xa, w), xa.double() @ w.double())
    p = _rel(xa @ w, xa.double() @ w.double())
    assert m <= 2 * p, (m, p)


def test_one_tf32_product_misses_the_forward_tolerance():
    """big.big alone (TF32) puts K4's y past the 1e-5 the 3xTF32 products
    meet."""
    args, relu, want = _fwd_case("k256_n256", "plain")
    got = model_fwd(*args, relu, products=1)
    assert _rel(got[0], want[0]) > 10 * TOL, _rel(got[0], want[0])
