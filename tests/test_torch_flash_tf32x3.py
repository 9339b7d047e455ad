"""The precision scheme of the flash-attention backward kernels (K2, K6),
checked on the CPU: an emulation of their 3xTF32 tensor-core products,
run through a backward, against the JAX package's scan backward.

The kernels (``mxnet_tpu_torch/csrc/flash_mma.cuh``) split each fp32
operand ``x`` into ``big = tf32(x)`` and ``small = tf32(x - big)``, both
rounded to nearest with ties away from zero (``cvt.rna.tf32.f32``), and
take a product as three TF32 products accumulated in fp32 in the order
small.big, big.small, big.big. Here the rounding is done on the fp32 bit
pattern with integer operations, and each TF32 product by an fp32 matmul
of TF32 values (a product of two 11-bit significands is exact in fp32).
The emulation lives in this file only; the port's package never uses it.

Tolerance (float32): 1e-5 absolute and relative, as the port's other
flash parity tests. 3xTF32 misses an fp32 product by about 2^-22 of each
term (the dropped small.small and the bits past 22), well below the ~1e-6
that summation order moves values of order 1 by; one TF32 product alone
misses by about 2^-11, which a test shows the tolerance catches.

The fp32 matmuls above round each sum to nearest. The tensor cores'
fp32 accumulator does not: the last test models it as rounding toward
zero after each mma step (eight exact products added at once) and shows
why the kernels start every tile's product at zero and add it to the
running sum with an ordinary fp32 add, instead of chaining one
accumulator over the whole walk of the query (or key) axis.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import flash_attention as jfa
from mxnet_tpu_torch.ops.flash_attention import _repeat_kv, _visible

TOL = 1e-5
_NEG_INF = -1e30

# name: (B, H, KVH, T, S, D, causal, window): dense, causal, window, GQA 2
# and 4, head dims 16 / 40 / 64 / 128, ragged T, a causal cross shape
CASES = {
    "dense_d16": (2, 2, 2, 24, 24, 16, False, 0),
    "causal_ragged_d64": (1, 2, 2, 37, 37, 64, True, 0),
    "window_gqa2_d40": (1, 4, 2, 30, 30, 40, True, 7),
    "causal_gqa4_d128": (1, 8, 2, 20, 20, 128, True, 0),
    "causal_cross_gqa2_d64": (1, 4, 2, 12, 40, 64, True, 0),
}


def tf32(x):
    """fp32 -> TF32 (kept in fp32), round to nearest, ties away from zero:
    add half of the 13 dropped bits to the magnitude bits, then clear
    them. Finite inputs only."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (u + 0x1000) & 0xFFFFE000
    r = torch.where(r >= 2 ** 31, r - 2 ** 32, r)
    return r.to(torch.int32).view(torch.float32)


def split(x):
    big = tf32(x)
    return big, tf32(x - big)


def mm_3xtf32(a, b):
    """a @ b as the kernels take it: small.big + big.small + big.big."""
    a_big, a_small = split(a)
    b_big, b_small = split(b)
    acc = a_small @ b_big
    acc = acc + a_big @ b_small
    return acc + a_big @ b_big


def mm_tf32(a, b):
    """a @ b as one TF32 product (big.big only)."""
    return tf32(a) @ tf32(b)


def emulated_bwd(q, k, v, out, lse, g, scale, causal, window, mm):
    """The backward with each of its five products taken by ``mm``: the
    kernels' function (flash_bwd.cu) on whole (T, S) tiles."""
    B, H, T, D = q.shape
    KVH, S = k.shape[1], k.shape[2]
    kf, vf = _repeat_kv(q, k, v)
    delta = (g * out).sum(dim=-1)
    s = mm(q, kf.transpose(-1, -2)) * scale
    if causal or window > 0:
        ok = _visible(T, S, torch.arange(S), window, q.device)
        s = torch.where(ok, s, _NEG_INF)
    p = torch.exp(s - lse[..., None])
    dv = mm(p.transpose(-1, -2), g)
    dp = mm(g, vf.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    dq = mm(ds, kf)
    dk = mm(ds.transpose(-1, -2), q)
    if H != KVH:
        dk = dk.reshape(B, KVH, H // KVH, S, D).sum(dim=2)
        dv = dv.reshape(B, KVH, H // KVH, S, D).sum(dim=2)
    return dq, dk, dv


def _case(name):
    B, H, KVH, T, S, D, causal, window = CASES[name]
    rs = np.random.RandomState(5)
    q = rs.randn(B, H, T, D).astype(np.float32)
    k = rs.randn(B, KVH, S, D).astype(np.float32)
    v = rs.randn(B, KVH, S, D).astype(np.float32)
    g = rs.randn(B, H, T, D).astype(np.float32)
    scale = D ** -0.5
    kf, vf = jfa._repeat_kv(q, k, v)
    o, lse = jfa._jnp_flash_fwd(q, kf, vf, scale, causal, window)
    o, lse = np.array(o), np.array(lse)
    want = [np.array(a) for a in jfa._flash_bwd_rule(
        scale, causal, 8, window, False, (q, k, v, o, lse), jnp.asarray(g))]
    args = [torch.from_numpy(a) for a in (q, k, v, o, lse, g)]
    return args, (scale, causal, window), want


def test_tf32_rounds_to_nearest_ties_away():
    base = 0x3F800000  # 1.0
    bits = np.array([base, base + 0x0FFF, base + 0x1000, base + 0x1FFF,
                     base + 0x2000 + 0x1000, base | 0x80000000,
                     (base + 0x1000) | 0x80000000], dtype=np.uint32)
    x = torch.from_numpy(bits.view(np.float32).copy())
    got = tf32(x).numpy().view(np.uint32)
    want = np.array([base, base, base + 0x2000, base + 0x2000,
                     base + 0x4000, base | 0x80000000,
                     (base + 0x2000) | 0x80000000], dtype=np.uint32)
    np.testing.assert_array_equal(got, want)


def test_split_rebuilds_fp32_within_2_pow_minus_22():
    rs = np.random.RandomState(0)
    x = (rs.randn(1 << 16) * 10.0 ** rs.uniform(-6, 6, 1 << 16)).astype(
        np.float32)
    xt = torch.from_numpy(x)
    big, small = split(xt)
    assert torch.equal(tf32(big), big) and torch.equal(tf32(small), small)
    err = (big.double() + small.double() - xt.double()).abs()
    assert bool((err <= 2.0 ** -22 * xt.double().abs()).all()), \
        float((err / xt.double().abs()).max())


@pytest.mark.parametrize("name", list(CASES))
def test_3xtf32_backward_matches_jax_scan(name):
    args, (scale, causal, window), want = _case(name)
    got = emulated_bwd(*args, scale, causal, window, mm_3xtf32)
    for what, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == torch.float32, what
        np.testing.assert_allclose(a.numpy(), b, rtol=TOL, atol=TOL,
                                   err_msg=what)


def test_one_tf32_product_misses_the_tolerance():
    """big.big alone is the TF32 scheme fp32 attention must not fall to:
    at D = 128 it misses the 1e-5 the 3xTF32 backward meets."""
    args, (scale, causal, window), want = _case("causal_gqa4_d128")
    got = emulated_bwd(*args, scale, causal, window, mm_tf32)
    worst = max(float(np.abs(a.numpy() - b).max() / np.abs(b).max())
                for a, b in zip(got, want))
    assert worst > 10 * TOL, worst


def trunc32(x):
    """float64 -> float32 rounded toward zero: the model of the tensor
    cores' fp32 accumulator used here."""
    f = x.to(torch.float32)
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def mm_3xtf32_chained(a, b, tile, per_tile):
    """a @ b as a chain of m16n8k8 mma steps: each step adds its eight
    small.big, then big.small, then big.big products (exact in float64)
    into the fp32 accumulator, which rounds toward zero. With
    ``per_tile`` the accumulator starts at zero every ``tile`` steps of k
    and is added into an fp32 running sum (round to nearest), as the
    kernels do; without it one accumulator runs over the whole k axis."""
    a_big, a_small = (x.double() for x in split(a))
    b_big, b_small = (x.double() for x in split(b))
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    total = torch.zeros_like(acc)
    for k0 in range(0, a.shape[1], 8):
        ks = slice(k0, k0 + 8)
        for x, y in ((a_small, b_big), (a_big, b_small), (a_big, b_big)):
            acc = trunc32(acc.double() + x[:, ks] @ y[ks])
        if per_tile and (k0 + 8) % tile == 0:
            total, acc = total + acc, torch.zeros_like(acc)
    return total + acc


@pytest.mark.parametrize("product", ["dk", "dv"])
def test_truncating_accumulator_needs_per_tile_sums(product):
    """dk = ds^T Q and dv = p^T dO of one key tile (64 keys, D 128) over a
    long walk: a group of 4 query heads of 2048 rows each, 8192 rows in
    all, dense. With the accumulator chained over the walk, rounding
    toward zero at each of its 3072 steps drifts past 1e-5 of the largest
    value; with a fresh accumulator per 64-row tile (24 steps) added to
    an fp32 sum, the product stays within it. The reference is the
    float64 product of the same fp32 operands."""
    group, T, S, D = 4, 2048, 64, 128
    rs = np.random.RandomState(11)
    q, g = (torch.from_numpy(rs.randn(group, T, D)) for _ in range(2))
    k, v = (torch.from_numpy(rs.randn(S, D)) for _ in range(2))
    scale = D ** -0.5
    p = torch.softmax(q @ k.T * scale, dim=-1)
    dp = g @ v.T
    ds = p * (dp - (p * dp).sum(-1, keepdim=True)) * scale
    a, b = (ds, q) if product == "dk" else (p, g)
    a32 = a.permute(2, 0, 1).reshape(S, group * T).float()
    b32 = b.reshape(group * T, D).float()
    want = a32.double() @ b32.double()
    errs = {}
    for per_tile in (True, False):
        got = mm_3xtf32_chained(a32, b32, 64, per_tile)
        errs[per_tile] = float(
            (got.double() - want).abs().max() / want.abs().max())
    assert errs[True] <= TOL < errs[False], errs
