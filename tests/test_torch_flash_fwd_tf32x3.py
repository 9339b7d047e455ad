"""The arithmetic of the flash-attention forward kernel (K1,
``mxnet_tpu_torch/csrc/flash_fwd.cu``), checked on the CPU: an emulation
of its 3xTF32 tensor-core products and its online softmax over 64-key
tiles, against the JAX package's oracle ``_jnp_flash_fwd``.

What is emulated, as the kernel does it:
- each product S = Q K^T and P V runs as m16n8k8 mma steps of eight
  k-indices: each fp32 operand is split into big = tf32(x) and
  small = tf32(x - big) (``tests/test_torch_flash_tf32x3.py``'s ``split``),
  and a step adds its small.big, then big.small, then big.big products
  into the fp32 accumulator, which rounds toward zero (the model of the
  tensor cores' accumulator used there); the kernel's paired k order
  permutes k inside one step, whose eight products the model adds at
  once, so it leaves the result as it is;
- S of a tile starts at zero and runs over the head dim; P stays fp32
  (its small term kept); P V of a tile starts at zero, runs over the
  tile's 64 keys, and is added with an fp32 add to acc * alpha, alpha =
  exp(m_old - m_new) of the online softmax;
- O = acc / max(l, 1e-30) and LSE = m + log(l) at the end.
The emulation lives in this file only; the port's package never uses it.

Tolerance (float32): 1e-5 of the largest |value| on O and the LSE, as
the kernel is held to its plain version on the card. The last test shows
why the kernel adds each tile's P V in fp32: one accumulator chained
through the mma steps over a long walk of keys drifts past 1e-5.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import flash_attention as jfa
from mxnet_tpu_torch.ops.flash_attention import _repeat_kv, _visible

TOL = 1e-5
KEYS = 64  # keys per tile

# name: (B, H, KVH, T, S, D, causal, window, rows): rows, when given, are
# the query rows emulated (the kernel's query tiles are independent; at
# T = 2048 the last, whose causal walk is the longest, keeps the test
# short)
CASES = {
    "dense_d64": (1, 2, 2, 200, 200, 64, False, 0, None),
    "causal_d128": (1, 2, 2, 260, 260, 128, True, 0, None),
    "window_d128": (1, 2, 2, 260, 260, 128, True, 100, None),
    "causal_gqa4_d128_t2048": (1, 4, 1, 2048, 2048, 128, True, 0,
                               slice(1984, 2048)),
}


def tf32(x):
    """fp32 -> TF32 (kept in fp32), round to nearest, ties away from zero."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (u + 0x1000) & 0xFFFFE000
    r = torch.where(r >= 2 ** 31, r - 2 ** 32, r)
    return r.to(torch.int32).view(torch.float32)


def split(x):
    big = tf32(x)
    return big, tf32(x - big)


def trunc32(x):
    """float64 -> float32 rounded toward zero (fp32's normal range): the
    low 29 bits of the float64 significand cleared, then an exact cast."""
    return (x.view(torch.int64) & ~((1 << 29) - 1)).view(torch.float64) \
        .to(torch.float32)


def mma_chain(acc, a, b):
    """acc + a @ b as the kernel's mma steps: eight k-indices a step, each
    step adding small.big, big.small, big.big (exact in float64) into the
    fp32 accumulator ``acc``, which rounds toward zero after each."""
    a_big, a_small = (x.double() for x in split(a))
    b_big, b_small = (x.double() for x in split(b))
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        for x, y in ((a_small, b_big), (a_big, b_small), (a_big, b_big)):
            acc = trunc32(acc.double() + x[..., ks] @ y[..., ks, :])
    return acc


def emulated_fwd(q, k, v, scale, causal, window, chained=False, rows=None):
    """K1's function with its arithmetic: O (fp32) and the LSE, of the
    query rows ``rows`` (a slice; all by default). With ``chained``, each
    tile's P V goes straight into the rescaled running accumulator
    instead of starting from zero and being added in fp32."""
    T, S = q.shape[2], k.shape[2]
    kf, vf = _repeat_kv(q, k, v)
    rows = rows or slice(0, T)
    q = q[:, :, rows]
    B, H, _, D = q.shape
    m = torch.full((B, H, q.shape[2], 1), -np.inf)
    l = torch.zeros(B, H, q.shape[2], 1)
    acc = torch.zeros(B, H, q.shape[2], D)
    for c0 in range(0, S, KEYS):
        ks, vs = kf[:, :, c0:c0 + KEYS], vf[:, :, c0:c0 + KEYS]
        s = mma_chain(torch.zeros(B, H, q.shape[2], ks.shape[2]), q,
                      ks.transpose(-1, -2)) * scale
        if causal or window > 0:
            cols = torch.arange(c0, c0 + ks.shape[2])
            s = torch.where(_visible(T, S, cols, window, q.device)[rows], s,
                            torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        m = m_new
        if chained:
            acc = mma_chain(acc * alpha, p, vs)
        else:
            acc = acc * alpha + mma_chain(torch.zeros_like(acc), p, vs)
    lf = torch.clamp(l, min=1e-30)
    return acc / lf, (m + torch.log(lf))[..., 0]


def _inputs(B, H, KVH, T, S, D, seed=9):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, H, T, D).astype(np.float32),
            rs.randn(B, KVH, S, D).astype(np.float32),
            rs.randn(B, KVH, S, D).astype(np.float32))


def _oracle(q, k, v, scale, causal, window):
    kf, vf = jfa._repeat_kv(q, k, v)
    o, lse = jfa._jnp_flash_fwd(q, kf, vf, scale, causal, window)
    return np.array(o), np.array(lse)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_trunc32_rounds_toward_zero():
    x = torch.tensor([1.0 + 2.0 ** -30, -(1.0 + 2.0 ** -30),
                      1.0 + 2.0 ** -23 - 2.0 ** -40, 3.0],
                     dtype=torch.float64)
    want = torch.tensor([1.0, -1.0, 1.0, 3.0])
    assert torch.equal(trunc32(x), want)


@pytest.mark.parametrize("name", list(CASES))
def test_emulated_forward_matches_jax_oracle(name):
    B, H, KVH, T, S, D, causal, window, rows = CASES[name]
    q, k, v = _inputs(B, H, KVH, T, S, D)
    scale = D ** -0.5
    want_o, want_lse = _oracle(q, k, v, scale, causal, window)
    rows = rows or slice(0, T)
    want_o, want_lse = want_o[:, :, rows], want_lse[:, :, rows]
    o, lse = emulated_fwd(*(torch.from_numpy(a) for a in (q, k, v)), scale,
                          causal, window, rows=rows)
    assert o.shape == want_o.shape and lse.shape == want_lse.shape
    assert _rel(o.numpy(), want_o) <= TOL
    assert _rel(lse.numpy(), want_lse) <= TOL


def test_chained_accumulator_misses_where_per_tile_adds_meet():
    """One query tile of 64 rows over a dense walk of 8192 keys (D 128):
    chained through the mma steps, the running P V accumulator is
    truncated 3 x 1024 times and O drifts past 1e-5 of its largest
    value; with each tile's product from zero, added in fp32, it stays
    within it."""
    B, H, KVH, T, S, D = 1, 1, 1, 64, 8192, 128
    q, k, v = _inputs(B, H, KVH, T, S, D, seed=10)
    scale = D ** -0.5
    want_o, _ = _oracle(q, k, v, scale, False, 0)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    errs = {chained: _rel(emulated_fwd(*args, scale, False, 0,
                                       chained=chained)[0].numpy(), want_o)
            for chained in (False, True)}
    assert errs[False] <= TOL < errs[True], errs
