"""Port parity: ``mxnet_tpu_torch.ops.flash_attention.flash_attention``
against the JAX package's ``flash_attention`` on the same numpy inputs.

On the CPU the JAX side runs its jnp oracle (``_jnp_flash_fwd``) forward
and its blockwise scan backward (``jax.grad`` through the custom VJP);
the port runs its plain versions through ``torch.autograd``. Every mode
the kernels take is covered: dense, causal, sliding window, grouped-query
groups 2 and 4 with ``native_gqa`` both ways, ragged T, and causal
cross-attention with T < S; and head dims 160 and 256, past the kernels'
128, which both packages compute with their plain versions (on a card the
port too, counted as ``flash_plain_fwd``/``flash_plain_bwd``).

Tolerance (float32): 1e-5 absolute and relative on O and the gradients.
Both sides compute a float32 softmax over at most 40 positions and three
float32 products per gradient; they differ only in summation order,
which moves values of order 1 by ~1e-6. float16 storage: both sides
compute in fp32 from the same float16 inputs and round each output once
to float16, so they may differ by one float16 step, at most 2^-10 of the
largest |value|.

The Hopper kernels run only on a card: the ``*_on_cuda`` tests skip
without one (run them there with ``-k on_cuda``).
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops.flash_attention import flash_attention as jax_flash
from mxnet_tpu_torch.ops import _kernels
from mxnet_tpu_torch.ops.flash_attention import (
    _torch_flash_bwd,
    _torch_flash_fwd,
    flash_attention,
)

TOL = 1e-5

# name: (B, H, KVH, T, S, D, causal, window, native_gqa)
MODES = {
    "dense": (2, 4, 4, 24, 24, 16, False, 0, False),
    "causal": (2, 4, 4, 24, 24, 16, True, 0, False),
    "window": (2, 4, 4, 24, 24, 16, True, 7, False),
    "gqa2": (2, 4, 2, 24, 24, 16, True, 0, False),
    "gqa2_native": (2, 4, 2, 24, 24, 16, True, 0, True),
    "gqa4": (1, 8, 2, 20, 20, 8, False, 0, False),
    "gqa4_native": (1, 8, 2, 20, 20, 8, False, 0, True),
    "gqa4_window_native": (1, 8, 2, 20, 20, 8, True, 5, True),
    "ragged": (1, 2, 2, 37, 37, 12, True, 0, False),
    "causal_cross": (2, 2, 2, 12, 40, 16, True, 0, False),
    "dense_cross": (2, 2, 1, 9, 31, 16, False, 0, False),
    "causal_d160": (1, 2, 2, 20, 20, 160, True, 0, False),
    "dense_gqa2_d256": (1, 4, 2, 16, 16, 256, False, 0, False),
}
# float16 storage (the JAX package sums a GQA group's dk/dv after rounding
# each head's to float16, the port before, so GQA modes stay in float32)
FP16_MODES = ("dense", "causal", "window", "causal_cross", "causal_d160")


def _inputs(seed, B, H, KVH, T, S, D):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, H, T, D).astype(np.float32)
    k = rs.randn(B, KVH, S, D).astype(np.float32)
    v = rs.randn(B, KVH, S, D).astype(np.float32)
    w = rs.randn(B, H, T, D).astype(np.float32)  # cotangent of O
    return q, k, v, w


def _jax_side(q, k, v, w, causal, window, native):
    def loss(q_, k_, v_):
        o = jax_flash(q_, k_, v_, causal=causal, window=window,
                      native_gqa=native)
        return jnp.sum(o * w), o

    (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                       has_aux=True)(q, k, v)
    return [np.asarray(a) for a in (o, *grads)]


def _torch_side(q, k, v, w, causal, window, native):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = flash_attention(*ts, causal=causal, window=window,
                        native_gqa=native)
    o.backward(torch.from_numpy(w))
    return [o.detach().float().numpy()] + [t.grad.float().numpy()
                                           for t in ts]


@pytest.mark.parametrize("mode", list(MODES))
def test_forward_and_grads_match_jax(mode):
    B, H, KVH, T, S, D, causal, window, native = MODES[mode]
    q, k, v, w = _inputs(0, B, H, KVH, T, S, D)
    _kernels.LAUNCHES.clear()
    got = _torch_side(q, k, v, w, causal, window, native)
    want = _jax_side(q, k, v, w, causal, window, native)
    for name, g, x in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.shape == x.shape and g.dtype == np.float32, name
        np.testing.assert_allclose(g, x, rtol=TOL, atol=TOL, err_msg=name)
    assert not _kernels.LAUNCHES  # CPU tensors: plain versions only


@pytest.mark.parametrize("mode", FP16_MODES)
def test_float16_matches_jax(mode):
    B, H, KVH, T, S, D, causal, window, native = MODES[mode]
    arrs = [a.astype(np.float16) for a in _inputs(0, B, H, KVH, T, S, D)]
    _kernels.LAUNCHES.clear()
    got = _torch_side(*arrs, causal, window, native)
    want = _jax_side(*arrs, causal, window, native)
    for name, g, x in zip(("out", "dq", "dk", "dv"), got, want):
        x = x.astype(np.float32)
        assert g.shape == x.shape, name
        assert np.abs(g - x).max() <= 2.0 ** -10 * np.abs(x).max(), name
    assert not _kernels.LAUNCHES


def test_lse_and_plain_backward_match_jax_internals():
    """The plain forward's LSE equals the oracle's, and the plain backward
    fed the oracle's residuals equals the scan backward, at a block size
    that splits S into several blocks (the scan's own blocking)."""
    from mxnet_tpu.ops import flash_attention as fa

    B, H, KVH, T, S, D = 2, 4, 2, 16, 32, 8
    q, k, v, w = _inputs(1, B, H, KVH, T, S, D)
    scale = 0.3
    kf, vf = fa._repeat_kv(q, k, v)
    o_j, lse_j = fa._jnp_flash_fwd(q, kf, vf, scale, True)
    o_t, lse_t = _torch_flash_fwd(*(torch.from_numpy(a) for a in (q, k, v)),
                                  scale, True)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), rtol=TOL,
                               atol=TOL)
    want = fa._flash_bwd_rule(scale, True, 8, 0, False,
                              (q, k, v, o_j, lse_j), w)
    got = _torch_flash_bwd(*(torch.from_numpy(np.array(a)) for a in
                             (q, k, v, o_j, lse_j, w)), scale, True,
                           block_size=8)
    for g, x in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=TOL,
                                   atol=TOL)


def test_argument_checks_match_jax():
    q = torch.zeros(1, 3, 4, 8)
    k = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        flash_attention(q, k, k)
    q = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="window must be >= 0"):
        flash_attention(q, k, k, window=-1)
    with pytest.raises(ValueError, match="T == S"):
        flash_attention(q, torch.zeros(1, 2, 6, 8), torch.zeros(1, 2, 6, 8),
                        window=2)


def test_window_turns_causal_on():
    q, k, v, _ = _inputs(2, 1, 2, 2, 10, 10, 4)
    ts = [torch.from_numpy(a) for a in (q, k, v)]
    a = flash_attention(*ts, causal=False, window=3)
    b = flash_attention(*ts, causal=True, window=3)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# on the card: the Hopper kernels against the plain versions
# ---------------------------------------------------------------------------

# (B, H, KVH, T, S, D, causal, window): tile boundaries (T, S not multiples
# of 64), every head-dim bucket (32, 64, 128) and a padded one (40), GQA,
# causal cross shapes both ways (T > S leaves rows that see no key)
CUDA_CASES = {
    "dense_d64": (2, 3, 3, 130, 130, 64, False, 0),
    "causal_d32": (2, 2, 2, 70, 70, 32, True, 0),
    "window_d128_gqa4": (1, 8, 2, 200, 200, 128, True, 50),
    "causal_gqa2_d40": (2, 4, 2, 96, 96, 40, True, 0),
    "causal_cross_d64": (1, 2, 1, 70, 200, 64, True, 0),
    "causal_t_gt_s_d64": (1, 2, 2, 100, 40, 64, True, 0),
    "dense_cross_d16": (2, 2, 2, 5, 77, 16, False, 0),
    # a long walk through the kernels' two-stage tile ring, ending ragged
    "causal_gqa4_long_d128": (1, 8, 2, 1030, 1030, 128, True, 0),
}


def _rel_err(got, want):
    return float((got.detach().float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", list(CUDA_CASES))
def test_kernels_match_plain_on_cuda(case, dtype):
    """O, LSE, dq, dk and dv of the kernels against the plain versions on
    the same CUDA tensors, relative to the largest |value|: fp32 2e-5
    (summation order over up to 200 keys); bf16 2^-7 and fp16 2^-10 for O
    and the gradients (both sides compute in fp32 and round once to the
    storage type, so they may differ by one step of it) and 2e-5 for the
    fp32 LSE."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    B, H, KVH, T, S, D, causal, window = CUDA_CASES[case]
    dt = getattr(torch, dtype)
    q, k, v, w = (torch.from_numpy(a).cuda().to(dt)
                  for a in _inputs(3, B, H, KVH, T, S, D))
    scale = D ** -0.5
    n0 = dict(_kernels.LAUNCHES)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    out = flash_attention(qr, kr, vr, causal=causal, window=window)
    out.backward(w)
    torch.cuda.synchronize()
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert _kernels.LAUNCHES[name] == n0.get(name, 0) + 1, name
    want_o, want_lse = _torch_flash_fwd(q, k, v, scale, causal, window)
    from mxnet_tpu_torch.ops.flash_attention import _cuda_flash_fwd
    _, got_lse = _cuda_flash_fwd(q, k, v, scale, causal, window)
    want = _torch_flash_bwd(q, k, v, want_o, want_lse, w, scale, causal,
                            window)
    tol = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -7,
           torch.float16: 2.0 ** -10}[dt]
    assert _rel_err(got_lse, want_lse) <= 2e-5
    for name, g, x in zip(("out", "dq", "dk", "dv"),
                          (out, qr.grad, kr.grad, vr.grad),
                          (want_o, *want)):
        assert g.dtype == dt and g.shape == x.shape, name
        assert _rel_err(g, x) <= tol, (name, _rel_err(g, x))


def test_head_dim_over_128_and_float16_compute_on_cuda():
    """On the card the port computes what the JAX package computes: head
    dim 160 through the plain versions (chosen by shape, counted as
    ``flash_plain_fwd``/``flash_plain_bwd``, no kernel launched), equal to
    them; float16 through the kernels, within one float16 step (2^-10 of
    the largest |value|) of the plain versions. Mixed types and tensors
    on two devices are still refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_plain_fwd",
             "flash_plain_bwd")
    for D, dt, plain in ((160, torch.float32, True),
                         (16, torch.float16, False)):
        q, _, _, w = (torch.from_numpy(a).cuda().to(dt)
                      for a in _inputs(4, 1, 1, 1, 4, 4, D))
        leaves = [q.clone().requires_grad_() for _ in range(3)]
        n0 = dict(_kernels.LAUNCHES)
        out = flash_attention(*leaves)
        out.backward(w)
        torch.cuda.synchronize()
        got = [_kernels.LAUNCHES[k] - n0.get(k, 0) for k in names]
        assert got == ([0, 0, 0, 1, 1] if plain else [1, 1, 1, 0, 0]), got
        want_o, lse = _torch_flash_fwd(q, q, q, D ** -0.5, False)
        want = _torch_flash_bwd(q, q, q, want_o, lse, w, D ** -0.5, False)
        tol = 0.0 if plain else 2.0 ** -10
        for g, x in zip([out] + [t.grad for t in leaves], [want_o, *want]):
            assert g.dtype == dt and g.shape == x.shape
            assert _rel_err(g, x) <= tol
    q = torch.zeros(1, 1, 4, 16, device="cuda")
    with pytest.raises(TypeError, match="the same for q, k, v"):
        flash_attention(q, q.half(), q)
    with pytest.raises(ValueError, match="is on cpu"):
        flash_attention(q, q.cpu(), q)
