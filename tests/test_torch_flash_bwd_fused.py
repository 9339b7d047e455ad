"""Port parity: the fused flash-attention backward (K6) and its route.

- The port's plain backward ``_torch_flash_bwd`` (the plain version of K6,
  as of K2) against the JAX package's Pallas K6, ``_pallas_flash_bwd``,
  run in TPU interpret mode on the CPU, and against the scan backward of
  ``_flash_bwd_rule``, on the same numpy inputs and the oracle's O and
  LSE: dense, causal, sliding window, and native grouped-query heads with
  groups 2 and 4. Tolerance (float32) 1e-5 absolute and relative: the
  three compute the same float32 products over at most 32 keys and differ
  in summation order only (~1e-6).
- The route, ``_bwd_kernel_for(T, fused)``, against the reference's
  ``_flash_bwd_rule`` case by case (``MXTPU_FLASH_BWD`` unset, ``split``,
  ``fused``; T under, at and over the cap; ``native_gqa`` both ways),
  with the reference's kernels replaced by recorders as
  ``tests/test_attention_models.py`` does and both caps set alike.
- On a card (``*_on_cuda``, skipped here): K6 against its plain version
  in float32 and bfloat16, its three gradients equal over two calls, and
  which kernels a backward launches.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mxnet_tpu.ops import flash_attention as jfa
from mxnet_tpu_torch.ops import _kernels
from mxnet_tpu_torch.ops import flash_attention as fa

TOL = 1e-5

# name: (B, H, KVH, T, D, causal, window); self-attention (T == S) as the
# fused Pallas kernel takes it, T a multiple of its 8-row blocks
MODES = {
    "dense": (2, 4, 4, 24, 16, False, 0),
    "causal": (2, 4, 4, 32, 16, True, 0),
    "window": (2, 4, 4, 32, 16, True, 8),
    "gqa2_causal": (2, 4, 2, 24, 16, True, 0),
    "gqa4_window": (1, 8, 2, 32, 8, True, 8),
}


def _inputs(seed, B, H, KVH, T, D):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, H, T, D).astype(np.float32)
    k = rs.randn(B, KVH, T, D).astype(np.float32)
    v = rs.randn(B, KVH, T, D).astype(np.float32)
    g = rs.randn(B, H, T, D).astype(np.float32)
    return q, k, v, g


@pytest.mark.parametrize("mode", list(MODES))
def test_plain_backward_matches_pallas_k6_and_scan(mode):
    B, H, KVH, T, D, causal, window = MODES[mode]
    q, k, v, g = _inputs(0, B, H, KVH, T, D)
    scale = D ** -0.5
    kf, vf = jfa._repeat_kv(q, k, v)
    o, lse = jfa._jnp_flash_fwd(q, kf, vf, scale, causal, window)
    o, lse = np.array(o), np.array(lse)
    with pltpu.force_tpu_interpret_mode():
        k6 = jfa._pallas_flash_bwd(q, k, v, o, lse, g, scale, causal, bq=8,
                                   bk=8, window=window)
    k6 = [np.array(a) for a in k6]
    scan = [np.array(a) for a in jfa._flash_bwd_rule(
        scale, causal, 8, window, False, (q, k, v, o, lse), g)]
    got = fa._torch_flash_bwd(*(torch.from_numpy(a) for a in
                                (q, k, v, o, lse, g)), scale, causal,
                              window, block_size=8)
    for name, t, want_k6, want_scan in zip(("dq", "dk", "dv"), got, k6,
                                           scan):
        assert t.shape == want_k6.shape and t.dtype == torch.float32, name
        np.testing.assert_allclose(t.numpy(), want_k6, rtol=TOL, atol=TOL,
                                   err_msg=f"{name} vs Pallas K6")
        np.testing.assert_allclose(t.numpy(), want_scan, rtol=TOL, atol=TOL,
                                   err_msg=f"{name} vs scan")


# the reference's routing with both caps at 16 and 4 query heads per kv
# head: T = 4 fits even flattened (group * T = 16), T = 8 fits only
# unflattened, T = 16 is at the cap, T = 20 over it
CAP = 16


def _reference_route(monkeypatch, T, native):
    calls = []

    def recorder(kind):
        def run(q, k, v, out, lse, g, scale, causal, bq=512, bk=512,
                window=0):
            calls.append(kind)
            return jnp.zeros_like(q), jnp.zeros_like(k), jnp.zeros_like(v)
        return run

    monkeypatch.setattr(jfa, "_pallas_ready", lambda q, k, causal, bs: True)
    monkeypatch.setattr(jfa, "_PALLAS_BWD_MAX_T", CAP)
    monkeypatch.setattr(jfa, "_pallas_flash_bwd_split", recorder("split"))
    monkeypatch.setattr(jfa, "_pallas_flash_bwd", recorder("fused"))
    q = jnp.ones((1, 8, T, 8))
    k = jnp.ones((1, 2, T, 8))
    jfa._flash_bwd_rule(1.0, True, 4, 0, native,
                        (q, k, k, jnp.ones_like(q), jnp.ones((1, 8, T))),
                        jnp.ones_like(q))
    assert len(calls) == 1, calls
    return calls[0]


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("T", [4, 8, 16, 20])
@pytest.mark.parametrize("env", [None, "split", "fused"])
def test_route_matches_reference(monkeypatch, env, T, native):
    if env is None:
        monkeypatch.delenv("MXTPU_FLASH_BWD", raising=False)
    else:
        monkeypatch.setenv("MXTPU_FLASH_BWD", env)
    want = _reference_route(monkeypatch, T, native)
    monkeypatch.setattr(fa, "_FUSED_BWD_MAX_T", CAP)
    assert fa._bwd_kernel_for(T, env == "fused") == want
    assert want == ("fused" if env == "fused" and T <= CAP else "split")


def test_cap_is_the_reference_cap():
    assert fa._FUSED_BWD_MAX_T == jfa._PALLAS_BWD_MAX_T == 8192
    assert fa._bwd_kernel_for(8192, True) == "fused"
    assert fa._bwd_kernel_for(8193, True) == "split"
    assert fa._bwd_kernel_for(128, False) == "split"


def test_cpu_backward_takes_the_plain_version_under_fused(monkeypatch):
    """On CPU tensors both routes are the plain version: the gradients
    under ``fused`` equal those under ``split`` and nothing launches."""
    q, k, v, g = _inputs(1, 1, 4, 2, 16, 8)

    def grads():
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        fa.flash_attention(*ts, causal=True, native_gqa=True).backward(
            torch.from_numpy(g))
        return [t.grad for t in ts]

    _kernels.LAUNCHES.clear()
    monkeypatch.setenv("MXTPU_FLASH_BWD", "fused")
    fused = grads()
    monkeypatch.setenv("MXTPU_FLASH_BWD", "split")
    for a, b in zip(fused, grads()):
        assert torch.equal(a, b)
    assert not _kernels.LAUNCHES


# ---------------------------------------------------------------------------
# on the card: K6 against its plain version, and the route it takes
# ---------------------------------------------------------------------------

# (B, H, KVH, T, S, D, causal, window): tile edges, every head-dim bucket
# and a padded one, GQA groups 2 and 4, cross shapes both ways (T > S
# leaves rows that see no key), as the K1/K2 card tests
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


def _cuda_inputs(case, dt):
    B, H, KVH, T, S, D, causal, window = CUDA_CASES[case]
    rs = np.random.RandomState(3)
    q, g = (rs.randn(B, H, T, D).astype(np.float32) for _ in range(2))
    k, v = (rs.randn(B, KVH, S, D).astype(np.float32) for _ in range(2))
    return [torch.from_numpy(a).cuda().to(dt) for a in (q, k, v, g)]


def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CUDA_CASES))
def test_fused_kernel_matches_plain_on_cuda(case, dtype):
    """dq, dk and dv of K6 against the plain backward on the same CUDA
    tensors, relative to the largest |value|: fp32 2e-5 (summation order);
    bf16 2^-7 (both round once to bf16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    *_, D, causal, window = CUDA_CASES[case]
    dt = getattr(torch, dtype)
    q, k, v, g = _cuda_inputs(case, dt)
    scale = D ** -0.5
    out, lse = fa._torch_flash_fwd(q, k, v, scale, causal, window)
    n0 = _kernels.LAUNCHES["flash_bwd_fused"]
    got = fa._cuda_flash_bwd_fused(q, k, v, out, lse, g, scale, causal,
                                   window)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["flash_bwd_fused"] == n0 + 1
    want = fa._torch_flash_bwd(q, k, v, out, lse, g, scale, causal, window)
    tol = 2e-5 if dt == torch.float32 else 2.0 ** -7
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dt and a.shape == b.shape, name
        assert _rel_err(a, b) <= tol, (name, _rel_err(a, b))


@pytest.mark.parametrize("case", ["causal_gqa4_long_d128",
                                  "window_d128_gqa4", "causal_cross_d64"])
def test_fused_kernel_repeats_bit_for_bit_on_cuda(case):
    """K6's dq, dk and dv equal bit for bit over two calls on the same
    tensors: the blocks add into dq in ascending key-tile order, whatever
    order they run in (causal GQA, a sliding window, a bottom-right causal
    cross shape)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    *_, D, causal, window = CUDA_CASES[case]
    q, k, v, g = _cuda_inputs(case, torch.float32)
    scale = D ** -0.5
    out, lse = fa._torch_flash_fwd(q, k, v, scale, causal, window)
    first, second = (fa._cuda_flash_bwd_fused(q, k, v, out, lse, g, scale,
                                              causal, window)
                     for _ in range(2))
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("env,T,want", [
    (None, 200, {"flash_bwd_dq": 1, "flash_bwd_dkv": 1}),
    ("split", 200, {"flash_bwd_dq": 1, "flash_bwd_dkv": 1}),
    ("fused", 200, {"flash_bwd_fused": 1}),
    ("fused", 8192, {"flash_bwd_fused": 1}),
    ("fused", 8200, {"flash_bwd_dq": 1, "flash_bwd_dkv": 1}),
])
def test_backward_route_launches_on_cuda(monkeypatch, env, T, want):
    """The public op's backward launches K6 exactly when the route says
    fused, and K2 otherwise; the forward K1 either way."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if env is None:
        monkeypatch.delenv("MXTPU_FLASH_BWD", raising=False)
    else:
        monkeypatch.setenv("MXTPU_FLASH_BWD", env)
    q = torch.randn(1, 4, T, 16, device="cuda", requires_grad=True)
    kv = torch.randn(1, 2, T, 16, device="cuda", requires_grad=True)
    _kernels.LAUNCHES.clear()
    fa.flash_attention(q, kv, kv, causal=True, native_gqa=True).sum() \
        .backward()
    torch.cuda.synchronize()
    assert dict(_kernels.LAUNCHES) == {"flash_fwd": 1, **want}
