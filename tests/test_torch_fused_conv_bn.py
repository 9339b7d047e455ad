"""Port parity: the fused 1x1-conv + BN-statistics operators of
``mxnet_tpu_torch/ops/fused_conv_bn.py`` against the JAX package.

The plain versions of K4 (``_torch_fused_fwd``) and K5
(``_torch_fused_bwd``) and the port's autograd operators run on the CPU
with the inputs of ``tests/test_fused_conv_bn.py`` (seed 7, M = 128,
K = 64, N = 32), with no prologue and with a prologue with relu on and
off. They are held against the JAX package's ``_fused_fwd_reference`` /
``_fused_bwd_reference`` and its Pallas kernels in interpret mode within
1e-5 (float32; the sides differ in summation order over at most 128
terms). The port's hand-written backward is held against torch autograd
of the plain forward form, as ``test_custom_vjp_matches_autodiff`` does in
the JAX package.

The Hopper kernels run only on a card: the ``*_on_cuda`` tests skip
without one (run them there with ``-k on_cuda``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from mxnet_tpu.ops import fused_conv_bn as J

from mxnet_tpu_torch.ops import _kernels
from mxnet_tpu_torch.ops import fused_conv_bn as F

TOL = 1e-5
MODES = {"plain": (False, False), "prologue_relu": (True, True),
         "prologue": (True, False)}


def _data(M=128, K=64, N=32, seed=7):
    rng = np.random.RandomState(seed)
    return {
        "x": rng.randn(M, K).astype(np.float32),
        "w": (rng.randn(K, N) * 0.1).astype(np.float32),
        "s": (rng.rand(K) + 0.5).astype(np.float32),
        "t": (rng.randn(K) * 0.1).astype(np.float32),
        "dy": rng.randn(M, N).astype(np.float32),
        "dsum": rng.randn(N).astype(np.float32),
        "dssq": (rng.randn(N) * 0.01).astype(np.float32),
    }


DATA = _data()


def _args(mode, lib):
    """(x, w, scale, shift, relu) as ``lib`` arrays (jnp or torch)."""
    pro, relu = MODES[mode]
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    d = {k: conv(v) for k, v in DATA.items()}
    return (d["x"], d["w"], d["s"] if pro else None, d["t"] if pro else None,
            relu)


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("oracle", ["reference", "pallas_interpret"])
@pytest.mark.parametrize("mode", list(MODES))
def test_fwd_matches_jax(mode, oracle):
    jx, jw, js, jt, relu = _args(mode, "jax")
    if oracle == "reference":
        want = J._fused_fwd_reference(jx, jw, js, jt, relu=relu)
    else:
        want = J._fused_fwd_pallas(jx, jw, js, jt, relu=relu, interpret=True)
    got = F._torch_fused_fwd(*_args(mode, "torch"))
    for name, g, w in zip(("y", "ysum", "yssq"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        _close(g, w, what=name)


@pytest.mark.parametrize("oracle", ["reference", "pallas_interpret"])
@pytest.mark.parametrize("mode", list(MODES))
def test_bwd_matches_jax(mode, oracle):
    jx, jw, js, jt, relu = _args(mode, "jax")
    y = J._fused_fwd_reference(jx, jw, js, jt, relu=relu)[0]
    cts = [jnp.asarray(DATA[k]) for k in ("dy", "dsum", "dssq")]
    fn = J._fused_bwd_reference if oracle == "reference" else \
        lambda *a, relu: J._fused_bwd_pallas(*a, relu=relu, interpret=True)
    want = fn(jx, jw, y, js, jt, *cts, relu=relu)
    tx, tw, ts, tt, _ = _args(mode, "torch")
    got = F._torch_fused_bwd(tx, tw, torch.from_numpy(np.array(y)), ts, tt,
                             *[torch.from_numpy(DATA[k])
                               for k in ("dy", "dsum", "dssq")], relu=relu)
    for name, g, w in zip(("dx", "dw", "dscale", "dbias"), got, want):
        if w is None:
            assert g is None, name
            continue
        _close(g, np.asarray(w).reshape(tuple(g.shape)), what=name)


def _stat_loss(outs, lib):
    """sum(y * dy) + sum(ysum * dsum) + sum(yssq * dssq): its gradient
    feeds the stat outputs' cotangents back as given."""
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    cts = [conv(DATA[k]) for k in ("dy", "dsum", "dssq")]
    return sum((o * c).sum() for o, c in zip(outs, cts))


@pytest.mark.parametrize("mode", list(MODES))
def test_autograd_ops_match_jax_custom_vjp(mode):
    """The port's autograd operators (outputs and the gradients of every
    input) against the JAX package's custom_vjp operators."""
    jx, jw, js, jt, relu = _args(mode, "jax")
    if js is None:
        jfn = lambda x, w: J.matmul_stats(x, w)  # noqa: E731
        jargs = (jx, jw)
    else:
        jfn = lambda x, s, t, w: J.scaled_matmul_stats(  # noqa: E731
            x, s, t, w, relu)
        jargs = (jx, js, jt, jw)
    jouts = jfn(*jargs)
    jgrads = jax.grad(lambda *a: _stat_loss(jfn(*a), "jax"),
                      tuple(range(len(jargs))))(*jargs)

    tx, tw, ts, tt, _ = _args(mode, "torch")
    targs = [a.clone().requires_grad_() for a in
             ((tx, tw) if ts is None else (tx, ts, tt, tw))]
    touts = F.matmul_stats(*targs) if ts is None \
        else F.scaled_matmul_stats(*targs, relu=relu)
    tgrads = torch.autograd.grad(_stat_loss(touts, "torch"), targs)
    for g, w in zip(touts, jouts):
        _close(g.detach(), w)
    for i, (g, w) in enumerate(zip(tgrads, jgrads)):
        _close(g, w, tol=1e-4, what=f"grad {i}")


@pytest.mark.parametrize("mode", list(MODES))
def test_custom_backward_matches_autodiff(mode):
    """The hand-derived backward (stat cotangents as per-channel vectors,
    dY = dy + dsum + 2 y dssq) equals torch autograd of the plain form."""
    tx, tw, ts, tt, relu = _args(mode, "torch")
    base = (tx, tw) if ts is None else (tx, ts, tt, tw)
    a1 = [a.clone().requires_grad_() for a in base]
    a2 = [a.clone().requires_grad_() for a in base]
    if ts is None:
        out1 = F.matmul_stats(*a1)
        out2 = F._torch_fused_fwd(a2[0], a2[1], None, None)
    else:
        out1 = F.scaled_matmul_stats(*a1, relu=relu)
        out2 = F._torch_fused_fwd(a2[0], a2[3], a2[1], a2[2], relu=relu)
    g1 = torch.autograd.grad(_stat_loss(out1, "torch"), a1)
    g2 = torch.autograd.grad(_stat_loss(out2, "torch"), a2)
    for i, (a, b) in enumerate(zip(g1, g2)):
        _close(a, b, tol=1e-4, what=f"grad {i}")


@pytest.mark.parametrize("mode", list(MODES))
def test_bf16_plain_matches_jax(mode):
    """bfloat16 storage: y, dx and dw are rounded to bfloat16 on both
    sides after fp32 sums in another order, so they may differ by one
    bfloat16 step (2^-7 of the largest value); the fp32 statistics by
    summation order only."""
    jx, jw, js, jt, relu = _args(mode, "jax")
    jx, jw = jx.astype(jnp.bfloat16), jw.astype(jnp.bfloat16)
    jy, jsum, jssq = J._fused_fwd_reference(jx, jw, js, jt, relu=relu)
    tx, tw, ts, tt, _ = _args(mode, "torch")
    tx, tw = tx.bfloat16(), tw.bfloat16()
    ty, tsum, tssq = F._torch_fused_fwd(tx, tw, ts, tt, relu=relu)
    assert ty.dtype == torch.bfloat16 and tsum.dtype == torch.float32

    def rel(g, w):
        g = g.float().numpy() if isinstance(g, torch.Tensor) else g
        w = np.asarray(w, np.float32)
        return np.abs(g - w).max() / np.abs(w).max()

    assert rel(ty, jy) <= 2.0 ** -7
    assert rel(tsum, jsum) <= 1e-4 and rel(tssq, jssq) <= 1e-4
    cts = [DATA[k] for k in ("dy", "dsum", "dssq")]
    jct = [jnp.asarray(cts[0]).astype(jnp.bfloat16)] + \
        [jnp.asarray(c) for c in cts[1:]]
    tct = [torch.from_numpy(cts[0]).bfloat16()] + \
        [torch.from_numpy(c) for c in cts[1:]]
    want = J._fused_bwd_reference(jx, jw, jy, js, jt, *jct, relu=relu)
    got = F._torch_fused_bwd(tx, tw, ty, ts, tt, *tct, relu=relu)
    for name, g, w in zip(("dx", "dw", "dscale", "dbias"), got, want):
        if w is not None:
            lim = 2.0 ** -7 if name in ("dx", "dw") else 1e-4
            assert rel(g, w) <= lim, name


def test_cpu_tensors_take_the_plain_version():
    before = dict(_kernels.LAUNCHES)
    x, w, s, t, _ = _args("prologue_relu", "torch")
    y, ysum, yssq = F.scaled_matmul_stats(x.requires_grad_(), s, t, w)
    (y.sum() + ysum.sum()).backward()
    y2, _, _ = F.matmul_stats(x, w)
    assert dict(_kernels.LAUNCHES) == before
    _close(y.detach(), F._torch_fused_fwd(x.detach(), w, s, t, True)[0])
    assert y2.dtype == torch.float32


def test_stats_compose_to_batch_norm():
    """matmul_stats + BatchNorm arithmetic on its sums reproduces the
    port's batch_norm in training mode (as test_bn_equivalence_through_
    stats does for the JAX package)."""
    from mxnet_tpu_torch.ops import nn as nn_ops

    rng = np.random.RandomState(3)
    M, K, N = 64, 16, 8
    x = torch.from_numpy(rng.randn(M, K).astype(np.float32))
    w = torch.from_numpy((rng.randn(K, N) * 0.3).astype(np.float32))
    g = torch.from_numpy((rng.rand(N) + 0.5).astype(np.float32))
    b = torch.from_numpy(rng.randn(N).astype(np.float32))
    y, ysum, yssq = F.matmul_stats(x, w)
    mean = ysum / M
    var = torch.clamp(yssq / M - mean * mean, min=0.0)
    out_fused = (y - mean) * torch.rsqrt(var + 1e-3) * g + b
    out_bn, _, _ = nn_ops.batch_norm(
        (x @ w).reshape(M, N, 1, 1), g, b, torch.zeros(N), torch.ones(N),
        training=True, fix_gamma=False, axis=1)
    _close(out_fused, out_bn.reshape(M, N), tol=1e-4)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# kernel vs plain on the card, relative to the largest |value| of each
# output: fp32 differs by summation order only; bf16 y, dx, dw are rounded
# once on both sides (one bf16 step, 2^-7 of the largest value) while the
# statistics stay fp32 (order only, 1e-4 leaves room for one flipped
# rounding of a bf16 operand)
CUDA_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0 ** -7, 1e-4)}
CUDA_SHAPES = {"small": (128, 64, 32), "ragged": (1000, 72, 40),
               "odd": (1000, 37, 23), "stage4": (6272, 2048, 512)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("shape", list(CUDA_SHAPES))
def test_kernels_match_plain_on_cuda(shape, mode, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dt = getattr(torch, dtype)
    M, K, N = CUDA_SHAPES[shape]
    d = {k: torch.from_numpy(v).cuda() for k, v in
         _data(M, K, N, seed=11).items()}
    pro, relu = MODES[mode]
    s, t = (d["s"], d["t"]) if pro else (None, None)
    x, w, dy = d["x"].to(dt), d["w"].to(dt), d["dy"].to(dt)
    n0 = dict(_kernels.LAUNCHES)
    got = F._cuda_fused_fwd(x, w, s, t, relu)
    want = F._torch_fused_fwd(x, w, s, t, relu)
    y = want[0]
    got_b = (F._cuda_fused_dx(x, w, y, s, t, dy, d["dsum"], d["dssq"], relu)
             + (F._cuda_fused_dw(x, w, y, s, t, dy, d["dsum"], d["dssq"],
                                 relu),))
    torch.cuda.synchronize()
    dx, dw, dsc, dbi = F._torch_fused_bwd(x, w, y, s, t, dy, d["dsum"],
                                          d["dssq"], relu)
    lim_t, lim_f = CUDA_TOL[dt]
    for name, g, r, lim in (("y", got[0], want[0], lim_t),
                            ("ysum", got[1], want[1], lim_f),
                            ("yssq", got[2], want[2], lim_f),
                            ("dx", got_b[0], dx, lim_t),
                            ("dscale", got_b[1], dsc, lim_f),
                            ("dbias", got_b[2], dbi, lim_f),
                            ("dw", got_b[3], dw, lim_t)):
        if r is None:
            assert g is None
            continue
        assert g.dtype == r.dtype and g.shape == r.shape, name
        err = float((g.float() - r.float()).abs().max())
        assert err <= lim * float(r.float().abs().max()), (name, err)
    for k in ("fused_fwd", "fused_dw", "fused_dx"):
        assert _kernels.LAUNCHES[k] == n0.get(k, 0) + 1


def test_autograd_ops_launch_kernels_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, w, s, t, _ = (a if a is None or isinstance(a, bool) else a.cuda()
                     for a in _args("prologue_relu", "torch"))
    n0 = dict(_kernels.LAUNCHES)
    args = [a.clone().requires_grad_() for a in (x, s, t, w)]
    outs = F.scaled_matmul_stats(*args, relu=True)
    grads = torch.autograd.grad(_stat_loss(
        [o.cpu() for o in outs], "torch"), args)
    assert all(g.is_cuda for g in grads)
    for k in ("fused_fwd", "fused_dw", "fused_dx"):
        assert _kernels.LAUNCHES[k] == n0.get(k, 0) + 1


def test_kernel_refuses_what_it_cannot_take_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.randn(16, 8, device="cuda", dtype=torch.float16)
    w = torch.randn(8, 4, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        F.matmul_stats(x, w)
    with pytest.raises(ValueError, match="x .M, K. and w .K, N."):
        F.matmul_stats(x.float(), w.float().t())
