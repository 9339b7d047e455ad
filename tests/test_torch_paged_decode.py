"""Port parity: ``mxnet_tpu_torch.ops.flash_attention.paged_decode_attention``
against the JAX package's ``paged_decode_attention`` (its plain jnp path
on the CPU), on the same numpy inputs.

Tolerance (float32): 1e-5 absolute and relative. Both sides compute a
float32 softmax over at most a few dozen positions; they differ only in
summation order, which moves the outputs (|out| <= ~3) by ~1e-7. float16
storage: both compute in fp32 from the same float16 values and round the
output once, so they may differ by one float16 step, 2^-10 of the largest
|value|. Head dims 160 and 256 lie past the kernel's 128: both packages
compute them with their plain versions (on a card the port too, counted
as ``paged_decode_plain``).

The Hopper kernels (K3, ``csrc/paged_decode.cu``) split each context into
ranges, one block each, and combine the ranges' partial softmaxes in
ascending order. ``split_model`` below is that arithmetic in plain fp32
torch, held against the JAX package's oracle ``_jnp_paged_decode`` within
1e-5 of the largest |value|: the sums run in another order, across ranges
and 32-position chunks, so only rounding moves. The kernels themselves run
only on a card: the ``*_on_cuda`` tests skip without one (run them there
with ``-k on_cuda``).
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import numpy as np
import pytest
import torch

from mxnet_tpu.ops.flash_attention import _jnp_paged_decode
from mxnet_tpu.ops.flash_attention import \
    paged_decode_attention as jax_paged_decode
from mxnet_tpu_torch.ops import _kernels
from mxnet_tpu_torch.ops.flash_attention import (
    _paged_decode_splits,
    _torch_paged_decode,
    paged_decode_attention,
)

TOL = 1e-5
BS, NUM_BLOCKS, MAX_BLOCKS, B, D = 4, 40, 6, 4, 16

# (query heads, kv heads): group 1, 2, 4 and 16 (multi-query)
HEADS = [(4, 4), (4, 2), (8, 2), (16, 1)]
# context lengths per slot: an empty slot, block boundaries, ragged, and
# one past the table's reach (clipped to MAX_BLOCKS * BS)
LENS = {
    "ctx0": [0, 5, 9, 1],
    "block_boundary": [BS, 2 * BS, MAX_BLOCKS * BS, 3 * BS],
    "ragged": [1, 7, 13, 22],
    "over_table": [MAX_BLOCKS * BS + 3, 2, 11, 0],
}


def _inputs(seed, h, kvh, lens, shuffled=True, d=D):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, h, d).astype(np.float32)
    kp = rs.randn(NUM_BLOCKS, BS, kvh, d).astype(np.float32)
    vp = rs.randn(NUM_BLOCKS, BS, kvh, d).astype(np.float32)
    ids = np.arange(1, B * MAX_BLOCKS + 1)
    if shuffled:  # tables scattered across the pool, never block 0
        ids = rs.permutation(np.arange(1, NUM_BLOCKS))[:B * MAX_BLOCKS]
    tables = ids.reshape(B, MAX_BLOCKS).astype(np.int32)
    return q, kp, vp, tables, np.asarray(lens, np.int32)


def _both(q, kp, vp, tables, lens, scale=None):
    want = np.asarray(jax_paged_decode(q, kp, vp, tables, lens, scale=scale))
    got = paged_decode_attention(*(torch.from_numpy(a) for a in
                                   (q, kp, vp, tables, lens)), scale=scale)
    return got.numpy(), want


@pytest.mark.parametrize("lens", list(LENS), ids=list(LENS))
@pytest.mark.parametrize("h,kvh", HEADS, ids=[f"g{h // k}" for h, k in HEADS])
def test_matches_jax(h, kvh, lens):
    _kernels.LAUNCHES.clear()
    got, want = _both(*_inputs(0, h, kvh, LENS[lens]))
    assert got.shape == (B, h, D) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    for slot, n in enumerate(LENS[lens]):
        if n == 0:  # empty slots answer zeros, not uniform-weight noise
            assert not got[slot].any()
    assert _kernels.LAUNCHES["paged_decode"] == 0  # CPU: plain version


@pytest.mark.parametrize("head_dim", [160, 256])
def test_head_dim_over_128_matches_jax(head_dim):
    _kernels.LAUNCHES.clear()
    got, want = _both(*_inputs(5, 8, 2, LENS["ctx0"], d=head_dim))
    assert got.shape == (B, 8, head_dim)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert not _kernels.LAUNCHES


@pytest.mark.parametrize("h,kvh", HEADS, ids=[f"g{h // k}" for h, k in HEADS])
def test_float16_matches_jax(h, kvh):
    q, kp, vp, tables, lens = _inputs(6, h, kvh, LENS["ragged"])
    q, kp, vp = (a.astype(np.float16) for a in (q, kp, vp))
    want = np.asarray(jax_paged_decode(q, kp, vp, tables, lens),
                      np.float32)
    got = paged_decode_attention(*(torch.from_numpy(a) for a in
                                   (q, kp, vp, tables, lens)))
    assert got.dtype == torch.float16
    assert np.abs(got.float().numpy() - want).max() \
        <= 2.0 ** -10 * np.abs(want).max()


def test_unshuffled_tables_and_explicit_scale():
    got, want = _both(*_inputs(1, 8, 2, LENS["ragged"], shuffled=False),
                      scale=0.3)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_single_position_context_returns_that_value():
    """ctx == 1: softmax over one position is exactly that row of V."""
    q, kp, vp, tables, _ = _inputs(2, 4, 2, LENS["ragged"])
    lens = np.ones(B, np.int32)
    got, want = _both(q, kp, vp, tables, lens)
    first = vp[tables[:, 0], 0]                      # (B, KVH, D)
    np.testing.assert_allclose(got, np.repeat(first, 2, axis=1),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_heads_must_divide():
    q, kp, vp, tables, lens = _inputs(0, 4, 4, LENS["ragged"])
    with pytest.raises(ValueError, match="multiple of kv heads"):
        paged_decode_attention(torch.zeros(B, 3, D), torch.from_numpy(kp),
                               torch.from_numpy(vp),
                               torch.from_numpy(tables),
                               torch.from_numpy(lens))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("h,kvh", HEADS, ids=[f"g{h // k}" for h, k in HEADS])
def test_kernel_matches_plain_on_cuda(h, kvh, dtype):
    """On the card: the Hopper kernel against the plain version on the
    same CUDA tensors. fp32: 1e-5 (summation order). bf16 and fp16: both
    read the same 16-bit values and compute in fp32, then round once to
    the storage type, so they may differ by one step of it in the output:
    1e-2 abs + rel in bf16, 2^-10 in fp16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dt = getattr(torch, dtype)
    tol = {torch.float32: TOL, torch.bfloat16: 1e-2,
           torch.float16: 2.0 ** -10}[dt]
    for lens in LENS.values():
        args = [torch.from_numpy(a).cuda()
                for a in _inputs(3, h, kvh, lens)]
        args[:3] = [a.to(dt) for a in args[:3]]
        n0 = _kernels.LAUNCHES["paged_decode"]
        got = paged_decode_attention(*args)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES["paged_decode"] == n0 + 1
        want = _torch_paged_decode(*args, 1.0 / D ** 0.5)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


def test_head_dim_over_128_computes_on_cuda():
    """On the card, head dim 160 runs the plain version (chosen by shape,
    counted as ``paged_decode_plain``, no kernel launched), as the JAX
    package runs its jnp path there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = [torch.from_numpy(a).cuda()
            for a in _inputs(7, 8, 2, LENS["ctx0"], d=160)]
    n0 = dict(_kernels.LAUNCHES)
    got = paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["paged_decode_plain"] \
        == n0.get("paged_decode_plain", 0) + 1
    assert _kernels.LAUNCHES["paged_decode"] == n0.get("paged_decode", 0)
    want = _torch_paged_decode(*args, 160 ** -0.5)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# K3's split-and-combine arithmetic
# ---------------------------------------------------------------------------

CHUNK = 32  # context positions one ring stage of the split kernel holds
NEG_INF = -1e30


def split_model(q, kp, vp, tables, lens, scale, nsplit):
    """K3's arithmetic in fp32: each context (clamped to the table's reach)
    cut into ``nsplit`` ranges of ceil(ctx / nsplit) positions rounded up
    to whole pool blocks; each range an online softmax over chunks of
    CHUNK positions, giving (m, l, acc); an empty range (m, l) =
    (-1e30, 0); then M = max m, L = sum l e^(m - M) and
    O = sum acc e^(m - M) / max(L, 1e-30), the ranges in ascending order,
    and zeros where the context is empty."""
    B, H, D = q.shape
    _, bs, kvh, _ = kp.shape
    mb = tables.shape[1]
    heads = torch.arange(H) // (H // kvh)
    out = torch.zeros(B, H, D)
    for b in range(B):
        ctx = min(max(int(lens[b]), 0), mb * bs)
        if ctx == 0:
            continue
        per = -(-(-(-ctx // nsplit)) // bs) * bs
        pos = torch.arange(ctx)
        rows = tables[b, pos // bs].long() * bs + pos % bs
        k = kp.reshape(-1, kvh, D)[rows][:, heads]  # (ctx, H, D)
        v = vp.reshape(-1, kvh, D)[rows][:, heads]
        parts = []
        for s in range(nsplit):
            m, l = torch.full((H,), NEG_INF), torch.zeros(H)
            acc = torch.zeros(H, D)
            for c0 in range(s * per, min(ctx, s * per + per), CHUNK):
                c1 = min(ctx, s * per + per, c0 + CHUNK)
                sc = torch.einsum("hd,thd->ht", q[b], k[c0:c1]) * scale
                m_new = torch.maximum(m, sc.amax(-1))
                p = torch.exp(sc - m_new[:, None])
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[:, None] \
                    + torch.einsum("ht,thd->hd", p, v[c0:c1])
                m = m_new
            parts.append((m, l, acc))
        big_m = torch.stack([m for m, _, _ in parts]).amax(0)
        big_l, o = torch.zeros(H), torch.zeros(H, D)
        for m, l, acc in parts:
            w = torch.exp(m - big_m)
            big_l = big_l + l * w
            o = o + acc * w[:, None]
        out[b] = o / torch.clamp(big_l, min=1e-30)[:, None]
    return out


SPLIT_BS, SPLIT_MB = 4, 40  # table reach 160: several chunks a range


def _split_lens(nsplit):
    """Per slot: empty, one position, one pool block, an exact multiple of
    nsplit * block_size (clamped to the table's reach when none fits), a
    ragged length and the table's full reach."""
    exact = 80 if 80 % (nsplit * SPLIT_BS) == 0 else nsplit * SPLIT_BS
    return [0, 1, SPLIT_BS, exact, 23, SPLIT_MB * SPLIT_BS]


def _split_inputs(seed, h, kvh, lens, d=D):
    rs = np.random.RandomState(seed)
    b = len(lens)
    q = rs.randn(b, h, d).astype(np.float32)
    kp = rs.randn(b * SPLIT_MB + 1, SPLIT_BS, kvh, d).astype(np.float32)
    vp = rs.randn(b * SPLIT_MB + 1, SPLIT_BS, kvh, d).astype(np.float32)
    tables = rs.permutation(np.arange(1, b * SPLIT_MB + 1)) \
        .reshape(b, SPLIT_MB).astype(np.int32)
    return q, kp, vp, tables, np.asarray(lens, np.int32)


SPLIT_HEADS = [(2, 2), (8, 2), (16, 1)]  # groups 1, 4 and 16


@pytest.mark.parametrize("nsplit", [1, 4, SPLIT_MB + 5],
                         ids=["nsplit1", "nsplit4", "more_splits_than_blocks"])
@pytest.mark.parametrize("h,kvh", SPLIT_HEADS,
                         ids=[f"g{h // k}" for h, k in SPLIT_HEADS])
def test_split_model_matches_jax_oracle(h, kvh, nsplit):
    q, kp, vp, tables, lens = _split_inputs(8, h, kvh, _split_lens(nsplit))
    scale = D ** -0.5
    want = np.asarray(_jnp_paged_decode(q, kp, vp, tables, lens, scale))
    got = split_model(*(torch.from_numpy(a) for a in
                        (q, kp, vp, tables, lens)), scale, nsplit).numpy()
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    assert not got[0].any() and not want[0].any()  # ctx 0: zeros


@pytest.mark.parametrize("b,h,kvh,mb,sms,want", [
    (8, 16, 1, 512, 132, 33),   # the serving slice: 264 blocks
    (8, 32, 8, 512, 132, 5),    # group 4: 8 x 8 blocks a split
    (4, 16, 1, 6, 132, 6),      # at most one split per table entry
    (64, 64, 1, 512, 132, 2),   # group 64: 4 blocks a (sequence, kv head)
    (300, 16, 1, 512, 132, 1),  # the grid fills the card unsplit
])
def test_split_count_depends_on_shapes_and_sms_only(b, h, kvh, mb, sms,
                                                    want):
    assert _paged_decode_splits(b, h, kvh, mb, sms) == want


@pytest.mark.parametrize("head_dim", [D, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("h,kvh", SPLIT_HEADS,
                         ids=[f"g{h // k}" for h, k in SPLIT_HEADS])
def test_kernel_edge_lengths_repeat_on_cuda(h, kvh, dtype, head_dim):
    """On the card, at the split model's edge lengths (empty, 1, one pool
    block, a multiple of the splits, ragged, the table's reach): K3
    against the plain version (fp32 1e-5; bf16 1e-2 and fp16 2^-10 abs +
    rel, one rounding of the output apart), zeros where the context is
    empty, one launch of each kernel, and two calls equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dt = getattr(torch, dtype)
    tol = {torch.float32: TOL, torch.bfloat16: 1e-2,
           torch.float16: 2.0 ** -10}[dt]
    mb = SPLIT_MB
    nsplit = _paged_decode_splits(
        6, h, kvh, mb, torch.cuda.get_device_properties(0)
        .multi_processor_count)
    args = [torch.from_numpy(a).cuda() for a in _split_inputs(
        9, h, kvh, _split_lens(nsplit), d=head_dim)]
    args[:3] = [a.to(dt) for a in args[:3]]
    n0 = dict(_kernels.LAUNCHES)
    first = paged_decode_attention(*args)
    second = paged_decode_attention(*args)
    torch.cuda.synchronize()
    for name in ("paged_decode", "paged_decode_combine"):
        assert _kernels.LAUNCHES[name] == n0.get(name, 0) + 2, name
    want = _torch_paged_decode(*args, 1.0 / head_dim ** 0.5)
    torch.testing.assert_close(first.float(), want.float(), rtol=tol,
                               atol=tol)
    assert not first[0].any()
    assert torch.equal(first, second)
