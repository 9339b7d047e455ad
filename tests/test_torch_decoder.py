"""Port parity: ``mxnet_tpu_torch.serving.TransformerDecoderLM`` carries
the JAX net's weights (``params_from_numpy``) and must compute the same
function on the CPU: the dense ``forward_fn``, ``prefill_fn`` (logits and
the K/V it scatters into the pool) and a chain of ``decode_step_fn``
steps, each against the JAX counterpart, plus decode against the port's
own dense forward.

Tolerance (float32): 1e-5 absolute and relative on logits (|logit| is
~0.1-1 here); the two packages differ only in summation order and in
LayerNorm's rsqrt-vs-divide rounding, ~1e-7 per value.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.serving import TransformerDecoderLM as JaxLM
from mxnet_tpu_torch.serving import (
    PagedKVCache,
    TransformerDecoderLM,
    params_from_numpy,
)

TOL = 1e-5
VOCAB, MAX_SEQ, BS, NUM_BLOCKS = 48, 64, 4, 40
PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6], list(range(2, 13))]
STEPS = 7


def _pair(kv_heads, device="cpu"):
    kw = dict(vocab_size=VOCAB, num_layers=2, d_model=32, num_heads=4,
              kv_heads=kv_heads, max_seq=MAX_SEQ, seed=0)
    jnet = JaxLM(**kw)
    tree = {k: ([{n: np.asarray(a) for n, a in lyr.items()} for lyr in v]
                if k == "layers" else np.asarray(v))
            for k, v in jnet.params().items()}
    return jnet, TransformerDecoderLM(
        **kw, device=device, params=params_from_numpy(tree, device))


@pytest.fixture(scope="module", params=[2, 1], ids=["gqa_kv2", "mqa_kv1"])
def nets(request):
    return _pair(request.param)


def _close(got, want):
    got, want = (a.cpu() if isinstance(a, torch.Tensor) else a
                 for a in (got, want))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=TOL, atol=TOL)


def test_params_carry_keeps_orientation(nets):
    jnet, tnet = nets
    jp, tp = jnet.params(), tnet.params()
    assert tp["layers"][0]["wq"].shape == (32, 32)
    assert tp["layers"][0]["wk"].shape == (32, tnet.kv_heads * 8)
    assert tp["head"].shape == (32, VOCAB)  # (in, out): h @ w, no transpose
    np.testing.assert_array_equal(tp["layers"][1]["w1"].numpy(),
                                  np.asarray(jp["layers"][1]["w1"]))
    assert tnet.decode_dims() == jnet.decode_dims()
    assert tnet.spec() == jnet.spec()


def test_forward_matches_jax(nets):
    jnet, tnet = nets
    toks = np.random.RandomState(0).randint(0, VOCAB, (3, 17)).astype(
        np.int32)
    want = jax.jit(jnet.forward_fn())(jnet.params(), toks)
    got = tnet.forward_fn()(tnet.params(), torch.from_numpy(toks))
    assert got.shape == (3, 17, VOCAB)
    _close(got, want)


def _tables():
    """Each sequence's first 6 blocks (enough for prompt + STEPS) shuffled
    across the pool; the rest of each row is the null block."""
    n, used = len(PROMPTS), 6
    ids = np.random.RandomState(7).permutation(np.arange(1, NUM_BLOCKS))
    tables = np.zeros((n, -(-MAX_SEQ // BS)), np.int32)
    tables[:, :used] = ids[:n * used].reshape(n, used)
    return tables


def _prefill_both(jnet, tnet, tables, bucket=16):
    """Prefill every prompt into both packages' pools; return the pools
    and each prompt's prefill logits from both sides."""
    dims = jnet.decode_dims()
    shape = (dims["layers"], NUM_BLOCKS, BS, dims["kv_heads"],
             dims["head_dim"])
    jk, jv = jnp.zeros(shape), jnp.zeros(shape)
    dev = tnet.device
    cache = PagedKVCache(dims["layers"], dims["kv_heads"], dims["head_dim"],
                         max_seq=MAX_SEQ, num_blocks=NUM_BLOCKS,
                         block_size=BS, device=dev)
    tk, tv = cache.pools()
    jpre, tpre = jax.jit(jnet.prefill_fn()), tnet.prefill_fn()
    logits = []
    for i, p in enumerate(PROMPTS):
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :len(p)] = p
        length = np.array([len(p)], np.int32)
        jl, jk, jv = jpre(jnet.params(), padded, jk, jv, tables[i:i + 1],
                          length)
        tl, tk2, tv2 = tpre(tnet.params(), torch.from_numpy(padded).to(dev),
                            tk, tv, torch.from_numpy(tables[i:i + 1]).to(dev),
                            torch.from_numpy(length).to(dev))
        assert tk2 is tk and tv2 is tv  # pools updated in place
        logits.append((tl, jl))
    return (jk, jv), (tk, tv), logits


def test_prefill_logits_and_pool_match_jax(nets):
    jnet, tnet = nets
    (jk, jv), (tk, tv), logits = _prefill_both(jnet, tnet, _tables())
    for tl, jl in logits:
        assert tl.shape == (1, VOCAB)
        _close(tl, jl)
    # every real block matches (block 0 takes colliding pad writes whose
    # winner is unspecified on both sides)
    _close(tk[:, 1:], np.asarray(jk)[:, 1:])
    _close(tv[:, 1:], np.asarray(jv)[:, 1:])


def test_decode_chain_matches_jax_and_dense(nets):
    _decode_chain(*nets)


@pytest.mark.parametrize("kv_heads", [2, 1], ids=["gqa_kv2", "mqa_kv1"])
def test_decode_chain_on_cuda_matches_jax(kv_heads):
    """The same chain with the port on the card: every decode step runs
    the Hopper paged-decode kernel (head_dim 8, groups 2 and 4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mxnet_tpu_torch.ops import _kernels

    n0 = _kernels.LAUNCHES["paged_decode"]
    _decode_chain(*_pair(kv_heads, "cuda"))
    assert _kernels.LAUNCHES["paged_decode"] - n0 == STEPS * 2  # 2 layers


def _decode_chain(jnet, tnet):
    """Prefill both packages, then STEPS decode steps fed the same tokens:
    logits agree step by step, pools agree, and the port's decode logits
    equal its own dense forward at every position."""
    dev = tnet.device
    tables = _tables()
    (jk, jv), (tk, tv), logits = _prefill_both(jnet, tnet, tables)
    jstep, tstep = jax.jit(jnet.decode_step_fn()), tnet.decode_step_fn()
    n = len(PROMPTS)
    pos = np.array([len(p) for p in PROMPTS], np.int32)
    token = np.array([int(np.argmax(np.asarray(j))) for _, j in logits],
                     np.int32)
    active = np.array([True, False, True])  # slot 1 sits out: null writes
    seqs = [list(p) for p in PROMPTS]
    step_logits = []
    for _ in range(STEPS):
        jl, jk, jv = jstep(jnet.params(), token, pos, jk, jv, tables,
                           active)
        t_tok, t_pos, t_tab, t_act = (torch.from_numpy(a).to(dev) for a in
                                      (token, pos, tables, active))
        tl, tk, tv = tstep(tnet.params(), t_tok, t_pos, tk, tv, t_tab, t_act)
        _close(tl, jl)
        step_logits.append(tl)
        for s in range(n):
            if active[s]:
                seqs[s].append(int(token[s]))
        pos = pos + active.astype(np.int32)
        token = np.asarray(jl).argmax(-1).astype(np.int32)
    _close(tk[:, 1:], np.asarray(jk)[:, 1:])
    # decode == dense recompute at every position the chain produced
    fwd = tnet.forward_fn()
    for s in np.flatnonzero(active):
        dense = fwd(tnet.params(), torch.tensor([seqs[s]], device=dev))[0]
        plen = len(PROMPTS[s])
        _close(logits[s][0][0], dense[plen - 1])  # prefill: last prompt pos
        for i, tl in enumerate(step_logits):  # step i fed position plen+i
            _close(tl[s], dense[plen + i])


def test_decode_step_positions_clip_to_max_seq(nets):
    """pos >= max_seq clips to max_seq - 1 (learned positions have no
    row past it), as in the JAX step."""
    jnet, tnet = nets
    tables = np.tile(np.arange(1, MAX_SEQ // BS + 1, dtype=np.int32), (1, 1))
    dims = jnet.decode_dims()
    shape = (dims["layers"], NUM_BLOCKS, BS, dims["kv_heads"],
             dims["head_dim"])
    token, pos, active = (np.array([5], np.int32),
                          np.array([MAX_SEQ + 3], np.int32), np.array([True]))
    jl, _, _ = jax.jit(jnet.decode_step_fn())(
        jnet.params(), token, pos, jnp.zeros(shape), jnp.zeros(shape),
        tables, active)
    tl, _, _ = tnet.decode_step_fn()(
        tnet.params(), torch.from_numpy(token), torch.from_numpy(pos),
        torch.zeros(shape), torch.zeros(shape), torch.from_numpy(tables),
        torch.from_numpy(active))
    _close(tl, jl)
