"""The captured prefill of ``GenerationEngine`` (one CUDA graph per
prompt bucket, as the JAX engine seals one prefill executable per bucket).

On the CPU the prefill stays eager: the engine holds no prefill graph,
counts one compile per bucket (plus the decode chunk), and its first
greedy token of each prompt equals the JAX engine's. The ``*_on_cuda``
tests hold the engine's own prefill (``_prefill_logits``: its packing
into the bucket's static buffer and one replay) equal, bit for bit, to
the eager prefill on the same inputs and pools (logits, and every pool block
but the null block 0, whose content under colliding pad writes is
unspecified), and the first sampled token equal for the same seed.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import numpy as np
import pytest
import torch

from mxnet_tpu.serving import GenerationEngine as JaxEngine
from mxnet_tpu.serving import TransformerDecoderLM as JaxLM
from mxnet_tpu_torch.serving import (
    GenerationEngine,
    TransformerDecoderLM,
    params_from_numpy,
    sample_tokens,
)

VOCAB, MAX_SEQ, BUCKETS = 48, 64, [4, 8, 16]
NET = dict(vocab_size=VOCAB, num_layers=2, d_model=32, num_heads=4,
           kv_heads=2, max_seq=MAX_SEQ, seed=0)
ENG = dict(slots=4, chunk=4, queue_cap=64, cache_blocks=96,
           cache_block_size=4)
PROMPTS = [[3, 1, 4], [7, 2, 9, 11, 5, 40], list(range(2, 15))]


def _carry(jnet, device="cpu"):
    tree = {k: ([{n: np.asarray(a) for n, a in lyr.items()} for lyr in v]
                if k == "layers" else np.asarray(v))
            for k, v in jnet.params().items()}
    return params_from_numpy(tree, device)


@pytest.fixture(scope="module")
def jnet():
    return JaxLM(**NET)


def test_cpu_prefill_stays_eager_and_matches_jax(jnet):
    net = TransformerDecoderLM(**NET, device="cpu", params=_carry(jnet))
    eng = GenerationEngine(net, BUCKETS, name="pf-cpu", device="cpu", **ENG)
    jeng = JaxEngine(jnet, BUCKETS, name="pf-jax", **ENG)
    try:
        assert eng._prefill_graphs == {}
        assert eng.stats()["compiles"] == 1 + len(BUCKETS)
        for p in PROMPTS:
            want = jeng.predict(np.array(p, np.int32), max_new_tokens=1,
                                greedy=True, timeout=60.0)
            got = eng.predict(np.array(p, np.int32), max_new_tokens=1,
                              greedy=True, timeout=60.0)
            assert got.tolist() == want.tolist()
    finally:
        eng.close()
        jeng.close()


def test_captured_prefill_equals_eager_on_cuda(jnet):
    """Each bucket's replay against the eager prefill from the same
    inputs and pools: logits and pools (but the null block) equal bit for
    bit, and the first token sampled from one seed equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    net = TransformerDecoderLM(**NET, device="cuda",
                               params=_carry(jnet, "cuda"))
    e = GenerationEngine(net, BUCKETS, name="pf-graph", autostart=False,
                         **ENG)
    try:
        assert sorted(e._prefill_graphs) == BUCKETS
        assert e.stats()["compiles"] == 1 + len(BUCKETS)
        with e._on_device():
            for p in PROMPTS + [[5] * 16]:
                _replay_against_eager(e, p)
    finally:
        e.close()


def _replay_against_eager(e, prompt):
    plen = len(prompt)
    tb = e._bucket_for(plen)
    table = e.cache.allocate(plen)
    row = table.device_row(e._mb)
    pools0 = [p.clone() for p in e.cache.pools()]
    replay = e._prefill_logits(prompt, table).clone()
    graph_pools = [p.clone() for p in e.cache.pools()]
    for p, p0 in zip(e.cache.pools(), pools0):
        p.copy_(p0)
    padded = np.zeros((1, tb), np.int64)
    padded[0, :plen] = prompt
    k, v = e.cache.pools()
    eager, _, _ = e._prefill_step(
        e._params, e._dev(padded), k, v, e._dev(row[None, :]),
        e._dev([plen], torch.int32))
    torch.cuda.synchronize()
    assert torch.equal(replay, eager)
    for a, b in zip(graph_pools, e.cache.pools()):
        assert torch.equal(a[:, 1:], b[:, 1:])
    toks = []
    for lg in (replay, eager):
        gen = torch.Generator(device="cuda").manual_seed(11)
        toks.append(sample_tokens(
            lg, gen, e._dev([1.3], torch.float32), e._dev([0], torch.int32),
            e._dev([1.0], torch.float32), e._dev([False], torch.bool)))
    assert torch.equal(toks[0], toks[1])
    e.cache.release(table)
