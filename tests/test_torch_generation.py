"""Port parity: ``mxnet_tpu_torch.serving.GenerationEngine`` on the CPU.

Greedy generation from the port's engine must equal the JAX engine's,
token for token, on the same weights (carried with
``params_from_numpy``), for the prompts of ``tests/test_generation.py``;
and the port replays that file's engine contracts: sampling policies,
EOS, ``max_new`` clipping, typed refusal of over-bucket prompts,
deadlines, cancel, pause/resume/kill/close, and ragged traffic that
leaves the cache empty. Greedy decode is exact (argmax of float32 logits
that agree to ~1e-7); sampled draws come from another random stream and
are only checked for range and seed determinism. ``canary()`` returns the
JAX engine's tokens; the chunk body split from its runner gives the
unsplit chunk's tokens, slot state and pools exactly. The ``*_on_cuda``
tests hold one replay of the captured chunk equal to the eager body on
the same static inputs and pools, and two engines from one seed to the
same sampled tokens when every chunk is a replay.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import time

import numpy as np
import pytest
import torch

from mxnet_tpu.serving import GenerationEngine as JaxEngine
from mxnet_tpu.serving import TransformerDecoderLM as JaxLM
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import (
    EngineClosed,
    GenerationEngine,
    ReplicaDead,
    RequestCancelled,
    RequestTimeout,
    RetraceForbidden,
    ServingError,
    TransformerDecoderLM,
    params_from_numpy,
    sample_tokens,
)

VOCAB, MAX_SEQ, BUCKETS, SLOTS, CHUNK = 48, 64, [4, 8, 16], 4, 4
NET = dict(vocab_size=VOCAB, num_layers=2, d_model=32, num_heads=4,
           kv_heads=2, max_seq=MAX_SEQ, seed=0)
ENG = dict(slots=SLOTS, chunk=CHUNK, queue_cap=64, cache_blocks=96,
           cache_block_size=4)
PROMPTS = [([3, 1, 4], 10), ([7, 2, 9, 11, 5, 40], 9),
           (list(range(2, 15)), 17)]


def _carry(jnet, device="cpu"):
    tree = {k: ([{n: np.asarray(a) for n, a in lyr.items()} for lyr in v]
                if k == "layers" else np.asarray(v))
            for k, v in jnet.params().items()}
    return params_from_numpy(tree, device)


@pytest.fixture(scope="module")
def jnet():
    return JaxLM(**NET)


@pytest.fixture(scope="module")
def net(jnet):
    return TransformerDecoderLM(**NET, device="cpu", params=_carry(jnet))


@pytest.fixture(scope="module")
def eng(net):
    e = GenerationEngine(net, BUCKETS, name="gen-test", device="cpu", **ENG)
    yield e
    e.close()


def _assert_matches_dense(net, prompt, toks):
    """ONE causal forward over prompt+generated must greedy-predict every
    generated token from its own prefix."""
    seq = [int(t) for t in prompt] + [int(t) for t in toks]
    with torch.inference_mode():
        logits = net.forward_fn()(net.params(), torch.tensor([seq]))
    want = logits[0, len(prompt) - 1:len(seq) - 1].argmax(-1)
    assert [int(t) for t in toks] == want.tolist()


def _drain(eng, timeout=10.0):
    deadline = time.perf_counter() + timeout
    while (eng.active_slots() or eng.queue_depth()) \
            and time.perf_counter() < deadline:
        time.sleep(0.002)


def test_greedy_tokens_equal_the_jax_engine(jnet, eng, net):
    jeng = JaxEngine(jnet, BUCKETS, name="gen-jax", **ENG)
    try:
        for prompt, n in PROMPTS:
            want = jeng.predict(np.array(prompt, np.int32),
                                max_new_tokens=n, greedy=True, timeout=60.0)
            got = eng.predict(np.array(prompt, np.int32),
                              max_new_tokens=n, greedy=True, timeout=60.0)
            assert got.dtype == np.int32 and len(got) == n
            assert got.tolist() == want.tolist()
            _assert_matches_dense(net, prompt, got)
    finally:
        jeng.close()


def test_greedy_tokens_on_cuda_equal_the_jax_engine(jnet):
    """The port's engine on the card (every decode step through the
    Hopper paged-decode kernel) against the JAX engine on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mxnet_tpu_torch.ops import _kernels

    net = TransformerDecoderLM(**NET, device="cuda",
                               params=_carry(jnet, "cuda"))
    jeng = JaxEngine(jnet, BUCKETS, name="gen-jax-ref", **ENG)
    eng = GenerationEngine(net, BUCKETS, name="gen-cuda", **ENG)
    try:
        n0 = _kernels.LAUNCHES["paged_decode"]
        for prompt, n in PROMPTS:
            want = jeng.predict(np.array(prompt, np.int32),
                                max_new_tokens=n, greedy=True, timeout=60.0)
            got = eng.predict(np.array(prompt, np.int32),
                              max_new_tokens=n, greedy=True, timeout=60.0)
            assert got.tolist() == want.tolist()
        assert _kernels.LAUNCHES["paged_decode"] > n0
    finally:
        eng.close()
        jeng.close()


def test_batch_axis_squeeze_and_validation(eng):
    a = eng.predict(np.array([[5, 6, 7]], np.int32), max_new_tokens=3,
                    timeout=60.0)
    b = eng.predict([5, 6, 7], max_new_tokens=3, timeout=60.0)
    assert a.tolist() == b.tolist()
    with pytest.raises(ServingError):
        eng.submit(np.zeros((2, 3), np.int32))
    with pytest.raises(ServingError):
        eng.submit(np.array([], np.int32))


def test_eos_stops_early_and_is_included(eng, net):
    prompt = [3, 1, 4]
    ref = eng.predict(np.array(prompt, np.int32), max_new_tokens=12,
                      greedy=True, timeout=60.0)
    _assert_matches_dense(net, prompt, ref)
    eos = int(ref[5])
    want = ref[:list(ref).index(eos) + 1].tolist()
    toks = eng.predict(np.array(prompt, np.int32), max_new_tokens=12,
                       eos=eos, timeout=60.0)
    assert toks.tolist() == want and toks[-1] == eos


def test_max_new_clipped_to_max_seq(eng):
    toks = eng.predict(np.arange(1, 14, dtype=np.int32),
                       max_new_tokens=10_000, timeout=120.0)
    assert len(toks) == MAX_SEQ - 13


def test_sampling_first_token_is_seed_deterministic(eng):
    kw = dict(max_new_tokens=8, greedy=False, temperature=0.8, top_k=12,
              seed=7, timeout=60.0)
    a = eng.predict(np.array([9, 8, 7], np.int32), **kw)
    b = eng.predict(np.array([9, 8, 7], np.int32), **kw)
    assert a[0] == b[0]
    c = eng.predict(np.array([9, 8, 7], np.int32), **{**kw, "seed": 1234})
    for toks in (a, b, c):
        assert np.all(toks >= 0) and np.all(toks < VOCAB)


def test_sample_tokens_policies():
    rs = np.random.RandomState(0)
    logits = torch.from_numpy(rs.randn(3, 16).astype(np.float32))
    ones = torch.ones(3)
    zeros_i = torch.zeros(3, dtype=torch.int32)
    amax = logits.argmax(-1).to(torch.int32)

    def draw(temperature=ones, top_k=zeros_i, top_p=ones,
             greedy=torch.zeros(3, dtype=torch.bool), seed=0):
        gen = torch.Generator().manual_seed(seed)
        return sample_tokens(logits, gen, temperature, top_k, top_p, greedy)

    assert torch.equal(draw(greedy=torch.ones(3, dtype=torch.bool)), amax)
    # top_k=1 collapses to argmax no matter the temperature
    assert torch.equal(draw(temperature=ones * 5.0,
                            top_k=torch.ones(3, dtype=torch.int32)), amax)
    # a tiny nucleus keeps only the argmax (it always survives)
    assert torch.equal(draw(top_p=ones * 1e-6), amax)
    mixed = draw(greedy=torch.tensor([True, False, False]),
                 top_k=torch.tensor([0, 1, 0], dtype=torch.int32))
    assert mixed[0] == amax[0] and mixed[1] == amax[1]
    t = ones * 3.0
    assert torch.equal(draw(temperature=t), draw(temperature=t))
    assert draw().dtype == torch.int32
    assert bool(((draw() >= 0) & (draw() < 16)).all())
    # top-k keeps only the k best: 200 draws never leave the top 3
    top3 = set(torch.topk(logits[0], 3).indices.tolist())
    seen = {int(draw(temperature=ones * 10.0,
                     top_k=torch.full((3,), 3, dtype=torch.int32),
                     seed=s)[0]) for s in range(200)}
    assert seen <= top3 and len(seen) > 1


def test_over_bucket_prompt_is_typed_refusal(eng):
    st0 = eng.stats()
    with pytest.raises(RetraceForbidden, match="no prefill bucket"):
        eng.submit(np.arange(17, dtype=np.int32))
    with pytest.raises(RetraceForbidden):
        eng.submit(np.zeros(MAX_SEQ, np.int32))
    st1 = eng.stats()
    assert st1["refused"] - st0["refused"] == 2
    assert st1["compiles"] == st0["compiles"]


def test_one_host_round_trip_per_chunk(eng):
    st0 = eng.stats()
    n = 9  # prefill token + 8 more = 2 full chunks of 4
    toks = eng.predict(np.array([2, 4, 6], np.int32), max_new_tokens=n,
                       greedy=True, timeout=60.0)
    assert len(toks) == n
    st1 = eng.stats()
    assert st1["prefills"] - st0["prefills"] == 1
    assert st1["decode_chunks"] - st0["decode_chunks"] == -(-(n - 1) // CHUNK)
    assert st1["dispatches"] - st0["dispatches"] == 1 + 2


def test_ragged_traffic_frees_cache(eng, net):
    st0 = eng.stats()
    rs = np.random.RandomState(3)
    futs, checks = [], []
    for i in range(14):
        plen = int(rs.choice([3, 4, 6, 8, 11, 16]))
        prompt = rs.randint(0, VOCAB, plen).astype(np.int32)
        n = int(rs.choice([2, 5, 8, 13]))
        if i % 3 == 0:
            futs.append(eng.submit(prompt, max_new_tokens=n, greedy=True))
            checks.append((len(futs) - 1, list(prompt), n))
        else:
            futs.append(eng.submit(prompt, max_new_tokens=n, greedy=False,
                                   temperature=0.9, top_k=10, top_p=0.95,
                                   seed=i))
    outs = [f.result(120.0) for f in futs]
    st1 = eng.stats()
    assert st1["requests_ok"] - st0["requests_ok"] == 14
    assert st1["recompiles_after_warmup"] == 0
    for idx, prompt, n in checks:
        assert len(outs[idx]) == n
        _assert_matches_dense(net, prompt, outs[idx])
    for out in outs:
        assert np.all(out >= 0) and np.all(out < VOCAB)
    _drain(eng)
    assert eng.stats()["cache"]["blocks_used"] == 0


def test_late_join_rides_next_chunk_without_drain(eng):
    long_f = eng.submit(np.array([1, 2, 3], np.int32), max_new_tokens=40,
                        greedy=True)
    deadline = time.perf_counter() + 10.0
    while eng.active_slots() == 0 and time.perf_counter() < deadline:
        time.sleep(0.001)
    assert eng.active_slots() > 0
    short_f = eng.submit(np.array([9, 9], np.int32), max_new_tokens=3,
                         greedy=True)
    assert len(short_f.result(60.0)) == 3
    assert len(long_f.result(60.0)) == 40
    assert short_f.token_times()[1] < long_f.token_times()[1]


def test_deadline_expires_in_queue(eng):
    longs = [eng.submit(np.array([5, 3], np.int32), max_new_tokens=30,
                        greedy=True) for _ in range(SLOTS + 1)]
    f = eng.submit(np.array([1, 1], np.int32), max_new_tokens=30,
                   deadline_ms=0.1)
    with pytest.raises(RequestTimeout):
        f.result(60.0)
    for lf in longs:
        assert len(lf.result(120.0)) == 30


def test_cancel_only_before_admission(eng):
    longs = [eng.submit(np.array([5, 3], np.int32), max_new_tokens=25,
                        greedy=True) for _ in range(SLOTS + 2)]
    victim = eng.submit(np.array([2, 2], np.int32), max_new_tokens=4)
    assert victim.cancel() is True and victim.cancelled()
    with pytest.raises(RequestCancelled):
        victim.result(10.0)
    longs[0].result(120.0)
    assert longs[0].cancel() is False
    for lf in longs[1:]:
        lf.result(120.0)


def _tiny_engine(name):
    net = TransformerDecoderLM(vocab_size=32, num_layers=1, d_model=16,
                               num_heads=2, max_seq=32, seed=0, device="cpu")
    return GenerationEngine(net, [4], name=name, slots=2, chunk=2,
                            cache_blocks=24, cache_block_size=4)


def test_pause_resume_kill_lifecycle():
    e = _tiny_engine("gen-life")
    try:
        assert len(e.predict([1, 2], max_new_tokens=2, timeout=60.0)) == 2
        e.pause()
        with pytest.raises(EngineClosed):
            e.submit(np.array([1, 2], np.int32))
        e.resume()
        assert len(e.predict([1, 2], max_new_tokens=2, timeout=60.0)) == 2
        f = e.submit(np.array([3, 1], np.int32), max_new_tokens=20)
        e.kill()
        with pytest.raises(ReplicaDead):
            f.result(30.0)
        with pytest.raises(EngineClosed):
            e.resume()
    finally:
        e.close()
    assert not e._thread.is_alive()


def test_close_drains_inflight():
    e = _tiny_engine("gen-drain")
    f = e.submit(np.array([1, 2, 3], np.int32), max_new_tokens=10)
    e.close()
    assert len(f.result(1.0)) == 10
    assert not e._thread.is_alive()
    with pytest.raises(EngineClosed):
        e.submit(np.array([1, 2], np.int32))


# -- the chunk body and its runner; canary() --------------------------------

def _legacy_run_chunk(e, tables):
    """The engine's chunk before the body was split from its runner: every
    slot mirror copied on its own, the loop, the pools adopted, one packed
    device-to-host copy."""
    def dev(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(e.device)

    tables = dev(tables)
    lens, token = dev(e._lens), dev(e._token)
    active, remaining = dev(e._active), dev(e._remaining)
    temp, top_k = dev(e._temp), dev(e._topk)
    top_p, greedy, eos = dev(e._topp), dev(e._greedy), dev(e._eos)
    k_pool, v_pool = e.cache.pools()
    toks, flags = [], []
    for _ in range(e._chunk):
        logits, k_pool, v_pool = e._step(
            e._params, token, lens, k_pool, v_pool, tables, active)
        nxt = sample_tokens(logits, e._gen, temp, top_k, top_p, greedy)
        emitted = active
        nxt = torch.where(emitted, nxt, 0)
        lens = lens + active.to(lens.dtype)
        remaining = remaining - active.to(remaining.dtype)
        hit_eos = (nxt == eos) & (eos >= 0)
        active = active & ~hit_eos & (remaining > 0)
        token = nxt
        toks.append(nxt)
        flags.append(emitted)
    e.cache.update_pools(k_pool, v_pool)
    n = e._slots
    packed = torch.cat([torch.stack(toks).reshape(-1),
                        torch.stack(flags).to(torch.int32).reshape(-1),
                        lens, token, active.to(torch.int32),
                        remaining]).cpu().numpy()
    c = e._chunk * n
    rest = packed[2 * c:].reshape(4, n)
    return (packed[:c].reshape(e._chunk, n),
            packed[c:2 * c].reshape(e._chunk, n).astype(bool),
            rest[0].copy(), rest[1].copy(), rest[2].astype(bool),
            rest[3].copy())


def _seated_engine(net):
    """An engine with its scheduler held, three slots seated by hand (two
    greedy, one sampling with every filter, one with an EOS) and their
    prompts prefilled."""
    e = GenerationEngine(net, BUCKETS, name="gen-split", device="cpu",
                         autostart=False, **ENG)
    rs = np.random.RandomState(4)
    for s, (plen, greedy) in enumerate(((5, True), (9, False), (3, True))):
        prompt = rs.randint(1, VOCAB, plen).astype(np.int32)
        table = e.cache.allocate(plen + 12)
        padded = np.zeros((1, 16), np.int64)
        padded[0, :plen] = prompt
        k, v = e.cache.pools()
        e._prefill_step(e._params, torch.from_numpy(padded), k, v,
                        torch.from_numpy(table.device_row(e._mb)[None]),
                        torch.tensor([plen], dtype=torch.int32))
        e._slot_tables[s] = table
        e._lens[s], e._token[s], e._active[s] = plen, int(prompt[-1]), True
        e._remaining[s] = 11
        e._greedy[s] = greedy
        e._temp[s], e._topk[s], e._topp[s] = 0.9, 7, 0.8
    e._eos[2] = int(rs.randint(0, VOCAB))
    tables = np.zeros((e._slots, e._mb), np.int32)
    for s, t in enumerate(e._slot_tables):
        if t is not None:
            tables[s] = t.device_row(e._mb)
    return e, tables


def test_chunk_body_matches_the_unsplit_chunk(net):
    """The runner (mirrors packed into one static buffer, the body, one
    packed read) gives the unsplit chunk's tokens, flags, slot state and
    pools, from the same generator state, over three chunks."""
    e, tables = _seated_engine(net)
    try:
        with torch.inference_mode():
            _compare_legacy_and_split(e, tables)
    finally:
        e.close()


def _compare_legacy_and_split(e, tables):
    """Three chunks through each runner from the same state: equal."""
    pools0 = [p.clone() for p in e.cache.pools()]
    mirrors = [a.copy() for a in (e._lens, e._token, e._active,
                                  e._remaining)]
    gen0 = e._gen.get_state()
    runs = {}
    for name, run in (("legacy", _legacy_run_chunk),
                      ("split", lambda eng, t: eng._run_chunk(t))):
        for p, p0 in zip(e.cache.pools(), pools0):
            p.copy_(p0)
        e._lens, e._token, e._active, e._remaining = \
            [a.copy() for a in mirrors]
        e._gen.set_state(gen0)
        outs = []
        for _ in range(3):
            out = run(e, tables)
            (_, _, e._lens, e._token, e._active, e._remaining) = out
            outs.append(out)
        runs[name] = (outs, [p.clone() for p in e.cache.pools()])
    (lo, lp), (so, sp) = runs["legacy"], runs["split"]
    for a, b in zip(lo, so):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    assert any(f.any() for f in (lo[0][1], lo[2][1]))
    for x, y in zip(lp, sp):
        assert torch.equal(x, y)


def test_canary_matches_the_jax_engine(jnet, net):
    """``canary()`` generates 2 greedy tokens from [1, 2] (starting the
    scheduler if it was held) and returns them: the JAX engine's tokens."""
    jeng = JaxEngine(jnet, BUCKETS, name="gen-canary-jax", autostart=False,
                     **ENG)
    e = GenerationEngine(net, BUCKETS, name="gen-canary", device="cpu",
                         autostart=False, **ENG)
    try:
        got, want = e.canary(), jeng.canary()
        assert got.dtype == np.int32 and got.tolist() == want.tolist()
        assert e.stats()["requests_ok"] == 1
    finally:
        e.close()
        jeng.close()


def test_canary_refuses_out_of_vocabulary_ids(net, monkeypatch):
    e = GenerationEngine(net, BUCKETS, name="gen-canary-bad", device="cpu",
                         **ENG)
    try:
        monkeypatch.setattr(e, "predict", lambda *a, **k: np.array(
            [3, VOCAB], np.int32))
        with pytest.raises(ServingError, match="out-of-vocabulary"):
            e.canary()
    finally:
        e.close()


def test_pools_in_other_storage_raise():
    from mxnet_tpu_torch.serving import PagedKVCache

    cache = PagedKVCache(1, 1, 4, max_seq=8, num_blocks=4, block_size=4,
                         device="cpu")
    k, v = cache.pools()
    cache.update_pools(k, v)  # the same tensors, written in place
    with pytest.raises(MXNetError, match="other storage"):
        cache.update_pools(k.clone(), v)


# -- on the card: the captured chunk -----------------------------------------

def _cuda_net(jnet):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return TransformerDecoderLM(**NET, device="cuda",
                                params=_carry(jnet, "cuda"))


def test_captured_chunk_equals_the_eager_body_on_cuda(jnet):
    """One replay of the captured chunk against the eager body on the same
    static inputs and pools: greedy tokens, flags, slot state and pools
    equal; K3's two kernels launch once per layer per step, from the
    replay's accounting."""
    net = _cuda_net(jnet)
    e = GenerationEngine(net, BUCKETS, name="gen-graph", autostart=False,
                         **ENG)
    try:
        with e._on_device():
            _replay_against_eager(e)
    finally:
        e.close()


def _replay_against_eager(e):
    """Three slots seated by hand, one replay, then the eager body from the
    same static inputs and pools."""
    from mxnet_tpu_torch.ops import _kernels

    assert e._chunk_graph is not None
    rs = np.random.RandomState(6)
    tables = np.zeros((e._slots, e._mb), np.int32)
    for s, plen in enumerate((5, 12, 3)):
        t = e.cache.allocate(plen + CHUNK)
        tables[s] = t.device_row(e._mb)
        e._lens[s], e._token[s] = plen, int(rs.randint(VOCAB))
        e._active[s], e._remaining[s] = True, 10
    pools0 = [p.clone() for p in e.cache.pools()]
    e._pack(tables)
    e._dev_in.copy_(e._host_in)
    n0 = dict(_kernels.LAUNCHES)
    e._chunk_graph.replay()
    replay = e._chunk_out.clone()
    graph_pools = [p.clone() for p in e.cache.pools()]
    got = {k: _kernels.LAUNCHES[k] - n0.get(k, 0)
           for k in ("paged_decode", "paged_decode_combine")}
    assert got == {k: NET["num_layers"] * CHUNK for k in got}
    for p, p0 in zip(e.cache.pools(), pools0):
        p.copy_(p0)
    eager = e._chunk_body()
    torch.cuda.synchronize()
    assert torch.equal(replay, eager)
    for a, b in zip(graph_pools, e.cache.pools()):
        assert torch.equal(a, b)


def test_captured_sampling_repeats_from_one_seed_on_cuda(jnet):
    """Two engines from one seed, each chunk a replay drawing from the
    engine's registered generator: the same sampled tokens; another seed
    gives others."""
    net = _cuda_net(jnet)

    def run(seed):
        e = GenerationEngine(net, BUCKETS, name=f"gen-seed-{seed}",
                             seed=seed, **ENG)
        try:
            return [e.predict(np.array(p, np.int32), max_new_tokens=n,
                              greedy=False, temperature=1.3, seed=5,
                              timeout=60.0).tolist() for p, n in PROMPTS]
        finally:
            e.close()

    a, b, c = run(3), run(3), run(4)
    assert a == b and a != c


def test_pool_reallocation_refuses_to_replay_on_cuda(jnet):
    net = _cuda_net(jnet)
    e = GenerationEngine(net, BUCKETS, name="gen-realloc", autostart=False,
                         **ENG)
    try:
        with e._on_device():
            e.cache.k_pool = e.cache.k_pool.clone()
            with pytest.raises(MXNetError, match="captured over"):
                e._run_chunk(np.zeros((e._slots, e._mb), np.int32))
    finally:
        e.close()
