"""Port parity: ``mxnet_tpu_torch.serving.kvcache`` replays the cases of
``tests/test_kvcache.py`` — the block allocator (free list + refcounts,
typed OOM, fork / copy-on-write) and the table-indirection helpers, the
latter held against the JAX package's helpers on the same numpy inputs.
Helpers move values without arithmetic, so results must be equal.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.serving import kvcache as jkv
from mxnet_tpu_torch.serving import BlockTable, KVCacheOOM, PagedKVCache
from mxnet_tpu_torch.serving.kvcache import (
    paged_gather,
    paged_prefill_write,
    paged_write,
    slot_coords,
)


def _cache(num_blocks=16, block_size=4, layers=2, kv_heads=2, head_dim=3,
           max_seq=32):
    return PagedKVCache(layers, kv_heads, head_dim, max_seq=max_seq,
                        num_blocks=num_blocks, block_size=block_size,
                        device="cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# allocator
# ---------------------------------------------------------------------------

def test_allocate_release_round_trip():
    c = _cache()
    assert c.k_pool.shape == (2, 16, 4, 2, 3)
    assert c.k_pool.device.type == "cpu" and c.k_pool.dtype == torch.float32
    t = c.allocate(10)  # 3 blocks of 4
    assert len(t.blocks) == 3 and c.blocks_used() == 3
    assert 0 not in t.blocks  # the null block is never handed out
    c.release(t)
    assert c.blocks_used() == 0
    assert t.blocks == [] and t.length == 0
    c.release(t)  # idempotent
    assert c.blocks_used() == 0
    assert c.allocate(0).blocks == []


def test_oom_is_typed_and_non_destructive():
    c = _cache(num_blocks=4)  # 3 usable
    t = c.allocate(12)
    with pytest.raises(KVCacheOOM, match="exhausted"):
        c.allocate(1)
    c.release(t)
    assert c.blocks_free() == 3
    c.release(c.allocate(12))


def test_ensure_grows_in_place():
    c = _cache()
    t = c.allocate(4)
    t.length = 4
    c.ensure(t, 5)
    assert len(t.blocks) == 2
    c.ensure(t, 5)  # already covered
    assert len(t.blocks) == 2
    c.release(t)
    assert c.blocks_used() == 0


def test_fork_is_free_until_divergence():
    c = _cache()
    t = c.allocate(6)
    t.length = 6
    used = c.blocks_used()
    f = c.fork(t)
    assert c.blocks_used() == used  # refcount bump only
    assert f.blocks == t.blocks and f is not t and f.length == 6
    c.release(f)  # the other holder keeps the blocks
    assert c.blocks_used() == used
    c.release(t)
    assert c.blocks_used() == 0


def test_fork_copy_on_write_copies_exactly_one_block():
    c = _cache()
    t = c.allocate(6)
    t.length = 6
    used = c.blocks_used()
    f = c.fork(t)
    assert c.blocks_used() == used and c.forks == 1
    shared_tail = t.blocks[-1]
    c.k_pool[:, shared_tail] = 7.0
    c.v_pool[:, shared_tail] = -3.0
    c.ensure(f, 7)  # the writer gets a private copy of the partial block
    assert c.cow_copies == 1 and c.blocks_used() == used + 1
    assert f.blocks[-1] != shared_tail and t.blocks[-1] == shared_tail
    assert f.blocks[:-1] == t.blocks[:-1]
    # the copy is on the device, in place, for every layer, K and V
    assert torch.equal(c.k_pool[:, f.blocks[-1]], c.k_pool[:, shared_tail])
    assert torch.equal(c.v_pool[:, f.blocks[-1]], c.v_pool[:, shared_tail])
    c.release(f)
    f2 = c.fork(t)
    f2.length = t.length = 8  # block boundary: plain growth, no COW
    c.ensure(f2, 9)
    assert c.cow_copies == 1
    c.release(f2)
    c.release(t)
    assert c.blocks_used() == 0


def test_fork_free_round_trip_interleaved():
    c = _cache(num_blocks=32)
    t = c.allocate(10)
    t.length = 10
    forks = [c.fork(t) for _ in range(3)]
    c.release(t)
    assert c.blocks_used() == 3
    c.ensure(forks[0], 11)
    for f in forks:
        c.release(f)
    assert c.blocks_used() == 0 and c.blocks_free() == 31
    t2 = c.allocate(31 * 4)
    assert len(t2.blocks) == 31
    c.release(t2)


def test_occupancy_accounting():
    c = _cache(num_blocks=11)  # 10 usable
    t = c.allocate(20)
    assert c.occupancy() == pytest.approx(0.5)
    assert c.stats()["blocks_used"] == 5
    assert c.can_allocate(20) and not c.can_allocate(21)
    c.release(t)
    assert c.stats()["occupancy"] == 0.0


def test_block_table_device_row_pads_with_null():
    row = BlockTable([5, 9, 2], 0).device_row(6)
    assert row.dtype == np.int32 and row.tolist() == [5, 9, 2, 0, 0, 0]


def test_env_knob_defaults_and_floors(monkeypatch):
    from mxnet_tpu_torch.serving import kvcache_block_size, kvcache_blocks

    monkeypatch.delenv("MXTPU_KVCACHE_BLOCKS", raising=False)
    monkeypatch.delenv("MXTPU_KVCACHE_BLOCK_SIZE", raising=False)
    assert kvcache_blocks() == 512 and kvcache_block_size() == 16
    monkeypatch.setenv("MXTPU_KVCACHE_BLOCKS", "1")
    assert kvcache_blocks() == 2
    monkeypatch.setenv("MXTPU_KVCACHE_BLOCKS", "64")
    monkeypatch.setenv("MXTPU_KVCACHE_BLOCK_SIZE", "8")
    c = PagedKVCache(1, 1, 2, max_seq=32, device="cpu")
    assert c.num_blocks == 64 and c.block_size == 8
    assert c.max_blocks_per_seq == 4


# ---------------------------------------------------------------------------
# table indirection, against the JAX helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("active", [None, [True, False, True]])
def test_slot_coords_matches_jax(active):
    tables = np.array([[3, 7], [4, 6], [2, 5]], np.int32)
    pos = np.array([5, 1, 9], np.int32)  # 9 clips to the last table entry
    act = None if active is None else np.array(active)
    jb, jo = jkv.slot_coords(tables, pos, 4, act)
    blk, off = slot_coords(_t(tables), _t(pos), 4,
                           None if act is None else _t(act))
    assert blk.dtype == torch.int64 and off.dtype == torch.int64
    assert blk.tolist() == np.asarray(jb).tolist()
    assert off.tolist() == np.asarray(jo).tolist()
    if act is not None:
        assert blk.tolist()[1] == 0  # inactive slot -> null sink


def test_paged_write_then_gather_matches_jax():
    bs, kvh, d = 4, 2, 3
    tables = np.array([[2, 5], [3, 0]], np.int32)
    vals = np.arange(2 * kvh * d, dtype=np.float32).reshape(2, kvh, d)
    pos = np.array([5, 2], np.int32)
    jb, jo = jkv.slot_coords(tables, pos, bs)
    jpool = jkv.paged_write(jnp.zeros((8, bs, kvh, d)), jb, jo, vals)
    pool = torch.zeros(8, bs, kvh, d)
    blk, off = slot_coords(_t(tables), _t(pos), bs)
    out = paged_write(pool, blk, off, _t(vals))
    assert out is pool  # in place
    np.testing.assert_array_equal(pool.numpy(), np.asarray(jpool))
    got = paged_gather(pool, _t(tables))
    assert got.shape == (2, 2 * bs, kvh, d)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jkv.paged_gather(jpool, tables)))


@pytest.mark.parametrize("length", [0, 3, 5, 8])
def test_paged_prefill_write_matches_jax(length):
    bs, kvh, d = 4, 1, 2
    table_row = np.array([2, 4], np.int32)
    vals = np.random.RandomState(length).randn(8, kvh, d).astype(np.float32)
    jpool = np.asarray(jkv.paged_prefill_write(
        jnp.zeros((6, bs, kvh, d)), table_row, length, vals))
    pool = torch.zeros(6, bs, kvh, d)
    paged_prefill_write(pool, _t(table_row), torch.tensor(length), _t(vals))
    # real positions land through the table; pads hit ONLY block 0 (whose
    # content under colliding pad writes is unspecified on both sides)
    np.testing.assert_array_equal(pool[1:].numpy(), jpool[1:])
    assert not pool[[1, 3, 5]].any()


def test_null_block_absorbs_inactive_writes():
    bs, kvh, d = 2, 1, 2
    pool = torch.zeros(4, bs, kvh, d)
    tables = _t(np.array([[1], [2]], np.int32))
    blk, off = slot_coords(tables, torch.tensor([0, 0]), bs,
                           active=torch.tensor([True, False]))
    vals = torch.tensor([[[7.0, 7.0]], [[5.0, 5.0]]])
    paged_write(pool, blk, off, vals)
    assert pool[1, 0].sum() == kvh * d * 7.0   # the live slot's write
    assert pool[2].sum() == 0.0                # inactive slot's block clean
    assert pool[0, 0].sum() == kvh * d * 5.0   # absorbed by the sink
    assert paged_gather(pool, tables)[1].sum() == 0.0
