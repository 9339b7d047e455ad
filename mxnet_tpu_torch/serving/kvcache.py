"""Paged KV cache: fixed-size blocks in one preallocated device pool,
per-request block tables (vLLM/PagedAttention-style).

PyTorch counterpart of ``mxnet_tpu/serving/kvcache.py``. The cache owns
ONE pool per projection, shaped

    ``(layers, num_blocks, block_size, kv_heads, head_dim)``

and every request holds a :class:`BlockTable` — the list of pool block
ids that back its tokens, in order. Growing a sequence is appending a
block id to a host-side list; no device copy, no reallocation. Block 0
is reserved as the NULL block: writes for inactive batch slots and for
prompt padding are routed there, so the decode step never branches on
slot liveness — dead slots scatter into a sink that nothing ever reads.

Allocation is a free-list with per-block refcounts. ``fork()`` shares
a prefix between sequences by bumping refcounts — copy-on-write
triggers only when a writer must append into a shared partial block,
and copies exactly that one block.

Where the JAX package threads the pools through its executables as
donated functional values, the port updates them IN PLACE: the prefill
and decode functions write into the very tensors the cache holds, and
:meth:`PagedKVCache.update_pools` is the hand-over of those same
tensors. Pool memory is therefore allocated once, at construction.

Knobs: ``MXTPU_KVCACHE_BLOCKS`` (pool size), ``MXTPU_KVCACHE_BLOCK_SIZE``
(tokens per block).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .. import base
from ..base import MXNetError
from .. import observability as _obs
from ..context import resolve_device
from .errors import KVCacheOOM


def kvcache_blocks() -> int:
    """Pool capacity in blocks (``MXTPU_KVCACHE_BLOCKS``, default 512).
    Block 0 is the reserved null sink, so usable capacity is one less."""
    return max(2, base.getenv("MXTPU_KVCACHE_BLOCKS", 512, dtype=int))


def kvcache_block_size() -> int:
    """Tokens per cache block (``MXTPU_KVCACHE_BLOCK_SIZE``, default
    16)."""
    return max(1, base.getenv("MXTPU_KVCACHE_BLOCK_SIZE", 16, dtype=int))


class BlockTable:
    """One sequence's view into the pool: ordered block ids + how many
    tokens are written. Host-side bookkeeping only — the device sees a
    padded ``int32`` row (:meth:`device_row`) with the null block in
    unused slots."""

    __slots__ = ("blocks", "length")

    def __init__(self, blocks=None, length=0):
        self.blocks = list(blocks or [])
        self.length = int(length)

    def __repr__(self):
        return f"BlockTable(blocks={self.blocks}, length={self.length})"

    def device_row(self, max_blocks: int) -> np.ndarray:
        """Padded ``int32`` row for the decode batch's table operand —
        unused entries point at the null block (id 0)."""
        row = np.zeros((int(max_blocks),), dtype=np.int32)
        n = min(len(self.blocks), int(max_blocks))
        row[:n] = self.blocks[:n]
        return row


class PagedKVCache:
    """Device block pool + host free-list allocator (thread-safe).

    ``_free`` and ``_ref`` are guarded by ``_lock``.

    >>> cache = PagedKVCache(layers=2, kv_heads=2, head_dim=8,
    ...                      max_seq=128, device="cpu")
    >>> t = cache.allocate(17)          # ceil(17/16) = 2 blocks
    >>> child = cache.fork(t)           # refcount bump, no copy
    >>> cache.ensure(child, 18)         # COW copies ONE shared block
    >>> cache.release(t); cache.release(child)
    """

    def __init__(self, layers, kv_heads, head_dim, *, max_seq=None,
                 num_blocks=None, block_size=None, dtype=torch.float32,
                 name="model", device=None):
        self.layers = int(layers)
        self.kv_heads = int(kv_heads)
        self.head_dim = int(head_dim)
        self.block_size = int(block_size or kvcache_block_size())
        self.num_blocks = int(num_blocks or kvcache_blocks())
        if self.num_blocks < 2:
            raise ValueError("PagedKVCache needs >= 2 blocks "
                             "(block 0 is the reserved null sink)")
        self.name = str(name)
        self.device = resolve_device(device)
        self.max_blocks_per_seq = (
            -(-int(max_seq) // self.block_size) if max_seq
            else self.num_blocks - 1)
        shape = (self.layers, self.num_blocks, self.block_size,
                 self.kv_heads, self.head_dim)
        self.k_pool = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=dtype, device=self.device)
        self._lock = threading.Lock()
        self._free = list(range(self.num_blocks - 1, 0, -1))  # pop() -> 1
        self._ref = np.zeros((self.num_blocks,), dtype=np.int64)
        self._ref[0] = 1  # the null block is permanently resident
        self.forks = 0
        self.cow_copies = 0

    # -- pool threading ----------------------------------------------------
    def pools(self):
        """Current ``(k_pool, v_pool)`` device tensors — the operands the
        next prefill/decode step writes into in place."""
        return self.k_pool, self.v_pool

    def update_pools(self, k_pool, v_pool):
        """Adopt the pools a step returned: the tensors it was handed,
        updated in place. A captured decode chunk reads the pools through
        fixed addresses, so pools in other storage raise instead of
        leaving a graph to replay memory that is no longer the cache."""
        for name, old, new in (("k_pool", self.k_pool, k_pool),
                               ("v_pool", self.v_pool, v_pool)):
            if old is not None and (new.data_ptr() != old.data_ptr()
                                    or new.shape != old.shape):
                raise MXNetError(
                    f"PagedKVCache.update_pools: the step returned a "
                    f"{name} in other storage; the pools are updated in "
                    "place and never reallocated")
        self.k_pool, self.v_pool = k_pool, v_pool

    # -- allocator ---------------------------------------------------------
    def _blocks_for(self, num_tokens: int) -> int:
        return -(-max(0, int(num_tokens)) // self.block_size)

    def _take(self, n: int):
        """Pop ``n`` free blocks (caller holds ``_lock``); raises typed
        OOM without mutating anything when the pool can't supply them."""
        if n > len(self._free):
            if _obs.ENABLED:
                _obs.KVCACHE_OOM_TOTAL.inc(1, model=self.name)
            raise KVCacheOOM(
                f"KV cache pool exhausted: need {n} block(s), "
                f"{len(self._free)} free of {self.num_blocks - 1} usable "
                f"(MXTPU_KVCACHE_BLOCKS={self.num_blocks}, "
                f"block_size={self.block_size})")
        return [self._free.pop() for _ in range(n)]

    def allocate(self, num_tokens: int) -> BlockTable:
        """Blocks for a fresh sequence of ``num_tokens`` tokens."""
        n = self._blocks_for(num_tokens)
        with self._lock:
            blocks = self._take(n)
            for b in blocks:
                self._ref[b] = 1
        self._gauges()
        return BlockTable(blocks, 0)

    def ensure(self, table: BlockTable, num_tokens: int):
        """Grow ``table`` to cover ``num_tokens`` tokens, triggering
        copy-on-write first if new tokens would land in a shared
        partial block. Returns the table."""
        need = self._blocks_for(num_tokens) - len(table.blocks)
        will_append = num_tokens > table.length
        copy = None
        with self._lock:
            if (will_append and table.blocks
                    and table.length % self.block_size != 0
                    and self._ref[table.blocks[-1]] > 1):
                # COW: the writer gets a private copy of the one shared
                # partial block; readers keep the original.
                (dst,) = self._take(1)
                self._ref[dst] = 1
                src = table.blocks[-1]
                self._ref[src] -= 1
                table.blocks[-1] = dst
                copy = (src, dst)
            if need > 0:
                grown = self._take(need)
                for b in grown:
                    self._ref[b] = 1
                table.blocks.extend(grown)
        if copy is not None:
            self._copy_block(*copy)
            self.cow_copies += 1
        self._gauges()
        return table

    def fork(self, table: BlockTable) -> BlockTable:
        """Share ``table``'s prefix with a new sequence: refcount bump
        only — no device traffic until a writer appends into the shared
        partial block (then exactly that block is copied)."""
        with self._lock:
            for b in table.blocks:
                self._ref[b] += 1
        self.forks += 1
        if _obs.ENABLED:
            _obs.KVCACHE_FORKS_TOTAL.inc(1, model=self.name)
        return BlockTable(list(table.blocks), table.length)

    def release(self, table: BlockTable):
        """Return the table's blocks (refcounted — a block frees only
        when its last holder releases). Idempotent per table."""
        blocks, table.blocks, table.length = table.blocks, [], 0
        with self._lock:
            for b in blocks:
                self._ref[b] -= 1
                if self._ref[b] == 0:
                    self._free.append(b)
        self._gauges()

    def _copy_block(self, src: int, dst: int):
        """Copy one block (all layers, K and V) in place — the COW path."""
        self.k_pool[:, dst] = self.k_pool[:, src]
        self.v_pool[:, dst] = self.v_pool[:, src]

    # -- accounting --------------------------------------------------------
    def blocks_used(self) -> int:
        with self._lock:
            return self.num_blocks - 1 - len(self._free)

    def blocks_free(self) -> int:
        with self._lock:
            return len(self._free)

    def occupancy(self) -> float:
        usable = max(1, self.num_blocks - 1)
        return self.blocks_used() / usable

    def can_allocate(self, num_tokens: int) -> bool:
        """Admission check: could a fresh sequence of this length be
        backed right now? (Advisory — allocate() stays the authority.)"""
        with self._lock:
            return self._blocks_for(num_tokens) <= len(self._free)

    def _gauges(self):
        if _obs.ENABLED:
            used = self.blocks_used()
            _obs.KVCACHE_BLOCKS_USED.set(used, model=self.name)
            _obs.KVCACHE_OCCUPANCY.set(
                used / max(1, self.num_blocks - 1), model=self.name)

    def stats(self) -> dict:
        return {
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "blocks_used": self.blocks_used(),
            "occupancy": self.occupancy(),
            "forks": self.forks,
            "cow_copies": self.cow_copies,
        }


# ---------------------------------------------------------------------------
# table indirection on tensors (used by the decode model AND the tests —
# one implementation, exercised from both sides). Torch indexes with int64,
# so coordinates come back as int64; the kernel takes the int32 tables.
# ---------------------------------------------------------------------------

def slot_coords(tables, pos, block_size, active=None):
    """``(block_id, offset)`` pool coordinates (int64) for writing each
    batch slot's token at position ``pos``. ``tables`` is ``(B,
    max_blocks)``, ``pos`` is ``(B,)``. Inactive slots are routed to the
    null block (id 0)."""
    pos = pos.long()
    idx = torch.clamp(pos // block_size, 0, tables.shape[1] - 1)
    blk = torch.gather(tables.long(), 1, idx[:, None])[:, 0]
    off = pos % block_size
    if active is not None:
        blk = torch.where(active, blk, 0)
    return blk, off


def paged_write(pool_layer, blk, off, values):
    """Scatter one token's K (or V) per batch slot into a single layer's
    pool slice ``(num_blocks, block_size, kv_heads, head_dim)`` IN PLACE
    and return it. ``values`` is ``(B, kv_heads, head_dim)``."""
    pool_layer[blk, off] = values.to(pool_layer.dtype)
    return pool_layer


def paged_prefill_write(pool_layer, table_row, length, values):
    """Scatter a whole prompt's K (or V) into one layer's pool slice IN
    PLACE and return it. ``table_row`` ``(max_blocks,)``, ``length`` a
    0-d or ``(1,)`` tensor (or int), ``values`` ``(T, kv_heads,
    head_dim)``; positions ``>= length`` (bucket padding) go to the null
    block."""
    t = values.shape[0]
    pos = torch.arange(t, device=pool_layer.device)
    block_size = pool_layer.shape[1]
    idx = torch.clamp(pos // block_size, 0, table_row.shape[0] - 1)
    blk = torch.where(pos < length, table_row.long()[idx], 0)
    pool_layer[blk, pos % block_size] = values.to(pool_layer.dtype)
    return pool_layer


def paged_gather(pool_layer, tables):
    """Gather each slot's K (or V) context from one layer's pool slice
    through its block table: ``(B, max_blocks * block_size, kv_heads,
    head_dim)``. Padding rows gather the null block — callers mask by
    context length."""
    b, mb = tables.shape
    g = pool_layer[tables.long()]  # (B, max_blocks, block_size, KVH, D)
    return g.reshape(b, mb * pool_layer.shape[1],
                     pool_layer.shape[2], pool_layer.shape[3])
