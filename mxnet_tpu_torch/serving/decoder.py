"""A functional transformer decoder LM — the generation stack's
reference model, on PyTorch.

PyTorch counterpart of ``mxnet_tpu/serving/decoder.py``. The class
carries the hyperparameters and the (seeded) weights as a plain dict of
tensors, the same tree the JAX package uses; everything the device runs
comes out of :meth:`~TransformerDecoderLM.forward_fn` /
:meth:`~TransformerDecoderLM.prefill_fn` /
:meth:`~TransformerDecoderLM.decode_step_fn` as functions of
``(params, ...)``:

- ``forward_fn`` — dense full-context causal forward (the oracle);
- ``prefill_fn`` — dense over the prompt, scattering each layer's K/V
  into the paged pool through the request's block table;
- ``decode_step_fn`` — one token per sequence, K/V appended to the pool
  and attention read back through
  :func:`~mxnet_tpu_torch.ops.flash_attention.paged_decode_attention`
  (the Hopper kernel on a CUDA device).

The pools are updated IN PLACE (the JAX package donates them instead),
and the functions return the same tensors they were handed.

Architecture (the GPTBigCode family): learned positional embeddings,
pre-LN LayerNorm, grouped/multi-query attention (``kv_heads |
num_heads``), tanh-GELU MLP with biases, untied head. Weights multiply
as ``h @ w`` with ``w`` stored ``(in, out)``, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..context import resolve_device

_EPS = 1e-5
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _ln(x, g, b):
    # population variance and eps 1e-5, as jnp.var in the JAX package
    return F.layer_norm(x, (x.shape[-1],), g, b, eps=_EPS)


def params_from_numpy(tree, device):
    """Carry a weight tree across packages: the JAX net's ``params()``
    with every leaf as ``np.asarray`` becomes the port's tree of tensors
    on ``device``. Orientation is kept as stored: both packages multiply
    ``h @ w`` with ``w`` shaped ``(in, out)``, so nothing is transposed."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, dev) for v in tree]
    return torch.from_numpy(np.array(tree)).to(dev)


class TransformerDecoderLM:
    """Decoder-only LM with paged-cache-aware prefill/decode.

    >>> net = TransformerDecoderLM(vocab_size=64, num_layers=2,
    ...                            d_model=32, num_heads=4, kv_heads=2,
    ...                            device="cpu")
    >>> dims = net.decode_dims()   # cache geometry for PagedKVCache

    ``device`` defaults to ``cuda:0`` (raising when there is none);
    ``params`` takes a ready weight tree (e.g. from
    :func:`params_from_numpy`) instead of drawing one from ``seed``."""

    def __init__(self, vocab_size=64, num_layers=2, d_model=32,
                 num_heads=4, kv_heads=None, d_ff=None, max_seq=128,
                 seed=0, dtype="float32", device=None, params=None):
        self.vocab_size = int(vocab_size)
        self.num_layers = int(num_layers)
        self.d_model = int(d_model)
        self.num_heads = int(num_heads)
        self.kv_heads = int(kv_heads or num_heads)
        self.d_ff = int(d_ff or 2 * d_model)
        self.max_seq = int(max_seq)
        self.seed = int(seed)
        self.dtype = str(dtype)
        if self.num_heads % self.kv_heads != 0:
            raise ValueError("num_heads must be a multiple of kv_heads; "
                             f"got {self.num_heads} vs {self.kv_heads}")
        if self.d_model % self.num_heads != 0:
            raise ValueError("d_model must divide into num_heads")
        self.head_dim = self.d_model // self.num_heads
        self.device = resolve_device(device)
        self._params = params if params is not None else self._init_params()

    # -- weights -----------------------------------------------------------
    def _init_params(self):
        """N(0, 0.02) matrices, unit gains and zero biases, drawn on the
        target device from a ``torch.Generator`` seeded with ``seed``
        (the JAX package draws from numpy's RandomState: the two nets
        share a layout, not values — carry weights with
        :func:`params_from_numpy`)."""
        dev, dt = self.device, _DTYPES[self.dtype]
        gen = torch.Generator(device=dev).manual_seed(self.seed)

        def w(*shape):
            t = torch.empty(shape, dtype=torch.float32, device=dev)
            return t.normal_(0.0, 0.02, generator=gen).to(dt)

        def zeros(*shape):
            return torch.zeros(shape, dtype=dt, device=dev)

        def ones(*shape):
            return torch.ones(shape, dtype=dt, device=dev)

        d, h, kvh, hd, ff = (self.d_model, self.num_heads, self.kv_heads,
                             self.head_dim, self.d_ff)
        layers = []
        for _ in range(self.num_layers):
            layers.append({
                "ln1_g": ones(d), "ln1_b": zeros(d),
                "wq": w(d, h * hd), "wk": w(d, kvh * hd),
                "wv": w(d, kvh * hd), "wo": w(h * hd, d),
                "ln2_g": ones(d), "ln2_b": zeros(d),
                "w1": w(d, ff), "b1": zeros(ff),
                "w2": w(ff, d), "b2": zeros(d),
            })
        return {
            "embed": w(self.vocab_size, d),
            "pos": w(self.max_seq, d),
            "layers": layers,
            "lnf_g": ones(d), "lnf_b": zeros(d),
            "head": w(d, self.vocab_size),
        }

    def params(self):
        """The weight tree (a plain dict of device tensors)."""
        return self._params

    def decode_dims(self) -> dict:
        """Cache geometry the engine hands to :class:`PagedKVCache`."""
        return {
            "layers": self.num_layers,
            "kv_heads": self.kv_heads,
            "head_dim": self.head_dim,
            "max_seq": self.max_seq,
            "vocab_size": self.vocab_size,
            "d_model": self.d_model,
        }

    def spec(self) -> dict:
        """The ``{"decoder": ...}`` spec that rebuilds this net (same
        seed -> identical weights on the same device type)."""
        return {"decoder": {
            "vocab_size": self.vocab_size, "num_layers": self.num_layers,
            "d_model": self.d_model, "num_heads": self.num_heads,
            "kv_heads": self.kv_heads, "d_ff": self.d_ff,
            "max_seq": self.max_seq, "seed": self.seed,
            "dtype": self.dtype,
        }}

    # -- shared layer math -------------------------------------------------
    def _qkv(self, lyr, h):
        """Project one layer's hidden states ``(..., d)`` to q/k/v with
        head axes split out."""
        lead = h.shape[:-1]
        q = (h @ lyr["wq"]).reshape(*lead, self.num_heads, self.head_dim)
        k = (h @ lyr["wk"]).reshape(*lead, self.kv_heads, self.head_dim)
        v = (h @ lyr["wv"]).reshape(*lead, self.kv_heads, self.head_dim)
        return q, k, v

    def _mlp(self, lyr, x):
        u = F.gelu(x @ lyr["w1"] + lyr["b1"], approximate="tanh")
        return u @ lyr["w2"] + lyr["b2"]

    def _dense_attend(self, q, k, v, causal_mask):
        """Dense causal attention over full context (oracle + prefill).
        q: (B, T, H, hd); k/v: (B, S, KVH, hd). Query heads h*G..h*G+G-1
        share kv head h."""
        b, t, h, hd = q.shape
        kvh = self.kv_heads
        qg = q.float().reshape(b, t, kvh, h // kvh, hd)
        scale = 1.0 / (self.head_dim ** 0.5)
        s = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) * scale
        s = torch.where(causal_mask, s, -1e30)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
        o = torch.einsum("bkgts,bskd->btkgd", p, v.float())
        return o.reshape(b, t, h, hd).to(q.dtype)

    def _trunk_dense(self, params, tokens, write_kv=None):
        """Dense causal trunk over ``tokens`` (B, T). ``write_kv`` is an
        optional callback ``(layer_idx, k, v)`` the prefill path uses to
        scatter each layer's K/V into the paged pool."""
        b, t = tokens.shape
        x = params["embed"][tokens.long()] + params["pos"][:t][None]
        mask = torch.ones((t, t), dtype=torch.bool,
                          device=x.device).tril()
        for li, lyr in enumerate(params["layers"]):
            h = _ln(x, lyr["ln1_g"], lyr["ln1_b"])
            q, k, v = self._qkv(lyr, h)
            if write_kv is not None:
                write_kv(li, k, v)
            o = self._dense_attend(q, k, v, mask)
            x = x + o.reshape(b, t, -1) @ lyr["wo"]
            x = x + self._mlp(lyr, _ln(x, lyr["ln2_g"], lyr["ln2_b"]))
        return _ln(x, params["lnf_g"], params["lnf_b"])

    # -- the three faces ---------------------------------------------------
    def forward_fn(self):
        """Dense full-context oracle: ``(params, tokens[B, T]) ->
        logits[B, T, V]`` — what every decode step must reproduce."""

        def forward(params, tokens):
            return self._trunk_dense(params, tokens) @ params["head"]

        return forward

    def prefill_fn(self):
        """Prompt ingestion: dense causal forward over ONE padded prompt,
        scattering every layer's K/V into the paged pool through the
        request's block table. ``(params, tokens[1, Tb], k_pool, v_pool,
        table[1, mb], length[1]) -> (logits[1, V], k_pool, v_pool)`` —
        logits are at the LAST REAL position (``length - 1``); pad
        positions write to the null block."""
        from .kvcache import paged_prefill_write

        def prefill(params, tokens, k_pool, v_pool, table, length):
            def write_kv(li, k, v):
                paged_prefill_write(k_pool[li], table[0], length[0], k[0])
                paged_prefill_write(v_pool[li], table[0], length[0], v[0])

            h = self._trunk_dense(params, tokens, write_kv=write_kv)
            last = torch.clamp(length.long() - 1, 0, tokens.shape[1] - 1)
            h_last = h[torch.arange(h.shape[0], device=h.device), last]
            return h_last @ params["head"], k_pool, v_pool

        return prefill

    def decode_step_fn(self):
        """One decode step for the whole slot batch: append each active
        slot's token K/V to the pool, attend through the block table,
        return next-token logits. ``(params, token[B], pos[B], k_pool,
        v_pool, tables[B, mb] int32, active[B] bool) -> (logits[B, V],
        k_pool, v_pool)``. Inactive slots write to the null block and
        read an empty context — the step is branch-free in slot
        liveness, and never synchronizes with the host."""
        from ..ops.flash_attention import paged_decode_attention
        from .kvcache import paged_write, slot_coords

        def step(params, token, pos, k_pool, v_pool, tables, active):
            block_size = k_pool.shape[2]
            pos_c = torch.clamp(pos.long(), 0, self.max_seq - 1)
            x = params["embed"][token.long()] + params["pos"][pos_c]
            blk, off = slot_coords(tables, pos_c, block_size, active)
            # context includes the token being written THIS step
            ctx = torch.where(active, pos_c + 1, 0).to(torch.int32)
            scale = 1.0 / (self.head_dim ** 0.5)
            for li, lyr in enumerate(params["layers"]):
                h = _ln(x, lyr["ln1_g"], lyr["ln1_b"])
                q, k, v = self._qkv(lyr, h)       # (B, H/KVH, hd)
                paged_write(k_pool[li], blk, off, k)
                paged_write(v_pool[li], blk, off, v)
                # the kernel takes q in the pools' type (float32 pools
                # under any net type, as in the JAX engine)
                o = paged_decode_attention(
                    q.to(k_pool.dtype).contiguous(), k_pool[li],
                    v_pool[li], tables, ctx, scale=scale).to(x.dtype)
                x = x + o.reshape(x.shape[0], -1) @ lyr["wo"]
                x = x + self._mlp(lyr, _ln(x, lyr["ln2_g"], lyr["ln2_b"]))
            h = _ln(x, params["lnf_g"], params["lnf_b"])
            return h @ params["head"], k_pool, v_pool

        return step
