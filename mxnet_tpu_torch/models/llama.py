"""Llama-3 family: RMSNorm + RoPE + SwiGLU + grouped-query attention.

PyTorch counterpart of ``mxnet_tpu/models/llama.py``, reproduced as it is
(parameter names, fp32 norm and rotary math, causal attention with an
optional sliding window). Attention goes through ``F.flash_attention``
with the kv heads unrepeated: on the card the Hopper kernels K1 (forward)
and K2 or, under ``MXTPU_FLASH_BWD=fused``, K6 (backward).
``tp_sharding_map`` gives the tensor-parallel ``PartitionSpec``s that
``SPMDTrainStep(param_sharding=...)`` trains with; there each rank runs
the kernels on its own heads.
"""

from __future__ import annotations

import torch

from ..gluon import nn
from ..gluon.block import HybridBlock
from ..ndarray.ndarray import apply


def _rms_norm(x, weight, eps):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * (1.0 / torch.sqrt(var + eps))
    return (normed * weight.float()).to(x.dtype)


class RMSNorm(HybridBlock):
    def __init__(self, units, eps=1e-5, **kwargs):
        super().__init__(**kwargs)
        self._eps = eps
        with self.name_scope():
            self.weight = self.params.get("weight", shape=(units,),
                                          init="ones")

    def hybrid_forward(self, F, x, weight):
        return apply(_rms_norm, x, weight, eps=self._eps)


def _rope(x, base=500000.0):
    """Rotary position embeddings on (B, H, T, D), in fp32."""
    T, D = x.shape[2], x.shape[3]
    half = D // 2
    idx = torch.arange(0, half, dtype=torch.float32, device=x.device)
    freqs = 1.0 / (base ** (idx / half))
    t = torch.arange(T, dtype=torch.float32, device=x.device)
    ang = torch.outer(t, freqs)  # (T, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class LlamaAttention(HybridBlock):
    def __init__(self, units, num_heads, num_kv_heads, rope_base=500000.0,
                 sliding_window=0, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._h = num_heads
        self._kvh = num_kv_heads
        self._d = units // num_heads
        self._rope_base = rope_base
        self._window = sliding_window
        with self.name_scope():
            self.q_proj = nn.Dense(units, flatten=False, use_bias=False,
                                   prefix="q_")
            self.k_proj = nn.Dense(self._kvh * self._d, flatten=False,
                                   use_bias=False, prefix="k_")
            self.v_proj = nn.Dense(self._kvh * self._d, flatten=False,
                                   use_bias=False, prefix="v_")
            self.o_proj = nn.Dense(units, flatten=False, use_bias=False,
                                   prefix="o_")

    def hybrid_forward(self, F, x):
        B, T, C = x.shape
        H, KVH, D = self._h, self._kvh, self._d
        q = F.transpose(F.reshape(self.q_proj(x), shape=(B, T, H, D)),
                        axes=(0, 2, 1, 3))
        k = F.transpose(F.reshape(self.k_proj(x), shape=(B, T, KVH, D)),
                        axes=(0, 2, 1, 3))
        v = F.transpose(F.reshape(self.v_proj(x), shape=(B, T, KVH, D)),
                        axes=(0, 2, 1, 3))
        q = apply(_rope, q, base=self._rope_base)
        k = apply(_rope, k, base=self._rope_base)
        # grouped-query kv heads (KVH < H) go to the op unrepeated; the
        # kernels read each kv head once for its group of query heads
        out = F.flash_attention(q, k, v, causal=True, window=self._window)
        out = F.reshape(F.transpose(out, axes=(0, 2, 1, 3)), shape=(B, T, C))
        return self.o_proj(out)


class LlamaMLP(HybridBlock):
    def __init__(self, units, intermediate, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.gate_proj = nn.Dense(intermediate, flatten=False,
                                      use_bias=False, prefix="gate_")
            self.up_proj = nn.Dense(intermediate, flatten=False,
                                    use_bias=False, prefix="up_")
            self.down_proj = nn.Dense(units, flatten=False, use_bias=False,
                                      prefix="down_")

    def hybrid_forward(self, F, x):
        return self.down_proj(_silu(F, self.gate_proj(x)) * self.up_proj(x))


def _silu(F, x):
    return x * F.sigmoid(x)


class LlamaDecoderLayer(HybridBlock):
    def __init__(self, units, intermediate, num_heads, num_kv_heads,
                 rope_base, sliding_window=0, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.input_layernorm = RMSNorm(units, prefix="in_ln_")
            self.self_attn = LlamaAttention(units, num_heads, num_kv_heads,
                                            rope_base,
                                            sliding_window=sliding_window,
                                            prefix="attn_")
            self.post_attention_layernorm = RMSNorm(units, prefix="post_ln_")
            self.mlp = LlamaMLP(units, intermediate, prefix="mlp_")

    def hybrid_forward(self, F, x):
        x = x + self.self_attn(self.input_layernorm(x))
        x = x + self.mlp(self.post_attention_layernorm(x))
        return x


class LlamaModel(HybridBlock):
    def __init__(self, vocab_size=128256, num_layers=32, units=4096,
                 intermediate=14336, num_heads=32, num_kv_heads=8,
                 rope_base=500000.0, sliding_window=0, **kwargs):
        super().__init__(**kwargs)
        self._cfg = dict(vocab_size=vocab_size, num_layers=num_layers,
                         units=units, intermediate=intermediate,
                         num_heads=num_heads, num_kv_heads=num_kv_heads,
                         sliding_window=sliding_window)
        with self.name_scope():
            self.embed_tokens = nn.Embedding(vocab_size, units,
                                             prefix="embed_")
            self.layers = nn.HybridSequential(prefix="layers_")
            with self.layers.name_scope():
                for i in range(num_layers):
                    self.layers.add(LlamaDecoderLayer(
                        units, intermediate, num_heads, num_kv_heads,
                        rope_base, sliding_window=sliding_window,
                        prefix=f"l{i}_"))
            self.norm = RMSNorm(units, prefix="norm_")
            self.lm_head = nn.Dense(vocab_size, flatten=False, use_bias=False,
                                    prefix="lm_head_")

    def hybrid_forward(self, F, input_ids):
        x = self.embed_tokens(input_ids)
        for layer in self.layers._children.values():
            x = layer(x)
        x = self.norm(x)
        return self.lm_head(x)

    def tp_sharding_map(self, tp_axis="tp"):
        """PartitionSpecs for Megatron-style TP over ``tp_axis``
        (``SPMDTrainStep(param_sharding=...)``).

        Dense weights are (out, in): column-parallel layers shard dim 0
        (q/k/v/gate/up and the LM head), row-parallel shard dim 1 (o/down).
        Embeddings shard the hidden dim; the norms stay replicated.
        """
        from ..parallel.mesh import PartitionSpec as P

        mapping = {}
        for name, p in self.collect_params().items():
            if p.shape is None:
                continue
            if any(t in name for t in ("q_weight", "k_weight", "v_weight",
                                       "gate_weight", "up_weight",
                                       "lm_head_weight")):
                mapping[name] = P(tp_axis, None)
            elif any(t in name for t in ("o_weight", "down_weight")):
                mapping[name] = P(None, tp_axis)
            elif "embed_weight" in name:
                mapping[name] = P(None, tp_axis)
            else:  # norms replicated
                mapping[name] = P()
        return mapping


_LLAMA_CONFIGS = {
    "llama3_8b": dict(vocab_size=128256, num_layers=32, units=4096,
                      intermediate=14336, num_heads=32, num_kv_heads=8),
    "llama3_70b": dict(vocab_size=128256, num_layers=80, units=8192,
                       intermediate=28672, num_heads=64, num_kv_heads=8),
    "llama_tiny": dict(vocab_size=256, num_layers=2, units=64,
                       intermediate=128, num_heads=4, num_kv_heads=2),
}


def get_llama(name, **kwargs):
    cfg = dict(_LLAMA_CONFIGS[name])
    cfg.update(kwargs)
    return LlamaModel(**cfg)


def llama3_8b(**kwargs):
    return get_llama("llama3_8b", **kwargs)


def llama_tiny(**kwargs):
    return get_llama("llama_tiny", **kwargs)
