"""Seq2seq Transformer for machine translation.

PyTorch counterpart of ``mxnet_tpu/models/transformer.py`` (GluonNLP
``model/transformer.py`` parity; BASELINE's "Transformer-base MT"),
reproduced as it is: post-norm cells built on ``models/bert.py``'s
``MultiHeadAttention``, ``PositionwiseFFN`` and
``TransformerEncoderCell``, no padding masks, ``tie_weights`` accepted
and unused, a learned position table read through
``self.pos_weight.data(x.ctx)``. Its attention runs through
``F.flash_attention`` (K1 forward, K2 backward on the card) three ways:
the encoder's self-attention (T = S), the decoder's causal
self-attention and its cross-attention over the encoder's output
(non-causal, T = target length, S = source length).
"""

from __future__ import annotations

from ..gluon import nn
from ..gluon.block import HybridBlock
from .bert import MultiHeadAttention, PositionwiseFFN, TransformerEncoderCell


class TransformerDecoderCell(HybridBlock):
    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.self_attention = MultiHeadAttention(
                units, num_heads, dropout, causal=True, prefix="self_attn_")
            self.ln1 = nn.LayerNorm(in_channels=units, prefix="ln1_")
            self.cross_attention = MultiHeadAttention(
                units, num_heads, dropout, prefix="cross_attn_")
            self.ln2 = nn.LayerNorm(in_channels=units, prefix="ln2_")
            self.ffn = PositionwiseFFN(units, hidden_size, dropout,
                                       activation="relu", prefix="ffn_")
            self.ln3 = nn.LayerNorm(in_channels=units, prefix="ln3_")

    def hybrid_forward(self, F, x, mem):
        x = self.ln1(x + self.self_attention(x))
        x = self.ln2(x + self.cross_attention(x, mem, mem))
        x = self.ln3(x + self.ffn(x))
        return x


class Transformer(HybridBlock):
    """Encoder-decoder transformer; ``Transformer(src_vocab, tgt_vocab)``
    is the base configuration of Vaswani et al. 2017 (6 + 6 layers,
    units 512, hidden 2048, 8 heads). ``net(src, tgt)`` returns the
    target logits ``(batch, tgt_len, tgt_vocab)``."""

    def __init__(self, src_vocab, tgt_vocab, num_layers=6, units=512,
                 hidden_size=2048, num_heads=8, dropout=0.1, max_length=512,
                 tie_weights=False, **kwargs):
        super().__init__(**kwargs)
        del tie_weights  # accepted and unused, as in the JAX package
        self._units = units
        with self.name_scope():
            self.src_embed = nn.Embedding(src_vocab, units,
                                          prefix="src_embed_")
            self.tgt_embed = nn.Embedding(tgt_vocab, units,
                                          prefix="tgt_embed_")
            self.pos_weight = self.params.get(
                "pos_weight", shape=(max_length, units), init="normal")
            self.encoder = nn.HybridSequential(prefix="enc_")
            with self.encoder.name_scope():
                for i in range(num_layers):
                    self.encoder.add(TransformerEncoderCell(
                        units, hidden_size, num_heads, dropout,
                        prefix=f"layer{i}_"))
            self.dec_cells = nn.HybridSequential(prefix="dec_")
            with self.dec_cells.name_scope():
                for i in range(num_layers):
                    self.dec_cells.add(TransformerDecoderCell(
                        units, hidden_size, num_heads, dropout,
                        prefix=f"layer{i}_"))
            self.proj = nn.Dense(tgt_vocab, flatten=False, prefix="proj_")

    def _pos(self, F, x):
        T = x.shape[1]
        pos = F.slice_axis(self.pos_weight.data(x.ctx), axis=0, begin=0,
                           end=T)
        return x + F.expand_dims(pos, axis=0)

    def encode(self, src):
        from .. import ndarray as F

        x = self._pos(F, self.src_embed(src) * (self._units ** 0.5))
        for cell in self.encoder._children.values():
            x = cell(x)
        return x

    def decode(self, tgt, mem):
        from .. import ndarray as F

        x = self._pos(F, self.tgt_embed(tgt) * (self._units ** 0.5))
        for cell in self.dec_cells._children.values():
            x = cell(x, mem)
        return self.proj(x)

    def hybrid_forward(self, F, src, tgt, pos_weight=None):
        mem = self.encode(src)
        return self.decode(tgt, mem)

