"""Transformer encoder blocks + BERT.

PyTorch counterpart of ``mxnet_tpu/models/bert.py``, reproduced as it is
(parameter names, post-norm cells, the MLM decoder head). Attention goes
through ``F.flash_attention``: on the card the Hopper kernels K1 (forward)
and K2 (backward).
"""

from __future__ import annotations

from ..gluon import nn
from ..gluon.block import HybridBlock


class MultiHeadAttention(HybridBlock):
    """Multi-head attention over the flash kernel, (B, T, C) layout."""

    def __init__(self, units, num_heads, dropout=0.0, use_bias=True,
                 causal=False, **kwargs):
        super().__init__(**kwargs)
        assert units % num_heads == 0
        self._units = units
        self._num_heads = num_heads
        self._causal = causal
        with self.name_scope():
            self.query_proj = nn.Dense(units, flatten=False,
                                       use_bias=use_bias, prefix="query_")
            self.key_proj = nn.Dense(units, flatten=False, use_bias=use_bias,
                                     prefix="key_")
            self.value_proj = nn.Dense(units, flatten=False,
                                       use_bias=use_bias, prefix="value_")
            self.out_proj = nn.Dense(units, flatten=False, use_bias=use_bias,
                                     prefix="out_")
            self.dropout = nn.Dropout(dropout) if dropout else None

    def hybrid_forward(self, F, query, key=None, value=None, mask=None):
        if key is None:
            key = query
        if value is None:
            value = key
        B, Tq, C = query.shape
        Tk = key.shape[1]
        H = self._num_heads
        D = C // H

        def split_heads(x, T):
            return F.transpose(F.reshape(x, shape=(B, T, H, D)),
                               axes=(0, 2, 1, 3))

        q = split_heads(self.query_proj(query), Tq)
        k = split_heads(self.key_proj(key), Tk)
        v = split_heads(self.value_proj(value), Tk)
        out = F.flash_attention(q, k, v, causal=self._causal)
        out = F.reshape(F.transpose(out, axes=(0, 2, 1, 3)),
                        shape=(B, Tq, C))
        out = self.out_proj(out)
        if self.dropout is not None:
            out = self.dropout(out)
        return out


class PositionwiseFFN(HybridBlock):
    def __init__(self, units, hidden_size, dropout=0.0, activation="gelu",
                 **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.ffn_1 = nn.Dense(hidden_size, flatten=False,
                                  prefix="ffn_1_")
            self.activation = nn.GELU() if activation == "gelu" \
                else nn.Activation(activation)
            self.ffn_2 = nn.Dense(units, flatten=False, prefix="ffn_2_")
            self.dropout = nn.Dropout(dropout) if dropout else None

    def hybrid_forward(self, F, x):
        out = self.ffn_2(self.activation(self.ffn_1(x)))
        if self.dropout is not None:
            out = self.dropout(out)
        return out


class TransformerEncoderCell(HybridBlock):
    """Post-norm transformer layer (BERT style)."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.attention = MultiHeadAttention(units, num_heads, dropout,
                                                prefix="attn_")
            self.ln1 = nn.LayerNorm(in_channels=units, prefix="ln1_")
            self.ffn = PositionwiseFFN(units, hidden_size, dropout,
                                       prefix="ffn_")
            self.ln2 = nn.LayerNorm(in_channels=units, prefix="ln2_")

    def hybrid_forward(self, F, x, mask=None):
        x = self.ln1(x + self.attention(x))
        x = self.ln2(x + self.ffn(x))
        return x


class BERTEncoder(HybridBlock):
    def __init__(self, num_layers, units, hidden_size, num_heads,
                 dropout=0.0, max_length=512, **kwargs):
        super().__init__(**kwargs)
        self._max_length = max_length
        self._units = units
        with self.name_scope():
            self.position_weight = self.params.get(
                "position_weight", shape=(max_length, units), init="normal")
            self.dropout = nn.Dropout(dropout) if dropout else None
            self.layer_norm = nn.LayerNorm(in_channels=units, prefix="ln_")
            self.transformer_cells = nn.HybridSequential(prefix="cells_")
            with self.transformer_cells.name_scope():
                for i in range(num_layers):
                    self.transformer_cells.add(
                        TransformerEncoderCell(units, hidden_size, num_heads,
                                               dropout,
                                               prefix=f"transformer{i}_"))

    def hybrid_forward(self, F, x, mask=None, position_weight=None):
        T = x.shape[1]
        pos = F.slice_axis(position_weight, axis=0, begin=0, end=T)
        x = x + F.expand_dims(pos, axis=0)
        x = self.layer_norm(x)
        if self.dropout is not None:
            x = self.dropout(x)
        for cell in self.transformer_cells._children.values():
            x = cell(x)
        return x


class BERTModel(HybridBlock):
    """BERT with MLM + NSP heads (GluonNLP ``BERTModel`` parity)."""

    def __init__(self, num_layers=12, units=768, hidden_size=3072,
                 num_heads=12, vocab_size=30522, token_type_vocab_size=2,
                 max_length=512, dropout=0.1, use_pooler=True,
                 use_decoder=True, use_classifier=True, **kwargs):
        super().__init__(**kwargs)
        self._use_pooler = use_pooler
        self._use_decoder = use_decoder
        self._use_classifier = use_classifier
        with self.name_scope():
            self.word_embed = nn.Embedding(vocab_size, units,
                                           prefix="word_embed_")
            self.token_type_embed = nn.Embedding(token_type_vocab_size, units,
                                                 prefix="token_type_embed_")
            self.encoder = BERTEncoder(num_layers, units, hidden_size,
                                       num_heads, dropout, max_length,
                                       prefix="encoder_")
            if use_pooler:
                self.pooler = nn.Dense(units, activation="tanh",
                                       flatten=False, prefix="pooler_")
            if use_decoder:  # masked-LM head
                self.decoder = nn.HybridSequential(prefix="decoder_")
                with self.decoder.name_scope():
                    self.decoder.add(nn.Dense(units, flatten=False))
                    self.decoder.add(nn.GELU())
                    self.decoder.add(nn.LayerNorm(in_channels=units))
                    self.decoder.add(nn.Dense(vocab_size, flatten=False))
            if use_classifier:  # next-sentence head
                self.classifier = nn.Dense(2, flatten=False,
                                           prefix="classifier_")

    def hybrid_forward(self, F, inputs, token_types=None, valid_length=None,
                       masked_positions=None):
        x = self.word_embed(inputs)
        if token_types is not None:
            x = x + self.token_type_embed(token_types)
        seq = self.encoder(x)
        outputs = [seq]
        if self._use_pooler:
            pooled = self.pooler(F.slice_axis(seq, axis=1, begin=0, end=1)
                                 .reshape((seq.shape[0], -1)))
            outputs.append(pooled)
            if self._use_classifier:
                outputs.append(self.classifier(pooled))
        if self._use_decoder:
            if masked_positions is not None:
                # computed and unused, as in the JAX package (take over
                # axis 1 with (B, M) indices gives (B, B, M, C))
                gathered = F.take(seq, masked_positions, axis=1)  # noqa: F841
                outputs.append(self.decoder(seq))
            else:
                outputs.append(self.decoder(seq))
        return tuple(outputs) if len(outputs) > 1 else outputs[0]


_BERT_CONFIGS = {
    "bert_12_768_12": dict(num_layers=12, units=768, hidden_size=3072,
                           num_heads=12),
    "bert_24_1024_16": dict(num_layers=24, units=1024, hidden_size=4096,
                            num_heads=16),
}


def get_bert_model(model_name="bert_12_768_12", vocab_size=30522,
                   dropout=0.1, **kwargs):
    cfg = dict(_BERT_CONFIGS[model_name])
    cfg.update(kwargs)
    return BERTModel(vocab_size=vocab_size, dropout=dropout, **cfg)


def bert_base(**kwargs):
    return get_bert_model("bert_12_768_12", **kwargs)


def bert_large(**kwargs):
    return get_bert_model("bert_24_1024_16", **kwargs)
