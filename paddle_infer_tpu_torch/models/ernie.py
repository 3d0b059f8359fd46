"""ERNIE/BERT-family encoders — the training path's model.

Port of ``paddle_infer_tpu/models/ernie.py``: ``ERNIE_PRESETS``,
``ErnieConfig``, ``ErnieEmbeddings``, ``ErniePooler``, ``ErnieModel``,
``ErnieMLMHead`` (tied to ``word_embeddings.weight``, with
``decoder_bias``), ``ErnieForPretraining`` and ``ernie_pretrain_loss``,
built from post-LN ``ParallelTransformerLayer`` blocks.  Parameter names
are the JAX model's ``state_dict()`` keys (``weights.py`` carries them
over, the tied weight under both its names).

A ``[b, s]`` attention mask becomes int32 segment ids (1 real, 0 pad;
attend iff equal), so on the card every layer's attention runs the flash
kernels.  Dropout keys come from the model's ``KeyStream`` (``keys``),
drawn in the JAX order: the embedding dropout, then per layer the
``sdpa`` key, ``dropout1``, the MLP dropout, ``dropout2``.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import amp, resolve_device
from ..core.random import KeyStream
from ..nn import functional as PF
from ..nn.layers import (Dropout, Embedding, LayerNorm, Linear,
                         VocabParallelEmbedding)
from .losses import masked_lm_loss
from .transformer_block import ParallelTransformerLayer

ERNIE_PRESETS = {
    # ERNIE 3.0 / BERT size ladder
    "ernie-3.0-nano": dict(hidden_size=312, num_hidden_layers=4,
                           num_attention_heads=12, intermediate_size=1248),
    "ernie-3.0-micro": dict(hidden_size=384, num_hidden_layers=4,
                            num_attention_heads=12, intermediate_size=1536),
    "ernie-3.0-mini": dict(hidden_size=384, num_hidden_layers=6,
                           num_attention_heads=12, intermediate_size=1536),
    "ernie-3.0-medium": dict(hidden_size=768, num_hidden_layers=6,
                             num_attention_heads=12, intermediate_size=3072),
    "ernie-3.0-base": dict(hidden_size=768, num_hidden_layers=12,
                           num_attention_heads=12, intermediate_size=3072),
    "ernie-3.0-xbase": dict(hidden_size=1024, num_hidden_layers=20,
                            num_attention_heads=16, intermediate_size=4096),
    "bert-base": dict(hidden_size=768, num_hidden_layers=12,
                      num_attention_heads=12, intermediate_size=3072,
                      vocab_size=30522),
    "bert-large": dict(hidden_size=1024, num_hidden_layers=24,
                       num_attention_heads=16, intermediate_size=4096,
                       vocab_size=30522),
    "ernie-1.3b": dict(hidden_size=2048, num_hidden_layers=24,
                       num_attention_heads=32, intermediate_size=8192,
                       vocab_size=50176, max_position_embeddings=2048),
    "ernie-3.5-10b": dict(hidden_size=4096, num_hidden_layers=48,
                          num_attention_heads=32,
                          intermediate_size=16384, vocab_size=50176,
                          max_position_embeddings=2048),
}


class ErnieConfig:
    def __init__(self, vocab_size=40000, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, hidden_act="gelu",
                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                 max_position_embeddings=2048, type_vocab_size=4,
                 initializer_range=0.02, pad_token_id=0,
                 layer_norm_eps=1e-12, **extra):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.hidden_act = hidden_act
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.initializer_range = initializer_range
        self.pad_token_id = pad_token_id
        self.layer_norm_eps = layer_norm_eps
        for k, v in extra.items():
            setattr(self, k, v)

    @classmethod
    def from_preset(cls, name: str, **overrides) -> "ErnieConfig":
        cfg = dict(ERNIE_PRESETS[name])
        cfg.update(overrides)
        return cls(**cfg)


class ErnieEmbeddings(nn.Module):
    def __init__(self, config: ErnieConfig, keys=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.word_embeddings = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size, **kw)
        self.position_embeddings = Embedding(
            config.max_position_embeddings, config.hidden_size, **kw)
        self.token_type_embeddings = Embedding(
            config.type_vocab_size, config.hidden_size, **kw)
        self.layer_norm = LayerNorm(config.hidden_size,
                                    epsilon=config.layer_norm_eps, **kw)
        self.dropout = Dropout(config.hidden_dropout_prob, keys=keys)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        s = input_ids.shape[1]
        emb = self.word_embeddings(input_ids)
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device)[None]
        emb = emb + self.position_embeddings(position_ids)
        if token_type_ids is None:
            tok = amp.cast(self.token_type_embeddings.weight[0])
        else:
            tok = self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(emb + tok))


class ErniePooler(nn.Module):
    def __init__(self, hidden_size, device=None, dtype=torch.float32):
        super().__init__()
        self.dense = Linear(hidden_size, hidden_size, device=device,
                            dtype=dtype)

    def forward(self, hidden_states):
        return PF.tanh(self.dense(hidden_states[:, 0]))


class ErnieModel(nn.Module):
    """Backbone: embeddings + N post-LN transformer layers + pooler."""

    def __init__(self, config: ErnieConfig, keys=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.config = config
        self.embeddings = ErnieEmbeddings(config, keys=keys, **kw)
        self.layers = nn.ModuleList([
            ParallelTransformerLayer(
                config.hidden_size, config.num_attention_heads,
                config.intermediate_size,
                dropout=config.hidden_dropout_prob,
                attn_dropout=config.attention_probs_dropout_prob,
                activation=config.hidden_act, normalize_before=False,
                layer_norm_eps=config.layer_norm_eps, keys=keys, **kw)
            for _ in range(config.num_hidden_layers)])
        self.pooler = ErniePooler(config.hidden_size, **kw)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        segment_ids = None
        if attention_mask is not None and attention_mask.dim() == 2:
            # [b, s] padding mask → segment ids (attend iff equal), which
            # keeps the flash kernels engaged
            segment_ids = attention_mask.to(torch.int32)
            attention_mask = None
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        for layer in self.layers:
            x = layer(x, attn_mask=attention_mask, segment_ids=segment_ids)
        return x, self.pooler(x)


class ErnieMLMHead(nn.Module):
    """Transform + vocab projection tied to the word embedding."""

    def __init__(self, config: ErnieConfig, embedding_weights, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.transform = Linear(config.hidden_size, config.hidden_size, **kw)
        self.activation = getattr(PF, config.hidden_act)
        self.layer_norm = LayerNorm(config.hidden_size,
                                    epsilon=config.layer_norm_eps, **kw)
        self._tied_weight = embedding_weights      # [vocab, hidden]
        self.decoder_bias = nn.Parameter(torch.zeros(
            config.vocab_size, **kw), requires_grad=False)

    def forward(self, hidden_states):
        x = self.layer_norm(self.activation(self.transform(hidden_states)))
        logits = torch.matmul(x, amp.cast(self._tied_weight).t())
        return logits + amp.cast(self.decoder_bias)


class ErnieForPretraining(nn.Module):
    """MLM + next-sentence heads (the BERT-style pretraining objective).

    ``device`` defaults to the card (raising without one); ``seed``
    drives the on-device ``torch.Generator`` that fills the weights
    (N(0, ``initializer_range``) matrices, zero biases, LayerNorm 1/0);
    ``keys`` is the dropout ``KeyStream`` (default ``KeyStream(seed)``).
    Parameters require grad; the model starts in training mode."""

    def __init__(self, config: ErnieConfig, device=None,
                 dtype=torch.float32, seed: int = 0, keys=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, dtype=dtype)
        self.config = config
        self.keys = keys if keys is not None else KeyStream(seed)
        self.ernie = ErnieModel(config, keys=self.keys, **kw)
        self.cls = ErnieMLMHead(
            config, self.ernie.embeddings.word_embeddings.weight, **kw)
        self.nsp = Linear(config.hidden_size, 2, **kw)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        with torch.no_grad():
            norms = {id(p) for m in self.modules()
                     if isinstance(m, LayerNorm) for p in m.parameters()}
            for name, p in self.named_parameters():
                if id(p) in norms:
                    p.fill_(1.0 if name.endswith("weight") else 0.0)
                elif p.dim() >= 2:
                    p.normal_(0.0, config.initializer_range, generator=gen)
                else:
                    p.zero_()
        self.requires_grad_(True)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        seq, pooled = self.ernie(input_ids, token_type_ids, position_ids,
                                 attention_mask)
        return self.cls(seq), self.nsp(pooled)


def ernie_pretrain_loss(mlm_logits, nsp_logits, mlm_labels, nsp_labels,
                        ignore_index=-100):
    """Summed MLM + NSP loss with label masking (mean over valid tokens);
    under O2 the sum computes in bf16, as the JAX package's add does."""
    mlm_loss = masked_lm_loss(mlm_logits, mlm_labels,
                              ignore_index=ignore_index)
    nsp_loss = PF.cross_entropy(nsp_logits, nsp_labels, reduction="mean")
    return amp.cast(mlm_loss) + amp.cast(nsp_loss)
