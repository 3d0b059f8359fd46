"""GPT-family causal decoder.

Port of ``paddle_infer_tpu/models/gpt.py``: word plus learned position
embeddings, N pre-LN ``ParallelTransformerLayer`` blocks, a final
LayerNorm and an LM head tied to the word embedding.  Parameter names
match the JAX model's ``state_dict()`` keys one to one
(``weights.py`` carries them over).  Like the LLaMA port, the model is
built on its device in its dtype and filled from a seeded
``torch.Generator`` there.  Dropout is an identity at inference and is
not kept; MoE FFNs (``num_experts > 1``) raise.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import resolve_device
from ..nn.layers import Embedding, LayerNorm, VocabParallelEmbedding
from .transformer_block import ParallelTransformerLayer

GPT_PRESETS = {
    "gpt2-small": dict(hidden_size=768, num_hidden_layers=12,
                       num_attention_heads=12, intermediate_size=3072,
                       vocab_size=50304, max_position_embeddings=1024),
    "gpt2-medium": dict(hidden_size=1024, num_hidden_layers=24,
                        num_attention_heads=16, intermediate_size=4096,
                        vocab_size=50304, max_position_embeddings=1024),
    "gpt2-large": dict(hidden_size=1280, num_hidden_layers=36,
                       num_attention_heads=20, intermediate_size=5120,
                       vocab_size=50304, max_position_embeddings=1024),
    "gpt3-1.3b": dict(hidden_size=2048, num_hidden_layers=24,
                      num_attention_heads=32, intermediate_size=8192,
                      vocab_size=50304, max_position_embeddings=2048),
    "gpt3-6.7b": dict(hidden_size=4096, num_hidden_layers=32,
                      num_attention_heads=32, intermediate_size=16384,
                      vocab_size=50304, max_position_embeddings=2048),
    "llama-7b": dict(hidden_size=4096, num_hidden_layers=32,
                     num_attention_heads=32, intermediate_size=11008,
                     vocab_size=32000, max_position_embeddings=4096,
                     hidden_act="silu"),
}


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, hidden_act="gelu",
                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                 max_position_embeddings=1024, initializer_range=0.02,
                 layer_norm_eps=1e-5, **extra):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.hidden_act = hidden_act
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.max_position_embeddings = max_position_embeddings
        self.initializer_range = initializer_range
        self.layer_norm_eps = layer_norm_eps
        for k, v in extra.items():
            setattr(self, k, v)

    @classmethod
    def from_preset(cls, name: str, **overrides) -> "GPTConfig":
        cfg = dict(GPT_PRESETS[name])
        cfg.update(overrides)
        return cls(**cfg)


class GPTModel(nn.Module):
    """Backbone: word + position embeddings, N pre-LN causal blocks,
    final LayerNorm."""

    def __init__(self, config: GPTConfig, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.config = config
        self.word_embeddings = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size, **kw)
        self.position_embeddings = Embedding(
            config.max_position_embeddings, config.hidden_size, **kw)
        self.layers = nn.ModuleList([
            ParallelTransformerLayer(
                config.hidden_size, config.num_attention_heads,
                config.intermediate_size, dropout=0.0,
                activation=config.hidden_act, normalize_before=True,
                causal=True, layer_norm_eps=config.layer_norm_eps,
                num_experts=getattr(config, "num_experts", 1), **kw)
            for _ in range(config.num_hidden_layers)])
        self.final_norm = LayerNorm(config.hidden_size,
                                    epsilon=config.layer_norm_eps, **kw)

    def forward(self, input_ids, position_ids=None, attention_mask=None,
                caches=None):
        x = self.word_embeddings(input_ids)
        if position_ids is None:
            # dense forward: positions 0..s-1 (the serving step always
            # passes its per-row positions)
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)[None]
        x = x + self.position_embeddings(position_ids)
        new_caches = [] if caches is not None else None
        for i, layer in enumerate(self.layers):
            if caches is not None:
                x, c = layer(x, attention_mask, cache=caches[i])
                new_caches.append(c)
            else:
                x = layer(x, attention_mask)
        x = self.final_norm(x)
        return (x, new_caches) if caches is not None else x


class GPTForCausalLM(nn.Module):
    """Backbone plus an LM head tied to ``word_embeddings``.

    ``device`` defaults to the card (raising without one); ``seed``
    drives the on-device ``torch.Generator`` that fills the weights."""

    def __init__(self, config: GPTConfig, device=None, dtype=torch.float32,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.gpt = GPTModel(config, device=device, dtype=dtype)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        with torch.no_grad():
            for mod in self.modules():
                if hasattr(mod, "reset_parameters"):
                    mod.reset_parameters(gen)
        self.eval()

    def forward(self, input_ids, position_ids=None, attention_mask=None,
                caches=None):
        """Logits ``[b, s, vocab]``; ``attention_mask`` is additive
        (broadcast to ``[b, h, s, kv]``).  With ``caches`` (one cache
        tuple per layer: static, paged or ragged, see
        ``ParallelSelfAttention``) returns ``(logits, new_caches)``."""
        out = self.gpt(input_ids, position_ids=position_ids,
                       attention_mask=attention_mask, caches=caches)
        x, new_caches = out if caches is not None else (out, None)
        logits = torch.matmul(x, self.gpt.word_embeddings.weight.t())
        return (logits, new_caches) if caches is not None else logits
