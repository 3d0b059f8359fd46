"""LLaMA-family decoder.

Port of ``paddle_infer_tpu/models/llama.py``: RMSNorm, rotary attention
with optional GQA, SwiGLU MLP and an untied LM head.  Parameter names
match the JAX model's ``state_dict()`` keys one to one (``weights.py``
carries them over).  The model is built directly on its device in its
dtype and filled from a seeded ``torch.Generator`` there, so a 7B model
never passes through a CPU float32 copy.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..core.random import KeyStream
from ..nn.layers import (ColumnParallelLinear, RMSNorm, RowParallelLinear,
                         VocabParallelEmbedding, mp_block)
from ..parallel import topology
from .pretrained import PretrainedMixin
from .transformer_block import ParallelSelfAttention

LLAMA_PRESETS = {
    # (hidden, layers, heads, kv_heads, ffn, vocab, max_pos, theta)
    "llama-7b": dict(hidden_size=4096, num_hidden_layers=32,
                     num_attention_heads=32, num_key_value_heads=32,
                     intermediate_size=11008, vocab_size=32000,
                     max_position_embeddings=4096, rope_theta=10000.0),
    "llama-13b": dict(hidden_size=5120, num_hidden_layers=40,
                      num_attention_heads=40, num_key_value_heads=40,
                      intermediate_size=13824, vocab_size=32000,
                      max_position_embeddings=4096, rope_theta=10000.0),
    "llama2-70b": dict(hidden_size=8192, num_hidden_layers=80,
                       num_attention_heads=64, num_key_value_heads=8,
                       intermediate_size=28672, vocab_size=32000,
                       max_position_embeddings=4096, rope_theta=10000.0),
    "llama3-8b": dict(hidden_size=4096, num_hidden_layers=32,
                      num_attention_heads=32, num_key_value_heads=8,
                      intermediate_size=14336, vocab_size=128256,
                      max_position_embeddings=8192, rope_theta=500000.0),
}


class LlamaConfig:
    def __init__(self, vocab_size=32000, hidden_size=4096,
                 num_hidden_layers=32, num_attention_heads=32,
                 num_key_value_heads=None, intermediate_size=11008,
                 max_position_embeddings=4096, rms_norm_eps=1e-6,
                 rope_theta=10000.0, initializer_range=0.02, **extra):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.num_key_value_heads = num_key_value_heads or num_attention_heads
        self.intermediate_size = intermediate_size
        self.max_position_embeddings = max_position_embeddings
        self.rms_norm_eps = rms_norm_eps
        self.rope_theta = rope_theta
        self.initializer_range = initializer_range
        for k, v in extra.items():
            setattr(self, k, v)

    @classmethod
    def from_preset(cls, name: str, **overrides) -> "LlamaConfig":
        cfg = dict(LLAMA_PRESETS[name])
        cfg.update(overrides)
        return cls(**cfg)


class LlamaMLP(nn.Module):
    """SwiGLU FFN: down(silu(gate(x)) * up(x))."""

    def __init__(self, hidden, ffn_hidden, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(has_bias=False, device=device, dtype=dtype)
        self.gate_proj = ColumnParallelLinear(hidden, ffn_hidden, **kw)
        self.up_proj = ColumnParallelLinear(hidden, ffn_hidden, **kw)
        self.down_proj = RowParallelLinear(ffn_hidden, hidden, **kw)

    def forward(self, x):
        pl = topology.get_current_placement()
        if pl is not None:
            sg, su, sd = (pl.get(self.gate_proj), pl.get(self.up_proj),
                          pl.get(self.down_proj))
            if sg is not None and su is not None and sd is not None \
                    and sg.n == su.n == sd.n > 1:
                return mp_block(x, [sg, su], lambda g, u: F.silu(g) * u, sd)
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    """Pre-RMSNorm decoder block with rotary attention."""

    def __init__(self, config: LlamaConfig, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       epsilon=config.rms_norm_eps, **kw)
        self.self_attn = ParallelSelfAttention(
            config.hidden_size, config.num_attention_heads, causal=True,
            rope_theta=config.rope_theta,
            num_kv_heads=config.num_key_value_heads, **kw)
        self.post_attention_layernorm = RMSNorm(
            config.hidden_size, epsilon=config.rms_norm_eps, **kw)
        self.mlp = LlamaMLP(config.hidden_size, config.intermediate_size,
                            **kw)

    def forward(self, x, attn_mask=None, cache=None, position_ids=None):
        h = self.self_attn(self.input_layernorm(x), attn_mask=attn_mask,
                           cache=cache, position_ids=position_ids)
        if cache is not None:
            h, new_cache = h
        x = x + h
        x = x + self.mlp(self.post_attention_layernorm(x))
        return (x, new_cache) if cache is not None else x


class LlamaModel(nn.Module):
    """Embedding, N rotary decoder blocks, final RMSNorm."""

    def __init__(self, config: LlamaConfig, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.config = config
        self.embed_tokens = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size, device=device,
            dtype=dtype)
        self.layers = nn.ModuleList([
            LlamaDecoderLayer(config, device=device, dtype=dtype)
            for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, epsilon=config.rms_norm_eps,
                            device=device, dtype=dtype)

    def forward(self, input_ids, position_ids=None, attention_mask=None,
                caches=None):
        x = self.embed_tokens(input_ids)
        new_caches = [] if caches is not None else None
        for i, layer in enumerate(self.layers):
            if caches is not None:
                x, c = layer(x, attn_mask=attention_mask, cache=caches[i],
                             position_ids=position_ids)
                new_caches.append(c)
            else:
                x = layer(x, attn_mask=attention_mask,
                          position_ids=position_ids)
        x = self.norm(x)
        return (x, new_caches) if caches is not None else x


class LlamaForCausalLM(PretrainedMixin, nn.Module):
    """Backbone plus an untied LM head ``[hidden, vocab]``.

    ``device`` defaults to the card (raising without one); ``seed``
    drives the on-device ``torch.Generator`` that fills the weights.
    Parameters require grad and the model starts in eval mode, as
    ``GPTForCausalLM``: every serving path runs under
    ``torch.inference_mode``, and ``FleetTrainStep`` trains it (the
    reference's LLaMA has no dropout; ``keys``, default
    ``KeyStream(seed)``, is the stream the step draws its key from)."""

    config_class = LlamaConfig

    def __init__(self, config: LlamaConfig, device=None,
                 dtype=torch.float32, seed: int = 0, keys=None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.keys = keys if keys is not None else KeyStream(seed)
        self.llama = LlamaModel(config, device=device, dtype=dtype)
        self.lm_head = ColumnParallelLinear(config.hidden_size,
                                            config.vocab_size,
                                            has_bias=False, device=device,
                                            dtype=dtype)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        with torch.no_grad():
            for mod in self.modules():
                if hasattr(mod, "reset_parameters"):
                    mod.reset_parameters(gen)
        self.requires_grad_(True)
        self.eval()

    def forward(self, input_ids, position_ids=None, attention_mask=None,
                caches=None):
        """Logits ``[b, s, vocab]``; ``attention_mask`` is additive
        (broadcast to ``[b, h, s, kv]``).  With ``caches`` (one cache
        tuple per layer: static, paged or ragged, see
        ``ParallelSelfAttention``) returns ``(logits, new_caches)``."""
        out = self.llama(input_ids, position_ids=position_ids,
                         attention_mask=attention_mask, caches=caches)
        if caches is not None:
            x, new_caches = out
            return self.lm_head(x), new_caches
        return self.lm_head(out)
