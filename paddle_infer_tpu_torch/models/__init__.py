"""Models of the port (LLaMA, GPT)."""
from .gpt import GPT_PRESETS, GPTConfig, GPTForCausalLM, GPTModel
from .llama import (LLAMA_PRESETS, LlamaConfig, LlamaDecoderLayer,
                    LlamaForCausalLM, LlamaMLP, LlamaModel)

__all__ = ["GPT_PRESETS", "GPTConfig", "GPTForCausalLM", "GPTModel",
           "LLAMA_PRESETS", "LlamaConfig", "LlamaDecoderLayer",
           "LlamaForCausalLM", "LlamaMLP", "LlamaModel"]
