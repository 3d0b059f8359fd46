"""Models of the port (LLaMA, GPT, ERNIE)."""
from .ernie import (ERNIE_PRESETS, ErnieConfig, ErnieForPretraining,
                    ErnieModel, ernie_pretrain_loss)
from .gpt import GPT_PRESETS, GPTConfig, GPTForCausalLM, GPTModel
from .llama import (LLAMA_PRESETS, LlamaConfig, LlamaDecoderLayer,
                    LlamaForCausalLM, LlamaMLP, LlamaModel)

__all__ = ["ERNIE_PRESETS", "ErnieConfig", "ErnieForPretraining",
           "ErnieModel", "ernie_pretrain_loss",
           "GPT_PRESETS", "GPTConfig", "GPTForCausalLM", "GPTModel",
           "LLAMA_PRESETS", "LlamaConfig", "LlamaDecoderLayer",
           "LlamaForCausalLM", "LlamaMLP", "LlamaModel"]
