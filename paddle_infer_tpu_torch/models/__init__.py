"""Models of the port (LLaMA, GPT, GPT-MoE, ERNIE and its BERT names)
and their checkpoint directories (``AutoModel``, ``save_pretrained`` /
``from_pretrained``)."""
from .bert import (BertConfig, BertForPretraining,
                   BertForSequenceClassification, BertModel)
from .ernie import (ERNIE_PRESETS, ErnieConfig, ErnieForMaskedLM,
                    ErnieForPretraining, ErnieForSequenceClassification,
                    ErnieModel, ernie_pretrain_loss)
from .gpt import (GPT_PRESETS, GPTConfig, GPTForCausalLM, GPTModel,
                  gpt_lm_loss)
from .gpt_moe import GPTMoEForCausalLM, GPTMoEModel, MoEConfig
from .llama import (LLAMA_PRESETS, LlamaConfig, LlamaDecoderLayer,
                    LlamaForCausalLM, LlamaMLP, LlamaModel)
from .pretrained import AutoConfig, AutoModel, PretrainedMixin

__all__ = ["AutoConfig", "AutoModel", "PretrainedMixin",
           "BertConfig", "BertForPretraining",
           "BertForSequenceClassification", "BertModel",
           "ERNIE_PRESETS", "ErnieConfig", "ErnieForMaskedLM",
           "ErnieForPretraining", "ErnieForSequenceClassification",
           "ErnieModel", "ernie_pretrain_loss",
           "GPT_PRESETS", "GPTConfig", "GPTForCausalLM", "GPTModel",
           "gpt_lm_loss", "GPTMoEForCausalLM", "GPTMoEModel", "MoEConfig",
           "LLAMA_PRESETS", "LlamaConfig", "LlamaDecoderLayer",
           "LlamaForCausalLM", "LlamaMLP", "LlamaModel"]
