"""Single-device layers of the port, and the gradient clips re-exported
as the reference's ``nn`` does."""
from ..optimizer.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                              ClipGradByValue)
from .layers import (CrossEntropyLoss, Dropout, Embedding, LayerNorm,
                     Linear, ReLU, Sequential)

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "CrossEntropyLoss", "Dropout", "Embedding", "LayerNorm", "Linear",
           "ReLU", "Sequential"]
