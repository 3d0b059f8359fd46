"""Single-device layers of the port, and the gradient clips re-exported
as the reference's ``nn`` does."""
from ..optimizer.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                              ClipGradByValue)

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue"]
