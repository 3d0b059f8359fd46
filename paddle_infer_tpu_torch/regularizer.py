"""Weight-decay regularizers: ``L1Decay`` and ``L2Decay``.

Port of ``paddle_infer_tpu/regularizer.py``: objects passed as an
optimizer's ``weight_decay=``, which ``Optimizer.__init__`` normalizes
(L2 to its coefficient, L1 to ``coeff * sign(w)`` folded into the
gradient)."""
from __future__ import annotations

__all__ = ["L1Decay", "L2Decay"]


class L2Decay:
    """coeff/2 * ||w||^2 — folded into the gradient as coeff*w."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __repr__(self):
        return f"L2Decay(coeff={self.coeff})"


class L1Decay:
    """coeff * ||w||_1 — folded into the gradient as coeff*sign(w)."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __repr__(self):
        return f"L1Decay(coeff={self.coeff})"
