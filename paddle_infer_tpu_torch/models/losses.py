"""Shared loss utilities (port of ``paddle_infer_tpu/models/losses.py``)."""
from __future__ import annotations

from .. import amp
from ..nn import functional as PF


def masked_lm_loss(logits, labels, ignore_index=-100):
    """Mean cross-entropy over tokens whose label != ``ignore_index``,
    the ``+1e-6`` in the denominator keeping an all-masked batch finite.
    Under O2 the product and the division compute in bf16 and the sums
    in float32, as the JAX package's ops do; under O1 only the sums are
    ruled (float32)."""
    loss = PF.cross_entropy(logits, labels, reduction="none",
                            ignore_index=ignore_index)
    valid = (labels != ignore_index).float()
    prod = amp.cast(loss, "multiply") * amp.cast(valid, "multiply")
    num = amp.cast(prod, "sum").sum()
    den = amp.cast(amp.cast(valid, "sum").sum(), "add") + 1e-6
    return amp.cast(num, "divide") / amp.cast(den, "divide")
