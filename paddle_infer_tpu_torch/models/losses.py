"""Shared loss utilities (port of ``paddle_infer_tpu/models/losses.py``)."""
from __future__ import annotations

from .. import amp
from ..nn import functional as PF


def masked_lm_loss(logits, labels, ignore_index=-100):
    """Mean cross-entropy over tokens whose label != ``ignore_index``,
    the ``+1e-6`` in the denominator keeping an all-masked batch finite.
    Under O2 the product and the division compute in bf16 and the sums
    in float32, as the JAX package's ops do."""
    loss = PF.cross_entropy(logits, labels, reduction="none",
                            ignore_index=ignore_index)
    valid = (labels != ignore_index).float()
    num = amp.black(amp.cast(loss) * amp.cast(valid)).sum()
    den = amp.cast(amp.black(valid).sum()) + 1e-6
    return amp.cast(num) / den
