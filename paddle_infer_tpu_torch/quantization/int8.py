"""Int8-activation serving: int8 × int8 matmul with static activation
scales.

Port of ``paddle_infer_tpu/quantization/int8.py``.  Calibrated (QAT /
PTQ) activation scales quantize the matmul inputs, so the product runs
int8 × int8 and accumulates exactly in int32 — the reference asks XLA
for ``preferred_element_type=jnp.int32``.  On the card that product is
``torch._int_mm`` (cuBLASLt IMMA); it needs more than 16 rows and an
inner and outer dim divisible by 8, so the operands are padded with
zeros to fit, which leaves every sum exact.  Its tensor-core kernel
takes the weight column-major (the "tn" layout): ``Int8Linear`` keeps
its ``[in, out]`` payload in that layout, as a row-major weight falls
to a kernel several times slower.  On the CPU the product is an int32
matmul.  On an mp serving mesh the int8 weight and per-channel scales
split as the source layer's shards split, each shard's product runs on
its slice, and a row layer's int32 partial sums add exactly before the
one scaling.  A float32 product would not do: at K = 4096 the sums pass
2^24 (127 · 127 · 4096 ≈ 6.6e7).
"""
from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F


def _round_up(n, m):
    return -(-n // m) * m


def int8_matmul(xq, qw):
    """Exact ``xq [M, K] @ qw [K, N]`` of int8 operands, int32 out."""
    if xq.device.type != "cuda":
        return torch.matmul(xq.to(torch.int32), qw.to(torch.int32))
    M, K = xq.shape
    N = qw.shape[1]
    Mp, Kp, Np = max(_round_up(M, 8), 24), _round_up(K, 8), _round_up(N, 8)
    if (Mp, Kp) != (M, K):
        xq = F.pad(xq, (0, Kp - K, 0, Mp - M))
    if (Kp, Np) != (K, N):
        qw = F.pad(qw, (0, Np - N, 0, Kp - K)).t().contiguous().t()
    acc = torch._int_mm(xq, qw)
    return acc[:M, :N]


def int8_accumulate(x, qw, act_scale):
    """The int32 accumulator of ``int8_linear``: ``x`` quantized by the
    static ``act_scale``, times the int8 weight."""
    inv = 1.0 / float(act_scale)
    xq = torch.clamp(torch.round(x.to(torch.float32) * inv),
                     -127, 127).to(torch.int8)
    lead = xq.shape[:-1]
    acc = int8_matmul(xq.reshape(-1, xq.shape[-1]), qw)
    return acc.reshape(*lead, qw.shape[1])


def int8_linear(x, qw, w_scale, bias=None, act_scale=1.0):
    """``x [..., in]`` float; ``qw [in, out]`` int8; ``w_scale [out]``
    float32 (per channel); the static ``act_scale`` quantizes the
    activations symmetrically."""
    acc = int8_accumulate(x, qw, act_scale)
    y = acc.to(torch.float32) * (w_scale[None] * float(act_scale))
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(x.dtype)


class Int8Linear(nn.Module):
    """Deploy-time linear with int8 weights AND int8 activations, built
    from a float linear and an observed activation scale; not trained.
    Its buffers are not part of the state dict, as the reference layer's
    arrays are not."""

    def __init__(self, in_features, out_features, act_scale, bias=True):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.act_scale = float(act_scale)
        for name in ("qweight", "w_scale", "bias"):
            self.register_buffer(name, None, persistent=False)

    @classmethod
    def from_linear(cls, linear, act_scale):
        """Per-channel absmax quantization of ``linear``'s weight, in
        float32 on its device."""
        w = linear.weight.detach().to(torch.float32)          # [in, out]
        scale = torch.clamp(w.abs().amax(dim=0), min=1e-8) / 127.0
        qw = torch.clamp(torch.round(w / scale[None]), -127,
                         127).to(torch.int8)
        lay = cls(w.shape[0], w.shape[1], act_scale,
                  bias=linear.bias is not None)
        # column-major [in, out]: the layout of the card's IMMA kernel
        lay.qweight = qw.t().contiguous().t()
        lay.w_scale = scale
        if linear.bias is not None:
            lay.bias = linear.bias.detach()
        # on an mp mesh the int8 weight and its scales split as the
        # source layer's weight splits (nn.layers.LinearShards)
        lay._mp_kind = getattr(linear, "_KIND", None)
        if hasattr(linear, "_qkv_heads"):
            lay._qkv_heads = linear._qkv_heads
        return lay

    def forward(self, x):
        return int8_linear(x, self.qweight, self.w_scale, self.bias,
                           act_scale=self.act_scale)

    def extra_repr(self):
        return (f"in={self.in_features}, out={self.out_features}, "
                f"act_scale={self.act_scale:.4g}, int8xint8")


def convert_int8(model, default_act_scale=None):
    """Swap observer-wrapped (QAT / PTQ) linears for ``Int8Linear`` with
    their observed activation scales."""
    from .slim import QuantedLayer, _linear_kinds, _swap

    def make(q):
        inner = q.inner
        if isinstance(inner, _linear_kinds()):
            scale = float(q.act_scale.item())
            if scale <= 0:
                if not default_act_scale:
                    raise ValueError(
                        "convert_int8: layer has no observed activation "
                        "scale — run calibration batches (PTQ) or pass "
                        "default_act_scale")
                scale = default_act_scale
            return Int8Linear.from_linear(inner, scale)
        return inner

    return _swap(model, (QuantedLayer,), make)
