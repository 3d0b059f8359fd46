"""Whole-batch logits processors and the token draw.

Port of ``paddle_infer_tpu/inference/sampling.py``: every transform is a
tensor function over the full ``[batch, vocab]`` logits with one knob
for the whole batch — what the engines' ``generate`` / ``stream`` loops
use.  Nothing reads back to the host, so a decode step that calls them
runs as one CUDA graph.  Draws come from ``core/random.py``, the
reference's threefry bits, so sampled tokens equal the JAX package's.
The serving plane's per-row processors (one knob per row) live in
``serving/programs.py``.
"""
from __future__ import annotations

import torch

from ..core import random as prng

# additive mask value of the logits processors (not attention's -1e30)
NEG_INF = -1e9


def device_scalar(x, device):
    """An int or a 0-d tensor as a 0-d tensor on ``device``, made there
    (no host copy: a CUDA graph capture can hold it)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.full((), int(x), dtype=torch.int64, device=device)


def _neg(logits):
    return torch.full((), NEG_INF, dtype=logits.dtype, device=logits.device)


def apply_temperature(logits, temperature):
    """Scale logits by ``1 / T`` (``T`` floored at 1e-6)."""
    t = max(float(temperature), 1e-6)
    return logits / torch.full((), t, dtype=logits.dtype,
                               device=logits.device)


def apply_top_k(logits, k):
    """Keep the ``k`` highest logits per row, the rest to ``NEG_INF``."""
    vocab = logits.shape[-1]
    k = max(1, min(int(k), vocab))
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, _neg(logits), logits)


def apply_top_p(logits, p):
    """Nucleus filter: the token ranked ``r`` survives iff the sorted
    probability mass before it is ``< p``; the top token always does."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits.to(torch.float32), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < p
    keep[..., 0] = True
    thresh = torch.where(keep, sorted_logits,
                         torch.full_like(sorted_logits, torch.inf)
                         ).amin(dim=-1, keepdim=True)
    return torch.where(logits < thresh, _neg(logits), logits)


def apply_min_length(logits, eos_token_id, cur_len, min_length):
    """Forbid EOS while ``cur_len < min_length`` (``cur_len`` an int or a
    0-d tensor on the device)."""
    if eos_token_id is None or min_length <= 0:
        return logits
    col = torch.arange(logits.shape[-1], device=logits.device)
    ban = (col == int(eos_token_id)) & (
        device_scalar(cur_len, logits.device) < int(min_length))
    return torch.where(ban, _neg(logits), logits)


def apply_repetition_penalty(logits, token_history, penalty):
    """CTRL-style penalty: logits of tokens seen in ``token_history``
    ``[batch, hist]`` (-1 marks an empty slot) are divided by
    ``penalty`` where positive, multiplied where not."""
    if penalty == 1.0:
        return logits
    vocab = logits.shape[-1]
    hist = torch.where(token_history < 0, vocab, token_history).long()
    seen = torch.zeros(hist.shape[0], vocab + 1, dtype=torch.bool,
                       device=logits.device)
    seen.scatter_(1, hist, True)
    pen = torch.full((), float(penalty), dtype=logits.dtype,
                     device=logits.device)
    penalized = torch.where(logits > 0, logits / pen, logits * pen)
    return torch.where(seen[:, :vocab], penalized, logits)


def process_logits(logits, temperature=1.0, top_k=0, top_p=1.0,
                   token_history=None, repetition_penalty=1.0,
                   eos_token_id=None, cur_len=None, min_length=0):
    """The processor chain in the reference's order: penalty, min
    length, temperature, top-k, top-p; float32 out."""
    logits = logits.to(torch.float32)
    if token_history is not None and repetition_penalty != 1.0:
        logits = apply_repetition_penalty(logits, token_history,
                                          repetition_penalty)
    if cur_len is not None:
        logits = apply_min_length(logits, eos_token_id, cur_len, min_length)
    if temperature != 1.0:
        logits = apply_temperature(logits, temperature)
    if top_k and top_k > 0:
        logits = apply_top_k(logits, top_k)
    if top_p < 1.0:
        logits = apply_top_p(logits, top_p)
    return logits


def sample_token(logits, key, do_sample):
    """Greedy argmax, or one categorical draw for the whole batch from
    the single ``key`` ``[2]`` (``jax.random.categorical(key, logits)``);
    int32 ``[batch]``."""
    if do_sample:
        return prng.categorical(key, logits).to(torch.int32)
    return torch.argmax(logits, dim=-1).to(torch.int32)
