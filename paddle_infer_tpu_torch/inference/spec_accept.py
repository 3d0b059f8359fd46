"""Speculative-decoding acceptance rule.

Port of ``paddle_infer_tpu/inference/spec_accept.py``: the accept
algebra the speculative mixed step (``serving/programs.build_mixed_step``
with ``spec_window > 1``) applies to ``[batch, k]`` tensors.

  greedy   — accept the longest prefix of drafts matching the target's
             per-position argmax; the target's own choice at the first
             mismatch is the correction, after a full accept the bonus.
  sampling — accept draft ``d_j`` with probability
             ``min(1, p_j(d_j) / q_j(d_j))``; on the first rejection
             resample from ``norm(max(p - q, 0))``.  For a deterministic
             proposal (``q = one_hot(d)``) the residual is ``p`` with
             the draft masked out.

Per-row acceptance counts stay device tensors; nothing here syncs.
"""
from __future__ import annotations

import torch

from .sampling import NEG_INF


def accepted_prefix_len(accept_mask):
    """Length of the accepted prefix per row: ``accept_mask [batch, k]``
    bool → ``[batch]`` int32 in ``0..k`` (the index of the first False;
    a fully-True row gives ``k``)."""
    b = accept_mask.shape[0]
    ext = torch.cat([accept_mask.to(torch.int32),
                     torch.zeros((b, 1), dtype=torch.int32,
                                 device=accept_mask.device)], dim=1)
    # the first zero: argmax over "is zero" returns the first maximum
    return torch.argmax((ext == 0).to(torch.int32), dim=1).to(torch.int32)


def rejection_accept(u, p_draft, q_draft, eps=1e-20):
    """Elementwise accept test ``u < p(d) / max(q(d), eps)``; with
    ``q_draft = 1`` (point-mass proposal) it is ``u < p(d)``."""
    return u < p_draft / torch.clamp(q_draft, min=eps)


def residual_probs(p, q, eps=1e-20):
    """Correction distribution ``max(p - q, 0)`` (unnormalised) on
    rejection; ``p`` where the residual mass vanishes."""
    resid = torch.clamp(p - q, min=0.0)
    has = resid.sum(dim=-1, keepdim=True) > eps
    return torch.where(has, resid, p)


def residual_logits_point_mass(proc_logits, draft):
    """Correction logits for a point-mass proposal: the processed logits
    ``[batch, vocab]`` with each row's ``draft [batch]`` id masked to
    ``NEG_INF`` (``categorical`` renormalises)."""
    vocab = proc_logits.shape[-1]
    hit = (torch.arange(vocab, device=proc_logits.device)[None]
           == draft.long()[:, None])
    return torch.where(hit, torch.full_like(proc_logits, NEG_INF),
                       proc_logits)
