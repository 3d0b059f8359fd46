"""The ragged serving step.

Port of ``paddle_infer_tpu/serving/programs.py``: ``_process_rows``,
``_pick_rows`` and ``build_mixed_step``, plain (``spec_window == 1``)
and speculative draft/verify (``spec_window = W > 1``), and
``build_page_copy`` (the prefix cache's copy-on-write).  Sampling knobs
ride as per-row tensors (the ``samp`` dict), so one program serves
every batch composition; greedy rows stay argmax-exact.

Per-row RNG: each request owns a base key ``fold_in(PRNGKey(seed),
rid)``; step ``s`` draws from ``fold_in(base, s)`` with the threefry
port in ``core/random.py`` — the reference's bits, so seeded sampled
streams match it.

The JAX package returns a jitted executable with the pools donated;
here ``build_mixed_step`` returns a callable that updates the pools in
place, and ``PagedGenerationEngine.run_paged_program`` runs it as one
CUDA graph per program key on the card (``core/graphs.py``; eager on the
CPU and inside ``disable_graphs()``).  So the step reads nothing back to
the host: sampled and greedy rows are both computed and picked per row
on the device.
"""
from __future__ import annotations

import torch

from ..core import random as prng
from ..inference import spec_accept
from ..inference.sampling import NEG_INF

# samp dict fields (all shaped [batch]):
#   temperature f32, top_k i32 (0 = off), top_p f32 (1.0 = off),
#   min_len i32, eos i32 (-1 = none), do_sample bool, pad i32


def _process_rows(logits, samp, steps):
    """Per-row logits-processor chain (min-length eos ban → temperature
    → top-k → top-p), vectorized over rows with heterogeneous knobs."""
    logits = logits.to(torch.float32)
    vocab = logits.shape[-1]
    neg = torch.full_like(logits, NEG_INF)

    eos = samp["eos"]
    banned = (eos >= 0) & (steps < samp["min_len"])
    eos_col = (torch.arange(vocab, device=logits.device)[None]
               == torch.clamp(eos, min=0).long()[:, None])
    logits = torch.where(banned[:, None] & eos_col, neg, logits)

    t = torch.clamp(samp["temperature"].to(torch.float32), min=1e-6)
    logits = logits / t[:, None]

    # per-row top-k: k=0 disables by widening to the full vocab
    top_k = samp["top_k"].long()
    k = torch.where(top_k > 0, torch.clamp(top_k, 1, vocab),
                    torch.full_like(top_k, vocab))
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    kth = torch.gather(sorted_desc, 1, (k - 1)[:, None])
    logits = torch.where(logits < kth, neg, logits)

    # per-row nucleus filter over the post-top-k logits (the top token
    # is always kept, so p=1.0 rows pass through unchanged)
    sorted2 = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted2, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < samp["top_p"][:, None]
    keep[:, 0].fill_(True)
    thresh = torch.where(keep, sorted2, torch.full_like(sorted2, torch.inf)
                         ).amin(dim=-1, keepdim=True)
    return torch.where(logits < thresh, neg, logits)


def _pick_rows(proc, samp, steps, keys):
    """Sample (per-row ``fold_in(key, step)`` stream) or argmax, per row.
    Every row draws, whatever the batch holds (no host read decides), and
    greedy rows take the argmax, so they stay argmax-exact."""
    greedy = torch.argmax(proc, dim=-1)
    sampled = prng.categorical(prng.fold_in(keys, steps), proc)
    return torch.where(samp["do_sample"], sampled, greedy).to(torch.int32)


def build_mixed_step(engine, max_batch, token_budget, max_pages,
                     spec_window=1):
    """THE ragged serving step: one call per scheduler step, whatever
    the batch composition.  Row ``b`` carries ``qlens[b]`` query tokens
    starting at absolute position ``ctx[b]`` — 1 for a decode row, >1 for
    a prefill chunk, 0 for an inactive row (tables at the scratch page).

    ``run(params, ids[b, C], qlens[b], ctx[b], steps0[b], sample_now[b],
    decode[b], tables[b, max_pages], samp, keys[b, 2], scratch[],
    k_pages, v_pages)`` → ``(tok[b], fin[b], k_pages, v_pages)``.  A
    pool is a tensor or an int8 ``(payload, scales)`` pair.

    ``decode`` flags the rows feeding their last generated token: only
    they take the decode kernel, so every prompt token goes through the
    ragged kernel however the prompt was chunked or how much of it a
    prefix hit served (``ops/ragged_paged_attention.py``).

    Each row's next-token logits sit at chunk position ``qlens - 1``;
    ``sample_now`` is False for non-final prefill chunks (the pad id is
    returned and ignored); ``steps0`` is the sampled token's
    generation-step index, which keys the ``fold_in`` stream and the
    min-length window.

    ``spec_window = W > 1`` builds the speculative variant (``EngineCore
    speculate=True``).  A speculating decode row packs ``[last_tok,
    d_1..d_k]`` (``k <= W - 1``, ``qlens = k + 1``) and its ``spec`` flag
    routes its first W positions through the verify kernel (the cache's
    seventh element), so position ``j``'s logits are bit for bit
    what sequential step ``steps0 + j`` computes.  Greedy rows accept
    the longest draft prefix matching the per-position argmax chain;
    sampled rows accept ``d_j`` with probability ``p_j(d_j)`` (drawn
    from ``fold_in(fold_in(key, step), 1)``) and resample the first
    rejection from the draft-masked residual
    (``fold_in(fold_in(key, step), 2)``).  Accepted positions use the
    same ``fold_in(key, steps0 + j)`` stream as sequential decode.  The
    per-lane work runs over ``[b * W]`` rows at once.

    Spec signature: ``run(params, ids, qlens, ctx, steps0, sample_now,
    decode, spec[b] bool, tables, samp, keys, scratch, k_pages,
    v_pages)`` →
    ``(out[b, W], n_emit[b], fin[b], k_pages, v_pages)``: row ``i``
    emits ``out[i, :n_emit[i]]`` (cut at its first eos; 0 when
    ``sample_now`` is off).  Rejected drafts' KV stays in the row's
    reservation past its length, never attended, and is overwritten
    before it becomes visible."""
    L = engine._num_layers
    C = int(token_budget)
    W = int(spec_window)

    def run(params, ids, qlens, ctx, steps0, sample_now, decode, tables,
            samp, keys, scratch, k_pages, v_pages):
        b = ids.shape[0]
        caches = [(k_pages[i], v_pages[i], tables, ctx, qlens, scratch,
                   None, decode) for i in range(L)]
        i2d = torch.arange(C, dtype=torch.int32,
                           device=ids.device)[None].expand(b, C)
        # pad positions pin to 0 so their (never attended) K/V stays
        # finite: NaN in the scratch page would poison 0-weight reads
        pos2d = torch.where(i2d < qlens[:, None], ctx[:, None] + i2d,
                            torch.zeros_like(i2d))
        logits, caches = engine._model_step(params, ids, pos2d, caches)
        idx = torch.clamp(qlens.long() - 1, min=0)
        last = logits[torch.arange(b, device=ids.device), idx]
        proc = _process_rows(last, samp, steps0)
        tok = _pick_rows(proc, samp, steps0, keys)
        tok = torch.where(sample_now, tok, samp["pad"].to(torch.int32))
        fin = sample_now & (samp["eos"] >= 0) & (tok == samp["eos"])
        return (tok, fin, [c[0] for c in caches], [c[1] for c in caches])

    if W <= 1:
        return run

    def run_spec(params, ids, qlens, ctx, steps0, sample_now, decode, spec,
                 tables, samp, keys, scratch, k_pages, v_pages):
        b = ids.shape[0]
        dev = ids.device
        spec2d = spec[:, None].expand(b, W)
        caches = [(k_pages[i], v_pages[i], tables, ctx, qlens, scratch,
                   spec2d, decode) for i in range(L)]
        i2d = torch.arange(C, dtype=torch.int32, device=dev)[None].expand(
            b, C)
        pos2d = torch.where(i2d < qlens[:, None], ctx[:, None] + i2d,
                            torch.zeros_like(i2d))
        logits, caches = engine._model_step(params, ids, pos2d, caches)

        # per-window-position logits: spec rows read positions 0..W-1
        # (clamped to their qlen), plain rows replicate qlens-1 so their
        # lane 0 is exactly the non-spec gather
        base = torch.clamp(qlens.long() - 1, min=0)                 # [b]
        j = torch.arange(W, device=dev)[None]                       # [1, W]
        gidx = torch.where(spec[:, None], torch.minimum(j, base[:, None]),
                           base[:, None])                           # [b, W]
        lg_w = logits[torch.arange(b, device=dev)[:, None], gidx]
        steps_w = steps0.long()[:, None] + torch.where(
            spec[:, None], j, torch.zeros_like(j))                  # [b, W]
        vocab = lg_w.shape[-1]
        samp_w = {k: v.repeat_interleave(W, dim=0) for k, v in samp.items()}
        proc_w = _process_rows(lg_w.reshape(b * W, vocab), samp_w,
                               steps_w.reshape(-1))
        chosen_w = _pick_rows(proc_w, samp_w, steps_w.reshape(-1),
                              keys.repeat_interleave(W, dim=0)
                              ).reshape(b, W)
        proc_w = proc_w.reshape(b, W, vocab)

        # drafts ride at ids[:, 1 + j]; lane j carries one only on spec
        # rows with j < qlens - 1
        jd = j[:, :W - 1]
        drafts = torch.gather(ids, 1, torch.clamp(jd + 1, max=C - 1)
                              .expand(b, W - 1)).to(torch.int32)
        has_draft = spec[:, None] & (jd < base[:, None])

        # greedy accept: the draft matches the per-position argmax chain;
        # sampled accept (point-mass proposal): u < p_j(d_j), u from the
        # disjoint fold_in(fold_in(key, step), 1) stream
        greedy_acc = drafts == chosen_w[:, :W - 1]
        p_w = torch.softmax(proc_w[:, :W - 1], dim=-1)
        p_draft = torch.gather(p_w, 2, drafts.long()[:, :, None])[..., 0]
        u = prng.uniform(prng.fold_in(prng.fold_in(
            keys[:, None, :], steps_w[:, :W - 1]), 1))
        samp_acc = spec_accept.rejection_accept(u, p_draft,
                                                torch.ones_like(p_draft))
        do_sample = samp["do_sample"]
        acc = torch.where(do_sample[:, None], samp_acc, greedy_acc)
        a = spec_accept.accepted_prefix_len(acc & has_draft).long()  # [b]

        # the token at the cut: the chain's own choice at position a,
        # except that a sampled rejection resamples from the residual
        # (processed logits with the draft masked)
        rows = torch.arange(b, device=dev)
        draft_a = drafts[rows, torch.clamp(a, max=W - 2)]
        resid = spec_accept.residual_logits_point_mass(proc_w[rows, a],
                                                       draft_a)
        rkeys = prng.fold_in(prng.fold_in(keys, steps0.long() + a), 2)
        resample = prng.categorical(rkeys, resid).to(torch.int32)
        rejected = do_sample & spec & (a < base)
        pick = torch.where(rejected, resample, chosen_w[rows, a])

        # window emit: accepted drafts, then the cut token, truncated at
        # the row's first eos
        drafts_full = torch.nn.functional.pad(drafts, (0, 1))       # [b, W]
        pad = samp["pad"].to(torch.int32)[:, None].expand(b, W)
        out = torch.where(j < a[:, None], drafts_full,
                          torch.where(j == a[:, None], pick[:, None], pad))
        r = a + 1
        eos = samp["eos"][:, None]
        is_eos = (eos >= 0) & (out == eos) & (j < r[:, None])
        any_eos = is_eos.any(dim=1)
        r = torch.where(any_eos, torch.argmax(is_eos.to(torch.int32), dim=1)
                        + 1, r)
        out = torch.where(sample_now[:, None] & (j < r[:, None]), out,
                          pad).to(torch.int32)
        n_emit = torch.where(sample_now, r, torch.zeros_like(r)).to(
            torch.int32)
        fin = sample_now & any_eos
        return (out, n_emit, fin, [c[0] for c in caches],
                [c[1] for c in caches])

    return run_spec


def build_page_copy(engine):
    """Copy one physical page across every layer's pools: the
    copy-on-write step for a shared partial tail block.  ``run(params,
    src[1], dst[1], k_pages, v_pages)`` → ``(src, k_pages, v_pages)``,
    the pools updated in place.  An int8 pool copies the page's scale
    row with its payload, so the copy stays bitwise.  ``EngineCore``
    runs it under one key per pool size, with ``src`` and ``dst`` staged,
    so every copy-on-write replays one graph on the card."""

    def copy(pages, src, dst):
        for t in (pages if isinstance(pages, tuple) else (pages,)):
            t.index_copy_(0, dst, t.index_select(0, src))

    def run(params, src, dst, k_pages, v_pages):
        s, d = src.long(), dst.long()
        for pages in list(k_pages) + list(v_pages):
            copy(pages, s, d)
        return (src, k_pages, v_pages)

    return run
