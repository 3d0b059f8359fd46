"""Generation engines: the dense one over static KV buffers and the paged
one the serving plane stands on.

Port of ``paddle_infer_tpu/inference/generation.py``:

* ``GenerationEngine`` — ``generate`` over static per-layer buffers
  ``[b, cache_len, h, d]``: left-padded prompts, an additive pad mask,
  the sampled / greedy loop (``_build_sample``) and beam search with a
  whole-cache reorder every step (``_build_beam``), eagerly on the
  engine's device.
* ``PagedGenerationEngine`` — the same entry points over the paged KV
  pools that ``serving.EngineCore`` drives through ``run_paged_program``
  (native block pool, per-layer pools, parameter snapshot): ``generate``
  and ``stream`` for greedy and sampled decoding and paged beam search
  over forked prompt pages.  Each prompt is one prefill program and the
  decode loop a series of chunk programs of a fixed number of steps;
  on the card each program key runs as one CUDA graph (``core/graphs.py``)
  whose decode steps walk the pages with the decode kernel and whose
  prefill attends through the flash forward kernel.

The JAX package runs each decode loop as one ``while_loop`` that stops
when every row has finished.  Here the host reads the "every row
finished" flag once per chunk: a finished row emits ``pad_token_id``
and keeps its score, exactly what the reference emits for it after the
loop stops, so the tokens and scores equal the reference's whatever the
chunk length.  Mesh serving and the quantized all-reduce are not ported
and raise.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import native, resolve_device
from ..core import random as prng
from ..core.graphs import ProgramCache, StagedInputs
from ..ops.paged_attention import KV_SCALE_EPS
from . import sampling

# decode steps per chunk program of ``generate`` and paged beam search:
# the host reads the stop flag once per chunk
STOP_EVERY = 8


@dataclass
class GenerationConfig:
    """Decode-time knobs (same fields and defaults as the reference)."""

    max_new_tokens: int = 64
    min_length: int = 0
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    num_beams: int = 1
    length_penalty: float = 1.0
    repetition_penalty: float = 1.0
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0
    seed: int = 0

    def cache_key(self):
        return (self.max_new_tokens, self.min_length, self.do_sample,
                self.temperature, self.top_k, self.top_p, self.num_beams,
                self.length_penalty, self.repetition_penalty,
                self.eos_token_id, self.pad_token_id)


def _round_up(n, mult):
    return ((n + mult - 1) // mult) * mult


def _check_positions(plen_raw, budget, max_positions):
    if plen_raw + budget > max_positions:
        raise ValueError(
            f"prompt {plen_raw} + generation budget {budget} exceeds "
            f"max_position_embeddings {max_positions}")


def _as_ids(input_ids):
    ids = np.array(input_ids.detach().cpu() if isinstance(
        input_ids, torch.Tensor) else input_ids).astype(np.int32)
    return ids[None, :] if ids.ndim == 1 else ids


def _split(rng):
    """``key, rng = jax.random.split(rng)`` on the key's device."""
    ks = prng.split_on_device(rng)
    return ks[0], ks[1]


def _step_index(step, b, device):
    """A step (int or 0-d tensor) as a long column ``[b, 1]``."""
    return sampling.device_scalar(step, device).long().reshape(1, 1) \
        .expand(b, 1)


def _top_k_stable(x, k):
    """``jax.lax.top_k`` over the last axis: equal values keep their
    index order (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# ---------------------------------------------------------- beam algebra

def _beam_first(last, g, b, W):
    """The first beam step from the prompt logits ``[b, V]`` (only beam 0
    is live: every beam shares the prefix).  Returns ``(src, tok, cum,
    fin, gen_len, out)``."""
    dev = last.device
    logp = torch.log_softmax(last.to(torch.float32), dim=-1)
    vocab = logp.shape[-1]
    if g.eos_token_id is not None and g.min_length > 0:
        logp = sampling.apply_min_length(logp, g.eos_token_id, 0,
                                         g.min_length)
    bias = torch.where(torch.arange(W, device=dev) == 0,
                       torch.zeros((), device=dev),
                       torch.full((), sampling.NEG_INF, device=dev))
    flat = (logp[:, None, :] + bias[None, :, None]).reshape(b, W * vocab)
    cum, top_i = _top_k_stable(flat, W)
    src = top_i // vocab
    tok = (top_i % vocab).to(torch.int32)
    fin = (tok == g.eos_token_id) if g.eos_token_id is not None \
        else torch.zeros((b, W), dtype=torch.bool, device=dev)
    gen_len = torch.ones((b, W), dtype=torch.int32, device=dev)
    out = torch.full((b, W, g.max_new_tokens), g.pad_token_id,
                     dtype=torch.int32, device=dev)
    out[:, :, 0] = tok
    return src, tok, cum, fin, gen_len, out


def _beam_next(last, step, cum, fin, gen_len, out, g, b, W):
    """One beam step from the beams' logits ``[b*W, V]`` at generation
    step ``step``: finished beams continue only with pad at an unchanged
    score, the top W of ``cum + logp`` over W·V survive.  Returns
    ``(src, tok, cum, fin, gen_len, out)`` reordered to the survivors."""
    dev = last.device
    logp = torch.log_softmax(last.to(torch.float32), dim=-1)
    vocab = logp.shape[-1]
    logp = logp.reshape(b, W, vocab)
    col = torch.arange(vocab, device=dev)
    neg = torch.full((), sampling.NEG_INF, device=dev)
    logp = sampling.apply_min_length(logp, g.eos_token_id, step,
                                     g.min_length)
    pad_row = torch.where(col == g.pad_token_id, torch.zeros((), device=dev),
                          neg)
    logp = torch.where(fin[:, :, None], pad_row, logp)
    flat = (cum[:, :, None] + logp).reshape(b, W * vocab)
    cum, top_i = _top_k_stable(flat, W)
    src = top_i // vocab
    nxt = (top_i % vocab).to(torch.int32)
    out = torch.gather(out, 1, src[:, :, None].expand_as(out))
    fin = torch.gather(fin, 1, src)
    gen_len = torch.gather(gen_len, 1, src) + (~fin).to(torch.int32)
    if g.eos_token_id is not None:
        fin = fin | (nxt == g.eos_token_id)
    out = out.scatter(2, _step_index(step, b, dev)[:, None, :]
                      .expand(b, W, 1), nxt[:, :, None])
    return src, nxt, cum, fin, gen_len, out


def _beam_final(cum, gen_len, out, length_penalty):
    """The length-penalized best beam of each row: ``(seq [b, max_new],
    score [b])``."""
    norm = cum / gen_len.to(torch.float32).pow(float(length_penalty))
    best = torch.argmax(norm, dim=1)
    rows = torch.arange(out.shape[0], device=out.device)
    return out[rows, best], norm[rows, best]


class GenerationEngine:
    """Generator over a causal LM (``forward(input_ids, position_ids,
    attention_mask, caches)`` returning ``(logits, new_caches)`` with
    caches) with static per-layer KV buffers.

    ``device`` defaults to the card and must be where the model's
    parameters live.  ``mesh`` and ``quantized_allreduce`` (mesh
    serving) are not ported and raise."""

    def __init__(self, model, cache_bucket: int = 128,
                 prompt_bucket: int = 64, cache_dtype=None, mesh=None,
                 quantized_allreduce: Optional[str] = None, device=None):
        unported = [n for n, v in (("mesh", mesh),
                                   ("quantized_allreduce",
                                    quantized_allreduce)) if v is not None]
        if unported:
            raise NotImplementedError(
                f"GenerationEngine options not ported yet: "
                f"{', '.join(unported)}; see ROADMAP.md")
        self.device = resolve_device(device)
        first = next(model.parameters())
        if first.device.type != self.device.type:
            raise ValueError(f"model parameters are on {first.device}, "
                             f"engine device is {self.device}")
        model.eval()
        self._model = model
        cfg = model.config
        self._num_layers = cfg.num_hidden_layers
        self._num_heads = cfg.num_attention_heads
        self._head_dim = cfg.hidden_size // cfg.num_attention_heads
        self._max_positions = cfg.max_position_embeddings
        self._cache_bucket = int(cache_bucket)
        self._prompt_bucket = int(prompt_bucket)
        self._params = None
        self.refresh_params()
        # the first floating parameter decides the KV dtype
        self._cache_dtype = cache_dtype or next(
            (p.dtype for p in self._params.values()
             if p.dtype.is_floating_point), torch.float32)

    # ----------------------------------------------------------- plumbing
    def refresh_params(self):
        """Re-snapshot the model's parameters (the dict every forward
        receives), honouring weights replaced after construction."""
        self._params = dict(self._model.named_parameters())
        return self._params

    def _model_step(self, params, ids, position_ids, caches,
                    attention_mask=None):
        """One forward over the model with ``params`` swapped in; returns
        ``(logits, new_caches)``."""
        kw = {"position_ids": position_ids, "caches": caches}
        if attention_mask is not None:
            kw["attention_mask"] = attention_mask
        with torch.inference_mode():
            return torch.func.functional_call(self._model, params, (ids,),
                                              kw)

    def _empty_caches(self, batch, cache_len):
        shape = (batch, cache_len, self._num_heads, self._head_dim)
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        return [(torch.zeros(shape, dtype=self._cache_dtype,
                             device=self.device),
                 torch.zeros(shape, dtype=self._cache_dtype,
                             device=self.device), zero)
                for _ in range(self._num_layers)]

    def _pad_mask_add(self, prompt_mask, cache_len):
        """``[b, plen]`` 0/1 prompt mask → additive ``[b, 1, 1,
        cache_len]`` over the buffer: pad slots ``NEG_INF``, slots past
        the prompt 0 (``kv_cache_mask`` rules those)."""
        b, plen = prompt_mask.shape
        full = torch.cat([prompt_mask, torch.ones(
            (b, cache_len - plen), dtype=prompt_mask.dtype,
            device=prompt_mask.device)], dim=1)
        add = torch.where(full == 0,
                          torch.full((), sampling.NEG_INF,
                                     device=full.device),
                          torch.zeros((), device=full.device))
        return add[:, None, None, :]

    def _logits_picker(self, g: GenerationConfig):
        """The processor chain and the draw, shared by every loop:
        ``pick(logits [b, V], history, step, key) -> (tok, tok_logp)``."""

        def pick(logits_row, hist, step, key):
            proc = sampling.process_logits(
                logits_row, temperature=g.temperature, top_k=g.top_k,
                top_p=g.top_p, token_history=hist,
                repetition_penalty=g.repetition_penalty,
                eos_token_id=g.eos_token_id, cur_len=step,
                min_length=g.min_length)
            tok = sampling.sample_token(proc, key, g.do_sample)
            logp = torch.log_softmax(proc, dim=-1)
            return tok, torch.gather(logp, 1, tok.long()[:, None])[:, 0]

        return pick

    def _prepare(self, input_ids, attention_mask, g: GenerationConfig,
                 budget: Optional[int] = None):
        """Coerce to ``[b, plen]`` int32, move every row's tokens to the
        right end (LEFT padding: the programs read next-token logits from
        the last slot), bucket the prompt and size the buffers.  Returns
        ``(ids, mask, plen, cache_len)`` as numpy and ints."""
        budget = g.max_new_tokens if budget is None else budget
        ids = _as_ids(input_ids)
        b, plen_raw = ids.shape
        mask = (np.ones_like(ids) if attention_mask is None
                else np.array(attention_mask).astype(np.int32))
        for i in range(b):
            real = np.flatnonzero(mask[i])
            if len(real) and real[-1] != plen_raw - 1:
                n = len(real)
                row = ids[i, real]
                ids[i] = g.pad_token_id
                mask[i] = 0
                ids[i, plen_raw - n:] = row
                mask[i, plen_raw - n:] = 1
        _check_positions(plen_raw, budget, self._max_positions)
        plen = _round_up(max(plen_raw, 1), self._prompt_bucket)
        plen = max(plen_raw, min(plen, self._max_positions - budget))
        if plen > plen_raw:
            padw = plen - plen_raw
            ids = np.pad(ids, ((0, 0), (padw, 0)),
                         constant_values=g.pad_token_id)
            mask = np.pad(mask, ((0, 0), (padw, 0)), constant_values=0)
        cache_len = min(_round_up(plen + budget, self._cache_bucket),
                        self._max_positions)
        cache_len = max(cache_len, plen + budget)
        return ids, mask, plen, cache_len

    # ----------------------------------------------------- the dense loops
    def _build_sample(self, batch, plen, cache_len, g: GenerationConfig):
        """The greedy / sampled loop: prefill over the left-padded
        prompts, then one step per token, the stop flag read once every
        ``STOP_EVERY`` steps.  ``run(params, ids, mask, rng) -> (seq
        [b, max_new], score [b])``."""
        max_new = g.max_new_tokens
        pick = self._logits_picker(g)

        def run(params, ids, prompt_mask, rng):
            dev = ids.device
            lengths = prompt_mask.sum(dim=1).to(torch.int32)
            pad_add = self._pad_mask_add(prompt_mask, cache_len)
            pos = torch.clamp(torch.cumsum(prompt_mask, dim=1) - 1,
                              min=0).to(torch.int32)
            caches = self._empty_caches(batch, cache_len)
            logits, caches = self._model_step(params, ids, pos, caches,
                                              pad_add)
            out = torch.full((batch, max_new), g.pad_token_id,
                             dtype=torch.int32, device=dev)
            hist = torch.cat([torch.where(prompt_mask > 0, ids, -1),
                              torch.full((batch, max_new), -1,
                                         dtype=torch.int32, device=dev)],
                             dim=1)
            k0, rng = _split(rng)
            tok, cum = pick(logits[:, -1], hist, 0, k0)
            fin = (tok == g.eos_token_id) if g.eos_token_id is not None \
                else torch.zeros((batch,), dtype=torch.bool, device=dev)
            out[:, 0] = tok
            hist[:, plen] = tok
            for step in range(1, max_new):
                if (g.eos_token_id is not None and step % STOP_EVERY == 1
                        and bool(fin.all())):
                    break
                p = (lengths + step - 1)[:, None]
                logits, caches = self._model_step(
                    params, tok[:, None], p, caches, pad_add)
                key, rng = _split(rng)
                nxt, tok_logp = pick(logits[:, -1], hist, step, key)
                if g.eos_token_id is not None:
                    nxt = torch.where(fin, torch.full_like(
                        nxt, g.pad_token_id), nxt)
                    cum = torch.where(fin, cum, cum + tok_logp)
                    fin = fin | (nxt == g.eos_token_id)
                else:
                    cum = cum + tok_logp
                out[:, step] = nxt
                hist[:, plen + step] = nxt
                tok = nxt
            return out, cum

        return run

    def _build_beam(self, batch, plen, cache_len, g: GenerationConfig):
        """Beam search over ``b * W`` rows of static buffers (the
        reference's beam_search_softmax semantics), the buffers gathered
        into the survivors' order after every step.  ``run(params, ids,
        mask, rng) -> (seq, score)``; deterministic (``rng`` unused)."""
        W = g.num_beams
        max_new = g.max_new_tokens

        def run(params, ids, prompt_mask, rng):
            del rng
            b = batch
            lengths_w = prompt_mask.sum(dim=1).to(torch.int32) \
                .repeat_interleave(W)
            ids_w = ids.repeat_interleave(W, dim=0)
            mask_w = prompt_mask.repeat_interleave(W, dim=0)
            pad_add = self._pad_mask_add(mask_w, cache_len)
            pos = torch.clamp(torch.cumsum(mask_w, dim=1) - 1,
                              min=0).to(torch.int32)
            caches = self._empty_caches(b * W, cache_len)
            logits, caches = self._model_step(params, ids_w, pos, caches,
                                              pad_add)
            last = logits[:, -1].reshape(b, W, -1)[:, 0]
            src, tok, cum, fin, gen_len, out = _beam_first(last, g, b, W)

            def reorder(caches, src):
                rows = (torch.arange(b, device=src.device)[:, None] * W
                        + src).reshape(-1)
                return [(k.index_select(0, rows), v.index_select(0, rows),
                         i) for k, v, i in caches]

            caches = reorder(caches, src)
            for step in range(1, max_new):
                if step % STOP_EVERY == 1 and bool(fin.all()):
                    break
                p = (lengths_w + step - 1)[:, None]
                logits, caches = self._model_step(
                    params, tok.reshape(b * W, 1), p, caches, pad_add)
                src, tok, cum, fin, gen_len, out = _beam_next(
                    logits[:, -1], step, cum, fin, gen_len, out, g, b, W)
                caches = reorder(caches, src)
            return _beam_final(cum, gen_len, out, g.length_penalty)

        return run

    # ------------------------------------------------------------- public
    def generate(self, input_ids, generation_config: GenerationConfig = None,
                 attention_mask=None, return_scores: bool = False):
        """Generate continuations of ``input_ids`` ``[b, plen]`` (numpy,
        list or tensor; an optional 0/1 ``attention_mask`` marks the real
        tokens).  Returns numpy ``[b, max_new_tokens]`` (pad after EOS),
        and the scores ``[b]`` with ``return_scores``."""
        g = generation_config or GenerationConfig()
        _warn_beam_knobs(g)
        self.refresh_params()
        ids, mask, plen, cache_len = self._prepare(input_ids,
                                                   attention_mask, g)
        b = ids.shape[0]
        builder = self._build_beam if g.num_beams > 1 else \
            self._build_sample
        run = builder(b, plen, cache_len, g)
        dev = self.device
        with torch.inference_mode():
            seq, score = run(self._params,
                             torch.as_tensor(ids, device=dev),
                             torch.as_tensor(mask, device=dev),
                             prng.PRNGKey(g.seed, device=dev))
            seq, score = seq.cpu().numpy(), score.cpu().numpy()
        return (seq, score) if return_scores else seq


def _warn_beam_knobs(g):
    if g.num_beams > 1 and (g.do_sample or g.temperature != 1.0
                            or g.top_k or g.top_p < 1.0
                            or g.repetition_penalty != 1.0):
        warnings.warn(
            "beam search ignores do_sample/temperature/top_k/top_p/"
            "repetition_penalty (reference beam_search_softmax is "
            "deterministic)", UserWarning)


class PagedGenerationEngine(GenerationEngine):
    """Generation and serving over a paged KV cache: one shared physical
    page pool ``[P, h, page, d]`` per layer (K and V), per-sequence page
    tables from the native block allocator.

    Against the dense engine: prompts are RIGHT-padded (real tokens at
    positions ``0 .. len - 1``, so causal prefill never sees a pad and
    the decode kernel masks by each row's length); memory is allocated
    in pages; beam search forks pages (``KVBlockPool.fork``) — the W
    beams of a row share its prompt pages, each beam owns
    ``ceil(max_new / page) + 1`` private decode pages, the partly filled
    boundary page is copied into each beam's first private page, and
    the per-step reorder permutes only the private pages' contents.

    ``kv_dtype="int8"`` stores each pool as an int8 payload with one
    float32 scale per (page, head) (the slot-0 scale protocol of
    ``ops/paged_attention.py``): half the page bytes of bf16, a quarter
    of fp32.  ``None`` keeps pages in the model's dtype."""

    def __init__(self, model, page_size: int = 16,
                 num_pages: Optional[int] = None, prompt_bucket: int = 64,
                 cache_dtype=None, mesh=None,
                 quantized_allreduce: Optional[str] = None,
                 kv_dtype: Optional[str] = None, device=None):
        if kv_dtype not in (None, "int8"):
            if kv_dtype == "int4":
                raise NotImplementedError(
                    "kv_dtype='int4' is recognized by "
                    "validate_serving_config but the pool stores int8 "
                    "payloads only")
            raise ValueError(
                f"kv_dtype must be None or 'int8', got {kv_dtype!r}")
        self._kv_dtype = kv_dtype
        self._programs = ProgramCache()
        self._inputs = {}
        super().__init__(model, cache_bucket=page_size,
                         prompt_bucket=prompt_bucket,
                         cache_dtype=cache_dtype, mesh=mesh,
                         quantized_allreduce=quantized_allreduce,
                         device=device)
        self.page_size = int(page_size)
        self._requested_pages = num_pages
        self._pool = None
        self._k_pages = self._v_pages = None
        self._kv_lost = False
        self.last_beam_pool_stats = None

    # ----------------------------------------------------------- plumbing
    def _ensure_pool(self, need_pages: int):
        want = max(int(need_pages), self._requested_pages or 0)
        if self._pool is None or self._pool.num_blocks < want:
            self._pool = native.KVBlockPool(want, self.page_size)
            self._k_pages = self._v_pages = None     # resize device pools
        return self._pool

    def _ensure_pages(self):
        """The per-layer K and V pools ``[P, H, page, D]`` (int8: a
        ``(payload, [P, H] scales)`` pair each), made at the pool's
        size."""
        pshape = (self._pool.num_blocks, self._num_heads, self.page_size,
                  self._head_dim)
        first = None if self._k_pages is None else self._k_pages[0]
        if first is not None and isinstance(first, tuple):
            first = first[0]
        if first is None or tuple(first.shape) != pshape:
            def alloc():
                if self._kv_dtype != "int8":
                    return torch.zeros(pshape, dtype=self._cache_dtype,
                                       device=self.device)
                # scales start at the eps floor (never zero): a zeroed
                # pool dequantizes to zero, and the masked-max writer's
                # "scale > 0" invariant holds from the first step
                return (torch.zeros(pshape, dtype=torch.int8,
                                    device=self.device),
                        torch.full(pshape[:2], KV_SCALE_EPS,
                                   dtype=torch.float32, device=self.device))

            # the graphs hold the old pools: free both before allocating,
            # and bind the new pools only once both exist
            self._programs.clear()
            self._k_pages = self._v_pages = None
            k = [alloc() for _ in range(self._num_layers)]
            v = [alloc() for _ in range(self._num_layers)]
            self._k_pages, self._v_pages = k, v
        elif self._kv_lost:
            self._zero_pages()
        self._kv_lost = False
        return self._k_pages, self._v_pages

    def _zero_pages(self):
        """Reset every pool, in place, to what ``_ensure_pages`` makes:
        zeros, and int8 scales at the eps floor.  The tensors keep their
        storage, so every captured graph that holds them stays valid."""
        with torch.no_grad():
            for pages in self._k_pages + self._v_pages:
                if isinstance(pages, tuple):
                    pages[0].zero_()
                    pages[1].fill_(KV_SCALE_EPS)
                else:
                    pages.zero_()

    # ------------------------------------------------- serving resilience
    def kv_state_lost(self) -> bool:
        """True once ``drop_kv_state`` marked the pools lost, until they
        are rebuilt (their contents, every in-flight row's KV, are
        gone)."""
        return self._kv_lost

    def drop_kv_state(self):
        """Forget the pools' contents — the recovery hook for a failure
        inside a step that wrote them (``serving/resilience/``).  Where
        the JAX package drops its donated pools, this only marks them
        lost: the tensors stay bound, so the graphs that hold them stay
        valid.  ``kv_state_lost()`` reports True until ``rebuild_kv_state``
        or the next program call zeroes them."""
        self._kv_lost = True

    def rebuild_kv_state(self):
        """Zero the lost pools in place (int8 scales back to the eps
        floor) once serving recovery has released every in-flight row,
        so ``kv_state_lost()`` stops reporting a loss already serviced.
        No pool moves and no graph is recaptured."""
        self._ensure_pages()

    # ------------------------------------------------------ serving hooks
    def refresh_params(self):
        """Re-snapshot the model's parameters (the dict every program
        receives); the graphs are dropped when a tensor changed."""
        old = self._params or {}
        params = super().refresh_params()
        if params.keys() != old.keys() or any(
                p is not old[n] or p.data_ptr() != old[n].data_ptr()
                for n, p in params.items()):
            self._programs.clear()
        return params

    def release_graphs(self):
        """Free every captured graph and staging buffer (the owning
        ``EngineCore`` closes)."""
        self._programs = ProgramCache()
        self._inputs.clear()

    def program_inputs(self, key, fields) -> StagedInputs:
        """The staged host/device inputs of program ``key`` (made once:
        ``fields`` is ``[(name, shape, numpy dtype), ...]``)."""
        inp = self._inputs.get(key)
        if inp is None:
            inp = self._inputs[key] = StagedInputs(fields, self.device)
        return inp

    def serving_pool(self, num_pages: int):
        """Size the native block pool for a serving session (slots ×
        pages-per-slot + scratch) and return it.  Resizing drops the
        device pools, so EngineCore calls this once up front."""
        return self._ensure_pool(num_pages)

    def run_paged_program(self, key, builder, *args):
        """Run a program over the persistent page pools.

        ``builder()`` returns a callable ``fn(params, *args, k_pages,
        v_pages)`` whose LAST two outputs are the pools and whose leading
        outputs are returned to the caller; it is built once per ``key``.
        On the card each ``(key, argument signature)`` runs as one CUDA
        graph (``core/graphs.py``): its first call executes eagerly and
        captures, later calls replay.  The arguments are device tensors,
        best the key's staged buffers (``program_inputs``), which a
        replay reads without a copy.  The pools are updated in place and
        stay put — where the JAX package donates them into the compiled
        program and rebinds them from its outputs.  Leading outputs of a
        replay are the graph's static outputs: read them before the next
        call."""
        self._ensure_pages()
        tag = str(key[0]) if isinstance(key, tuple) and key else str(key)
        site = "serving-decode" if tag == "serve-step" else f"serving-{tag}"

        def make():
            fn = builder()
            return lambda *a: fn(self._params, *a, self._k_pages,
                                 self._v_pages)

        with torch.inference_mode():
            *rest, _, _ = self._programs.run(site, key, make, args,
                                             self.device)
        return rest

    # ------------------------------------------------- greedy and sampled
    def _prefill_caches(self, k_pages, v_pages, tables, batch):
        zero = torch.zeros((batch,), dtype=torch.int32,
                           device=tables.device)
        return [(k_pages[i], v_pages[i], tables, zero)
                for i in range(self._num_layers)]

    def _prefill_logits(self, params, ids, lengths, tables, k_pages,
                        v_pages):
        """The prompts' forward over their pages: each row's last real
        position's logits ``[b, V]`` and the pools."""
        b, plen = ids.shape
        pos = torch.arange(plen, dtype=torch.int32,
                           device=ids.device)[None].expand(b, plen)
        logits, caches = self._model_step(
            params, ids, pos, self._prefill_caches(k_pages, v_pages,
                                                   tables, b))
        last = logits[torch.arange(b, device=ids.device),
                      lengths.long() - 1]
        return last, [c[0] for c in caches], [c[1] for c in caches]

    def _build_paged_prefill(self, batch, plen, g: GenerationConfig):
        """Prefill + first token: ``run(params, ids [b, plen], lengths,
        tables, rng, k_pages, v_pages) -> (tok, fin, hist, cum, rng,
        k_pages, v_pages)``."""
        pick = self._logits_picker(g)

        def run(params, ids, lengths, tables, rng, k_pages, v_pages):
            last, k_pages, v_pages = self._prefill_logits(
                params, ids, lengths, tables, k_pages, v_pages)
            col = torch.arange(plen, device=ids.device)[None]
            hist = torch.cat([
                torch.where(col < lengths[:, None], ids, -1),
                torch.full((batch, g.max_new_tokens), -1, dtype=torch.int32,
                           device=ids.device)], dim=1)
            k0, rng = _split(rng)
            tok, cum = pick(last, hist, 0, k0)
            fin = (tok == g.eos_token_id) if g.eos_token_id is not None \
                else torch.zeros((batch,), dtype=torch.bool,
                                 device=ids.device)
            hist = _put_col(hist, plen, tok)
            return tok, fin, hist, cum, rng, k_pages, v_pages

        return run

    def _build_paged_chunk(self, batch, plen, chunk, g: GenerationConfig):
        """``chunk`` decode steps from the persistent pools, resumable at
        any step: ``run(params, step, tok, fin, hist, cum, rng, lengths,
        tables, k_pages, v_pages) -> (toks [b, chunk], step + chunk, tok,
        fin, hist, cum, rng, k_pages, v_pages)``.  Step ``s``'s input
        token lands at position ``lengths + s - 1``."""
        L = self._num_layers
        pick = self._logits_picker(g)

        def run(params, step, tok, fin, hist, cum, rng, lengths, tables,
                k_pages, v_pages):
            toks = []
            for _ in range(chunk):
                pos = lengths + step - 1
                caches = [(k_pages[i], v_pages[i], tables, pos)
                          for i in range(L)]
                logits, caches = self._model_step(params, tok[:, None],
                                                  pos[:, None], caches)
                k_pages = [c[0] for c in caches]
                v_pages = [c[1] for c in caches]
                key, rng = _split(rng)
                nxt, tok_logp = pick(logits[:, -1], hist, step, key)
                if g.eos_token_id is not None:
                    nxt = torch.where(fin, torch.full_like(
                        nxt, g.pad_token_id), nxt)
                    cum = torch.where(fin, cum, cum + tok_logp)
                    fin = fin | (nxt == g.eos_token_id)
                else:
                    cum = cum + tok_logp
                hist = _put_col(hist, plen + step, nxt)
                toks.append(nxt)
                tok = nxt
                step = step + 1
            return (torch.stack(toks, dim=1), step, tok, fin, hist, cum,
                    rng, k_pages, v_pages)

        return run

    def _paged_chunks(self, input_ids, attention_mask, g, chunk_size):
        """The greedy / sampled decode as a generator of ``(tokens
        [b, n] numpy, cum)``: the prefill's first token, then chunks of
        up to ``chunk_size`` steps until ``max_new_tokens`` or until
        every row has finished.  The rows' sequences are freed when the
        generator ends or is closed."""
        ids, lengths, plen, pages_per_seq, pool, tables = \
            self._prepare_paged_inputs(input_ids, attention_mask, g)
        b = ids.shape[0]
        try:
            self._ensure_pages()
            tail = (b, plen, pages_per_seq, pool.num_blocks, g.cache_key())
            key_p = ("paged-prefill",) + tail
            inputs = self.program_inputs(key_p, [
                ("ids", (b, plen), np.int32), ("lengths", (b,), np.int32),
                ("tables", (b, pages_per_seq), np.int32),
                ("rng", (2,), np.int64)])
            h = inputs.begin()
            h["ids"][:] = ids
            h["lengths"][:] = lengths
            h["tables"][:] = tables
            h["rng"][:] = prng.PRNGKey(g.seed).numpy()
            dev = inputs.upload()
            tok, fin, hist, cum, rng = self.run_paged_program(
                key_p, lambda: self._build_paged_prefill(b, plen, g),
                dev["ids"], dev["lengths"], dev["tables"], dev["rng"])
            emitted = 1
            yield tok.cpu().numpy()[:, None], cum
            step = torch.ones((), dtype=torch.int32, device=self.device)
            # the stop flag is read once per chunk: rows that finish
            # inside one emit the pad token and keep their score, which
            # is what the reference's output holds for them after its
            # loop stops
            while emitted < g.max_new_tokens and not bool(fin.all()):
                chunk = min(chunk_size, g.max_new_tokens - emitted)
                key_c = ("paged-chunk", chunk) + tail
                toks, step, tok, fin, hist, cum, rng = \
                    self.run_paged_program(
                        key_c,
                        lambda: self._build_paged_chunk(b, plen, chunk, g),
                        step, tok, fin, hist, cum, rng, dev["lengths"],
                        dev["tables"])
                emitted += chunk
                yield toks.cpu().numpy(), cum
        finally:
            for s in range(b):
                pool.free(s)

    def _prepare_paged_inputs(self, input_ids, attention_mask, g):
        """Right-pad every row, pad the prompt to its bucket and a page
        multiple, reserve each row's pages in the native pool (sequence
        id = row) and build the page tables.  Returns ``(ids, lengths,
        plen, pages_per_seq, pool, tables)``."""
        ids = _as_ids(input_ids)
        b, plen_raw = ids.shape
        mask = (np.ones_like(ids) if attention_mask is None
                else np.array(attention_mask).astype(np.int32))
        for i in range(b):
            real = np.flatnonzero(mask[i])
            row = ids[i, real]
            ids[i] = g.pad_token_id
            mask[i] = 0
            ids[i, :len(real)] = row
            mask[i, :len(real)] = 1
        lengths = np.maximum(mask.sum(axis=1), 1).astype(np.int32)
        _check_positions(plen_raw, g.max_new_tokens, self._max_positions)
        plen = _round_up(max(plen_raw, 1), self._prompt_bucket)
        plen = _round_up(min(plen, self._max_positions), self.page_size)
        plen = max(plen, _round_up(plen_raw, self.page_size))
        if plen > plen_raw:
            ids = np.pad(ids, ((0, 0), (0, plen - plen_raw)),
                         constant_values=g.pad_token_id)
        pages_per_seq = -(-(plen + g.max_new_tokens) // self.page_size)
        pool = self._ensure_pool(pages_per_seq * b)
        for s in range(b):
            pool.free(s)
            pool.reserve(s, plen + g.max_new_tokens)
        tables = np.zeros((b, pages_per_seq), np.int32)
        for s in range(b):
            t = pool.block_table(s)[:pages_per_seq]
            tables[s, :len(t)] = t
        return ids, lengths, plen, pages_per_seq, pool, tables

    def stream(self, input_ids, generation_config: GenerationConfig = None,
               attention_mask=None, chunk_size: int = 8):
        """Yield the decoded tokens in chunks (numpy ``[b, <= chunk]``):
        the first token from the prefill, then one chunk program of up to
        ``chunk_size`` steps at a time over the persistent pools; stops
        early once every row has hit EOS.  Beam search is not streamable
        (it finalizes globally).  Closing the generator frees the rows'
        pages."""
        g = generation_config or GenerationConfig()
        if g.num_beams > 1:
            raise ValueError("stream() supports sampling/greedy only")
        self.refresh_params()
        for toks, _ in self._paged_chunks(input_ids, attention_mask, g,
                                          int(chunk_size)):
            yield toks

    def generate(self, input_ids, generation_config: GenerationConfig = None,
                 attention_mask=None, return_scores: bool = False):
        """Generate continuations of ``input_ids`` ``[b, plen]`` over the
        page pools.  Returns numpy ``[b, max_new_tokens]`` (pad after
        EOS), and the scores ``[b]`` with ``return_scores``."""
        g = generation_config or GenerationConfig()
        _warn_beam_knobs(g)
        self.refresh_params()
        if g.num_beams > 1:
            return self._generate_paged_beam(input_ids, attention_mask, g,
                                             return_scores)
        parts = []
        for toks, cum in self._paged_chunks(input_ids, attention_mask, g,
                                            STOP_EVERY):
            parts.append(toks)
            # a replay's outputs are its graph's: read before the next
            score = cum.cpu().numpy()
        seq = np.concatenate(parts, axis=1)
        if seq.shape[1] < g.max_new_tokens:
            seq = np.pad(seq, ((0, 0), (0, g.max_new_tokens - seq.shape[1])),
                         constant_values=g.pad_token_id)
        return (seq, score) if return_scores else seq

    # --------------------------------------------------- paged beam search
    def _build_paged_beam_prefill(self, batch, plen, g: GenerationConfig):
        """Prefill once per row into its shared prompt pages, copy each
        row's boundary page into its beams' first private pages, take the
        first beam step: ``run(params, ids, lengths, tables, boundary_src,
        first_priv, k_pages, v_pages) -> (tok, cum, fin, gen_len, out,
        k_pages, v_pages)``."""
        W = g.num_beams

        def run(params, ids, lengths, tables, boundary_src, first_priv,
                k_pages, v_pages):
            last, k_pages, v_pages = self._prefill_logits(
                params, ids, lengths, tables, k_pages, v_pages)
            src_rep = boundary_src.long().repeat_interleave(W)
            dst = first_priv.long()
            for pages in k_pages + v_pages:
                pages.index_copy_(0, dst, pages.index_select(0, src_rep))
            _, tok, cum, fin, gen_len, out = _beam_first(last, g, batch, W)
            return tok, cum, fin, gen_len, out, k_pages, v_pages

        return run

    def _build_paged_beam_chunk(self, batch, chunk, g: GenerationConfig):
        """``chunk`` beam steps over ``b * W`` rows: ``run(params, step,
        tok, cum, fin, gen_len, out, lengths_w, beam_tables, priv_ids,
        k_pages, v_pages) -> (step + chunk, tok, cum, fin, gen_len, out,
        k_pages, v_pages)``.  The reorder moves only the private pages'
        contents (``priv_ids [b, W, n_priv]``): each target beam adopts
        its source beam's decode pages."""
        W = g.num_beams
        L = self._num_layers
        b = batch

        def run(params, step, tok, cum, fin, gen_len, out, lengths_w,
                beam_tables, priv_ids, k_pages, v_pages):
            priv_flat = priv_ids.reshape(-1).long()
            for _ in range(chunk):
                pos = lengths_w + step - 1
                caches = [(k_pages[i], v_pages[i], beam_tables, pos)
                          for i in range(L)]
                logits, caches = self._model_step(
                    params, tok.reshape(b * W, 1), pos[:, None], caches)
                k_pages = [c[0] for c in caches]
                v_pages = [c[1] for c in caches]
                src, tok, cum, fin, gen_len, out = _beam_next(
                    logits[:, -1], step, cum, fin, gen_len, out, g, b, W)
                src_ids = torch.gather(
                    priv_ids, 1, src[:, :, None].expand_as(priv_ids))
                src_flat = src_ids.reshape(-1).long()
                for pages in k_pages + v_pages:
                    pages.index_copy_(0, priv_flat,
                                      pages.index_select(0, src_flat))
                step = step + 1
            return step, tok, cum, fin, gen_len, out, k_pages, v_pages

        return run

    def _generate_paged_beam(self, input_ids, attention_mask, g,
                             return_scores):
        """Pool choreography of paged beam search: prompt rows own the
        shared pages; every beam is a ``KVBlockPool.fork`` of its row
        plus a reservation that appends its private decode pages."""
        if self._kv_dtype is not None:
            raise ValueError(
                "beam search over quantized KV pools is not supported "
                "(the fork/permute page choreography moves fp pages; "
                "the serving plane never batches beam requests)")
        ids, lengths, plen, _, pool, _ = self._prepare_paged_inputs(
            input_ids, attention_mask, g)
        b = ids.shape[0]
        W = g.num_beams
        page = self.page_size
        n_prompt = plen // page
        n_priv = -(-g.max_new_tokens // page) + 1
        max_pages = max(-(-(plen + g.max_new_tokens) // page), n_prompt + 1)
        prompt_sids = list(range(b))
        beam_sids = [b + i * W + w for i in range(b) for w in range(W)]
        for s in prompt_sids:          # the beam path reserves its own
            pool.free(s)
        pool = self._ensure_pool(b * (n_prompt + W * n_priv))
        try:
            for s in prompt_sids + beam_sids:
                pool.free(s)
            tables = np.zeros((b, max_pages), np.int32)
            priv_ids = np.zeros((b, W, n_priv), np.int32)
            for i in prompt_sids:
                pool.reserve(i, plen)
                t = pool.block_table(i)
                tables[i, :len(t)] = t
            for i in range(b):
                for w in range(W):
                    sid = b + i * W + w
                    pool.fork(i, sid)                # share the prompt
                    pool.reserve(sid, plen + n_priv * page)
                    priv_ids[i, w] = pool.block_table(sid)[
                        n_prompt:n_prompt + n_priv]
            self.last_beam_pool_stats = {
                "used_pages": pool.num_blocks - pool.free_blocks,
                "prompt_pages_shared": b * n_prompt,
                "private_pages": b * W * n_priv,
                "unshared_equivalent": b * W * (n_prompt + n_priv),
            }
            # per-beam tables: shared below each row's boundary page,
            # private from it on (never permuted: contents move instead)
            boundary = lengths // page
            p_idx = np.arange(max_pages)[None, None]
            rel = np.clip(p_idx - boundary[:, None, None], 0, n_priv - 1)
            priv_full = np.take_along_axis(
                priv_ids, np.broadcast_to(rel, (b, W, max_pages)), axis=2)
            beam_tables = np.where(p_idx < boundary[:, None, None],
                                   tables[:, None], priv_full)
            bsrc = tables[np.arange(b), np.minimum(boundary, max_pages - 1)]

            self._ensure_pages()
            tail = (b, plen, max_pages, n_priv, pool.num_blocks,
                    g.cache_key())
            key_p = ("paged-beam-prefill",) + tail
            inputs = self.program_inputs(key_p, [
                ("ids", (b, plen), np.int32), ("lengths", (b,), np.int32),
                ("tables", (b, max_pages), np.int32),
                ("bsrc", (b,), np.int32), ("first", (b * W,), np.int32),
                ("lengths_w", (b * W,), np.int32),
                ("beam_tables", (b * W, max_pages), np.int32),
                ("priv", (b, W, n_priv), np.int32)])
            h = inputs.begin()
            h["ids"][:] = ids
            h["lengths"][:] = lengths
            h["tables"][:] = tables
            h["bsrc"][:] = bsrc
            h["first"][:] = priv_ids[:, :, 0].reshape(-1)
            h["lengths_w"][:] = np.repeat(lengths, W)
            h["beam_tables"][:] = beam_tables.reshape(b * W, max_pages)
            h["priv"][:] = priv_ids
            dev = inputs.upload()
            tok, cum, fin, gen_len, out = self.run_paged_program(
                key_p, lambda: self._build_paged_beam_prefill(b, plen, g),
                dev["ids"], dev["lengths"], dev["tables"], dev["bsrc"],
                dev["first"])
            emitted = 1
            step = torch.ones((), dtype=torch.int32, device=self.device)
            while emitted < g.max_new_tokens and not bool(fin.all()):
                chunk = min(STOP_EVERY, g.max_new_tokens - emitted)
                key_c = ("paged-beam-chunk", chunk) + tail
                step, tok, cum, fin, gen_len, out = self.run_paged_program(
                    key_c, lambda: self._build_paged_beam_chunk(b, chunk, g),
                    step, tok, cum, fin, gen_len, out, dev["lengths_w"],
                    dev["beam_tables"], dev["priv"])
                emitted += chunk
            with torch.inference_mode():
                seq, score = _beam_final(cum, gen_len, out,
                                         g.length_penalty)
                seq, score = seq.cpu().numpy(), score.cpu().numpy()
        finally:
            for s in prompt_sids + beam_sids:
                pool.free(s)
        return (seq, score) if return_scores else seq


def _put_col(hist, col, tok):
    """``hist`` with column ``col`` (an int or a 0-d tensor) set to
    ``tok [b]``, out of place."""
    b = hist.shape[0]
    return hist.scatter(1, _step_index(col, b, hist.device),
                        tok[:, None].to(hist.dtype))
