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
chunk length.

Mesh serving (``mesh=``, a ``parallel.topology.create_hybrid_mesh``
mesh): the engine places every stamped parameter by its ``dist_attr``
(``serving_param_spec``, with the reference's once-logged fallback to
a whole copy where an axis does not divide a dim) into a ``Placement``
of per-shard slices, keeps head-sharded page pools (each mp shard a
``[P, H/mp, page, D]`` pool on its device, int8 scale rows included)
and runs every model step under ``topology.mesh_scope``, which makes the
mesh, the placement and the engine's ``quantized_allreduce`` current for
the step: the layers then run per shard and the paged kernels launch once
per shard over its heads and its replica group's rows.  Sharding is
placement, not shape: a program key and its graph are the same on every
mesh.
"""
from __future__ import annotations

import logging
import warnings
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import native, resolve_device
from ..core import random as prng
from ..core.graphs import ProgramCache, StagedInputs
from ..ops.paged_attention import KV_SCALE_EPS, pool_leaves
from . import sampling

# decode steps per chunk program of ``generate`` and paged beam search:
# the host reads the stop flag once per chunk
STOP_EVERY = 8

_LOG = logging.getLogger(__name__)

# (param name, axis, dim) fallbacks already warned about: per engine
# lifetime news, not per refresh_params noise
_FALLBACK_WARNED = set()


def serving_param_spec(arr, dist_attr, mesh, name=None, fallback=None):
    """Placement spec of one served parameter: the tensor-parallel axes
    stamped on it (``dist_attr``), kept where the mesh has the axis and
    it divides the dim; a tuple with one axis name or None per dim.

    A stamped axis the mesh HAS (size > 1) that does not divide its dim
    replicates the parameter — a tensor-parallel coverage loss if it
    hits a big weight — so each such fallback is logged once per
    parameter and appended to ``fallback`` (``(axis, dim)`` tuples) for
    the ``serving_shard_replicated_params`` gauge."""
    from ..parallel.topology import axis_if_divides

    sizes = mesh.shape if mesh is not None else {}
    spec = []
    for i in range(arr.dim() if isinstance(arr, torch.Tensor)
                   else np.ndim(arr)):
        s = dist_attr[i] if dist_attr and i < len(dist_attr) else None
        if not s:
            spec.append(None)
            continue
        ax = axis_if_divides(mesh, s, arr.shape[i])
        spec.append(ax)
        if ax is None and sizes.get(s, 1) > 1:
            if fallback is not None:
                fallback.append((s, i))
            key = (name or "<unnamed>", s, i)
            if key not in _FALLBACK_WARNED:
                _FALLBACK_WARNED.add(key)
                _LOG.warning(
                    "serving_param_spec: replicating param %s dim %d "
                    "(shape %s) — mesh axis %r size %d does not divide %d",
                    name or "<unnamed>", i, tuple(arr.shape), s,
                    sizes.get(s, 1), arr.shape[i])
    return tuple(spec)


def _version(t):
    """``t``'s in-place version counter (None for an inference tensor,
    which keeps none)."""
    try:
        return t._version
    except RuntimeError:
        return None


_LORA_POOLS = (".lora_a", ".lora_b", ".lora_scale")


def split_layers(mesh) -> bool:
    """True when a mesh runs the layers per shard: an mp split or
    replica groups (an ep-only mesh splits the expert stacks alone)."""
    return mesh is not None and (mesh.shape["mp"] > 1
                                 or mesh.shape["dp"] > 1)


class Placement:
    """A model's parameters placed on its mesh: the per-shard slices of
    every tensor-parallel layer (``nn.layers.LinearShards`` /
    ``EmbeddingShards``, looked up by module) and of every expert stack
    split over ``ep`` (looked up by tensor), plus the per-parameter
    record of ``named`` that ``shard_report`` counts.

    Serving makes one per parameter snapshot: the slices are copied once
    and the source tensors held, so a lookup by identity stays valid,
    with their version counters, so a tensor written in place since
    (``load_state_dict``) makes the placement ``stale()``.  Training
    (``parallel.FleetTrainStep``) makes one with ``live=True``: every
    shard slices the CURRENT parameters at each call, so autograd
    reaches the whole parameter through each shard's slice, and an
    expert stack is split by its shape (the AMP rule may hand the
    experts a cast copy).  Pipeline templates
    (``PipelineStack._template``) are walked too."""

    def __init__(self, model, mesh, named=(), live=False):
        from ..nn import layers as NL
        from ..parallel.moe import ep_stacks
        from ..quantization.int8 import Int8Linear
        from ..serving.adapters.layer import LoRAServingLinear

        self.mesh = mesh
        self.live = live
        self.record = {}
        # the LoRA pools are read live by every shard (an upload writes
        # them in place and changes no placement)
        self._versions = [(t, _version(t)) for n, t in named
                          if not n.endswith(_LORA_POOLS)]
        for n, t in named:
            fell_back = []
            spec = serving_param_spec(t, getattr(t, "dist_attr", None), mesh,
                                      name=n, fallback=fell_back)
            self.record[n] = ("fallback" if fell_back
                              else "sharded" if any(spec)
                              else "replicated")
        self._by_module = {}
        self._by_tensor = {}
        modules = list(_walk(model))
        self._held = list(modules)
        split = split_layers(mesh)
        # a LoRA wrapper's shards slice its base layer: the base gets
        # none of its own
        wrapped = {id(m.inner) for m in modules
                   if isinstance(m, LoRAServingLinear)}
        with torch.no_grad():
            for m in modules:
                if split and isinstance(m, NL.VocabParallelEmbedding):
                    self._by_module[id(m)] = NL.EmbeddingShards(m, mesh,
                                                                live=live)
                elif split and id(m) not in wrapped and (isinstance(
                        m, (NL.ColumnParallelLinear, LoRAServingLinear,
                            Int8Linear)) or hasattr(m, "_mp_kind")):
                    sh = NL.linear_shards(m, mesh, live=live)
                    if sh is not None:
                        self._by_module[id(m)] = sh
                if not live:
                    for t, parts in ep_stacks(m, mesh):
                        self._by_tensor[id(t)] = parts
                        self._held.append(t)

    def get(self, module):
        return self._by_module.get(id(module))

    def stale(self) -> bool:
        """True once a placed tensor was written in place."""
        return any(_version(t) != v for t, v in self._versions)

    def ep_parts(self, t):
        """The per-ep-shard slices of an expert stack (None when it is
        not split)."""
        if self.live:
            from ..parallel.moe import ep_split

            return ep_split(t, self.mesh)
        return self._by_tensor.get(id(t))


def _walk(model):
    """``model``'s modules, and those of every pipeline template
    (``_template``) among them, each once."""
    seen = set()
    stack = [model]
    while stack:
        for m in stack.pop().modules():
            if id(m) in seen:
                continue
            seen.add(id(m))
            yield m
            tpl = getattr(m, "_template", None)
            if isinstance(tpl, torch.nn.Module):
                stack.append(tpl)


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
    parameters live.  ``mesh`` (``parallel.topology.create_hybrid_mesh``)
    serves over a mesh of shards: tensor-parallel weights placed by
    their ``dist_attr``, caches split over heads, the rows over replica
    groups; its controller device must be the engine's.
    ``quantized_allreduce="int8"`` (mesh required) sends the model's
    row-parallel partial sums over the blockwise-int8 wire format:
    approximate logits, about 4x fewer mp interconnect bytes."""

    def __init__(self, model, cache_bucket: int = 128,
                 prompt_bucket: int = 64, cache_dtype=None, mesh=None,
                 quantized_allreduce: Optional[str] = None, device=None):
        if quantized_allreduce is not None and mesh is None:
            raise ValueError(
                "quantized_allreduce requires a mesh (it only changes "
                "the mp all-reduce wire format)")
        if quantized_allreduce not in (None, "int8"):
            raise ValueError(f"unsupported quantized_allreduce "
                             f"{quantized_allreduce!r}; expected 'int8'")
        self.device = resolve_device(device)
        first = next(model.parameters())
        if first.device.type != self.device.type:
            raise ValueError(f"model parameters are on {first.device}, "
                             f"engine device is {self.device}")
        if mesh is not None and mesh.controller.type != self.device.type:
            raise ValueError(f"mesh devices are {mesh.controller.type}, "
                             f"engine device is {self.device}")
        model.eval()
        self._model = model
        self._mesh = mesh if mesh is not None and mesh.size > 1 else None
        self._quant_allreduce = quantized_allreduce
        self._placement = None
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
        receives), honouring weights replaced after construction; on a
        mesh, re-place them when a tensor changed."""
        old = self._params or {}
        self._params = dict(self._model.named_parameters())
        if self._mesh is not None and (
                self._placement is None or self._placement.stale()
                or self._params.keys() != old.keys()
                or any(p is not old[n] or p.data_ptr() != old[n].data_ptr()
                       for n, p in self._params.items())):
            self._placement = Placement(self._model, self._mesh,
                                        self._placed_tensors())
        return self._params

    def _placed_tensors(self):
        """``(name, tensor)`` of every parameter and of the serving
        buffers the reference's snapshot carries (weight-only payloads,
        quantized experts, LoRA pools)."""
        from ..quantization.moe import Int8MoELayer, WeightOnlyMoELayer
        from ..quantization.weight_only import WeightOnlyLinear
        from ..serving.adapters.layer import LoRAServingLinear

        named = list(self._params.items())
        for lname, layer in self._model.named_modules():
            if isinstance(layer, (WeightOnlyLinear, WeightOnlyMoELayer,
                                  Int8MoELayer, LoRAServingLinear)):
                for bn, buf in layer.named_buffers(prefix=lname,
                                                   recurse=False):
                    named.append((bn, buf))
        return named

    def _mesh_ctx(self):
        from ..parallel import topology

        return topology.mesh_scope(self._mesh, self._placement,
                                   quantized=self._quant_allreduce)

    def shard_report(self):
        """Placement summary for the serving snapshot: the mesh's axes
        above 1, how many parameters are split and how many fell back
        to whole copies (an axis not dividing a dim), and the
        quantized-all-reduce mode.  None without a mesh."""
        if self._mesh is None:
            return None
        rec = self._placement.record
        fallbacks = sorted(n for n, v in rec.items() if v == "fallback")
        return {
            "mesh_axes": {a: int(s) for a, s in self._mesh.shape.items()
                          if int(s) > 1},
            "devices": int(self._mesh.size),
            "params_total": len(rec),
            "sharded_params": sum(1 for v in rec.values() if v == "sharded"),
            "replicated_params": len(fallbacks),
            "replicated_names": fallbacks[:8],
            "quantized_allreduce": self._quant_allreduce or "",
        }

    def _head_shards(self):
        """Mp shards of the KV heads (1 when mp does not divide them)."""
        from ..parallel.topology import axis_if_divides

        return (self._mesh.shape["mp"]
                if axis_if_divides(self._mesh, "mp", self._num_heads)
                else 1)

    def _model_step(self, params, ids, position_ids, caches,
                    attention_mask=None):
        """One forward over the model with ``params`` swapped in, under
        the engine's mesh; returns ``(logits, new_caches)``."""
        kw = {"position_ids": position_ids, "caches": caches}
        if attention_mask is not None:
            kw["attention_mask"] = attention_mask
        with torch.inference_mode(), self._mesh_ctx():
            return torch.func.functional_call(self._model, params, (ids,),
                                              kw)

    def _empty_caches(self, batch, cache_len):
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        if split_layers(self._mesh):
            # head-sharded static buffers: one [b, L, H/mp, d] pair per
            # mp shard on its device
            n = self._head_shards()
            shape = (batch, cache_len, self._num_heads // n, self._head_dim)

            def bufs():
                return [torch.zeros(shape, dtype=self._cache_dtype,
                                    device=self._mesh.device(mp=r))
                        for r in range(n)]

            return [(bufs(), bufs(), zero) for _ in range(self._num_layers)]
        shape = (batch, cache_len, self._num_heads, self._head_dim)
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

                def sel(buf):
                    return ([t.index_select(0, rows) for t in buf]
                            if isinstance(buf, list)
                            else buf.index_select(0, rows))

                return [(sel(k), sel(v), i) for k, v, i in caches]

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
        size.  On a mesh a layer's pool is the list of its mp shards'
        pools, ``[P, H/mp, page, D]`` each on its shard's device (int8
        scale rows ``[P, H/mp]`` with them); replica groups share them,
        their rows owning disjoint pages."""
        split = split_layers(self._mesh)
        n = self._head_shards() if split else 1
        pshape = (self._pool.num_blocks, self._num_heads // n,
                  self.page_size, self._head_dim)
        first = None if self._k_pages is None else pool_leaves(
            self._k_pages[0])[0]
        if first is None or tuple(first.shape) != pshape:
            def one(dev):
                if self._kv_dtype != "int8":
                    return torch.zeros(pshape, dtype=self._cache_dtype,
                                       device=dev)
                # scales start at the eps floor (never zero): a zeroed
                # pool dequantizes to zero, and the masked-max writer's
                # "scale > 0" invariant holds from the first step
                return (torch.zeros(pshape, dtype=torch.int8, device=dev),
                        torch.full(pshape[:2], KV_SCALE_EPS,
                                   dtype=torch.float32, device=dev))

            def alloc():
                if not split:
                    return one(self.device)
                return [one(self._mesh.device(mp=r)) for r in range(n)]

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
                for t in pool_leaves(pages):
                    if t.dtype == torch.float32 and t.dim() == 2:
                        t.fill_(KV_SCALE_EPS)
                    else:
                        t.zero_()

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
        receives); the graphs are dropped when a tensor changed (or, on
        a mesh, when the shards were placed anew)."""
        old, placement = self._params or {}, self._placement
        params = super().refresh_params()
        if self._placement is not placement or params.keys() != old.keys() \
                or any(p is not old[n] or p.data_ptr() != old[n].data_ptr()
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
        site = ("serving-decode" if tag == "serve-step"
                else "serving-prefill"
                if tag in ("serve-prefill", "serve-prefill-px")
                else f"serving-{tag}")

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
                for t in pool_leaves(pages):
                    t.index_copy_(0, dst, t.index_select(0, src_rep))
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
                    for t in pool_leaves(pages):
                        t.index_copy_(0, priv_flat, t.index_select(0,
                                                                   src_flat))
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
