"""Paged generation engine — the part the serving plane stands on.

Port of ``paddle_infer_tpu/inference/generation.py``:
``GenerationConfig`` and ``PagedGenerationEngine`` reduced to what
``serving.EngineCore`` needs — the native block pool and per-layer
device page pools (``serving_pool``, ``_ensure_pages``), the parameter
snapshot (``refresh_params``), one model forward (``_model_step``) and
the program runner over the pools (``run_paged_program``, one CUDA
graph per program key on the card, ``core/graphs.py``).  The engine's
own ``generate``/``stream``/beam search wait for a later slice
(ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .. import native, resolve_device
from ..core.graphs import ProgramCache, StagedInputs
from ..ops.paged_attention import KV_SCALE_EPS


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


def _round_up(n, mult):
    return ((n + mult - 1) // mult) * mult


class PagedGenerationEngine:
    """Serving-side engine over a paged KV cache: one shared physical
    page pool ``[P, h, page, d]`` per layer (K and V), per-sequence page
    tables from the native block allocator.

    ``kv_dtype="int8"`` stores each pool as an int8 payload with one
    float32 scale per (page, head) (the slot-0 scale protocol of
    ``ops/paged_attention.py``): half the page bytes of bf16, a quarter
    of fp32.  ``None`` keeps pages in the model's dtype.

    ``device`` defaults to the card and must be where the model's
    parameters live."""

    def __init__(self, model, page_size: int = 16,
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
        self.page_size = int(page_size)
        self._pool = None
        self._k_pages = self._v_pages = None
        self._programs = ProgramCache()
        self._inputs = {}
        self._params = None
        self.refresh_params()
        # the first floating parameter decides the KV page dtype
        self._cache_dtype = next(
            (p.dtype for p in self._params.values()
             if p.dtype.is_floating_point), torch.float32)

    # ----------------------------------------------------------- plumbing
    def _ensure_pool(self, need_pages: int):
        if self._pool is None or self._pool.num_blocks < need_pages:
            self._pool = native.KVBlockPool(need_pages, self.page_size)
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
        return self._k_pages, self._v_pages

    def _model_step(self, params, ids, position_ids, caches):
        """One forward over the model with ``params`` swapped in; returns
        ``(logits, new_caches)``."""
        with torch.inference_mode():
            return torch.func.functional_call(
                self._model, params, (ids,),
                {"position_ids": position_ids, "caches": caches})

    # ------------------------------------------------------ serving hooks
    def refresh_params(self):
        """Re-snapshot the model's parameters (the dict every program
        receives); the graphs are dropped when a tensor changed."""
        params = dict(self._model.named_parameters())
        old = self._params or {}
        if params.keys() != old.keys() or any(
                p is not old[n] or p.data_ptr() != old[n].data_ptr()
                for n, p in params.items()):
            self._programs.clear()
        self._params = params
        return self._params

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
        """Run a serving program over the persistent page pools.

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
