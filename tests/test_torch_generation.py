"""Port parity: the engines' own entry points — ``generate``, ``stream``
and beam search of ``PagedGenerationEngine`` and ``GenerationEngine`` —
and exclusive requests in ``EngineCore``.

* engines — on tiny LLaMA and tiny GPT (the configs and weights of
  ``tests/test_torch_speculation.py``) the same numpy-seeded prompts,
  right- and left-padded, go through the JAX engines and the port's
  (``device="cpu"``): paged greedy, sampled, EOS, min-length and int8
  ``generate`` tokens EQUAL, ``stream`` chunks EQUAL chunk by chunk,
  paged beam tokens EQUAL with equal ``last_beam_pool_stats``, dense
  greedy, sampled and beam tokens EQUAL; scores within ``TOL`` (float32
  sums in another order);
* the pieces — each whole-batch logits processor, the one-key
  categorical draw and the on-device split equal JAX's; the prompt-page
  writer and reader equal JAX's on fp32 and int8 pools;
* the reference tests' properties (``tests/test_generation.py``): one
  program per key, the pool freed and reused, ``stream`` rejecting
  beams, a closed stream freeing the pool, the max-position check;
* exclusive requests — a beam call on a dense engine runs FIFO among
  batch requests, its value EQUAL to the direct call, the batch streams
  EQUAL to a run without it; a failing call fails only itself;
* on the card (``gpu``) — graph runs EQUAL to ``disable_graphs()`` runs
  and the decode kernel once per layer per decode step.
"""
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_infer_tpu.inference import sampling as jsampling
from paddle_infer_tpu.inference.generation import \
    GenerationConfig as JGen
from paddle_infer_tpu.inference.generation import \
    GenerationEngine as JDense
from paddle_infer_tpu.inference.generation import \
    PagedGenerationEngine as JPaged
from paddle_infer_tpu.ops.pallas import paged_attention as JPA
from paddle_infer_tpu_torch.core import random as R
from paddle_infer_tpu_torch.inference import sampling as tsampling
from paddle_infer_tpu_torch.inference.generation import (
    GenerationConfig, GenerationEngine, PagedGenerationEngine)
from paddle_infer_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_infer_tpu_torch.ops import paged_attention as PA
from paddle_infer_tpu_torch.serving import (EngineCore, RejectedError,
                                            RequestState)
from paddle_infer_tpu_torch.serving import request as trequest

from _torch_jax_isolation import _private_jax_compile_log  # noqa: F401
from test_torch_speculation import SHAPE, TINY, _drive, _pair, \
    _pinned_globals

TOL = dict(rtol=1e-5, atol=5e-5)
PAGE = 8
BUCKET = 8


@pytest.fixture(scope="module", autouse=True)
def _meshless():
    from paddle_infer_tpu.parallel import topology

    prev = topology.get_current_mesh()
    topology.set_current_mesh(None)
    yield
    topology.set_current_mesh(prev)


def _inputs():
    """Three 13-token rows: one full, one right-padded to 9 real tokens,
    one left-padded to 9."""
    ids = np.random.RandomState(0).randint(1, 96, (3, 13)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 9:] = 0
    mask[2, :4] = 0
    return ids, mask


CASES = {
    "greedy": dict(max_new_tokens=10),
    "sampled": dict(max_new_tokens=10, do_sample=True, temperature=0.8,
                    top_k=20, top_p=0.9, repetition_penalty=1.1, seed=3),
    "beam": dict(max_new_tokens=9, num_beams=3),
}


def _eos_cases(greedy):
    """EOS is the token greedy row 0 emits third, so row 0 stops there
    (or earlier); with ``min_length`` 5 it is banned for five steps.
    ``eos_row0`` runs row 0 alone, so every row finishes early and the
    stream stops before ``max_new_tokens``."""
    eos = int(greedy[0, 2])
    return {"eos": dict(max_new_tokens=12, eos_token_id=eos),
            "eos_row0": dict(max_new_tokens=12, eos_token_id=eos),
            "min_length": dict(max_new_tokens=12, eos_token_id=eos,
                               min_length=5),
            "eos_sampled": dict(max_new_tokens=12, eos_token_id=eos,
                                do_sample=True, temperature=1.5, seed=9)}


def _paged(model, port, **kw):
    if port:
        return PagedGenerationEngine(model, page_size=PAGE,
                                     prompt_bucket=BUCKET, device="cpu",
                                     **kw)
    return JPaged(model, page_size=PAGE, prompt_bucket=BUCKET, **kw)


def _dense(model, port):
    if port:
        return GenerationEngine(model, cache_bucket=16,
                                prompt_bucket=BUCKET, device="cpu")
    return JDense(model, cache_bucket=16, prompt_bucket=BUCKET)


def _both(jm, tm, make, run, **kw):
    """``run(engine, G)`` on the JAX engine and the port's."""
    return run(make(jm, False, **kw), JGen), run(make(tm, True, **kw),
                                                  GenerationConfig)


def _runs(kind):
    jm, tm = _pair(kind)

    def inputs(name):
        ids, mask = _inputs()
        return (ids[:1], mask[:1]) if name == "eos_row0" else (ids, mask)

    def gen(name, cfg):
        def run(eng, G):
            ids, mask = inputs(name)
            out = eng.generate(ids, G(**cfg), attention_mask=mask,
                               return_scores=True)
            stats = getattr(eng, "last_beam_pool_stats", None)
            return out + (stats,)
        return run

    def stream(name, cfg):
        def run(eng, G):
            ids, mask = inputs(name)
            return [np.asarray(c) for c in eng.stream(
                ids, G(**cfg), attention_mask=mask, chunk_size=3)]
        return run

    out = {}
    for name, cfg in CASES.items():
        out["paged", name] = _both(jm, tm, _paged, gen(name, cfg))
        out["dense", name] = _both(jm, tm, _dense, gen(name, cfg))
    cases = dict(CASES, **_eos_cases(out["paged", "greedy"][1][0]))
    for name, cfg in cases.items():
        if name not in CASES:
            out["paged", name] = _both(jm, tm, _paged, gen(name, cfg))
        if name not in ("beam", "min_length"):
            out["stream", name] = _both(jm, tm, _paged, stream(name, cfg))
    for name in ("greedy", "sampled"):
        out["int8", name] = _both(jm, tm, _paged, gen(name, CASES[name]),
                                  kv_dtype="int8")
    out["eos_token"] = cases["eos"]["eos_token_id"]
    return out


@pytest.fixture(scope="module", params=["llama", "gpt"])
def runs(request):
    with _pinned_globals():
        return _runs(request.param)


GEN_CASES = [("paged", "greedy"), ("paged", "sampled"), ("paged", "eos"),
             ("paged", "eos_row0"), ("paged", "eos_sampled"),
             ("paged", "min_length"),
             ("paged", "beam"), ("int8", "greedy"), ("int8", "sampled"),
             ("dense", "greedy"), ("dense", "sampled"), ("dense", "beam")]


@pytest.mark.parametrize("engine,case", GEN_CASES,
                         ids=[f"{e}-{c}" for e, c in GEN_CASES])
def test_generate_equals_jax(runs, engine, case):
    (jseq, jscore, jstats), (tseq, tscore, tstats) = runs[engine, case]
    assert tseq.dtype == np.int32 and tseq.shape == jseq.shape
    np.testing.assert_array_equal(tseq, jseq)
    np.testing.assert_allclose(tscore, jscore, **TOL)
    assert np.isfinite(tscore).all()
    if engine == "paged" and case == "beam":
        assert tstats == jstats
        assert tstats["used_pages"] < tstats["unshared_equivalent"]


@pytest.mark.parametrize("case", ["greedy", "sampled", "eos", "eos_row0",
                                  "eos_sampled"])
def test_stream_chunks_equal_jax(runs, case):
    jchunks, tchunks = runs["stream", case]
    assert [c.shape for c in tchunks] == [c.shape for c in jchunks]
    for t, j in zip(tchunks, jchunks):
        np.testing.assert_array_equal(t, j)
    # the stream is generate's tokens (up to an early stop)
    seq = np.concatenate(tchunks, axis=1)
    full = runs["paged", case][1][0]
    np.testing.assert_array_equal(seq, full[:, :seq.shape[1]])


def test_eos_stops_and_pads(runs):
    """Row 0 emits EOS by step 2 and pads after it; the stream ends
    within one chunk of the last row's EOS."""
    eos = runs["eos_token"]
    seq = runs["paged", "eos"][1][0]
    row = list(seq[0])
    first = row.index(eos)
    assert first <= 2 and all(t == 0 for t in row[first + 1:])
    greedy = runs["paged", "greedy"][1][0]
    np.testing.assert_array_equal(seq[0, :first + 1],
                                  greedy[0, :first + 1])


def test_stream_stops_early_when_every_row_finished(runs):
    chunks = runs["stream", "eos_row0"][1]
    assert sum(c.shape[1] for c in chunks) < 12
    assert (runs["paged", "eos_row0"][1][0][0, -1] == 0)


def test_min_length_bans_eos(runs):
    eos = runs["eos_token"]
    seq = runs["paged", "min_length"][1][0]
    assert not (seq[:, :5] == eos).any()


# ------------------------------------------------------- the pieces

LOGITS = (np.random.RandomState(5).randn(4, 50) * 3).astype(np.float32)
HIST = np.random.RandomState(6).randint(-1, 50, (4, 9)).astype(np.int32)

PROCESSORS = {
    "temperature": (lambda m, x: m.apply_temperature(x, 0.7)),
    "top_k": (lambda m, x: m.apply_top_k(x, 5)),
    "top_k_wide": (lambda m, x: m.apply_top_k(x, 80)),
    "top_p": (lambda m, x: m.apply_top_p(x, 0.8)),
    "min_length_banned": (lambda m, x: m.apply_min_length(x, 7, 2, 4)),
    "min_length_open": (lambda m, x: m.apply_min_length(x, 7, 4, 4)),
    "repetition": (lambda m, x, h: m.apply_repetition_penalty(x, h, 1.3)),
    "chain": (lambda m, x, h: m.process_logits(
        x, temperature=0.9, top_k=10, top_p=0.85, token_history=h,
        repetition_penalty=1.2, eos_token_id=3, cur_len=1, min_length=2)),
}


@pytest.mark.parametrize("name", list(PROCESSORS))
def test_processor_equals_jax(name):
    fn = PROCESSORS[name]
    with_hist = fn.__code__.co_argcount == 3
    jargs = (jnp.asarray(LOGITS),) + ((jnp.asarray(HIST),) if with_hist
                                      else ())
    targs = (torch.tensor(LOGITS),) + ((torch.tensor(HIST),) if with_hist
                                       else ())
    want = np.asarray(fn(jsampling, *jargs))
    got = fn(tsampling, *targs)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("do_sample", [False, True])
def test_sample_token_equals_jax(do_sample):
    want = np.asarray(jsampling.sample_token(
        jnp.asarray(LOGITS), jax.random.PRNGKey(11), do_sample))
    got = tsampling.sample_token(torch.tensor(LOGITS), R.PRNGKey(11),
                                 do_sample)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_split_on_device_equals_jax():
    key = jax.random.PRNGKey(42)
    for _ in range(3):
        want = np.asarray(jax.random.split(key)).astype(np.int64)
        got = R.split_on_device(torch.tensor(
            np.asarray(key).astype(np.int64)))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(R.split(R._as_key(np.asarray(
            key))).numpy(), want)
        key = jax.random.split(key)[1]


P, H, PG, D = 12, 2, 4, 8


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_prompt_pages_equal_jax(quantized):
    rs = np.random.RandomState(8)
    tables = np.asarray([[3, 0, 7], [5, 9, 1]], np.int32)
    kv = (rs.randn(2, 3 * PG, H, D) * 2).astype(np.float32)
    if quantized:
        pay = rs.randint(-90, 90, (P, H, PG, D)).astype(np.int8)
        sc = (rs.rand(P, H) + 0.1).astype(np.float32)
        jpool = (jnp.asarray(pay), jnp.asarray(sc))
        tpool = (torch.tensor(pay), torch.tensor(sc))
    else:
        fp = rs.randn(P, H, PG, D).astype(np.float32)
        jpool, tpool = jnp.asarray(fp), torch.tensor(fp)
    want = JPA.write_prompt_pages(jpool, jnp.asarray(tables),
                                  jnp.asarray(kv))
    got = PA.write_prompt_pages(tpool, torch.tensor(tables),
                                torch.tensor(kv))
    # in place: the same pool tensors come back
    assert all(g is t for g, t in zip(got, tpool)) if quantized \
        else got is tpool
    for w, g in zip(want if quantized else (want,),
                    got if quantized else (got,)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for s in (PG, 3 * PG):
        np.testing.assert_array_equal(
            PA.gather_prompt_pages(got, torch.tensor(tables), s).numpy(),
            np.asarray(JPA.gather_prompt_pages(want, jnp.asarray(tables),
                                               s)))
    with pytest.raises(ValueError, match="multiple of the page size"):
        PA.write_prompt_pages(tpool, torch.tensor(tables),
                              torch.tensor(kv[:, :5]))


# ------------------------------------------- the reference's properties

@pytest.fixture(scope="module")
def llama():
    with _pinned_globals():
        return _pair("llama")[1]


def test_one_program_per_key(llama):
    eng = _paged(llama, True)
    g = GenerationConfig(max_new_tokens=3)
    eng.generate(np.array([[1, 2, 3]], np.int32), g)
    n = len(eng._programs._fns)
    # the same prompt bucket: no new program
    eng.generate(np.array([[4, 5]], np.int32), g)
    assert len(eng._programs._fns) == n == 2       # prefill + one chunk


def test_pool_freed_and_reused(llama):
    ids = np.arange(1, 21, dtype=np.int32)[None, :]
    g = GenerationConfig(max_new_tokens=16)             # crosses pages
    eng = PagedGenerationEngine(llama, page_size=4, prompt_bucket=8,
                                device="cpu")
    first = eng.generate(ids, g)
    assert eng._pool.free_blocks == eng._pool.num_blocks
    np.testing.assert_array_equal(eng.generate(ids, g), first)
    dense = GenerationEngine(llama, cache_bucket=16, prompt_bucket=8,
                             device="cpu")
    np.testing.assert_array_equal(dense.generate(ids, g), first)


def test_stream_rejects_beams(llama):
    eng = _paged(llama, True)
    with pytest.raises(ValueError, match="sampling/greedy"):
        next(eng.stream(np.zeros((1, 4), np.int32),
                        GenerationConfig(num_beams=3)))


def test_closed_stream_frees_pool(llama):
    ids = np.random.RandomState(4).randint(0, 96, (2, 8)).astype(np.int32)
    g = GenerationConfig(max_new_tokens=8)
    eng = _paged(llama, True)
    it = eng.stream(ids, g, chunk_size=2)
    next(it)
    it.close()
    assert eng._pool.free_blocks == eng._pool.num_blocks
    np.testing.assert_array_equal(eng.generate(ids, g),
                                  _paged(llama, True).generate(ids, g))


def test_int8_beams_rejected(llama):
    eng = _paged(llama, True, kv_dtype="int8")
    with pytest.raises(ValueError, match="quantized KV pools"):
        eng.generate(np.zeros((1, 4), np.int32),
                     GenerationConfig(num_beams=2, max_new_tokens=3))
    assert eng._pool is None                   # nothing was reserved


@pytest.mark.parametrize("entry", ["paged", "stream", "dense"])
def test_max_positions_enforced(llama, entry):
    ids = np.zeros((1, 60), np.int32)
    g = GenerationConfig(max_new_tokens=10)
    with pytest.raises(ValueError, match="max_position"):
        if entry == "paged":
            _paged(llama, True).generate(ids, g)
        elif entry == "stream":
            next(_paged(llama, True).stream(ids, g))
        else:
            _dense(llama, True).generate(ids, g)


def test_unported_engine_options_raise(llama):
    with pytest.raises(NotImplementedError, match="mesh"):
        GenerationEngine(llama, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="quantized_allreduce"):
        PagedGenerationEngine(llama, quantized_allreduce="int8",
                              device="cpu")


# ------------------------------------------------- exclusive requests

def _batch_prompts():
    rs = np.random.RandomState(2)
    return [rs.randint(1, 96, (n,)).astype(np.int32) for n in (11, 4, 7)]


BEAM = GenerationConfig(max_new_tokens=5, num_beams=3)
BEAM_IDS = np.random.RandomState(3).randint(1, 96, (2, 6)).astype(np.int32)


def _serve_with(llama, exclusive_at=None, make_fn=None):
    """Three batch requests (rids from 300; the first sampled) with an
    exclusive call ``make_fn(batch requests)`` submitted before request
    ``exclusive_at``; returns ``(batch requests, exclusive request, core
    metrics)``."""
    saved = trequest._rid_counter
    trequest._rid_counter = itertools.count(300)
    core = EngineCore(_paged(llama, True), device="cpu", **SHAPE)
    try:
        # the sampled row first: its stream is keyed by its rid, which an
        # exclusive request submitted after it does not shift
        cfgs = [GenerationConfig(max_new_tokens=5, do_sample=True, seed=4),
                GenerationConfig(max_new_tokens=6),
                GenerationConfig(max_new_tokens=6)]
        reqs, ex = [], None
        for i, (p, g) in enumerate(zip(_batch_prompts(), cfgs)):
            if i == exclusive_at:
                ex = core.submit_exclusive(make_fn(reqs))
            reqs += core.submit(p, g)
        _drive(core, reqs + ([ex] if ex is not None else []))
        return reqs, ex, core.metrics_snapshot()
    finally:
        core.close()
        trequest._rid_counter = saved


def test_exclusive_value_and_fifo(llama):
    dense = _dense(llama, True)
    seen = {}

    def make_fn(reqs):
        def call():
            # FIFO: the request ahead was admitted, those behind wait
            seen["states"] = [r.state for r in reqs]
            return dense.generate(BEAM_IDS, BEAM, return_scores=True)
        return call

    plain, _, _ = _serve_with(llama)
    reqs, ex, snap = _serve_with(llama, exclusive_at=1, make_fn=make_fn)
    assert ex.kind == "exclusive" and ex.state == RequestState.DONE
    want_seq, want_score = dense.generate(BEAM_IDS, BEAM,
                                          return_scores=True)
    np.testing.assert_array_equal(ex.value[0], want_seq)
    np.testing.assert_array_equal(ex.value[1], want_score)
    assert seen["states"] == [RequestState.ACTIVE] + \
        [RequestState.QUEUED] * 2
    for r, p in zip(reqs, plain):
        assert r.state == RequestState.DONE
        assert r.tokens == p.tokens
    assert snap["submitted"] == snap["completed"] == 4


def test_exclusive_failure_fails_only_itself(llama):
    plain, _, _ = _serve_with(llama)

    def make_fn(reqs):
        def boom():
            raise RuntimeError("exclusive call failed")
        return boom

    reqs, ex, snap = _serve_with(llama, exclusive_at=1, make_fn=make_fn)
    assert ex.state == RequestState.FAILED
    with pytest.raises(RuntimeError, match="exclusive call failed"):
        ex.result(timeout=1)
    for r, p in zip(reqs, plain):
        assert r.state == RequestState.DONE and r.tokens == p.tokens
    assert snap["failed"] == 1 and snap["completed"] == 3


def test_unbatchable_submit_points_to_exclusive(llama):
    core = EngineCore(_paged(llama, True), device="cpu", **SHAPE)
    try:
        for g in (GenerationConfig(num_beams=2),
                  GenerationConfig(repetition_penalty=1.2)):
            with pytest.raises(RejectedError, match="submit_exclusive"):
                core.submit(np.zeros(4, np.int32), g)
    finally:
        core.close()
    with pytest.raises(RejectedError, match="closed"):
        core.submit_exclusive(lambda: None)


def test_chip_smoke_generate_phase_on_cpu(llama, monkeypatch):
    """``chip_smoke``'s generate phase (every gate but the launch counts,
    which count CUDA launches only; the profile, which needs CUDA, is
    stubbed) at a tiny size on the CPU."""
    import os

    monkeypatch.syspath_prepend(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "_check_generate_launches",
                        lambda *a: None)
    monkeypatch.setattr(chip_smoke, "profile_generate",
                        lambda *a: {"idle_share": 0.0, "busy_ms": 0.0,
                                    "wall_ms": 0.0})
    make_core = chip_smoke.make_core
    monkeypatch.setattr(chip_smoke, "make_core", lambda m, d, **kw: make_core(
        m, d, max_model_len=48, token_budget=16, page_size=PAGE, **kw))
    saved = trequest._rid_counter
    try:
        total = chip_smoke.generate_phase(
            llama, torch.device("cpu"), "cpu", prompt_lens=(20, 9, 3),
            max_new=6, beam_new=4, exclusive_lens=(11, 2))
    finally:
        trequest._rid_counter = saved
    assert total == {"decode": 0, "flash": 0}


# ------------------------------------------------------------ the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


CARD_LLAMA = dict(TINY, hidden_size=256, num_attention_heads=4,
                  num_key_value_heads=2, intermediate_size=512,
                  max_position_embeddings=256)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["greedy", "sampled", "beam", "int8"])
def test_graphs_equal_eager_on_card(cuda_device, case):
    """Paged ``generate`` (and ``stream``) on graphs EQUAL to the same
    calls under ``disable_graphs()``; the decode kernel launches once per
    layer per decode step."""
    from paddle_infer_tpu_torch.core.graphs import disable_graphs
    from paddle_infer_tpu_torch.ops import _build

    model = LlamaForCausalLM(LlamaConfig(**CARD_LLAMA), device=cuda_device,
                             dtype=torch.bfloat16, seed=0)
    cfg = dict(CASES.get(case, CASES["greedy"]), max_new_tokens=9)
    g = GenerationConfig(**cfg)
    ids = np.random.RandomState(1).randint(1, 96, (3, 40)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 17:] = 0
    kv = "int8" if case == "int8" else None
    eng = PagedGenerationEngine(model, page_size=16, kv_dtype=kv,
                                device=cuda_device)
    eng.generate(ids, g, attention_mask=mask)              # captures
    dec = _build.KERNELS["paged_decode"]
    dec.launches = 0
    graph = eng.generate(ids, g, attention_mask=mask, return_scores=True)
    layers = CARD_LLAMA["num_hidden_layers"]
    assert dec.launches == layers * (g.max_new_tokens - 1)
    with disable_graphs():
        eager = eng.generate(ids, g, attention_mask=mask, return_scores=True)
    np.testing.assert_array_equal(graph[0], eager[0])
    np.testing.assert_array_equal(graph[1], eager[1])
    if case != "beam":
        got = np.concatenate(list(eng.stream(ids, g, attention_mask=mask,
                                             chunk_size=4)), axis=1)
        np.testing.assert_array_equal(got, graph[0])
