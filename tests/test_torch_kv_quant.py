"""Port parity: int8 KV pages (payload + one float32 scale per page and
head) on the ragged serving path.

* writers — ``_quantized_scatter`` and the three page writers
  (``write_chunk_pages``, ``write_token_page``, ``write_ragged_pages``)
  at int8 against the JAX functions on the same seeded inputs, with
  slot-0 landings and duplicate pad landings on the scratch page:
  payload and scales EQUAL;
* protocol — one token stream written whole, in three chunkings and
  token by token gives EQUAL pools (the slot-0 scale protocol's write-
  order invariance), and the round trip stays within
  ``kv_dequant_error_bound``;
* config — ``kv_dtype`` validation and the feature matrix as in JAX;
* isolation — a worker whose JAX native library load failed while
  collecting (a parallel build race) recovers it before the serving
  runs below build their JAX engines;
* serving — int8 ``EngineCore`` greedy and seeded-sampled streams of
  tiny LLaMA and GPT equal to the JAX int8 ``EngineCore``, plain and
  ngram-speculative (request ids pinned), with equal ``kv_quant``
  snapshot sections and no new first call after warm-up;
* on the card (``gpu``) — the int8 writer and the page copy against the
  CPU, eagerly and as CUDA graph replays.
"""
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_infer_tpu.inference.generation import \
    GenerationConfig as JGen
from paddle_infer_tpu.inference.generation import \
    PagedGenerationEngine as JEngine
from paddle_infer_tpu.ops.pallas import paged_attention as JPA
from paddle_infer_tpu.ops.pallas import ragged_paged_attention as JRPA
from paddle_infer_tpu.serving import EngineCore as JCore
from paddle_infer_tpu.serving import request as jrequest
from paddle_infer_tpu.serving.sharded import mesh as jmesh
from paddle_infer_tpu_torch.inference.generation import (
    GenerationConfig, PagedGenerationEngine)
from paddle_infer_tpu_torch.observability import get_compile_log
from paddle_infer_tpu_torch.ops import paged_attention as PA
from paddle_infer_tpu_torch.ops import ragged_paged_attention as RPA
from paddle_infer_tpu_torch.serving import EngineCore, RequestState
from paddle_infer_tpu_torch.serving import request as trequest
from paddle_infer_tpu_torch.serving.programs import build_page_copy
from paddle_infer_tpu_torch.serving.sharded import (ShardedConfigError,
                                                    validate_kv_quant_combo)

from _torch_jax_isolation import (_private_jax_compile_log,  # noqa: F401
                                  ensure_jax_native)
from test_torch_speculation import (GREEDY, PAGE, SHAPE, _cfgs, _drive,
                                    _pair, _pinned_globals, _prompts)

P, H, PG, D = 9, 2, 4, 8            # pool pages, heads, page size, head dim
SCRATCH = P - 1


@pytest.fixture(scope="module", autouse=True)
def _meshless():
    from paddle_infer_tpu.parallel import topology

    prev = topology.get_current_mesh()
    topology.set_current_mesh(None)
    yield
    topology.set_current_mesh(prev)


def _pool(seed):
    """A dirty int8 pool (random payload, positive scales) as numpy."""
    rs = np.random.RandomState(seed)
    return (rs.randint(-100, 100, (P, H, PG, D)).astype(np.int8),
            (rs.rand(P, H) + 0.05).astype(np.float32))


def _both(pool):
    pay, sc = pool
    return ((jnp.asarray(pay), jnp.asarray(sc)),
            (torch.tensor(pay), torch.tensor(sc)))


def _kv(seed, *lead):
    return (np.random.RandomState(seed).randn(*lead, H, D) * 3.0).astype(
        np.float32)


def _assert_pools_equal(j, t):
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))


# ------------------------------------------------------------------ writers

def test_quantized_scatter_equals_jax():
    """Slot-0 landings re-seed their page's scale; duplicate landings on
    one page (the scratch page, slot 0 twice) take the max."""
    (jp, tp) = _both(_pool(0))
    page_idx = np.asarray([[0, 0, 3, SCRATCH, SCRATCH, 5]], np.int32)
    slot = np.asarray([[0, 1, 2, 0, 0, 3]], np.int32)
    kv = _kv(1, 1, 6)
    want = JPA._quantized_scatter(jp, jnp.asarray(page_idx),
                                  jnp.asarray(slot), jnp.asarray(kv))
    got = PA._quantized_scatter(tp, torch.tensor(page_idx),
                                torch.tensor(slot), torch.tensor(kv))
    assert got[0] is tp[0] and got[1] is tp[1]        # in place
    _assert_pools_equal(want, got)
    # the scratch page's scale is the larger of its two slot-0 landings
    amax = np.abs(kv[0, 3:5]).max(axis=-1) / 127.0
    np.testing.assert_array_equal(got[1][SCRATCH].numpy(),
                                  amax.max(axis=0).astype(np.float32))


def test_write_chunk_pages_int8_equals_jax():
    (jp, tp) = _both(_pool(2))
    tables = np.asarray([[0, 1, 2], [3, 4, 5]], np.int32)
    offsets = np.asarray([2, 4], np.int32)        # mid-page and aligned
    kv = _kv(3, 2, 7)
    want = JPA.write_chunk_pages(jp, jnp.asarray(tables), jnp.asarray(kv),
                                 jnp.asarray(offsets))
    got = PA.write_chunk_pages(tp, torch.tensor(tables), torch.tensor(kv),
                               torch.tensor(offsets))
    _assert_pools_equal(want, got)


def test_write_token_page_int8_equals_jax():
    (jp, tp) = _both(_pool(4))
    tables = np.asarray([[0, 1], [2, 3], [SCRATCH, SCRATCH]], np.int32)
    positions = np.asarray([4, 5, 0], np.int32)   # slot 0, slot 1, scratch
    kv = _kv(5, 3)
    want = JPA.write_token_page(jp, jnp.asarray(tables), jnp.asarray(kv),
                                jnp.asarray(positions))
    got = PA.write_token_page(tp, torch.tensor(tables), torch.tensor(kv),
                              torch.tensor(positions))
    _assert_pools_equal(want, got)


@pytest.mark.parametrize("case", ["mixed", "all_pads"])
def test_write_ragged_pages_int8_equals_jax(case):
    """A chunk from slot 0, a chunk starting mid-page, a decode row and
    inactive rows: their pads land on the scratch page at slot i % page,
    duplicates included."""
    (jp, tp) = _both(_pool(6))
    tables = np.asarray([[0, 1], [2, 3], [4, 5], [6, 7]], np.int32)
    if case == "mixed":
        ctx = np.asarray([0, 3, 5, 0], np.int32)
        qlens = np.asarray([6, 3, 1, 0], np.int32)
    else:
        ctx = np.zeros(4, np.int32)
        qlens = np.zeros(4, np.int32)
    kv = _kv(7, 4, 6)
    want = JRPA.write_ragged_pages(jp, jnp.asarray(tables), jnp.asarray(kv),
                                   jnp.asarray(ctx), jnp.asarray(qlens),
                                   SCRATCH)
    got = RPA.write_ragged_pages(tp, torch.tensor(tables), torch.tensor(kv),
                                 torch.tensor(ctx), torch.tensor(qlens),
                                 SCRATCH)
    _assert_pools_equal(want, got)


# ----------------------------------------------------------------- protocol

def _fresh():
    return (torch.zeros(3, H, PG, D, dtype=torch.int8),
            torch.full((3, H), PA.KV_SCALE_EPS))


@pytest.mark.parametrize("chunks", [(8,), (3, 5), (1, 4, 3), (2, 2, 2, 2),
                                    (1,) * 8])
def test_slot0_protocol_is_write_order_invariant(chunks):
    """One stream of 8 tokens over two pages, written whole, in chunks
    through ``write_chunk_pages`` and ``write_ragged_pages``, and token
    by token through ``write_token_page``: EQUAL payloads and scales."""
    kv = torch.tensor(_kv(8, 1, 8))
    tables = torch.tensor([[0, 1]], dtype=torch.int32)
    whole = PA.write_chunk_pages(_fresh(), tables, kv,
                                 torch.zeros(1, dtype=torch.int32))
    chunked, ragged = _fresh(), _fresh()
    at = 0
    for n in chunks:
        off = torch.tensor([at], dtype=torch.int32)
        PA.write_chunk_pages(chunked, tables, kv[:, at:at + n], off)
        # the ragged writer's chunk is padded to 8, pads to page 2
        pad = torch.zeros(1, 8, H, D)
        pad[:, :n] = kv[:, at:at + n]
        RPA.write_ragged_pages(ragged, tables, pad, off,
                               torch.tensor([n], dtype=torch.int32), 2)
        at += n
    tok = _fresh()
    for i in range(8):
        PA.write_token_page(tok, tables, kv[:, i],
                            torch.tensor([i], dtype=torch.int32))
    for other in (chunked, ragged, tok):
        assert torch.equal(whole[0][:2], other[0][:2])
        assert torch.equal(whole[1][:2], other[1][:2])
    # and the offline construction agrees with the incremental one
    fp = torch.zeros(3, H, PG, D)
    fp[0] = kv[0, :4].permute(1, 0, 2)
    fp[1] = kv[0, 4:].permute(1, 0, 2)
    off_pay, off_sc = PA.quantize_pages(fp[:2])
    assert torch.equal(off_pay, whole[0][:2])
    assert torch.equal(off_sc, whole[1][:2])


def test_roundtrip_within_analytic_bound():
    """dequantize(quantize(x)) within ``kv_dequant_error_bound`` (the same
    number as JAX's), and the bound well under the data's magnitude."""
    pool = np.random.RandomState(0).randn(6, 4, 8, 16).astype(
        np.float32) * 3.0
    payload, scales = PA.quantize_pages(torch.tensor(pool))
    assert payload.dtype == torch.int8 and scales.dtype == torch.float32
    assert float(scales.min()) >= PA.KV_SCALE_EPS
    err = float((PA.dequantize_pages((payload, scales))
                 - torch.tensor(pool)).abs().max())
    bound = PA.kv_dequant_error_bound(pool, scales.numpy())
    assert bound == JPA.kv_dequant_error_bound(pool, scales.numpy())
    assert err <= bound < float(np.abs(pool).max())


# ------------------------------------------------------------------- config

@pytest.mark.parametrize("kv_dtype,flags", [
    (None, {}),
    (None, dict(speculate=True, enable_prefix_cache=True)),
    ("int8", dict(enable_prefix_cache=True)),
    ("int8", dict(speculate=True, enable_prefix_cache=True)),
    ("int4", dict(speculate=True, spec_accept_threshold=0.1)),
    ("fp8", {}),
    ("int4", dict(speculate=True)),
    ("int8", dict(spec_accept_threshold=1.5)),
])
def test_kv_quant_combo_like_jax(kv_dtype, flags):
    def outcome(fn, err):
        try:
            fn(kv_dtype, **flags)
            return None
        except err as e:
            return str(e)

    assert outcome(validate_kv_quant_combo, ShardedConfigError) == \
        outcome(jmesh.validate_kv_quant_combo, jmesh.ShardedConfigError)


def test_kv_dtype_validation():
    _, tm = _pair("llama")
    with pytest.raises(NotImplementedError, match="int8 payloads only"):
        PagedGenerationEngine(tm, kv_dtype="int4", device="cpu")
    with pytest.raises(ValueError, match="None or 'int8'"):
        PagedGenerationEngine(tm, kv_dtype="fp8", device="cpu")
    eng = PagedGenerationEngine(tm, page_size=PAGE, device="cpu")
    assert eng._kv_dtype is None
    with pytest.raises(ShardedConfigError, match="disagrees"):
        EngineCore(eng, kv_dtype="int8", device="cpu", **SHAPE)
    q8 = PagedGenerationEngine(tm, page_size=PAGE, kv_dtype="int8",
                               device="cpu")
    core = EngineCore(q8, kv_dtype="int8", device="cpu", **SHAPE)
    try:
        assert core._kv_dtype == "int8"
        k, v = q8._ensure_pages()
        payload, scales = k[0]
        assert payload.dtype == torch.int8 and scales.dtype == torch.float32
        assert tuple(scales.shape) == tuple(payload.shape[:2])
        assert bool((scales == PA.KV_SCALE_EPS).all())
    finally:
        core.close()


# ------------------------------------------------------------------ serving

def test_latched_jax_native_failure_is_recovered(monkeypatch):
    """The fault of a parallel run on a tree without the JAX native
    library: a worker whose load raced another worker's unlocked build
    while collecting (``tests/test_native.py``'s module-level
    ``native.available()``) latched "file too short" and every JAX
    engine it built after failed — the ``runs`` fixture below among
    them.  That latched state, set up directly: ``ensure_jax_native``
    clears it under the build lock and loads the finished library."""
    from paddle_infer_tpu import native as jnative

    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_load_error",
                        f"{jnative._LIB_PATH}: file too short")
    monkeypatch.setattr(jnative, "_build_attempted", True)
    with pytest.raises(RuntimeError, match="file too short"):
        jnative.KVBlockPool(4, 4)
    assert ensure_jax_native(attempts=2, wait_s=0.0)
    assert jnative.available() and jnative._load_error is None
    pool = jnative.KVBlockPool(4, 4)
    assert pool.reserve(0, 5) == 2



def _serve(core, G, rid_mod):
    rid_mod._rid_counter = itertools.count(700)
    try:
        reqs = [core.submit(p, g)[0] for p, g in zip(_prompts(), _cfgs(G))]
        _drive(core, reqs)
        failed = [(r.rid, r.state, r.error) for r in reqs
                  if r.error is not None]
        assert not failed, f"requests failed: {failed}"
        return reqs, core.metrics_snapshot()
    finally:
        core.close()


def _runs(kind):
    jm, tm = _pair(kind)
    saved = jrequest._rid_counter, trequest._rid_counter
    log = get_compile_log()
    out = {}
    try:
        for name, kw in (("plain", {}),
                         ("ngram", dict(speculate=True, num_draft_tokens=4,
                                        draft_source="ngram"))):
            log.reset()
            tcore = EngineCore(
                PagedGenerationEngine(tm, page_size=PAGE, kv_dtype="int8",
                                      device="cpu"),
                device="cpu", **SHAPE, **kw)
            out[name] = _serve(tcore, GenerationConfig, trequest)
            out[name + "_log"] = log.summary(), log.count("serving-decode")
            jcore = JCore(JEngine(jm, page_size=PAGE, kv_dtype="int8"),
                          enable_prefix_cache=False, **SHAPE, **kw)
            out["jax_" + name] = _serve(jcore, JGen, jrequest)
    finally:
        jrequest._rid_counter, trequest._rid_counter = saved
    return out


@pytest.fixture(scope="module", params=["llama", "gpt"])
def runs(request):
    with _pinned_globals():
        return _runs(request.param)


@pytest.mark.parametrize("name", ["plain", "ngram"])
def test_int8_streams_equal_jax(runs, name):
    treqs, tsnap = runs[name]
    jreqs, jsnap = runs["jax_" + name]
    for t, j in zip(treqs, jreqs):
        assert t.state == RequestState.DONE
        assert t.state.value == j.state.value and t.rid == j.rid
        assert t.tokens == j.tokens, (t.rid, t.tokens, j.tokens)
    assert tsnap["speculation"] == jsnap["speculation"]
    assert tsnap["kv_quant"] == jsnap["kv_quant"]


def test_int8_spec_greedy_streams_equal_plain(runs):
    plain, _ = runs["plain"]
    spec, snap = runs["ngram"]
    assert snap["speculation"]["drafts_proposed"] > 0
    for i in GREEDY:
        assert spec[i].tokens == plain[i].tokens


@pytest.mark.parametrize("name", ["plain", "ngram"])
def test_int8_no_first_call_after_warmup(runs, name):
    """One program for every batch composition: the serve-step site saw
    one first call (the warm-up) and none after."""
    summary, decode_calls = runs[name + "_log"]
    assert decode_calls == 1
    assert summary["post_warmup_decode_compiles"] == 0


def test_kv_quant_section_only_on_int8(runs):
    snap = runs["plain"][1]["kv_quant"]
    assert snap["kv_dtype"] == "int8"
    # fp32 pages are 4 bytes a value: an int8 page with its scales holds
    # 32 values a head in 32 + 4 bytes
    assert snap["resident_page_ratio"] == pytest.approx(
        4 * PAGE * 8 / (PAGE * 8 + 4))
    _, tm = _pair("llama")
    core = EngineCore(PagedGenerationEngine(tm, page_size=PAGE,
                                            device="cpu"),
                      device="cpu", **SHAPE)
    try:
        snap = core.metrics_snapshot()
        assert "kv_quant" not in snap and "prefix_cache" not in snap
    finally:
        core.close()


# ------------------------------------------------------------------ the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_int8_writer_and_page_copy_on_card(cuda_device):
    """``write_ragged_pages`` on an int8 pool on the card EQUAL to the
    CPU (the scratch page's payload aside: its duplicate pad writes land
    in either order; its scales are a max, so EQUAL), eagerly and as a
    CUDA graph replay; then ``build_page_copy`` copies a page's payload
    and scale row bitwise in every layer."""
    (_, cpu_pool) = _both(_pool(9))
    tables = np.asarray([[0, 1], [2, 3], [4, 5], [6, 7]], np.int32)
    ctx = np.asarray([0, 3, 5, 0], np.int32)
    qlens = np.asarray([6, 3, 1, 0], np.int32)
    kv = _kv(10, 4, 6)
    args = [torch.tensor(a) for a in (tables, kv, ctx, qlens)]
    want = RPA.write_ragged_pages(cpu_pool, args[0], args[1], args[2],
                                  args[3], SCRATCH)
    dev_args = [a.to(cuda_device) for a in args]
    scratch = torch.tensor(SCRATCH, dtype=torch.int32, device=cuda_device)

    def card_pool():
        return tuple(t.to(cuda_device) for t in _both(_pool(9))[1])

    eager_pool = card_pool()
    RPA.write_ragged_pages(eager_pool, *dev_args, scratch)
    graph_pool = card_pool()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        RPA.write_ragged_pages(card_pool(), *dev_args, scratch)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        RPA.write_ragged_pages(graph_pool, *dev_args, scratch)
    graph.replay()
    torch.cuda.synchronize()
    for got in (eager_pool, graph_pool):
        assert torch.equal(got[0][:SCRATCH].cpu(), want[0][:SCRATCH])
        assert torch.equal(got[1].cpu(), want[1])

    layers = [(card_pool(), card_pool()) for _ in range(2)]
    run = build_page_copy(None)
    src = torch.tensor([2], dtype=torch.int32, device=cuda_device)
    dst = torch.tensor([6], dtype=torch.int32, device=cuda_device)
    run({}, src, dst, [k for k, _ in layers], [v for _, v in layers])
    torch.cuda.synchronize()
    for k, v in layers:
        for pages in (k, v):
            assert torch.equal(pages[0][6], pages[0][2])
            assert torch.equal(pages[1][6], pages[1][2])
