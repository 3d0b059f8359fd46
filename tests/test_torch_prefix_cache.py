"""Port parity: the prefix cache on the ragged serving path.

* pool and tree — the native block operations (refcounts, ``assign``)
  and the radix tree's pinned partial tail as in the JAX package's
  tests; a seeded fuzz of admit / finish / evict on the port's tree and
  pool and on JAX's gives the same matches, block ids and
  ``stats_snapshot()`` after every operation, with the pool's
  invariants checked;
* serving — warm (radix-tree hit, with a copy-on-write tail) streams
  EQUAL to cold within the port, fp32 and int8 pools; streams with the
  cache equal the JAX ``EngineCore``'s with the cache, with equal hit
  and copy counts and ``prefix_cache`` snapshot sections; salts isolate
  tenants; a failed step or a cancel gives every block back; no new
  first call after warm-up on the serve-step site;
* drafts — ``PrefixCacheDraftSource`` and the auto source propose what
  JAX's propose on the same tree, and speculative streams with tree
  drafts equal plain ones;
* composition — a one-token prompt chunk goes through the ragged
  kernel, not the decode kernel, when the step flags its decode rows.
"""
import itertools
import math
import random

import numpy as np
import pytest
import torch

from paddle_infer_tpu import native as jnative
from paddle_infer_tpu.inference.generation import \
    GenerationConfig as JGen
from paddle_infer_tpu.inference.generation import \
    PagedGenerationEngine as JEngine
from paddle_infer_tpu.serving import EngineCore as JCore
from paddle_infer_tpu.serving import request as jrequest
from paddle_infer_tpu.serving import speculation as jspec
from paddle_infer_tpu.serving.prefix_cache import PrefixCache as JCache
from paddle_infer_tpu_torch import native
from paddle_infer_tpu_torch.inference.generation import (
    GenerationConfig, PagedGenerationEngine)
from paddle_infer_tpu_torch.observability import get_compile_log
from paddle_infer_tpu_torch.ops import ragged_paged_attention as RPA
from paddle_infer_tpu_torch.serving import EngineCore, RequestState
from paddle_infer_tpu_torch.serving import request as trequest
from paddle_infer_tpu_torch.serving import speculation as tspec
from paddle_infer_tpu_torch.serving.prefix_cache import PrefixCache

from _torch_jax_isolation import _private_jax_compile_log  # noqa: F401
from test_torch_speculation import PAGE, SHAPE, _drive, _pair, \
    _pinned_globals


@pytest.fixture(scope="module", autouse=True)
def _meshless():
    from paddle_infer_tpu.parallel import topology

    prev = topology.get_current_mesh()
    topology.set_current_mesh(None)
    yield
    topology.set_current_mesh(prev)


# ------------------------------------------------------------ pool, tree

def test_block_ops_refcount_lifecycle():
    pool = native.KVBlockPool(8, 4)
    b = pool.alloc_block()
    assert pool.block_refcount(b) == 1
    assert pool.ref_block(b) == 2
    assert pool.unref_block(b) == 1
    assert pool.unref_block(b) == 0          # freed
    assert pool.free_blocks == 8
    with pytest.raises(ValueError):
        pool.unref_block(b)                  # double-free guard
    with pytest.raises(ValueError):
        pool.ref_block(b)                    # a free block stays free
    for _ in range(8):
        pool.alloc_block()
    with pytest.raises(MemoryError):
        pool.alloc_block()


def test_assign_takes_per_sequence_refs():
    pool = native.KVBlockPool(8, 4)
    pool.reserve(0, 8)                       # seq 0: 2 blocks
    t0 = [int(x) for x in pool.block_table(0)]
    assert pool.assign(1, t0, 8) == 2        # seq 1 shares them
    assert all(pool.block_refcount(b) == 2 for b in t0)
    assert pool.length(1) == 8
    pool.free(0)
    assert all(pool.block_refcount(b) == 1 for b in t0)
    pool.free(1)
    assert pool.free_blocks == 8
    with pytest.raises(ValueError):          # a dead block fails it all
        pool.assign(2, t0, 8)
    assert pool.free_blocks == 8


def test_matched_partial_tail_pinned_against_eviction():
    """A matched partial tail stays pinned from match() to release():
    eviction may not recycle it before the consumer copies it."""
    pool = native.KVBlockPool(8, 4)
    cache = PrefixCache(pool, page_size=4, watermark=1.0)
    pool.reserve(0, 6)                       # 1 full page + 2-token tail
    table = [int(x) for x in pool.block_table(0)]
    cache.insert(list(range(6)), table)
    pool.free(0)                             # the tree holds the only refs
    m = cache.match([0, 1, 2, 3, 4, 99])     # full page + 1-token tail
    assert m.partial_block == table[1] and m.partial_len == 1
    assert not cache.ensure_free(pool.num_blocks)
    assert pool.block_refcount(m.partial_block) == 1
    blk = m.partial_block
    cache.release(m)
    assert cache.ensure_free(pool.num_blocks)
    assert pool.free_blocks == pool.num_blocks
    with pytest.raises(ValueError):
        pool.ref_block(blk)


def _tree_blocks(cache):
    out = []
    stack = list(cache._roots.values())
    while stack:
        n = stack.pop()
        stack.extend(n.children.values())
        if n.block is not None:
            out.append(n.block)
        out.extend(entry[0] for entry in n.partials.values())
    return out


def _check_invariants(pool, cache, active):
    tb = _tree_blocks(cache)
    assert len(tb) == len(set(tb)), "tree retains a block twice"
    assert cache.cached_blocks == len(tb)
    assert all(pool.block_refcount(b) >= 1 for b in tb)
    live = set(tb)
    for s in active:
        live.update(int(x) for x in pool.block_table(s))
    assert pool.num_blocks - pool.free_blocks == len(live)


class _Side:
    """One side of the fuzz: a pool and a tree, driven by the engine's
    staging protocol (match → ensure_free → copy-on-write alloc → assign
    → reserve); each operation returns what it decided."""

    def __init__(self, pool_cls, cache_cls, page):
        self.page = page
        self.pool = pool_cls(48, page)
        self.cache = cache_cls(self.pool, page, watermark=0.75)
        self.active = {}

    def admit(self, seq, tokens, extra, salt):
        m = self.cache.match(tokens, salt=salt)
        decided = (list(m.blocks), m.partial_block, m.partial_len)
        reserve = len(tokens) + extra
        self.cache.ensure_free(math.ceil(reserve / self.page)
                               - len(m.blocks))
        try:
            cow = None
            if m.partial_block is not None:
                cow = self.pool.alloc_block()
                self.cache.on_cow()
            blocks = list(m.blocks)
            ntok = len(blocks) * self.page
            if cow is not None:
                blocks.append(cow)
                ntok += m.partial_len
            try:
                if blocks:
                    self.pool.assign(seq, blocks, ntok)
            finally:
                if cow is not None:
                    self.pool.unref_block(cow)
            self.pool.reserve(seq, reserve)
            self.active[seq] = (m, tokens, salt)
            return decided, [int(b) for b in self.pool.block_table(seq)]
        except MemoryError:
            self.pool.free(seq)
            self.cache.release(m)
            return decided, "oom"

    def finish(self, seq, retain):
        m, tokens, salt = self.active.pop(seq)
        if retain:
            self.cache.insert(tokens, self.pool.block_table(seq), salt=salt)
        self.pool.free(seq)
        self.cache.release(m)
        self.cache.enforce_watermark()

    def state(self):
        _check_invariants(self.pool, self.cache, self.active)
        return self.cache.stats_snapshot(), self.pool.free_blocks


def test_tree_decisions_equal_jax_under_fuzz():
    """400 seeded admit / finish / evict / trim / peek / lookahead
    operations on both sides, with two tenants: every match, block
    table, proposal and ``stats_snapshot()`` EQUAL, invariants held."""
    page = 4
    ours = _Side(native.KVBlockPool, PrefixCache, page)
    theirs = _Side(jnative.KVBlockPool, JCache, page)
    rng = random.Random(0)
    next_seq = 0
    for step in range(400):
        op = rng.choice(["admit", "admit", "finish", "finish", "evict",
                         "trim", "probe"])
        salt = rng.choice([None, "tenant-b"])
        if op == "admit" and len(ours.active) < 6:
            tokens = [rng.randrange(5) for _ in range(rng.randrange(2, 30))]
            extra = rng.randrange(0, 8)
            assert ours.admit(next_seq, tokens, extra, salt) == \
                theirs.admit(next_seq, tokens, extra, salt), step
            next_seq += 1
        elif op == "finish" and ours.active:
            seq = rng.choice(sorted(ours.active))
            retain = rng.random() < 0.7
            ours.finish(seq, retain)
            theirs.finish(seq, retain)
        elif op == "evict":
            need = rng.randrange(0, 12)
            assert ours.cache.ensure_free(need) == \
                theirs.cache.ensure_free(need)
        elif op == "trim":
            tokens = [rng.randrange(5) for _ in range(rng.randrange(2, 30))]
            keep = rng.randrange(0, 20)
            got = []
            for side in (ours, theirs):
                m = side.cache.match(tokens, salt=salt)
                side.cache.trim(m, keep)
                got.append((list(m.blocks), m.partial_block,
                            m.cached_tokens))
                side.cache.release(m)
            assert got[0] == got[1], step
        else:
            tokens = [rng.randrange(5) for _ in range(rng.randrange(1, 30))]
            k = rng.randrange(0, 9)
            for fn in ("peek", "lookahead"):
                args = (tokens,) if fn == "peek" else (tokens, k)
                assert getattr(ours.cache, fn)(*args, salt=salt) == \
                    getattr(theirs.cache, fn)(*args, salt=salt), (step, fn)
        assert ours.state() == theirs.state(), step
    for side in (ours, theirs):
        for seq in sorted(side.active):
            side.finish(seq, retain=False)
        side.cache.clear()
        assert side.pool.free_blocks == side.pool.num_blocks
    assert ours.cache.stats_snapshot() == theirs.cache.stats_snapshot()


# ------------------------------------------------------------------ drafts

def _twin_trees():
    """The same inserts into the port's tree and JAX's."""
    rs = np.random.RandomState(3)
    seqs = [list(rs.randint(0, 6, n)) for n in (13, 21, 8, 30, 17)]
    trees = []
    for pool_cls, cache_cls in ((native.KVBlockPool, PrefixCache),
                                (jnative.KVBlockPool, JCache)):
        pool = pool_cls(64, 4)
        cache = cache_cls(pool, 4, watermark=1.0)
        for i, s in enumerate(seqs):
            pool.reserve(i, len(s))
            cache.insert(s, pool.block_table(i), salt=None if i % 2 else "a")
            pool.free(i)
        trees.append(cache)
    return seqs, trees


def test_tree_draft_proposals_equal_jax():
    seqs, (ours, theirs) = _twin_trees()
    rs = np.random.RandomState(4)
    histories = [s[:n] for s in seqs for n in (1, 4, 5, 9, len(s))]
    histories += [list(rs.randint(0, 6, n)) for n in range(1, 20)]
    sources = [(tspec.PrefixCacheDraftSource(ours),
                jspec.PrefixCacheDraftSource(theirs)),
               (tspec.AutoDraftSource(cache=ours),
                jspec.AutoDraftSource(cache=theirs))]
    fired = 0
    for t_src, j_src in sources:
        for h in histories:
            for k in (1, 3, 6):
                for salt in (None, "a"):
                    for det in (False, True):
                        got = t_src.propose(h, k, salt=salt,
                                            deterministic_only=det)
                        assert got == j_src.propose(
                            h, k, salt=salt, deterministic_only=det)
                        fired += bool(got)
    assert fired > 0
    assert isinstance(tspec.resolve_draft_source("prefix_cache", cache=ours),
                      tspec.PrefixCacheDraftSource)
    with pytest.raises(ValueError, match="enable_prefix_cache"):
        tspec.resolve_draft_source("prefix_cache")


# ----------------------------------------------------------------- serving

BASE = np.random.RandomState(11).randint(0, 96, (20,)).astype(np.int32)
EXTRA = np.random.RandomState(12).randint(0, 96, (6,)).astype(np.int32)


def _waves():
    """Serving waves, each driven to the end before the next: a cold
    prompt, its repeat (a hit whose partial tail is copied on write), a
    longer prompt sharing its full pages, a sampled one over the same
    pages, and a short unrelated prompt (a miss)."""
    return [[(BASE, dict(max_new_tokens=6))],
            [(BASE, dict(max_new_tokens=6))],
            [(np.concatenate([BASE, EXTRA]), dict(max_new_tokens=5)),
             (BASE[:13], dict(max_new_tokens=6, do_sample=True,
                              temperature=0.9, top_p=0.9, seed=3))],
            [(BASE[3:9], dict(max_new_tokens=4))]]


def _serve_waves(core, G, rid_mod, salt=None, waves=None):
    rid_mod._rid_counter = itertools.count(800)
    out = []
    try:
        for wave in waves or _waves():
            reqs = [core.submit(p, G(**kw), cache_salt=salt)[0]
                    for p, kw in wave]
            _drive(core, reqs)
            for r in reqs:
                assert r.state.value == "done", (r.rid, r.error)
            out += [r.tokens for r in reqs]
        snap = core.metrics_snapshot()
        return out, snap
    finally:
        core.close()


def _tcore(tm, kv_dtype=None, **kw):
    return EngineCore(PagedGenerationEngine(tm, page_size=PAGE,
                                            kv_dtype=kv_dtype, device="cpu"),
                      device="cpu", **SHAPE, **kw)


@pytest.fixture(scope="module")
def llama():
    with _pinned_globals():
        return _pair("llama")


@pytest.fixture(scope="module", params=[None, "int8"], ids=["fp32", "int8"])
def served(request, llama):
    """The waves on a port core with the cache, on one without (cold),
    and on the JAX core with the cache; the serve-step compile log of
    the warm run."""
    jm, tm = llama
    kv = request.param
    saved = jrequest._rid_counter, trequest._rid_counter
    log = get_compile_log()
    try:
        with _pinned_globals():
            log.reset()
            warm = _serve_waves(_tcore(tm, kv, enable_prefix_cache=True),
                                GenerationConfig, trequest)
            logged = (log.summary(), log.count("serving-decode"),
                      log.count("serving-serve-page-copy"))
            cold = _serve_waves(_tcore(tm, kv), GenerationConfig, trequest)
            jax_warm = _serve_waves(
                JCore(JEngine(jm, page_size=PAGE, kv_dtype=kv),
                      enable_prefix_cache=True, **SHAPE),
                JGen, jrequest)
    finally:
        jrequest._rid_counter, trequest._rid_counter = saved
    return dict(warm=warm, cold=cold, jax=jax_warm, log=logged)


def test_warm_streams_equal_cold(served):
    warm, _ = served["warm"]
    cold, _ = served["cold"]
    assert warm == cold


def test_cache_hits_and_copies(served):
    snap = served["warm"][1]["prefix_cache"]
    # the repeat, the longer prompt and the sampled one hit; the first
    # and the unrelated prompt miss; the repeat copies its tail
    assert snap["queries"] == 5 and snap["hits"] == 3
    assert snap["cow_copies"] >= 1
    assert "prefix_cache" not in served["cold"][1]


def test_streams_and_counters_equal_jax(served):
    warm, tsnap = served["warm"]
    jwarm, jsnap = served["jax"]
    assert warm == jwarm
    assert tsnap["prefix_cache"] == jsnap["prefix_cache"]
    assert tsnap.get("kv_quant") == jsnap.get("kv_quant")
    assert tsnap["kv_pool"]["headroom_pages"] == \
        jsnap["kv_pool"]["headroom_pages"]


def test_no_first_call_after_warmup(served):
    """One first call on the serve-step site (the warm-up) and one for
    the page copy's own key, whatever the waves' compositions."""
    summary, decode_calls, copy_calls = served["log"]
    assert decode_calls == 1 and copy_calls == 1
    assert summary["post_warmup_decode_compiles"] == 0


def test_salts_isolate_tenants(llama):
    _, tm = llama
    core = _tcore(tm, enable_prefix_cache=True)
    try:
        g = GenerationConfig(max_new_tokens=3)
        for salt in ("a", "b", "a", None):
            r = core.submit(BASE, g, cache_salt=salt)[0]
            _drive(core, [r])
        snap = core.prefix_cache.stats_snapshot()
        # only the second "a" request hits: "b" and None are other trees
        assert snap["queries"] == 4 and snap["hits"] == 1
        assert core.prefix_cache.peek(BASE, salt="b") > 0
        assert core.prefix_cache.peek(BASE, salt="c") == 0
    finally:
        core.close()


def _assert_all_blocks_back(core):
    pool = core._pool
    cache = core.prefix_cache
    held = 1 + (cache.cached_blocks if cache is not None else 0)
    assert pool.num_blocks - pool.free_blocks == held
    stack = list(cache._roots.values()) if cache is not None else []
    while stack:
        n = stack.pop()
        stack.extend(n.children.values())
        assert n.pins == 0
        assert all(e[2] == 0 for e in n.partials.values())


def test_cancel_gives_every_block_back(llama):
    _, tm = llama
    core = _tcore(tm, enable_prefix_cache=True)
    try:
        r = core.submit(BASE, GenerationConfig(max_new_tokens=4))[0]
        _drive(core, [r])
        warm = core.submit(BASE, GenerationConfig(max_new_tokens=8),
                           timeout_s=60.0)[0]
        core.run_once()                      # admitted on a hit
        assert warm.state == RequestState.ACTIVE
        warm.deadline = 0.0
        core.run_once()
        assert warm.state == RequestState.CANCELLED
        _assert_all_blocks_back(core)
        # a cancelled row is never retained
        assert core.prefix_cache.stats_snapshot()["inserts"] == 1
    finally:
        core.close()
    assert core._pool.free_blocks == core._pool.num_blocks


def test_failed_step_gives_every_block_back(llama):
    _, tm = llama
    core = _tcore(tm, enable_prefix_cache=True)
    try:
        r = core.submit(BASE, GenerationConfig(max_new_tokens=4))[0]
        _drive(core, [r])
        eng = core._engine
        step = eng._model_step

        def broken(*a, **kw):
            raise RuntimeError("injected step failure")

        eng._model_step = broken
        reqs = [core.submit(p, GenerationConfig(max_new_tokens=4))[0]
                for p in (BASE, BASE[:9])]
        core.run_once()
        eng._model_step = step
        assert all(q.state == RequestState.FAILED for q in reqs)
        # the pools are suspect: the retained prefixes went too
        assert core.prefix_cache.stats_snapshot()["cached_blocks"] == 0
        _assert_all_blocks_back(core)
        r = core.submit(BASE, GenerationConfig(max_new_tokens=4))[0]
        _drive(core, [r])                    # the core still serves
        assert r.state == RequestState.DONE
    finally:
        core.close()


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["fp32", "int8"])
def test_tree_draft_streams_equal_plain(llama, kv_dtype):
    """Repeated prompts make tree drafts fire: greedy speculative streams
    with ``draft_source="prefix_cache"`` and ``"auto"`` equal plain ones,
    with drafts accepted."""
    _, tm = llama
    waves = [[(BASE, dict(max_new_tokens=10))]] * 3 + [
        [(BASE, dict(max_new_tokens=10)),
         (np.concatenate([BASE, EXTRA]), dict(max_new_tokens=8))]]
    plain, _ = _serve_waves(_tcore(tm, kv_dtype), GenerationConfig,
                            trequest, waves=waves)
    for source in ("prefix_cache", "auto"):
        spec, snap = _serve_waves(
            _tcore(tm, kv_dtype, enable_prefix_cache=True, speculate=True,
                   num_draft_tokens=4, draft_source=source),
            GenerationConfig, trequest, waves=waves)
        assert spec == plain, source
        assert snap["speculation"]["drafts_accepted"] > 0, source


# ------------------------------------------------------------- composition

def test_one_token_prompt_chunk_takes_the_ragged_kernel():
    """With ``decode_rows`` a one-token row that is not flagged (a prompt
    chunk) gets the ragged kernel's output, a flagged one the decode
    kernel's; without it both are decode rows, as in the reference."""
    rs = np.random.RandomState(5)
    h, d, page, max_pages = 2, 8, 4, 3
    num_pages = 2 * max_pages + 1
    k = torch.tensor(rs.randn(num_pages, h, page, d).astype(np.float32))
    v = torch.tensor(rs.randn(num_pages, h, page, d).astype(np.float32))
    tables = torch.arange(2 * max_pages, dtype=torch.int32).reshape(2, -1)
    q = torch.tensor(rs.randn(2, 4, h, d).astype(np.float32))
    ctx = torch.tensor([5, 5], dtype=torch.int32)
    qlens = torch.tensor([1, 1], dtype=torch.int32)
    flags = torch.tensor([False, True])
    out = RPA.ragged_paged_attention(q, k, v, tables, ctx, qlens,
                                     decode_rows=flags)
    ragged = RPA.ragged_kernel(q, k, v, tables, ctx, qlens)
    dec = RPA.paged_attention_decode(q[:, 0].contiguous(), k, v, tables,
                                     ctx + 1)
    assert torch.equal(out[0, 0], ragged[0, 0])
    assert torch.equal(out[1, 0], dec[1])
    ref = RPA.ragged_paged_attention(q, k, v, tables, ctx, qlens)
    assert torch.equal(ref[:, 0], dec)


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["fp32", "int8"])
def test_warm_steps_read_nothing_back(llama, kv_dtype):
    """A warm admission (the page copy) and the steps after it, on
    int8 pools too, under the dispatch guard that raises on any read of a
    tensor value back to the host (what breaks a CUDA graph capture)."""
    from test_torch_graphs import _NoHostReads

    _, tm = llama
    core = _tcore(tm, kv_dtype, enable_prefix_cache=True)
    try:
        r = core.submit(BASE, GenerationConfig(max_new_tokens=4))[0]
        _drive(core, [r])
        warm = core.submit(BASE, GenerationConfig(max_new_tokens=5))[0]
        while not warm.done:
            mode = _NoHostReads()
            with mode:
                core.run_once()
            assert mode.ops > 0
        assert core.prefix_cache.stats_snapshot()["cow_copies"] == 1
        assert warm.state == RequestState.DONE
        assert warm.tokens[:4] == r.tokens
    finally:
        core.close()
