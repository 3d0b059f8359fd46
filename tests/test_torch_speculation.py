"""Port parity: speculative draft/verify serving.

* kernel level — the verify kernel's plain version ``_verify_plain``
  against the JAX ``paged_attention_verify`` (Pallas, interpret mode) at
  the reference test's shape, fp32 and int8 pages, tol 2e-5 (float32
  sums in another order); each lane EQUAL to the port's ``_decode_plain``
  at its length; ``_ragged_reference`` with verify rows against JAX;
* accept algebra — the four ``spec_accept`` functions equal JAX's on
  seeded arrays, and the accept/resample key streams bit-equal to
  ``jax.random``;
* draft sources — ngram and auto proposals equal JAX's on 200 seeded
  histories;
* serving — ``EngineCore(speculate=True)`` greedy and seeded-sampled
  streams of tiny LLaMA and tiny GPT equal to the JAX
  ``EngineCore(speculate=True)`` (prefix cache off on both, request ids
  pinned), with equal ``speculation`` metrics and drafts accepted; and
  within the port, speculative greedy streams bitwise equal to plain
  ones with the ngram and the oracle sources.
"""
import contextlib
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_infer_tpu as pit
from paddle_infer_tpu.inference import spec_accept as jsa
from paddle_infer_tpu.inference.generation import \
    GenerationConfig as JGen
from paddle_infer_tpu.inference.generation import \
    PagedGenerationEngine as JEngine
from paddle_infer_tpu.models import GPTConfig as JGPTConfig
from paddle_infer_tpu.models import GPTForCausalLM as JGPT
from paddle_infer_tpu.models import LlamaConfig as JLlamaConfig
from paddle_infer_tpu.models import LlamaForCausalLM as JLlama
from paddle_infer_tpu.ops.pallas import paged_attention as JPA
from paddle_infer_tpu.ops.pallas import ragged_paged_attention as JRPA
from paddle_infer_tpu.serving import EngineCore as JCore
from paddle_infer_tpu.serving import request as jrequest
from paddle_infer_tpu.serving import speculation as jspec
from paddle_infer_tpu_torch.core import random as R
from paddle_infer_tpu_torch.inference import spec_accept as tsa
from paddle_infer_tpu_torch.inference.generation import (
    GenerationConfig, PagedGenerationEngine)
from paddle_infer_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                           LlamaConfig, LlamaForCausalLM)
from paddle_infer_tpu_torch.ops import paged_attention as PA
from paddle_infer_tpu_torch.ops import ragged_paged_attention as RPA
from paddle_infer_tpu_torch.serving import EngineCore, RequestState
from paddle_infer_tpu_torch.serving import request as trequest
from paddle_infer_tpu_torch.serving import speculation as tspec
from paddle_infer_tpu_torch.weights import from_jax_state_dict

from _torch_jax_isolation import _private_jax_compile_log  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)
TINY = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64)
SHAPE = dict(max_batch=3, max_model_len=48, token_budget=16,
             prefill_chunk=16)
PAGE = 8
NUM_DRAFT = 4


@pytest.fixture(scope="module", autouse=True)
def _meshless():
    from paddle_infer_tpu.parallel import topology

    prev = topology.get_current_mesh()
    topology.set_current_mesh(None)
    yield
    topology.set_current_mesh(prev)


# ------------------------------------------------------------------ kernel

def _verify_case(seed, quantized):
    """The reference test's verify shape (b=4, w=5, h=2, d=16, page 8,
    5 pages per row, 24 pages) — lengths ctx + j + 1."""
    rs = np.random.RandomState(seed)
    b, w, h, d, page, max_pages, num_pages = 4, 5, 2, 16, 8, 5, 24
    q = rs.randn(b, w, h, d).astype(np.float32)
    k = rs.randn(num_pages, h, page, d).astype(np.float32)
    v = rs.randn(num_pages, h, page, d).astype(np.float32)
    tables = rs.randint(0, num_pages, (b, max_pages)).astype(np.int32)
    ctx = rs.randint(1, max_pages * page - w - 1, (b,))
    lens = (ctx[:, None] + np.arange(w)[None] + 1).astype(np.int32)
    if quantized:
        jk, jv = JPA.quantize_pages(jnp.asarray(k)), JPA.quantize_pages(
            jnp.asarray(v))
        tk = tuple(torch.tensor(np.asarray(a)) for a in jk)
        tv = tuple(torch.tensor(np.asarray(a)) for a in jv)
    else:
        jk, jv = jnp.asarray(k), jnp.asarray(v)
        tk, tv = torch.tensor(k), torch.tensor(v)
    return q, (jk, jv), (tk, tv), tables, lens


@pytest.mark.parametrize("quantized", [False, True])
def test_verify_plain_matches_jax_kernel(quantized):
    q, (jk, jv), (tk, tv), tables, lens = _verify_case(0, quantized)
    want = np.asarray(JPA.paged_attention_verify(
        jnp.asarray(q), jk, jv, jnp.asarray(tables), jnp.asarray(lens),
        interpret=True))
    got = PA.paged_attention_verify(torch.tensor(q), tk, tv,
                                    torch.tensor(tables), torch.tensor(lens))
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("quantized", [False, True])
def test_verify_plain_matches_jax_kernel_across_split_boundaries(quantized):
    """Verify lanes that straddle the card kernel's page and split
    boundaries (a 20-page table of 4-slot pages, splits of 8 pages: see
    ``test_torch_paged_attention.BOUNDARY_LENS``), a row of length 0 and
    the full table: the plain version still equals the Pallas kernel.
    A row's lanes are at least 1 where its last lane is: beside a longer
    lane, the Pallas verify kernel gives a lane of length 0 the mean of V
    over its first page, where its decode kernel gives zeros (serving's
    lanes are ctx + j + 1 >= 1)."""
    from test_torch_paged_attention import BOUNDARY_LENS, D, H, boundary_case

    (jk, jv), (tk, tv), tables = boundary_case(40, quantized)
    w = 5
    last = np.asarray(BOUNDARY_LENS)
    lens = np.clip(last[:, None] - (w - 1) + np.arange(w)[None],
                   np.minimum(last, 1)[:, None], None).astype(np.int32)
    q = np.random.RandomState(41).randn(len(last), w, H, D).astype(
        np.float32)
    want = np.asarray(JPA.paged_attention_verify(
        jnp.asarray(q), jk, jv, jnp.asarray(tables), jnp.asarray(lens),
        interpret=True))
    got = PA.paged_attention_verify(torch.tensor(q), tk, tv,
                                    torch.tensor(tables), torch.tensor(lens))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("quantized", [False, True])
def test_verify_lanes_equal_decode_plain(quantized):
    q, _, (tk, tv), tables, lens = _verify_case(1, quantized)
    tq, tt, tl = torch.tensor(q), torch.tensor(tables), torch.tensor(lens)
    out = PA.paged_attention_verify(tq, tk, tv, tt, tl)
    for w in range(q.shape[1]):
        dec = PA._decode_plain(tq[:, w], tk, tv, tt, tl[:, w])
        assert torch.equal(out[:, w], dec), f"lane {w}"


@pytest.mark.parametrize("quantized", [False, True])
def test_ragged_reference_verify_rows_match_jax(quantized):
    """Rows 0 and 2 verify (drafts), row 1 is a plain decode row, row 3
    a prefill chunk, row 4 inactive: every valid position agrees."""
    rs = np.random.RandomState(2)
    h, d, page, max_pages, num_pages, c, w = 2, 16, 8, 5, 27, 6, 4
    k = rs.randn(num_pages, h, page, d).astype(np.float32)
    v = rs.randn(num_pages, h, page, d).astype(np.float32)
    ctx = np.asarray([9, 17, 0, 3, 0], np.int32)
    qlens = np.asarray([4, 1, 3, 6, 0], np.int32)
    verify = np.asarray([True, False, True, False, False])
    q = rs.randn(len(ctx), c, h, d).astype(np.float32)
    tables = rs.permutation(num_pages - 1)[:len(ctx) * max_pages].reshape(
        len(ctx), max_pages).astype(np.int32)
    if quantized:
        jk, jv = JPA.quantize_pages(jnp.asarray(k)), JPA.quantize_pages(
            jnp.asarray(v))
        tk = tuple(torch.tensor(np.asarray(a)) for a in jk)
        tv = tuple(torch.tensor(np.asarray(a)) for a in jv)
    else:
        jk, jv = jnp.asarray(k), jnp.asarray(v)
        tk, tv = torch.tensor(k), torch.tensor(v)
    want = np.asarray(JRPA.ragged_paged_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(tables), jnp.asarray(ctx),
        jnp.asarray(qlens), verify_rows=jnp.asarray(verify),
        verify_window=w))
    got = RPA.ragged_paged_attention(
        torch.tensor(q), tk, tv, torch.tensor(tables), torch.tensor(ctx),
        torch.tensor(qlens), verify_rows=torch.tensor(verify),
        verify_window=w).numpy()
    valid = np.arange(c)[None] < qlens[:, None]
    np.testing.assert_allclose(got[valid], want[valid], **TOL)
    # a verify row's position j is the decode plain version at ctx + j + 1
    tq = torch.tensor(q)
    for j in range(3):
        dec = PA._decode_plain(tq[:, j], tk, tv, torch.tensor(tables),
                               torch.tensor(ctx + j + 1))
        assert torch.equal(torch.tensor(got[0, j]), dec[0])


# ---------------------------------------------------------- accept algebra

def test_spec_accept_functions_equal_jax():
    rs = np.random.RandomState(3)
    mask = rs.rand(64, 4) < 0.7
    mask[0] = True
    mask[1] = False
    np.testing.assert_array_equal(
        tsa.accepted_prefix_len(torch.tensor(mask)).numpy(),
        np.asarray(jsa.accepted_prefix_len(jnp.asarray(mask))))
    u = rs.rand(64, 4).astype(np.float32)
    p = rs.rand(64, 4).astype(np.float32)
    qd = np.where(rs.rand(64, 4) < 0.2, 0.0, rs.rand(64, 4)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tsa.rejection_accept(torch.tensor(u), torch.tensor(p),
                             torch.tensor(qd)).numpy(),
        np.asarray(jsa.rejection_accept(jnp.asarray(u), jnp.asarray(p),
                                        jnp.asarray(qd))))
    pp = rs.dirichlet(np.ones(12), 16).astype(np.float32)
    qq = rs.dirichlet(np.ones(12), 16).astype(np.float32)
    qq[0] = pp[0]                        # no residual mass: falls back to p
    np.testing.assert_array_equal(
        tsa.residual_probs(torch.tensor(pp), torch.tensor(qq)).numpy(),
        np.asarray(jsa.residual_probs(jnp.asarray(pp), jnp.asarray(qq))))
    logits = rs.randn(16, 96).astype(np.float32)
    draft = rs.randint(0, 96, (16,)).astype(np.int32)
    np.testing.assert_array_equal(
        tsa.residual_logits_point_mass(torch.tensor(logits),
                                       torch.tensor(draft)).numpy(),
        np.asarray(jsa.residual_logits_point_mass(jnp.asarray(logits),
                                                  jnp.asarray(draft))))


def test_accept_streams_bit_equal_jax():
    """The accept test's ``uniform(fold_in(fold_in(key, step), 1))`` over
    [b, W-1] keys and the resample's ``categorical(fold_in(fold_in(key,
    step), 2), ...)`` — bits equal to ``jax.random``."""
    b, wm1 = 5, 4
    keys = jax.vmap(jax.random.fold_in)(
        jnp.stack([jax.random.PRNGKey(7)] * b), jnp.arange(100, 100 + b))
    steps = np.random.RandomState(4).randint(0, 40, (b, wm1)).astype(
        np.int32)
    want = np.asarray(jax.vmap(jax.vmap(
        lambda k, st: jax.random.uniform(
            jax.random.fold_in(jax.random.fold_in(k, st), 1)),
        in_axes=(None, 0)))(keys, jnp.asarray(steps)))
    tkeys = torch.tensor(np.asarray(keys).astype(np.int64))
    got = R.uniform(R.fold_in(R.fold_in(tkeys[:, None, :],
                                        torch.tensor(steps)), 1)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    logits = np.random.RandomState(5).randn(b, 96).astype(np.float32)
    st = steps[:, 0]
    rk = jax.vmap(lambda k, s: jax.random.fold_in(
        jax.random.fold_in(k, s), 2))(keys, jnp.asarray(st))
    want = np.asarray(jax.vmap(lambda k, row: jax.random.categorical(
        k, row))(rk, jnp.asarray(logits)))
    got = R.categorical(R.fold_in(R.fold_in(tkeys, torch.tensor(st)), 2),
                        torch.tensor(logits)).numpy()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ draft sources

def _histories(n=200):
    rs = np.random.RandomState(6)
    out = []
    for _ in range(n):
        pat = rs.randint(0, 7, (rs.randint(1, 5),))
        h = np.tile(pat, rs.randint(1, 6))
        noise = rs.rand(h.size) < 0.2
        h = np.where(noise, rs.randint(0, 7, h.size), h)
        out.append(h[:rs.randint(0, h.size + 1)].astype(np.int32))
    return out


@pytest.mark.parametrize("name", ["ngram", "auto"])
def test_draft_proposals_equal_jax(name):
    js, ts = jspec.resolve_draft_source(name), tspec.resolve_draft_source(
        name)
    fired = 0
    for i, h in enumerate(_histories()):
        k = 1 + i % 5
        want = js.propose(h, k, deterministic_only=bool(i % 2))
        got = ts.propose(h, k, deterministic_only=bool(i % 2))
        assert got == want, (h, k)
        fired += bool(got)
    assert fired > 50


def test_resolve_draft_source_like_jax():
    assert isinstance(tspec.resolve_draft_source("ngram"),
                      tspec.NgramDraftSource)
    assert isinstance(tspec.resolve_draft_source(None),
                      tspec.AutoDraftSource)
    src = tspec.resolve_draft_source(lambda h, k: [1, 2, 3, 4])
    assert isinstance(src, tspec.CallableDraftSource)
    assert src.propose([0], 2) == [1, 2]
    assert src.propose([0], 2, deterministic_only=True) == []
    with pytest.raises(ValueError, match="enable_prefix_cache"):
        tspec.resolve_draft_source("prefix_cache")
    with pytest.raises(ValueError):
        tspec.resolve_draft_source(42)


# ----------------------------------------------------------------- serving

class Oracle:
    """Proposes each request's continuation from a known stream: the
    prompt is looked up by prefix, the drafts follow what was already
    emitted.  Declared deterministic, so sampled rows draft too."""

    name = "oracle"
    deterministic = True

    def __init__(self, prompts, streams):
        self._pairs = [(np.asarray(p), list(s))
                       for p, s in zip(prompts, streams)]

    def propose(self, history, k, salt=None, deterministic_only=False):
        h = np.asarray(history)
        for p, s in self._pairs:
            if h.size >= p.size and np.array_equal(h[:p.size], p):
                done = h.size - p.size
                return s[done:done + k]
        return []


def _prompts():
    """Tiled short patterns (so ngram drafts fire), one longer than the
    token budget (so it is prefilled in chunks)."""
    rs = np.random.RandomState(0)
    return [np.tile(rs.randint(0, 96, (m,)), -(-n // m))[:n].astype(np.int32)
            for n, m in ((20, 3), (5, 2), (9, 4), (1, 1), (13, 2))]


def _cfgs(G):
    return [G(max_new_tokens=7),
            G(max_new_tokens=6, do_sample=True, temperature=0.8, top_k=20,
              top_p=0.9, seed=3),
            G(max_new_tokens=8),
            G(max_new_tokens=5),
            G(max_new_tokens=7, do_sample=True, temperature=1.3, top_p=0.7,
              seed=5, eos_token_id=17)]


GREEDY = (0, 2, 3)


def _drive(core, reqs, max_iters=400):
    for _ in range(max_iters):
        if all(r.done for r in reqs):
            return
        core.run_once()
    raise AssertionError("requests did not finish")


def _serve(core, G, rid_mod):
    rid_mod._rid_counter = itertools.count(500)
    try:
        reqs = [core.submit(p, g)[0] for p, g in zip(_prompts(), _cfgs(G))]
        _drive(core, reqs)
        # a request that failed names its cause here, not as a token
        # mismatch in the tests below
        failed = [(r.rid, r.state, r.error) for r in reqs
                  if r.error is not None]
        assert not failed, f"requests failed: {failed}"
        return reqs, core.metrics_snapshot()
    finally:
        core.close()


def _pair(kind):
    pit.seed(0)
    if kind == "llama":
        cfg = dict(TINY, num_key_value_heads=2)
        jm = JLlama(JLlamaConfig(**cfg))
        tm = LlamaForCausalLM(LlamaConfig(**cfg), device="cpu")
    else:
        cfg = dict(TINY, hidden_dropout_prob=0.0,
                   attention_probs_dropout_prob=0.0)
        jm = JGPT(JGPTConfig(**cfg))
        tm = GPTForCausalLM(GPTConfig(**cfg), device="cpu")
    jm.eval()
    from_jax_state_dict(tm, {k: np.asarray(v.numpy())
                             for k, v in jm.state_dict().items()})
    return jm, tm


@contextlib.contextmanager
def _pinned_globals():
    """Every process-wide setting the streams below depend on, set to
    its default for the serving runs and restored after: the module
    fixture runs before the first test's autouse seeding, after whatever
    test file the worker ran last.  JAX package: AMP state, the op
    profile hook, the IR tracer, the default dtype, the global key;
    jax's x64 flag; torch's default dtype, grad mode and global seed;
    numpy's global seed; the port's O2 scope."""
    from paddle_infer_tpu.core import dispatch as jdispatch
    from paddle_infer_tpu_torch import amp as tamp

    saved_amp = jdispatch.set_amp_state(False)
    saved_hook = jdispatch.set_op_profile_hook(None)
    saved_tracer = jdispatch.set_tracer(None)
    saved_dtype = pit.get_default_dtype()
    saved_x64 = jax.config.jax_enable_x64
    saved_torch = (torch.get_default_dtype(), torch.is_grad_enabled(),
                   torch.random.get_rng_state())
    saved_np = np.random.get_state()
    pit.set_default_dtype("float32")
    jax.config.update("jax_enable_x64", False)
    torch.set_default_dtype(torch.float32)
    torch.set_grad_enabled(True)
    torch.manual_seed(0)
    np.random.seed(0)
    pit.seed(0)
    try:
        with tamp.amp_scope(enabled=False):
            yield
    finally:
        np.random.set_state(saved_np)
        torch.set_default_dtype(saved_torch[0])
        torch.set_grad_enabled(saved_torch[1])
        torch.random.set_rng_state(saved_torch[2])
        jax.config.update("jax_enable_x64", saved_x64)
        pit.set_default_dtype(saved_dtype)
        jdispatch.set_tracer(saved_tracer)
        jdispatch.set_op_profile_hook(saved_hook)
        jdispatch.set_amp_state(saved_amp["enabled"], saved_amp["dtype"],
                                saved_amp["level"])


@pytest.fixture(scope="module", params=["llama", "gpt"])
def runs(request):
    """Port plain, port and JAX speculative with the oracle source (built
    from the plain streams) and with ngram."""
    with _pinned_globals():
        return _runs(request.param)


def _runs(kind):
    jm, tm = _pair(kind)
    saved = jrequest._rid_counter, trequest._rid_counter
    jeng = JEngine(jm, page_size=PAGE)
    try:
        def tcore(**kw):
            return EngineCore(PagedGenerationEngine(tm, page_size=PAGE,
                                                    device="cpu"),
                              device="cpu", **SHAPE, **kw)

        def jcore(**kw):
            return JCore(jeng, enable_prefix_cache=False, **SHAPE, **kw)

        out = {"plain": _serve(tcore(), GenerationConfig, trequest)}
        oracle = Oracle(_prompts(), [r.tokens for r in out["plain"][0]])
        for src_name, src in (("oracle", oracle), ("ngram", "ngram")):
            spec = dict(speculate=True, num_draft_tokens=NUM_DRAFT,
                        draft_source=src)
            out[src_name] = _serve(tcore(**spec), GenerationConfig, trequest)
            out["jax_" + src_name] = _serve(jcore(**spec), JGen, jrequest)
    finally:
        jrequest._rid_counter, trequest._rid_counter = saved
    return out


@pytest.mark.parametrize("source", ["oracle", "ngram"])
def test_spec_streams_equal_jax(runs, source):
    treqs, tsnap = runs[source]
    jreqs, jsnap = runs["jax_" + source]
    for t, j in zip(treqs, jreqs):
        assert t.state == RequestState.DONE
        assert t.state.value == j.state.value and t.rid == j.rid
        assert t.tokens == j.tokens, (t.rid, t.tokens, j.tokens)
    assert tsnap["speculation"] == jsnap["speculation"]
    assert tsnap["tokens_generated"] == jsnap["counters"][
        "tokens_generated"]


def test_oracle_drafts_accepted(runs):
    s = runs["oracle"][1]["speculation"]
    assert s["rows"] > 0 and s["drafts_accepted"] > 0
    assert s["drafts_accepted"] <= s["drafts_proposed"]
    assert runs["ngram"][1]["speculation"]["drafts_proposed"] > 0


@pytest.mark.parametrize("source", ["oracle", "ngram"])
def test_spec_greedy_streams_equal_plain(runs, source):
    plain, _ = runs["plain"]
    spec, _ = runs[source]
    for i in GREEDY:
        assert spec[i].tokens == plain[i].tokens
    # every greedy oracle draft is the plain stream itself: all accepted
    if source == "oracle":
        assert all(len(spec[i].tokens) == len(plain[i].tokens)
                   for i in range(len(plain)))


def test_spec_window_and_validation():
    _, tm = _pair("llama")
    eng = PagedGenerationEngine(tm, page_size=PAGE, device="cpu")
    core = EngineCore(eng, device="cpu", speculate=True, num_draft_tokens=40,
                      **SHAPE)
    assert core._spec_window == SHAPE["token_budget"]
    core.close()
    with pytest.raises(ValueError):
        EngineCore(eng, device="cpu", speculate=True, num_draft_tokens=0,
                   **SHAPE)
    with pytest.raises(ValueError, match="enable_prefix_cache"):
        EngineCore(eng, device="cpu", speculate=True,
                   draft_source="prefix_cache", **SHAPE)
