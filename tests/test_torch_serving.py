"""Port parity: the ragged continuous-batching serving path.

The same prompts — one longer than ``token_budget``, so it is prefilled
in chunks across steps — go through the JAX ``EngineCore(ragged=True)``
and the port's ``EngineCore(device="cpu")`` on the same tiny LLaMA
weights, with the request-id counter pinned in both packages (each
request's sampling key is ``fold_in(PRNGKey(seed), rid)``).  Greedy AND
seeded-sampled streams must be equal token for token.

The JAX package's native library, which the JAX engines need, is
loaded under a file lock when ``_torch_jax_isolation`` is imported
(``ensure_jax_native``).
"""
import itertools

import numpy as np
import pytest

import paddle_infer_tpu as pit
from paddle_infer_tpu.inference.generation import \
    GenerationConfig as JGen
from paddle_infer_tpu.inference.generation import \
    PagedGenerationEngine as JEngine
from paddle_infer_tpu.models import LlamaConfig as JConfig
from paddle_infer_tpu.models import LlamaForCausalLM as JLlama
from paddle_infer_tpu.serving import EngineCore as JCore
from paddle_infer_tpu.serving import request as jrequest
from paddle_infer_tpu_torch import native
from paddle_infer_tpu_torch.inference.generation import (
    GenerationConfig, PagedGenerationEngine)
from paddle_infer_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_infer_tpu_torch.serving import (DeadlineExceededError,
                                            EngineCore, RejectedError,
                                            RequestState)
from paddle_infer_tpu_torch.serving import request as trequest
from paddle_infer_tpu_torch.serving.resilience import FaultPlane, FaultSpec
from paddle_infer_tpu_torch.weights import from_jax_state_dict

from _torch_jax_isolation import _private_jax_compile_log  # noqa: F401


TINY = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64, num_key_value_heads=2)
SHAPE = dict(max_batch=3, max_model_len=48, token_budget=16,
             prefill_chunk=16)
PAGE = 8


@pytest.fixture(scope="module", autouse=True)
def _meshless():
    from paddle_infer_tpu.parallel import topology

    prev = topology.get_current_mesh()
    topology.set_current_mesh(None)
    yield
    topology.set_current_mesh(prev)


@pytest.fixture(scope="module")
def models():
    pit.seed(0)
    jm = JLlama(JConfig(**TINY))
    jm.eval()
    sd = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu")
    from_jax_state_dict(tm, sd)
    return jm, tm


def _prompts():
    rs = np.random.RandomState(0)
    return [rs.randint(0, 96, (n,)).astype(np.int32)
            for n in (20, 5, 9, 1, 13)]


def _cfgs(G):
    return [G(max_new_tokens=6),
            G(max_new_tokens=5, do_sample=True, temperature=0.8, top_k=20,
              top_p=0.9, seed=3),
            G(max_new_tokens=7, do_sample=True, seed=11),
            G(max_new_tokens=4),
            G(max_new_tokens=6, do_sample=True, temperature=1.3, top_p=0.7,
              seed=5, eos_token_id=17)]


def _drive(core, reqs, max_iters=400):
    for _ in range(max_iters):
        if all(r.done for r in reqs):
            return
        core.run_once()
    raise AssertionError("requests did not finish")


@pytest.fixture(scope="module")
def streams(models):
    jm, tm = models
    saved = jrequest._rid_counter, trequest._rid_counter
    jrequest._rid_counter = itertools.count(100)
    trequest._rid_counter = itertools.count(100)
    jcore = JCore(JEngine(jm, page_size=PAGE), **SHAPE)
    tcore = EngineCore(PagedGenerationEngine(tm, page_size=PAGE,
                                             device="cpu"),
                       device="cpu", **SHAPE)
    try:
        jreqs = [jcore.submit(p, g)[0]
                 for p, g in zip(_prompts(), _cfgs(JGen))]
        _drive(jcore, jreqs)
        treqs = [tcore.submit(p, g)[0]
                 for p, g in zip(_prompts(), _cfgs(GenerationConfig))]
        _drive(tcore, treqs)
        snap = tcore.metrics_snapshot()
        trace = list(tcore.step_trace)
    finally:
        jcore.close()
        tcore.close()
        jrequest._rid_counter, trequest._rid_counter = saved
    return jreqs, treqs, snap, trace


@pytest.mark.parametrize("i", range(5))
def test_streams_equal_jax(streams, i):
    jreqs, treqs, _, _ = streams
    assert treqs[i].state == RequestState.DONE
    assert jreqs[i].state.value == treqs[i].state.value
    assert treqs[i].rid == jreqs[i].rid
    assert treqs[i].tokens == jreqs[i].tokens


def test_long_prompt_was_chunked(streams):
    """The 20-token prompt exceeds token_budget=16: its first step
    prefilled only part of it."""
    _, _, _, trace = streams
    assert trace[0]["prefill_tokens"] == SHAPE["token_budget"]
    assert len(trace) > 7


def test_metrics_counted(streams):
    _, treqs, snap, _ = streams
    assert snap["submitted"] == snap["completed"] == len(treqs)
    assert snap["tokens_generated"] == sum(len(r.tokens) for r in treqs)
    assert snap["ttft_s"]["count"] == len(treqs)
    # every finished row freed its pages: only the scratch page is held
    assert snap["kv_pool"]["used_blocks"] == 1


@pytest.mark.parametrize("knob", [
    dict(ragged=False),
    dict(adapter_store=object()), dict(grammar_vocab=["a"]),
    dict(serving_mesh=object()), dict(kv_host_pages=4),
    dict(sched_policy="slack"),
    # the host KV tier's fault sites: a plane that scripts them
    dict(fault_plane=FaultPlane([FaultSpec("kv.swap_out", at=1)]))])
def test_unported_knobs_raise(models, knob):
    _, tm = models
    eng = PagedGenerationEngine(tm, page_size=PAGE, device="cpu")
    with pytest.raises(NotImplementedError):
        EngineCore(eng, device="cpu", **SHAPE, **knob)


def test_entry_points_default_to_the_card(models):
    _, tm = models
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedGenerationEngine(tm, page_size=PAGE)
    eng = PagedGenerationEngine(tm, page_size=PAGE, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        EngineCore(eng, **SHAPE)


def test_rejects_oversized_and_unbatchable(models):
    _, tm = models
    core = EngineCore(PagedGenerationEngine(tm, page_size=PAGE,
                                            device="cpu"),
                      device="cpu", **SHAPE)
    try:
        with pytest.raises(RejectedError):
            core.submit(np.zeros(45, np.int32),
                        GenerationConfig(max_new_tokens=8))
        with pytest.raises(RejectedError):
            core.submit(np.zeros(4, np.int32), GenerationConfig(num_beams=2))
        assert core.metrics.rejected == 2
    finally:
        core.close()


def test_deadlines_cancel_queued_and_active_rows(models):
    _, tm = models
    core = EngineCore(PagedGenerationEngine(tm, page_size=PAGE,
                                            device="cpu"),
                      device="cpu", **SHAPE)
    try:
        queued = core.submit(np.arange(5, dtype=np.int32),
                             GenerationConfig(max_new_tokens=4),
                             timeout_s=-1.0)[0]
        active = core.submit(np.arange(30, dtype=np.int32),
                             GenerationConfig(max_new_tokens=4),
                             timeout_s=60.0)[0]
        core.run_once()             # admits + one chunk of the 30 tokens
        assert queued.state == RequestState.CANCELLED
        assert active.state == RequestState.ACTIVE
        active.deadline = 0.0       # expire it mid-prefill
        core.run_once()
        assert active.state == RequestState.CANCELLED
        with pytest.raises(DeadlineExceededError):
            active.result(timeout=1)
        assert core.metrics.cancelled_deadline == 2
        assert core.active_count == 0
    finally:
        core.close()


def test_background_loop_serves(models):
    _, tm = models
    core = EngineCore(PagedGenerationEngine(tm, page_size=PAGE,
                                            device="cpu"),
                      device="cpu", **SHAPE).start()
    try:
        req = core.submit(np.arange(9, dtype=np.int32),
                          GenerationConfig(max_new_tokens=3))[0]
        assert len(req.result(timeout=60)) == 3
        assert core.stop(timeout=10)
    finally:
        core.close()


def test_native_pool_tables_match_jax_pool():
    """Same allocator source, same call sequence → same page tables."""
    from paddle_infer_tpu import native as jnative

    a, b = native.KVBlockPool(12, 4), jnative.KVBlockPool(12, 4)
    for pool in (a, b):
        pool.reserve(0, 9)
        pool.reserve(1, 4)
        pool.free(0)
        pool.reserve(2, 13)
        pool.reserve(1, 6)
    for sid in (0, 1, 2):
        np.testing.assert_array_equal(a.block_table(sid),
                                      b.block_table(sid))
        assert a.length(sid) == b.length(sid)
    assert a.free_blocks == b.free_blocks
    # copy-on-write fork: the child shares the parent's blocks until its
    # last (shared) block is privatized
    assert a.fork(2, 5) == b.fork(2, 5)
    assert a.cow_last_block(5) == b.cow_last_block(5)
    assert a.cow_last_block(5) is None
    np.testing.assert_array_equal(a.block_table(5), b.block_table(5))
    with pytest.raises(MemoryError):
        a.reserve(3, 100)
