"""Port parity: the compile log (``observability/compilelog.py``).

* The port's ``CompileLog`` and the JAX package's, fed one scripted
  sequence of ``record`` / ``mark_warm`` calls, give equal ``summary()``
  dicts and equal events; ``signature_of`` agrees on numpy arguments and
  ``instrument_first_calls`` records what ``instrument_jit`` records.
* A mixed fuzz of batch compositions — decode, prompt-chunk and inactive
  rows, and speculative verify rows — through the port's ``EngineCore``
  (CPU) and the JAX ``EngineCore`` on the same tiny LLaMA weights: each
  logs exactly one ``serving-decode`` event for its one program key and
  none after warm-up, and the streams are equal token for token.  The
  shapes are this module's own, so no other test's warm marks apply.
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
from paddle_infer_tpu.observability import compilelog as jlog
from paddle_infer_tpu.serving import EngineCore as JCore
from paddle_infer_tpu.serving import request as jrequest
from paddle_infer_tpu_torch.inference.generation import (
    GenerationConfig, PagedGenerationEngine)
from paddle_infer_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_infer_tpu_torch.observability import compilelog as tlog
from paddle_infer_tpu_torch.serving import EngineCore, RequestState
from paddle_infer_tpu_torch.serving import request as trequest
from paddle_infer_tpu_torch.weights import from_jax_state_dict

from _torch_jax_isolation import _private_jax_compile_log  # noqa: F401

TINY = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64, num_key_value_heads=2)
# shapes no other test uses: its program key is this module's alone
SHAPE = dict(max_batch=3, max_model_len=47, token_budget=11,
             prefill_chunk=11)
PAGE = 8

SIG_A = (((2, 4), "float32"), ("S", 3))
SIG_B = (((2, 8), "float32"), ("S", 3))
SCRIPTS = {
    "warm-then-recompile": [
        ("record", "serving-decode", ("serve-step", 3, 16), SIG_A, 0.5),
        ("mark_warm", "serving-decode", ("serve-step", 3, 16)),
        ("record", "serving-decode", ("serve-step", 3, 16), SIG_B, 0.25),
        ("record", "serving-decode", ("serve-step", 3, 16), SIG_A, 0.125),
    ],
    "sites-and-storm": [
        ("record", "dispatch", "add", SIG_A, 0.001),
        ("record", "dispatch", "add", SIG_A, 0.002),
        ("record", "to_static", "f", SIG_B, 0.75),
        ("mark_warm", "train-step", ("train-step",)),
        ("record", "train-step", ("train-step",), SIG_A, 1.5),
    ],
    "warm-without-events": [
        ("mark_warm", "serving-decode", ("serve-step", 8, 512)),
        ("record", "serving-prefill", ("serve-prefill", 8), SIG_B, 0.0625),
    ],
}


def _play(log, script):
    for op, *args in script:
        getattr(log, op)(*args)
    return log


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_summary_and_events_equal_jax(name):
    j = _play(jlog.CompileLog(), SCRIPTS[name])
    t = _play(tlog.CompileLog(), SCRIPTS[name])
    assert t.summary() == j.summary()
    strip = lambda evs: [dict(e.to_dict(), at=None) for e in evs]
    assert strip(t.events()) == strip(j.events())
    for site in ("serving-decode", "dispatch", "train-step", "nowhere"):
        assert t.count(site) == j.count(site)
        assert t.is_warm(site, ("serve-step", 3, 16)) == \
            j.is_warm(site, ("serve-step", 3, 16))
    assert t.recompile_storm == j.recompile_storm
    t.reset()
    j.reset()
    assert t.summary() == j.summary()


def test_signature_of_equals_jax():
    rs = np.random.RandomState(0)
    args = [rs.rand(2, 3).astype(np.float32), None, 7, "s",
            [np.zeros(4, np.int32), (1, 2)],
            {"b": np.ones((1,), np.bool_), "a": 2.5}, {1, 2}]
    assert tlog.signature_of(args) == jlog.signature_of(args)


def test_instrument_first_calls_records_like_instrument_jit():
    calls = [np.zeros((2, 3), np.float32), np.zeros((2, 3), np.float32),
             np.zeros((4, 3), np.float32), np.zeros((2, 3), np.int32)]

    def run(mod):
        log = mod.get_compile_log()
        before = (log.count("probe"), log.recompile_count)
        wrap = getattr(mod, "instrument_jit", None) or \
            mod.instrument_first_calls
        fn = wrap(lambda x: x.sum(), "probe", ("probe-key",))
        outs = [float(fn(x)) for x in calls]
        sigs = [e.signature for e in log.events("probe")][-3:]
        return (log.count("probe") - before[0],
                log.recompile_count - before[1], outs, sigs)

    assert run(tlog) == run(jlog)


# ------------------------------------------------ serving: one per key

@pytest.fixture(scope="module")
def models():
    pit.seed(0)
    jm = JLlama(JConfig(**TINY))
    jm.eval()
    sd = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu")
    from_jax_state_dict(tm, sd)
    return jm, tm


def _waves(G):
    """Three waves of tiled prompts (ngram drafts fire on them): long
    ones prefill in chunks beside decode rows, short budgets free slots
    early (inactive rows), sampled rows ride beside greedy ones."""
    rs = np.random.RandomState(7)

    def prompt(n, m):
        return np.tile(rs.randint(0, 96, (m,)), -(-n // m))[:n].astype(
            np.int32)

    waves = []
    for wave in range(3):
        lens = [(23, 3), (4, 2), (9, 4)] if wave != 1 else [(1, 1), (15, 5)]
        cfgs = [G(max_new_tokens=(2, 9, 5)[i] + wave,
                  do_sample=(i + wave) % 3 == 1, temperature=0.9, top_k=30,
                  seed=wave * 10 + i) for i in range(len(lens))]
        waves.append([(prompt(n, m), g) for (n, m), g in zip(lens, cfgs)])
    return waves


def _run(core, G, rid_mod):
    rid_mod._rid_counter = itertools.count(700)
    reqs = []
    try:
        for wave in _waves(G):
            reqs += [core.submit(p, g)[0] for p, g in wave]
            for _ in range(3):            # the next wave lands mid-run
                core.run_once()
        for _ in range(400):
            if all(r.done for r in reqs):
                break
            core.run_once()
        return reqs
    finally:
        core.close()


@pytest.mark.parametrize("speculate", [False, True],
                         ids=["plain", "speculative"])
def test_fuzz_logs_one_event_per_key_and_streams_equal_jax(models,
                                                           speculate):
    jm, tm = models
    spec = (dict(speculate=True, num_draft_tokens=3, draft_source="ngram")
            if speculate else {})
    logs = {"jax": jlog.get_compile_log(), "port": tlog.get_compile_log()}
    before = {k: (log.count("serving-decode"),
                  log.summary()["post_warmup_decode_compiles"])
              for k, log in logs.items()}
    saved = jrequest._rid_counter, trequest._rid_counter
    try:
        jreqs = _run(JCore(JEngine(jm, page_size=PAGE),
                           enable_prefix_cache=False, **SHAPE, **spec),
                     JGen, jrequest)
        tcore = EngineCore(PagedGenerationEngine(tm, page_size=PAGE,
                                                 device="cpu"),
                           device="cpu", **SHAPE, **spec)
        trace = tcore.step_trace
        treqs = _run(tcore, GenerationConfig, trequest)
    finally:
        jrequest._rid_counter, trequest._rid_counter = saved
    for k, log in logs.items():
        n0, pw0 = before[k]
        assert log.count("serving-decode") - n0 == 1, k
        assert log.summary()["post_warmup_decode_compiles"] - pw0 == 0, k
    key = tlog.get_compile_log().events("serving-decode")[-1].key
    assert key[0] == "serve-step" and (len(key) == 6) == speculate
    for t, j in zip(treqs, jreqs):
        assert t.state == RequestState.DONE and t.rid == j.rid
        assert t.tokens == j.tokens, (t.rid, t.tokens, j.tokens)
    # the fuzz did mix the compositions it claims
    assert any(s["prefill_tokens"] and s["decode_rows"] for s in trace)
    assert any(len(s["active"]) < SHAPE["max_batch"] for s in trace)
    if speculate:
        assert sum(s["draft_tokens"] for s in trace) > 0
