"""Port parity: sharded serving (``paddle_infer_tpu_torch/serving/sharded/``,
the mesh-aware layers, the head-sharded pools and ``EngineCore(serving_mesh=)``)
against the JAX package.

The reference's tiny GPT (``tests/test_sharded_serving.py``: vocab 96,
hidden 32, 2 layers, 4 heads), a tiny LLaMA with GQA (4 query heads
over 2 key / value heads) and the tiny GPT-MoE (4 experts) on both
packages, weights carried over by ``from_jax_state_dict``, the core
shape of the reference's tests (``max_batch`` 4, ``token_budget`` 16),
both rid counters pinned.  The JAX side serves over conftest's forced
host devices; the port's meshes take ``[cpu] * n``.

* the config matrix (``validate_serving_config``, the core's
  re-validation and its meshless-engine and quantized-mismatch errors)
  refused on both sides;
* streams of the single, mp=2, mp=2 x dp=2 and quantized mp=2 cores
  (greedy and seeded-sampled rows in one batch) EQUAL to the JAX core's
  on the same mesh; after the same run the collective ledger, every
  step record's ``ici_bytes_est`` / ``ici_bytes_saved_est``, the
  ``sharding`` section and its Prometheus lines EQUAL;
* ep=2 (and ep=2 x mp=2) on the 4-expert model: streams and each step's
  routed / dropped counts EQUAL to JAX's;
* within the port, bitwise against the single-device core: a chunked
  long prompt, warm prefix hits, ngram speculation, a supervisor replay
  after a fault that loses the pools, weight-only layers on the mesh,
  ``generate`` on the paged and dense engines; no capture or first call
  once warm; the ragged attention launched once per shard and layer;
* the head-sharded pools' shapes and devices (fp32 and int8 with their
  ``[P, H/mp]`` scale rows), the shard report, the once-logged
  placement fallback; the server's mesh flags on the CPU.

Logits: the mp=2 core's first-step logits within 2e-5 of the single
core's at fp32 (ROADMAP's bar).
"""
import itertools
import json
import logging

import numpy as np
import pytest
import torch

import paddle_infer_tpu as pit
from paddle_infer_tpu.inference.generation import \
    GenerationConfig as JGen
from paddle_infer_tpu.inference.generation import \
    PagedGenerationEngine as JEngine
from paddle_infer_tpu.models import GPTConfig as JGPTConfig
from paddle_infer_tpu.models import GPTForCausalLM as JGPT
from paddle_infer_tpu.models import GPTMoEForCausalLM as JGPTMoE
from paddle_infer_tpu.models import LlamaConfig as JLlamaConfig
from paddle_infer_tpu.models import LlamaForCausalLM as JLlama
from paddle_infer_tpu.models import MoEConfig as JMoEConfig
from paddle_infer_tpu.observability.prometheus import \
    render_prometheus as j_render
from paddle_infer_tpu.parallel import collective as jcol
from paddle_infer_tpu.serving import EngineCore as JCore
from paddle_infer_tpu.serving import ServingMesh as JMesh
from paddle_infer_tpu.serving import ShardedConfigError as JShardedError
from paddle_infer_tpu.serving import build_sharded_engine as j_build
from paddle_infer_tpu.serving import request as jrequest
from paddle_infer_tpu.serving import \
    validate_serving_config as j_validate
from paddle_infer_tpu_torch.inference.generation import (
    GenerationConfig, GenerationEngine, PagedGenerationEngine,
    serving_param_spec)
from paddle_infer_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                           GPTMoEForCausalLM, LlamaConfig,
                                           LlamaForCausalLM, MoEConfig)
from paddle_infer_tpu_torch.observability import (render_prometheus,
                                                  validate_exposition)
from paddle_infer_tpu_torch.observability.compilelog import get_compile_log
from paddle_infer_tpu_torch.ops import ragged_paged_attention as RPA
from paddle_infer_tpu_torch.parallel import collective as tcol
from paddle_infer_tpu_torch.parallel import topology as ttopo
from paddle_infer_tpu_torch.quantization import quantize_model
from paddle_infer_tpu_torch.serving import (EngineCore, EngineSupervisor,
                                            FaultPlane, FaultSpec,
                                            RequestState, ServingMesh,
                                            ShardedConfigError,
                                            build_sharded_engine,
                                            validate_serving_config)
from paddle_infer_tpu_torch.serving import request as trequest
from paddle_infer_tpu_torch.weights import from_jax_state_dict

from _torch_jax_isolation import _private_jax_compile_log  # noqa: F401
from test_torch_speculation import _pinned_globals

TOL = dict(rtol=2e-5, atol=2e-5)
PAGE = 8
CORE_SHAPE = dict(max_batch=4, max_model_len=48, token_budget=16,
                  prefill_chunk=16)
GPT_DIMS = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=64,
                max_position_embeddings=64, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)
LLAMA_DIMS = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2,
                  intermediate_size=64, max_position_embeddings=64)
MESHES = {"single": {}, "mp2": dict(mp=2), "dp2": dict(dp_replicas=2),
          "mp2dp2": dict(mp=2, dp_replicas=2),
          "mp2q": dict(mp=2, quantized_allreduce="int8")}


@pytest.fixture(scope="module", autouse=True)
def _clean_topology():
    """The JAX mesh and wire format are trace-time globals; leak either
    and later modules' executables change."""
    from paddle_infer_tpu.parallel import topology

    prev = topology.get_current_mesh(), topology.get_quantized_allreduce()
    topology.set_current_mesh(None)
    topology.set_quantized_allreduce(None)
    yield
    topology.set_current_mesh(prev[0])
    topology.set_quantized_allreduce(prev[1])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def _rid_counters():
    saved = jrequest._rid_counter, trequest._rid_counter
    yield
    jrequest._rid_counter, trequest._rid_counter = saved


def _jax_model(kind):
    pit.seed(0)
    if kind == "gpt":
        m = JGPT(JGPTConfig(**GPT_DIMS))
    elif kind == "llama":
        m = JLlama(JLlamaConfig(**LLAMA_DIMS))
    else:
        m = JGPTMoE(JMoEConfig(num_experts=4, **GPT_DIMS))
    m.eval()
    return m


def _port_model(kind, state):
    if kind == "gpt":
        m = GPTForCausalLM(GPTConfig(**GPT_DIMS), device="cpu")
    elif kind == "llama":
        m = LlamaForCausalLM(LlamaConfig(**LLAMA_DIMS), device="cpu")
    else:
        m = GPTMoEForCausalLM(MoEConfig(num_experts=4, **GPT_DIMS),
                              device="cpu")
    from_jax_state_dict(m, state[kind])
    return m


@pytest.fixture(scope="module")
def state():
    with _pinned_globals():
        return {k: {n: np.asarray(v.numpy())
                    for n, v in _jax_model(k).state_dict().items()}
                for k in ("gpt", "llama", "moe")}


def _prompt(seed, n=8):
    return np.random.RandomState(seed).randint(0, 96, (n,)).astype(
        np.int32)


def _mixed_gens(G):
    return [G(max_new_tokens=8),
            G(max_new_tokens=6, do_sample=True, temperature=0.8, top_k=12,
              top_p=0.9, seed=7),
            G(max_new_tokens=7, do_sample=True, top_k=5, seed=3)]


PROMPTS = [_prompt(1, 11), _prompt(2, 21), _prompt(3, 5)]


def _drive(core, reqs, sup=None):
    for _ in range(400):
        if all(r.done for r in reqs):
            return
        (sup or core).run_once()
    raise AssertionError("requests did not finish")


def _serve(side, model, mesh_kw, prompts=PROMPTS, gens=None, rid=7000,
           **kw):
    """One batch through a fresh core on ``side``'s engine over the mesh;
    returns streams, the ledger, the step records' interconnect fields,
    the snapshot and the exposition's sharding lines."""
    jax_side = side == "jax"
    Mesh = JMesh if jax_side else ServingMesh
    cfg = Mesh(**mesh_kw)
    if jax_side:
        eng = j_build(model, cfg, page_size=PAGE)
        eng.program_cost = lambda key: None
        jrequest._rid_counter = itertools.count(rid)
        core_kw = {}
    else:
        eng = build_sharded_engine(model, cfg, page_size=PAGE,
                                   device="cpu")
        trequest._rid_counter = itertools.count(rid)
        core_kw = dict(device="cpu")
    led = jcol.LEDGER if jax_side else tcol.LEDGER
    led.reset()
    for k, v in CORE_SHAPE.items():
        kw.setdefault(k, v)
    Core = JCore if jax_side else EngineCore
    core = Core(eng, serving_mesh=(cfg if cfg.n_devices > 1
                                   or cfg.quantized_allreduce else None),
                **kw, **core_kw)
    try:
        G = JGen if jax_side else GenerationConfig
        gens = gens(G) if callable(gens) else (gens or _mixed_gens(G))
        reqs = [core.submit(p, g)[0] for p, g in zip(prompts, gens)]
        _drive(core, reqs)
        assert all(r.state.name == "DONE" for r in reqs)
        snap = core.metrics_snapshot()
        render = j_render if jax_side else render_prometheus
        text = render(snap, {})
        return {
            "streams": [np.asarray(r.padded_result()) for r in reqs],
            "ledger": led.snapshot(),
            "records": [{k: r.get(k) for k in (
                "kind", "ici_bytes_est", "ici_bytes_saved_est",
                "moe_tokens_routed", "moe_tokens_dropped")}
                for r in core.steplog.records()],
            "snap": snap,
            "lines": sorted(ln for ln in text.splitlines()
                            if ln.startswith(("serving_mesh_info",
                                              "serving_shard_",
                                              "collective_bytes"))),
            "engine": eng,
        }
    finally:
        core.close()


@pytest.fixture(scope="module")
def served(state):
    """Each (model, mesh) run once per side, on demand."""
    cache = {}

    def get(kind, mesh, side):
        key = (kind, mesh, side)
        if key not in cache:
            with _pinned_globals():
                model = (_jax_model(kind) if side == "jax"
                         else _port_model(kind, state))
                cache[key] = _serve(side, model, MESHES[mesh])
        return cache[key]

    return get


# ------------------------------------------------------------ config

CONFIG_CASES = [
    (dict(mp=0), {}),
    (dict(mp=2, quantized_allreduce="fp8"), {}),
    (dict(mp=1, quantized_allreduce="int8"), {}),
    (dict(mp=2, quantized_allreduce="int8"), dict(speculate=True)),
    (dict(mp=2, quantized_allreduce="int8"),
     dict(enable_prefix_cache=True)),
    (dict(mp=2), dict(num_heads=3)),
    (dict(dp_replicas=2), dict(max_batch=3)),
    (dict(mp=4, dp_replicas=4), dict(available_devices=8)),
    (dict(ep=2), {}),
    (dict(ep=3), dict(num_experts=4)),
]


@pytest.mark.parametrize("kw,flags", CONFIG_CASES)
def test_invalid_combos_rejected_as_the_reference(kw, flags):
    with pytest.raises(JShardedError):
        j_validate(JMesh(**kw), **flags)
    with pytest.raises(ShardedConfigError):
        validate_serving_config(ServingMesh(**kw), **flags)


def test_valid_config_is_silent_and_described():
    validate_serving_config(ServingMesh(mp=2, dp_replicas=2), max_batch=4,
                            num_heads=4, available_devices=8)
    validate_serving_config(ServingMesh(ep=2), num_experts=4)
    for kw in (dict(mp=2, dp_replicas=2, quantized_allreduce="int8"),
               dict(ep=2), {}):
        assert ServingMesh(**kw).describe() == JMesh(**kw).describe()
        assert ServingMesh(**kw).n_devices == JMesh(**kw).n_devices


def test_single_device_build_has_no_mesh(state):
    eng = build_sharded_engine(_port_model("gpt", state), ServingMesh(),
                               page_size=PAGE, device="cpu")
    assert eng._mesh is None and eng.shard_report() is None


def test_core_rejects_mesh_config_on_meshless_engine(state):
    eng = PagedGenerationEngine(_port_model("gpt", state), page_size=PAGE,
                                device="cpu")
    with pytest.raises(ShardedConfigError, match="no mesh"):
        EngineCore(eng, serving_mesh=ServingMesh(mp=2), device="cpu",
                   **CORE_SHAPE)


def test_core_rejects_quantized_mismatch(state):
    eng = build_sharded_engine(_port_model("gpt", state),
                               ServingMesh(mp=2), page_size=PAGE,
                               device="cpu")
    with pytest.raises(ShardedConfigError, match="disagrees"):
        EngineCore(eng, serving_mesh=ServingMesh(
            mp=2, quantized_allreduce="int8"), device="cpu", **CORE_SHAPE)


def test_core_rejects_quant_engine_with_speculation(state):
    eng = build_sharded_engine(
        _port_model("gpt", state),
        ServingMesh(mp=2, quantized_allreduce="int8"), page_size=PAGE,
        device="cpu")
    for kw in (dict(speculate=True), dict(enable_prefix_cache=True)):
        with pytest.raises(ShardedConfigError):
            EngineCore(eng, device="cpu", **kw, **CORE_SHAPE)


def test_core_rejects_ep_mesh_over_dense_model(state):
    eng = build_sharded_engine(_port_model("gpt", state),
                               ServingMesh(mp=2), page_size=PAGE,
                               device="cpu")
    with pytest.raises(ShardedConfigError, match="needs a MoE model"):
        EngineCore(eng, serving_mesh=ServingMesh(mp=2, ep=2),
                   device="cpu", **CORE_SHAPE)


# ------------------------------------------------------------ parity

PAIRS = [(k, m) for k in ("gpt", "llama") for m in MESHES]


@pytest.mark.parametrize("kind,mesh", PAIRS)
def test_streams_equal_jax_core(served, kind, mesh):
    """Row 0 is greedy, rows 1-2 seeded-sampled.  Under the quantized
    all-reduce only the greedy row is held to JAX's: the step's pad
    slots enter the int8 blocks' scales, and their attention outputs are
    zeros in the port and garbage in the JAX package, so quantized
    logits differ within the wire's error bound and a seeded draw near a
    boundary can flip (``test_quantized_generate_equals_jax`` holds the
    sampled streams EQUAL where no pad slot exists)."""
    want = served(kind, mesh, "jax")["streams"]
    got = served(kind, mesh, "port")["streams"]
    held = [0] if mesh == "mp2q" else range(len(want))
    for i in held:
        np.testing.assert_array_equal(got[i], want[i])


@pytest.mark.parametrize("kind,mesh", PAIRS)
def test_ledger_and_step_records_equal_jax_core(served, kind, mesh):
    j, t = served(kind, mesh, "jax"), served(kind, mesh, "port")
    assert t["ledger"] == j["ledger"]
    assert [r["ici_bytes_est"] for r in t["records"]] == \
        [r["ici_bytes_est"] for r in j["records"]]
    assert [r["ici_bytes_saved_est"] for r in t["records"]] == \
        [r["ici_bytes_saved_est"] for r in j["records"]]
    for key in ("ici_bytes_est_total", "ici_bytes_saved_total"):
        assert t["snap"]["steplog"][key] == j["snap"]["steplog"][key]
    if mesh == "mp2q":
        assert t["ledger"]["bytes_saved_total"] > 0
        assert t["ledger"]["by_op_dtype"]["mp_allreduce"]["int8"] > 0
    elif MESHES[mesh].get("mp", 1) > 1:
        assert t["ledger"]["bytes_saved_total"] == 0
        assert t["ledger"]["bytes_total"] > 0


@pytest.mark.parametrize("kind,mesh", PAIRS)
def test_sharding_section_and_exposition_equal_jax_core(served, kind,
                                                       mesh):
    j, t = served(kind, mesh, "jax"), served(kind, mesh, "port")
    assert t["snap"].get("sharding") == j["snap"].get("sharding")
    assert t["lines"] == j["lines"]
    if mesh != "single":
        text = render_prometheus(t["snap"], {})
        assert validate_exposition(text) == []
        want = MESHES[mesh]
        mp, dp = want.get("mp", 1), want.get("dp_replicas", 1)
        info = ('serving_mesh_info{devices="%d",dp="%d",ep="1",mp="%d",'
                'quantized_allreduce="%s"}' % (
                    mp * dp, dp, mp,
                    want.get("quantized_allreduce") or "off"))
        assert info in text


def test_first_step_logits_within_fp32_bar(state):
    """One mixed step's logits: mp=2 and mp=2 x dp=2 against the single
    device at 2e-5 (the partial sums add in another order)."""
    captured = {}

    def run(mesh_kw):
        model = _port_model("gpt", state)
        orig = model.forward

        def spy(*a, **k):
            out = orig(*a, **k)
            captured.setdefault(str(mesh_kw), out[0].detach().clone())
            return out

        model.forward = spy
        _serve("port", model, mesh_kw, prompts=PROMPTS[:2],
               gens=lambda G: [G(max_new_tokens=2)] * 2)
        return captured[str(mesh_kw)]

    base = run({})
    for kw in (dict(mp=2), dict(mp=2, dp_replicas=2)):
        np.testing.assert_allclose(run(kw).numpy(), base.numpy(), **TOL)


def test_ep2_streams_and_routing_equal_jax_core(state):
    with _pinned_globals():
        for kw in (dict(ep=2), dict(ep=2, mp=2)):
            j = _serve("jax", _jax_model("moe"), kw)
            t = _serve("port", _port_model("moe", state), kw)
            for w, g in zip(j["streams"], t["streams"]):
                np.testing.assert_array_equal(g, w)
            for field in ("moe_tokens_routed", "moe_tokens_dropped",
                          "ici_bytes_est"):
                assert [r[field] for r in t["records"]] == \
                    [r[field] for r in j["records"]]
            assert t["ledger"] == j["ledger"]
            assert t["ledger"]["by_op_dtype"]["ep_alltoall"]
            assert t["snap"]["moe"]["ep"] == 2
            assert t["snap"]["sharding"]["mesh_axes"] == \
                j["snap"]["sharding"]["mesh_axes"]


def test_ep2_experts_split_per_shard(state):
    eng = build_sharded_engine(_port_model("moe", state),
                               ServingMesh(ep=2), page_size=PAGE,
                               device="cpu")
    pl = eng._placement
    layer = eng._model.gpt.layers[0].mlp
    parts = pl.ep_parts(layer.w1)
    assert [tuple(p.shape) for p in parts] == [(2, 32, 64)] * 2
    assert torch.equal(torch.cat(parts), layer.w1)
    # ep alone leaves the dense layers whole and the pools unsplit
    assert pl.get(eng._model.gpt.layers[0].self_attn.qkv_proj) is None


# ------------------------------------------- port schedules at mp=2

def _port_pair(state, kind="gpt"):
    single = build_sharded_engine(_port_model(kind, state), ServingMesh(),
                                  page_size=PAGE, device="cpu")
    mp2 = build_sharded_engine(_port_model(kind, state), ServingMesh(mp=2),
                               page_size=PAGE, device="cpu")
    return single, mp2


def _tserve(engine, prompts, gens, rid, mesh_kw=None, **kw):
    trequest._rid_counter = itertools.count(rid)
    for k, v in CORE_SHAPE.items():
        kw.setdefault(k, v)
    cfg = ServingMesh(**mesh_kw) if mesh_kw else None
    core = EngineCore(engine, serving_mesh=cfg, device="cpu", **kw)
    try:
        reqs = [core.submit(p, g)[0] for p, g in zip(prompts, gens)]
        _drive(core, reqs)
        return [np.asarray(r.padded_result()) for r in reqs]
    finally:
        core.close()


def test_chunked_long_prompt_equals_single(state):
    single, mp2 = _port_pair(state)
    ids, g = [_prompt(7, 40)], [GenerationConfig(max_new_tokens=8)]
    want = _tserve(single, ids, g, 7200)
    got = _tserve(mp2, ids, g, 7200, dict(mp=2))
    np.testing.assert_array_equal(got[0], want[0])


def test_warm_prefix_hits_equal_single(state):
    single, mp2 = _port_pair(state)
    base = _prompt(8, 24)
    tail = np.concatenate([base[:16], _prompt(9, 6)])
    g = GenerationConfig(max_new_tokens=6)

    def run(engine, mesh_kw):
        trequest._rid_counter = itertools.count(7300)
        core = EngineCore(engine, enable_prefix_cache=True, device="cpu",
                          serving_mesh=(ServingMesh(**mesh_kw)
                                        if mesh_kw else None),
                          **CORE_SHAPE)
        try:
            outs = []
            for ids in (base, base, tail):        # cold, full, partial
                (r,) = core.submit(ids, g)
                _drive(core, [r])
                outs.append(np.asarray(r.padded_result()))
            assert core.prefix_cache.stats_snapshot()["hits"] >= 2
            return outs
        finally:
            core.close()

    for w, o in zip(run(single, None), run(mp2, dict(mp=2))):
        np.testing.assert_array_equal(o, w)


def test_speculative_equals_plain_single(state):
    single, mp2 = _port_pair(state)
    prompts = [_prompt(10, 12), _prompt(11, 9)]
    gens = [GenerationConfig(max_new_tokens=10),
            GenerationConfig(max_new_tokens=8)]
    want = _tserve(single, prompts, gens, 7400)
    got = _tserve(mp2, prompts, gens, 7400, dict(mp=2), speculate=True,
                  num_draft_tokens=3, draft_source="ngram")
    for w, o in zip(want, got):
        np.testing.assert_array_equal(o, w)


def test_supervisor_replay_equals_single(state):
    single, mp2 = _port_pair(state)
    ids, g = _prompt(12, 10), GenerationConfig(max_new_tokens=12)
    (want,) = _tserve(single, [ids], [g], 7500)
    trequest._rid_counter = itertools.count(7500)
    plane = FaultPlane([FaultSpec("decode.step", at=4, lose_kv=True)])
    core = EngineCore(mp2, fault_plane=plane, device="cpu",
                      serving_mesh=ServingMesh(mp=2), **CORE_SHAPE)
    sup = EngineSupervisor(core, backoff_base_s=0.0)
    try:
        (req,) = core.submit(ids, g)
        _drive(core, [req], sup)
        assert req.state is RequestState.DONE and req.retries == 1
        np.testing.assert_array_equal(req.padded_result(), want)
    finally:
        sup.close()


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_parked_rows_on_mesh_equal_unparked(state, kv_dtype):
    """The host KV tier over head-sharded pools: a row parked mid-decode
    (every mp shard's pages gathered to the host) and resumed (scattered
    back in place) streams EQUAL to the unparked mp=2 run, fp32 and int8
    pools."""
    eng = build_sharded_engine(_port_model("gpt", state), ServingMesh(mp=2),
                               page_size=PAGE, kv_dtype=kv_dtype,
                               device="cpu")
    prompts = [_prompt(40, 11), _prompt(41, 7)]
    gens = [GenerationConfig(max_new_tokens=10)] * 2

    def run(park_at):
        trequest._rid_counter = itertools.count(8100)
        core = EngineCore(eng, serving_mesh=ServingMesh(mp=2), device="cpu",
                          kv_host_pages=16, kv_park_watermark=0.99,
                          kv_resume_watermark=0.01, **CORE_SHAPE)
        try:
            reqs = [core.submit(p, g)[0] for p, g in zip(prompts, gens)]
            parked = 0
            for step in range(1, 400):
                if all(r.done for r in reqs):
                    break
                core.run_once()
                if step == park_at:
                    parked += bool(core.park_for_pressure())
            snap = core.metrics_snapshot()["kv_tier"]
            return [list(r.tokens) for r in reqs], parked, snap
        finally:
            core.close()

    want, _, _ = run(None)
    got, parked, tier = run(3)
    assert parked == 1 and tier["resumes_total"] == 1
    assert got == want


def test_handoff_between_mesh_cores_equals_single(state):
    """A row exported from one mp=2 core (its pages gathered from both
    shards' pools) and imported into another continues EQUAL to the
    single-device stream; a packet from a one-device core is refused by
    the pools' geometry."""
    from paddle_infer_tpu_torch.serving import HandoffError

    single, mp2 = _port_pair(state)
    ids, g = _prompt(42, 12), GenerationConfig(max_new_tokens=8)
    (want,) = _tserve(single, [ids], [g], 8200)
    other = build_sharded_engine(_port_model("gpt", state),
                                 ServingMesh(mp=2), page_size=PAGE,
                                 device="cpu")
    trequest._rid_counter = itertools.count(8200)
    src = EngineCore(mp2, serving_mesh=ServingMesh(mp=2), device="cpu",
                     **CORE_SHAPE)
    dst = EngineCore(other, serving_mesh=ServingMesh(mp=2), device="cpu",
                     **CORE_SHAPE)
    one = EngineCore(build_sharded_engine(_port_model("gpt", state),
                                          ServingMesh(), page_size=PAGE,
                                          device="cpu"),
                     device="cpu", **CORE_SHAPE)
    try:
        (req,) = src.submit(ids, g)
        for _ in range(3):
            src.run_once()
        packet = src.export_handoff(req)
        with pytest.raises(HandoffError, match="geometry"):
            one.import_handoff(dict(packet))
        dst.import_handoff(packet)
        _drive(dst, [req])
        np.testing.assert_array_equal(req.padded_result(), want)
    finally:
        for c in (src, dst, one):
            c.close()


def test_no_first_call_once_warm_mp2(state):
    """Batch composition is data on the sharded step too: on a warm core
    a second, differently composed batch adds nothing to the compile
    log."""
    _, mp2 = _port_pair(state)
    trequest._rid_counter = itertools.count(7600)
    core = EngineCore(mp2, serving_mesh=ServingMesh(mp=2), device="cpu",
                      **CORE_SHAPE)
    gens = [GenerationConfig(max_new_tokens=6),
            GenerationConfig(max_new_tokens=7)]
    try:
        reqs = [core.submit(p, g)[0] for p, g in
                zip([_prompt(13), _prompt(14)], gens)]
        _drive(core, reqs)
        before = get_compile_log().count()
        reqs = [core.submit(p, g)[0] for p, g in
                zip([_prompt(15), _prompt(16, 12)], gens)]
        _drive(core, reqs)
        assert get_compile_log().count() == before
    finally:
        core.close()


@pytest.mark.parametrize("mesh,launches", [("mp2", 2), ("mp2dp2", 4)])
def test_ragged_attention_once_per_shard(state, monkeypatch, mesh,
                                         launches):
    """Every layer of every step calls the ragged attention once per
    (replica group, mp shard), each over its shard's heads and its
    group's rows."""
    calls = []
    orig = RPA.ragged_paged_attention

    def spy(q, k_pages, *a, **k):
        calls.append((tuple(q.shape), tuple(k_pages.shape)))
        return orig(q, k_pages, *a, **k)

    monkeypatch.setattr(RPA, "ragged_paged_attention", spy)
    eng = build_sharded_engine(_port_model("gpt", state),
                               ServingMesh(**MESHES[mesh]),
                               page_size=PAGE, device="cpu")
    trequest._rid_counter = itertools.count(7800)
    core = EngineCore(eng, serving_mesh=ServingMesh(**MESHES[mesh]),
                      device="cpu", **CORE_SHAPE)
    try:
        core.submit(_prompt(17), GenerationConfig(max_new_tokens=1))
        calls.clear()
        core.run_once()
    finally:
        core.close()
    rows = CORE_SHAPE["max_batch"] // (launches // 2)
    assert len(calls) == launches * GPT_DIMS["num_hidden_layers"]
    assert set(calls) == {((rows, 16, 2, 8), (eng._pool.num_blocks, 2,
                                              PAGE, 8))}


@pytest.mark.parametrize("algo", ["weight_only_int8", "weight_only_int4"])
def test_weight_only_layers_on_mesh_equal_single(state, algo):
    def engine(mesh_kw):
        m = _port_model("gpt", state)
        quantize_model(m, algo=algo)
        return build_sharded_engine(m, ServingMesh(**mesh_kw),
                                    page_size=PAGE, device="cpu")

    gens = [GenerationConfig(max_new_tokens=8),
            GenerationConfig(max_new_tokens=6)]
    prompts = PROMPTS[:2]
    want = _tserve(engine({}), prompts, gens, 7900)
    mp2 = engine(dict(mp=2))
    got = _tserve(mp2, prompts, gens, 7900, dict(mp=2))
    for w, o in zip(want, got):
        np.testing.assert_array_equal(o, w)
    assert mp2.shard_report()["sharded_params"] > 0
    qkv = mp2._placement.get(mp2._model.gpt.layers[0].self_attn.qkv_proj)
    assert qkv.n == 2 and qkv.parts[0][0].dtype == torch.int8


def test_gqa_with_fewer_kv_heads_than_shards_equals_single(state):
    """One key / value head under two mp shards: each shard reads the
    K/V head its query heads need (``kv_index``), streams EQUAL to one
    device."""
    dims = dict(LLAMA_DIMS, num_key_value_heads=1)

    def engine(mesh_kw):
        torch.manual_seed(3)
        return build_sharded_engine(
            LlamaForCausalLM(LlamaConfig(**dims), device="cpu", seed=3),
            ServingMesh(**mesh_kw), page_size=PAGE, device="cpu")

    gens = [GenerationConfig(max_new_tokens=8),
            GenerationConfig(max_new_tokens=6, do_sample=True, seed=4)]
    want = _tserve(engine({}), PROMPTS[:2], gens, 8300)
    mp2 = engine(dict(mp=2))
    heads = mp2._placement.get(mp2._model.llama.layers[0].self_attn
                               .qkv_proj).heads
    assert [(h, kv) for h, kv, _ in heads] == [(2, 1), (2, 1)]
    got = _tserve(mp2, PROMPTS[:2], gens, 8300, dict(mp=2))
    for w, o in zip(want, got):
        np.testing.assert_array_equal(o, w)


def test_paged_generate_on_mesh_equals_jax(state):
    """``generate`` (prefill through ``sdpa`` per shard, decode through
    the decode kernel per shard) at mp=2: greedy and sampled EQUAL to
    the JAX engine on the same mesh."""
    import jax

    ids = np.stack([_prompt(20, 9), _prompt(21, 9)])
    with _pinned_globals():
        jm = _jax_model("llama")
        jeng = JEngine(jm, page_size=PAGE, mesh=JMesh(mp=2).build(
            jax.devices()[:2]))
        mesh = ttopo.create_hybrid_mesh(mp=2, devices=["cpu"] * 2)
        teng = PagedGenerationEngine(_port_model("llama", state),
                                     page_size=PAGE, mesh=mesh,
                                     device="cpu")
        for kw in (dict(), dict(do_sample=True, top_k=8, seed=5)):
            want = jeng.generate(ids, JGen(max_new_tokens=6, **kw))
            got = teng.generate(ids, GenerationConfig(max_new_tokens=6,
                                                      **kw))
            np.testing.assert_array_equal(got, want)


def test_quantized_generate_equals_jax(state):
    """``generate`` under ``quantized_allreduce="int8"`` at mp=2 on
    full-bucket prompts (no pad position enters a block): greedy and
    seeded-sampled EQUAL to the JAX engine's."""
    import jax

    ids = np.random.RandomState(5).randint(0, 96, (4, 16)).astype(np.int32)
    with _pinned_globals():
        jeng = JEngine(_jax_model("llama"), page_size=PAGE, prompt_bucket=16,
                       mesh=JMesh(mp=2).build(jax.devices()[:2]),
                       quantized_allreduce="int8")
        teng = PagedGenerationEngine(
            _port_model("llama", state), page_size=PAGE, prompt_bucket=16,
            mesh=ttopo.create_hybrid_mesh(mp=2, devices=["cpu"] * 2),
            quantized_allreduce="int8", device="cpu")
        for kw in (dict(), dict(do_sample=True, top_k=20, seed=0),
                   dict(do_sample=True, temperature=0.7, seed=3)):
            want = jeng.generate(ids, JGen(max_new_tokens=8, **kw))
            got = teng.generate(ids, GenerationConfig(max_new_tokens=8,
                                                      **kw))
            np.testing.assert_array_equal(got, want)


def test_dense_generate_on_mesh_equals_single(state):
    ids = np.stack([_prompt(22, 7), _prompt(23, 7)])
    g = GenerationConfig(max_new_tokens=5)
    want = GenerationEngine(_port_model("llama", state),
                            device="cpu").generate(ids, g)
    mesh = ttopo.create_hybrid_mesh(mp=2, dp=2, devices=["cpu"] * 4)
    eng = GenerationEngine(_port_model("llama", state), mesh=mesh,
                           device="cpu")
    np.testing.assert_array_equal(eng.generate(ids, g), want)
    beams = GenerationConfig(max_new_tokens=4, num_beams=2)
    np.testing.assert_array_equal(
        eng.generate(ids, beams),
        GenerationEngine(_port_model("llama", state),
                         device="cpu").generate(ids, beams))


# ----------------------------------------- pools, report, fallback

@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_head_sharded_pools(state, kv_dtype):
    eng = build_sharded_engine(_port_model("llama", state),
                               ServingMesh(mp=2), page_size=PAGE,
                               kv_dtype=kv_dtype, device="cpu")
    eng.serving_pool(10)
    k_pages, v_pages = eng._ensure_pages()
    assert len(k_pages) == len(v_pages) == LLAMA_DIMS["num_hidden_layers"]
    for layer in k_pages + v_pages:
        assert isinstance(layer, list) and len(layer) == 2
        for r, shard in enumerate(layer):
            if kv_dtype:
                payload, scales = shard
                assert payload.dtype == torch.int8
                assert tuple(scales.shape) == (10, 2)
            else:
                payload = shard
            assert tuple(payload.shape) == (10, 2, PAGE, 8)
            assert payload.device == eng._mesh.device(mp=r)


def test_shard_report_equals_jax(served):
    j = served("gpt", "mp2", "jax")["engine"].shard_report()
    t = served("gpt", "mp2", "port")["engine"].shard_report()
    assert t == j
    assert t["mesh_axes"] == {"mp": 2} and t["devices"] == 2
    assert 0 < t["sharded_params"] <= t["params_total"]
    assert t["quantized_allreduce"] == ""


def test_param_fallback_logged_once_and_listed(caplog):
    mesh = ServingMesh(mp=2).build(["cpu"] * 2)
    arr = torch.zeros(7, 6)                  # mp=2 does not divide 7
    fallback = []
    with caplog.at_level(
            logging.WARNING,
            logger="paddle_infer_tpu_torch.inference.generation"):
        for _ in range(2):
            spec = serving_param_spec(arr, ("mp", None), mesh,
                                      name="odd.weight", fallback=fallback)
    assert spec == (None, None)
    assert len(fallback) == 2                 # every fallback counted
    assert len([r for r in caplog.records
                if "odd.weight" in r.getMessage()]) == 1   # logged once
    assert serving_param_spec(torch.zeros(8, 7), (None, "mp"), mesh) == \
        (None, None)
    assert serving_param_spec(torch.zeros(8, 6), ("mp", None), mesh) == \
        ("mp", None)


# --------------------------------------------------------- the server

def test_server_mesh_flags_on_cpu(tmp_path_factory, state, capsys):
    """``--mp 2 --quantized_allreduce int8`` on the CPU: /generate EQUAL
    to the in-process quantized mp=2 core, the sharding section and the
    mesh info family in /metrics; invalid meshes exit 2."""
    from paddle_infer_tpu_torch.tools import serve
    from test_torch_serve import _get, _post, _spawn, _wait_healthy

    d = str(tmp_path_factory.mktemp("mesh") / "gpt")
    with _pinned_globals():
        _jax_model("gpt").save_pretrained(d)
    flags = ("--max_batch", "4", "--token_budget", "16", "--max_model_len",
             "48", "--mp", "2", "--quantized_allreduce", "int8")
    ids = np.stack([_prompt(30, 8), _prompt(31, 8)])
    url, proc = _spawn(d, *flags)
    try:
        _wait_healthy(url, proc)
        with _post(url, "/generate", {"ids": ids.tolist(),
                                      "max_new_tokens": 5}) as r:
            got = [list(t) for t in json.load(r)["tokens"]]
        with _get(url, "/metrics") as r:
            snap = json.load(r)
        with _get(url, "/metrics", Accept="text/plain") as r:
            text = r.read().decode()
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    eng = build_sharded_engine(
        _port_model("gpt", state),
        ServingMesh(mp=2, quantized_allreduce="int8"), page_size=PAGE,
        device="cpu")
    want = _tserve(eng, list(ids), [GenerationConfig(max_new_tokens=5)] * 2,
                   1, dict(mp=2, quantized_allreduce="int8"))
    assert got == [list(w) for w in want]
    assert snap["sharding"]["mesh_axes"] == {"mp": 2}
    assert snap["sharding"]["quantized_allreduce"] == "int8"
    assert 'serving_mesh_info{devices="2",dp="1",ep="1",mp="2",' \
        'quantized_allreduce="int8"}' in text
    for bad, msg in ((["--mp", "3"], "does not divide"),
                     (["--quantized_allreduce", "int8"], "mp=1"),
                     (["--mp", "2", "--mesh_devices", "cpu"], "needs 2")):
        args = ["--model_dir", d, "--device", "cpu", "--page_size", "8",
                *bad]
        assert serve.main(args) == 2, bad
        err = capsys.readouterr().err
        assert "invalid sharded-serving config" in err and msg in err


# ------------------------------------------------ the smoke's phase

def test_chip_smoke_sharded_phase_on_cpu(monkeypatch):
    """``chip_smoke``'s sharded phase at a tiny size on the CPU (every
    gate but the launch counts and the card-only kernel and
    ``quantized_psum`` timings): mp=2, mp=2 x dp=2 and the int8 wire on
    graphs and eager with their ledgers against the ring model, warm =
    cold and speculative = plain at mp=2, ``generate`` per mesh, LoRA and
    int8 activations at mp=2 against their one-device runs; then the MoE
    phase's serve run and the ep=2 run with its routing EQUAL to ep=1's;
    and the phase argument."""
    import os

    monkeypatch.syspath_prepend(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    for gate in ("_check_decode_launches", "_check_ragged_launches",
                 "_check_verify_launches", "_check_shard_launches",
                 "_check_shard_generate_launches"):
        monkeypatch.setattr(chip_smoke, gate, lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "shard_kernels", lambda d, c: {})
    monkeypatch.setattr(chip_smoke, "shard_psum", lambda d, c: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(chip_smoke, "PREFIX_LEN", 16)
    monkeypatch.setattr(chip_smoke, "PREFIX_SUFFIXES", (5, 1, 3, 8, 2, 6,
                                                        4, 7))
    monkeypatch.setattr(chip_smoke, "MAX_NEW", 6)
    monkeypatch.setattr(chip_smoke, "PRIMER_NEW", 2)
    monkeypatch.setattr(chip_smoke, "SHARD_GEN_LENS", (12, 5))
    monkeypatch.setattr(chip_smoke, "SHARD_GEN_NEW", 4)
    make_core = chip_smoke.make_core
    monkeypatch.setattr(chip_smoke, "make_core", lambda m, d, **kw: make_core(
        m, d, max_model_len=48, token_budget=16, page_size=PAGE, **kw))
    cpu = torch.device("cpu")
    saved = trequest._rid_counter
    try:
        model = LlamaForCausalLM(LlamaConfig(**LLAMA_DIMS), device="cpu")
        runs = chip_smoke.sharded_phase(
            model, cpu, "cpu", prompt_lens=(20, 9, 3, 12, 5, 7, 2, 1),
            max_new=6, spec_lens=(16, 12, 9, 8, 6, 5, 4, 3))
        assert {"mp2", "mp2dp2", "mp2 int8-wire", "prefix warm",
                "spec ngram", "generate mp2", "lora mp2",
                "int8 mp2"} <= set(runs)
        moe = chip_smoke.moe_phase(
            cpu, "cpu", config=MoEConfig(num_experts=4, **GPT_DIMS),
            dtype=torch.float32, prompt_lens=(20, 9, 3, 12, 5, 7, 2, 1),
            max_new=6, only_serve=True,
            ep_run=lambda m, st, p, n: chip_smoke.sharded_ep_run(
                m, cpu, "cpu", st, p, n))
        assert set(moe) == {"serve", "serve eager", "sharded ep2"}
    finally:
        trequest._rid_counter = saved
    assert chip_smoke.main(["nonsense"]) == 2


def test_weights_written_in_place_are_placed_again(state):
    """A placement holds copies of split weights: writing the model's
    weights in place (``from_jax_state_dict``) after the engine placed
    them makes ``refresh_params`` place them again, so the mesh serves
    the new weights, as one device does."""
    gens = [GenerationConfig(max_new_tokens=6)]
    single = build_sharded_engine(_port_model("gpt", state), ServingMesh(),
                                  page_size=PAGE, device="cpu")
    want = _tserve(single, PROMPTS[:1], gens, 8400)
    model = GPTForCausalLM(GPTConfig(**GPT_DIMS), device="cpu", seed=9)
    mp2 = build_sharded_engine(model, ServingMesh(mp=2), page_size=PAGE,
                               device="cpu")
    before = mp2._placement
    from_jax_state_dict(model, state["gpt"])
    mp2.refresh_params()
    assert mp2._placement is not before and not mp2._placement.stale()
    got = _tserve(mp2, PROMPTS[:1], gens, 8400, dict(mp=2))
    np.testing.assert_array_equal(got[0], want[0])
