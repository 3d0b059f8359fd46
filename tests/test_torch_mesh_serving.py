"""Port parity: LoRA adapters and int8-activation layers served on an
mp=2 and an mp=2 x dp=2 mesh (``nn.layers.LinearShards`` over
``LoRAServingLinear`` and ``Int8Linear``) against the JAX package's
sharded engine on its forced host devices.

The tiny GPT of ``tests/test_torch_adapters.py`` (vocab 96, hidden 32,
2 layers, 4 heads) on both packages, the same adapters and store, the
same PTQ calibration for the int8 model; both rid counters pinned.
Streams (greedy and seeded-sampled rows with and without adapters in
one batch) EQUAL to the JAX core's on the same mesh and to the port's
single-device core; the layers are sliced per shard (the LoRA base
keeps no shards of its own); an upload after warm-up writes the pools
the shards read and makes no new capture or first call.
"""
import itertools

import numpy as np
import pytest
import torch

import paddle_infer_tpu as pit
from paddle_infer_tpu.core.tensor import Tensor as JT
from paddle_infer_tpu.inference.generation import GenerationConfig as JGen
from paddle_infer_tpu.models import GPTConfig as JGPTConfig
from paddle_infer_tpu.models import GPTForCausalLM as JGPT
from paddle_infer_tpu import quantization as jq
from paddle_infer_tpu.serving import AdapterStore as JStore
from paddle_infer_tpu.serving import EngineCore as JCore
from paddle_infer_tpu.serving import ServingMesh as JMesh
from paddle_infer_tpu.serving import adapter_layer_spec as j_spec
from paddle_infer_tpu.serving import build_sharded_engine as j_build
from paddle_infer_tpu.serving import make_random_adapter
from paddle_infer_tpu.serving import request as jrequest
from paddle_infer_tpu_torch import quantization as tq
from paddle_infer_tpu_torch.inference.generation import GenerationConfig
from paddle_infer_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_infer_tpu_torch.nn.layers import LinearShards
from paddle_infer_tpu_torch.observability import get_compile_log
from paddle_infer_tpu_torch.serving import (AdapterStore, EngineCore,
                                            LoRAServingLinear, ServingMesh,
                                            build_sharded_engine)
from paddle_infer_tpu_torch.serving import request as trequest
from paddle_infer_tpu_torch.weights import from_jax_state_dict

from _torch_jax_isolation import _private_jax_compile_log  # noqa: F401
from test_torch_speculation import _pinned_globals

DIMS = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
CORE_SHAPE = dict(max_batch=4, max_model_len=48, token_budget=16,
                  prefill_chunk=16)
PAGE, RANK, AMP = 8, 4, 0.6
MESHES = {"single": {}, "mp2": dict(mp=2),
          "mp2dp2": dict(mp=2, dp_replicas=2)}


def _prompt(seed, n=8):
    return np.random.RandomState(seed).randint(0, 96, (n,)).astype(np.int32)


JOBS = [(_prompt(30, 9), dict(max_new_tokens=6), "t0"),
        (_prompt(31, 20), dict(max_new_tokens=6, do_sample=True,
                               temperature=0.8, top_k=12, seed=7), "t0"),
        (_prompt(34, 11), dict(max_new_tokens=6), "t1"),
        (_prompt(35, 5), dict(max_new_tokens=6), None)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module", autouse=True)
def _clean_topology():
    from paddle_infer_tpu.parallel import topology

    prev = topology.get_current_mesh()
    topology.set_current_mesh(None)
    yield
    topology.set_current_mesh(prev)


@pytest.fixture(autouse=True)
def _rid_counters():
    saved = jrequest._rid_counter, trequest._rid_counter
    yield
    jrequest._rid_counter, trequest._rid_counter = saved


def _jax_model():
    pit.seed(0)
    m = JGPT(JGPTConfig(**DIMS))
    m.eval()
    return m


@pytest.fixture(scope="module")
def state():
    with _pinned_globals():
        return {k: np.asarray(v.numpy())
                for k, v in _jax_model().state_dict().items()}


def _int8(side, m):
    """The reference's int8-activation model: QAT observers, one
    calibration batch, ``convert_int8``."""
    ids = np.random.RandomState(3).randint(1, 96, (2, 12)).astype(np.int32)
    lib = jq if side == "jax" else tq
    m = lib.QAT().quantize(m)
    m.eval()
    mods = list(m.sublayers() if side == "jax" else m.modules())
    for lay in mods:
        if isinstance(lay, lib.QuantedLayer):
            lay._calibrating = True
    if side == "jax":
        m(JT(ids))
    else:
        with torch.no_grad():
            m(torch.from_numpy(ids))
    for lay in mods:
        if isinstance(lay, lib.QuantedLayer):
            lay._calibrating = False
    m = lib.convert_int8(m)
    m.eval()
    return m


def _model(side, state, kind):
    with _pinned_globals():
        if side == "jax":
            m = _jax_model()
        else:
            m = GPTForCausalLM(GPTConfig(**DIMS), device="cpu")
            from_jax_state_dict(m, state)
        return _int8(side, m) if kind == "int8" else m


def _store(side, ids=("t0", "t1")):
    spec = j_spec(_jax_model())
    store = (JStore if side == "jax" else AdapterStore)(spec, rank=RANK)
    for aid, seed in zip(ids, (11, 14)):
        f, s = make_random_adapter(spec, RANK, seed, amplitude=AMP)
        store.add(aid, f, scale=s)
    return store


def _serve(side, state, kind, mesh, rid=9300, after=None):
    cfg = (JMesh if side == "jax" else ServingMesh)(**MESHES[mesh])
    model = _model(side, state, kind)
    kw = dict(CORE_SHAPE)
    if kind == "lora":
        kw.update(adapter_store=_store(side), adapter_slots=4)
    mesh_kw = dict(serving_mesh=cfg) if MESHES[mesh] else {}
    with _pinned_globals():
        if side == "jax":
            eng = j_build(model, cfg, page_size=PAGE)
            eng.program_cost = None
            jrequest._rid_counter = itertools.count(rid)
            core, G = JCore(eng, **mesh_kw, **kw), JGen
        else:
            eng = build_sharded_engine(model, cfg, page_size=PAGE,
                                       device="cpu")
            trequest._rid_counter = itertools.count(rid)
            core = EngineCore(eng, device="cpu", **mesh_kw, **kw)
            G = GenerationConfig
        jobs = JOBS if kind == "lora" else [(p, g, None) for p, g, _ in JOBS]
        try:
            reqs = [core.submit(p, G(**g), adapter_id=a)[0]
                    for p, g, a in jobs]
            for _ in range(500):
                if all(r.done for r in reqs):
                    break
                core.run_once()
            assert all(r.done for r in reqs)
            out = {"streams": [list(r.tokens) for r in reqs],
                   "engine": eng, "model": model}
            if after is not None:
                out["after"] = after(core, G)
            return out
        finally:
            core.close()


@pytest.fixture(scope="module")
def served(state):
    cache = {}

    def get(side, kind, mesh):
        key = (side, kind, mesh)
        if key not in cache:
            cache[key] = _serve(side, state, kind, mesh)
        return cache[key]

    return get


@pytest.mark.parametrize("kind", ["lora", "int8"])
@pytest.mark.parametrize("mesh", ["mp2", "mp2dp2"])
def test_streams_equal_jax_sharded_engine(served, kind, mesh):
    assert served("port", kind, mesh)["streams"] == \
        served("jax", kind, mesh)["streams"]


@pytest.mark.parametrize("kind", ["lora", "int8"])
@pytest.mark.parametrize("mesh", ["mp2", "mp2dp2"])
def test_streams_equal_single_device_core(served, kind, mesh):
    got = served("port", kind, mesh)["streams"]
    assert got == served("port", kind, "single")["streams"]
    if kind == "lora":
        base = served("port", "int8", "single")
        assert got != base["streams"]


@pytest.mark.parametrize("kind", ["lora", "int8"])
def test_layers_sliced_per_shard(served, kind):
    from paddle_infer_tpu_torch.quantization.int8 import Int8Linear

    out = served("port", kind, "mp2")
    pl = out["engine"]._placement
    layers = [m for m in out["model"].modules()
              if isinstance(m, (LoRAServingLinear, Int8Linear))]
    assert layers
    for m in layers:
        sh = pl.get(m)
        assert isinstance(sh, LinearShards) and sh.n == 2, m
        if isinstance(m, LoRAServingLinear):
            assert sh.lora is m and pl.get(m.inner) is None
        else:
            assert sh.int8 and sh.parts[0][0].dtype == torch.int8


def test_upload_after_warm_up_adds_no_first_call(state):
    """A new adapter's upload between steps writes the pools in place:
    the mp=2 core takes no new first call for it, and the pools' data
    pointers are the ones the shards read."""
    def after(core, G):
        log = get_compile_log()
        before = log.count("serving-decode")
        ptrs = [m.lora_a.data_ptr() for m in core._engine._model.modules()
                if isinstance(m, LoRAServingLinear)]
        core._adapters._store.add(
            "t2", *make_random_adapter(j_spec(_jax_model()), RANK, 23,
                                       amplitude=AMP))
        req = core.submit(_prompt(40, 9), G(max_new_tokens=4),
                          adapter_id="t2")[0]
        for _ in range(100):
            if req.done:
                break
            core.run_once()
        assert req.done
        return (log.count("serving-decode") - before, ptrs == [
            m.lora_a.data_ptr() for m in core._engine._model.modules()
            if isinstance(m, LoRAServingLinear)])

    out = _serve("port", state, "lora", "mp2", after=after)
    assert out["after"] == (0, True)
