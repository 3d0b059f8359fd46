"""One CUDA graph per program key (``core/graphs.py``).

On the CPU (here):

* the graph plumbing — ``disable_graphs()``, ``StagedInputs``, the
  launch tally a capture records and each replay adds, the first-call
  log of the eager path, and the engine dropping its graphs when the
  parameters or pools move or its core closes;
* no host read is left for a capture to trip on: one plain serving step,
  one speculative step and one ``FleetTrainStep.step`` each run under a
  ``TorchDispatchMode`` that raises on ``aten._local_scalar_dense``,
  ``aten.nonzero`` and ``aten.is_nonzero`` (and, inside the step's
  program, on ``aten.lift_fresh``: a host tensor made there would be a
  pageable host-to-device copy on the card);
* the dropout seed as a device tensor: masks and the flash plain
  versions bit-equal to the old int seed.

On the card (``gpu`` marker, skipped here): graph and eager streams are
equal (plain and speculative), one capture per key and none after
warm-up, no synchronisation inside a replay, and graph and eager train
steps give equal losses (the flash kernels use no atomics).
"""
import contextlib
import itertools

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from paddle_infer_tpu_torch.core import graphs as G
from paddle_infer_tpu_torch.core import random as R
from paddle_infer_tpu_torch.inference.generation import (
    GenerationConfig, PagedGenerationEngine)
from paddle_infer_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_infer_tpu_torch.models.ernie import (ErnieConfig,
                                                 ErnieForPretraining,
                                                 ernie_pretrain_loss)
from paddle_infer_tpu_torch.nn import functional as PF
from paddle_infer_tpu_torch.observability import get_compile_log
from paddle_infer_tpu_torch.ops import _build
from paddle_infer_tpu_torch.ops import flash_attention as FA
from paddle_infer_tpu_torch.optimizer import AdamW
from paddle_infer_tpu_torch.parallel import (DistributedStrategy,
                                             FleetTrainStep, fleet)
from paddle_infer_tpu_torch.serving import EngineCore, RequestState
from paddle_infer_tpu_torch.serving import request as trequest

TINY = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64, num_key_value_heads=2)
SHAPE = dict(max_batch=3, max_model_len=48, token_budget=16,
             prefill_chunk=16)
ERNIE = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=2, intermediate_size=128,
             max_position_embeddings=64, hidden_dropout_prob=0.1,
             attention_probs_dropout_prob=0.1)
HOST_READS = ("aten._local_scalar_dense", "aten.nonzero", "aten.is_nonzero")


class _NoHostReads(TorchDispatchMode):
    """Raise on any op that reads a device value back to the host (and
    on ``forbid_extra``)."""

    def __init__(self, forbid_extra=()):
        super().__init__()
        self.forbid = HOST_READS + tuple(forbid_extra)
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        if name in self.forbid:
            raise AssertionError(f"{func} inside a step: a host read or "
                                 "host tensor a CUDA graph cannot hold")
        self.ops += 1
        return func(*args, **(kwargs or {}))


def _tiled(n, m, seed):
    rs = np.random.RandomState(seed)
    return np.tile(rs.randint(0, 96, (m,)), -(-n // m))[:n].astype(np.int32)


def _core(model, device, **kw):
    return EngineCore(PagedGenerationEngine(model, page_size=8,
                                            device=device),
                      device=device, **SHAPE, **kw)


def _submit(core, G_):
    prompts = [_tiled(20, 3, 0), _tiled(5, 2, 1), _tiled(9, 4, 2)]
    cfgs = [G_(max_new_tokens=8),
            G_(max_new_tokens=6, do_sample=True, temperature=0.8, top_k=20,
               seed=3),
            G_(max_new_tokens=7)]
    return [core.submit(p, g)[0] for p, g in zip(prompts, cfgs)]


@pytest.fixture(scope="module")
def llama():
    return LlamaForCausalLM(LlamaConfig(**TINY), device="cpu", seed=0)


# ------------------------------------------------------------- plumbing

def test_disable_graphs_nests_and_the_cpu_never_graphs():
    cuda = torch.device("cuda")
    assert G.graphs_enabled(cuda)
    assert not G.graphs_enabled("cpu")
    with G.disable_graphs():
        assert not G.graphs_enabled(cuda)
        with G.disable_graphs():
            assert not G.graphs_enabled(cuda)
        assert not G.graphs_enabled(cuda)
    assert G.graphs_enabled(cuda)


def test_graph_static_args_keep_the_argument_tree():
    """A capture runs on the argument tree with each tensor swapped for
    its static input, in ``_flat_tensors`` order; the rest is kept."""
    a, b, c = torch.zeros(2), torch.ones(3), torch.arange(4)
    args = (a, {"x": b, "n": 5}, [c, "s"], None)
    flat = G._flat_tensors(args)
    assert [t is u for t, u in zip(flat, (a, b, c))] == [True] * 3
    new = [t.clone() for t in flat]
    out = G._with_tensors(args, iter(new))
    assert out[0] is new[0] and out[1]["x"] is new[1]
    assert out[1]["n"] == 5 and out[2][0] is new[2] and out[2][1] == "s"
    assert out[3] is None and isinstance(out[2], list)
    # only a live StagedInputs device tensor is kept as its own static
    # input, and the CPU's are not registered (the CPU never captures)
    assert not G._is_staged(a)
    inp = G.StagedInputs([("ids", (2,), np.int32)], "cpu")
    assert not G._is_staged(inp.device["ids"])


def test_staged_inputs_share_one_aligned_buffer_on_the_cpu():
    fields = [("ids", (3, 5), np.int32), ("flag", (3,), np.bool_),
              ("keys", (3, 2), np.int64), ("scratch", (), np.int32)]
    inp = G.StagedInputs(fields, "cpu")
    h = inp.begin()
    h["ids"][1, 2] = 7
    h["flag"][2] = True
    h["keys"][0] = (5, 2 ** 32 - 1)
    h["scratch"][()] = 9
    d = inp.upload()
    assert d["ids"][1, 2] == 7 and d["flag"].dtype == torch.bool
    assert d["keys"][0, 1] == 2 ** 32 - 1 and d["scratch"].shape == ()
    assert all(t.data_ptr() % 16 == 0 for t in d.values())
    base = inp._host.data_ptr()
    assert all(base <= t.data_ptr() < base + inp._host.numel()
               for t in d.values())
    assert int(inp.begin()["ids"].sum()) == 0 and d["scratch"] == 0


def test_capture_tally_counts_launches_per_replay(monkeypatch):
    k = _build.CudaKernel("probe", "none.cu", "none", [], replaces="-")
    monkeypatch.setattr(_build, "require_cuda", lambda: None)
    monkeypatch.setattr(k, "_bind", lambda: (lambda *a: 0))
    k()
    with _build.capture_launches() as tally:
        k()
        k()
    assert k.launches == 1 and tally == {k: 2}
    for _ in range(3):                     # three replays
        _build.add_launches(tally)
    assert k.launches == 7


def test_program_cache_logs_each_new_signature_once_on_the_cpu():
    log = get_compile_log()
    cache = G.ProgramCache()
    n0 = log.count("probe-graphs")
    built = []

    def make():
        built.append(1)
        return lambda x, y: x + y

    for n in (2, 2, 3, 2):
        out = cache.run("probe-graphs", ("k",), make,
                        (torch.ones(n), torch.ones(n)), torch.device("cpu"))
        assert torch.equal(out, torch.full((n,), 2.0))
    assert len(built) == 1
    assert log.count("probe-graphs") - n0 == 2
    assert cache._graphs == {}


def test_engine_drops_graphs_when_params_or_pools_move(llama):
    eng = PagedGenerationEngine(llama, page_size=8, device="cpu")
    marker = object()

    def arm():
        eng._programs._graphs["probe"] = marker

    arm()
    eng.refresh_params()                   # the same tensors: kept
    assert eng._programs._graphs == {"probe": marker}
    name, p = next(iter(eng._params.items()))
    eng._params = dict(eng._params, **{name: p.clone()})
    eng.refresh_params()                   # a tensor changed: dropped
    assert eng._programs._graphs == {}
    eng.serving_pool(8)
    eng._ensure_pages()
    arm()
    eng.serving_pool(8)                    # big enough: pools stay
    eng._ensure_pages()
    assert eng._programs._graphs == {"probe": marker}
    eng.serving_pool(16)                   # resized: dropped with the
    eng._ensure_pages()                    # pools they hold
    assert eng._programs._graphs == {}


def test_core_close_releases_the_keys_buffers(llama):
    core = _core(llama, "cpu")
    reqs = _submit(core, GenerationConfig)
    core.run_once()
    eng = core._engine
    assert len(eng._inputs) == 1
    core.close()
    assert eng._inputs == {} and eng._programs._graphs == {}
    assert all(r.done for r in reqs)


# ------------------------------------------------------ no host reads

def _guarded_steps(core, want_drafts, max_steps=12):
    """Run steps under ``_NoHostReads`` (``lift_fresh`` forbidden too:
    with no admission pending a step makes no host tensor) until one
    carried decode rows (and drafts, when ``want_drafts``)."""
    for _ in range(max_steps):
        mode = _NoHostReads(forbid_extra=("aten.lift_fresh",))
        with mode:
            core.run_once()
        assert mode.ops > 0
        step = core.step_trace[-1]
        if step["decode_rows"] and (step["draft_tokens"]
                                    or not want_drafts):
            return step
    raise AssertionError("no guarded step carried decode rows / drafts")


@pytest.mark.parametrize("speculate", [False, True],
                         ids=["plain", "speculative"])
def test_serving_step_reads_nothing_back(llama, speculate):
    spec = (dict(speculate=True, num_draft_tokens=3, draft_source="ngram")
            if speculate else {})
    core = _core(llama, "cpu", **spec)
    try:
        reqs = _submit(core, GenerationConfig)
        core.run_once()                    # admission + the first chunk
        _guarded_steps(core, want_drafts=speculate)
        for _ in range(200):
            if all(r.done for r in reqs):
                break
            core.run_once()
        assert all(r.state == RequestState.DONE for r in reqs)
    finally:
        core.close()


def _train_step(device, cfg=ERNIE, amp_o2=False, seed=3):
    model = ErnieForPretraining(ErnieConfig(**cfg), device=device,
                                seed=seed)
    st = DistributedStrategy()
    if amp_o2:
        st.amp = True
        st.amp_configs = {"level": "O2", "dtype": "bfloat16"}
    fleet.init(strategy=st, devices=[device])

    def loss_fn(m, ids, mask, labels, nsp):
        mlm, nsp_logits = m(ids, attention_mask=mask)
        return ernie_pretrain_loss(mlm, nsp_logits, labels, nsp)

    return FleetTrainStep(model, loss_fn, AdamW(
        learning_rate=1e-3, parameters=model.parameters()), strategy=st)


def _train_batch(device, b=2, s=32, pad=4, vocab=ERNIE["vocab_size"],
                 seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[:, s - pad:] = 0
    labels = rng.randint(0, vocab, (b, s)).astype(np.int32)
    labels[:, s - pad:] = -100
    nsp = rng.randint(0, 2, (b,)).astype(np.int32)
    return [torch.from_numpy(a).to(device) for a in (ids, mask, labels, nsp)]


def test_train_step_reads_nothing_back():
    step = _train_step("cpu")
    data = _train_batch("cpu")
    step(*data)
    with _NoHostReads():
        loss = step(*data)
    assert torch.isfinite(loss)
    # the graph's body alone makes no host tensor either
    d = step._scalars.upload()
    with _NoHostReads(forbid_extra=("aten.lift_fresh",)):
        step._grad_sets = []
        step._body(d["key"], d["lr"], d["step"], *data)
    step._grad_sets = None


# ------------------------------------------------- the seed as a tensor

@pytest.mark.parametrize("seed", [0, 7, 2 ** 32 - 3])
def test_dropout_and_flash_plain_tensor_seed_bit_equal_int(seed):
    torch.manual_seed(1)
    tseed = torch.tensor(seed, dtype=torch.int64)
    # the keep grid
    assert torch.equal(FA._keep_grid(seed, 6, 9, 11, 0.3, "cpu"),
                       FA._keep_grid(tseed, 6, 9, 11, 0.3, "cpu"))
    # the flash plain versions
    bh, sq, sk, d, h = 4, 9, 13, 8, 2
    q, k, v, do = (torch.randn(bh, n, d) for n in (sq, sk, sk, sq))
    args = (None, None)
    o_i, lse_i = FA._fwd_reference(q, k, v, *args, seed, False, 0.3, 0.2, h)
    o_t, lse_t = FA._fwd_reference(q, k, v, *args, tseed, False, 0.3, 0.2, h)
    assert torch.equal(o_i, o_t) and torch.equal(lse_i, lse_t)
    gi = FA._bwd_reference(q, k, v, o_i, lse_i, do, *args, seed, True, 0.3,
                           0.2, h)
    gt = FA._bwd_reference(q, k, v, o_t, lse_t, do, *args, tseed, True,
                           0.3, 0.2, h)
    assert all(torch.equal(a, b) for a, b in zip(gi, gt))
    # the public entry point takes either form
    qb, kb, vb = (x.reshape(2, h, -1, d).permute(0, 2, 1, 3)
                  for x in (q, k, v))
    assert torch.equal(
        FA.flash_attention(qb, kb, vb, dropout_p=0.2, dropout_seed=seed),
        FA.flash_attention(qb, kb, vb, dropout_p=0.2, dropout_seed=tseed))


def test_scope_draws_equal_fold_in_across_blocks():
    """Inside ``trace_key_scope(base)`` draw ``i`` is ``fold_in(base,
    i)`` and its seed ``seed_from_key`` of that key, past a block's end
    too, and keys and seeds interleave on one counter."""
    base = R.fold_in(R.PRNGKey(5), 11)
    ks = R.KeyStream(0)
    n = R._SCOPE_BLOCK * 2 + 3
    with ks.trace_key_scope(base):
        got = [ks.next_key() if i % 3 else ks.next_seed() for i in range(n)]
    for i, g in enumerate(got):
        want = R.fold_in(base, i)
        assert torch.equal(g, want if i % 3 else R.seed_from_key(want)), i
    assert torch.equal(R.bits(R.fold_in(base, torch.arange(4))),
                       torch.stack([R.bits(R.fold_in(base, i))
                                    for i in range(4)]))


def test_scope_derives_a_block_of_seeds_in_one_pass():
    """A block's draws after the first cost one view each: a step's
    dropouts add no threefry chain of their own."""
    base = R.PRNGKey(1)

    def ops(n):
        ks = R.KeyStream(0)
        with _NoHostReads() as mode, ks.trace_key_scope(base):
            for _ in range(n):
                ks.next_seed()
        return mode.ops

    assert ops(R._SCOPE_BLOCK) == ops(1) + 2 * (R._SCOPE_BLOCK - 1)


def test_dropout_seed_from_key_bit_equal_int_words():
    key = R.fold_in(R.PRNGKey(11), 5)
    w0, w1 = R._key_words(key)
    b1, b2 = R.threefry2x32(w0, w1, 0, 0)
    seed = R.seed_from_key(key)
    assert seed.dtype == torch.int64 and seed.dim() == 0
    assert int(seed) == b1 ^ b2
    x = torch.randn(4, 33)
    lin = torch.arange(x.numel(), dtype=torch.int64).reshape(x.shape)
    keep = FA._mix32(FA._mul32(lin, 0x9E3779B1) ^ (b1 ^ b2)) >= \
        FA.keep_threshold(0.25)
    want = torch.where(keep, x * (1.0 / 0.75), torch.zeros(()))
    assert torch.equal(PF._dropout(x, key, p=0.25), want)
    # inside a step scope, keys fold in on the base's device
    ks = R.KeyStream(0)
    with ks.trace_key_scope(key):
        k0 = ks.next_key()
    assert torch.equal(k0, R.fold_in(key, 0))


# ------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


CARD_LLAMA = dict(TINY, hidden_size=256, num_attention_heads=4,
                  num_key_value_heads=4, intermediate_size=512)


def _card_streams(model, device, **kw):
    """Serve the three requests with the rid counter pinned; returns the
    streams, the core's trace and the launches of the run."""
    saved = trequest._rid_counter
    trequest._rid_counter = itertools.count(900)
    for kern in _build.KERNELS.values():
        kern.launches = 0
    core = _core(model, device, **kw)
    try:
        reqs = _submit(core, GenerationConfig)
        for _ in range(200):
            if all(r.done for r in reqs):
                break
            core.run_once()
        torch.cuda.synchronize()
        assert all(r.state == RequestState.DONE for r in reqs), \
            [(r.rid, r.error) for r in reqs]
        return ([list(r.tokens) for r in reqs], list(core.step_trace),
                {n: k.launches for n, k in _build.KERNELS.items()})
    finally:
        core.close()
        trequest._rid_counter = saved


@pytest.mark.gpu
@pytest.mark.parametrize("speculate", [False, True],
                         ids=["plain", "speculative"])
def test_graph_streams_equal_eager_on_card(cuda_device, speculate):
    spec = (dict(speculate=True, num_draft_tokens=3, draft_source="ngram")
            if speculate else {})
    model = LlamaForCausalLM(LlamaConfig(**CARD_LLAMA), device=cuda_device,
                             dtype=torch.bfloat16, seed=0)
    log = get_compile_log()
    n0 = log.count("serving-decode")
    pw0 = log.summary()["post_warmup_decode_compiles"]
    graph, trace, launches = _card_streams(model, cuda_device, **spec)
    assert log.count("serving-decode") - n0 == 1
    assert log.summary()["post_warmup_decode_compiles"] == pw0
    L = CARD_LLAMA["num_hidden_layers"]
    assert launches["paged_decode"] == L * len(trace)
    assert launches["ragged_paged_attention"] == L * len(trace)
    with G.disable_graphs():
        eager, _, _ = _card_streams(model, cuda_device, **spec)
    assert graph == eager


@pytest.mark.gpu
def test_replay_makes_no_sync(cuda_device):
    model = LlamaForCausalLM(LlamaConfig(**CARD_LLAMA), device=cuda_device,
                             dtype=torch.bfloat16, seed=0)
    core = _core(model, cuda_device)
    eng = core._engine
    inner = eng.run_paged_program
    replays = []

    def guarded(*a):
        if not eng._programs._graphs:
            return inner(*a)               # the capturing call syncs
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = inner(*a)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        replays.append(1)
        return out

    eng.run_paged_program = guarded
    try:
        reqs = _submit(core, GenerationConfig)
        for _ in range(200):
            if all(r.done for r in reqs):
                break
            core.run_once()
        assert all(r.state == RequestState.DONE for r in reqs), \
            [(r.rid, r.error) for r in reqs]
    finally:
        core.close()
    assert len(replays) >= 3


CARD_ERNIE = dict(ERNIE, hidden_size=128)        # head_dim 64: flash


@pytest.mark.gpu
def test_train_graph_equals_eager_on_card(cuda_device):
    """The kernels are deterministic (no atomics), so graph and eager
    steps from the same state give EQUAL losses."""
    data = _train_batch(cuda_device, b=2, s=64, pad=6)
    losses = {}
    for mode in ("graph", "eager"):
        step = _train_step(cuda_device, CARD_ERNIE, amp_o2=True)
        for kern in _build.KERNELS.values():
            kern.launches = 0
        with (G.disable_graphs() if mode == "eager"
              else contextlib.nullcontext()):
            losses[mode] = torch.stack(
                [step(*data).clone() for _ in range(6)])
        torch.cuda.synchronize()
        for name in ("flash_fwd", "flash_dkdv", "flash_dq"):
            assert _build.KERNELS[name].launches == \
                6 * CARD_ERNIE["num_hidden_layers"], (mode, name)
        step.release_graphs()
    assert torch.equal(losses["graph"], losses["eager"])


@pytest.mark.gpu
def test_train_graph_takes_each_batch_on_card(cuda_device):
    """Two batches on the card, alternating: the graph's losses equal
    the eager ones, and the caller's batch tensors are never written
    (a replay copies each batch into the graph's own inputs)."""
    batches = [_train_batch(cuda_device, b=2, s=64, pad=6, seed=seed)
               for seed in (0, 1)]
    kept = [[t.clone() for t in b] for b in batches]
    losses = {}
    for mode in ("graph", "eager"):
        step = _train_step(cuda_device, CARD_ERNIE, amp_o2=True)
        with (G.disable_graphs() if mode == "eager"
              else contextlib.nullcontext()):
            losses[mode] = torch.stack(
                [step(*batches[i % 2]).clone() for i in range(6)])
        torch.cuda.synchronize()
        step.release_graphs()
    assert torch.equal(losses["graph"], losses["eager"])
    assert not torch.equal(losses["graph"][0], losses["graph"][1])
    for b, kb in zip(batches, kept):
        assert all(torch.equal(t, k) for t, k in zip(b, kb))
