"""Port parity: fault-tolerant serving (``serving/resilience/``) on the
ragged ``EngineCore``.

Each test of ``tests/test_resilience.py`` on the port's core, on the
reference tests' tiny GPT (vocab 96, hidden 32, 2 layers, page 8): the
fault plane's schedule, the guarded health machine, replay after a
failed step (KV lost and KV intact, greedy and sampled), the retry
budget's quarantine, the crash loop going DOWN, the memory-pressure
ladder and its shedding, quarantine of a poisoned row, the step
watchdog (post hoc and live), drain / resume, the supervisor's thread,
and the seeded chaos run over at least 200 steps.  The JAX test's
``decode_chunk`` (the port's core has none) and its Prometheus
rendering (queue item 2) are left out; ``metrics_snapshot()
["resilience"]`` is checked in their place.  Added here:

* the port's ``FaultPlane`` and JAX's fire the same spec lists at the
  same sequence numbers, with the same ``nan_rids`` and counts;
* the port's core and the JAX ``EngineCore``, on the same weights and
  the same fault script, give equal streams, final states and counters
  (the script keeps its ``lose_kv`` fault last: the port replays lost
  delivered tokens one a step, where JAX re-prefills them in one, so a
  later scripted fault would land on another step);
* within the port, replayed streams are bitwise the fault-free ones,
  with fp32 and int8 pools, with and without the prefix cache, and a
  replay feeds each token through the kernel that first wrote it (the
  CPU's plain paths agree bit for bit, so only the card's bf16 streams
  would show a token on the wrong kernel: the routing is checked on the
  staged step inputs);
* ``rebuild_kv_state`` zeroes the pools in place (every ``data_ptr()``
  kept) and a replay takes no new first call on the serve-step site;
* on the card (``gpu``), a replay through a failure replays the
  captured graph and takes no capture.

Request ids key the sampling streams (``fold_in(key, rid)``), so runs
that compare streams pin both packages' rid counters.
"""
import itertools
import json
import threading
import time

import numpy as np
import pytest
import torch

from paddle_infer_tpu.inference.generation import \
    GenerationConfig as JGen
from paddle_infer_tpu.inference.generation import \
    PagedGenerationEngine as JEngine
from paddle_infer_tpu.serving import EngineCore as JCore
from paddle_infer_tpu.serving import EngineSupervisor as JSupervisor
from paddle_infer_tpu.serving import request as jrequest
from paddle_infer_tpu.serving.resilience import faultplane as jfaultplane
from paddle_infer_tpu_torch.inference.generation import (
    GenerationConfig, PagedGenerationEngine)
from paddle_infer_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_infer_tpu_torch.observability import get_compile_log
from paddle_infer_tpu_torch.ops.paged_attention import KV_SCALE_EPS
from paddle_infer_tpu_torch.serving import (DeadlineExceededError,
                                            EngineCore, EngineSupervisor,
                                            FaultPlane, FaultSpec,
                                            HealthMonitor, HealthState,
                                            LoadShedError,
                                            QuarantinedError, RequestState)
from paddle_infer_tpu_torch.serving import request as trequest
from paddle_infer_tpu_torch.serving.resilience import (NULL_PLANE,
                                                       InjectedFault,
                                                       InjectedMemoryError)
from paddle_infer_tpu_torch.serving.resilience import \
    faultplane as tfaultplane
from paddle_infer_tpu_torch.serving.resilience.faultplane import SITES

from _torch_jax_isolation import _private_jax_compile_log  # noqa: F401
from test_torch_speculation import TINY, _pair, _pinned_globals

PAGE = 8


@pytest.fixture(scope="module", autouse=True)
def _meshless():
    from paddle_infer_tpu.parallel import topology

    prev = topology.get_current_mesh()
    topology.set_current_mesh(None)
    yield
    topology.set_current_mesh(prev)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tiny model's steps are a few hundred small ops each: one
    intra-op thread runs them as fast as many, and stays fast when the
    suite's workers share the machine's cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def _rid_counters():
    """Tests pin the rid counters; put both back after each."""
    saved = jrequest._rid_counter, trequest._rid_counter
    yield
    jrequest._rid_counter, trequest._rid_counter = saved


@pytest.fixture(scope="module")
def pair():
    """The reference tests' tiny GPT in JAX, and the port's on the same
    weights."""
    with _pinned_globals():
        return _pair("gpt")


@pytest.fixture(scope="module")
def model(pair):
    return pair[1]


@pytest.fixture(scope="module")
def engine(model):
    """The engine the supervised cores own (recovery zeroes its pools in
    place)."""
    return PagedGenerationEngine(model, page_size=PAGE, device="cpu")


@pytest.fixture(scope="module")
def ref(model):
    """A separate engine: ``generate()`` on a core's own engine would
    free its slots' sequence ids."""
    return PagedGenerationEngine(model, page_size=PAGE, device="cpu")


@pytest.fixture
def make_sup(engine):
    """(core, sup) factory: core kwargs are split from supervisor kwargs,
    every supervisor is closed on teardown."""
    sups = []

    def make(plane=None, **kw):
        core_kw = {"max_batch": kw.pop("max_batch", 2),
                   "max_model_len": kw.pop("max_model_len", 48),
                   "enable_prefix_cache": kw.pop("enable_prefix_cache",
                                                 False),
                   "fault_plane": plane}
        if "max_queue" in kw:
            core_kw["max_queue"] = kw.pop("max_queue")
        core = EngineCore(engine, device="cpu", **core_kw)
        sup = EngineSupervisor(core, **kw)
        sups.append(sup)
        return core, sup

    yield make
    for s in sups:
        s.close()


def _prompt(seed, n=8):
    return np.random.RandomState(seed).randint(0, 96, (n,)).astype(np.int32)


def _drive(sup, reqs, max_iters=400):
    steps = 0
    for _ in range(max_iters):
        if all(r.done for r in reqs):
            return steps
        sup.run_once()
        steps += 1
    raise AssertionError("requests did not finish")


def _generate(ref, ids, g):
    return np.asarray(ref.generate(ids[None], g))[0]


# --------------------------------------------------------------- fault plane

def test_faultplane_scripted_and_probabilistic_are_deterministic():
    def pattern(seed):
        plane = FaultPlane([FaultSpec("decode.step", at=3),
                            FaultSpec("kv.alloc", p=0.3, times=2,
                                      exc="MemoryError")], seed=seed)
        fired = []
        for i in range(40):
            for site, err in (("decode.step", InjectedFault),
                              ("kv.alloc", InjectedMemoryError)):
                try:
                    plane.fire(site)
                except err as e:
                    fired.append((site, i, e.seq))
        return fired, plane.counts()

    a, ca = pattern(7)
    b, cb = pattern(7)
    assert a == b and ca == cb               # same seed -> same schedule
    assert ("decode.step", 2, 3) in a        # scripted fire at seq 3
    assert ca["kv.alloc"] == 2               # p-spec honoured its budget
    c, _ = pattern(8)
    assert [x for x in c if x[0] == "kv.alloc"] != \
        [x for x in a if x[0] == "kv.alloc"]


def test_faultplane_from_spec_json_and_null_plane():
    plane = FaultPlane.from_spec(
        '[{"site": "prefill.run", "at": 1, "exc": "MemoryError", '
        '"lose_kv": true}]')
    with pytest.raises(MemoryError) as ei:
        plane.fire("prefill.run")
    assert ei.value.lose_kv and ei.value.site == "prefill.run"
    assert plane.counts() == {"prefill.run": 1}
    with pytest.raises(ValueError):
        FaultSpec("not.a.site")
    with pytest.raises(ValueError):
        FaultSpec("decode.step", action="explode")
    # the disabled plane: no effects, no counts, at every site
    for site in SITES:
        assert NULL_PLANE.fire(site) is None
    assert NULL_PLANE.counts() == {}


def test_faultplane_latency_spec_sleeps(monkeypatch):
    slept = []
    monkeypatch.setattr(tfaultplane, "time_sleep", slept.append)
    plane = FaultPlane([FaultSpec("decode.step", action="hang", at=2,
                                  delay_s=0.5)])
    plane.fire("decode.step")
    assert slept == []
    plane.fire("decode.step")
    assert slept == [0.5]


def _fire_log(mod, specs, seed, monkeypatch):
    """Fire a fixed site sequence on ``mod``'s plane: per fire, the
    sequence number, what was raised (type name, ``lose_kv``), the sleep
    and the ``nan_rids``; then the counts and the specs' state."""
    slept = []
    monkeypatch.setattr(mod, "time_sleep", slept.append)
    plane = mod.FaultPlane.from_spec(json.dumps(specs), seed=seed)
    rs = np.random.RandomState(seed)
    log = []
    for i in range(300):
        site = mod.SITES[rs.randint(len(mod.SITES))]
        rid = int(rs.randint(100, 106))
        rids = sorted({int(x) for x in rs.randint(100, 106, (3,))})
        n0 = len(slept)
        try:
            out = plane.fire(site, rid=rid, rids=rids)
            raised = None
        except (mod.InjectedFault, mod.InjectedMemoryError) as e:
            out, raised = None, (type(e).__name__, e.seq, e.lose_kv)
        log.append((i, site, raised, slept[n0:],
                    sorted(out["nan_rids"]) if out else None))
    return log, plane.counts(), plane.specs_snapshot()


@pytest.mark.parametrize("seed", [0, 5])
def test_faultplane_fires_as_jax(seed, monkeypatch):
    """One spec list, one seed, one sequence of fires: the port's plane
    and JAX's raise, sleep and poison at the same fires."""
    specs = [
        {"site": "decode.step", "at": 7, "lose_kv": True},
        {"site": "decode.step", "action": "nan_rows", "p": 0.2},
        {"site": "decode.step", "action": "nan_rows", "at": 12,
         "rid": 103},
        {"site": "kv.alloc", "p": 0.15, "times": 4, "exc": "MemoryError"},
        {"site": "prefill.run", "p": 0.1, "rid": 101},
        {"site": "prefix.match", "action": "latency", "p": 0.1,
         "delay_s": 0.25},
        {"site": "page.copy", "action": "hang", "at": 3, "delay_s": 1.5},
        {"site": "kv.swap_in", "p": 0.3, "times": 2},
    ]
    got = _fire_log(tfaultplane, specs, seed, monkeypatch)
    want = _fire_log(jfaultplane, specs, seed, monkeypatch)
    assert got == want
    assert sum(got[1].values()) > 10        # the schedule did fire


# ------------------------------------------------------------- health machine

def test_health_transitions_are_guarded():
    h = HealthMonitor()
    assert h.state is HealthState.HEALTHY and h.is_serving()
    assert not h.to_healthy("noop")          # only DEGRADED -> HEALTHY
    assert h.to_degraded("failure")
    assert not h.to_degraded("again")        # already degraded
    assert h.to_healthy("recovered")
    assert h.to_draining("admin")
    assert not h.is_serving()
    assert not h.to_degraded("late failure")  # draining is sticky
    assert h.resume() and h.state is HealthState.DEGRADED
    assert h.to_down("crash loop")
    assert h.state.code == 3
    assert h.resume() and h.state is HealthState.DEGRADED
    reasons = [t["reason"] for t in h.transitions()]
    assert "crash loop" in reasons


# ----------------------------------------------------------- replay recovery

def test_replay_after_kv_loss_preserves_greedy_stream(make_sup, ref):
    """A mid-decode crash that loses the pools' contents: the supervisor
    restarts the engine and replays the in-flight request; the client
    sees the exact uninterrupted stream."""
    ids = _prompt(1)
    g = GenerationConfig(max_new_tokens=12)
    want = _generate(ref, ids, g)

    # step 1 prefills and samples; step 5 is the fourth decode step
    plane = FaultPlane([FaultSpec("decode.step", at=5, lose_kv=True)])
    core, sup = make_sup(plane)
    (req,) = core.submit(ids, g)
    _drive(sup, [req])
    np.testing.assert_array_equal(req.result(), want)
    assert req.retries == 1
    res = core.metrics_snapshot()["resilience"]
    assert res["engine_restarts"] == 1
    assert res["request_retries"] == 1
    assert res["faults_injected"] == {"decode.step": 1}
    assert res["health_state"] == "degraded"


def test_replay_sampled_row_draws_the_same_stream(make_sup):
    """Replay resumes sampling at the original per-(rid, step) fold_in
    offset — a SAMPLED row's replayed stream equals its uninterrupted
    one.  Both runs pin the rid counter so the request keys match."""
    ids = _prompt(2)
    g = GenerationConfig(max_new_tokens=12, do_sample=True,
                         temperature=0.8, top_k=12, seed=11)

    def run(plane):
        trequest._rid_counter = itertools.count(7000)
        core, sup = make_sup(plane)
        (req,) = core.submit(ids, g)
        _drive(sup, [req])
        return req

    want = run(None).result()
    got = run(FaultPlane([FaultSpec("decode.step", at=4)]))
    np.testing.assert_array_equal(got.result(), want)
    assert got.retries == 1


def test_retry_budget_exhaustion_quarantines_poison_request(make_sup):
    """A request that crashes the engine on every step burns its replay
    budget and is quarantined instead of crash-looping."""
    plane = FaultPlane([FaultSpec("decode.step", p=1.0)])
    core, sup = make_sup(plane, max_retries=2, crash_threshold=100)
    (req,) = core.submit(_prompt(3), GenerationConfig(max_new_tokens=8))
    for _ in range(40):
        if req.done:
            break
        sup.run_once()
    assert req.state is RequestState.FAILED
    with pytest.raises(QuarantinedError):
        req.result()
    assert req.retries == 2
    res = core.metrics_snapshot()["resilience"]
    assert res["requests_quarantined"] == 1
    assert res["request_retries"] == 2
    assert core.active_count == 0
    assert core.metrics_snapshot()["queue_depth"] == 0


def test_crash_loop_goes_down_and_resume_recovers(make_sup):
    plane = FaultPlane([FaultSpec("decode.step", p=1.0)])
    core, sup = make_sup(plane, max_retries=50, crash_threshold=3)
    (req,) = core.submit(_prompt(4), GenerationConfig(max_new_tokens=8))
    for _ in range(40):
        if req.done:
            break
        sup.run_once()
    assert sup.health.state is HealthState.DOWN
    # DOWN disables replay: the in-flight request failed rather than
    # retrying forever against a wedged engine
    assert req.state is RequestState.FAILED
    assert sup.consume_backoff() > 0.0
    assert sup.resume() and sup.health.state is HealthState.DEGRADED


def test_expired_request_is_cancelled_not_replayed(make_sup):
    plane = FaultPlane([FaultSpec("decode.step", at=2)])
    core, sup = make_sup(plane)
    (req,) = core.submit(_prompt(5), GenerationConfig(max_new_tokens=12),
                         timeout_s=0.05)
    sup.run_once()                       # admit + first step
    time.sleep(0.08)                     # deadline passes mid-decode
    for _ in range(5):
        if req.done:
            break
        sup.run_once()                   # crash/deadline -> no replay
    assert req.state is RequestState.CANCELLED
    with pytest.raises(DeadlineExceededError):
        req.result()
    assert req.retries == 0              # no budget spent on a dead row
    assert core.metrics_snapshot()["resilience"]["request_retries"] == 0


# ------------------------------------------------------- degradation ladder

def test_memory_pressure_halves_batch_then_ladder_recovers(make_sup):
    plane = FaultPlane([FaultSpec("kv.alloc", at=1, exc="MemoryError")])
    core, sup = make_sup(plane, max_batch=4, recover_after=1)
    assert core.effective_max_batch == 4
    reqs = [core.submit(_prompt(10 + i), GenerationConfig(
        max_new_tokens=20))[0] for i in range(2)]
    _drive(sup, reqs)
    for r in reqs:                       # the OOM victim was requeued
        assert r.state is RequestState.DONE
    assert core.metrics_snapshot()["resilience"]["request_retries"] == 1
    # ladder: halved to 2 on pressure, then grown back one slot per
    # clean step, and DEGRADED -> HEALTHY at full width
    assert core.effective_max_batch == 4
    assert sup.health.state is HealthState.HEALTHY


def test_second_pressure_sheds_queued_low_headroom(make_sup):
    specs = [FaultSpec("kv.alloc", at=1, exc="MemoryError"),
             FaultSpec("kv.alloc", at=2, exc="MemoryError")]
    core, sup = make_sup(FaultPlane(specs), max_batch=1,
                         shed_headroom_s=5.0, recover_after=100)
    g = GenerationConfig(max_new_tokens=8)
    # the OOM magnet has no deadline (never shed); the doomed request
    # waits in the queue with less headroom than the ladder demands
    (victim,) = core.submit(_prompt(20), g)
    (doomed,) = core.submit(_prompt(21), g, timeout_s=2.0)
    for _ in range(10):
        if doomed.done:
            break
        sup.run_once()                   # 2nd consecutive OOM -> shed
    assert doomed.state is RequestState.REJECTED
    with pytest.raises(LoadShedError):
        doomed.result()
    _drive(sup, [victim])                # the magnet itself replays fine
    assert victim.state is RequestState.DONE
    res = core.metrics_snapshot()["resilience"]
    assert res["requests_shed"] == 1
    assert res["request_retries"] == 2
    assert core.effective_max_batch == 1


def test_nan_logits_quarantine_only_the_offending_row(make_sup, ref):
    """Non-finite logits on one row: that row alone is quarantined; its
    batch-mate keeps decoding and stays bit-exact."""
    ga = GenerationConfig(max_new_tokens=12)
    ids_a, ids_b = _prompt(30), _prompt(31)
    trequest._rid_counter = itertools.count(7100)
    plane = FaultPlane([FaultSpec("decode.step", action="nan_rows",
                                  at=2, rid=7100)])
    core, sup = make_sup(plane)
    (ra,) = core.submit(ids_a, ga)
    (rb,) = core.submit(ids_b, ga)
    _drive(sup, [ra, rb])
    assert ra.state is RequestState.FAILED
    with pytest.raises(QuarantinedError):
        ra.result()
    np.testing.assert_array_equal(rb.result(),
                                  _generate(ref, ids_b, ga))
    res = core.metrics_snapshot()["resilience"]
    assert res["requests_quarantined"] == 1
    assert res["engine_restarts"] == 0   # row fault, not an engine fault
    assert res["request_retries"] == 0


# ------------------------------------------------------ watchdog + draining

def test_watchdog_trips_on_hung_step(make_sup):
    plane = FaultPlane([FaultSpec("decode.step", action="hang", at=2,
                                  delay_s=0.25)])
    core, sup = make_sup(plane, watchdog_s=0.1)
    (req,) = core.submit(_prompt(40), GenerationConfig(max_new_tokens=8))
    sup.run_once()                       # admit + first (clean) step
    trips0 = core.metrics.watchdog_trips
    sup.run_once()                       # hung step
    assert core.metrics.watchdog_trips == trips0 + 1
    assert sup.health.state is HealthState.DEGRADED
    _drive(sup, [req])
    assert req.state is RequestState.DONE
    info = sup.health_info()
    assert info["watchdog_s"] == 0.1 and info["stalled_for_s"] == 0.0


def test_live_watchdog_flags_step_still_in_flight(make_sup):
    """The sidecar thread must trip WHILE a step is wedged (not only
    post-hoc), and exactly once per stall."""
    core, sup = make_sup(watchdog_s=0.05)
    started, release = threading.Event(), threading.Event()

    def wedged(wait_s=0.0):
        started.set()
        release.wait(5.0)
        return False

    core.run_once = wedged
    sup.start()
    assert started.wait(2.0)
    deadline = time.monotonic() + 2.0
    while (core.metrics.watchdog_trips < 1
           and time.monotonic() < deadline):
        time.sleep(0.01)
    assert core.metrics.watchdog_trips == 1   # deduped while stalled
    assert sup.stalled_for() > 0.05
    assert sup.health.state is HealthState.DEGRADED
    release.set()
    assert sup.stop(timeout=5.0)


def test_drain_resume_gate_admission(make_sup):
    core, sup = make_sup()
    g = GenerationConfig(max_new_tokens=4)
    assert sup.drain()
    assert core.draining and not sup.health.is_serving()
    with pytest.raises(LoadShedError):
        core.submit(_prompt(41), g)
    with pytest.raises(LoadShedError):
        core.submit_exclusive(lambda: None)
    assert core.metrics_snapshot()["rejected"] == 2
    assert sup.resume()
    (req,) = core.submit(_prompt(41), g)
    _drive(sup, [req])
    assert req.state is RequestState.DONE
    assert core.metrics_snapshot()["resilience"]["draining"] is False


def test_supervisor_background_thread_and_stop(make_sup):
    core, sup = make_sup()
    sup.start()
    (req,) = core.submit(_prompt(42), GenerationConfig(max_new_tokens=8))
    req.result(timeout=60)
    assert sup.stop(timeout=5.0) is True
    assert sup.stop(timeout=5.0) is True     # idempotent


# --------------------------------------------------------------- chaos run

def test_seeded_chaos_exact_streams_across_200_steps(model):
    """The reference's acceptance scenario on the port: >= 200
    supervised steps under a seeded schedule of MemoryError, engine
    crashes (with and without KV loss), non-finite logits, a hung step,
    and admission-path faults on every site the port fires.  Every
    non-quarantined request completes with exactly its fault-free
    stream, the pool drains back to baseline, and replay takes no new
    first call on the serve-step site after warm-up."""
    n_req, max_new = 32, 24
    shared = np.random.RandomState(99).randint(0, 96, (12,)).astype(
        np.int32)
    prompts = []
    for i in range(n_req):
        if i % 4 == 0:    # every 4th request shares a 12-token prefix
            tail = np.random.RandomState(200 + i).randint(
                0, 96, (4,)).astype(np.int32)
            prompts.append(np.concatenate([shared, tail]))
        else:
            prompts.append(_prompt(100 + i, n=8 if i % 2 else 16))
    configs = [GenerationConfig(max_new_tokens=max_new, do_sample=True,
                                temperature=0.9, top_k=20, seed=3 + i)
               if i % 8 == 5 else
               GenerationConfig(max_new_tokens=max_new)
               for i in range(n_req)]
    chaos_engine = PagedGenerationEngine(model, page_size=PAGE,
                                         device="cpu")
    log = get_compile_log()

    def run(plane):
        trequest._rid_counter = itertools.count(5000)
        core = EngineCore(chaos_engine, max_batch=4, max_queue=64,
                          max_model_len=40, enable_prefix_cache=True,
                          fault_plane=plane, device="cpu")
        sup = EngineSupervisor(core, watchdog_s=0.5, max_retries=3,
                               crash_threshold=10, recover_after=10,
                               backoff_base_s=0.0)
        try:
            pool_baseline = core._pool.free_blocks
            (w,) = core.submit(_prompt(98), GenerationConfig(
                max_new_tokens=4))
            _drive(sup, [w])             # warm-up: first call + warm
            warm = log.summary()["post_warmup_decode_compiles"]
            reqs = [core.submit(p, g)[0]
                    for p, g in zip(prompts, configs)]
            steps = _drive(sup, reqs, max_iters=2000)
            # sequential identical-prompt resubmissions: with the batch
            # drained the retained pages survive, so the 16-token prompt
            # matches 15 tokens (a full page + a 7-token tail) and
            # admission copies the tail on write
            for _ in range(3):
                (e,) = core.submit(prompts[0], GenerationConfig(
                    max_new_tokens=max_new))
                steps += _drive(sup, [e])
                reqs.append(e)
            outs = []
            for r in reqs:
                try:
                    outs.append(r.result().tolist())
                except Exception:
                    outs.append(None)
            snap = core.metrics_snapshot()
            replay_calls = log.summary()["post_warmup_decode_compiles"] - warm
            # refcount discipline: queue empty, no active rows; dropping
            # the retained cache pages returns the pool to baseline
            assert core.active_count == 0
            assert snap["queue_depth"] == 0
            core.prefix_cache.clear()
            assert core._pool.free_blocks == pool_baseline
        finally:
            sup.close()
        return reqs, outs, snap, steps, replay_calls

    _, expected, _, _, _ = run(None)
    assert all(o is not None for o in expected)

    # schedule indices are absolute per-site fire counts; the warm-up
    # request burns decode.step x4 (a prefill step and 3 decode steps),
    # and one fire each of kv.alloc / prefill.run / prefix.match
    plane = FaultPlane([
        FaultSpec("decode.step", at=23, lose_kv=True),     # restart
        FaultSpec("decode.step", at=63),                   # crash, KV ok
        FaultSpec("decode.step", action="hang", at=110, delay_s=0.8),
        FaultSpec("decode.step", action="nan_rows", at=150),
        FaultSpec("kv.alloc", at=9, exc="MemoryError"),
        FaultSpec("kv.alloc", at=20, exc="MemoryError"),
        FaultSpec("prefill.run", at=16),
        FaultSpec("page.copy", at=3),
        FaultSpec("prefix.match", at=25),
    ], seed=0)
    reqs, got, snap, steps, replay_calls = run(plane)

    assert steps >= 200
    res = snap["resilience"]
    counts = res["faults_injected"]
    assert counts["decode.step"] == 4
    assert counts["kv.alloc"] == 2
    assert counts["prefill.run"] == 1
    assert counts["page.copy"] == 1
    assert counts["prefix.match"] == 1
    assert res["engine_restarts"] == 1
    assert res["watchdog_trips"] >= 1
    assert res["requests_quarantined"] == 1
    assert res["request_retries"] >= 6

    quarantined = [i for i, r in enumerate(reqs)
                   if r.state is RequestState.FAILED
                   and isinstance(r.error, QuarantinedError)]
    assert len(quarantined) == 1
    for i, (want, out) in enumerate(zip(expected, got)):
        if i in quarantined:
            # tokens delivered before the quarantine are an uncorrupted
            # prefix of the expected stream (never a wrong token)
            delivered = reqs[i].tokens
            assert delivered == want[:len(delivered)]
            continue
        assert out is not None, f"request {i} did not complete"
        assert out == want, f"request {i} stream diverged"

    # replay reused the warm serve-step program throughout
    assert replay_calls == 0
    assert res["health_state"] in ("healthy", "degraded")


# ------------------------------------------------------------ metrics wiring

def test_resilience_counters_reach_metrics_snapshot(make_sup):
    core, sup = make_sup()
    core.metrics.on_engine_restart()
    core.metrics.on_watchdog_trip(2)
    sup.drain()
    res = core.metrics_snapshot()["resilience"]
    assert res["health_state"] == "draining" and res["health_code"] == 2
    assert res["draining"] is True
    assert res["engine_restarts"] == 1
    assert res["watchdog_trips"] == 2
    assert res["effective_max_batch"] == 2
    assert res["faults_injected"] == {}
    sup.resume()


def test_fault_counts_reach_metrics_snapshot(make_sup):
    plane = FaultPlane([FaultSpec("decode.step", at=1)])
    core, sup = make_sup(plane)
    (req,) = core.submit(_prompt(60), GenerationConfig(max_new_tokens=8))
    _drive(sup, [req])
    res = core.metrics_snapshot()["resilience"]
    assert res["faults_injected"] == {"decode.step": 1}
    assert req.state is RequestState.DONE


def test_unsupervised_core_fails_what_a_supervisor_would_replay(engine):
    """Without ``attach_recovery`` a failure ends the request (the port's
    behaviour before the supervisor): an admission fault fails it, a
    step fault fails every in-flight row."""
    plane = FaultPlane([FaultSpec("kv.alloc", at=1),
                        FaultSpec("decode.step", at=2)])
    core = EngineCore(engine, max_batch=2, max_model_len=48,
                      fault_plane=plane, device="cpu")
    try:
        g = GenerationConfig(max_new_tokens=6)
        first, second = (core.submit(_prompt(70 + i), g)[0]
                         for i in range(2))
        for _ in range(10):
            core.run_once()
        assert first.state is RequestState.FAILED
        assert isinstance(first.error, InjectedFault)
        assert second.state is RequestState.FAILED
        snap = core.metrics_snapshot()
        assert snap["failed"] == 2 and snap["resilience"][
            "request_retries"] == 0
        assert snap["kv_pool"]["used_blocks"] == 1
    finally:
        core.close()


# ------------------------------------------------- against the JAX core

SHAPE = dict(max_batch=3, max_model_len=48, token_budget=16,
             prefill_chunk=16)
BASE = np.random.RandomState(11).randint(0, 96, (20,)).astype(np.int32)


def _workload():
    """A warm-up request, then 8 requests at once: repeats of a cached
    prompt (hits whose partial tail is copied on write), a longer prompt
    sharing its pages, 2 sampled rows and unrelated prompts."""
    prompts = [BASE, _prompt(80, 12), BASE[:13], _prompt(81, 5), BASE,
               np.concatenate([BASE, _prompt(82, 6)]), _prompt(83, 9),
               BASE]
    cfgs = [dict(max_new_tokens=10) for _ in prompts]
    cfgs[3] = dict(max_new_tokens=10, do_sample=True, temperature=0.9,
                   top_k=20, seed=5)
    cfgs[6] = dict(max_new_tokens=10, do_sample=True, temperature=0.8,
                   top_p=0.9, seed=6)
    return prompts, cfgs


# fires counted on a fault-free run of ``_workload`` (the warm-up takes
# decode.step 1-4, kv.alloc / prefix.match / prefill.run 1): every
# scripted fault lands while requests are in flight, and the lose_kv
# fault last
SCRIPT = [
    {"site": "kv.alloc", "at": 3, "exc": "MemoryError"},
    {"site": "prefix.match", "at": 4},
    {"site": "prefill.run", "at": 6},
    {"site": "page.copy", "at": 2},
    {"site": "decode.step", "at": 9},
    {"site": "decode.step", "action": "nan_rows", "at": 12, "rid": 302},
    {"site": "decode.step", "at": 24, "lose_kv": True},
]


def _supervised_run(core, sup, G, rid_mod):
    rid_mod._rid_counter = itertools.count(300)
    prompts, cfgs = _workload()
    try:
        (w,) = core.submit(_prompt(79), G(max_new_tokens=4))
        _drive(sup, [w])
        reqs = [core.submit(p, G(**kw))[0] for p, kw in zip(prompts, cfgs)]
        _drive(sup, reqs, max_iters=800)
        snap = core.metrics_snapshot()
        out = {"streams": [list(r.tokens) for r in reqs],
               "states": [r.state.value for r in reqs],
               "errors": [type(r.error).__name__ for r in reqs],
               "retries": [r.retries for r in reqs],
               "steps": core._step_idx}
        res = snap["resilience"]
        out["counters"] = {k: res[k] for k in (
            "request_retries", "requests_quarantined", "engine_restarts",
            "faults_injected")}
        # JAX's snapshot nests its counters; the port's is flat
        flat = snap.get("counters", snap)
        out["counters"].update({k: flat[k] for k in ("failed",
                                                     "completed")})
        return out
    finally:
        sup.close()


def test_streams_and_counters_equal_jax(pair):
    jm, tm = pair
    kw = dict(enable_prefix_cache=True, prefix_cache_headroom_pages=8,
              **SHAPE)
    sup_kw = dict(max_retries=3, crash_threshold=10, recover_after=4,
                  backoff_base_s=0.0)
    with _pinned_globals():
        jcore = JCore(JEngine(jm, page_size=PAGE),
                      fault_plane=jfaultplane.FaultPlane.from_spec(SCRIPT),
                      **kw)
        want = _supervised_run(jcore, JSupervisor(jcore, **sup_kw), JGen,
                               jrequest)
        tcore = EngineCore(PagedGenerationEngine(tm, page_size=PAGE,
                                                 device="cpu"),
                           fault_plane=FaultPlane.from_spec(SCRIPT),
                           device="cpu", **kw)
        got = _supervised_run(tcore, EngineSupervisor(tcore, **sup_kw),
                              GenerationConfig, trequest)
    # every scripted fault fired, one row was quarantined, the rest
    # replayed to the end
    assert want["counters"]["faults_injected"] == {
        "kv.alloc": 1, "prefix.match": 1, "prefill.run": 1,
        "page.copy": 1, "decode.step": 3}
    assert want["counters"]["requests_quarantined"] == 1
    assert want["counters"]["engine_restarts"] == 1
    assert want["states"].count("done") == len(want["states"]) - 1
    for k in ("streams", "states", "errors", "retries", "counters"):
        assert got[k] == want[k], k
    # the port replays lost delivered tokens one a step
    assert got["steps"] > want["steps"]


def _port_run(model, plane, kv_dtype, cache):
    """The ``_workload`` requests on a supervised port core (a new engine
    per run); returns the streams, states and the engine."""
    trequest._rid_counter = itertools.count(300)
    eng = PagedGenerationEngine(model, page_size=PAGE, kv_dtype=kv_dtype,
                                device="cpu")
    core = EngineCore(eng, fault_plane=plane, device="cpu",
                      enable_prefix_cache=cache,
                      prefix_cache_headroom_pages=8 if cache else 0,
                      **SHAPE)
    sup = EngineSupervisor(core, max_retries=3, backoff_base_s=0.0)
    prompts, cfgs = _workload()
    try:
        (w,) = core.submit(_prompt(79), GenerationConfig(max_new_tokens=4))
        _drive(sup, [w])
        reqs = [core.submit(p, GenerationConfig(**kw))[0]
                for p, kw in zip(prompts, cfgs)]
        _drive(sup, reqs, max_iters=800)
        return ([list(r.tokens) for r in reqs],
                [r.state.value for r in reqs], core.metrics_snapshot())
    finally:
        sup.close()


@pytest.mark.parametrize("cache", [False, True], ids=["cold", "cache"])
@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["fp32", "int8"])
def test_replay_is_bitwise_within_port(model, kv_dtype, cache):
    """KV intact (a step fault before dispatch) and KV lost, greedy and
    sampled: every replayed stream EQUALS the fault-free one."""
    want, states, _ = _port_run(model, None, kv_dtype, cache)
    assert states == ["done"] * len(states)
    specs = [s for s in SCRIPT if s["site"] != "page.copy" or cache]
    specs = [s for s in specs if s.get("action") != "nan_rows"]
    got, states, snap = _port_run(model, FaultPlane.from_spec(specs),
                                  kv_dtype, cache)
    assert states == ["done"] * len(states)
    assert got == want
    res = snap["resilience"]
    assert res["engine_restarts"] == 1 and res["request_retries"] >= 4


def _fed_rows(core):
    """Record, per step, what slot 0 feeds: ``(ids[0], qlen, ctx,
    decode, sample_now)``, from the staged inputs of each mixed step."""
    rows = []
    args = EngineCore._program_args

    def recording(dev, spec_window):
        rows.append(tuple(int(dev[k][0][0] if k == "ids" else dev[k][0])
                          for k in ("ids", "qlens", "ctx", "decode",
                                    "sample_now")))
        return args(dev, spec_window)

    core._program_args = recording
    return rows


@pytest.mark.parametrize("lose_kv,cache", [(True, False), (False, True)],
                         ids=["kv-lost", "kv-intact-cache"])
def test_replay_feeds_each_token_through_its_kernel(engine, lose_kv, cache):
    """The replay's routing (what keeps it bitwise on the card, where the
    ragged and decode kernels round differently in bf16): after a KV
    loss the prompt goes back as chunk rows that sample nothing, then
    the delivered tokens as decode rows one a step, sampling only at the
    last; with the KV intact and the cache on, the row re-enters as one
    decode row that samples at once."""
    prompt = _prompt(95, 12)
    core = EngineCore(engine, max_batch=1, max_model_len=48,
                      enable_prefix_cache=cache, device="cpu",
                      fault_plane=FaultPlane([FaultSpec(
                          "decode.step", at=5, lose_kv=lose_kv)]))
    sup = EngineSupervisor(core, backoff_base_s=0.0)
    try:
        rows = _fed_rows(core)
        (req,) = core.submit(prompt, GenerationConfig(max_new_tokens=8))
        _drive(sup, [req])
    finally:
        sup.close()
    toks = req.tokens
    n = len(prompt)
    # steps 1-4 (recorded): the prompt, then 3 decode steps; the fault
    # at the fifth fire records nothing
    assert rows[0] == (prompt[0], n, 0, 0, 1)
    assert [r[:2] + r[3:] for r in rows[1:4]] == [
        (t, 1, 1, 1) for t in toks[:3]]
    replay = rows[4:]
    if lose_kv:
        assert replay[0] == (prompt[0], n, 0, 0, 0)
        assert replay[1:4] == [(t, 1, n + j, 1, 0)
                               for j, t in enumerate(toks[:3])]
        assert replay[4] == (toks[3], 1, n + 3, 1, 1)
        rest = replay[5:]
    else:
        assert replay[0] == (toks[3], 1, n + 3, 1, 1)
        rest = replay[1:]
    assert [r[:2] + r[3:] for r in rest] == [(t, 1, 1, 1)
                                             for t in toks[4:7]]
    assert req.retries == 1


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["fp32", "int8"])
def test_rebuild_kv_state_keeps_pools_in_place(model, kv_dtype):
    """Recovery marks the pools lost and zeroes them in place (int8
    scales back to the eps floor): no pool tensor moves, and the replay
    after it takes no new first call on the serve-step site."""
    eng = PagedGenerationEngine(model, page_size=PAGE, kv_dtype=kv_dtype,
                                device="cpu")
    core = EngineCore(eng, fault_plane=FaultPlane(
        [FaultSpec("decode.step", at=7, lose_kv=True)]), device="cpu",
        **SHAPE)
    sup = EngineSupervisor(core, backoff_base_s=0.0)
    log = get_compile_log()
    try:
        (w,) = core.submit(_prompt(90), GenerationConfig(max_new_tokens=3))
        _drive(sup, [w])

        def flat():
            return [t for pages in eng._k_pages + eng._v_pages
                    for t in (pages if isinstance(pages, tuple)
                              else (pages,))]

        ptrs = [t.data_ptr() for t in flat()]
        calls = log.count("serving-decode")
        post = log.summary()["post_warmup_decode_compiles"]
        restarts = []
        rebuild = eng.rebuild_kv_state

        def spy():
            assert eng.kv_state_lost()
            rebuild()
            assert not eng.kv_state_lost()
            restarts.append([t.clone() for t in flat()])

        eng.rebuild_kv_state = spy
        reqs = [core.submit(_prompt(91 + i), GenerationConfig(
            max_new_tokens=8))[0] for i in range(2)]
        _drive(sup, reqs)
        assert all(r.state is RequestState.DONE and r.retries == 1
                   for r in reqs)
        assert len(restarts) == 1
        for t in restarts[0]:
            want = (KV_SCALE_EPS if t.dtype == torch.float32
                    and kv_dtype == "int8" and t.dim() == 2 else 0)
            assert bool((t == want).all())
        assert [t.data_ptr() for t in flat()] == ptrs
        assert log.count("serving-decode") == calls
        assert log.summary()["post_warmup_decode_compiles"] == post
    finally:
        sup.close()


# ------------------------------------------------------------------- card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_replay_replays_the_captured_graph_on_card(cuda_device):
    """On the card, bf16: a supervised core replays its rows through a
    KV-intact step fault and a KV loss on the serve step's captured
    graph: streams EQUAL to the fault-free run's on the same graph, and
    no capture after warm-up."""
    cfg = dict(TINY, hidden_size=256, num_attention_heads=4,
               num_key_value_heads=4, intermediate_size=512)
    model = LlamaForCausalLM(LlamaConfig(**cfg), device=cuda_device,
                             dtype=torch.bfloat16, seed=0)
    eng = PagedGenerationEngine(model, page_size=16, device=cuda_device)
    log = get_compile_log()
    prompts, cfgs = _workload()
    cores = []

    def run(plane):
        trequest._rid_counter = itertools.count(300)
        core = EngineCore(eng, fault_plane=plane, device=cuda_device,
                          enable_prefix_cache=True,
                          prefix_cache_headroom_pages=8, **SHAPE)
        cores.append(core)
        sup = EngineSupervisor(core, max_retries=3, backoff_base_s=0.0)
        reqs = [core.submit(p, GenerationConfig(**kw))[0]
                for p, kw in zip(prompts, cfgs)]
        _drive(sup, reqs, max_iters=800)
        core.prefix_cache.clear()
        return [list(r.tokens) for r in reqs], [r.state for r in reqs]

    try:
        log.reset()
        want, states = run(None)
        assert states == [RequestState.DONE] * len(states)
        post = log.summary()["post_warmup_decode_compiles"]
        assert log.count("serving-decode") == 1
        got, states = run(FaultPlane([
            FaultSpec("decode.step", at=6),
            FaultSpec("decode.step", at=14, lose_kv=True)]))
        assert states == [RequestState.DONE] * len(states)
        assert got == want
        assert log.count("serving-decode") == 1
        assert log.summary()["post_warmup_decode_compiles"] == post == 0
    finally:
        for core in reversed(cores):
            core.close()
