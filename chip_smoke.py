#!/usr/bin/env python3
"""Drive the PyTorch port (``paddle_infer_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero.
Every serving and training step runs as a replay of one CUDA graph per
program key (``core/graphs.py``), as a user's call runs it; each graph
run is repeated under ``disable_graphs()`` (eager) and must give EQUAL
token streams or losses, and the compile log must hold one capture per
key and none after warm-up.  A kernel launched from a replay counts once
per replay, so the launch checks stay exact.

1. card — name and power limit (``nvidia-smi``), TF32 off for matmul
   and cuDNN;
2. build — the CUDA kernels (one ``nvcc`` per source, in parallel) and
   the native KV block pool, from the checkout's sources; ptxas's
   registers and spills per kernel, and the decode / verify split
   (``kSplitPages``);
3. kernels — every kernel against its plain PyTorch version at the
   serving shapes (B=8, H=32, D=128, page 16, 128 pages per row,
   contexts over 1..2048; the ragged kernel at C=512 with decode, chunk
   and inactive rows — the mix — and at the prefill-heavy case (p),
   eight 512-query chunks at contexts 0..1536; the verify kernel at W=5
   with lane lengths ctx + j + 1, every lane also EQUAL to the decode
   kernel at its length), fp32, bf16 and int8 pages, each timed with
   CUDA events (median of 25 after warm-up) beside its plain version
   and its bound; decode, verify and ragged also device-only
   (``torch.profiler``) and 25 calls back to back, beside the earlier
   designs' times (``SEQUENTIAL_WALK_MS``, ``CUDA_CORE_RAGGED_MS``), the
   ragged kernel also beside ``prefix_prefill_attention`` (the dense
   window attention it replaced on the serving path); then one
   700-token prompt through the ragged kernel chunked three ways, EQUAL
   at every position;
4. serve — LLaMA-7B at full width and depth (random bf16 weights from a
   seeded on-device generator) behind ``EngineCore``: 8 requests with
   prompts of 1536..1 tokens, 32 new tokens each, 6 greedy and 2
   sampled, driven to completion with launch counts zeroed just before
   and read just after (the decode and ragged kernels once per layer per
   step); the same run eager, its streams EQUAL, step p50 and tokens/s
   side by side; then the paged forward against the dense one on a
   small input, a profiled short run after a warm one (graph, then
   eager: the idle shares side by side), and the ragged kernel's opt-in
   single-launch entry point (``ragged_paged_attention(use_kernel=True)``)
   at the serving shapes; between them the observability checks on the
   serve run's core (its streams EQUAL to the eager run's, no capture
   after warm-up; the step log one mixed / prefill / decode record per
   step, each with ``bytes_est > 0`` and ``dispatch_s <= wall_s``, and
   one evict record per request; every trace covering >= 0.95 of its
   request; every journey's buckets summing to its e2e within 1e-9 s at
   coverage >= 0.97; the snapshot's Prometheus exposition valid with >= 5
   histogram families and a ``device_memory`` section; an evidence
   bundle whose device probe names the card), printing the records by
   kind, the decode cost model's fit (s/byte, the bandwidth it implies
   against the HBM peak, its error and correlation), the dispatch / host
   split of decode steps, the journey buckets, the exposition's size,
   the step p50 and the decode steps' ``host_s`` share of their wall;
5. spec — the same LLaMA-7B core shape with ``num_draft_tokens=4``: 8
   greedy requests plain (a), then ``speculate=True`` with an oracle
   draft source proposing run (a)'s streams (b: streams equal to (a),
   every draft accepted), then ``speculate=True`` with ngram drafts on
   tiled prompts, 2 of 8 requests sampled (c: greedy streams equal to a
   plain run of the same prompts), each run also eager with EQUAL
   streams; the verify kernel launches once per layer per step in (b)
   and (c), the ragged kernel once per layer per step in every run; a
   profiled speculative run, graph and eager;
6. prefix — the same model with ``enable_prefix_cache=True``
   (``prefix_cache_headroom_pages=128``): a 1024-token shared prompt
   plus 8 distinct suffixes of 1..511 tokens, 32 new tokens each, 6
   greedy and 2 sampled; each core first serves the first prompt twice
   (4 new tokens, request ids of their own: the graphs are captured
   there, and with the cache the repeat copies a partial tail page on
   write, as the first request does again later); the 8 on a core
   without the cache (cold) and on one with it (warm), on graphs and
   eager: every stream EQUAL to the cold graph
   run's, each warm request hitting at least 64 pages, a page copied,
   one capture per key (serve step, page copy) and none after warm-up,
   the decode and ragged kernels once per layer per step; TTFT p50 and
   prefill tokens warm against cold;
7. resilience — the prefix phase's 8 prompts (32 new tokens, 2 sampled)
   on the same model behind ``EngineSupervisor(watchdog_s=1.0,
   max_retries=3)`` over a core with the prefix cache: once with no
   faults after a warm-up request, then on a fresh core over the same
   engine (so on the captured graph) under a fault script
   (``resilience_script``: a step fault with the KV intact, a
   MemoryError at an admission, a raise at the prefix lookup, the
   prefill site and the page copy, one poisoned row, a step slower than
   the watchdog, last a step fault that loses the KV); every stream not
   quarantined EQUAL to its fault-free one, exactly the poisoned row
   quarantined, the watchdog tripped, one engine restart, the batch
   halved and grown back, the pool back to its free blocks, no capture
   after warm-up, the decode and ragged kernels once per layer per
   clean step (a failed step launches nothing); the faulted core's step
   log one failed record per failed step and per failed admission and a
   failed evict per failed request, a ``recovery`` span per replay, its
   exposition valid with ``engine_restarts_total 1`` and the plane's
   ``faults_injected_total`` counts; the counters, both walls and step
   counts, and the time of ``rebuild_kv_state`` (64 pools zeroed in
   place);
8. int8 — the same model on ``kv_dtype="int8"`` pools: the serve
   phase's 8 requests on graphs and eager (streams EQUAL; decode and
   ragged launches exact on int8 pages; pool bytes, step p50 and
   tokens/s beside the bf16 serve run), paged vs dense logits at int8,
   the prefix phase at int8, ngram speculation on tiled prompts against
   int8 plain (greedy streams EQUAL, verify once per layer per step,
   again eager), the page writer alone at the serving shapes (bf16
   against int8, eager and as a graph replay, the round trip within
   ``kv_dequant_error_bound``) and a profiled int8 run whose groups
   hold the writes' scatters (``kv_write``);
9. generate — the engines' own entry points on the same model (bf16,
   page 16): ``PagedGenerationEngine.generate`` greedy on 4 right-padded
   prompts of 1024, 700, 129 and 17 tokens, 32 new tokens each, with
   scores (a warm-up call captures each key's graph, then the call on
   replays), EQUAL to ``stream(chunk_size=8)`` and to the call under
   ``disable_graphs()``; seeded sampling (top-k 50, top-p 0.9,
   temperature 0.8, repetition penalty 1.1), ``generate`` EQUAL to
   ``stream``; beam search (4 beams, 16 new tokens, the first two
   prompts: fewer pages than unshared beams, finite scores); greedy on
   int8 pools; for every call the decode kernel once per layer per
   decode step and the flash forward kernel once per layer per prefill,
   and no capture after each key's first call; prefill ms, decode step
   p50 graph against eager and tokens/s; the dense ``GenerationEngine``
   greedy at full depth, its first-step logits within 5 % of the logit
   scale of the paged engine's; then a beam ``generate`` of that dense
   engine through ``EngineCore.submit_exclusive`` while 4 batch rows
   decode: its value EQUAL to the direct call, the batch streams EQUAL
   to a run without it;
10. gpt — the LLaMA model freed, ``gpt3-6.7b`` at full width and depth
   (random bf16 weights) serves 8 requests with ngram speculation (the
   ragged kernel once per layer per step), again eager with EQUAL
   streams, then its paged forward against its dense one;
11. train — GPT freed: (1) the flash kernels (forward, dK/dV, dQ) against
   their plain versions at (a) the ERNIE shape B=32, H=12, S=512, D=64
   with 10 % trailing padding as segment ids, dropout 0.1 and 0, fp32
   and bf16, (b) B=2, H=32, S=4096, D=128 causal bf16, (c) Sq=256 <
   Sk=512 causal, (d) B=4, H=8, S=2000, D=256 causal with padding,
   timed at (a), (b) and (d) beside the plain version, the bound and
   SDPA, each kernel also beside the earlier mma.sync design's times
   (``MMA_SYNC_FWD_MS``, ``MMA_SYNC_BWD_MS``) and held bit-equal across
   two launches, the forward and SDPA's forward also device-only
   (``torch.profiler``, and 25 calls back to back), and
   ``hybrid_attention`` against ``flash_attention`` at (a);
   (2) ERNIE-3.0-base pretraining at full width and depth through
   ``FleetTrainStep`` (batch 32 x 512, dropout 0.1, AMP O2 bf16, AdamW
   lr 1e-4): 2 warm-up and 20 timed steps, the loss falling and each
   flash kernel launched once per layer per step, then two profiled
   steps — on the graph, then all again eager from the same state, the
   20 losses EQUAL (the kernels use no atomics); (3) ERNIE-3.0-mini (12
   heads of 32, a head_dim the flash kernels do not take): 3 steps on
   plain attention, every loss finite and no flash launch; (4) eager,
   one step at depth 2, batch 8 with the kernels against the same step
   with plain attention, fp32 and O2, on three batches;
12. the kernels line (one JSON object; the paged kernels' and the
    flash forward's launches summed over the runs in
    ``launches_by_run``), the card line, and last ``{"ok": true,
    "device": {...}}``.

Without a card, or without the repository beside it, it exits non-zero
before printing any result.  It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import gc
import itertools
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np

PEAK_BYTES_S = 3.35e12                 # H100 SXM HBM3
PEAK_OPS_S = {"fp32": 67e12, "bf16": 989e12, "int8": 989e12}
TOL = {"fp32": 1e-4, "bf16": 2e-2, "int8": 2e-2}
PROMPT_LENS = (1536, 1024, 700, 512, 257, 128, 33, 1)
SAMPLED = (2, 5)                       # request indices that sample
MAX_NEW = 32
# spec phase: shorter prompts, so decode steps dominate the run
SPEC_PROMPT_LENS = (512, 384, 256, 200, 128, 64, 33, 8)
NUM_DRAFT = 4
# prefix phase: a shared prompt, then suffixes past it (some not a
# multiple of the page, 16), the first prompt also served once before
PREFIX_LEN = 1024
PREFIX_SUFFIXES = (200, 511, 1, 16, 37, 100, 263, 64)
PREFIX_HEADROOM = 128                  # prefix_cache_headroom_pages
PRIMER_RID = 900
PRIMER_NEW = 4
# the scatters of the KV page writers (index_put for the payload,
# scatter_reduce for an int8 pool's scales): the profile's kv_write group
KV_WRITE_KERNELS = ("index_put", "scatter_gather")


# the ragged kernel's tolerance against its plain version (atol = rtol):
# 16-bit p in the tensor-core P V and the 16-bit output's own rounding
RAGGED_TOL = {"fp32": 1e-4, "bf16": 1e-2, "int8": 1e-2}
# the prefill-heavy ragged case "(p)": every row a 512-query chunk, at
# these contexts (the last pair reaching the 2048-slot window's end)
PREFILL_CTX = (0, 512, 1024, 1536, 0, 512, 1024, 1536)
# CUDA-event medians of the earlier ragged kernel (one block per 16
# queries, f32 tiles, scalar dot products; now the fp32 path) at the
# mix of phase 3 and at (p) on an NVIDIA H100 80GB HBM3 at 700 W,
# printed beside the redesigned kernel's times: {(case, pages): ms}
CUDA_CORE_RAGGED_MS = {("mix", "bf16"): 3.9093, ("mix", "fp32"): 3.8235,
                       ("mix", "int8"): 4.1808, ("p", "bf16"): 13.1159,
                       ("p", "fp32"): 12.5832, ("p", "int8"): 14.0240}

# CUDA-event medians of the earlier decode and verify kernels (one block
# per (row, head) walking all of the row's pages in order, one page at a
# time) at the serving shapes of phase 3 on an NVIDIA H100 80GB HBM3 at
# 700 W, printed beside the split kernels' times: {(kernel, pages): ms}
SEQUENTIAL_WALK_MS = {("paged_decode", "bf16"): 0.4074,
                      ("paged_decode", "fp32"): 0.6711,
                      ("paged_decode", "int8"): 0.3321,
                      ("paged_verify", "bf16"): 1.1578,
                      ("paged_verify", "fp32"): 1.8010,
                      ("paged_verify", "int8"): 0.9982}


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except OSError as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def clocks_line() -> str:
    """The card's SM and memory clocks, their maxima, power draw and
    temperature now: times from different calls compare only at equal
    clocks."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,clocks.mem,"
         "clocks.max.mem,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout else "none"


def print_ptxas(tag, log):
    """ptxas's registers, spills and performance warnings per kernel from
    an ``nvcc -Xptxas -v`` log."""
    fn = "?"
    for line in log.splitlines():
        m = re.search(r"([a-z]+(?:_[a-z]+)*_kernel(?:_[a-z0-9]+)?)"
                      r"I(\w+?)EEv", line)
        if "Compiling entry" in line and m:
            fn = f"{m.group(1)}<{m.group(2)}>"
        elif ("registers" in line or "spill" in line
              or "Performance Loss" in line):
            print(f"{tag} {fn}: {line.strip()}", flush=True)


def time_ms(fn, reps=25, warmup=3):
    """Median wall of one call on the device, from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps=25, name=None):
    """Device-only time of one call, read from ``torch.profiler`` over
    ``reps`` calls: the mean device time of each kernel they launch (only
    those whose name holds ``name``, when given), summed over kernels,
    each taken to launch once a call.  Means, not totals over ``reps``: a
    trace can lose the first calls' kernels (one kept 16 of 25).  Returns
    (ms, the fewest launches of a kernel the trace kept).  No host work
    between launches counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ms, seen = 0.0, reps
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or (
                name is not None and name not in e.key) or not e.count:
            continue
        t = getattr(e, "self_device_time_total", None)
        t = t if t is not None else getattr(e, "self_cuda_time_total", 0.0)
        ms += t / 1e3 / e.count
        seen = min(seen, e.count)
    return ms, seen


def stream_ms(fn, reps=25):
    """One call's share of ``reps`` calls issued back to back between two
    CUDA events: the host prepares the next launch while the device runs
    the last, so host work shows only where it outlasts the kernel."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


# ---------------------------------------------------------------- phase 3

def make_case(device, B=8, H=32, D=128, page=16, max_pages=128, C=512,
              W=NUM_DRAFT + 1, seed=1):
    """Serving-shaped inputs: one fp32 pool, per-row page tables over
    distinct pages, decode contexts spread over 1..max_len, a ragged
    batch mixing chunk, decode and inactive rows, and W-lane verify
    queries with lane lengths ctx + j + 1 over ctx in 1..max_len-W."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    max_len = max_pages * page
    P = B * max_pages + 1
    kp = torch.randn(P, H, page, D, generator=g, device=device)
    vp = torch.randn(P, H, page, D, generator=g, device=device)
    perm = torch.randperm(P - 1, generator=g, device=device)
    tables = perm[:B * max_pages].reshape(B, max_pages).int().contiguous()
    fr = np.linspace(0.0, 1.0, B)
    lengths = np.maximum(1, np.round(fr * max_len)).astype(np.int32)
    lengths[0] = 1
    q = torch.randn(B, H, D, generator=g, device=device)
    # ragged rows: chunk at 0, chunk mid-context, chunk at the window
    # edge, three decode rows, two inactive
    rows = [(0, min(C, max_len)), (max_len // 2, min(C, max_len // 4)),
            (max_len - 100, 100), (5, 1), (max_len // 3, 1),
            (max_len - 1, 1), (0, 0), (max_len // 7, 0)]
    rows = (rows * ((B + len(rows) - 1) // len(rows)))[:B]
    ctx = torch.tensor([r[0] for r in rows], dtype=torch.int32,
                       device=device)
    qlens = torch.tensor([min(r[1], C) for r in rows], dtype=torch.int32,
                         device=device)
    qc = torch.randn(B, C, H, D, generator=g, device=device)
    qv = torch.randn(B, W, H, D, generator=g, device=device)
    vctx = np.round(np.linspace(1, max_len - W, B)).astype(np.int32)
    vlens = vctx[:, None] + np.arange(W, dtype=np.int32)[None] + 1
    return dict(kp=kp, vp=vp, tables=tables, q=q, qc=qc, qv=qv, ctx=ctx,
                qlens=qlens, lengths=torch.tensor(lengths, device=device),
                vlens=torch.tensor(vlens, device=device).contiguous(),
                H=H, D=D, page=page)


def _cast(case, kind):
    """(q, qc, qv, k_pages, v_pages, plain k, plain v) for one page
    type; the plain version gets float32 copies of the SAME stored
    pages."""
    import torch

    from paddle_infer_tpu_torch.ops import paged_attention as PA

    if kind == "fp32":
        return case["q"], case["qc"], case["qv"], case["kp"], case["vp"], \
            case["kp"], case["vp"]
    q, qc, qv = (case[n].to(torch.bfloat16) for n in ("q", "qc", "qv"))
    if kind == "bf16":
        kp, vp = case["kp"].to(torch.bfloat16), case["vp"].to(torch.bfloat16)
        return q, qc, qv, kp, vp, kp.float(), vp.float()
    kq, vq = PA.quantize_pages(case["kp"]), PA.quantize_pages(case["vp"])
    return q, qc, qv, kq, vq, kq, vq


def _bytes_decode(case, kind, lengths):
    itemsize = {"fp32": 4, "bf16": 2, "int8": 1}[kind]
    qsize = 4 if kind == "fp32" else 2
    H, D = case["H"], case["D"]
    toks = int(lengths.sum())
    byts = 2 * toks * H * D * itemsize + 2 * len(lengths) * H * D * qsize
    if kind == "int8":
        pages = int(np.ceil(lengths / case["page"]).sum())
        byts += 2 * pages * H * 4
    flops = 4 * toks * H * D
    return byts, flops


def _bytes_verify(case, kind, vlens):
    """The longest lane's pages of K and V once (every lane reads a
    prefix of them), their scales, q and out; 4 FLOPs per (lane, slot,
    head, dim)."""
    itemsize = {"fp32": 4, "bf16": 2, "int8": 1}[kind]
    qsize = 4 if kind == "fp32" else 2
    H, D = case["H"], case["D"]
    last = vlens[:, -1]
    byts = 2 * int(last.sum()) * H * D * itemsize + 2 * vlens.size * H * D \
        * qsize
    if kind == "int8":
        byts += 2 * int(np.ceil(last / case["page"]).sum()) * H * 4
    flops = 4 * H * D * int(vlens.sum())
    return byts, flops


def _bytes_ragged(case, kind, ctx, qlens, C):
    itemsize = {"fp32": 4, "bf16": 2, "int8": 1}[kind]
    qsize = 4 if kind == "fp32" else 2
    H, D = case["H"], case["D"]
    active = qlens > 0
    kv_toks = int((ctx + qlens)[active].sum())
    byts = (2 * kv_toks * H * D * itemsize + int(qlens.sum()) * H * D * qsize
            + len(qlens) * C * H * D * qsize)
    if kind == "int8":
        pages = int(np.ceil((ctx + qlens)[active] / case["page"]).sum())
        byts += 2 * pages * H * 4
    # causal work: query i of a row sees ctx + i + 1 slots
    seen = int((qlens * ctx + qlens * (qlens + 1) // 2).sum())
    flops = 4 * seen * H * D
    return byts, flops


def _bound(byts, flops, kind):
    t_b = byts / PEAK_BYTES_S * 1e3
    t_o = flops / PEAK_OPS_S[kind] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def paged_times(name, run):
    """A split kernel's CUDA-event median (host work of the wrapper
    included), its device-only time (``torch.profiler``: split walk and
    combine summed, a mean per launch) and 25 calls back to back, all
    measured in this run."""
    dev, seen = device_ms(run, name=name)
    return {"ms": time_ms(run), "device_ms": dev, "device_calls": seen,
            "stream_ms": stream_ms(run)}


def paged_line_times(name, kind, rec, keys):
    """The ``[kernels]`` line's times: the record's, then the earlier
    sequential-walk design's (``SEQUENTIAL_WALK_MS``), which is printed
    only and never enters the record."""
    times = [f"{k}={rec[k]:.4f}" for k in keys if k in rec]
    if "ms" in rec:
        times.append(f"sequential_walk_ms="
                     f"{SEQUENTIAL_WALK_MS[(name, kind)]:.4f}")
    return " ".join(times)


def check_verify(case, kinds=("fp32", "bf16", "int8"), timed=True):
    """The verify kernel: every lane EQUAL to the decode kernel at its
    length (the greedy-parity invariant), and allclose to the plain
    version.  Returns ``{kind: record}``; raises on a disagreement."""
    import torch

    from paddle_infer_tpu_torch.ops import paged_attention as PA

    tables, vlens = case["tables"], case["vlens"]
    vl = vlens.cpu().numpy().astype(np.int64)
    out = {}
    for kind in kinds:
        _, _, qv, kp, vp, kp_ref, vp_ref = _cast(case, kind)
        tol = TOL[kind]
        ver = PA.paged_attention_verify(qv, kp, vp, tables, vlens)
        lanes = [(qv[:, w].contiguous(), vlens[:, w].contiguous())
                 for w in range(qv.shape[1])]
        lanes_equal = all(
            torch.equal(ver[:, w], PA.paged_attention_decode(
                ql, kp, vp, tables, ll)) for w, (ql, ll) in enumerate(lanes))
        ref = PA._verify_plain(qv.float(), kp_ref, vp_ref, tables, vlens)
        err = float((ver.float() - ref).abs().max())
        ok = lanes_equal and bool(torch.allclose(ver.float(), ref, atol=tol,
                                                 rtol=tol))
        rec = {"max_abs_err": err, "lanes_equal_decode": lanes_equal,
               "tol": tol, "ok": ok}
        if timed:
            run = lambda: PA.paged_attention_verify(qv, kp, vp, tables,
                                                    vlens)
            rec.update(paged_times("paged_verify", run))
            rec["plain_ms"] = time_ms(lambda: PA._verify_plain(
                qv, kp, vp, tables, vlens), reps=10)
            # the W separate decode launches the kernel stands in for
            rec["decode_x_w_ms"] = time_ms(lambda: [
                PA.paged_attention_decode(ql, kp, vp, tables, ll)
                for ql, ll in lanes])
            rec["bound_ms"], rec["bound_by"] = _bound(
                *_bytes_verify(case, kind, vl), kind)
        out[kind] = rec
        print(f"[kernels] paged_verify {kind} W={qv.shape[1]}: "
              f"max_abs_err={err:.3e} lanes_equal_decode={lanes_equal} "
              f"tol={tol} ok={ok} " + paged_line_times(
                  "paged_verify", kind, rec,
                  ("ms", "device_ms", "stream_ms", "plain_ms",
                   "decode_x_w_ms", "bound_ms"))
              + (f" clocks: {clocks_line()}" if timed else ""), flush=True)
    bad = [k for k, v in out.items() if not v["ok"]]
    if bad:
        raise AssertionError(f"paged_verify disagrees (lanes vs decode or "
                             f"vs plain) for {bad}")
    return out


def prefill_case(case):
    """``case`` with every ragged row a chunk of C queries at
    ``PREFILL_CTX`` (cut to the case's window): the prefill-heavy case
    (p)."""
    import torch

    C = case["qc"].shape[1]
    window = case["tables"].shape[1] * case["page"]
    cx = [min(c, max(0, window - C))
          for c in PREFILL_CTX][:case["qc"].shape[0]]
    dev = case["qc"].device
    return dict(case, ctx=torch.tensor(cx, dtype=torch.int32, device=dev),
                qlens=torch.full((len(cx),), min(C, window),
                                 dtype=torch.int32, device=dev))


def check_ragged(case, kinds=("fp32", "bf16", "int8"), timed=True,
                 tag="mix"):
    """The ragged kernel against its plain version (``RAGGED_TOL``) on the
    case's ragged rows, pads zero, a qlen == 1 row against the decode
    kernel at ctx + 1.  With ``timed``: CUDA-event median, device-only
    time (``torch.profiler``) and 25 calls back to back, beside the plain
    version, ``prefix_prefill_attention`` (the dense fp32 window attention
    the serving step ran for chunk rows until the kernel took them) and
    the bound.  Returns ``{kind: record}``; raises on a disagreement."""
    import torch

    from paddle_infer_tpu_torch.ops import paged_attention as PA
    from paddle_infer_tpu_torch.ops import ragged_paged_attention as RPA

    tables, ctx, qlens = case["tables"], case["ctx"], case["qlens"]
    C = case["qc"].shape[1]
    cx = ctx.cpu().numpy().astype(np.int64)
    ql = qlens.cpu().numpy().astype(np.int64)
    valid = (torch.arange(C, device=qlens.device)[None]
             < qlens[:, None].long())
    out = {}
    for kind in kinds:
        _, qc, _, kp, vp, kp_ref, vp_ref = _cast(case, kind)
        tol = RAGGED_TOL[kind]
        rag = RPA.ragged_kernel(qc, kp, vp, tables, ctx, qlens)
        ref = RPA._ragged_plain(qc.float(), kp_ref, vp_ref, tables, ctx,
                                qlens)
        err = float((rag.float() - ref)[valid].abs().max())
        ok = bool(torch.allclose(rag.float()[valid], ref[valid], atol=tol,
                                 rtol=tol)) and not bool(rag[~valid].any())
        rec = {"max_abs_err": err, "tol": tol}
        one = qlens == 1
        if bool(one.any()):
            # a qlen == 1 row must match the decode kernel at ctx + 1
            dec1 = PA.paged_attention_decode(qc[:, 0].contiguous(), kp, vp,
                                             tables, (ctx + 1).int())
            rec["decode_row_err"] = float(
                (rag[:, 0].float() - dec1.float())[one].abs().max())
            ok = ok and rec["decode_row_err"] <= TOL[kind]
        rec["ok"] = ok
        if timed:
            run = lambda: RPA.ragged_kernel(qc, kp, vp, tables, ctx, qlens)
            rec["ms"] = time_ms(run)
            rec["device_ms"], rec["device_calls"] = device_ms(
                run, name="ragged_paged")
            rec["stream_ms"] = stream_ms(run)
            rec["plain_ms"] = time_ms(lambda: RPA._ragged_plain(
                qc, kp, vp, tables, ctx, qlens), reps=10)
            rec["prefix_prefill_ms"] = time_ms(
                lambda: PA.prefix_prefill_attention(qc, kp, vp, tables, ctx),
                reps=10)
            rec["bound_ms"], rec["bound_by"] = _bound(
                *_bytes_ragged(case, kind, cx, ql, C), kind)
        out[kind] = rec
        old_ms = CUDA_CORE_RAGGED_MS.get((tag, kind))
        print(f"[kernels] ragged_paged_attention ({tag}) {kind}: "
              + " ".join(f"{k}={v:.4e}" if k.endswith("err") else
                         f"{k}={v:.4f}" if isinstance(v, float) else
                         f"{k}={v}" for k, v in rec.items())
              + (f" cuda_core_ms={old_ms:.4f}" if timed and old_ms else "")
              + (f" clocks: {clocks_line()}" if timed else ""), flush=True)
    bad = [k for k, v in out.items() if not v["ok"]]
    if bad:
        raise AssertionError(f"ragged kernel ({tag}) disagrees with its "
                             f"plain version for {bad}")
    return out


CHUNKINGS = ((700,), (100, 600), (333, 367))


def check_chunk_independence(device, kinds=("bf16", "int8", "fp32"), H=32,
                             D=128):
    """One prompt of ``sum(CHUNKINGS[0])`` tokens through the ragged
    kernel, taken as one chunk and as the chunks of each of
    ``CHUNKINGS``: each chunk in its own batch of 4 rows (the prompt in
    a different row each time, the other rows with their own tables,
    contexts and lengths) and a C of its own.  Raises unless every
    chunking gives EQUAL outputs at every position; returns ``{kind:
    True}``."""
    import torch

    from paddle_infer_tpu_torch.ops import ragged_paged_attention as RPA

    n, B, page = sum(CHUNKINGS[0]), 4, 16
    g = torch.Generator(device=device)
    g.manual_seed(5)
    max_pages = -(-n // page) + 3
    window = max_pages * page
    P = B * max_pages + 1
    case = dict(kp=torch.randn(P, H, page, D, generator=g, device=device),
                vp=torch.randn(P, H, page, D, generator=g, device=device))
    perm = torch.randperm(P - 1, generator=g, device=device)
    tables = perm[:B * max_pages].reshape(B, max_pages).int()
    prompt_q = torch.randn(n, H, D, generator=g, device=device)
    res = {}
    for kind in kinds:
        _, _, _, kp, vp, _, _ = _cast(dict(case, q=prompt_q, qc=prompt_q,
                                           qv=prompt_q), kind)
        qdt = torch.float32 if kind == "fp32" else torch.bfloat16
        outs = []
        for ci, chunks in enumerate(CHUNKINGS):
            got, start = [], 0
            for j, m in enumerate(chunks):
                C = m + 29 * j + ci
                row = (ci + j) % B
                tb = tables.roll(row, 0).contiguous()    # the prompt: row
                ctx = torch.randint(0, window - C, (B,), generator=g,
                                    device=device).int()
                ql = torch.randint(0, C + 1, (B,), generator=g,
                                   device=device).int()
                ctx[row], ql[row] = start, m
                qc = torch.randn(B, C, H, D, generator=g, device=device)
                qc[row, :m] = prompt_q[start:start + m]
                out = RPA.ragged_kernel(qc.to(qdt), kp, vp, tb,
                                        ctx.contiguous(), ql.contiguous())
                got.append(out[row, :m])
                start += m
            outs.append(torch.cat(got))
        res[kind] = all(torch.equal(outs[0], o) for o in outs[1:])
        ways = " / ".join("+".join(map(str, c)) for c in CHUNKINGS)
        print(f"[kernels] ragged chunk independence {kind}: a {n}-token "
              f"prompt as {ways}: equal={res[kind]}", flush=True)
    if not all(res.values()):
        raise AssertionError(f"ragged outputs depend on the chunking: {res}")
    return res


def check_kernels(case, kinds=("fp32", "bf16", "int8"), timed=True):
    """Each kernel against its plain version on the same inputs.
    Returns ``{kernel: {kind: record}}``; raises on a disagreement."""
    import torch

    from paddle_infer_tpu_torch.ops import paged_attention as PA

    tables, lengths = case["tables"], case["lengths"]
    ln = lengths.cpu().numpy().astype(np.int64)
    results = {"paged_decode": {},
               "ragged_paged_attention": check_ragged(case, kinds, timed)}
    for kind in kinds:
        q, _, _, kp, vp, kp_ref, vp_ref = _cast(case, kind)
        tol = TOL[kind]

        dec = PA.paged_attention_decode(q, kp, vp, tables, lengths)
        ref = PA._decode_plain(q.float(), kp_ref, vp_ref, tables, lengths)
        err = float((dec.float() - ref).abs().max())
        ok = bool(torch.allclose(dec.float(), ref, atol=tol, rtol=tol))
        byts, flops = _bytes_decode(case, kind, ln)
        rec = {"max_abs_err": err, "tol": tol, "ok": ok}
        if timed:
            rec.update(paged_times("paged_decode", lambda: (
                PA.paged_attention_decode(q, kp, vp, tables, lengths))))
            rec["plain_ms"] = time_ms(lambda: PA._decode_plain(
                q, kp, vp, tables, lengths), reps=10)
            rec["bound_ms"], rec["bound_by"] = _bound(byts, flops, kind)
        results["paged_decode"][kind] = rec
        print(f"[kernels] paged_decode {kind}: max_abs_err={err:.3e} "
              f"tol={tol} ok={ok} " + paged_line_times(
                  "paged_decode", kind, rec,
                  ("ms", "device_ms", "stream_ms", "plain_ms", "bound_ms"))
              + (f" clocks: {clocks_line()}" if timed else ""), flush=True)

    bad = [(n, k) for n, r in results.items() for k, v in r.items()
           if not v["ok"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain "
                             f"versions: {bad}")
    results["paged_verify"] = check_verify(case, kinds, timed)
    return results


# ---------------------------------------------------------------- phase 4

def build_llama(device, config=None, dtype=None, seed=0):
    import torch

    from paddle_infer_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    config = config or LlamaConfig.from_preset("llama-7b")
    return LlamaForCausalLM(config, device=device,
                            dtype=dtype or torch.bfloat16, seed=seed)


def eager():
    """``disable_graphs()``: every step eager inside the block — the only
    way the port runs a step eagerly on the card; the reference side of
    each graph-against-eager check."""
    from paddle_infer_tpu_torch.core.graphs import disable_graphs

    return disable_graphs()


def make_core(model, device, max_model_len=2048, token_budget=512,
              page_size=16, max_batch=8, kv_dtype=None, **core_kw):
    """An ``EngineCore`` over a new engine for ``model`` (its pools int8
    with ``kv_dtype="int8"``); ``core_kw`` goes to EngineCore
    (speculation, the prefix cache)."""
    from paddle_infer_tpu_torch.inference.generation import \
        PagedGenerationEngine
    from paddle_infer_tpu_torch.serving import EngineCore

    engine = PagedGenerationEngine(model, page_size=page_size,
                                   kv_dtype=kv_dtype, device=device)
    return EngineCore(engine, max_batch=max_batch,
                      max_model_len=max_model_len, token_budget=token_budget,
                      prefill_chunk=token_budget, device=device, **core_kw)


def free_memory():
    """Collect garbage (engines hold reference cycles) and return the
    caching allocator's free blocks, so a phase starts on a clear card."""
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def pool_bytes(engine) -> int:
    """Bytes of the engine's K and V pools, every layer (payload and
    scales of an int8 pool)."""
    flat = [t for pages in engine._k_pages + engine._v_pages
            for t in (pages if isinstance(pages, tuple) else (pages,))]
    return sum(t.numel() * t.element_size() for t in flat)


def drive(core, prompts, max_new, sampled, rid_start):
    """Submit one request per prompt (those in ``sampled`` sampling, the
    rest greedy), request ids from ``rid_start`` (each sampled stream is
    keyed by its rid), and run the core until all are done; returns
    ``(requests, wall seconds)``."""
    import torch

    from paddle_infer_tpu_torch.inference.generation import \
        GenerationConfig
    from paddle_infer_tpu_torch.serving import request as trequest

    trequest._rid_counter = itertools.count(rid_start)
    reqs = []
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        g = (GenerationConfig(max_new_tokens=max_new, do_sample=True,
                              temperature=0.8, top_k=50, top_p=0.95,
                              seed=1234)
             if i in sampled else GenerationConfig(max_new_tokens=max_new))
        reqs += core.submit(p, g)
    for _ in range(2000):
        if all(r.done for r in reqs):
            break
        core.run_once()
    if core._engine.device.type == "cuda":
        torch.cuda.synchronize()
    return reqs, time.perf_counter() - t0


def serve(model, device, prompt_lens=PROMPT_LENS, max_new=MAX_NEW,
          prompts=None, sampled=SAMPLED, rid_start=1, **core_kw):
    """Serve one request per prompt length (or per given prompt) through
    EngineCore (``core_kw`` to ``make_core``), on graphs unless inside
    ``eager()``.  Returns the run's numbers.  Raises if a request fails,
    a stream is off, a step's logits are not finite, or the compile log
    shows other than one event for the run's one program key or any
    after warm-up."""
    import torch

    from paddle_infer_tpu_torch.core.graphs import graphs_enabled
    from paddle_infer_tpu_torch.observability import get_compile_log
    from paddle_infer_tpu_torch.serving import RequestState

    vocab = model.config.vocab_size
    log = get_compile_log()
    log.reset()
    core = make_core(model, device, **core_kw)
    engine = core._engine
    # every step ANDs its rows' finiteness into one device flag: a graph
    # replays the check with the step, and nothing syncs until the end
    finite = torch.ones((), dtype=torch.bool, device=device)
    step = engine._model_step

    def checked_step(params, ids, pos, caches):
        logits, new = step(params, ids, pos, caches)
        qlens = caches[0][4]
        rows = torch.arange(ids.shape[0], device=ids.device)
        last = logits[rows, torch.clamp(qlens.long() - 1, min=0)]
        finite.logical_and_((torch.isfinite(last).all(dim=-1)
                             | (qlens <= 0)).all())
        return logits, new

    engine._model_step = checked_step
    if prompts is None:
        rs = np.random.RandomState(0)
        prompts = [rs.randint(0, vocab, (n,)).astype(np.int32)
                   for n in prompt_lens]
    graphs = graphs_enabled(device)
    try:
        reqs, wall = drive(core, prompts, max_new, sampled, rid_start)
        nbytes = pool_bytes(engine)
        # the core's records, read before close (the observability
        # phase's input); the snapshot probes the card's allocator
        obs = {"steplog": core.steplog, "tracer": core.tracer,
               "journeys": core._journeys, "metrics": core.metrics,
               "snapshot": core.metrics_snapshot(),
               "compile_summary": log.summary()}
    finally:
        core.close()
        # the wrapper closes over the engine (a cycle): drop it and
        # collect, so this engine's pools leave the card now
        del engine._model_step
        free_memory()
    bad = [(r.rid, r.state.value, repr(r.error)) for r in reqs
           if r.state != RequestState.DONE]
    if bad:
        raise AssertionError(f"requests not DONE: {bad}")
    for r in reqs:
        toks = np.asarray(r.tokens)
        if len(toks) != max_new or toks.min() < 0 or toks.max() >= vocab:
            raise AssertionError(f"request {r.rid}: bad stream {toks}")
    if not bool(finite):
        raise AssertionError("non-finite last-position logits in a step")
    events = log.events("serving-decode")
    summary = log.summary()
    if len(events) != 1 or summary["post_warmup_decode_compiles"]:
        raise AssertionError(
            f"compile log: {len(events)} serving-decode events (keys "
            f"{sorted({repr(e.key) for e in events})}), "
            f"{summary['post_warmup_decode_compiles']} after warm-up; want "
            "exactly one for the run's one key and none after")
    gen = sum(len(r.tokens) for r in reqs)
    spec = obs["snapshot"]["speculation"]
    return {"steps": core._step_idx, "wall_s": wall,
            "generated_tokens": gen, "tokens_per_s": gen / wall,
            "ttft_s": [r.first_token_at - r.arrival for r in reqs],
            "step_ms": [t["wall_s"] * 1e3 for t in core.step_trace],
            "drafts_proposed": spec["drafts_proposed"],
            "drafts_accepted": spec["drafts_accepted"],
            "graphs": graphs, "captures": len(events) if graphs else 0,
            "capture_wall_s": events[0].wall_s,
            "post_warmup_captures": summary["post_warmup_decode_compiles"],
            "pool_bytes": nbytes, "rids": [r.rid for r in reqs],
            "obs": obs,
            "prompts": prompts, "streams": [list(r.tokens) for r in reqs]}


@contextlib.contextmanager
def plain_attention():
    """``sdpa`` forced to its plain version (``_xla_sdpa``) inside the
    block: the reference side of a kernel-against-plain check."""
    from paddle_infer_tpu_torch.ops import attention as A

    choice = A._attn_impl_choice
    A._attn_impl_choice = lambda q, k, mask: "xla"
    try:
        yield
    finally:
        A._attn_impl_choice = choice


@contextlib.contextmanager
def quantized_kv(page):
    """Inside the block, dense attention reads K and V as the int8 pools
    hold them: each ``page``-token page quantized under the slot-0 scale
    protocol (``quantize_pages``) and dequantized — the dense side of
    the int8 paged-vs-dense check."""
    import torch

    from paddle_infer_tpu_torch.nn import functional as PF
    from paddle_infer_tpu_torch.ops import paged_attention as PA

    def fake(x):
        b, s, h, d = x.shape
        n = -(-s // page)
        pad = x.new_zeros(b, n * page - s, h, d)
        pages = (torch.cat([x, pad], dim=1).reshape(b * n, page, h, d)
                 .permute(0, 2, 1, 3))
        deq = PA.dequantize_pages(PA.quantize_pages(pages))
        return (deq.permute(0, 2, 1, 3).reshape(b, n * page, h, d)[:, :s]
                .to(x.dtype))

    sdpa = PF.scaled_dot_product_attention
    PF.scaled_dot_product_attention = \
        lambda q, k, v, *a, **kw: sdpa(q, fake(k), fake(v), *a, **kw)
    try:
        yield
    finally:
        PF.scaled_dot_product_attention = sdpa


def reference_check(model, device, n_prompt=33, n_decode=4, page=16,
                    tol=5e-2, kv_dtype=None):
    """The paged ragged forward (one prompt chunk, then decode steps)
    against the dense causal forward of the same model on the same
    tokens, its attention the plain version: max |logit difference|
    relative to the logits' magnitude.  ``kv_dtype="int8"`` runs the
    paged side on int8 pools and the dense side on the same quantized K
    and V (``quantized_kv``); the distance to the unquantized dense
    logits — the protocol's own error — is printed beside."""
    import torch

    from paddle_infer_tpu_torch.ops.paged_attention import KV_SCALE_EPS

    cfg = model.config
    L, H = cfg.num_hidden_layers, cfg.num_attention_heads
    D = cfg.hidden_size // H
    n = n_prompt + n_decode
    max_pages = -(-n // page)
    P = max_pages + 1
    dtype = next(model.parameters()).dtype
    rs = np.random.RandomState(1)
    ids = torch.tensor(rs.randint(0, cfg.vocab_size, (1, n)),
                       device=device)
    tables = torch.arange(max_pages, dtype=torch.int32,
                          device=device)[None].contiguous()
    scratch = torch.tensor(P - 1, dtype=torch.int32, device=device)
    def pool():
        if kv_dtype != "int8":
            return torch.zeros(P, H, page, D, dtype=dtype, device=device)
        return (torch.zeros(P, H, page, D, dtype=torch.int8, device=device),
                torch.full((P, H), KV_SCALE_EPS, device=device))

    pools = [(pool(), pool()) for _ in range(L)]
    with torch.inference_mode():
        with plain_attention():
            dense = model(ids).float()
            if kv_dtype == "int8":
                fp_dense = dense
                with quantized_kv(page):
                    dense = model(ids).float()
        got = []
        for start, qn in [(0, n_prompt)] + [(n_prompt + i, 1)
                                            for i in range(n_decode)]:
            ctx = torch.tensor([start], dtype=torch.int32, device=device)
            ql = torch.tensor([qn], dtype=torch.int32, device=device)
            caches = [(k, v, tables, ctx, ql, scratch) for k, v in pools]
            pos = ctx[:, None] + torch.arange(qn, device=device)[None]
            logits, _ = model(ids[:, start:start + qn], position_ids=pos,
                              caches=caches)
            got.append(logits.float())
        paged = torch.cat(got, dim=1)
    scale = float(dense.abs().max())
    err = float((paged - dense).abs().max())
    ok = err <= tol * scale
    raw = ("" if kv_dtype != "int8" else
           f" (against unquantized dense K/V: max_abs_err="
           f"{float((paged - fp_dense).abs().max()):.4e})")
    print(f"[reference] paged ({kv_dtype or 'model dtype'} pages) vs dense "
          f"logits ({n_prompt}-token chunk + "
          f"{n_decode} decode steps): max_abs_err={err:.4e} "
          f"logit_scale={scale:.4e} rel_tol={tol} ok={ok}{raw}", flush=True)
    if not ok:
        raise AssertionError("paged forward disagrees with dense forward")
    return err, scale


def _profile_rows(prof):
    """(self device ms, calls, name) of every device-side event."""
    import torch

    rows = []
    for e in prof.key_averages():
        # device-side events only: host ops report their kernels' time
        # as their own too
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t > 0:
            rows.append((t / 1e3, e.count, e.key))
    return rows


def profile_serving(model, device, prompt_lens=(512, 1), max_new=4,
                    top=12, tag="plain", prompts=None, sampled=SAMPLED,
                    **core_kw):
    """Where a steady serving step's device time goes: one core serves
    the prompts once (its graph captured there), then again under
    ``torch.profiler`` (one chunk step, then decode steps, replays
    only); prints the device busy share of that run's wall and the top
    kernels by self device time, grouped also into matmul /
    attention-kernel / other.  Returns the run's numbers."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_infer_tpu_torch.observability import get_compile_log
    from paddle_infer_tpu_torch.serving import RequestState

    vocab = model.config.vocab_size
    if prompts is None:
        rs = np.random.RandomState(0)
        prompts = [rs.randint(0, vocab, (n,)).astype(np.int32)
                   for n in prompt_lens]
    # a new engine: its capture is not a recompile of an earlier one's
    get_compile_log().reset()
    core = make_core(model, device, **core_kw)
    try:
        warm, _ = drive(core, prompts, max_new, sampled, rid_start=1)
        steps0 = core._step_idx
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            reqs, wall = drive(core, prompts, max_new, sampled,
                               rid_start=1)
        steps = core._step_idx - steps0
    finally:
        core.close()
        del core
        free_memory()
    bad = [(r.rid, r.state.value, repr(r.error)) for r in warm + reqs
           if r.state != RequestState.DONE]
    if bad:
        raise AssertionError(f"profiled requests not DONE: {bad}")
    res = print_profile(prof, wall, f"{tag}: {len(prompts)} requests, "
                        f"{steps} steps", top)
    return dict(res, steps=steps)


def print_profile(prof, wall_s, what, top):
    """Print a profiled run's device busy time against its wall, the
    idle share, the device time by group (matmul, each attention
    kernel, the KV writes, other) and the top kernels; returns the
    numbers."""
    rows = _profile_rows(prof)
    busy_ms = sum(r[0] for r in rows)
    wall_ms = wall_s * 1e3
    # a paged kernel's group holds its split walk and its combine
    groups = {"matmul": 0.0, "ragged_paged": 0.0, "paged_decode": 0.0,
              "paged_verify": 0.0, "flash_fwd": 0.0, "kv_write": 0.0,
              "other": 0.0}
    for ms, _, name in rows:
        low = name.lower()
        if "ragged_paged" in name:
            groups["ragged_paged"] += ms
        elif "paged_decode_" in name:
            groups["paged_decode"] += ms
        elif "paged_verify_" in name:
            groups["paged_verify"] += ms
        elif "flash_fwd" in name:
            groups["flash_fwd"] += ms
        elif any(s in low for s in ("gemm", "xmma", "cutlass", "nvjet",
                                    "matmul", "mm_")):
            groups["matmul"] += ms
        elif any(s in low for s in KV_WRITE_KERNELS):
            groups["kv_write"] += ms
        else:
            groups["other"] += ms
    idle = max(0.0, 1 - busy_ms / wall_ms)
    print(f"[profile] {what}: wall_ms={wall_ms:.1f} "
          f"device_busy_ms={busy_ms:.1f} idle_share={idle:.3f} groups_ms="
          + json.dumps({k: round(v, 3) for k, v in groups.items()}),
          flush=True)
    for ms, n, name in sorted(rows, reverse=True)[:top]:
        print(f"[profile] {ms:10.3f} ms {n:6d} calls  {name[:110]}",
              flush=True)
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle_share": idle,
            "groups": groups}


def profile_pair(model, device, tag, card, **kw):
    """``profile_serving`` on graphs, then eager; one line side by
    side."""
    g = profile_serving(model, device, tag=f"{tag} graph", **kw)
    with eager():
        e = profile_serving(model, device, tag=f"{tag} eager", **kw)
    print(f"[profile] {tag} graph vs eager ({card}): idle_share "
          f"graph={g['idle_share']:.3f} eager={e['idle_share']:.3f} "
          f"wall_ms_per_step graph={g['wall_ms'] / g['steps']:.2f} "
          f"eager={e['wall_ms'] / e['steps']:.2f} busy_ms_per_step "
          f"graph={g['busy_ms'] / g['steps']:.2f} "
          f"eager={e['busy_ms'] / e['steps']:.2f}", flush=True)
    return g, e


# ---------------------------------------------------------------- phase 5

class OracleDrafts:
    """Draft source proposing each request's continuation from a known
    stream (found by its prompt), so every greedy draft is accepted."""

    name = "oracle"
    deterministic = True

    def __init__(self, prompts, streams):
        self._pairs = [(np.asarray(p), list(t))
                       for p, t in zip(prompts, streams)]

    def propose(self, history, k, salt=None, deterministic_only=False):
        h = np.asarray(history)
        for p, t in self._pairs:
            if h.size >= p.size and np.array_equal(h[:p.size], p):
                return t[h.size - p.size:h.size - p.size + k]
        return []


def tiled_prompts(vocab, lens, seed):
    """Prompts that repeat a short random pattern, so ngram drafts fire."""
    rs = np.random.RandomState(seed)
    return [np.tile(rs.randint(0, vocab, (m,)), -(-n // m))[:n]
            .astype(np.int32) for n, m in zip(lens, (4, 5, 6, 7, 3, 4, 5, 2))]


def serve_counted(model, device, tag, **kw):
    """``serve`` with every launch count zeroed just before and read just
    after; prints the run's line."""
    from paddle_infer_tpu_torch.ops import _build

    for k in _build.KERNELS.values():
        k.launches = 0
    st = serve(model, device, **kw)
    st["launches"] = {n: k.launches for n, k in _build.KERNELS.items()}
    print(f"[{tag}] steps={st['steps']} wall_s={st['wall_s']:.3f} "
          f"generated={st['generated_tokens']} "
          f"tokens_per_s={st['tokens_per_s']:.2f} "
          f"step_ms_p50={_p50_after_first(st):.1f} "
          f"drafts_proposed={st['drafts_proposed']} "
          f"drafts_accepted={st['drafts_accepted']} "
          f"graphs={st['graphs']} captures={st['captures']} "
          f"post_warmup_captures={st['post_warmup_captures']} "
          f"launches={st['launches']}", flush=True)
    return st


def _p50_after_first(st):
    """Step p50 over the steps after the first (which captures)."""
    return float(np.median(st["step_ms"][1:] or st["step_ms"]))


def eager_twin(model, device, tag, graph_run, card, **kw):
    """The run of ``graph_run`` again under ``eager()``: raises unless
    every stream is ``torch.equal`` to the graph run's; prints the two
    side by side.  Returns the eager run."""
    import torch

    with eager():
        e = serve_counted(model, device, f"{tag} eager", **kw)
    g = graph_run
    for i, (a, b) in enumerate(zip(g["streams"], e["streams"])):
        if not torch.equal(torch.tensor(a), torch.tensor(b)):
            raise AssertionError(f"{tag}: request {i}'s graph stream differs "
                                 f"from its eager stream:\n{a}\n{b}")
    print(f"[{tag}] graph vs eager ({card}): step_ms_p50 "
          f"graph={_p50_after_first(g):.2f} eager={_p50_after_first(e):.2f} "
          f"tokens_per_s graph={g['tokens_per_s']:.2f} "
          f"eager={e['tokens_per_s']:.2f} captures={g['captures']} "
          f"capture_wall_s={g['capture_wall_s']:.3f} "
          f"post_warmup_captures={g['post_warmup_captures']} "
          f"streams_equal=True ({len(g['streams'])} requests)", flush=True)
    return e


def _check_decode_launches(st, L, tag):
    """Decode rows ride the decode kernel: one launch a layer a step."""
    n = st["launches"]["paged_decode"]
    if n != L * st["steps"]:
        raise AssertionError(f"{tag}: paged_decode launched {n} times in "
                             f"{st['steps']} steps (want {L} per step)")


def _check_ragged_launches(st, L, tag):
    """Chunk rows ride the ragged kernel: one launch a layer a step."""
    n = st["launches"]["ragged_paged_attention"]
    if n != L * st["steps"]:
        raise AssertionError(f"{tag}: ragged_paged_attention launched {n} "
                             f"times in {st['steps']} steps (want {L} per "
                             "step)")


def _check_verify_launches(st, L, tag):
    """Under speculation every step verifies: one launch a layer a
    step."""
    n = st["launches"]["paged_verify"]
    if n != L * st["steps"]:
        raise AssertionError(f"{tag}: paged_verify launched {n} times in "
                             f"{st['steps']} steps (want {L} per step)")


# ------------------------------------------------------- observability

STEP_KINDS = ("mixed", "prefill", "decode")


def _p50(xs):
    return float(np.median(xs)) if xs else float("nan")


def check_journeys(journeys, rids, tag):
    """Every journey of ``rids`` partitions its e2e wall exactly: the
    attribution buckets, recomputed unrounded from the store's intervals,
    sum to the journey's window within 1e-9 s, and its coverage is at
    least 0.97."""
    from paddle_infer_tpu_torch.observability.journey import attribute

    for rid in rids:
        summary = journeys.get(rid)
        j = journeys._find(rid)
        traces = journeys._traces(j)
        begin, finish = journeys._window(j, traces)
        buckets = attribute(journeys._intervals(j, traces, begin, finish),
                            begin, finish)
        gap = abs(sum(buckets.values()) - (finish - begin))
        if gap > 1e-9 or summary["coverage"] < 0.97:
            raise AssertionError(
                f"{tag}: journey {rid} buckets sum {gap:.3g} s off its "
                f"e2e, coverage {summary['coverage']} (want <= 1e-9, "
                ">= 0.97)")


def observability_phase(st, reference_streams, card):
    """The serve run's records (``serve``'s ``obs``): raises unless its
    streams EQUAL ``reference_streams`` (the eager run's), no capture
    followed warm-up, the step log holds one mixed / prefill / decode
    record per step (each with ``bytes_est > 0`` and ``dispatch_s <=
    wall_s``) and one evict record per request, every trace covers at
    least 0.95 of its request, every journey partitions its e2e, the
    snapshot's exposition validates with at least five histogram
    families, and the evidence bundle's device probe names the card.
    Prints the records by kind, the decode cost model's fit, the
    dispatch / host split of decode steps, the journey buckets, the
    exposition's size, the step p50 and the decode steps' ``host_s``
    share."""
    import tempfile

    import torch

    from paddle_infer_tpu_torch.observability import (capture_bundle,
                                                      family_names,
                                                      validate_exposition)

    t0 = time.perf_counter()
    obs = st["obs"]
    if st["streams"] != reference_streams:
        raise AssertionError("observability: the serve streams differ from "
                             "the eager run's")
    if st["post_warmup_captures"]:
        raise AssertionError(f"observability: {st['post_warmup_captures']} "
                             "captures after warm-up")
    recs = obs["steplog"].records()
    steps = [r for r in recs if r["kind"] in STEP_KINDS]
    evicts = [r for r in recs if r["kind"] == "evict"]
    if len(steps) != st["steps"] or len(evicts) != len(st["rids"]):
        raise AssertionError(
            f"observability: {len(steps)} step records for {st['steps']} "
            f"steps, {len(evicts)} evict records for {len(st['rids'])} "
            "requests")
    bad = [r["seq"] for r in steps
           if not (r["bytes_est"] > 0 and r["dispatch_s"] <= r["wall_s"])]
    if bad:
        raise AssertionError(f"observability: step records {bad} lack "
                             "bytes_est > 0 or dispatch_s <= wall_s")
    for rid in st["rids"]:
        tr = obs["tracer"].get(rid)
        if tr is None or tr.state != "done" or tr.coverage() < 0.95:
            raise AssertionError(
                f"observability: request {rid}'s trace "
                f"{None if tr is None else (tr.state, tr.coverage())}; "
                "want done with coverage >= 0.95")
    check_journeys(obs["journeys"], st["rids"], "observability")
    snap = obs["snapshot"]
    text = obs["metrics"].to_prometheus(snap, obs["compile_summary"])
    problems = validate_exposition(text)
    n_hist = sum(1 for ln in text.splitlines()
                 if ln.startswith("# TYPE") and ln.endswith(" histogram"))
    if problems or n_hist < 5:
        raise AssertionError(f"observability: exposition problems "
                             f"{problems[:5]}, {n_hist} histogram families")
    if not snap.get("device_memory", {}).get("bytes_limit"):
        raise AssertionError("observability: no device_memory section")
    with tempfile.TemporaryDirectory() as out:
        manifest = capture_bundle(
            out, snapshot=snap, core=type("Recorded", (), {
                "steplog": obs["steplog"], "tracer": obs["tracer"]})())
        with open(f"{out}/device_probe.json") as f:
            probe = json.load(f)
    if ("manifest.json" not in manifest["files"]
            or probe.get("device_kind") != torch.cuda.get_device_name(0)):
        raise AssertionError(f"observability: bundle {manifest}, probe "
                             f"{probe}")
    summary = obs["steplog"].summary()
    model = summary["decode_model"]
    scale = model["scale_s_per_byte"]
    decode = [r for r in steps if r["kind"] == "decode"]
    buckets = obs["journeys"].summary()["bucket_seconds"]
    kinds = json.dumps(summary["by_kind"], sort_keys=True)
    print(f"[observability] records {kinds} steps={st['steps']} requests="
          f"{len(st['rids'])} bytes_est_total={summary['bytes_est_total']:.4g}"
          f" cost_source={sorted({r['cost_source'] for r in steps})}",
          flush=True)
    print(f"[observability] decode model ({card}): n={model['n']} "
          f"scale_s_per_byte={scale:.6g} implied_GB_s="
          f"{1e-9 / scale:.1f} (HBM peak {PEAK_BYTES_S / 1e9:.0f}) "
          f"mean_abs_rel_err={model['mean_abs_rel_err']:.4f} "
          f"pearson_r={model['pearson_r']}", flush=True)
    print(f"[observability] decode steps ({card}): dispatch_s_p50="
          f"{_p50([r['dispatch_s'] for r in decode]):.6f} host_s_p50="
          f"{_p50([r['host_s'] for r in decode]):.6f} wall_s_p50="
          f"{_p50([r['wall_s'] for r in decode]):.6f} "
          f"(n={len(decode)})", flush=True)
    print("[observability] journey buckets_s " + " ".join(
        f"{b}={v:.4f}" for b, v in buckets.items() if v) + " coverage="
        f"{obs['journeys'].summary()['attribution_coverage']}", flush=True)
    print(f"[observability] exposition {len(text)} bytes, "
          f"{len(family_names(text))} families ({n_hist} histograms), "
          f"device_memory={json.dumps(snap['device_memory'], sort_keys=True)}"
          f" bundle_files={len(manifest['files'])}", flush=True)
    # host_s holds the step's bookkeeping after its readback, the
    # recording included: its share of the step's wall is what the
    # recording can cost the card, which idles through it
    host_share = (sum(r["host_s"] for r in decode)
                  / max(sum(r["wall_s"] for r in decode), 1e-12))
    print(f"[observability] serve step_ms_p50={_p50_after_first(st):.2f} "
          f"decode host_s_share={host_share:.5f} ({card}); phase took "
          f"{time.perf_counter() - t0:.2f}s", flush=True)


def check_resilience_records(core, plane, reqs, tag):
    """The faulted core's records: one failed step record per failed
    step (a raise at ``decode.step``) and one failed ``prefill`` record
    per failed admission (a fault at any admission site), a failed
    evict per failed request, a ``recovery`` span per replay of every
    replayed request, and an exposition that validates with
    ``engine_restarts_total 1`` and the plane's ``faults_injected_total``
    counts."""
    from paddle_infer_tpu_torch.observability import (get_compile_log,
                                                      validate_exposition)
    from paddle_infer_tpu_torch.serving import RequestState

    recs = core.steplog.records()
    counts = plane.counts()
    raises = sum(sp["fired"] for sp in plane.specs_snapshot()
                 if sp["site"] == "decode.step" and sp["action"] == "raise")
    admission = sum(n for site, n in counts.items()
                    if site != "decode.step")
    failed_steps = [r for r in recs if r["failed"] and r["chunk_steps"]]
    failed_admits = [r for r in recs if r["failed"]
                     and r["kind"] == "prefill" and not r["chunk_steps"]]
    failed_evicts = [r for r in recs if r["failed"] and r["kind"] == "evict"]
    n_failed = sum(r.state == RequestState.FAILED for r in reqs)
    if (len(failed_steps) != raises or len(failed_admits) != admission
            or len(failed_evicts) != n_failed):
        raise AssertionError(
            f"{tag}: {len(failed_steps)} failed step records for "
            f"{raises} failed steps, {len(failed_admits)} failed "
            f"admission records for {admission} admission faults, "
            f"{len(failed_evicts)} failed evicts for {n_failed} failed "
            "requests")
    for r in reqs:
        n = sum(s.name == "recovery" for s in core.tracer.get(r.rid).spans)
        if n != r.retries:
            raise AssertionError(f"{tag}: request {r.rid} has {n} recovery "
                                 f"spans for {r.retries} replays")
    snap = core.metrics_snapshot()
    text = core.metrics.to_prometheus(snap, get_compile_log().summary())
    problems = validate_exposition(text)
    lines = set(text.splitlines())
    want = {"engine_restarts_total 1"} | {
        f'faults_injected_total{{site="{site}"}} {n}'
        for site, n in counts.items()}
    if problems or not want <= lines:
        raise AssertionError(f"{tag}: exposition problems {problems[:5]}, "
                             f"missing {sorted(want - lines)}")
    print(f"[{tag}] records: failed steps={len(failed_steps)} failed "
          f"admissions={len(failed_admits)} failed evicts="
          f"{len(failed_evicts)} recovery spans="
          f"{sum(r.retries for r in reqs)} exposition ok "
          f"({' '.join(sorted(want))})", flush=True)


def spec_phase(model, device, card=""):
    """Runs (a) plain, (b) oracle speculation, (c) ngram speculation on
    tiled prompts with 2 sampled rows and its plain twin, each on graphs
    and again eager; raises unless (b) equals (a) with every draft
    accepted, (c)'s greedy streams equal its plain twin's, and every
    graph run's streams equal its eager run's."""
    L = model.config.num_hidden_layers
    vocab = model.config.vocab_size
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, vocab, (n,)).astype(np.int32)
               for n in SPEC_PROMPT_LENS]
    spec = dict(speculate=True, num_draft_tokens=NUM_DRAFT)
    tiled = tiled_prompts(vocab, SPEC_PROMPT_LENS, seed=4)
    runs, eager_runs = {}, {}
    plan = [("a", "spec a plain", dict(prompts=prompts, sampled=())),
            ("b", "spec b oracle", None),
            ("c_plain", "spec c plain", dict(prompts=tiled)),
            ("c", "spec c ngram", dict(prompts=tiled, draft_source="ngram",
                                       **spec))]
    for name, tag, kw in plan:
        if kw is None:          # the oracle proposes run (a)'s streams
            kw = dict(prompts=prompts, sampled=(), draft_source=OracleDrafts(
                prompts, runs["a"]["streams"]), **spec)
        runs[name] = serve_counted(model, device, tag, **kw)
        eager_runs[name] = eager_twin(model, device, tag, runs[name], card,
                                      **kw)
    if runs["b"]["streams"] != runs["a"]["streams"]:
        raise AssertionError("oracle-speculative greedy streams differ "
                             "from plain ones")
    if not (runs["b"]["drafts_accepted"] == runs["b"]["drafts_proposed"]
            > 0):
        raise AssertionError(f"oracle drafts: {runs['b']['drafts_accepted']}"
                             f" of {runs['b']['drafts_proposed']} accepted")
    greedy = [i for i in range(len(tiled)) if i not in SAMPLED]
    if any(runs["c"]["streams"][i] != runs["c_plain"]["streams"][i]
           for i in greedy):
        raise AssertionError("ngram-speculative greedy streams differ from "
                             "plain ones")
    for tag in ("b", "c"):
        _check_verify_launches(runs[tag], L, f"spec {tag}")
    for tag, st in runs.items():
        _check_ragged_launches(st, L, f"spec {tag}")
    runs["eager"] = eager_runs
    return runs


# ---------------------------------------------------------------- phase 6

def prefix_prompts(vocab, seed=7):
    """The shared ``PREFIX_LEN``-token prompt plus one distinct suffix
    per ``PREFIX_SUFFIXES`` length."""
    rs = np.random.RandomState(seed)
    shared = rs.randint(0, vocab, (PREFIX_LEN,))
    return [np.concatenate([shared, rs.randint(0, vocab, (n,))])
            .astype(np.int32) for n in PREFIX_SUFFIXES]


def prefix_run(model, device, prompts, warm, tag, **core_kw):
    """One core, with the prefix cache when ``warm``, primed by serving
    ``prompts[0]`` twice under request ids of their own (so the serve
    step's graph, and with the cache the page copy's, are captured
    before the measured run, whose TTFTs then hold no capture); then the
    prompts served with every launch count zeroed just before and read
    just after.
    Raises unless every request is DONE with a full stream and the
    compile log holds one event per key (the serve step; the page copy
    when a page was copied) and none after warm-up.  Returns the run's
    numbers: streams, TTFTs, prefill tokens computed, per-request hit
    pages (admission order), the cache's counters, launches."""
    from paddle_infer_tpu_torch.observability import get_compile_log
    from paddle_infer_tpu_torch.ops import _build
    from paddle_infer_tpu_torch.serving import RequestState

    log = get_compile_log()
    log.reset()
    kw = dict(core_kw)
    if warm:
        kw.update(enable_prefix_cache=True,
                  prefix_cache_headroom_pages=PREFIX_HEADROOM)
    core = make_core(model, device, **kw)
    hits = []
    if warm:
        stage = core._stage_prefix

        def recording(sid, match, length, max_new):
            out = stage(sid, match, length, max_new)
            hits.append(len(match.blocks))
            return out

        core._stage_prefix = recording
    try:
        primer = []
        for i in range(2):
            primer += drive(core, prompts[:1], PRIMER_NEW, (),
                            PRIMER_RID + i)[0]
        steps0, trace0 = core._step_idx, len(core.step_trace)
        for k in _build.KERNELS.values():
            k.launches = 0
        reqs, wall = drive(core, prompts, MAX_NEW, SAMPLED, rid_start=1)
        launches = {n: k.launches for n, k in _build.KERNELS.items()}
        steps = core._step_idx - steps0
        prefill = sum(t["prefill_tokens"] for t in core.step_trace[trace0:])
        snap = core.metrics_snapshot()
    finally:
        core.close()
        del core
        free_memory()
    bad = [(r.rid, r.state.value, repr(r.error)) for r in primer + reqs
           if r.state != RequestState.DONE
           or len(r.tokens) != (PRIMER_NEW if r in primer else MAX_NEW)]
    if bad:
        raise AssertionError(f"{tag}: requests not DONE in full: {bad}")
    decode_events = log.events("serving-decode")
    copy_events = log.events("serving-serve-page-copy")
    cache = snap.get("prefix_cache") or {}
    want_copy = 1 if cache.get("cow_copies") else 0
    post = log.summary()["post_warmup_decode_compiles"]
    if len(decode_events) != 1 or len(copy_events) != want_copy or post:
        raise AssertionError(
            f"{tag}: compile log {len(decode_events)} serve-step and "
            f"{len(copy_events)} page-copy events, {post} after warm-up; "
            f"want 1, {want_copy} and 0")
    ttft = [r.first_token_at - r.arrival for r in reqs]
    st = {"streams": [list(r.tokens) for r in reqs], "ttft_s": ttft,
          "steps": steps, "wall_s": wall, "prefill_tokens": prefill,
          "hits": hits[len(primer):], "cache": cache,
          "launches": launches}
    print(f"[{tag}] steps={steps} wall_s={wall:.3f} "
          f"prefill_tokens={prefill} ttft_p50_s="
          f"{float(np.median(ttft)):.4f} hit_pages={st['hits']} "
          f"cow_copies={cache.get('cow_copies', 0)} "
          f"captures serve-step={len(decode_events)} "
          f"page-copy={len(copy_events)} post_warmup={post} "
          f"launches={launches}", flush=True)
    return st


def prefix_phase(model, device, card, kv_dtype=None):
    """Warm against cold: the ``prefix_prompts`` on a core without the
    cache (cold) and on one with it, primed (warm), on graphs and again
    eager.  Raises unless every warm and eager stream EQUALS the cold
    graph run's, each warm request hit at least ``PREFIX_LEN / 16``
    pages, a page was copied on write, and the decode and ragged
    kernels launched once per layer per step.  Returns the runs."""
    L = model.config.num_hidden_layers
    name = f"prefix {kv_dtype or 'bf16'}"
    prompts = prefix_prompts(model.config.vocab_size)
    kw = dict(kv_dtype=kv_dtype)
    runs = {"cold": prefix_run(model, device, prompts, False,
                               f"{name} cold", **kw),
            "warm": prefix_run(model, device, prompts, True,
                               f"{name} warm", **kw)}
    with eager():
        runs["cold eager"] = prefix_run(model, device, prompts, False,
                                        f"{name} cold eager", **kw)
        runs["warm eager"] = prefix_run(model, device, prompts, True,
                                        f"{name} warm eager", **kw)
    want = runs["cold"]["streams"]
    for tag, st in runs.items():
        for i, (a, b) in enumerate(zip(want, st["streams"])):
            if not np.array_equal(np.asarray(a), np.asarray(b)):
                raise AssertionError(f"{name}: request {i}'s {tag} stream "
                                     f"differs from cold:\n{a}\n{b}")
        _check_decode_launches(st, L, f"{name} {tag}")
        _check_ragged_launches(st, L, f"{name} {tag}")
    for tag in ("warm", "warm eager"):
        st = runs[tag]
        if len(st["hits"]) != len(prompts) or min(st["hits"]) < \
                PREFIX_LEN // 16 or not st["cache"]["cow_copies"]:
            raise AssertionError(f"{name} {tag}: hit pages {st['hits']}, "
                                 f"{st['cache']['cow_copies']} copies on "
                                 "write")
    w, c = runs["warm"], runs["cold"]
    print(f"[{name}] warm vs cold ({card}): streams_equal=True "
          f"(graph and eager, {len(prompts)} requests) ttft_p50_s "
          f"warm={float(np.median(w['ttft_s'])):.4f} "
          f"cold={float(np.median(c['ttft_s'])):.4f} prefill_tokens "
          f"warm={w['prefill_tokens']} cold={c['prefill_tokens']} steps "
          f"warm={w['steps']} cold={c['steps']} cow_copies="
          f"{w['cache']['cow_copies']} hit_rate={w['cache']['hit_rate']:.3f}",
          flush=True)
    return runs


# ---------------------------------------------------------------- phase 7

RES_RID = 1000              # the resilience runs' first request id
RES_WATCHDOG_S = 1.0
RES_NAN = 3                 # the request whose row the script poisons


def resilience_script(rid0=RES_RID):
    """The faulted run's script, by per-site fire count on its own core
    (admissions fire ``kv.alloc``, ``prefix.match`` and ``prefill.run``;
    every mixed step fires ``decode.step``): a step fault with the KV
    intact, a MemoryError at an admission, one raise each at the prefix
    lookup, the prefill site and the page copy (a KV-intact replay
    copies its matched tail on write), one poisoned row, a step slower
    than the watchdog, and last a step fault that loses the KV."""
    from paddle_infer_tpu_torch.serving import FaultSpec

    return [FaultSpec("decode.step", at=5),
            FaultSpec("kv.alloc", at=3, exc="MemoryError"),
            FaultSpec("prefill.run", at=4),
            FaultSpec("prefix.match", at=6),
            FaultSpec("page.copy", at=1),
            FaultSpec("decode.step", action="nan_rows", at=12,
                      rid=rid0 + RES_NAN),
            FaultSpec("decode.step", action="latency", at=15,
                      delay_s=1.5 * RES_WATCHDOG_S),
            FaultSpec("decode.step", at=20, lose_kv=True)]


def _check_resilience_launches(st, L, tag):
    """Every clean step launches the decode and ragged kernels once a
    layer; a step that failed at its fault site launched nothing."""
    _check_decode_launches(st, L, tag)
    _check_ragged_launches(st, L, tag)


def resilience_run(core, sup, prompts, sampled, max_new, rid0):
    """Drive ``prompts`` through the supervised core from request id
    ``rid0``, with every launch count zeroed just before and read just
    after; returns the run's numbers (the effective batch after every
    supervised step among them)."""
    import torch

    from paddle_infer_tpu_torch.inference.generation import \
        GenerationConfig
    from paddle_infer_tpu_torch.ops import _build
    from paddle_infer_tpu_torch.serving import request as trequest

    trequest._rid_counter = itertools.count(rid0)
    for k in _build.KERNELS.values():
        k.launches = 0
    steps0 = core._step_idx
    reqs = []
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        g = (GenerationConfig(max_new_tokens=max_new, do_sample=True,
                              temperature=0.8, top_k=50, top_p=0.95,
                              seed=1234)
             if i in sampled else GenerationConfig(max_new_tokens=max_new))
        reqs += core.submit(p, g)
    eff = []
    for _ in range(4000):
        if all(r.done for r in reqs):
            break
        sup.run_once()
        eff.append(core.effective_max_batch)
    if core._engine.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not all(r.done for r in reqs):
        raise AssertionError("resilience: requests did not finish")
    return {"reqs": reqs, "wall_s": wall, "steps": core._step_idx - steps0,
            "launches": {n: k.launches for n, k in _build.KERNELS.items()},
            "effective": eff, "snap": core.metrics_snapshot()}


def resilience_phase(model, device, card, max_new=MAX_NEW,
                     sampled=SAMPLED, script=resilience_script):
    """Replay through failures on the serve path: the ``prefix_prompts``
    on a supervised core with the prefix cache, once with no faults
    (after a warm-up request that captures the serve step's graph, its
    retained pages then dropped) and
    once under ``script()`` on a fresh core over the same engine (the
    first core idle, its cache cleared), which replays the captured
    graphs.  Raises unless every request not quarantined finishes with a
    stream EQUAL to its fault-free one, exactly the poisoned row is
    quarantined, the watchdog tripped, one engine restart, the ladder
    halved the batch and grew it back to full, the pool's free blocks
    return to their baseline, no capture followed warm-up, and the
    faulted run's decode and ragged launches equal its clean steps'
    (the two failed steps launched nothing).  Returns the runs."""
    import torch

    from paddle_infer_tpu_torch.observability import get_compile_log
    from paddle_infer_tpu_torch.serving import (EngineCore,
                                                EngineSupervisor,
                                                FaultPlane,
                                                QuarantinedError,
                                                RequestState)

    L = model.config.num_hidden_layers
    prompts = prefix_prompts(model.config.vocab_size)
    sup_kw = dict(watchdog_s=RES_WATCHDOG_S, max_retries=3,
                  backoff_base_s=0.0, recover_after=4)
    cache_kw = dict(enable_prefix_cache=True,
                    prefix_cache_headroom_pages=PREFIX_HEADROOM)
    log = get_compile_log()
    log.reset()
    clean_core = make_core(model, device, **cache_kw)
    eng = clean_core._engine
    cores = [clean_core]
    rebuilds = []
    rebuild = eng.rebuild_kv_state

    def timed_rebuild():
        sync = eng.device.type == "cuda"
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        rebuild()
        if sync:
            torch.cuda.synchronize()
        rebuilds.append(time.perf_counter() - t0)

    eng.rebuild_kv_state = timed_rebuild
    try:
        sup = EngineSupervisor(clean_core, **sup_kw)
        baseline = clean_core._pool.free_blocks
        warm = resilience_run(clean_core, sup, prompts[:1], (), PRIMER_NEW,
                              PRIMER_RID)
        # both runs start from an empty cache, so their step counts
        # differ by what the replays cost
        clean_core.prefix_cache.clear()
        clean = resilience_run(clean_core, sup, prompts, sampled, max_new,
                               RES_RID)
        clean_core.prefix_cache.clear()
        clean_free = clean_core._pool.free_blocks
        post0 = log.summary()["post_warmup_decode_compiles"]
        events0 = len(log.events("serving-decode"))
        plane = FaultPlane(script())
        faulted_core = EngineCore(eng, max_batch=8, max_model_len=2048,
                                  token_budget=512, prefill_chunk=512,
                                  fault_plane=plane, device=device,
                                  **cache_kw)
        cores.append(faulted_core)
        fsup = EngineSupervisor(faulted_core, **sup_kw)
        faulted = resilience_run(faulted_core, fsup, prompts, sampled,
                                 max_new, RES_RID)
        check_resilience_records(faulted_core, plane, faulted["reqs"],
                                 "resilience")
        faulted_core.prefix_cache.clear()
        faulted_free = faulted_core._pool.free_blocks
        post = log.summary()["post_warmup_decode_compiles"] - post0
        captures = len(log.events("serving-decode")) - events0
        nbytes = pool_bytes(eng)
        n_pools = len(eng._k_pages) + len(eng._v_pages)
    finally:
        for core in reversed(cores):
            core.close()
        del eng.rebuild_kv_state
        free_memory()

    bad = [(r.rid, r.state.value, repr(r.error))
           for r in warm["reqs"] + clean["reqs"]
           if r.state != RequestState.DONE]
    if bad:
        raise AssertionError(f"resilience: fault-free requests not DONE: "
                             f"{bad}")
    quarantined = {r.rid for r in faulted["reqs"]
                   if r.state == RequestState.FAILED
                   and isinstance(r.error, QuarantinedError)}
    if quarantined != {RES_RID + RES_NAN}:
        raise AssertionError(f"resilience: quarantined {quarantined}, want "
                             f"{{{RES_RID + RES_NAN}}}")
    for i, (a, b) in enumerate(zip(clean["reqs"], faulted["reqs"])):
        if b.rid in quarantined:
            if b.tokens != a.tokens[:len(b.tokens)]:
                raise AssertionError(f"resilience: request {i} delivered "
                                     "a wrong token before its quarantine")
            continue
        if b.state != RequestState.DONE or not np.array_equal(
                np.asarray(a.tokens), np.asarray(b.tokens)):
            raise AssertionError(
                f"resilience: request {i} ({b.state.value}, "
                f"{b.error!r}) differs from its fault-free stream:\n"
                f"{a.tokens}\n{b.tokens}")
    res = faulted["snap"]["resilience"]
    want_faults = {"decode.step": 4, "kv.alloc": 1, "prefix.match": 1,
                   "prefill.run": 1, "page.copy": 1}
    if res["faults_injected"] != want_faults:
        raise AssertionError(f"resilience: faults injected "
                             f"{res['faults_injected']}, want {want_faults}")
    if res["watchdog_trips"] < 1 or res["engine_restarts"] != 1:
        raise AssertionError(f"resilience: {res['watchdog_trips']} watchdog "
                             f"trips, {res['engine_restarts']} engine "
                             "restarts; want >= 1 and 1")
    eff = faulted["effective"]
    if min(eff) != 4 or eff[-1] != 8:
        raise AssertionError(f"resilience: effective batch min {min(eff)}, "
                             f"last {eff[-1]}; want 4 (halved) and 8")
    if not baseline == clean_free == faulted_free:
        raise AssertionError(f"resilience: free blocks {clean_free} / "
                             f"{faulted_free} after the runs, baseline "
                             f"{baseline}")
    if post or captures:
        raise AssertionError(f"resilience: {captures} serve-step captures "
                             f"and {post} after warm-up in the faulted run")
    if len(rebuilds) != 1:
        raise AssertionError(f"resilience: {len(rebuilds)} pool rebuilds")
    for tag, st in (("clean", clean), ("faulted", faulted)):
        _check_resilience_launches(st, L, f"resilience {tag}")
    counters = {k: res[k] for k in (
        "request_retries", "requests_quarantined", "engine_restarts",
        "watchdog_trips", "requests_shed", "faults_injected",
        "health_state")}
    print(f"[resilience] counters {json.dumps(counters, sort_keys=True)} "
          f"failed={faulted['snap']['failed']} "
          f"completed={faulted['snap']['completed']} "
          f"effective_batch min={min(eff)} last={eff[-1]}", flush=True)
    print(f"[resilience] faulted vs fault-free ({card}): wall_s "
          f"{faulted['wall_s']:.3f} / {clean['wall_s']:.3f}, steps "
          f"{faulted['steps']} / {clean['steps']} (replay took "
          f"{faulted['steps'] - clean['steps']} more), streams_equal=True "
          f"({len(prompts) - 1} requests, 1 quarantined), "
          f"post_warmup_captures={post} launches faulted="
          f"{faulted['launches']} clean={clean['launches']}", flush=True)
    print(f"[resilience] rebuild_kv_state {rebuilds[0] * 1e3:.3f} ms: "
          f"{n_pools} pools zeroed in place, {nbytes / 1e9:.3f} GB "
          f"({card})", flush=True)
    return {"clean": clean, "faulted": faulted, "warm": warm,
            "rebuild_ms": rebuilds[0] * 1e3, "pool_bytes": nbytes}


# ---------------------------------------------------------------- phase 8

def writer_case(device, B=8, C=512, H=32, D=128, page=16, max_pages=128,
                seed=5):
    """The mixed step's K (or V) write at the serving shapes: every row a
    ``C``-token chunk but two (one decode row, one inactive), pads to the
    scratch page; returns (kv in bf16, tables, ctx, qlens, scratch,
    pool pages)."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    P = B * max_pages + 1
    kv = torch.randn(B, C, H, D, generator=g, device=device).to(
        torch.bfloat16)
    tables = torch.arange(B * max_pages, dtype=torch.int32,
                          device=device).reshape(B, max_pages)
    ctx = torch.tensor([0, 512, 1024, 1500, 3, 700, 2000, 0],
                       dtype=torch.int32, device=device)[:B]
    qlens = torch.tensor([C, C, C, 48, C, C, 1, 0], dtype=torch.int32,
                         device=device)[:B]
    scratch = torch.tensor(P - 1, dtype=torch.int32, device=device)
    return kv, tables, ctx, qlens, scratch, P


def writer_phase(device, card):
    """The KV page writer (``write_ragged_pages``) alone at the serving
    shapes: a bf16 pool against an int8 one, CUDA-event medians of one
    eager call and of one CUDA graph replay of it (as the serve step
    runs it), and per step (K and V, 32 layers).  The
    int8 pool's dequantized pages must stay within
    ``kv_dequant_error_bound`` of the bf16 values written.  Returns the
    numbers."""
    import torch

    from paddle_infer_tpu_torch.ops import paged_attention as PA
    from paddle_infer_tpu_torch.ops import ragged_paged_attention as RPA

    kv, tables, ctx, qlens, scratch, P = writer_case(device)
    B, C, H, D = kv.shape
    page = 16
    bf = torch.zeros(P, H, page, D, dtype=torch.bfloat16, device=device)
    q8 = (torch.zeros(P, H, page, D, dtype=torch.int8, device=device),
          torch.full((P, H), PA.KV_SCALE_EPS, device=device))
    out = {}
    for kind, pages in (("bf16", bf), ("int8", q8)):
        def fn(pages=pages):
            RPA.write_ragged_pages(pages, tables, kv, ctx, qlens, scratch)

        ms = time_ms(fn)
        # as the serve step runs it: inside a CUDA graph, no host work
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        out[kind] = {"ms": ms, "graph_ms": time_ms(graph.replay)}
        del graph
    # the bytes the write must move: the chunk's values read once, the
    # touched page slots (and scales) written once
    tokens = int(qlens.sum())
    live = tokens * H * D
    nbytes = {"bf16": live * 2 * 2, "int8": live * (2 + 1) + P * H * 4}
    # the scratch page (the last) takes duplicate pad writes in either
    # order: compare the rows' pages only
    live_q8 = (q8[0][:-1], q8[1][:-1])
    err = float((PA.dequantize_pages(live_q8) - bf[:-1].float()).abs().max())
    bound = PA.kv_dequant_error_bound(bf[:-1].float().cpu().numpy(),
                                      live_q8[1].cpu().numpy())
    ok = err <= bound
    for kind, r in out.items():
        r["bound_ms"] = nbytes[kind] / PEAK_BYTES_S * 1e3
        print(f"[writer] write_ragged_pages {kind}: ms={r['ms']:.4f} "
              f"graph_ms={r['graph_ms']:.4f} "
              f"bytes_bound_ms={r['bound_ms']:.4f}; per step (K and V, "
              f"32 layers): ms={r['ms'] * 64:.2f} "
              f"graph_ms={r['graph_ms'] * 64:.2f} ({B}x{C} positions, "
              f"{tokens} valid; {card})", flush=True)
    print(f"[writer] int8 round trip max_abs_err={err:.4e} "
          f"kv_dequant_error_bound={bound:.4e} ok={ok}", flush=True)
    if not ok:
        raise AssertionError("int8 pages outside kv_dequant_error_bound")
    return out


def int8_phase(model, device, card, bf16_serve):
    """The same model on int8 pools: (a) the serve phase's 8 requests on
    graphs and eager, streams EQUAL, decode and ragged launches exact,
    pool bytes and step p50 beside the bf16 serve run; (b) paged vs
    dense logits at int8; (c) the prefix phase at int8; (d) ngram
    speculation on tiled prompts against int8 plain (greedy streams
    EQUAL, verify launched once per layer per step); (e) the writer
    alone (``writer_phase``) and a profiled short int8 run.  Returns
    the runs."""
    L = model.config.num_hidden_layers
    q8 = dict(kv_dtype="int8")
    st = serve_counted(model, device, "int8 serve", **q8)
    _check_decode_launches(st, L, "int8 serve")
    _check_ragged_launches(st, L, "int8 serve")
    eager_twin(model, device, "int8 serve", st, card, **q8)
    print(f"[int8] pool bytes bf16={bf16_serve['pool_bytes']} "
          f"int8={st['pool_bytes']} ratio="
          f"{bf16_serve['pool_bytes'] / st['pool_bytes']:.4f}; step_ms_p50 "
          f"bf16={_p50_after_first(bf16_serve):.2f} "
          f"int8={_p50_after_first(st):.2f}; tokens_per_s "
          f"bf16={bf16_serve['tokens_per_s']:.2f} "
          f"int8={st['tokens_per_s']:.2f} ({card})", flush=True)
    reference_check(model, device, kv_dtype="int8")
    runs = {"serve": st,
            "prefix": prefix_phase(model, device, card, kv_dtype="int8")}
    tiled = tiled_prompts(model.config.vocab_size, SPEC_PROMPT_LENS, seed=4)
    runs["spec plain"] = serve_counted(model, device, "int8 spec plain",
                                       prompts=tiled, **q8)
    spec_kw = dict(prompts=tiled, draft_source="ngram", speculate=True,
                   num_draft_tokens=NUM_DRAFT, **q8)
    runs["spec"] = serve_counted(model, device, "int8 spec ngram",
                                 **spec_kw)
    eager_twin(model, device, "int8 spec ngram", runs["spec"], card,
               **spec_kw)
    greedy = [i for i in range(len(tiled)) if i not in SAMPLED]
    if any(runs["spec"]["streams"][i] != runs["spec plain"]["streams"][i]
           for i in greedy):
        raise AssertionError("int8 ngram-speculative greedy streams differ "
                             "from int8 plain ones")
    if not runs["spec"]["drafts_proposed"]:
        raise AssertionError("int8 spec: no draft was proposed")
    _check_verify_launches(runs["spec"], L, "int8 spec")
    for tag in ("spec plain", "spec"):
        _check_ragged_launches(runs[tag], L, f"int8 {tag}")
    runs["writer"] = writer_phase(device, card)
    profile_pair(model, device, "int8", card, **q8)
    return runs


# ---------------------------------------------------------------- phase 9

GEN_PROMPT_LENS = (1024, 700, 129, 17)
GEN_NEW = 32
BEAM_NEW = 16
NUM_BEAMS = 4
GEN_SAMPLED = dict(do_sample=True, top_k=50, top_p=0.9, temperature=0.8,
                   repetition_penalty=1.1, seed=1234)
EXCLUSIVE_LENS = (512, 257, 128, 33)     # batch rows beside the call


def gen_prompts(vocab, lens, seed=8):
    """Right-padded ``[b, max(lens)]`` ids of random tokens and their
    0/1 mask."""
    rs = np.random.RandomState(seed)
    ids = np.zeros((len(lens), max(lens)), np.int32)
    mask = np.zeros_like(ids)
    for i, n in enumerate(lens):
        ids[i, :n] = rs.randint(1, vocab, (n,))
        mask[i, :n] = 1
    return ids, mask


def _timed_programs(engine):
    """Time every ``run_paged_program`` call of ``engine`` (the card
    synced before and after); returns the list the ``(key, ms)`` pairs
    are appended to.  ``del engine.run_paged_program`` undoes it."""
    import torch

    inner = engine.run_paged_program
    calls = []
    cuda = engine.device.type == "cuda"

    def run(key, builder, *args):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(key, builder, *args)
        if cuda:
            torch.cuda.synchronize()
        calls.append((key, (time.perf_counter() - t0) * 1e3))
        return out

    engine.run_paged_program = run
    return calls


def _gen_times(calls):
    """(prefill ms, decode step ms p50) of one call's programs: a chunk
    program's time over its steps."""
    pre = [ms for k, ms in calls if not k[0].endswith("chunk")]
    steps = [ms / k[1] for k, ms in calls if k[0].endswith("chunk")]
    return (float(np.median(pre)) if pre else float("nan"),
            float(np.median(steps)) if steps else float("nan"))


def profile_generate(fn, tag, top=10):
    """One call of ``fn`` (a ``generate`` on keys already captured)
    under ``torch.profiler``: ``print_profile``'s lines."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return print_profile(prof, wall, tag, top)


def _check_generate_launches(launches, L, decode_steps, prefills, tag):
    """Each decode step walks the pages once a layer (the decode kernel),
    each prefill attends once a layer (the flash forward kernel)."""
    want = {"paged_decode": L * decode_steps, "flash_fwd": L * prefills}
    got = {n: launches[n] for n in want}
    if got != want:
        raise AssertionError(f"{tag}: launches {got}, want {want}")


def gen_counted(engine, calls, fn, tag, L, decode_steps, prefills):
    """``fn()`` with the launch counts zeroed just before and read just
    after and the engine's programs timed; checks the launches and
    returns ``(result, record)``."""
    from paddle_infer_tpu_torch.ops import _build

    for k in _build.KERNELS.values():
        k.launches = 0
    del calls[:]
    t0 = time.perf_counter()
    out = fn()
    wall = time.perf_counter() - t0
    launches = {n: k.launches for n, k in _build.KERNELS.items()}
    _check_generate_launches(launches, L, decode_steps, prefills, tag)
    pre, step = _gen_times(calls)
    return out, {"wall_s": wall, "prefill_ms": pre, "step_ms": step,
                 "launches": launches, "programs": len(calls)}


def _stream_all(engine, ids, g, mask, chunk):
    return np.concatenate(list(engine.stream(ids, g, attention_mask=mask,
                                             chunk_size=chunk)), axis=1)


def _first_logits(engine, fn):
    """The last real prompt position's logits of each row (float32
    ``[b, V]``) from the first prefill ``fn()`` makes through ``engine``,
    run eagerly: the paged engine's ``_prefill_logits`` picks position
    ``length - 1`` of its right-padded rows, the dense engine's prompts
    are left-padded (the last position)."""
    paged = hasattr(engine, "_prefill_logits")
    inner = engine._prefill_logits if paged else engine._model_step
    got = []

    def record(*a):
        out = inner(*a)
        if not got:
            got.append((out[0] if paged else out[0][:, -1]).float().clone())
        return out

    name = "_prefill_logits" if paged else "_model_step"
    setattr(engine, name, record)
    try:
        with eager():
            fn()
    finally:
        delattr(engine, name)
    return got[0]


def generate_phase(model, device, card, prompt_lens=GEN_PROMPT_LENS,
                   max_new=GEN_NEW, beam_new=BEAM_NEW,
                   exclusive_lens=EXCLUSIVE_LENS):
    """The engines' own entry points on the serve phase's model:
    ``PagedGenerationEngine.generate`` greedy (graphs, again as a
    ``stream``, again eager: EQUAL), seeded sampling (``generate`` EQUAL
    to ``stream``), beam search (pages shared, scores finite), int8
    pools; the launches of the decode and flash forward kernels exact
    for each call and no capture after each key's first call; the dense
    ``GenerationEngine`` against the paged one; a beam call of a dense
    engine through ``EngineCore.submit_exclusive`` beside batch rows.
    Returns ``{"decode": launches, "flash": launches}`` over the counted
    calls."""
    from paddle_infer_tpu_torch.core.graphs import graphs_enabled
    from paddle_infer_tpu_torch.inference.generation import (
        GenerationConfig, GenerationEngine, PagedGenerationEngine)
    from paddle_infer_tpu_torch.observability import get_compile_log

    L = model.config.num_hidden_layers
    vocab = model.config.vocab_size
    ids, mask = gen_prompts(vocab, prompt_lens)
    b = len(prompt_lens)
    log = get_compile_log()
    log.reset()
    eng = PagedGenerationEngine(model, page_size=16, device=device)
    calls = _timed_programs(eng)
    total = {"decode": 0, "flash": 0}

    graphs = graphs_enabled(device)
    replays = {"calls": 0}

    def counted(fn, tag, steps, replay=False):
        """A counted call; ``replay``: every key it runs was captured by
        an earlier call, so the compile log must not move."""
        before = log.count()
        out, rec = gen_counted(eng, calls, fn, tag, L, steps, 1)
        total["decode"] += rec["launches"]["paged_decode"]
        total["flash"] += rec["launches"]["flash_fwd"]
        if replay and graphs:
            replays["calls"] += 1
            if log.count() != before:
                raise AssertionError(f"{tag}: {log.count() - before} "
                                     "captures after the keys' first call")
        return out, rec

    def valid(seq, tag):
        if seq.min() < 0 or seq.max() >= vocab:
            raise AssertionError(f"{tag}: token outside the vocabulary")

    def gen(g):
        return lambda: eng.generate(ids, g, attention_mask=mask,
                                    return_scores=True)

    greedy = GenerationConfig(max_new_tokens=max_new)
    steps = max_new - 1
    # each key's first call runs eagerly and captures its graph
    (seq0, _), first = counted(gen(greedy), "generate greedy warm-up", steps)
    captured = log.count()
    (seq, score), rec = counted(gen(greedy), "generate greedy", steps,
                                replay=True)
    st, srec = counted(lambda: _stream_all(eng, ids, greedy, mask, 8),
                       "stream greedy", steps, replay=True)
    with eager():
        (eseq, escore), erec = counted(gen(greedy), "generate greedy eager",
                                       steps)
    valid(seq, "greedy")
    if not np.isfinite(score).all():
        raise AssertionError("greedy scores not finite")
    for name, other in (("warm-up", seq0), ("stream(chunk_size=8)", st),
                        ("disable_graphs()", eseq)):
        if not np.array_equal(other, seq):
            raise AssertionError(f"greedy generate differs from {name}")
    if not np.array_equal(escore, score):
        raise AssertionError("greedy scores differ graph vs eager")
    if graphs and captured == 0:
        raise AssertionError("the warm-up call captured no graph")
    toks = b * max_new
    print(f"[generate] greedy {b} prompts {list(prompt_lens)}, {max_new} "
          f"new: stream(chunk_size=8) EQUAL, disable_graphs() EQUAL "
          f"(tokens and scores), captures={captured} in the warm-up "
          f"call, 0 in the replays ({card})", flush=True)
    print(f"[generate] prefill_ms graph={rec['prefill_ms']:.2f} "
          f"eager={erec['prefill_ms']:.2f} (warm-up, capturing: "
          f"{first['prefill_ms']:.2f}); decode step p50 ms "
          f"graph={rec['step_ms']:.3f} eager={erec['step_ms']:.3f} "
          f"({card})", flush=True)
    print(f"[generate] tokens_per_s generate={toks / rec['wall_s']:.1f} "
          f"stream={toks / srec['wall_s']:.1f} "
          f"eager={toks / erec['wall_s']:.1f} ({card})", flush=True)
    pg = profile_generate(gen(greedy), "generate greedy graph")
    with eager():
        pe = profile_generate(gen(greedy), "generate greedy eager")
    print(f"[profile] generate graph vs eager ({card}): idle_share "
          f"graph={pg['idle_share']:.3f} eager={pe['idle_share']:.3f} "
          f"busy_ms graph={pg['busy_ms']:.1f} eager={pe['busy_ms']:.1f} "
          f"wall_ms graph={pg['wall_ms']:.1f} eager={pe['wall_ms']:.1f}",
          flush=True)
    print(f"[generate] launches per call: paged_decode="
          f"{rec['launches']['paged_decode']} ({L} layers x {steps} decode "
          f"steps), flash_fwd={rec['launches']['flash_fwd']} ({L} per "
          "prefill)", flush=True)

    sampled = GenerationConfig(max_new_tokens=max_new, **GEN_SAMPLED)
    (sseq, _), _ = counted(gen(sampled), "generate sampled", steps)
    sst, _ = counted(lambda: _stream_all(eng, ids, sampled, mask, 8),
                     "stream sampled", steps, replay=True)
    valid(sseq, "sampled")
    if not np.array_equal(sseq, sst):
        raise AssertionError("sampled generate differs from its stream")
    print(f"[generate] sampled {GEN_SAMPLED}: generate EQUAL stream "
          f"({card})", flush=True)

    beam = GenerationConfig(max_new_tokens=beam_new, num_beams=NUM_BEAMS)

    def bgen():
        return eng.generate(ids[:2], beam, attention_mask=mask[:2],
                            return_scores=True)

    counted(bgen, "beam warm-up", beam_new - 1)
    (bseq, bscore), brec = counted(bgen, "beam", beam_new - 1, replay=True)
    stats = eng.last_beam_pool_stats
    valid(bseq, "beam")
    if not stats["used_pages"] < stats["unshared_equivalent"]:
        raise AssertionError(f"beam pages not shared: {stats}")
    if not np.isfinite(bscore).all():
        raise AssertionError(f"beam scores not finite: {bscore}")
    print(f"[generate] beam {NUM_BEAMS} beams x 2 prompts, {beam_new} new: "
          f"pool {stats}, scores {bscore.tolist()}, tokens_per_s="
          f"{2 * beam_new / brec['wall_s']:.1f} (best beams), decode step "
          f"p50 ms={brec['step_ms']:.3f} over {2 * NUM_BEAMS} rows "
          f"({card})", flush=True)
    print(f"[generate] {log.count()} captures over the greedy, sampled and "
          f"beam keys, none in {replays['calls']} calls on captured keys",
          flush=True)
    del eng.run_paged_program
    # the first-step logits of a paged engine, for the dense engine below
    paged_first = _first_logits(eng, gen(greedy))
    del eng
    free_memory()

    q8 = PagedGenerationEngine(model, page_size=16, kv_dtype="int8",
                               device=device)
    calls8 = _timed_programs(q8)
    (qseq, qscore), qrec = gen_counted(
        q8, calls8, lambda: q8.generate(ids, greedy, attention_mask=mask,
                                        return_scores=True),
        "generate int8", L, steps, 1)
    total["decode"] += qrec["launches"]["paged_decode"]
    total["flash"] += qrec["launches"]["flash_fwd"]
    valid(qseq, "int8")
    if not np.isfinite(qscore).all():
        raise AssertionError("int8 scores not finite")
    print(f"[generate] int8 pools greedy: {int((qseq == seq).sum())}/"
          f"{seq.size} tokens as unquantized pages, prefill_ms="
          f"{qrec['prefill_ms']:.2f} (capturing) ({card})", flush=True)
    del q8.run_paged_program, q8
    free_memory()

    dense = GenerationEngine(model, device=device)
    dense_first = _first_logits(dense, lambda: dense.generate(
        ids, greedy, attention_mask=mask))
    t0 = time.perf_counter()
    dseq = dense.generate(ids, greedy, attention_mask=mask)
    dwall = time.perf_counter() - t0
    valid(dseq, "dense")
    scale = float(paged_first.abs().max())
    err = float((dense_first - paged_first).abs().max())
    print(f"[generate] dense GenerationEngine greedy ({L} layers): "
          f"first-step logits max_abs_err={err:.4e} logit_scale="
          f"{scale:.4e} rel_tol=0.05; {int((dseq == seq).sum())}/{seq.size}"
          f" tokens as the paged engine (no gate: bf16 near-ties); "
          f"tokens_per_s={toks / dwall:.1f} ({card})", flush=True)
    if not err <= 0.05 * scale:
        raise AssertionError("dense first-step logits disagree with paged")

    exclusive_phase(model, device, dense, card, exclusive_lens)
    del dense
    free_memory()
    return total


def exclusive_phase(model, device, dense, card, lens):
    """A beam ``generate`` of ``dense`` submitted through
    ``EngineCore.submit_exclusive`` while batch rows are in flight: its
    value EQUAL to the same call made directly, the batch streams EQUAL
    to a run without it."""
    from paddle_infer_tpu_torch.inference.generation import \
        GenerationConfig
    from paddle_infer_tpu_torch.observability import get_compile_log
    from paddle_infer_tpu_torch.serving import RequestState
    from paddle_infer_tpu_torch.serving import request as trequest

    vocab = model.config.vocab_size
    # two beam prompts as long as the last two batch rows
    bids, bmask = gen_prompts(vocab, lens[-2:], seed=9)
    beam = GenerationConfig(max_new_tokens=8, num_beams=NUM_BEAMS)
    want = dense.generate(bids, beam, attention_mask=bmask,
                          return_scores=True)
    rs = np.random.RandomState(10)
    prompts = [rs.randint(0, vocab, (n,)).astype(np.int32) for n in lens]
    streams = []
    for with_call in (False, True):
        get_compile_log().reset()
        core = make_core(model, device)
        trequest._rid_counter = itertools.count(400)
        try:
            reqs = [core.submit(p, GenerationConfig(max_new_tokens=16))[0]
                    for p in prompts]
            core.run_once()
            core.run_once()                       # the rows are decoding
            ex = None
            if with_call:
                ex = core.submit_exclusive(lambda: dense.generate(
                    bids, beam, attention_mask=bmask, return_scores=True))
            for _ in range(500):
                if all(r.done for r in reqs) and (ex is None or ex.done):
                    break
                core.run_once()
        finally:
            core.close()
            free_memory()
        bad = [r.rid for r in reqs if r.state != RequestState.DONE]
        if bad:
            raise AssertionError(f"exclusive phase: requests {bad} not DONE")
        streams.append([list(r.tokens) for r in reqs])
    if ex.state != RequestState.DONE:
        raise AssertionError(f"exclusive request {ex.state}: {ex.error!r}")
    if not (np.array_equal(ex.value[0], want[0])
            and np.array_equal(ex.value[1], want[1])):
        raise AssertionError("exclusive value differs from the direct call")
    if streams[0] != streams[1]:
        raise AssertionError("batch streams changed beside the exclusive "
                             "call")
    print(f"[generate] exclusive beam generate ({NUM_BEAMS} beams, 2 "
          f"prompts) through submit_exclusive beside {len(lens)} batch "
          f"rows in flight: value EQUAL to the direct call, batch streams "
          f"EQUAL to a run without it ({card})", flush=True)


# --------------------------------------------------------------- phase 10

def gpt_phase(device, config=None, dtype=None, card=""):
    """gpt3-6.7b (or ``config``) at full width and depth: ngram-speculative
    serving of 8 requests on graphs and again eager (equal streams), then
    paged vs dense logits."""
    import torch

    from paddle_infer_tpu_torch.models import GPTConfig, GPTForCausalLM

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = config or GPTConfig.from_preset("gpt3-6.7b")
    model = GPTForCausalLM(cfg, device=device, dtype=dtype or torch.bfloat16,
                           seed=0)
    if cuda:
        torch.cuda.synchronize()
    print(f"[gpt] {'gpt3-6.7b' if config is None else 'gpt'} built in "
          f"{time.perf_counter() - t0:.1f}s: hidden {cfg.hidden_size}, "
          f"layers {cfg.num_hidden_layers}, ffn {cfg.intermediate_size}, "
          f"vocab {cfg.vocab_size}, params "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.2f}B "
          f"{str(next(model.parameters()).dtype)[6:]}", flush=True)
    prompts = tiled_prompts(cfg.vocab_size, SPEC_PROMPT_LENS, seed=5)
    kw = dict(prompts=prompts, max_model_len=cfg.max_position_embeddings,
              speculate=True, num_draft_tokens=NUM_DRAFT,
              draft_source="ngram")
    st = serve_counted(model, device, "gpt ngram", **kw)
    eager_twin(model, device, "gpt ngram", st, card, **kw)
    if cuda:
        print(f"[gpt] peak_mem_gb="
              f"{torch.cuda.max_memory_allocated() / 1e9:.1f}", flush=True)
    _check_verify_launches(st, cfg.num_hidden_layers, "gpt")
    _check_ragged_launches(st, cfg.num_hidden_layers, "gpt")
    reference_check(model, device)
    return st


# --------------------------------------------------------------- phase 11

# (a) ERNIE-3.0-base attention with 10 % trailing padding as segment
# ids, (b) long causal (where the reference itself picks flash), (c)
# Sq < Sk causal, which exercises the offset Sk - Sq, (d) head_dim 256
# (the kernels' split accumulators), causal with padding segments
FLASH_SHAPES = {
    "a": dict(B=32, H=12, Sq=512, Sk=512, D=64, causal=False, pad=51),
    "b": dict(B=2, H=32, Sq=4096, Sk=4096, D=128, causal=True, pad=0),
    "c": dict(B=2, H=4, Sq=256, Sk=512, D=64, causal=True, pad=0),
    "d": dict(B=4, H=8, Sq=2000, Sk=2000, D=256, causal=True, pad=200),
}
FLASH_RUNS = (("a", "fp32", 0.1), ("a", "bf16", 0.1), ("a", "fp32", 0.0),
              ("a", "bf16", 0.0), ("b", "bf16", 0.0), ("c", "fp32", 0.1),
              ("c", "bf16", 0.1), ("c", "bf16", 0.0), ("d", "fp32", 0.1),
              ("d", "bf16", 0.1), ("d", "bf16", 0.0))
FLASH_TIMED = (("a", "bf16", 0.1), ("a", "bf16", 0.0), ("b", "bf16", 0.0),
               ("d", "bf16", 0.0))
FLASH_SEED = 0x5EED1234
# CUDA-event medians of the earlier bf16 backward kernels (warp-level
# mma.sync, synchronous tile loads, a head-dim split at D = 256) on an
# NVIDIA H100 80GB HBM3 at 700 W, printed beside the redesigned
# kernels' times: {(shape, type, dropout): (flash_dkdv ms, flash_dq ms)}
MMA_SYNC_BWD_MS = {("a", "bf16", 0.1): (0.7340, 0.3396),
                   ("a", "bf16", 0.0): (0.7768, 0.3357),
                   ("b", "bf16", 0.0): (4.3734, 2.7188),
                   ("d", "bf16", 0.0): (2.7206, 1.4400)}
# the same for the earlier bf16 forward kernel (four warps of mma.sync,
# synchronous tile loads), printed beside the redesigned forward's time
MMA_SYNC_FWD_MS = {("a", "bf16", 0.1): 0.3220, ("a", "bf16", 0.0): 0.3298,
                   ("b", "bf16", 0.0): 2.3937, ("d", "bf16", 0.0): 0.8406}


def make_flash_case(device, B, H, Sq, Sk, D, causal, pad, seed=2):
    """Folded ``[B*H, S, D]`` float32 q, k, v, dO (N(0, 1)) and, when
    ``pad``, ``[B, S]`` segment ids: 1 for real tokens, 0 for the
    trailing ``pad`` (self-attention: the same ids on both sides)."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    mk = lambda s: torch.randn(B * H, s, D, generator=g, device=device)
    seg = None
    if pad:
        seg = torch.ones(B, Sq, dtype=torch.int32, device=device)
        seg[:, Sq - pad:] = 0
    return dict(q=mk(Sq), k=mk(Sk), v=mk(Sk), do=mk(Sq), seg=seg, B=B, H=H,
                Sq=Sq, Sk=Sk, D=D, causal=causal,
                scale=1.0 / float(np.sqrt(D)))


def _plain_chunks(fn, case, tensors, chunk_bytes=2 ** 31):
    """Run a plain version over slices of whole batch rows (heads of one
    row stay together), so its ``[bh, Sq, Sk]`` float32 temporaries stay
    within ``chunk_bytes``; results concatenated along bh."""
    import torch

    H, Sq, Sk = case["H"], case["Sq"], case["Sk"]
    rows = max(1, chunk_bytes // (H * Sq * Sk * 4))
    seg = case["seg"]
    outs = []
    for b0 in range(0, case["B"], rows):
        b1 = min(case["B"], b0 + rows)
        part = [t[b0 * H:b1 * H] for t in tensors]
        s = (seg[b0:b1], seg[b0:b1]) if seg is not None else (None, None)
        outs.append(fn(part, s))
    return [torch.cat(x) for x in zip(*outs)]


def _mask_pairs(case):
    """The q-k pairs this case's mask lets through, summed over batch
    rows: causal (row i sees keys j <= i + Sk - Sq) and, with segment
    ids, equal ids on both sides."""
    B, Sq, Sk = case["B"], case["Sq"], case["Sk"]
    ok = np.ones((Sq, Sk), bool)
    if case["causal"]:
        ok = np.arange(Sq)[:, None] + (Sk - Sq) >= np.arange(Sk)[None, :]
    if case["seg"] is None:
        return B * int(ok.sum())
    seg = case["seg"].cpu().numpy()            # the same ids on both sides
    return sum(int(((s[:, None] == s[None, :]) & ok).sum()) for s in seg)


def _flash_cost(case, kind):
    """(bytes, operations) one kernel must at least move and do: each
    input read once, each output written once; the q-k pairs this mask
    needs (``_mask_pairs``)."""
    B, H, Sq, Sk, D = (case[n] for n in ("B", "H", "Sq", "Sk", "D"))
    isz = case["itemsize"]
    pairs = _mask_pairs(case)
    seg = 4 * B * (Sq + Sk) if case["seg"] is not None else 0
    qd, kd = B * H * Sq * D * isz, B * H * Sk * D * isz
    rowf = B * H * Sq * 4
    if kind == "flash_fwd":
        return qd + 2 * kd + qd + rowf + seg, 4 * H * pairs * D
    if kind == "flash_dkdv":
        return 2 * qd + 2 * kd + 2 * rowf + 2 * kd + seg, 8 * H * pairs * D
    return 2 * qd + 2 * kd + 2 * rowf + qd + seg, 6 * H * pairs * D


def check_flash(case, kind, p, timed=True):
    """Kernels 4–6 against their plain versions on the same inputs:
    ``flash_fwd``'s o and lse, then dq, dk, dv of ``flash_dq`` and
    ``flash_dkdv`` from the plain version's (o, lse) and the same dO.
    With ``timed``, CUDA-event medians of each kernel beside its plain
    version, its bound and the library call (SDPA at dropout 0).
    Returns ``{kernel: record}``; raises on a disagreement."""
    import torch

    from paddle_infer_tpu_torch.ops import flash_attention as FA

    dt = torch.float32 if kind == "fp32" else torch.bfloat16
    case = dict(case, itemsize=4 if kind == "fp32" else 2)
    q, k, v, do = (case[n].to(dt) for n in ("q", "k", "v", "do"))
    seg, H, causal, scale = case["seg"], case["H"], case["causal"], \
        case["scale"]
    tol = TOL[kind]
    cfg = dict(seed=FLASH_SEED, causal=causal, scale=scale, dropout_p=p,
               h=H)

    def plain_fwd():
        return _plain_chunks(
            lambda t, s: FA._fwd_reference(*[x.float() for x in t], *s,
                                           **cfg), case, (q, k, v))

    ref_o, ref_lse = plain_fwd()
    o, lse = FA.flash_fwd(q, k, v, seg, seg, **cfg)
    o2, lse2 = FA.flash_fwd(q, k, v, seg, seg, **cfg)
    delta = FA._delta(do, ref_o)

    def plain_grads():
        return _plain_chunks(
            lambda t, s: FA._grads_reference(
                *[x.float() for x in t[:4]], t[4], t[5], *s, **cfg),
            case, (q, k, v, do, ref_lse, delta))

    rdq, rdk, rdv = plain_grads()
    dk, dv = FA.flash_dkdv(q, k, v, do, ref_lse, delta, seg, seg, **cfg)
    dq = FA.flash_dq(q, k, v, do, ref_lse, delta, seg, seg, **cfg)
    # determinism: a second launch on the same inputs gives the same bits
    dk2, dv2 = FA.flash_dkdv(q, k, v, do, ref_lse, delta, seg, seg, **cfg)
    dq2 = FA.flash_dq(q, k, v, do, ref_lse, delta, seg, seg, **cfg)
    if q.is_cuda:
        torch.cuda.synchronize()

    def cmp(got, ref):
        err = float((got.float() - ref).abs().max())
        return err, bool(torch.allclose(got.float(), ref, atol=tol, rtol=tol))

    out = {}
    for name, pairs in (("flash_fwd", ((o, ref_o), (lse, ref_lse))),
                        ("flash_dkdv", ((dk, rdk), (dv, rdv))),
                        ("flash_dq", ((dq, rdq),))):
        res = [cmp(g_, r_) for g_, r_ in pairs]
        out[name] = {"max_abs_err": max(e for e, _ in res), "tol": tol,
                     "ok": all(ok for _, ok in res)}
    for name, pairs in (("flash_fwd", ((o, o2), (lse, lse2))),
                        ("flash_dkdv", ((dk, dk2), (dv, dv2))),
                        ("flash_dq", ((dq, dq2),))):
        same = all(torch.equal(x, y) for x, y in pairs)
        out[name]["repeat_equal"] = same
        out[name]["ok"] = out[name]["ok"] and same
    if timed:
        out["flash_fwd"]["ms"] = time_ms(
            lambda: FA.flash_fwd(q, k, v, seg, seg, **cfg))
        # without the wrapper's host work: the profiler's kernel time
        # (and how many of the 25 launches the trace kept), and 25 calls
        # back to back
        fwd = lambda: FA.flash_fwd(q, k, v, seg, seg, **cfg)
        out["flash_fwd"]["device_ms"], out["flash_fwd"]["device_calls"] \
            = device_ms(fwd, name="flash_fwd_kernel")
        out["flash_fwd"]["stream_ms"] = stream_ms(fwd)
        out["flash_dkdv"]["ms"] = time_ms(
            lambda: FA.flash_dkdv(q, k, v, do, ref_lse, delta, seg, seg,
                                  **cfg))
        out["flash_dq"]["ms"] = time_ms(
            lambda: FA.flash_dq(q, k, v, do, ref_lse, delta, seg, seg,
                                **cfg))
        out["flash_fwd"]["plain_ms"] = time_ms(plain_fwd, reps=5, warmup=1)
        # one plain function computes dq, dk and dv together: its time
        # stands beside both backward kernels
        grads_ms = time_ms(plain_grads, reps=5, warmup=1)
        out["flash_dkdv"]["plain_ms"] = out["flash_dq"]["plain_ms"] = grads_ms
        for name in out:
            out[name]["bound_ms"], out[name]["bound_by"] = _bound(
                *_flash_cost(case, name), kind)
        lib = _sdpa_library_ms(case, q, k, v, do) if p == 0 else None
        out["flash_fwd"]["library_ms"] = lib and lib[0]
        out["flash_fwd"]["library_device_ms"] = lib and lib[2]
        out["flash_fwd"]["library_stream_ms"] = lib and lib[3]
        out["flash_dkdv"]["library_ms"] = out["flash_dq"]["library_ms"] = \
            lib and lib[1]
    return out


def _sdpa_library_ms(case, q, k, v, do):
    """``torch.nn.functional.scaled_dot_product_attention`` on the same
    inputs (the segment mask, and with it the causal mask, as a boolean
    ``attn_mask``; causal alone as ``is_causal``): (forward ms, forward +
    backward ms minus forward, the forward's profiled device ms, its ms
    back to back)."""
    import torch
    import torch.nn.functional as F

    B, H, Sq, Sk, D = (case[n] for n in ("B", "H", "Sq", "Sk", "D"))
    q4, k4, v4 = (t.reshape(B, H, -1, D).detach().requires_grad_(True)
                  for t in (q, k, v))
    do4 = do.reshape(B, H, Sq, D)
    mask = None
    if case["seg"] is not None:
        s = case["seg"]
        mask = (s[:, :, None] == s[:, None, :])[:, None]
        if case["causal"]:
            mask = mask & torch.ones(Sq, Sk, dtype=torch.bool,
                                     device=s.device).tril(Sk - Sq)
    kw = dict(attn_mask=mask, is_causal=case["causal"] and mask is None,
              scale=case["scale"])

    def fwd():
        return F.scaled_dot_product_attention(q4, k4, v4, **kw)

    def both():
        fwd().backward(do4)
    fwd_ms = time_ms(fwd)
    return (fwd_ms, time_ms(both) - fwd_ms, device_ms(fwd)[0],
            stream_ms(fwd))


def flash_kernels_phase(device, shapes=FLASH_SHAPES, runs=FLASH_RUNS,
                        timed_runs=FLASH_TIMED):
    """Phase 7.1: every (shape, type, dropout) of ``runs`` checked,
    those of ``timed_runs`` timed.  Returns ``{(shape, kind, p):
    {kernel: record}}``; raises on a disagreement."""
    results = {}
    cases = {}
    for tag, kind, p in runs:
        if tag not in cases:
            cases[tag] = make_flash_case(device, **shapes[tag])
        rec = check_flash(cases[tag], kind, p,
                          timed=(tag, kind, p) in timed_runs)
        results[(tag, kind, p)] = rec
        for name, r in rec.items():
            print(f"[flash] ({tag}) {name} {kind} dropout={p}: " + " ".join(
                f"{k_}={v_:.4e}" if isinstance(v_, float) else f"{k_}={v_}"
                for k_, v_ in r.items()), flush=True)
        if "ms" in rec["flash_dkdv"]:
            print_forward(tag, kind, p, rec["flash_fwd"])
            print_backward(tag, kind, p, rec)
    bad = [(key, n) for key, rec in results.items() for n, r in rec.items()
           if not r["ok"]]
    if bad:
        raise AssertionError(f"flash kernels disagree with their plain "
                             f"versions: {bad}")
    return results


def print_forward(tag, kind, p, r):
    """One line per timed run: the forward's time beside the earlier
    mma.sync design's (``MMA_SYNC_FWD_MS``), its bound and SDPA's forward
    (dropout 0 only), then the device-only times of both (profiled, and
    25 calls back to back) and the card's clocks."""
    prev = MMA_SYNC_FWD_MS.get((tag, kind, p))
    fmt = lambda x: "none" if x is None else f"{x:.4f}"
    print(f"[flash] ({tag}) forward {kind} dropout={p}: fwd_ms={r['ms']:.4f}"
          f" mma_sync_ms={fmt(prev)} faster="
          f"{'none' if prev is None else r['ms'] < prev}"
          f" bound_ms={r['bound_ms']:.4f} sdpa_fwd_ms={fmt(r['library_ms'])}"
          f" device_ms={r['device_ms']:.4f} ({r['device_calls']} of 25 "
          "launches traced)"
          f" sdpa_fwd_device_ms={fmt(r['library_device_ms'])}"
          f" stream_ms={r['stream_ms']:.4f} sdpa_fwd_stream_ms="
          f"{fmt(r['library_stream_ms'])} clocks: {clocks_line()}",
          flush=True)


def print_backward(tag, kind, p, rec):
    """One line per timed run: each backward kernel's time beside the
    earlier mma.sync design's (``MMA_SYNC_BWD_MS``) and its bound, and
    their sum beside SDPA's backward (dropout 0 only)."""
    dkdv, dq = rec["flash_dkdv"], rec["flash_dq"]
    prev = MMA_SYNC_BWD_MS.get((tag, kind, p))
    parts = []
    for i, (name, r) in enumerate((("dkdv", dkdv), ("dq", dq))):
        was = f"{prev[i]:.4f}" if prev else "none"
        faster = "none" if prev is None else str(r["ms"] < prev[i])
        parts.append(f"{name}_ms={r['ms']:.4f} mma_sync_ms={was} "
                     f"faster={faster} {name}_bound_ms={r['bound_ms']:.4f}")
    lib = dkdv.get("library_ms")
    print(f"[flash] ({tag}) backward {kind} dropout={p}: " + " ".join(parts)
          + f" sum_ms={dkdv['ms'] + dq['ms']:.4f} sdpa_bwd_ms="
          + (f"{lib:.4f}" if lib is not None else "none"), flush=True)


def hybrid_vs_flash(device, shape=FLASH_SHAPES["a"], p=0.1):
    """Forward + backward of ``hybrid_attention`` (plain forward, kernels
    5 and 6) against ``flash_attention`` (kernels 4–6) at one shape in
    bf16, in the ``(b, s, h, d)`` layout: CUDA-event medians."""
    import torch

    from paddle_infer_tpu_torch.ops import flash_attention as FA

    case = make_flash_case(device, **shape)
    B, H, S, D = shape["B"], shape["H"], shape["Sq"], shape["D"]
    q, k, v, do = (case[n].to(torch.bfloat16).reshape(B, H, S, D)
                   .permute(0, 2, 1, 3).detach().requires_grad_(True)
                   for n in ("q", "k", "v", "do"))
    do = do.detach()
    kw = dict(q_segment_ids=case["seg"], kv_segment_ids=case["seg"],
              dropout_p=p, dropout_seed=FLASH_SEED)
    out = {}
    for name, fn in (("flash", FA.flash_attention),
                     ("hybrid", FA.hybrid_attention)):
        out[name] = time_ms(lambda: fn(q, k, v, **kw).backward(do), reps=10)
    print(f"[flash] fwd+bwd at (a) bf16 dropout={p}: flash_ms="
          f"{out['flash']:.4f} hybrid_ms={out['hybrid']:.4f}", flush=True)
    return out


TRAIN_BATCH, TRAIN_SEQ = 32, 512
TRAIN_WARMUP, TRAIN_STEPS = 2, 20
H100_BF16_PEAK = 989e12


def pretrain_batch(vocab, batch, seq, seed=0):
    """``bench.py``'s ERNIE batch: random ids, ``seq // 10`` trailing
    pads per row (mask 0, labels -100), random NSP labels."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (batch, seq)).astype(np.int32)
    pad = max(1, seq // 10)
    mask = np.ones((batch, seq), np.int32)
    mask[:, seq - pad:] = 0
    labels = rng.randint(0, vocab, (batch, seq)).astype(np.int32)
    labels[:, seq - pad:] = -100
    nsp = rng.randint(0, 2, (batch,)).astype(np.int32)
    return ids, mask, labels, nsp


def _pretrain_loss(m, ids, mask, labels, nsp):
    from paddle_infer_tpu_torch.models.ernie import ernie_pretrain_loss

    mlm, nsp_logits = m(ids, attention_mask=mask)
    return ernie_pretrain_loss(mlm, nsp_logits, labels, nsp)


def build_train_step(device, cfg, amp_o2, lr=1e-4, weight_decay=0.01,
                     seed=0):
    """ERNIE pretraining through ``FleetTrainStep`` on one device: random
    fp32 weights (N(0, 0.02), seeded on the device), AdamW, AMP O2 bf16
    when ``amp_o2``."""
    from paddle_infer_tpu_torch.models.ernie import ErnieForPretraining
    from paddle_infer_tpu_torch.optimizer import AdamW
    from paddle_infer_tpu_torch.parallel import (DistributedStrategy,
                                                 FleetTrainStep, fleet)

    model = ErnieForPretraining(cfg, device=device, seed=seed)
    strategy = DistributedStrategy()
    if amp_o2:
        strategy.amp = True
        strategy.amp_configs = {"level": "O2", "dtype": "bfloat16"}
    fleet.init(strategy=strategy, devices=[device])
    opt = AdamW(learning_rate=lr, weight_decay=weight_decay,
                parameters=model.parameters())
    return FleetTrainStep(model, _pretrain_loss, opt, strategy=strategy)


def train_phase(device, cfg=None, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                warmup=TRAIN_WARMUP, steps=TRAIN_STEPS, amp_o2=True,
                launches_per_step=None):
    """Phase 7.2: ERNIE-3.0-base pretraining (or ``cfg``), ``warmup``
    steps, then ``steps`` timed steps alternating two batches that lie
    on the device, with the launch counts zeroed just before and read
    just after.  Raises unless every loss is finite, each batch's losses
    fall (the mean of its last quarter below that of its first), each
    flash kernel launched ``launches_per_step`` times per step (default:
    once per layer on the card, not checked on the CPU), the compile log
    holds one ``train-step`` event (on graphs: the capture) and none
    after warm-up, and the caller's batch tensors are unchanged (a
    replay copies each batch into the graph's own inputs).  ``peak_alloc_gb``
    is the timed steps' allocation peak, which under graphs leaves out
    the pool made at capture; ``reserved_gb`` is what the process holds
    after them, that pool included."""
    import torch

    from paddle_infer_tpu_torch.core.graphs import graphs_enabled
    from paddle_infer_tpu_torch.models.ernie import ErnieConfig
    from paddle_infer_tpu_torch.observability import get_compile_log
    from paddle_infer_tpu_torch.ops import _build

    cuda = device.type == "cuda"
    graphs = graphs_enabled(device)
    log = get_compile_log()
    log.reset()
    cfg = cfg or ErnieConfig.from_preset("ernie-3.0-base")
    t0 = time.perf_counter()
    step = build_train_step(device, cfg, amp_o2)
    n_params = sum(p.numel() for p in step.params.values())
    print(f"[train] ernie built in {time.perf_counter() - t0:.1f}s: hidden "
          f"{cfg.hidden_size}, layers {cfg.num_hidden_layers}, vocab "
          f"{cfg.vocab_size}, params {n_params / 1e6:.1f}M fp32, batch "
          f"{batch}x{seq}, amp {'O2 bf16' if amp_o2 else 'off'}", flush=True)
    batches = [[torch.from_numpy(a).to(device)
                for a in pretrain_batch(cfg.vocab_size, batch, seq, seed)]
               for seed in (0, 1)]
    kept = [[t.clone() for t in b] for b in batches]
    data = batches[0]
    for _ in range(warmup):
        step(*data)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for k in _build.KERNELS.values():
        k.launches = 0
    losses, ms = [], []
    for i in range(steps):
        t = time.perf_counter()
        losses.append(float(step(*batches[i % 2])))   # syncs on the loss
        ms.append((time.perf_counter() - t) * 1e3)
    launches = {n: k.launches for n, k in _build.KERNELS.items()}
    p50 = float(np.median(ms))
    tok_s = batch * seq / (p50 / 1e3)
    flops_tok = 6 * n_params + 12 * cfg.num_hidden_layers * seq \
        * cfg.hidden_size
    mfu = tok_s * flops_tok / H100_BF16_PEAK
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
    held = torch.cuda.memory_reserved() / 1e9 if cuda else 0.0
    print(f"[train] steps={steps} step_ms_p50={p50:.2f} step_ms_min="
          f"{min(ms):.2f} step_ms_max={max(ms):.2f} tokens_per_s="
          f"{tok_s:.0f} mfu={mfu:.4f} (6N+12Lsh per token over "
          f"{H100_BF16_PEAK:.0e}) peak_alloc_gb={peak:.2f}"
          f"{' (without the capture pool)' if graphs else ''} "
          f"reserved_gb={held:.2f}", flush=True)
    print("[train] losses " + " ".join(f"{x:.4f}" for x in losses),
          flush=True)
    print(f"[train] launches {launches}", flush=True)
    events = log.events("train-step")
    post_warm = log.summary()["post_warmup_compiles"]
    print(f"[train] graphs={graphs} captures={len(events) if graphs else 0}"
          f" capture_wall_s={events[0].wall_s if events else 0.0:.3f} "
          f"post_warmup_captures={post_warm}", flush=True)
    if len(events) != 1 or post_warm:
        raise AssertionError(f"compile log: {len(events)} train-step events, "
                             f"{post_warm} after warm-up (want 1 and 0)")
    if not all(np.isfinite(losses)):
        raise AssertionError("non-finite training loss")
    if not all(torch.equal(t, k) for b, kb in zip(batches, kept)
               for t, k in zip(b, kb)):
        raise AssertionError("a train step wrote into the caller's batch")
    for b in (0, 1):
        own = losses[b::2]
        k = max(1, len(own) // 4)
        if not np.mean(own[-k:]) < np.mean(own[:k]):
            raise AssertionError(f"training loss on batch {b} did not go "
                                 f"down: {own}")
    if launches_per_step is None:
        launches_per_step = cfg.num_hidden_layers if cuda else 0
    for name in ("flash_fwd", "flash_dkdv", "flash_dq"):
        if launches[name] != launches_per_step * steps:
            raise AssertionError(
                f"{name} launched {launches[name]} times in {steps} steps "
                f"(want {launches_per_step} per step)")
    return {"losses": losses, "step_ms": ms, "step_ms_p50": p50,
            "tokens_per_s": tok_s, "mfu": mfu, "peak_alloc_gb": peak,
            "reserved_gb": held,
            "launches": launches, "step": step, "data": data,
            "graphs": graphs, "captures": len(events) if graphs else 0,
            "capture_wall_s": events[0].wall_s}


def small_head_phase(device, cfg=None, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                     steps=3):
    """Phase 7.3: ERNIE-3.0-mini (or ``cfg``) — 12 heads of 32, a head_dim
    the flash kernels do not take — through ``FleetTrainStep`` (AMP O2
    bf16, AdamW): attention takes plain ``_xla_sdpa``, as the reference
    routes that head_dim.  Raises unless every loss is finite and no
    flash kernel launched in the ``steps`` steps."""
    import torch

    from paddle_infer_tpu_torch.models.ernie import ErnieConfig
    from paddle_infer_tpu_torch.ops import _build

    cfg = cfg or ErnieConfig.from_preset("ernie-3.0-mini")
    step = build_train_step(device, cfg, amp_o2=True)
    data = [torch.from_numpy(a).to(device)
            for a in pretrain_batch(cfg.vocab_size, batch, seq)]
    for k in _build.KERNELS.values():
        k.launches = 0
    losses = [float(step(*data)) for _ in range(steps)]
    launches = {n: _build.KERNELS[n].launches
                for n in ("flash_fwd", "flash_dkdv", "flash_dq")}
    print(f"[train] small head: hidden {cfg.hidden_size}, heads "
          f"{cfg.num_attention_heads}, head_dim "
          f"{cfg.hidden_size // cfg.num_attention_heads}, layers "
          f"{cfg.num_hidden_layers}, batch {batch}x{seq}: losses "
          + " ".join(f"{x:.4f}" for x in losses)
          + f" flash launches {launches}", flush=True)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss at a small head_dim: "
                             f"{losses}")
    if any(launches.values()):
        raise AssertionError(f"flash kernels launched at a head_dim they "
                             f"do not take: {launches}")
    step.release_graphs()
    return losses


def step_parity_phase(device, cfg=None, batch=8, seq=TRAIN_SEQ, layers=2,
                      data_seeds=(1, 2, 3)):
    """Phase 7.4: one ``FleetTrainStep`` step (lr 0, so the weights stay
    put) with the flash kernels and again with ``sdpa`` forced to its
    plain version, on the same weights, batch and step key, for the
    batch of each of ``data_seeds``.  fp32: the losses agree to 1e-5
    relative and every gradient to 1e-4 of its max-abs.  O2 bf16: the
    losses to 2e-2, and every gradient to 5e-2 of its max-abs or to twice
    the plain O2 step's own distance from the fp32 step on that tensor,
    whichever is larger — one rule for every tensor: were the kernels'
    step as close to the fp32 step as the plain O2 step is, the two O2
    steps would differ by at most twice that distance (triangle
    inequality).  Prints ``nsp.bias``'s readings (a gradient that
    cancels: the batch mean of per-row p - y) as a witness.  Runs eager
    (``eager()``): the plain side switches attention in Python, which a
    replayed graph would not see."""
    with eager():
        _step_parity(device, cfg, batch, seq, layers, data_seeds)


def _step_parity(device, cfg, batch, seq, layers, data_seeds):
    import torch

    from paddle_infer_tpu_torch.models.ernie import ErnieConfig

    base = cfg or ErnieConfig.from_preset("ernie-3.0-base")
    cfg = ErnieConfig(**dict(vars(base), num_hidden_layers=layers))
    batches = {ds: [torch.from_numpy(a).to(device)
                    for a in pretrain_batch(cfg.vocab_size, batch, seq,
                                            seed=ds)]
               for ds in data_seeds}
    exact = {}                     # data seed -> the plain fp32 gradients
    for amp_o2, (ltol, gtol) in ((False, (1e-5, 1e-4)),
                                 (True, (2e-2, 5e-2))):
        step = build_train_step(device, cfg, amp_o2, lr=0.0)
        for ds, data in batches.items():
            runs = []
            for plain in (False, True):
                with plain_attention() if plain else contextlib.nullcontext():
                    step.keys.seed(11)
                    loss = float(step(*data))
                runs.append((loss, {n: p.grad.float().clone()
                                    for n, p in step.params.items()}))
            (lk, gk), (lp, gp) = runs
            if not amp_o2:
                exact[ds] = gp
            rel = abs(lk - lp) / abs(lp)
            rows = []
            for n in gp:
                err = float((gk[n] - gp[n]).abs().max())
                big = float(gp[n].abs().max())
                noise = own = 0.0
                if amp_o2:
                    noise = float((gp[n] - exact[ds][n]).abs().max())
                    own = float((gk[n] - exact[ds][n]).abs().max())
                rows.append((err / max(gtol * big, 2 * noise, 1e-30), n,
                             err, big, noise, own))
            rows.sort(reverse=True)
            worst = rows[0][0]
            ok = rel <= ltol and worst <= 1.0
            nsp = next(r for r in rows if r[1] == "nsp.bias")
            print(f"[parity] {'O2 bf16' if amp_o2 else 'fp32'} depth "
                  f"{layers} batch {batch} data seed {ds}: loss kernels="
                  f"{lk:.6f} plain={lp:.6f} rel={rel:.3e} (tol {ltol}) "
                  f"worst grad err/allowed={worst:.3e} (allowed: "
                  f"max({gtol} x max-abs, 2 x plain-vs-fp32)) ok={ok}; "
                  "largest (err, max-abs, plain-vs-fp32): "
                  + ", ".join(f"{n} {e:.3e}/{b_:.3e}/{z:.3e}"
                              for _, n, e, b_, z, _ in rows[:3])
                  + f"; nsp.bias over its max-abs: kernels-vs-plain "
                  f"{nsp[2] / nsp[3]:.3e}, plain-vs-fp32 {nsp[4] / nsp[3]:.3e}"
                  f", kernels-vs-fp32 {nsp[5] / nsp[3]:.3e}", flush=True)
            if not ok:
                raise AssertionError("kernel-path train step disagrees with "
                                     "the plain-attention step")
            del runs, gk, gp
        del step


def profile_train(step, data, steps=2, top=14, tag=""):
    """Where a train step's device time goes: ``steps`` steps under
    ``torch.profiler``; prints the device busy share of the wall and the
    top device ops by self time, grouped into the flash kernels, matmul
    and other."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            float(step(*data))
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _profile_rows(prof)
    busy = sum(r[0] for r in rows)
    groups = {"flash_fwd_kernel": 0.0, "flash_dkdv_kernel": 0.0,
              "flash_dq_kernel": 0.0, "matmul": 0.0, "other": 0.0}
    for ms, _, name in rows:
        low = name.lower()
        hit = [g for g in groups if g.startswith("flash") and g in name]
        if hit:
            groups[hit[0]] += ms
        elif any(s in low for s in ("gemm", "xmma", "cutlass", "nvjet",
                                    "matmul", "mm_")):
            groups["matmul"] += ms
        else:
            groups["other"] += ms
    idle = max(0.0, 1 - busy / wall_ms)
    print(f"[profile] train {tag}: {steps} steps wall_ms={wall_ms:.1f} "
          f"device_busy_ms={busy:.1f} idle_share={idle:.3f} groups_ms="
          + json.dumps({k: round(v, 3) for k, v in groups.items()})
          + f" clocks: {clocks_line()}", flush=True)
    for ms, n, name in sorted(rows, reverse=True)[:top]:
        print(f"[profile] {ms:10.3f} ms {n:6d} calls  {name[:110]}",
              flush=True)
    return {"wall_ms": wall_ms, "busy_ms": busy, "idle_share": idle}


def train_pair(device, card):
    """Phase 7.2 on graphs, then eager: ``train_phase`` and a profiled
    pair of steps each; raises unless the 20 losses are EQUAL (the
    kernels use no atomics, so a replay computes what the eager step
    computes).  Returns the graph run."""
    import torch

    runs = {}
    for mode in ("graph", "eager"):
        with eager() if mode == "eager" else contextlib.nullcontext():
            st = train_phase(device)
            st["profile"] = profile_train(st["step"], st["data"], tag=mode)
        st["step"].release_graphs()
        del st["step"], st["data"]
        free_memory()
        runs[mode] = st
    g, e = runs["graph"], runs["eager"]
    equal = torch.equal(torch.tensor(g["losses"]), torch.tensor(e["losses"]))
    print(f"[train] graph vs eager ({card}): step_ms_p50 "
          f"graph={g['step_ms_p50']:.2f} eager={e['step_ms_p50']:.2f} "
          f"tokens_per_s graph={g['tokens_per_s']:.0f} "
          f"eager={e['tokens_per_s']:.0f} idle_share "
          f"graph={g['profile']['idle_share']:.3f} "
          f"eager={e['profile']['idle_share']:.3f} "
          f"captures={g['captures']} capture_wall_s={g['capture_wall_s']:.3f}"
          f" reserved_gb graph={g['reserved_gb']:.2f} "
          f"eager={e['reserved_gb']:.2f} losses_equal={equal}", flush=True)
    if not equal:
        raise AssertionError("graph train losses differ from eager ones:\n"
                             f"{g['losses']}\n{e['losses']}")
    return g


# ------------------------------------------------------------------ main

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from paddle_infer_tpu_torch import native
        from paddle_infer_tpu_torch.ops import _build
        from paddle_infer_tpu_torch.ops import paged_attention as PA
        from paddle_infer_tpu_torch.ops import \
            ragged_paged_attention as RPA
        from paddle_infer_tpu_torch.ops import flash_attention  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    device = torch.device("cuda")

    # phase 1: card
    card = card_line()
    print(f"[card] {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    # phase 2: build
    t0 = time.perf_counter()
    nvcc_s = _build.build(_build.sources())
    native.build()
    print(f"[build] kernels {nvcc_s:.1f}s, total "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    for src, log in _build.BUILD_LOG.items():
        print_ptxas(f"[build] {src}", log)
    print(f"[build] paged decode / verify: kSplitPages={PA.split_pages()}",
          flush=True)

    # phase 3: kernels against their plain versions; the ragged kernel
    # also at the prefill-heavy case (p), and chunked two other ways
    case = make_case(device)
    kres = check_kernels(case)
    kres["ragged_paged_attention"].update({
        f"p/{kind}": rec for kind, rec in check_ragged(
            prefill_case(case), tag="p").items()})
    check_chunk_independence(device)

    # phase 4: serve LLaMA-7B on graphs; counts zeroed just before, read
    # just after; then the same run eager, streams EQUAL
    t0 = time.perf_counter()
    model = build_llama(device)
    torch.cuda.synchronize()
    print(f"[serve] llama-7b built in {time.perf_counter() - t0:.1f}s: "
          f"hidden {model.config.hidden_size}, layers "
          f"{model.config.num_hidden_layers}, params "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.2f}B bf16",
          flush=True)
    for k in _build.KERNELS.values():
        k.launches = 0
    stats = serve(model, device)
    launches = {n: k.launches for n, k in _build.KERNELS.items()}
    L = model.config.num_hidden_layers
    print(f"[serve] steps={stats['steps']} wall_s={stats['wall_s']:.3f} "
          f"generated={stats['generated_tokens']} "
          f"tokens_per_s={stats['tokens_per_s']:.2f} "
          f"step_ms_p50={_p50_after_first(stats):.1f} (steps after "
          f"the first) "
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.1f} "
          f"captures={stats['captures']} "
          f"capture_wall_s={stats['capture_wall_s']:.3f} "
          f"post_warmup_captures={stats['post_warmup_captures']}",
          flush=True)
    print("[serve] ttft_s " + " ".join(
        f"{n}:{t:.3f}" for n, t in zip(PROMPT_LENS, stats["ttft_s"])),
        flush=True)
    print("[serve] step_ms " + " ".join(f"{t:.1f}"
                                        for t in stats["step_ms"]),
          flush=True)
    print(f"[serve] launches {launches}", flush=True)
    _check_decode_launches(dict(stats, launches=launches), L, "serve")
    _check_ragged_launches(dict(stats, launches=launches), L, "serve")
    eager_stats = eager_twin(model, device, "serve", stats, card)
    # phase 4b: the serve run's step log, traces, journeys, exposition
    observability_phase(stats, eager_stats["streams"], card)
    del eager_stats
    reference_check(model, device)
    profile_pair(model, device, "plain", card)

    # the ragged kernel's opt-in single-launch entry point (every row
    # type in one launch) at the serving shapes
    q, qc, _, kp, vp, _, _ = _cast(case, "bf16")
    before = _build.KERNELS["ragged_paged_attention"].launches
    RPA.ragged_paged_attention(qc, kp, vp, case["tables"], case["ctx"],
                               case["qlens"], use_kernel=True)
    torch.cuda.synchronize()
    if _build.KERNELS["ragged_paged_attention"].launches != before + 1:
        raise AssertionError("ragged kernel entry point launched nothing")

    # phase 5: speculation on the same model; counts zeroed per run
    runs = spec_phase(model, device, card)
    tiled = tiled_prompts(model.config.vocab_size, (512, 8), seed=6)
    profile_pair(model, device, "spec", card, prompts=tiled, max_new=8,
                 speculate=True, num_draft_tokens=NUM_DRAFT,
                 draft_source="ngram", sampled=())
    by_run = {"paged_verify": {f"llama {t}": runs[t]["launches"][
        "paged_verify"] for t in ("b", "c")}}
    for name in ("paged_decode", "ragged_paged_attention"):
        by_run[name] = {"serve": launches[name]}

    # phase 6: the prefix cache, warm against cold, on bf16 pools
    pruns = prefix_phase(model, device, card)
    # phase 7: replay through faults under the supervisor
    rres = resilience_phase(model, device, card)
    # phase 8: int8 pools (serve, reference, prefix, speculation, the
    # writer alone, a profile)
    iruns = int8_phase(model, device, card, stats)
    for name in ("paged_decode", "ragged_paged_attention"):
        by_run[name].update({
            "prefix warm": pruns["warm"]["launches"][name],
            "resilience clean": rres["clean"]["launches"][name],
            "resilience faulted": rres["faulted"]["launches"][name],
            "int8 serve": iruns["serve"]["launches"][name],
            "int8 prefix warm": iruns["prefix"]["warm"]["launches"][name]})
    by_run["paged_verify"]["int8 spec"] = \
        iruns["spec"]["launches"]["paged_verify"]

    # phase 9: the engines' own entry points on the same model
    gen = generate_phase(model, device, card)
    by_run["paged_decode"]["generate"] = gen["decode"]

    # phase 10: GPT, with the LLaMA model freed first
    del model
    free_memory()
    gst = gpt_phase(device, card=card)
    by_run["paged_verify"]["gpt"] = gst["launches"]["paged_verify"]
    for name, runs_of in by_run.items():
        launches[name] = sum(runs_of.values())

    # phase 11: training, GPT freed first
    free_memory()
    fres = flash_kernels_phase(device)
    hybrid_vs_flash(device)
    tst = train_pair(device, card)
    by_run["flash_fwd"] = {"train": tst["launches"]["flash_fwd"],
                           "generate": gen["flash"]}
    for name in ("flash_fwd", "flash_dkdv", "flash_dq"):
        launches[name] = sum(by_run[name].values()) if name in by_run \
            else tst["launches"][name]
        kres[name] = {"bf16": dict(fres[("a", "bf16", 0.1)][name])}
        # SDPA is the same function only at dropout 0
        kres[name]["bf16"]["library_ms"] = \
            fres[("a", "bf16", 0.0)][name]["library_ms"]
        for (tag, kind, p), rec in fres.items():
            kres[name][f"{tag}/{kind}/dropout{p}"] = rec[name]
    del tst
    free_memory()
    small_head_phase(device)
    free_memory()
    step_parity_phase(device)

    # phase 12: the kernels line, the card line, the result line
    line = []
    for name, k in _build.KERNELS.items():
        rec = kres[name]["bf16"]
        line.append({
            "name": name, "route": "cuda",
            "source": f"paddle_infer_tpu_torch/ops/csrc/{k.source}",
            "replaces": k.replaces, "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "library_ms": rec.get("library_ms"),
            "dtype": "bf16",
            "all": {kind: {kk: v for kk, v in r.items()}
                    for kind, r in kres[name].items()},
            **({"launches_by_run": by_run[name]} if name in by_run
               else {})})
    print(json.dumps({"kernels": line}), flush=True)
    print(f"[card] {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
