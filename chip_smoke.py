#!/usr/bin/env python3
"""Drive the PyTorch port (``paddle_infer_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero:

1. card — name and power limit (``nvidia-smi``), TF32 off for matmul
   and cuDNN;
2. build — the CUDA kernels (one ``nvcc`` per source, in parallel) and
   the native KV block pool, from the checkout's sources;
3. kernels — every kernel against its plain PyTorch version at the
   serving shapes (B=8, H=32, D=128, page 16, 128 pages per row,
   contexts over 1..2048; the ragged kernel at C=512 with decode, chunk
   and inactive rows; the verify kernel at W=5 with lane lengths
   ctx + j + 1, every lane also EQUAL to the decode kernel at its
   length), fp32, bf16 and int8 pages, each timed with CUDA events
   (median of 25 after warm-up) beside its plain version and its bound;
4. serve — LLaMA-7B at full width and depth (random bf16 weights from a
   seeded on-device generator) behind ``EngineCore``: 8 requests with
   prompts of 1536..1 tokens, 32 new tokens each, 6 greedy and 2
   sampled, driven to completion with launch counts zeroed just before
   and read just after; then the paged forward against the dense one on
   a small input, and the ragged kernel's own entry point
   (``ragged_paged_attention(use_kernel=True)``) at the serving shapes;
5. spec — the same LLaMA-7B core shape with ``num_draft_tokens=4``: 8
   greedy requests plain (a), then ``speculate=True`` with an oracle
   draft source proposing run (a)'s streams (b: streams equal to (a),
   every draft accepted), then ``speculate=True`` with ngram drafts on
   tiled prompts, 2 of 8 requests sampled (c: greedy streams equal to a
   plain run of the same prompts); the verify kernel launches at least
   once per layer per step in (b) and (c);
6. gpt — the LLaMA model freed, ``gpt3-6.7b`` at full width and depth
   (random bf16 weights) serves 8 requests with ngram speculation, then
   its paged forward against its dense one;
7. the kernels line (one JSON object), the card line, and last
   ``{"ok": true, "device": {...}}``.

Without a card, or without the repository beside it, it exits non-zero
before printing any result.  It imports nothing of JAX.
"""
from __future__ import annotations

import gc
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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout else \
        f"nvidia-smi failed: {out.stderr.strip()}"


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
            rec["ms"] = time_ms(lambda: PA.paged_attention_verify(
                qv, kp, vp, tables, vlens))
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
              f"tol={tol} ok={ok} " + " ".join(
                  f"{k}={v:.4f}" for k, v in rec.items()
                  if k in ("ms", "plain_ms", "decode_x_w_ms", "bound_ms")),
              flush=True)
    bad = [k for k, v in out.items() if not v["ok"]]
    if bad:
        raise AssertionError(f"paged_verify disagrees (lanes vs decode or "
                             f"vs plain) for {bad}")
    return out


def check_kernels(case, kinds=("fp32", "bf16", "int8"), timed=True):
    """Each kernel against its plain version on the same inputs.
    Returns ``{kernel: {kind: record}}``; raises on a disagreement."""
    import torch

    from paddle_infer_tpu_torch.ops import paged_attention as PA
    from paddle_infer_tpu_torch.ops import ragged_paged_attention as RPA

    tables, lengths = case["tables"], case["lengths"]
    ctx, qlens = case["ctx"], case["qlens"]
    C = case["qc"].shape[1]
    ln = lengths.cpu().numpy().astype(np.int64)
    cx = ctx.cpu().numpy().astype(np.int64)
    ql = qlens.cpu().numpy().astype(np.int64)
    valid = (torch.arange(C, device=qlens.device)[None]
             < qlens[:, None].long())
    results = {"paged_decode": {}, "ragged_paged_attention": {}}
    for kind in kinds:
        q, qc, _, kp, vp, kp_ref, vp_ref = _cast(case, kind)
        tol = TOL[kind]

        dec = PA.paged_attention_decode(q, kp, vp, tables, lengths)
        ref = PA._decode_plain(q.float(), kp_ref, vp_ref, tables, lengths)
        err = float((dec.float() - ref).abs().max())
        ok = bool(torch.allclose(dec.float(), ref, atol=tol, rtol=tol))
        byts, flops = _bytes_decode(case, kind, ln)
        rec = {"max_abs_err": err, "tol": tol, "ok": ok}
        if timed:
            rec["ms"] = time_ms(lambda: PA.paged_attention_decode(
                q, kp, vp, tables, lengths))
            rec["plain_ms"] = time_ms(lambda: PA._decode_plain(
                q, kp, vp, tables, lengths), reps=10)
            rec["bound_ms"], rec["bound_by"] = _bound(byts, flops, kind)
        results["paged_decode"][kind] = rec
        print(f"[kernels] paged_decode {kind}: max_abs_err={err:.3e} "
              f"tol={tol} ok={ok} " + " ".join(
                  f"{k}={v:.4f}" for k, v in rec.items()
                  if k in ("ms", "plain_ms", "bound_ms")), flush=True)

        rag = RPA.ragged_kernel(qc, kp, vp, tables, ctx, qlens)
        ref = RPA._ragged_plain(qc.float(), kp_ref, vp_ref, tables, ctx,
                                qlens)
        diff = (rag.float() - ref)[valid]
        err = float(diff.abs().max())
        ok = bool(torch.allclose(rag.float()[valid], ref[valid], atol=tol,
                                 rtol=tol))
        # a qlen == 1 row must match the decode kernel at ctx + 1
        one = qlens == 1
        dec1 = PA.paged_attention_decode(qc[:, 0].contiguous(), kp, vp,
                                         tables, (ctx + 1).int())
        err1 = float((rag[:, 0].float() - dec1.float())[one].abs().max())
        ok = ok and err1 <= tol
        byts, flops = _bytes_ragged(case, kind, cx, ql, C)
        rec = {"max_abs_err": err, "decode_row_err": err1, "tol": tol,
               "ok": ok}
        if timed:
            rec["ms"] = time_ms(lambda: RPA.ragged_kernel(
                qc, kp, vp, tables, ctx, qlens))
            rec["plain_ms"] = time_ms(lambda: RPA._ragged_plain(
                qc, kp, vp, tables, ctx, qlens), reps=10)
            rec["bound_ms"], rec["bound_by"] = _bound(byts, flops, kind)
        results["ragged_paged_attention"][kind] = rec
        print(f"[kernels] ragged_paged_attention {kind}: max_abs_err="
              f"{err:.3e} decode_row_err={err1:.3e} tol={tol} ok={ok} "
              + " ".join(f"{k}={v:.4f}" for k, v in rec.items()
                         if k in ("ms", "plain_ms", "bound_ms")),
              flush=True)
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


def serve(model, device, prompt_lens=PROMPT_LENS, max_new=MAX_NEW,
          max_model_len=2048, token_budget=512, page_size=16, max_batch=8,
          prompts=None, sampled=SAMPLED, **core_kw):
    """Serve one request per prompt length (or per given prompt) through
    EngineCore, the requests in ``sampled`` sampling and the rest
    greedy; ``core_kw`` goes to EngineCore (speculation).  Returns the
    run's numbers.  Raises if a request fails or a stream is off."""
    import torch

    from paddle_infer_tpu_torch.inference.generation import (
        GenerationConfig, PagedGenerationEngine)
    from paddle_infer_tpu_torch.serving import EngineCore, RequestState

    vocab = model.config.vocab_size
    engine = PagedGenerationEngine(model, page_size=page_size,
                                   device=device)
    core = EngineCore(engine, max_batch=max_batch,
                      max_model_len=max_model_len,
                      token_budget=token_budget, prefill_chunk=token_budget,
                      device=device, **core_kw)
    finite = []
    step = engine._model_step

    def checked_step(params, ids, pos, caches):
        logits, new = step(params, ids, pos, caches)
        qlens = caches[0][4].long()
        rows = torch.arange(ids.shape[0], device=ids.device)
        last = logits[rows, torch.clamp(qlens - 1, min=0)][qlens > 0]
        finite.append(bool(torch.isfinite(last).all()))
        return logits, new

    engine._model_step = checked_step
    if prompts is None:
        rs = np.random.RandomState(0)
        prompts = [rs.randint(0, vocab, (n,)).astype(np.int32)
                   for n in prompt_lens]
    reqs = []
    try:
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
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        core.close()
    bad = [(r.rid, r.state.value, repr(r.error)) for r in reqs
           if r.state != RequestState.DONE]
    if bad:
        raise AssertionError(f"requests not DONE: {bad}")
    for r in reqs:
        toks = np.asarray(r.tokens)
        if len(toks) != max_new or toks.min() < 0 or toks.max() >= vocab:
            raise AssertionError(f"request {r.rid}: bad stream {toks}")
    if not all(finite):
        raise AssertionError("non-finite last-position logits in a step")
    gen = sum(len(r.tokens) for r in reqs)
    spec = core.metrics_snapshot()["speculation"]
    return {"steps": core._step_idx, "wall_s": wall,
            "generated_tokens": gen, "tokens_per_s": gen / wall,
            "ttft_s": [r.first_token_at - r.arrival for r in reqs],
            "step_ms": [t["wall_s"] * 1e3 for t in core.step_trace],
            "drafts_proposed": spec["drafts_proposed"],
            "drafts_accepted": spec["drafts_accepted"],
            "prompts": prompts, "streams": [list(r.tokens) for r in reqs]}


def reference_check(model, device, n_prompt=33, n_decode=4, page=16,
                    tol=5e-2):
    """The paged ragged forward (one prompt chunk, then decode steps)
    against the dense causal forward of the same model on the same
    tokens: max |logit difference| relative to the logits' magnitude."""
    import torch

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
    pools = [(torch.zeros(P, H, page, D, dtype=dtype, device=device),
              torch.zeros(P, H, page, D, dtype=dtype, device=device))
             for _ in range(L)]
    with torch.inference_mode():
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
    print(f"[reference] paged vs dense logits ({n_prompt}-token chunk + "
          f"{n_decode} decode steps): max_abs_err={err:.4e} "
          f"logit_scale={scale:.4e} rel_tol={tol} ok={ok}", flush=True)
    if not ok:
        raise AssertionError("paged forward disagrees with dense forward")
    return err, scale


def profile_serving(model, device, prompt_lens=(512, 1), max_new=4,
                    top=12, tag="plain", **serve_kw):
    """Where a serving step's device time goes: a short run (one chunk
    step, then decode steps) under ``torch.profiler``; prints the device
    busy share of the run's wall and the top kernels by self device
    time, grouped also into matmul / attention-kernel / other."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        stats = serve(model, device, prompt_lens=prompt_lens,
                      max_new=max_new, **serve_kw)
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
    busy_ms = sum(r[0] for r in rows)
    wall_ms = stats["wall_s"] * 1e3
    groups = {"matmul": 0.0, "paged_decode_kernel": 0.0,
              "paged_verify_kernel": 0.0, "other": 0.0}
    for ms, _, name in rows:
        low = name.lower()
        if "paged_decode_kernel" in name:
            groups["paged_decode_kernel"] += ms
        elif "paged_verify_kernel" in name:
            groups["paged_verify_kernel"] += ms
        elif any(s in low for s in ("gemm", "xmma", "cutlass", "nvjet",
                                    "matmul", "mm_")):
            groups["matmul"] += ms
        else:
            groups["other"] += ms
    print(f"[profile] {tag}: {len(stats['prompts'])} requests, "
          f"{stats['steps']} steps: "
          f"wall_ms={wall_ms:.1f} device_busy_ms={busy_ms:.1f} "
          f"idle_share={max(0.0, 1 - busy_ms / wall_ms):.3f} groups_ms="
          + json.dumps({k: round(v, 3) for k, v in groups.items()}),
          flush=True)
    for ms, n, name in sorted(rows, reverse=True)[:top]:
        print(f"[profile] {ms:10.3f} ms {n:6d} calls  {name[:110]}",
              flush=True)


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
    steps = np.asarray(st["step_ms"])
    print(f"[{tag}] steps={st['steps']} wall_s={st['wall_s']:.3f} "
          f"generated={st['generated_tokens']} "
          f"tokens_per_s={st['tokens_per_s']:.2f} "
          f"step_ms_p50={np.median(steps):.1f} "
          f"drafts_proposed={st['drafts_proposed']} "
          f"drafts_accepted={st['drafts_accepted']} "
          f"launches={st['launches']}", flush=True)
    return st


def _check_verify_launches(st, L, tag):
    n = st["launches"]["paged_verify"]
    if n < L * st["steps"]:
        raise AssertionError(f"{tag}: paged_verify launched {n} times in "
                             f"{st['steps']} steps (< {L} per step)")


def spec_phase(model, device):
    """Runs (a) plain, (b) oracle speculation, (c) ngram speculation on
    tiled prompts with 2 sampled rows and its plain twin; raises unless
    (b) equals (a) with every draft accepted and (c)'s greedy streams
    equal its plain twin's."""
    L = model.config.num_hidden_layers
    vocab = model.config.vocab_size
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, vocab, (n,)).astype(np.int32)
               for n in SPEC_PROMPT_LENS]
    spec = dict(speculate=True, num_draft_tokens=NUM_DRAFT)
    runs = {"a": serve_counted(model, device, "spec a plain",
                               prompts=prompts, sampled=())}
    runs["b"] = serve_counted(
        model, device, "spec b oracle", prompts=prompts, sampled=(),
        draft_source=OracleDrafts(prompts, runs["a"]["streams"]), **spec)
    if runs["b"]["streams"] != runs["a"]["streams"]:
        raise AssertionError("oracle-speculative greedy streams differ "
                             "from plain ones")
    if not (runs["b"]["drafts_accepted"] == runs["b"]["drafts_proposed"]
            > 0):
        raise AssertionError(f"oracle drafts: {runs['b']['drafts_accepted']}"
                             f" of {runs['b']['drafts_proposed']} accepted")
    tiled = tiled_prompts(vocab, SPEC_PROMPT_LENS, seed=4)
    runs["c_plain"] = serve_counted(model, device, "spec c plain",
                                    prompts=tiled)
    runs["c"] = serve_counted(model, device, "spec c ngram", prompts=tiled,
                              draft_source="ngram", **spec)
    greedy = [i for i in range(len(tiled)) if i not in SAMPLED]
    if any(runs["c"]["streams"][i] != runs["c_plain"]["streams"][i]
           for i in greedy):
        raise AssertionError("ngram-speculative greedy streams differ from "
                             "plain ones")
    for tag in ("b", "c"):
        _check_verify_launches(runs[tag], L, f"spec {tag}")
    return runs


# ---------------------------------------------------------------- phase 6

def gpt_phase(device, config=None, dtype=None):
    """gpt3-6.7b (or ``config``) at full width and depth: ngram-speculative
    serving of 8 requests, then paged vs dense logits."""
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
    st = serve_counted(model, device, "gpt ngram", prompts=prompts,
                       max_model_len=cfg.max_position_embeddings,
                       speculate=True, num_draft_tokens=NUM_DRAFT,
                       draft_source="ngram")
    if cuda:
        print(f"[gpt] peak_mem_gb="
              f"{torch.cuda.max_memory_allocated() / 1e9:.1f}", flush=True)
    _check_verify_launches(st, cfg.num_hidden_layers, "gpt")
    reference_check(model, device)
    return st


# ------------------------------------------------------------------ main

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from paddle_infer_tpu_torch import native
        from paddle_infer_tpu_torch.ops import _build
        from paddle_infer_tpu_torch.ops import \
            ragged_paged_attention as RPA
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
        fn = "?"
        for line in log.splitlines():
            m = re.search(r"([a-z]+_[a-z]+_kernel)I(\w+?)EEv", line)
            if "Compiling entry" in line and m:
                fn = f"{m.group(1)}<{m.group(2)}>"
            elif "registers" in line or "spill" in line:
                print(f"[build] {src} {fn}: {line.strip()}", flush=True)

    # phase 3: kernels against their plain versions
    case = make_case(device)
    kres = check_kernels(case)

    # phase 4: serve LLaMA-7B; counts zeroed just before, read just after
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
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.1f}",
          flush=True)
    print("[serve] ttft_s " + " ".join(
        f"{n}:{t:.3f}" for n, t in zip(PROMPT_LENS, stats["ttft_s"])),
        flush=True)
    print("[serve] step_ms " + " ".join(f"{t:.1f}"
                                        for t in stats["step_ms"]),
          flush=True)
    print(f"[serve] launches {launches}", flush=True)
    if launches["paged_decode"] < L * stats["steps"]:
        raise AssertionError(
            f"paged_decode launched {launches['paged_decode']} times in "
            f"{stats['steps']} steps (< {L} per step)")
    reference_check(model, device)
    profile_serving(model, device)

    # the ragged kernel's own path: its entry point at the serving shapes
    q, qc, _, kp, vp, _, _ = _cast(case, "bf16")
    for k in _build.KERNELS.values():
        k.launches = 0
    RPA.ragged_paged_attention(qc, kp, vp, case["tables"], case["ctx"],
                               case["qlens"], use_kernel=True)
    torch.cuda.synchronize()
    launches["ragged_paged_attention"] = \
        _build.KERNELS["ragged_paged_attention"].launches
    if launches["ragged_paged_attention"] < 1:
        raise AssertionError("ragged kernel entry point launched nothing")

    # phase 5: speculation on the same model; counts zeroed per run
    runs = spec_phase(model, device)
    tiled = tiled_prompts(model.config.vocab_size, (512, 8), seed=6)
    profile_serving(model, device, prompts=tiled, max_new=8, tag="spec",
                    speculate=True, num_draft_tokens=NUM_DRAFT,
                    draft_source="ngram", sampled=())
    by_run = {f"llama {t}": runs[t]["launches"]["paged_verify"]
              for t in ("b", "c")}

    # phase 6: GPT, with the LLaMA model freed first
    del model
    gc.collect()
    torch.cuda.empty_cache()
    gst = gpt_phase(device)
    by_run["gpt"] = gst["launches"]["paged_verify"]
    launches["paged_verify"] = sum(by_run.values())

    # phase 7: the kernels line, the card line, the result line
    line = []
    for name, k in _build.KERNELS.items():
        rec = kres[name]["bf16"]
        line.append({
            "name": name, "route": "cuda",
            "source": f"paddle_infer_tpu_torch/ops/csrc/{k.source}",
            "replaces": k.replaces, "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None,
            "dtype": "bf16",
            "all": {kind: {kk: v for kk, v in r.items()}
                    for kind, r in kres[name].items()},
            **({"launches_by_run": by_run} if name == "paged_verify"
               else {})})
    print(json.dumps({"kernels": line}), flush=True)
    print(f"[card] {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
