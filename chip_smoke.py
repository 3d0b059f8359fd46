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
7. train — GPT freed: (1) the flash kernels (forward, dK/dV, dQ) against
   their plain versions at (a) the ERNIE shape B=32, H=12, S=512, D=64
   with 10 % trailing padding as segment ids, dropout 0.1 and 0, fp32
   and bf16, (b) B=2, H=32, S=4096, D=128 causal bf16, (c) Sq=256 <
   Sk=512 causal, (d) B=4, H=8, S=2000, D=256 causal with padding,
   timed at (a), (b) and (d) beside the plain version, the bound and
   SDPA, and ``hybrid_attention`` against ``flash_attention`` at (a);
   (2) ERNIE-3.0-base pretraining at full width and depth through
   ``FleetTrainStep`` (batch 32 x 512, dropout 0.1, AMP O2 bf16, AdamW
   lr 1e-4): 2 warm-up and 20 timed steps, the loss falling and each
   flash kernel launched once per layer per step; (3) one step at depth
   2, batch 8 with the kernels against the same step with plain
   attention, fp32 and O2, on three batches; (4) a profiled train step;
8. the kernels line (one JSON object), the card line, and last
   ``{"ok": true, "device": {...}}``.

Without a card, or without the repository beside it, it exits non-zero
before printing any result.  It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
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


def reference_check(model, device, n_prompt=33, n_decode=4, page=16,
                    tol=5e-2):
    """The paged ragged forward (one prompt chunk, then decode steps)
    against the dense causal forward of the same model on the same
    tokens, its attention the plain version: max |logit difference|
    relative to the logits' magnitude."""
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
        with plain_attention():
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


# ---------------------------------------------------------------- phase 7

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
    delta = FA._delta(do, ref_o)

    def plain_grads():
        return _plain_chunks(
            lambda t, s: FA._grads_reference(
                *[x.float() for x in t[:4]], t[4], t[5], *s, **cfg),
            case, (q, k, v, do, ref_lse, delta))

    rdq, rdk, rdv = plain_grads()
    dk, dv = FA.flash_dkdv(q, k, v, do, ref_lse, delta, seg, seg, **cfg)
    dq = FA.flash_dq(q, k, v, do, ref_lse, delta, seg, seg, **cfg)
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
    if timed:
        out["flash_fwd"]["ms"] = time_ms(
            lambda: FA.flash_fwd(q, k, v, seg, seg, **cfg))
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
        out["flash_dkdv"]["library_ms"] = out["flash_dq"]["library_ms"] = \
            lib and lib[1]
    return out


def _sdpa_library_ms(case, q, k, v, do):
    """``torch.nn.functional.scaled_dot_product_attention`` on the same
    inputs (the segment mask as a boolean ``attn_mask``; causal as
    ``is_causal``): (forward ms, forward + backward ms minus forward)."""
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
    kw = dict(attn_mask=mask, is_causal=case["causal"] and mask is None,
              scale=case["scale"])
    fwd = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, **kw))

    def both():
        F.scaled_dot_product_attention(q4, k4, v4, **kw).backward(do4)
    return fwd, time_ms(both) - fwd


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
    bad = [(key, n) for key, rec in results.items() for n, r in rec.items()
           if not r["ok"]]
    if bad:
        raise AssertionError(f"flash kernels disagree with their plain "
                             f"versions: {bad}")
    return results


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
    steps, then ``steps`` timed steps on the same batch with the launch
    counts zeroed just before and read just after.  Raises unless every
    loss is finite, the last five losses average below the first five,
    and each flash kernel launched ``launches_per_step`` times per step
    (default: once per layer on the card, not checked on the CPU)."""
    import torch

    from paddle_infer_tpu_torch.models.ernie import ErnieConfig
    from paddle_infer_tpu_torch.ops import _build

    cuda = device.type == "cuda"
    cfg = cfg or ErnieConfig.from_preset("ernie-3.0-base")
    t0 = time.perf_counter()
    step = build_train_step(device, cfg, amp_o2)
    n_params = sum(p.numel() for p in step.params.values())
    print(f"[train] ernie built in {time.perf_counter() - t0:.1f}s: hidden "
          f"{cfg.hidden_size}, layers {cfg.num_hidden_layers}, vocab "
          f"{cfg.vocab_size}, params {n_params / 1e6:.1f}M fp32, batch "
          f"{batch}x{seq}, amp {'O2 bf16' if amp_o2 else 'off'}", flush=True)
    data = [torch.from_numpy(a).to(device)
            for a in pretrain_batch(cfg.vocab_size, batch, seq)]
    for _ in range(warmup):
        step(*data)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for k in _build.KERNELS.values():
        k.launches = 0
    losses, ms = [], []
    for _ in range(steps):
        t = time.perf_counter()
        losses.append(float(step(*data)))       # syncs on the loss
        ms.append((time.perf_counter() - t) * 1e3)
    launches = {n: k.launches for n, k in _build.KERNELS.items()}
    p50 = float(np.median(ms))
    tok_s = batch * seq / (p50 / 1e3)
    flops_tok = 6 * n_params + 12 * cfg.num_hidden_layers * seq \
        * cfg.hidden_size
    mfu = tok_s * flops_tok / H100_BF16_PEAK
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
    print(f"[train] steps={steps} step_ms_p50={p50:.2f} step_ms_min="
          f"{min(ms):.2f} step_ms_max={max(ms):.2f} tokens_per_s="
          f"{tok_s:.0f} mfu={mfu:.4f} (6N+12Lsh per token over "
          f"{H100_BF16_PEAK:.0e}) peak_mem_gb={peak:.2f}", flush=True)
    print("[train] losses " + " ".join(f"{x:.4f}" for x in losses),
          flush=True)
    print(f"[train] launches {launches}", flush=True)
    if not all(np.isfinite(losses)):
        raise AssertionError("non-finite training loss")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError("training loss did not go down: "
                             f"{losses[:5]} ... {losses[-5:]}")
    if launches_per_step is None:
        launches_per_step = cfg.num_hidden_layers if cuda else 0
    for name in ("flash_fwd", "flash_dkdv", "flash_dq"):
        if launches[name] != launches_per_step * steps:
            raise AssertionError(
                f"{name} launched {launches[name]} times in {steps} steps "
                f"(want {launches_per_step} per step)")
    return {"losses": losses, "step_ms": ms, "step_ms_p50": p50,
            "tokens_per_s": tok_s, "mfu": mfu, "peak_mem_gb": peak,
            "launches": launches, "step": step, "data": data}


def step_parity_phase(device, cfg=None, batch=8, seq=TRAIN_SEQ, layers=2,
                      data_seeds=(1, 2, 3)):
    """Phase 7.3: one ``FleetTrainStep`` step (lr 0, so the weights stay
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
    cancels: the batch mean of per-row p - y) as a witness."""
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


def profile_train(step, data, steps=2, top=14):
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
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t > 0:
            rows.append((t / 1e3, e.count, e.key))
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
    print(f"[profile] train: {steps} steps wall_ms={wall_ms:.1f} "
          f"device_busy_ms={busy:.1f} idle_share="
          f"{max(0.0, 1 - busy / wall_ms):.3f} groups_ms="
          + json.dumps({k: round(v, 3) for k, v in groups.items()}),
          flush=True)
    for ms, n, name in sorted(rows, reverse=True)[:top]:
        print(f"[profile] {ms:10.3f} ms {n:6d} calls  {name[:110]}",
              flush=True)


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
        fn = "?"
        for line in log.splitlines():
            m = re.search(r"([a-z]+_[a-z]+_kernel(?:_[a-z0-9]+)?)I(\w+?)EEv",
                          line)
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

    # phase 7: training, GPT freed first
    gc.collect()
    torch.cuda.empty_cache()
    fres = flash_kernels_phase(device)
    hybrid_vs_flash(device)
    tst = train_phase(device)
    profile_train(tst["step"], tst["data"])
    for name in ("flash_fwd", "flash_dkdv", "flash_dq"):
        launches[name] = tst["launches"][name]
        kres[name] = {"bf16": dict(fres[("a", "bf16", 0.1)][name])}
        # SDPA is the same function only at dropout 0
        kres[name]["bf16"]["library_ms"] = \
            fres[("a", "bf16", 0.0)][name]["library_ms"]
        for (tag, kind, p), rec in fres.items():
            kres[name][f"{tag}/{kind}/dropout{p}"] = rec[name]
    del tst
    gc.collect()
    torch.cuda.empty_cache()
    step_parity_phase(device)

    # phase 8: the kernels line, the card line, the result line
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
