#!/usr/bin/env python3
"""Drive the PyTorch port (``paddle_infer_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [kernels] [serve] [legacy] [sharded] [gpt] [moe]
                          [train] [hapi] [moe_train] [mesh_train]

With no argument every phase runs (the driver's run).  Named phases
run alone, after card and build: ``kernels`` is phase 3, ``serve``
phases 4 to 9c but 9d, ``legacy`` phase 9d (on its own LLaMA-7B, after
its own ragged serve run), ``sharded`` phase 9s (always on its own
4-layer LLaMA-7B, with its own one-device serve run to compare against,
and the ep run (d) after the MoE phase's serve run (a)), ``gpt`` 10,
``moe`` 10a, ``train`` 11 and 11.5, ``hapi`` 11.6, ``moe_train``
11.7, ``mesh_train`` 11.8; the kernels line (12) needs ``kernels`` and
``train``.

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
8a. kv_tier — the host KV tier (256 host pages, 2.15 GB of bf16 KV) on
   the serve model: (a) the serve prompts and seeds parked after steps 1
   (the 1536-token row between its chunks, 512 KV tokens) and 12 (the
   1024-token row mid-decode), held 16 steps each by a 0.99 / 0.01
   watermark gap, on bf16 and on int8 pools, every stream EQUAL to the
   unparked serve run's; (b) the same prompts under ``EngineSupervisor``
   with ``kv.alloc`` MemoryErrors at the 3rd and 6th admission: rows
   park instead of the ladder advancing, no shed, no retry, every park
   resumed, streams EQUAL; (c) the prefix phase's prompts with no
   headroom and retention cut to 5 % of the pool: full blocks demote to
   the host and promote back, warm streams EQUAL to cold; (d) a
   ``kv.swap_out`` script on the first victim (three failed attempts,
   its slot untouched, the next row parks) and a ``kv.swap_in`` one on
   that row (three failed attempts, it replays), streams EQUAL; (e) 97
   pages (a 1551-token row, 0.81 GB) gathered to the host and scattered
   back, the walls per page and the GB/s, beside the park and resume
   records' walls; every run the decode and ragged kernels once per
   layer per step, one capture, none after warm-up;
8b. structured — grammar-constrained decoding over the demo vocabulary
   (``default_vocab(32000, (eos, pad))``): the tool-call grammar's
   compile seconds and ``neg_mask`` bytes; the serve prompts with two
   rows under the tool-call grammar (one greedy, one sampled, 64 new
   tokens): both conform, the six plain rows EQUAL the serve run's, the
   step p50 with the mask beside the serve run's; the same under
   speculation with oracle drafts (greedy rows EQUAL, the verify kernel
   once per layer per step); the two grammar rows parked and resumed,
   EQUAL; 32 distinct grammars through one warm core with one capture
   and none after warm-up, every output conforming;
8c. http — the port's entry point as a user starts it: the serve model
   saved with ``save_pretrained`` (``model.pits``, about 13.5 GB) into
   a temporary directory and served by ``python -m
   paddle_infer_tpu_torch.tools.serve --max_batch 8 --max_model_len 2048
   --token_budget 512`` on the card, in its own process (stopped in a
   ``finally``); the serve phase's 8 prompts posted greedy with 32 new
   tokens, one ``/generate`` body each (a body's rows share one
   length), EQUAL to an in-process run of the same prompts through a
   fresh core over the same model, and as ``/generate_stream``s that
   concatenate to them; the Prometheus exposition valid with the
   ``sched_*`` and ``steplog_*`` families, ``/steps`` with the
   planner's fields, the health / drain / resume codes the reference's,
   the server's decode and ragged launches (from its ``/metrics``) once
   per layer per step, no watchdog trip and no capture after warm-up;
   ``/metrics`` scraped every 50 ms through the ``/generate`` round
   with no failed step, failed request, replay or restart; the save and
   load walls, the server's warm-up step beside its step watchdog, its
   TTFT p50, step p50 and tokens/s; then the same directory served with
   ``--kv_host_pages 256 --structured``: a tool-call grammar body
   answered conforming, a malformed grammar 400 ``GrammarError``, the
   ``kv_tier_*`` and ``grammar_*`` families in ``/metrics``; then with
   ``--weight_only int8 --adapter_dir`` (4 rank-16 adapters written as
   ``.npz`` checkpoints): a 128-token body under adapter ``l0`` answered
   with its id echoed (its tokens checked in phase 9a), an unknown id
   400 ``UnknownAdapterError``, the ``weight_only`` and ``adapters``
   sections and families in ``/metrics``; then with ``--fleet_roles
   prefill,decode --enable_prefix_cache``: the serve prompts posted
   greedy, EQUAL to the in-process run, the long prompts' journeys one
   hop from ``prefill0`` to ``decode1``, the ``router`` / ``fleet``
   sections and ``router_*`` families, no capture after warm-up, the
   kernels once per layer per replica step, ``/admin/drain`` answering
   the summed counts and ``/admin/resume`` serving again;
8d. sched — the SLO scheduler in process on the same model: one seeded
   bursty trace of the default tenants (``tools/loadgen.py``, seed 0,
   6 s at 6 requests/s, burstiness 4, vocab 32000: more new tokens a
   second than the step serves, so the queue grows) replayed at its own
   pace on calibrated cores under ``fifo``, ``slack`` with
   ``slo_itl_s=0.5`` and ``slack`` with ``slo_itl_s=0.1`` (below the
   step, so the planner caps chunks), request ids pinned: every stream
   EQUAL to fifo's over the tokens both delivered, fifo shedding
   nothing predictively and admitting in arrival order, slack admitting
   out of it with ``sched_reorder`` spans, the capped run with chunk-
   limited steps, no capture after warm-up, the decode and ragged
   kernels once per layer per step; per tenant the deadline attainment,
   sheds and TTFT p50 / p99, per run the slack error and the wall;
8e. fleet — the disaggregated fleet on the same model object: replicas
   ``prefill0`` and ``decode1`` (the serve core's shape, the prefix
   cache on, an engine, pool and graphs each, a tracer each, one step
   log and journey store) behind a ``FleetRouter``, both warmed up (every
   program captured) before anything runs: (a) the serve prompts and
   seeds routed and stepped by hand, every stream EQUAL to the serve
   run's, exactly 3 handoffs (the prompts of 513 tokens or more), the
   handoffs' export and import walls and pages; (b) the prefix cell's
   prompts twice, EQUAL to its cold run, the second round routed by
   affinity, TTFT beside (a)'s; (c) the replicas and the router on
   their own threads, streams EQUAL, handoffs against long prompts and
   requeues printed; the fleet server's greedy bodies EQUAL to (a)'s;
   no capture after warm-up on either replica, the decode and ragged
   kernels once per layer per replica step, pool bytes and the peak;
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
9d. legacy — the ``ragged=False`` programs on the same model: (a) the
   serve prompts and seeds on a legacy core (``decode_chunk=4``, 8
   slots): one prefill program per plen bucket and one fused decode
   chunk program, two passes on graphs and one eager, streams EQUAL, a
   capture per bucket plus the decode key and none after warm-up, the
   decode kernel once per layer per chunk step and the flash forward
   once per layer per prefill; the graph memory of each key; the
   per-token decode wall (chunk wall / 4) beside the ragged serve run's
   step p50 and the tokens agreeing with its streams (not gated); the
   decode kernel (8 rows, two inactive) and the flash forward (B=1, one
   prompt per bucket) against their plain versions; (b) the prefix
   cache on the legacy path: a 512-token prompt cold, again (a full
   hit) and a partial-tail hit (300 shared + 60 new tokens), warm
   streams EQUAL cold, a page copied; (c) a decode chunk that loses the
   KV (``FaultSpec("decode.step", at=3, lose_kv=True)``) under the
   supervisor: every row replayed, streams EQUAL to (a)'s; (d) the
   draft-model ``SpeculativeEngine`` (gamma 4, 32 greedy tokens on 4
   prompts): the serve model with a seeded 2-layer draft (acceptance,
   agreement with the dense ``generate``, two seeded sampled calls of
   8 tokens EQUAL), then a 4-layer fp32 copy drafting for itself, EQUAL
   to it alone;
9s. sharded — LLaMA-7B's widths at ``SHARD_LAYERS`` (4) of its 32
   layers (the default run's time limit; its own model and one-device
   serve run) over meshes of ``cuda:0`` repeated
   (``build_sharded_engine``, ``EngineCore(serving_mesh=)``): the decode,
   verify and ragged kernels at the shard shapes (8 rows x 16 heads, 4 x
   16, 4 x 8; D 128, fp32 / bf16 / int8 pools with ``[P, H/mp]`` scales)
   and the flash forward at 16 and 8 heads against their plain
   versions; ``quantized_psum`` on the card within its bound on the
   two-stage and the exact-shape path; (a) mp=2, (b) mp=2 x dp=2 and
   (c) mp=2 with the int8 wire, the serve cell each on graphs and eager
   (streams EQUAL), the decode and ragged kernels once per shard a
   layer a step, one capture and none after warm-up, the ``sharding``
   section and the ledger's ``mp_allreduce`` bytes EQUAL to the ring
   model over the step records' tokens, the tokens agreeing with the
   one-device run printed (not gated: bf16 partial sums add in another
   order), (c)'s bytes saved in the ledger, the step log and the
   exposition; warm = cold with the prefix cache and ngram speculation
   = plain (greedy) at mp=2, EQUAL; ``generate`` per mesh (the flash
   forward once per shard a layer a prefill, the decode kernel once per
   shard a layer a step, the prefill logits of (a) and (b) within 5 % of
   the logit scale of one device's, as their serve runs' first-step
   logits; (c)'s distances printed); (f) LoRA (three adapter rows of
   the eight) and int8 activations at mp=2, each against its own
   one-device run as (a): graph EQUAL eager, the kernels once per shard
   a layer a step, the first step's logits within 5 %, the uploads;
   (d), after phase 10a's serve run: ``gpt-moe-6.7b-8e`` at ep=2, the
   routing of every step EQUAL to ep=1's, the ``ep_alltoall`` bytes;
9a. weight_only — LLaMA-7B built again from the serve model's seed and
   weight-only quantized per channel at int8, then at int4 (the
   server's ``--weight_only``): the serve cell on graphs, then the model
   turned in place into its twin holding ``weight_dequantize`` of the
   same payload as bf16 weights and served again, streams EQUAL; the
   payload (``weight_only_summary``), the step p50s beside the serve
   run's, launches; at int8 also the adapter server's ``l0`` stream
   EQUAL to an in-process core over the same payload and adapter;
9b. int8 activations — LLaMA-7B again, every linear wrapped by
   ``QAT().quantize``, activation scales observed over two serve
   prompts, ``convert_int8``: for each projection shape the
   ``torch._int_mm`` int32 accumulator (64 rows, and 5 rows padded)
   bitwise the float64 product; the serve cell (full streams, finite
   logits, one capture), its step p50 and its last-position logits'
   distance from the bf16 model's;
9c. adapters — the serve model converted in place (rank 16, 8 slots,
   24 adapters from ``make_random_adapter``): a converted core with
   only base rows EQUAL to the serve run; a mixed batch (adapters on 3
   of the serve prompts) whose adapter rows EQUAL their prompts served
   alone and whose base rows EQUAL the serve run, the adapters moving
   their streams; an adapter row's first-step logits within 5 % of the
   logit scale of an fp32 eager forward with ``W + s * A @ B`` merged;
   oracle speculation, greedy rows EQUAL; a row parked into the host KV
   tier, its slot evicted and re-uploaded while it waits, EQUAL; a
   loadgen trace drawing 24 adapters over the 7 usable slots replayed
   with no capture after warm-up (uploads, evictions, upload ms); the
   step p50 with 8 adapter rows; every run's kernels once per layer per
   step;
10. gpt — the LLaMA model freed, ``gpt3-6.7b`` at full width and depth
   (random bf16 weights) serves 8 requests with ngram speculation (the
   ragged kernel once per layer per step), again eager with EQUAL
   streams, then its paged forward against its dense one;
10a. moe — GPT freed, ``gpt-moe-6.7b-8e`` (``gpt3-6.7b``'s widths, 8
   experts of FFN 16384, GShard top-2, capacity factor 2.0, 4 of its 32
   layers, random bf16 weights) behind the serve core: (a) the serve
   prompts on graphs and eager, EQUAL, the decode and ragged kernels
   once a layer a step, the routing (per-expert tokens, drops, aux)
   from the snapshot and the step log; (b) one converted layer at the
   default capacity ``torch.equal`` to its bare layer on an 8 x 512
   block, both timed; (c) capacity factor 0.0625: drops in the snapshot,
   the step log and the exposition; (d) ngram speculation EQUAL to its
   plain twin; (e) weight-only int8 experts EQUAL to the twin holding
   their dequantized stacks; (f) int8-activation experts after
   calibration, their logits beside the bf16 model's;
11. train — GPT freed: (1) the flash kernels (forward, dK/dV, dQ) against
   their plain versions at (a) the ERNIE shape B=32, H=12, S=512, D=64
   with 10 % trailing padding as segment ids, dropout 0.1 and 0, fp32
   and bf16, (b) B=2, H=32, S=4096, D=128 causal bf16, (c) Sq=256 <
   Sk=512 causal, (d) B=4, H=8, S=2000, D=256 causal with padding,
   timed at (a), (b) and (d) beside the plain version, the bound and
   SDPA, each kernel also beside the earlier mma.sync design's times
   (``MMA_SYNC_FWD_MS``, ``MMA_SYNC_BWD_MS``) and held bit-equal across
   two launches, the forward and SDPA's forward also device-only
   (``torch.profiler``, and 25 calls back to back), the float16
   kernels at (a) and (d) and both 16-bit types at (e), the fine-tuning
   shape B=32, H=12, S=128, D=64 with 10 % padding, timed at (a) and
   (e) beside bf16 and SDPA, and ``hybrid_attention`` against
   ``flash_attention`` at (a);
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
11.5. train recipe — at ERNIE-3.0-base widths: ``[train ft]``
   ``ErnieForSequenceClassification`` (2 classes, 32 x 128, 10 %
   padding, dropout 0.1, O2 bf16, AdamW under ``LinearWarmup(
   PolynomialDecay)`` with ``ClipGradByGlobalNorm(1.0)``), 2 + 20 steps
   on the graph and eager: every step's rate the schedule's, one
   capture, none after warm-up, 12 launches of each flash kernel per
   step, losses EQUAL and falling; ``[train recompute]`` 3 pretraining
   steps at 32 x 512 with ``recompute`` and 3 without, losses and
   parameters EQUAL, flash forward 24 per step under recompute, the
   allocation peaks; ``[train merge]`` ``gradient_merge`` k_steps 2, 24
   launches of each per step, and at dropout 0 the merged step within
   PERF.md §2's O2 limits of the plain one; ``[train o1]`` level O1
   bf16 within 2e-2 of fp32, bf16 flash kernels; ``[train scaler]`` the
   eager loop with ``auto_cast(level="O1", dtype="float16")`` and
   ``GradScaler``, an inf at step 3 skipped with the parameters
   bitwise unchanged, the scale halved, float16 flash kernels 12 per
   step; ``[train opt]`` SGD, Momentum, Adagrad, RMSProp, Lamb, Lars,
   Adadelta, Adamax and L1Decay, two steps each at depth 2, finite,
   graph EQUAL eager, one capture;
11.6. hapi — ``hapi.Model`` over ``ErnieForSequenceClassification`` at
   ``ernie-3.0-base`` widths, 6 of its 12 layers (2 classes, fp32: the reference
   ``Model`` has no AMP), 32 x 128, on a seeded synthetic set whose
   first token decides the label (512 training and 128 held-out rows),
   loaded by ``io.DataLoader(shuffle=True, num_workers=2)`` worker
   processes; ``prepare(AdamW + LinearWarmup, CrossEntropyLoss,
   Accuracy)``, ``fit`` for 2 epochs with ``EarlyStopping``,
   ``LRSchedulerCallback`` and a checkpoint directory, ``evaluate``,
   ``predict``, ``save`` / ``load`` into a fresh model, ``summary``: the
   loss falls, held-out accuracy at least 0.9, the loaded model's
   predictions EQUAL, the workers distinct processes, the f32 flash
   kernels 12 each per training batch and the forward 12 per evaluation
   or prediction batch; step p50, the loader's batches/s alone beside
   the fit's, peak memory (the eager loop has no graph: one run);
11.7. moe_train — ``GPTMoEForCausalLM`` at ``gpt-moe-6.7b-8e`` widths
   (hidden 4096, 32 heads of 128, 8 experts of FFN 16384, gshard top-2,
   factor 2.0, vocab 50304) and 1 layer (2 ran out of the card's memory
   at the graph's capture), 8 x 1024, O2 bf16, AdamW,
   ``gpt_lm_loss + 0.01 * moe_aux_loss()`` through ``FleetTrainStep``,
   2 + 10 steps on the graph, then eager from the same seed: losses and
   every parameter EQUAL, one capture and none after warm-up, every
   expert and gate tensor moved, the aux loss finite and above 0, the
   bf16 flash kernels causal at head_dim 128 once per layer per step;
   step p50, the expert products' TFLOP/s, routed and dropped
   assignments per layer, peak memory;
11.8. mesh_train — hybrid-parallel training through ``FleetTrainStep``
   on meshes of the card repeated: the flash kernels against their plain
   versions at the shapes one shard gives them (``MESH_FLASH_SHAPES``),
   then (a) ERNIE-3.0-base at dp=2 x mp=2, 32 x 512, O2, dropout 0.1:
   at dropout 0 the first step within PERF.md §2's O2 limits of the
   one-device step, then 2 + 10 graph steps and 3 eager ones EQUAL to
   the graph's first three, one capture, each flash kernel once per
   shard a layer a step, idle share and peak; (b) ZeRO stages 1–3 at
   dp=2 x sharding=2, fp32, one eager step each EQUAL to dp=2 alone (a
   stage changes the placement, not the arithmetic), the recorded specs
   equal to the reference's rules; (c) ``PipelineStack`` at pp=2 (12 blocks,
   4 micro-batches, interleave 1 and 2) within 1e-4 of the sequential
   stack; (d) ring and Ulysses attention at sep=2 (B=2, H=12, S=4096,
   D=64, causal bf16) within 2e-2 of unsplit ``sdpa``, Ulysses' flash
   kernels once per shard; (e) ``gpt-moe-6.7b-8e`` x1 at ep=2, its first
   step within the O2 limits of ep=1, then 2 + 5 graph steps;
12. the kernels line (one JSON object; every kernel's launches summed
    over the runs in ``launches_by_run``, those of phases 9a–9c and the
    sharded runs' per-shard launches among them; its records at the
    shard shapes under ``all``), the card line, and last ``{"ok": true,
    "device": {...}}``.

Without a card, or without the repository beside it, it exits non-zero
before printing any result.  It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import gc
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

PEAK_BYTES_S = 3.35e12                 # H100 SXM HBM3
PEAK_OPS_S = {"fp32": 67e12, "bf16": 989e12, "fp16": 989e12,
              "int8": 989e12}
TOL = {"fp32": 1e-4, "bf16": 2e-2, "fp16": 2e-2, "int8": 2e-2}
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
              page_size=16, max_batch=8, kv_dtype=None, serving_mesh=None,
              **core_kw):
    """An ``EngineCore`` over a new engine for ``model`` (its pools int8
    with ``kv_dtype="int8"``; with ``serving_mesh``, a ``ServingMesh``,
    built by ``build_sharded_engine`` over that many shards of
    ``device``, the card repeated); ``core_kw`` goes to EngineCore
    (speculation, the prefix cache)."""
    from paddle_infer_tpu_torch.inference.generation import \
        PagedGenerationEngine
    from paddle_infer_tpu_torch.serving import (EngineCore,
                                                build_sharded_engine)

    if serving_mesh is not None:
        engine = build_sharded_engine(
            model, serving_mesh, page_size=page_size, kv_dtype=kv_dtype,
            devices=[device] * serving_mesh.n_devices, device=device)
    else:
        engine = PagedGenerationEngine(model, page_size=page_size,
                                       kv_dtype=kv_dtype, device=device)
    return EngineCore(engine, max_batch=max_batch,
                      max_model_len=max_model_len, token_budget=token_budget,
                      prefill_chunk=token_budget, device=device,
                      serving_mesh=serving_mesh, **core_kw)


def free_memory():
    """Collect garbage (engines hold reference cycles) and return the
    caching allocator's free blocks, so a phase starts on a clear card."""
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def pool_bytes(engine) -> int:
    """Bytes of the engine's K and V pools, every layer (payload and
    scales of an int8 pool, every shard of a mesh's)."""
    from paddle_infer_tpu_torch.ops.paged_attention import pool_leaves

    flat = [t for pages in engine._k_pages + engine._v_pages
            for t in pool_leaves(pages)]
    return sum(t.numel() * t.element_size() for t in flat)


def gen_config(max_new, sampled):
    """The serve runs' generation config: greedy, or seeded sampling."""
    from paddle_infer_tpu_torch.inference.generation import \
        GenerationConfig

    if sampled:
        return GenerationConfig(max_new_tokens=max_new, do_sample=True,
                                temperature=0.8, top_k=50, top_p=0.95,
                                seed=1234)
    return GenerationConfig(max_new_tokens=max_new)


def serve_prompts(vocab, prompt_lens=PROMPT_LENS):
    """The serve phase's prompts: one per length, seed 0."""
    rs = np.random.RandomState(0)
    return [rs.randint(0, vocab, (n,)).astype(np.int32)
            for n in prompt_lens]


def drive(core, prompts, max_new, sampled, rid_start, adapter_ids=None):
    """Submit one request per prompt (those in ``sampled`` sampling, the
    rest greedy; request ``i`` bound to ``adapter_ids[i]`` when given),
    request ids from ``rid_start`` (each sampled stream is keyed by its
    rid), and run the core until all are done; returns ``(requests,
    wall seconds)``."""
    import torch

    from paddle_infer_tpu_torch.serving import request as trequest

    trequest._rid_counter = itertools.count(rid_start)
    reqs = []
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        reqs += core.submit(p, gen_config(max_new, i in sampled),
                            adapter_id=(adapter_ids[i] if adapter_ids
                                        else None))
    for _ in range(2000):
        if all(r.done for r in reqs):
            break
        core.run_once()
    if core._engine.device.type == "cuda":
        torch.cuda.synchronize()
    return reqs, time.perf_counter() - t0


def serve(model, device, prompt_lens=PROMPT_LENS, max_new=MAX_NEW,
          prompts=None, sampled=SAMPLED, rid_start=1, adapter_ids=None,
          **core_kw):
    """Serve one request per prompt length (or per given prompt, bound
    to ``adapter_ids``) through EngineCore (``core_kw`` to
    ``make_core``), on graphs unless inside
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
    first = []

    def checked_step(params, ids, pos, caches):
        logits, new = step(params, ids, pos, caches)
        qlens = caches[0][4]
        rows = torch.arange(ids.shape[0], device=ids.device)
        last = logits[rows, torch.clamp(qlens.long() - 1, min=0)]
        finite.logical_and_((torch.isfinite(last).all(dim=-1)
                             | (qlens <= 0)).all())
        if not first:
            # the first step's call runs eagerly (before any capture)
            first.append(last.float().clone())
        return logits, new

    engine._model_step = checked_step
    if prompts is None:
        prompts = serve_prompts(vocab, prompt_lens)
    graphs = graphs_enabled(device)
    try:
        reqs, wall = drive(core, prompts, max_new, sampled, rid_start,
                           adapter_ids)
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
            "obs": obs, "first_logits": first[0],
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


def prefix_run(model, device, prompts, warm, tag, headroom=PREFIX_HEADROOM,
               **core_kw):
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
    pages (admission order), the cache's and the host tier's counters,
    launches."""
    from paddle_infer_tpu_torch.observability import get_compile_log
    from paddle_infer_tpu_torch.ops import _build
    from paddle_infer_tpu_torch.serving import RequestState

    log = get_compile_log()
    log.reset()
    kw = dict(core_kw)
    if warm:
        kw.update(enable_prefix_cache=True,
                  prefix_cache_headroom_pages=headroom)
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
          "kv_tier": snap.get("kv_tier"), "launches": launches}
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


# ------------------------------------------------------- phases 8a, 8b

TIER_HOST_PAGES = 256       # 2.15 GB of LLaMA-7B bf16 pages (8 MiB each)
# park after step 1 (the 1536-token row between its chunks) and after
# step 12 (a decode row); a 0.99 / 0.01 watermark gap holds a parked row
# until it has aged 16 steps, so the batch runs on without it
TIER_PARK_AT = (1, 12)
TIER_HOLD = dict(kv_park_watermark=0.99, kv_resume_watermark=0.01)
# the prefix cell's retention cut to 5 % of the pool (51 of 1025 pages,
# no headroom): every release demotes full blocks of the shared prompt
TIER_PREFIX_WATERMARK = 0.05
TIER_SWAP_PAGES = 97        # a 1551-token row: 0.81 GB of bf16 pages
STRUCT_NEW = 64             # new tokens of a grammar row (the tool call
                            # needs at most about 50)
STRUCT_ROWS = {3: False, 7: True}   # serve prompt -> grammar row, sampled
STRUCT_CHURN = 32           # distinct grammars through one warm core


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def tier_run(model, device, tag, prompts, park_at=(), plane=None,
             supervised=False, jobs=None, rid_start=1, swap=False,
             **core_kw):
    """One core over a new engine with a host KV tier of
    ``TIER_HOST_PAGES`` pages (``core_kw`` to ``make_core``): the
    ``prompts`` submitted as the serve run submits them (request ids
    from ``rid_start``, ``SAMPLED`` rows sampling) or ``jobs`` (``(prompt,
    config, grammar)``), stepped to the end (under ``EngineSupervisor``
    when ``supervised``) with ``park_for_pressure()`` after the steps in
    ``park_at`` and every launch count zeroed just before and read just
    after; with ``swap``, the host link's walls (``swap_walls``) once the
    run is over.  Raises unless every request is DONE, the tier drained
    and the compile log holds one capture and none after warm-up.
    Returns the run's numbers: streams, the park calls' results with the
    rows active after each, the park / resume records and spans, the
    snapshot, steps, launches."""
    from paddle_infer_tpu_torch.observability import get_compile_log
    from paddle_infer_tpu_torch.ops import _build
    from paddle_infer_tpu_torch.serving import (EngineSupervisor,
                                                RequestState)
    from paddle_infer_tpu_torch.serving import request as trequest

    log = get_compile_log()
    log.reset()
    core = make_core(model, device, kv_host_pages=TIER_HOST_PAGES,
                     fault_plane=plane, **core_kw)
    sup = (EngineSupervisor(core, backoff_base_s=0.0) if supervised
           else None)
    if jobs is None:
        jobs = [(p, gen_config(MAX_NEW, i in SAMPLED), None)
                for i, p in enumerate(prompts)]
    try:
        trequest._rid_counter = itertools.count(rid_start)
        for k in _build.KERNELS.values():
            k.launches = 0
        t0 = time.perf_counter()
        reqs = [core.submit(p, g, grammar=spec)[0] for p, g, spec in jobs]
        parked = []
        for step in range(1, 4000):
            if all(r.done for r in reqs):
                break
            (sup or core).run_once()
            if step in park_at:
                ok = core.park_for_pressure()
                parked.append((ok, sorted(s["req"].rid for s in core._slots
                                          if s is not None)))
        _sync(device)
        wall = time.perf_counter() - t0
        launches = {n: k.launches for n, k in _build.KERNELS.items()}
        recs = [r for r in core.steplog.records()
                if r["kind"] in ("park", "resume")]
        spans = [(r.rid, s.name, dict(s.attrs)) for r in reqs
                 for s in core.tracer.get(r.rid).ordered()
                 if s.name in ("park", "resume")]
        steps = core._step_idx
        snap = core.metrics_snapshot()
        out = {"reqs": reqs, "parked": parked, "records": recs,
               "spans": spans, "snap": snap, "steps": steps,
               "wall_s": wall, "launches": launches,
               "step_ms": [t["wall_s"] * 1e3 for t in core.step_trace],
               "streams": [list(r.tokens) for r in reqs]}
        if swap:
            out["swap"] = swap_walls(core)
    finally:
        (sup or core).close()
        free_memory()
    bad = [(r.rid, r.state.value, repr(r.error)) for r in reqs
           if r.state != RequestState.DONE]
    if bad:
        raise AssertionError(f"{tag}: requests not DONE: {bad}")
    kt = snap["kv_tier"]
    if kt["parked_requests"] or kt["host_pages_resident"] - kt[
            "demoted_blocks"]:
        raise AssertionError(f"{tag}: the tier did not drain: {kt}")
    captures = log.count("serving-decode")
    post = log.summary()["post_warmup_decode_compiles"]
    if captures != 1 or post:
        raise AssertionError(f"{tag}: {captures} serve-step captures, "
                             f"{post} after warm-up; want 1 and 0")
    return out


def swap_walls(core, n_pages=TIER_SWAP_PAGES, reps=3):
    """The host link under the tier: ``n_pages`` pages of every pool
    gathered to the host and scattered back in place (the same bytes, so
    the pools are unchanged), each synchronized, median of ``reps``.
    Returns ``(gather s, scatter s, bytes)``."""
    dev = core._engine.device
    blocks = np.arange(n_pages, dtype=np.int64)
    g, sc = [], []
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        k, v = core._gather_blocks(blocks)
        _sync(dev)
        t1 = time.perf_counter()
        core._scatter_blocks(blocks, k, v)
        _sync(dev)
        g.append(t1 - t0)
        sc.append(time.perf_counter() - t1)
    nbytes = sum(t.numel() * t.element_size() for pages in k + v
                 for t in (pages if isinstance(pages, tuple) else (pages,)))
    return float(np.median(g)), float(np.median(sc)), nbytes


def _equal_streams(tag, want, got, rows=None):
    for i in (range(len(want)) if rows is None else rows):
        if list(want[i]) != list(got[i]):
            raise AssertionError(f"{tag}: request {i}'s stream differs:\n"
                                 f"{want[i]}\n{got[i]}")


def _tier_line(tag, st, card):
    kt = st["snap"]["kv_tier"]
    res = st["snap"]["resilience"]
    walls = {k: [(r["wall_s"], r["pages_freed"]) for r in st["records"]
                 if r["kind"] == k] for k in ("park", "resume")}
    print(f"[{tag}] ({card}) steps={st['steps']} wall_s={st['wall_s']:.3f} "
          f"parks={kt['parks_total']} resumes={kt['resumes_total']} "
          f"predictive={kt['predictive_parks_total']} "
          f"demotes={kt['demotes_total']} promotes={kt['promotes_total']} "
          f"swap_retries={kt['swap_retries_total']} "
          f"swap_fails={kt['swap_fails_total']} "
          f"host_pages_peak={kt['host_pages_peak']} "
          f"swap_out_bytes={kt['swap_out_bytes_total']} "
          f"retries={res['request_retries']} shed={res['requests_shed']} "
          f"park_spans={[(r, a.get('kv_tokens'), a.get('pages')) for r, n, a in st['spans'] if n == 'park']} "
          f"park_walls_s={[round(w, 4) for w, _ in walls['park']]} "
          f"resume_walls_s={[round(w, 4) for w, _ in walls['resume']]} "
          f"launches={st['launches']}", flush=True)


def kv_tier_phase(model, device, card, bf16_serve, int8_serve, prefix_cold):
    """The host KV tier on the serve model: (a) the serve prompts and
    seeds, parked after ``TIER_PARK_AT`` steps (the 1536-token row
    between its chunks, then a decode row), bf16 and int8 pools, streams
    EQUAL to the unparked serve runs'; (b) the same under
    ``EngineSupervisor`` with two injected ``kv.alloc`` MemoryErrors: no
    shed, no retry, every park resumed; (c) the prefix cell with no
    headroom and retention cut to ``TIER_PREFIX_WATERMARK``: full blocks
    demote and promote, streams EQUAL to the cold ones; (d) a
    ``kv.swap_out`` fault script on the first victim (the slot stays
    intact, the next victim parks) and a ``kv.swap_in`` one on that row
    (it replays): streams EQUAL; (e) the park and resume walls per page
    and the host link's GB/s.  Every run: the decode and ragged kernels
    once per layer per step, one capture, none after warm-up."""
    from paddle_infer_tpu_torch.serving import FaultPlane, FaultSpec

    L = model.config.num_hidden_layers
    prompts = serve_prompts(model.config.vocab_size)
    runs = {}
    for kv, want in ((None, bf16_serve), ("int8", int8_serve)):
        tag = f"kv_tier park {kv or 'bf16'}"
        st = runs[tag] = tier_run(model, device, tag, prompts,
                                  park_at=TIER_PARK_AT, kv_dtype=kv,
                                  swap=kv is None, **TIER_HOLD)
        _equal_streams(tag, want["streams"], st["streams"])
        parks = [(rid, a) for rid, n, a in st["spans"] if n == "park"]
        if [ok for ok, _ in st["parked"]] != [True, True] or len(parks) \
                != 2:
            raise AssertionError(f"{tag}: parks {st['parked']} {parks}")
        (r1, a1), (r2, a2) = parks
        # the first victim is the 1536-token row after one 512-token
        # chunk; the second a row past its prompt
        if r1 != 1 or a1["kv_tokens"] != 512 or a2["kv_tokens"] < \
                len(prompts[r2 - 1]):
            raise AssertionError(f"{tag}: victims {parks}")
        _check_decode_launches(st, L, tag)
        _check_ragged_launches(st, L, tag)
        _tier_line(tag, st, card)

    tag = "kv_tier alloc faults"
    st = runs[tag] = tier_run(
        model, device, tag, prompts, supervised=True,
        plane=FaultPlane([FaultSpec("kv.alloc", at=3, exc="MemoryError"),
                          FaultSpec("kv.alloc", at=6, exc="MemoryError")]))
    kt, res = st["snap"]["kv_tier"], st["snap"]["resilience"]
    _equal_streams(tag, bf16_serve["streams"], st["streams"])
    if (res["requests_shed"] or res["request_retries"]
            or kt["parks_total"] < 2
            or kt["resumes_total"] != kt["parks_total"]):
        raise AssertionError(f"{tag}: shed {res['requests_shed']}, retries "
                             f"{res['request_retries']}, {kt}")
    _check_decode_launches(st, L, tag)
    _check_ragged_launches(st, L, tag)
    _tier_line(tag, st, card)

    tag = "kv_tier prefix"
    pst = runs[tag] = prefix_run(
        model, device, prefix_prompts(model.config.vocab_size), True, tag,
        headroom=0, kv_host_pages=TIER_HOST_PAGES,
        prefix_cache_watermark=TIER_PREFIX_WATERMARK)
    _equal_streams(tag, prefix_cold["streams"], pst["streams"])
    kt = pst["kv_tier"]
    if not (kt["demotes_total"] and kt["promotes_total"]):
        raise AssertionError(f"{tag}: {kt}")
    _check_decode_launches(pst, L, tag)
    _check_ragged_launches(pst, L, tag)
    print(f"[{tag}] ({card}) warm EQUAL cold ({len(prompts)} requests) "
          f"hit_pages={pst['hits']} demotes={kt['demotes_total']} "
          f"promotes={kt['promotes_total']} demoted_evicted="
          f"{kt['demoted_evicted_total']} host_pages_peak="
          f"{kt['host_pages_peak']} ttft_p50_s="
          f"{float(np.median(pst['ttft_s'])):.4f} (cold "
          f"{float(np.median(prefix_cold['ttft_s'])):.4f}) prefill_tokens="
          f"{pst['prefill_tokens']} (cold {prefix_cold['prefill_tokens']})",
          flush=True)

    tag = "kv_tier swap faults"
    st = runs[tag] = tier_run(
        model, device, tag, prompts, supervised=True, park_at=(12,),
        plane=FaultPlane([
            FaultSpec("kv.swap_out", p=1.0, times=3, rid=1),
            FaultSpec("kv.swap_in", p=1.0, times=3, rid=2)]))
    kt, res = st["snap"]["kv_tier"], st["snap"]["resilience"]
    _equal_streams(tag, bf16_serve["streams"], st["streams"])
    retries = [r.retries for r in st["reqs"]]
    ((ok, active),) = st["parked"]
    # rid 1's swap-out failed three times and left it in its slot; rid 2
    # parked, its swap-in failed three times and it replayed
    if (not ok or 1 not in active or 2 in active
            or (kt["swap_retries_total"], kt["swap_fails_total"],
                kt["parks_total"], kt["resumes_total"]) != (6, 2, 1, 0)
            or retries != [0, 1] + [0] * (len(prompts) - 2)):
        raise AssertionError(f"{tag}: {st['parked']} {kt} {retries}")
    _check_decode_launches(st, L, tag)
    _check_ragged_launches(st, L, tag)
    _tier_line(tag, st, card)

    g_s, s_s, nbytes = runs["kv_tier park bf16"]["swap"]
    n = TIER_SWAP_PAGES
    print(f"[kv_tier] host link ({card}): {n} pages ({nbytes / 1e9:.3f} "
          f"GB, a 1551-token row) gathered in {g_s * 1e3:.2f} ms "
          f"({g_s * 1e3 / n:.3f} ms a page, {nbytes / g_s / 1e9:.2f} GB/s), "
          f"scattered in {s_s * 1e3:.2f} ms ({s_s * 1e3 / n:.3f} ms a page, "
          f"{nbytes / s_s / 1e9:.2f} GB/s)", flush=True)
    for tag in ("kv_tier park bf16", "kv_tier park int8"):
        st = runs[tag]
        pages = {k: [a["pages"] for _, n, a in st["spans"] if n == k]
                 for k in ("park", "resume")}
        walls = {k: [r["wall_s"] for r in st["records"] if r["kind"] == k]
                 for k in ("park", "resume")}
        per = {k: [f"{w * 1e3 / p:.3f}" for w, p in zip(walls[k], pages[k])
                   if p] for k in walls}
        print(f"[{tag}] ({card}) step-log walls a page (ms; park syncs on "
              f"its copy, resume returns with its copy enqueued): "
              f"park {per['park']} over {pages['park']} pages, resume "
              f"{per['resume']} over {pages['resume']} pages", flush=True)
    return runs


def structured_phase(model, device, card, bf16_serve):
    """Grammar-constrained decoding on the serve model over the demo
    vocabulary (``default_vocab(32000, (eos, pad))``): the tool-call
    grammar's compile seconds and ``neg_mask`` bytes; (a) the serve
    prompts with two rows grammar-constrained (one greedy, one sampled,
    ``STRUCT_NEW`` new tokens): every grammar output conforms, the plain
    rows EQUAL the serve run's; (b) the same under speculation with an
    oracle proposing (a)'s streams: greedy streams EQUAL (a)'s, every
    step verifies; (c) the two grammar rows alone, each parked once and
    resumed: EQUAL to (a); (d) ``STRUCT_CHURN`` distinct grammars through
    one warm core: no capture after warm-up, every output conforms; the
    step p50 with the mask beside the serve run's."""
    from paddle_infer_tpu_torch.serving.structured import (
        compile_grammar, conforms, decode_text, default_vocab)
    from paddle_infer_tpu_torch.tools.loadgen import TOOL_CALL_GRAMMAR

    cfg = model.config
    L = cfg.num_hidden_layers
    vocab = default_vocab(cfg.vocab_size, (
        getattr(cfg, "eos_token_id", None), getattr(cfg, "pad_token_id",
                                                    None)))
    t0 = time.perf_counter()
    g = compile_grammar(TOOL_CALL_GRAMMAR, vocab)
    compile_s = time.perf_counter() - t0
    print(f"[structured] tool-call grammar over {len(vocab)} tokens: "
          f"compiled in {compile_s:.3f}s, {g.fsm.n_states} states, "
          f"neg_mask {g.fsm.neg_mask.nbytes} bytes; the step's mask "
          f"upload {8 * len(vocab) * 4} bytes (x{NUM_DRAFT + 1} under "
          "speculation)", flush=True)
    prompts = serve_prompts(cfg.vocab_size)

    def jobs_of(rows):
        out = []
        for i in rows:
            if i in STRUCT_ROWS:
                out.append((prompts[i], gen_config(STRUCT_NEW,
                                                   STRUCT_ROWS[i]),
                            TOOL_CALL_GRAMMAR))
            else:
                out.append((prompts[i], gen_config(MAX_NEW, i in SAMPLED),
                            None))
        return out

    def check(tag, st, rows):
        sn = st["snap"]["structured"]
        for i, r in zip(rows, st["reqs"]):
            if i in STRUCT_ROWS and not conforms(
                    TOOL_CALL_GRAMMAR, decode_text(vocab, r.tokens)):
                raise AssertionError(f"{tag}: row {i} does not conform: "
                                     f"{decode_text(vocab, r.tokens)!r}")
        if sn["violations"] or sn["incomplete"]:
            raise AssertionError(f"{tag}: {sn}")

    rows = list(range(len(prompts)))
    runs = {}
    tag = "structured"
    st = runs["a"] = tier_run(model, device, tag, prompts,
                              jobs=jobs_of(rows), grammar_vocab=vocab)
    check(tag, st, rows)
    plain = [i for i in rows if i not in STRUCT_ROWS]
    _equal_streams(tag, bf16_serve["streams"], st["streams"], plain)
    _check_decode_launches(st, L, tag)
    _check_ragged_launches(st, L, tag)
    slog = st["snap"]["steplog"]
    texts = {i: decode_text(vocab, st["streams"][i]) for i in STRUCT_ROWS}
    print(f"[{tag}] ({card}) grammar rows {texts} conform; plain rows "
          f"EQUAL the serve run's ({len(plain)} requests); steps="
          f"{st['steps']} step_ms_p50 with the mask "
          f"{_p50_after_first(st):.2f} (serve "
          f"{_p50_after_first(bf16_serve):.2f}) grammar_rows="
          f"{slog['grammar_rows_total']} masked_tokens="
          f"{slog['masked_tokens_total']} structured="
          f"{json.dumps(st['snap']['structured'], sort_keys=True)} "
          f"launches={st['launches']}", flush=True)

    tag = "structured spec"
    st = runs["b"] = tier_run(
        model, device, tag, prompts, jobs=jobs_of(rows), grammar_vocab=vocab,
        speculate=True, num_draft_tokens=NUM_DRAFT,
        draft_source=OracleDrafts(prompts, runs["a"]["streams"]))
    check(tag, st, rows)
    greedy = [i for i in rows
              if not (STRUCT_ROWS.get(i) or (i not in STRUCT_ROWS
                                             and i in SAMPLED))]
    _equal_streams(tag, runs["a"]["streams"], st["streams"], greedy)
    spec = st["snap"]["speculation"]
    if not spec["drafts_accepted"]:
        raise AssertionError(f"{tag}: no draft accepted: {spec}")
    _check_verify_launches(st, L, tag)
    _check_ragged_launches(st, L, tag)
    print(f"[{tag}] ({card}) greedy rows {greedy} EQUAL the plain "
          f"grammar run's; drafts {spec['drafts_accepted']} of "
          f"{spec['drafts_proposed']} accepted; steps={st['steps']} "
          f"step_ms_p50={_p50_after_first(st):.2f} "
          f"launches={st['launches']}", flush=True)

    # the sampled grammar row first (its serve request id, so its key),
    # then the greedy one: each is the victim of one park
    order = sorted(STRUCT_ROWS, key=lambda i: not STRUCT_ROWS[i])
    tag = "structured park"
    st = runs["c"] = tier_run(model, device, tag, prompts,
                              jobs=jobs_of(order), rid_start=order[0] + 1,
                              park_at=(3, 6), grammar_vocab=vocab)
    check(tag, st, order)
    if [ok for ok, _ in st["parked"]] != [True, True]:
        raise AssertionError(f"{tag}: parks {st['parked']}")
    for j, i in enumerate(order):
        if st["streams"][j] != runs["a"]["streams"][i]:
            raise AssertionError(f"{tag}: row {i} differs after its park")
    _tier_line(tag, st, card)

    tag = "structured churn"
    rs = np.random.RandomState(9)
    jobs = [(rs.randint(0, cfg.vocab_size, (16,)).astype(np.int32),
             gen_config(8, False), {"type": "regex", "pattern": "w+"})]
    jobs += [(rs.randint(0, cfg.vocab_size, (16 + i,)).astype(np.int32),
              gen_config(8, False),
              {"type": "regex", "pattern": f"g{i}(a|b)"})
             for i in range(STRUCT_CHURN)]
    t0 = time.perf_counter()
    st = runs["d"] = tier_run(model, device, tag, prompts, jobs=jobs,
                              grammar_vocab=vocab)
    for (_, _, spec), r in zip(jobs, st["reqs"]):
        if not conforms(spec, decode_text(vocab, r.tokens)):
            raise AssertionError(f"{tag}: {spec} -> "
                                 f"{decode_text(vocab, r.tokens)!r}")
    sn = st["snap"]["structured"]
    if sn["entries"] != STRUCT_CHURN + 1 or sn["violations"]:
        raise AssertionError(f"{tag}: {sn}")
    print(f"[{tag}] ({card}) {STRUCT_CHURN} distinct grammars + warm-up: "
          f"1 capture, 0 after warm-up, all conform; compile_seconds="
          f"{sn['compile_seconds']:.2f} steps={st['steps']} wall_s="
          f"{time.perf_counter() - t0:.2f}", flush=True)
    return runs


# ------------------------------------------------------- phases 8c, 8d

HTTP_WAIT_S = 600           # the server's start: imports, load, kernels
HTTP_ARGS = ("--max_batch", "8", "--max_model_len", "2048",
             "--token_budget", "512")
SCHED_TRACE = dict(seed=0, duration_s=6.0, rate_per_s=6.0,
                   burstiness=4.0)
# the ITL targets of the two slack runs: 0.5 s never caps a chunk, 0.1 s
# is below the serve step (about 0.122 s), so every mixed step is capped
SCHED_RUNS = (("fifo", "fifo", None), ("slack", "slack", 0.5),
              ("slack capped", "slack", 0.1))
HTTP_SCRAPE_S = 0.05        # /metrics scrape period during a round
SCHED_CAL_RID = 5000        # the calibration requests' first request id
SCHED_RID = 6000            # the replays' first request id


def _http(url, path, body=None, accept=None, timeout=600):
    """``(status, headers, body bytes)`` of one request; an HTTP error
    status is returned, not raised."""
    import urllib.error
    import urllib.request

    headers = {"Content-Type": "application/json"}
    if accept:
        headers["Accept"] = accept
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _http_json(url, path, body=None, want=200):
    code, _, raw = _http(url, path, body)
    if code != want:
        raise AssertionError(f"{path}: HTTP {code}, want {want}: "
                             f"{raw[:400]!r}")
    return json.loads(raw)


def _tail(path, n=3000):
    with open(path, errors="replace") as f:
        return f.read()[-n:]


def stop_server(proc):
    proc.terminate()
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=60)


def start_server(model_dir, log_path, *args):
    """``python -m paddle_infer_tpu_torch.tools.serve`` over ``model_dir``
    on the card, on a free port, its output to ``log_path``.  Returns
    ``(url, process, seconds until /health answered)``; stops it and
    raises if it exits or never answers."""
    import os
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_infer_tpu_torch.tools.serve",
             "--model_dir", model_dir, "--port", str(port), *args],
            cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT)
    url = f"http://127.0.0.1:{port}"
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < HTTP_WAIT_S and proc.poll() is None:
        try:
            if _http(url, "/health", timeout=5)[0] == 200:
                return url, proc, time.perf_counter() - t0
        except OSError:
            pass
        time.sleep(0.5)
    stop_server(proc)
    raise AssertionError(f"server did not come up (exit "
                         f"{proc.returncode}):\n{_tail(log_path)}")


def _generate_posts(url, prompts, max_new, rids=None):
    """One greedy ``/generate`` body per prompt (a body's rows share one
    length), posted from threads started in prompt order; returns the
    streams and the wall (each body's request id into ``rids`` when
    given)."""
    import threading

    out = [None] * len(prompts)
    errs = []

    def post(i):
        try:
            body = _http_json(url, "/generate", {
                "ids": [prompts[i].tolist()], "max_new_tokens": max_new})
            out[i] = body["tokens"][0]
            if rids is not None:
                rids[i] = body["request_ids"][0]
        except Exception as e:          # reported below
            errs.append((i, repr(e)))

    threads = [threading.Thread(target=post, args=(i,))
               for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
        time.sleep(0.05)
    for t in threads:
        t.join(timeout=600)
    if errs or any(o is None for o in out):
        raise AssertionError(f"/generate failed: {errs}")
    return out, time.perf_counter() - t0


def _stream_posts(url, prompts, max_new, chunk=8):
    """One ``/generate_stream`` per prompt, each opened once the one
    before it sent its request-id line (so the server admits them in
    prompt order); returns each stream's concatenated tokens and its
    request id."""
    import threading
    import urllib.request

    out = [None] * len(prompts)
    rids = [None] * len(prompts)
    errs = []

    def read(i, opened):
        try:
            req = urllib.request.Request(
                url + "/generate_stream",
                data=json.dumps({"ids": [prompts[i].tolist()],
                                 "max_new_tokens": max_new,
                                 "chunk_size": chunk}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as r:
                first = json.loads(r.readline())
                opened.set()
                if "request_ids" not in first:
                    raise AssertionError(f"no request-id line: {first}")
                rids[i] = first["request_ids"][0]
                toks = []
                for line in r:
                    msg = json.loads(line)
                    if "error" in msg:
                        raise AssertionError(msg["error"])
                    toks += msg["tokens"][0]
            out[i] = toks
        except Exception as e:          # reported below
            errs.append((i, repr(e)))
            opened.set()

    threads = []
    for i in range(len(prompts)):
        opened = threading.Event()
        t = threading.Thread(target=read, args=(i, opened))
        t.start()
        threads.append(t)
        opened.wait(600)
    for t in threads:
        t.join(timeout=600)
    if errs or any(o is None for o in out):
        raise AssertionError(f"/generate_stream failed: {errs}")
    return out, rids


def _scraped(url, fn, period=HTTP_SCRAPE_S):
    """``fn()`` while a thread scrapes ``/metrics`` (JSON and Prometheus
    text in turn) every ``period`` seconds; returns ``fn()``'s result and
    the number of scrapes.  Raises if a scrape did not answer 200."""
    import threading

    stop = threading.Event()
    codes = []

    def loop():
        while not stop.is_set():
            try:
                codes.append(_http(url, "/metrics", accept=(
                    "text/plain" if len(codes) % 2 else None),
                    timeout=60)[0])
            except Exception as e:      # reported below
                codes.append(repr(e))
            stop.wait(period)

    t = threading.Thread(target=loop)
    t.start()
    try:
        out = fn()
    finally:
        stop.set()
        t.join(timeout=120)
    bad = [c for c in codes if c != 200]
    if bad or not codes:
        raise AssertionError(f"http: /metrics scrapes during the round "
                             f"answered {bad[:5]} ({len(codes)} scrapes)")
    return out, len(codes)


def _trace_ttft(url, rid):
    """A request's TTFT from its server trace: submission to the end of
    its last prefill chunk (the one that samples its first token)."""
    tr = _http_json(url, f"/trace/{rid}")
    return max(s["end"] for s in tr["spans"]
               if s["name"] == "prefill") - tr["begin"]


def _step_count(snap):
    by = snap["steplog"]["by_kind"]
    return sum(by.get(k, 0) for k in STEP_KINDS)


def http_phase(model, device, card, prompt_lens=PROMPT_LENS,
               max_new=MAX_NEW, server_args=HTTP_ARGS):
    """The port's entry point as a user starts it: the serve model saved
    with ``save_pretrained`` into a temporary directory, served by
    ``python -m paddle_infer_tpu_torch.tools.serve`` on the card (its own
    process), the serve phase's prompts posted greedy.  Raises unless
    the ``/generate`` tokens EQUAL an in-process run of the same prompts
    through a fresh core over the same model, the streams concatenate to
    them, the exposition (valid) carries the ``sched_*`` and
    ``steplog_*`` families, ``/steps`` the planner's fields, the health,
    drain and resume codes are the reference's, the server's decode and
    ragged kernels launched once per layer per step, no watchdog tripped,
    no capture followed the server's warm-up step, and ``/metrics``
    scraped through the ``/generate`` round left no failed step, failed
    request, replay or restart.  Returns the launches and the numbers."""
    import os
    import shutil
    import tempfile

    from paddle_infer_tpu_torch.observability import (family_names,
                                                      validate_exposition)
    from paddle_infer_tpu_torch.serving import adapter_layer_spec

    L = model.config.num_hidden_layers
    ref = serve(model, device, prompt_lens=prompt_lens, max_new=max_new,
                sampled=())
    prompts = ref["prompts"]
    with tempfile.TemporaryDirectory() as tmp:
        d = os.path.join(tmp, "model")
        free_gb = shutil.disk_usage(tmp).free / 1e9
        t0 = time.perf_counter()
        model.save_pretrained(d)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(os.path.join(d, "model.pits"))
        print(f"[http] save_pretrained {nbytes / 1e9:.3f} GB in "
              f"{save_s:.2f}s ({free_gb:.0f} GB free in the temporary "
              "directory before)", flush=True)
        log_path = os.path.join(tmp, "server.log")
        url, proc, up_s = start_server(d, log_path, *server_args)
        try:
            log = _tail(log_path)
            load = re.search(r"loaded \S+ in ([0-9.]+)s", log)
            warm = re.search(r"warm-up step ([0-9.]+)s before listening "
                             r"\(step watchdog ([0-9.]+)s\)", log)
            if warm is None:
                raise AssertionError(f"http: no warm-up line in the "
                                     f"server's log:\n{log}")
            warm_s, watchdog_s = float(warm.group(1)), float(warm.group(2))
            print(f"[http] server answered /health {up_s:.1f}s after its "
                  f"start (load_pretrained "
                  f"{load.group(1) if load else '?'}s, warm-up step "
                  f"{warm_s:.3f}s before listening)", flush=True)
            before = _http_json(url, "/metrics")
            # the round runs under a scraper, as a Prometheus server
            # polling on its own schedule would: no step may fail
            (gen, gen_s), scrapes = _scraped(
                url, lambda: _generate_posts(url, prompts, max_new))
            ttft_first = _http_json(url, "/metrics")["ttft_s"]["p50_recent"]
            for i, (a, b) in enumerate(zip(gen, ref["streams"])):
                if a != b:
                    raise AssertionError(
                        f"http: /generate of prompt {i} differs from the "
                        f"in-process run:\n{a}\n{b}")
            streams, rids = _stream_posts(url, prompts, max_new)
            ttft_second = float(np.median([_trace_ttft(url, r)
                                           for r in rids]))
            for i, (a, b) in enumerate(zip(streams, gen)):
                if a != b:
                    raise AssertionError(
                        f"http: /generate_stream of prompt {i} does not "
                        f"concatenate to /generate:\n{a}\n{b}")
            after = _http_json(url, "/metrics")
            code, hdrs, raw = _http(url, "/metrics", accept="text/plain")
            text = raw.decode()
            fams = family_names(text)
            bad = validate_exposition(text)
            if code != 200 or bad:
                raise AssertionError(f"http: exposition {code}: {bad[:5]}")
            for prefix in ("sched_", "steplog_"):
                if not any(f.startswith(prefix) for f in fams):
                    raise AssertionError(f"http: no {prefix}* family")
            recs = [r for r in _http_json(url, "/steps?limit=4096")["steps"]
                    if r["kind"] in STEP_KINDS]
            if not recs or any(r["planned_tokens"] < 1
                               or r["planned_chunk_cap"] < 1 for r in recs):
                raise AssertionError("http: step records without the "
                                     "planner's fields")
            predicted = [r for r in recs if r["predicted_wall_s"] > 0]
            if not predicted:
                raise AssertionError("http: no step record carries a "
                                     "predicted wall")
            steps = _step_count(after) - _step_count(before)
            launches = {n: after["kernel_launches"][n]
                        - before["kernel_launches"][n]
                        for n in ("paged_decode", "ragged_paged_attention")}
            counted = {"steps": steps, "launches": launches}
            _check_decode_launches(counted, L, "http (server process)")
            _check_ragged_launches(counted, L, "http (server process)")
            res, comp = after["resilience"], after["compile"]
            if res["watchdog_trips"] or comp["post_warmup_decode_compiles"]:
                raise AssertionError(
                    f"http: watchdog_trips {res['watchdog_trips']}, "
                    f"post-warm-up captures "
                    f"{comp['post_warmup_decode_compiles']}")
            faults = {"failed requests": after["counters"]["failed"],
                      "failed steps": sum(
                          r["failed"] for r in _http_json(
                              url, "/steps?limit=4096")["steps"]),
                      "replays": res["request_retries"],
                      "restarts": res["engine_restarts"],
                      "loop exceptions": res["loop_exceptions"]}
            if any(faults.values()):
                raise AssertionError(f"http: after the scraped round "
                                     f"{faults}")
            # the reference's health, drain and resume codes
            want = [("/healthz", None, 200), ("/readyz", None, 200),
                    ("/admin/drain", {}, 200), ("/readyz", None, 503),
                    ("/healthz", None, 200), ("/generate",
                                              {"ids": [[1, 2, 3]],
                                               "max_new_tokens": 2}, 503),
                    ("/admin/resume", {}, 200), ("/readyz", None, 200)]
            got = []
            for path, body, _ in want:
                c, h, _ = _http(url, path, body)
                got.append(c)
                if c == 503 and int(h.get("Retry-After", 0)) < 1:
                    raise AssertionError(f"http: {path} 503 without "
                                         "Retry-After")
            if got != [c for _, _, c in want]:
                raise AssertionError(f"http: health / drain / resume "
                                     f"codes {got}")
            gen_tokens = sum(len(t) for t in gen)
            pred = np.asarray([r["predicted_wall_s"] for r in predicted])
            wall = np.asarray([r["wall_s"] for r in predicted])
            out = {
                "save_s": save_s, "up_s": up_s, "gen_s": gen_s,
                "steps": steps, "launches": launches,
                "ttft_p50_s": after["ttft_s"]["p50_recent"],
                "ttft_p50_first_round_s": ttft_first,
                "ttft_p50_second_round_s": ttft_second,
                "warm_up_s": warm_s, "watchdog_s": watchdog_s,
                "first_step_s": recs[0]["wall_s"], "scrapes": scrapes,
                "step_p50_ms": after["decode_step_ms"]["p50_recent"],
                "tokens_per_s": gen_tokens / gen_s,
                "server_tokens_per_s": after["tokens_per_second"],
                "planner_err": float(np.median(np.abs(pred - wall) / wall)),
                "captures": comp["compile_count"]}
            print(f"[http] {card}: /generate of {len(gen)} prompts EQUAL "
                  f"to the in-process run, /generate_stream EQUAL; steps="
                  f"{steps} generate_wall_s={gen_s:.3f} tokens_per_s="
                  f"{out['tokens_per_s']:.2f} (server's 30 s window "
                  f"{out['server_tokens_per_s']:.2f}) ttft_p50_s="
                  f"{out['ttft_p50_s']:.4f} (/generate round "
                  f"{ttft_first:.4f}, streams round {ttft_second:.4f}) "
                  f"warm_up_step_s={warm_s:.3f} first_served_step_s="
                  f"{out['first_step_s']:.3f} (step watchdog "
                  f"{watchdog_s:.1f}s) metrics_scrapes={scrapes} "
                  f"failed=0 replays=0 step_p50_ms="
                  f"{out['step_p50_ms']:.2f} launches={launches} "
                  f"captures={out['captures']} watchdog_trips=0 "
                  f"post_warmup_captures=0 health/drain/resume {got} "
                  f"families={len(fams)} planner |pred-wall|/wall p50 "
                  f"{out['planner_err']:.4f} over {len(predicted)} steps",
                  flush=True)
        except BaseException:
            print(f"[http] server log:\n{_tail(log_path)}", flush=True)
            raise
        finally:
            stop_server(proc)
        out["structured"] = structured_server_run(
            d, os.path.join(tmp, "server-structured.log"), server_args,
            model.config.vocab_size, card)
        out["lora"] = lora_server_run(
            d, os.path.join(tmp, "server-lora.log"),
            os.path.join(tmp, "adapters"), server_args,
            adapter_layer_spec(model), model.config.vocab_size, card)
        out["fleet"] = fleet_server_run(
            d, os.path.join(tmp, "server-fleet.log"), server_args, prompts,
            max_new, ref["streams"], L, card)
        return out


def structured_server_run(model_dir, log_path, server_args, vocab_size,
                          card):
    """The same directory served again with ``--kv_host_pages
    TIER_HOST_PAGES --structured``: a tool-call grammar body answered
    with tokens that decode (demo vocabulary) into conforming text, a
    malformed grammar answered 400 with ``error_type`` ``GrammarError``,
    and ``/metrics`` carrying the ``kv_tier`` and ``structured``
    sections and the ``kv_tier_*`` and ``grammar_*`` families (valid
    exposition).  Returns the numbers."""
    from paddle_infer_tpu_torch.observability import (family_names,
                                                      validate_exposition)
    from paddle_infer_tpu_torch.serving.structured import (conforms,
                                                           decode_text,
                                                           default_vocab)
    from paddle_infer_tpu_torch.tools.loadgen import TOOL_CALL_GRAMMAR

    url, proc, up_s = start_server(
        model_dir, log_path, *server_args, "--kv_host_pages",
        str(TIER_HOST_PAGES), "--structured")
    try:
        vocab = default_vocab(vocab_size)
        prompt = serve_prompts(vocab_size)[3]
        t0 = time.perf_counter()
        body = _http_json(url, "/generate", {
            "ids": [prompt.tolist()], "max_new_tokens": STRUCT_NEW,
            "grammar": TOOL_CALL_GRAMMAR})
        gen_s = time.perf_counter() - t0
        # the pad tail (id 0) decodes to spaces
        text = decode_text(vocab, body["tokens"][0]).rstrip(" ")
        if not conforms(TOOL_CALL_GRAMMAR, text):
            raise AssertionError(f"http structured: {text!r} does not "
                                 "conform")
        code, _, raw = _http(url, "/generate", {
            "ids": [[1, 2, 3]], "max_new_tokens": 4,
            "grammar": {"type": "regex", "pattern": "("}})
        err = json.loads(raw)
        if code != 400 or err.get("error_type") != "GrammarError":
            raise AssertionError(f"http structured: bad grammar answered "
                                 f"{code} {err}")
        snap = _http_json(url, "/metrics")
        code, _, raw = _http(url, "/metrics", accept="text/plain")
        text_prom = raw.decode()
        fams = family_names(text_prom)
        bad = validate_exposition(text_prom)
        kt, sn = snap.get("kv_tier"), snap.get("structured")
        if (code != 200 or bad or not kt or not sn
                or kt["host_pages_total"] != TIER_HOST_PAGES
                or sn["violations"]
                or not any(f.startswith("kv_tier_") for f in fams)
                or not any(f.startswith("grammar_") for f in fams)):
            raise AssertionError(f"http structured: exposition {code} "
                                 f"{bad[:5]}, kv_tier {kt}, structured {sn}")
        print(f"[http structured] ({card}) --kv_host_pages "
              f"{TIER_HOST_PAGES} --structured: /health after {up_s:.1f}s; "
              f"a tool-call body answered in {gen_s:.3f}s, conforming: "
              f"{text!r}; a bad grammar 400 GrammarError; /metrics "
              f"kv_tier_* families "
              f"{sum(f.startswith('kv_tier_') for f in fams)}, grammar_* "
              f"{sum(f.startswith('grammar_') for f in fams)}, structured "
              f"{json.dumps(sn, sort_keys=True)}", flush=True)
        return {"up_s": up_s, "gen_s": gen_s, "text": text}
    except BaseException:
        print(f"[http structured] server log:\n{_tail(log_path)}",
              flush=True)
        raise
    finally:
        stop_server(proc)


def _calibrate(core, vocab, max_new=12):
    """The reference test's ``_calibrate``: two 12-token prompts with
    ``MIN_FIT_SAMPLES + 4`` new tokens each, driven to the end, so the
    step log's fit is admission-ready."""
    from paddle_infer_tpu_torch.inference.generation import \
        GenerationConfig
    from paddle_infer_tpu_torch.serving import request as trequest

    trequest._rid_counter = itertools.count(SCHED_CAL_RID)
    g = GenerationConfig(max_new_tokens=max_new)
    reqs = [core.submit(np.random.RandomState(70 + i).randint(
        0, vocab, (12,)).astype(np.int32), g)[0] for i in range(2)]
    for _ in range(200):
        if all(r.done for r in reqs):
            break
        core.run_once()
    cal = core._planner.calibration(refresh=True)
    if not cal.admission_ready:
        raise AssertionError(f"sched: calibration not admission-ready: "
                             f"{cal.as_dict()}")
    return cal


def _tenant_lines(events, handles):
    """Per tenant: requests, done, predictive sheds, cancellations and
    the TTFT p50 / p99 of those that got a first token."""
    from paddle_infer_tpu_torch.serving import RequestState

    rows = {}
    for e in events:
        r = handles[e["i"]]
        t = rows.setdefault(e["tenant"], {"n": 0, "done": 0, "shed": 0,
                                          "cancelled": 0, "ttft": []})
        t["n"] += 1
        t["done"] += r.state == RequestState.DONE
        t["shed"] += (r.state == RequestState.REJECTED
                      and "predictively" in str(r.error))
        t["cancelled"] += r.state == RequestState.CANCELLED
        if r.first_token_at is not None:
            t["ttft"].append(r.first_token_at - r.arrival)
    for t in rows.values():
        x = t.pop("ttft")
        t["ttft_p50_s"] = float(np.percentile(x, 50)) if x else None
        t["ttft_p99_s"] = float(np.percentile(x, 99)) if x else None
    return rows


def _admission_order(core, handles):
    """``(overtakes, reorder spans)`` of one replay from the core's
    traces: the pairs of admitted requests where the later arrival was
    admitted first, and the requests whose queue wait holds a
    ``sched_reorder`` span."""
    admitted = []
    reordered = 0
    for i in sorted(handles):
        tr = core.tracer.get(handles[i].rid)
        spans = tr.to_dict()["spans"] if tr is not None else []
        # a request that died in the queue has one queue_wait span with
        # its outcome: it was never admitted
        waits = [sp for sp in spans
                 if sp["name"] in ("queue_wait", "sched_reorder")
                 and "outcome" not in sp["attrs"]]
        reordered += any(sp["name"] == "sched_reorder" for sp in spans)
        if waits:
            admitted.append(max(sp["end"] for sp in waits))
    overtakes = sum(later < earlier
                    for k, earlier in enumerate(admitted)
                    for later in admitted[k + 1:])
    return overtakes, reordered


def sched_phase(model, device, card, trace=SCHED_TRACE, runs=SCHED_RUNS):
    """The SLO scheduler on the serve model, in process: one seeded
    bursty trace of the default tenants (``tools/loadgen.py``) that
    offers more new tokens a second than the step serves, replayed at
    its own pace on a calibrated core for each of ``runs`` (name,
    policy, ``slo_itl_s``).  Raises unless every request's stream EQUALs
    the fifo run's over the tokens both delivered, fifo shed nothing
    predictively and admitted in arrival order, each slack run admitted
    out of it with ``sched_reorder`` spans, a run whose ``slo_itl_s`` is
    below the step capped chunks, no capture followed warm-up and the
    decode and ragged kernels launched once per layer per step.  Prints
    per tenant the deadline attainment, the sheds, TTFT p50 / p99, and
    per run the slack error and the wall.  Returns the runs."""
    import torch

    from paddle_infer_tpu_torch.observability import get_compile_log
    from paddle_infer_tpu_torch.ops import _build
    from paddle_infer_tpu_torch.serving import request as trequest
    from paddle_infer_tpu_torch.tools import loadgen

    L = model.config.num_hidden_layers
    vocab = model.config.vocab_size
    events = loadgen.generate_trace(vocab_size=vocab, **trace)
    offered = sum(e["max_new"] for e in events) / trace["duration_s"]
    print(f"[sched] trace {trace}: {len(events)} requests, "
          f"{offered:.1f} new tokens/s offered", flush=True)
    out = {}
    for name, policy, itl in runs:
        log = get_compile_log()
        log.reset()
        kw = {} if itl is None else {"slo_itl_s": itl}
        core = make_core(model, device, sched_policy=policy, **kw)
        try:
            cal = _calibrate(core, vocab)
            step0 = core._step_idx
            trequest._rid_counter = itertools.count(SCHED_RID)
            for k in _build.KERNELS.values():
                k.launches = 0
            t0 = time.perf_counter()
            handles = loadgen.replay(core, events, time_scale=1.0,
                                     timeout_s=600.0)
            if device.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {n: k.launches for n, k in _build.KERNELS.items()}
            steps = core._step_idx - step0
            snap = core.metrics_snapshot()
            overtakes, reordered = _admission_order(core, handles)
        finally:
            core.close()
            free_memory()
        if log.summary()["post_warmup_decode_compiles"]:
            raise AssertionError(f"sched {name}: a capture after warm-up")
        counted = {"steps": steps, "launches": launches}
        _check_decode_launches(counted, L, f"sched {name}")
        _check_ragged_launches(counted, L, f"sched {name}")
        att = loadgen.tenant_attainment(events, handles)
        tenants = _tenant_lines(events, handles)
        sc = snap["sched"]
        limited = sc["planner"]["chunk_limited_steps"]
        out[name] = {"handles": handles, "wall_s": wall, "steps": steps,
                     "launches": launches, "sched": sc, "tenants": tenants,
                     "attainment": att, "overtakes": overtakes,
                     "reordered": reordered}
        print(f"[sched] {name} ({card}): wall_s={wall:.3f} steps={steps} "
              f"overtakes={overtakes} sched_reorder_spans={reordered} "
              f"predictive_sheds={sc['predictive_sheds']} slack_err="
              f"{sc['slack_err']} chunk_limited_steps={limited} "
              f"slo_itl_s={itl} calibration decode_step_s="
              f"{cal.decode_step_s:.4f} prefill_s_per_token="
              f"{cal.prefill_s_per_token:.6f}", flush=True)
        for tname, t in sorted(tenants.items()):
            a = att[tname]
            print(f"[sched] {name} {tname}: requests={t['n']} "
                  f"done={t['done']} attainment={a['attainment']} "
                  f"({a['attained']}/{a['deadline_requests']}) "
                  f"predictive_sheds={t['shed']} "
                  f"cancelled={t['cancelled']} ttft_p50_s="
                  f"{t['ttft_p50_s']} ttft_p99_s={t['ttft_p99_s']}",
                  flush=True)
        if policy == "fifo" and (sc["predictive_sheds"] or overtakes):
            raise AssertionError(
                f"sched {name}: {sc['predictive_sheds']} predictive sheds, "
                f"{overtakes} admissions out of arrival order")
        if policy == "slack" and not (overtakes and reordered):
            raise AssertionError(
                f"sched {name}: the queue was never reordered ({overtakes} "
                f"overtakes, {reordered} sched_reorder spans)")
        if itl is not None and itl < cal.decode_step_s and not limited:
            raise AssertionError(
                f"sched {name}: slo_itl_s {itl} is below the "
                f"{cal.decode_step_s:.4f} s step, yet no chunk was capped")
    want = out[runs[0][0]]["handles"]
    for name, _, _ in runs[1:]:
        both = compared = 0
        for e in events:
            a = want[e["i"]]
            b = out[name]["handles"][e["i"]]
            n = min(len(a.tokens), len(b.tokens))
            if a.tokens[:n] != b.tokens[:n]:
                raise AssertionError(
                    f"sched: event {e['i']}'s {runs[0][0]} and {name} "
                    f"streams differ:\n{a.tokens}\n{b.tokens}")
            compared += n > 0
            both += a.state.value == "done" and b.state.value == "done"
        print(f"[sched] {name} streams EQUAL to {runs[0][0]}'s over the "
              f"tokens both runs delivered ({compared} requests, {both} "
              f"finished in both)", flush=True)
    return out


# ------------------------------------------------------------- phase 8e

FLEET_ROLES = (("prefill0", "prefill"), ("decode1", "decode"))
FLEET_WAIT_S = 600.0        # a threaded request's result


def fleet_replicas(model, device, **core_kw):
    """The fleet over one model object: a ``prefill0`` and a ``decode1``
    replica (``make_core``'s shape, the prefix cache on), each over an
    engine of its own (KV pool, graphs) with a tracer of its own, one
    shared step log and journey store, behind a ``FleetRouter``.
    Returns ``(router, steplog, journeys)``."""
    from paddle_infer_tpu_torch.observability import (JourneyStore, StepLog,
                                                      Tracer)
    from paddle_infer_tpu_torch.serving import (FleetRouter, ReplicaHandle,
                                                ReplicaRole)

    steplog, journeys = StepLog(), JourneyStore()
    handles = [ReplicaHandle(name, make_core(
        model, device, enable_prefix_cache=True, tracer=Tracer(),
        steplog=steplog, journeys=journeys, replica_name=name, **core_kw),
        ReplicaRole(role)) for name, role in FLEET_ROLES]
    return FleetRouter(handles), steplog, journeys


def _replica_captures(log, name):
    """Compile-log events of one replica: its program keys end with its
    name."""
    return sum(1 for e in log.events()
               if isinstance(e.key, tuple) and e.key[-1:] == (name,))


def route(router, prompts, max_new, sampled, rid_start, threaded=False):
    """Submit one request per prompt through ``router`` (those in
    ``sampled`` sampling), request ids from ``rid_start``, and run them
    to the end: by hand through ``router.run_once()``, or, ``threaded``,
    waiting on each result while the replicas' own threads step.
    Returns ``(requests, wall seconds, replica steps)``."""
    import torch

    from paddle_infer_tpu_torch.serving import request as trequest

    cores = [h.core for h in router.replicas]
    steps0 = [c._step_idx for c in cores]
    trequest._rid_counter = itertools.count(rid_start)
    t0 = time.perf_counter()
    reqs = [router.submit(p, gen_config(max_new, i in sampled))
            for i, p in enumerate(prompts)]
    if threaded:
        for r in reqs:
            r.result(timeout=FLEET_WAIT_S)
    else:
        for _ in range(4000):
            if all(r.done for r in reqs):
                break
            router.run_once()
    if cores[0]._engine.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return reqs, wall, sum(c._step_idx - s for c, s in zip(cores, steps0))


def _handoff_walls(steplog, seq0):
    """The step log's ``handoff`` records after sequence ``seq0``, paired
    export (``pages_freed`` > 0) then import: ``[(pages, export s,
    import s)]``."""
    recs = [r for r in steplog.records()
            if r["kind"] == "handoff" and r["seq"] > seq0]
    out = []
    for exp, imp in zip(recs[0::2], recs[1::2]):
        out.append((exp["pages_freed"], exp["wall_s"], imp["wall_s"]))
    return out


def _fleet_run(router, steplog, tag, prompts, max_new, sampled, want, L,
               threaded=False, rid_start=1):
    """One routed run with every launch count zeroed just before and
    read just after: raises unless every request is DONE with a full
    stream EQUAL to ``want`` and the decode and ragged kernels launched
    once per layer per replica step.  Returns the run's numbers."""
    from paddle_infer_tpu_torch.ops import _build
    from paddle_infer_tpu_torch.serving import RequestState

    before = router.snapshot()
    seq0 = max([r["seq"] for r in steplog.records()] or [0])
    for k in _build.KERNELS.values():
        k.launches = 0
    reqs, wall, steps = route(router, prompts, max_new, sampled, rid_start,
                              threaded=threaded)
    launches = {n: k.launches for n, k in _build.KERNELS.items()}
    after = router.snapshot()
    bad = [(r.rid, r.state.value, repr(r.error)) for r in reqs
           if r.state != RequestState.DONE or len(r.tokens) != max_new]
    if bad:
        raise AssertionError(f"{tag}: requests not DONE in full: {bad}")
    for i, (r, w) in enumerate(zip(reqs, want)):
        if list(r.tokens) != list(w):
            raise AssertionError(f"{tag}: request {i}'s stream differs "
                                 f"from the reference:\n{r.tokens}\n{w}")
    st = {"steps": steps, "launches": launches, "wall_s": wall,
          "streams": [list(r.tokens) for r in reqs], "rids": [r.rid
                                                             for r in reqs],
          "ttft_s": [r.first_token_at - r.arrival for r in reqs],
          "handoffs": after["handoffs"] - before["handoffs"],
          "requeued": after["requeued"] - before["requeued"],
          "affinity_hits": after["affinity_hits"] - before["affinity_hits"],
          "walls": _handoff_walls(steplog, seq0), "reqs": reqs}
    _check_decode_launches(st, L, tag)
    _check_ragged_launches(st, L, tag)
    return st


def fleet_phase(model, device, card, serve_st, prefix_cold, server=None):
    """The disaggregated fleet on the serve model (``fleet_replicas``,
    warmed up, every program of both replicas captured before any
    thread starts): (a) the serve prompts and seeds routed and stepped
    by hand, every stream EQUAL to the serve run's, exactly one handoff
    per prompt of ``prefill_threshold`` (513) tokens or more (three);
    (b) the prefix cell's prompts twice, EQUAL to its cold run, the
    second round routed by ``affinity`` (a confirmed ``peek``) with its
    TTFT beside (a)'s; (c) the replicas and the router on their own
    threads, the serve prompts EQUAL to the serve run's, the handoffs
    against the long prompts and the requeues printed; ``server``, the
    fleet server's greedy bodies, EQUAL to (a)'s greedy rows.  Every run
    launches the decode and ragged kernels once per layer per replica
    step; no replica captures after its warm-up.  Prints the handoff
    walls and pages, each replica's pool bytes and the card's peak.
    Returns the runs."""
    import torch

    from paddle_infer_tpu_torch.observability import get_compile_log

    L = model.config.num_hidden_layers
    free_memory()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    log = get_compile_log()
    log.reset()
    router, steplog, journeys = fleet_replicas(model, device)
    reps = router.replicas
    out = {}
    try:
        warm = [h.core.warm_up() for h in reps]
        nbytes = [pool_bytes(h.core._engine) for h in reps]
        captured = {h.name: _replica_captures(log, h.name) for h in reps}
        long_n = sum(len(p) >= router._prefill_threshold
                     for p in serve_st["prompts"])
        page_mb = reps[0].core._cost_model.page_kv_bytes / 1e6
        print(f"[fleet] ({card}) replicas {[h.name for h in reps]} over one "
              f"model; pools {[b / 1e9 for b in nbytes]} GB; warm-up "
              f"{[round(w, 3) for w in warm]} s, captures {captured}; "
              f"prefill_threshold {router._prefill_threshold}; "
              f"{page_mb:.2f} MB a page", flush=True)
        # (a) by hand
        a = out["a"] = _fleet_run(router, steplog, "fleet a",
                                  serve_st["prompts"], MAX_NEW, SAMPLED,
                                  serve_st["streams"], L)
        if a["handoffs"] != long_n or a["handoffs"] != 3:
            raise AssertionError(f"fleet a: {a['handoffs']} handoffs for "
                                 f"{long_n} long prompts (want 3)")
        for pages, ex, im in a["walls"]:
            print(f"[fleet a] handoff {pages} pages "
                  f"({pages * page_mb / 1e3:.3f} GB): export "
                  f"{ex * 1e3:.2f} ms, import {im * 1e3:.2f} ms, "
                  f"{pages * page_mb / 1e3 / (ex + im):.2f} GB/s "
                  "through the host", flush=True)
        hops = [journeys.get(f"j{rid}") for rid in a["rids"]]
        moved = [j["hops"] for j in hops if j and j["hops"]]
        print(f"[fleet a] {card}: streams EQUAL to the serve run's (8, 2 "
              f"sampled); handoffs={a['handoffs']} of {long_n} long "
              f"prompts, journeys with a hop {len(moved)}; steps="
              f"{a['steps']} wall_s={a['wall_s']:.3f} ttft_s "
              + " ".join(f"{n}:{t:.3f}" for n, t in
                         zip(PROMPT_LENS, a["ttft_s"]))
              + f" (serve run p50 {float(np.median(serve_st['ttft_s'])):.3f}"
              f", fleet p50 {float(np.median(a['ttft_s'])):.3f}); "
              f"launches {a['launches']}", flush=True)
        # (b) the prefix cell, twice: the second round by affinity
        prompts = prefix_prompts(model.config.vocab_size)
        for rnd in ("b cold", "b warm"):
            b = out[rnd] = _fleet_run(router, steplog, f"fleet {rnd}",
                                      prompts, MAX_NEW, SAMPLED,
                                      prefix_cold, L)
            reasons = [s.attrs["reason"] for r in b["reqs"]
                       for s in reps[0].core.tracer.get(r.rid).ordered()
                       if s.name == "route"]
            b["reasons"] = reasons
            print(f"[fleet {rnd}] streams EQUAL to the prefix cell's cold "
                  f"run; routes {reasons}; affinity_hits="
                  f"{b['affinity_hits']} handoffs={b['handoffs']} steps="
                  f"{b['steps']} ttft_p50_s="
                  f"{float(np.median(b['ttft_s'])):.4f}", flush=True)
        if out["b warm"]["reasons"] != ["affinity"] * len(prompts):
            raise AssertionError(f"fleet b warm: routes "
                                 f"{out['b warm']['reasons']}, want "
                                 "affinity for every prompt")
        print(f"[fleet b] warm-round TTFT p50 "
              f"{float(np.median(out['b warm']['ttft_s'])):.4f} s against "
              f"(a)'s {float(np.median(a['ttft_s'])):.4f} and the cold "
              f"round's {float(np.median(out['b cold']['ttft_s'])):.4f}",
              flush=True)
        # (c) threaded: the replicas' own stepping threads and the router
        router.start(start_cores=True)
        try:
            c = out["c"] = _fleet_run(router, steplog, "fleet c",
                                      serve_st["prompts"], MAX_NEW,
                                      SAMPLED, serve_st["streams"], L,
                                      threaded=True)
        finally:
            router.stop()
        after = {h.name: _replica_captures(log, h.name) - captured[h.name]
                 for h in reps}
        post = log.summary()["post_warmup_decode_compiles"]
        print(f"[fleet c] {card}: streams EQUAL to the serve run's on the "
              f"replicas' threads; handoffs={c['handoffs']} against "
              f"{long_n} long prompts, requeued={c['requeued']}, "
              f"walls (pages, export s, import s) {c['walls']}; steps="
              f"{c['steps']} wall_s={c['wall_s']:.3f}; captures after "
              f"warm-up per replica {after}, post_warmup_decode_compiles "
              f"{post}", flush=True)
        if any(after.values()) or post:
            raise AssertionError(f"fleet: captures after warm-up {after}, "
                                 f"{post} on the serve-step site")
        if server is not None:
            greedy = [i for i in range(len(PROMPT_LENS)) if i not in SAMPLED]
            for i in greedy:
                if server["streams"][i] != a["streams"][i]:
                    raise AssertionError(
                        f"fleet: the fleet server's body {i} differs from "
                        f"the in-process fleet's:\n{server['streams'][i]}"
                        f"\n{a['streams'][i]}")
            print(f"[fleet] the fleet server's greedy bodies EQUAL to the "
                  f"in-process fleet's ({len(greedy)} rows)", flush=True)
        peak = (torch.cuda.max_memory_allocated() / 1e9
                if device.type == "cuda" else 0.0)
        print(f"[fleet] peak_mem_gb={peak:.1f} (model, two pools of "
              f"{[round(b / 1e9, 3) for b in nbytes]} GB)", flush=True)
        for st in out.values():
            st.pop("reqs", None)
        return out
    finally:
        router.close()
        del router
        free_memory()


def fleet_server_run(model_dir, log_path, server_args, prompts, max_new,
                     want, L, card):
    """The same directory served with ``--fleet_roles prefill,decode
    --enable_prefix_cache``: the serve prompts posted greedy, one body
    each, EQUAL to ``want`` (the in-process single core's greedy run);
    the long prompts' journeys with a hop from ``prefill0`` to
    ``decode1``; ``/metrics`` with the ``router`` and ``fleet`` sections
    and the ``router_*`` families (valid exposition), no capture after
    warm-up, the decode and ragged launches once per layer per step;
    ``/admin/drain`` answering the fleet's summed counts and
    ``/admin/resume`` serving again.  Returns the bodies and numbers."""
    from paddle_infer_tpu_torch.observability import (family_names,
                                                      validate_exposition)

    url, proc, up_s = start_server(
        model_dir, log_path, *server_args, "--fleet_roles", "prefill,decode",
        "--enable_prefix_cache")
    try:
        before = _http_json(url, "/metrics")
        rids = [None] * len(prompts)
        streams, gen_s = _generate_posts(url, prompts, max_new, rids=rids)
        for i, (a, b) in enumerate(zip(streams, want)):
            if a != b:
                raise AssertionError(f"http fleet: /generate of prompt {i} "
                                     f"differs from the in-process run:\n"
                                     f"{a}\n{b}")
        after = _http_json(url, "/metrics")
        rt = after["router"]
        long_rids = [r for r, p in zip(rids, prompts)
                     if len(p) >= rt["prefill_threshold"]]
        hops = [_http_json(url, f"/journey/j{r}") for r in long_rids]
        if any(j["replicas"] != ["prefill0", "decode1"] or j["hops"] != 1
               for j in hops):
            raise AssertionError(f"http fleet: journeys "
                                 f"{[(j['replicas'], j['hops']) for j in hops]}")
        code, _, raw = _http(url, "/metrics", accept="text/plain")
        text = raw.decode()
        fams = family_names(text)
        bad = validate_exposition(text)
        router_fams = sorted(f for f in fams if f.startswith("router_"))
        if code != 200 or bad or not router_fams or "fleet" not in after:
            raise AssertionError(f"http fleet: exposition {code} {bad[:5]}, "
                                 f"router families {router_fams}")
        steps = _step_count(after) - _step_count(before)
        launches = {n: after["kernel_launches"][n]
                    - before["kernel_launches"][n]
                    for n in ("paged_decode", "ragged_paged_attention")}
        counted = {"steps": steps, "launches": launches}
        _check_decode_launches(counted, L, "http fleet (server process)")
        _check_ragged_launches(counted, L, "http fleet (server process)")
        post = after["compile"]["post_warmup_decode_compiles"]
        if post:
            raise AssertionError(f"http fleet: {post} captures after "
                                 "warm-up")
        drain = _http_json(url, "/admin/drain", {})
        c503 = _http(url, "/generate", {"ids": [[1, 2, 3]],
                                        "max_new_tokens": 2})[0]
        resume = _http_json(url, "/admin/resume", {})
        c200 = _http(url, "/generate", {"ids": [[1, 2, 3]],
                                        "max_new_tokens": 2})[0]
        if (drain["status"] != "draining" or c503 != 503 or c200 != 200
                or not isinstance(drain["in_flight"], int)):
            raise AssertionError(f"http fleet: drain {drain}, {c503}, "
                                 f"resume {resume}, {c200}")
        print(f"[http fleet] ({card}) --fleet_roles prefill,decode "
              f"--enable_prefix_cache: /health after {up_s:.1f}s; "
              f"{len(streams)} /generate bodies EQUAL to the in-process "
              f"single core in {gen_s:.3f}s; router dispatched="
              f"{rt['dispatched']} handoffs={rt['handoffs']} "
              f"affinity_hits={rt['affinity_hits']} requeued="
              f"{rt['requeued']}; journeys of the {len(long_rids)} long "
              f"prompts prefill0 -> decode1 (1 hop each); steps={steps} "
              f"launches={launches} post_warmup_captures=0; router_* "
              f"families {router_fams}; drain summed in_flight="
              f"{drain['in_flight']} queued={drain['queued']} then 503, "
              f"resume {resume['status']} then 200", flush=True)
        return {"up_s": up_s, "gen_s": gen_s, "streams": streams,
                "steps": steps, "launches": launches,
                "handoffs": rt["handoffs"]}
    except BaseException:
        print(f"[http fleet] server log:\n{_tail(log_path)}", flush=True)
        raise
    finally:
        stop_server(proc)


# ------------------------------------------------------- phases 9a, 9b, 9c

LORA_RANK = 16
LORA_SLOTS = 8
# the factors' scale: each delta is about a tenth of the projection's
# output at LLaMA-7B's widths, enough to move the random model's streams
LORA_AMP = 0.02
LORA_CHURN = 24             # adapters drawn over the 7 usable slots
LORA_SERVER_IDS = ("l0", "l1", "l2", "l3")
LORA_SERVER_PROMPT = 5      # the serve prompt (128 tokens) the server gets
# the mixed batch: adapters on three serve prompts, the rest base rows
LORA_MIXED = ("a0", None, None, "a1", None, None, "a2", None)
LORA_LOGIT_ROW = 6          # the 33-token prompt: its first step samples
LORA_PARK_ROW = 3           # parked mid-run, its slot evicted meanwhile
LORA_PARK_AT = 12
LORA_CHURN_TRACE = dict(seed=2, duration_s=3.0, rate_per_s=10.0)
LORA_CHURN_LENS = ((16, 256), (8, 24))     # prompt and new-token ranges
INT8_CAL_PROMPTS = (3, 5)   # the serve prompts (512, 128 tokens) that
                            # calibrate the activation scales


def lora_adapters(spec, ids, seed0):
    """``{id: (factors, scale)}``: seeded random rank-``LORA_RANK``
    factors for every layer of ``spec``."""
    from paddle_infer_tpu_torch.serving import make_random_adapter

    return {aid: make_random_adapter(spec, LORA_RANK, seed0 + j,
                                     amplitude=LORA_AMP)
            for j, aid in enumerate(ids)}


def lora_store(spec, made):
    """An ``AdapterStore`` holding ``made``, its arena sized to fit."""
    from paddle_infer_tpu_torch.serving import AdapterStore

    page = 1 << 16
    pages = sum(-(-sum(a.nbytes + b.nbytes for a, b in f.values()) // page)
                for f, _ in made.values())
    store = AdapterStore(spec, rank=LORA_RANK, page_bytes=page,
                         capacity_pages=max(pages, 1))
    for aid, (f, sc) in made.items():
        store.add(aid, f, scale=sc)
    return store


def dequantize_in_place(model):
    """Replace every ``WeightOnlyLinear`` (unwrapping LoRA wrappers
    first) by a plain linear in the model's dtype holding
    ``weight_dequantize`` of its payload: the twin whose streams a
    weight-only core must EQUAL."""
    import torch

    from paddle_infer_tpu_torch.nn.layers import ColumnParallelLinear
    from paddle_infer_tpu_torch.quantization import WeightOnlyLinear
    from paddle_infer_tpu_torch.quantization.slim import _swap
    from paddle_infer_tpu_torch.serving import LoRAServingLinear

    _swap(model, (LoRAServingLinear,), lambda m: m.inner)
    dtype = next(p.dtype for p in model.parameters()
                 if p.is_floating_point())

    def plain(q):
        lin = ColumnParallelLinear(q.in_features, q.out_features,
                                   has_bias=q.bias is not None,
                                   device=q.qweight.device, dtype=dtype)
        with torch.no_grad():
            lin.weight.copy_(q.dequantized(dtype))
            if q.bias is not None:
                lin.bias.copy_(q.bias)
        return lin

    _swap(model, (WeightOnlyLinear,), plain)
    return model


def lora_http_check(model, device, card, http):
    """The weight-only int8 model in process with the server's adapters:
    the prompt the ``--weight_only int8 --adapter_dir`` server answered
    under ``l0``, served alone, must EQUAL the server's tokens."""
    from paddle_infer_tpu_torch.inference.generation import \
        GenerationConfig

    core = make_core(model, device, adapter_store=lora_store(
        http["spec"], http["made"]), adapter_slots=LORA_SLOTS)
    try:
        (req,) = core.submit(http["prompt"],
                             GenerationConfig(max_new_tokens=MAX_NEW),
                             adapter_id="l0")
        while not req.done:
            core.run_once()
        got = list(req.tokens)
    finally:
        core.close()
        free_memory()
    if got != list(http["tokens"]):
        raise AssertionError(f"http lora: the server's adapter stream "
                             f"differs from the in-process core's:\n"
                             f"{http['tokens']}\n{got}")
    print(f"[http lora] ({card}) the server's l0 stream EQUAL to an "
          f"in-process weight-only int8 core with the same adapter "
          f"({len(got)} tokens)", flush=True)
    return got


def weight_only_phase(device, card, bf16_serve, http=None):
    """LLaMA-7B (the serve model's seed) weight-only quantized at int8
    and int4, per channel (``--weight_only``'s quantization), served as
    the serve cell, then turned in place into its twin holding
    ``weight_dequantize`` of the same payload as bf16 weights and served
    again: raises unless the streams are EQUAL and the decode and ragged
    kernels launched once a layer a step.  At int8 the server's adapter
    stream (``lora_server_run``) is checked in process on the same
    model.  Prints the step p50s beside the serve run's, the payload and
    the launches."""
    import torch

    from paddle_infer_tpu_torch.quantization import (quantize_model,
                                                     weight_only_summary)

    out = {}
    for algo in ("int8", "int4"):
        free_memory()
        t0 = time.perf_counter()
        qm = build_llama(device)
        _sync(device)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        quantize_model(qm, algo=f"weight_only_{algo}")
        _sync(device)
        quant_s = time.perf_counter() - t0
        summ = weight_only_summary(qm)
        L = qm.config.num_hidden_layers
        tag = f"weight_only {algo}"
        st = serve_counted(qm, device, tag, prompts=bf16_serve["prompts"],
                           max_new=MAX_NEW)
        _check_decode_launches(st, L, tag)
        _check_ragged_launches(st, L, tag)
        if algo == "int8" and http is not None:
            out["http"] = lora_http_check(qm, device, card, http)
        dequantize_in_place(qm)
        tw = serve_counted(qm, device, f"{tag} twin",
                           prompts=bf16_serve["prompts"], max_new=MAX_NEW)
        _equal_streams(tag, tw["streams"], st["streams"])
        differ = sum(a != b for a, b in zip(st["streams"],
                                            bf16_serve["streams"]))
        print(f"[{tag}] ({card}) streams EQUAL to the dequantized-weights "
              f"twin (8 requests); build {build_s:.1f}s, quantize "
              f"{quant_s:.2f}s; payload {json.dumps(summ, sort_keys=True)}; "
              f"step_ms_p50 {algo}={_p50_after_first(st):.2f} twin="
              f"{_p50_after_first(tw):.2f} bf16 serve="
              f"{_p50_after_first(bf16_serve):.2f}; tokens_per_s "
              f"{st['tokens_per_s']:.2f} (bf16 "
              f"{bf16_serve['tokens_per_s']:.2f}); streams unlike the bf16 "
              f"model's: {differ} of 8; launches {st['launches']}",
              flush=True)
        out[algo] = {"run": st, "twin": tw, "summary": summ,
                     "quant_s": quant_s}
        del qm
        free_memory()
    return out


def int8_act_phase(model, device, card, bf16_serve):
    """int8 activations on LLaMA-7B (the serve model's seed): every
    linear wrapped by ``QAT().quantize``, its activation scale observed
    over two serve prompts (eager forwards), then ``convert_int8``.  For
    each projection shape the card's int32 accumulator (``torch._int_mm``,
    64 rows and a padded 5-row case) must be bitwise the exact float64
    product.  Serves the serve cell (every stream of full length, finite
    logits, one capture) and prints its step p50 beside the serve run's
    and the last-position logit distance from the bf16 serve model."""
    import torch

    from paddle_infer_tpu_torch.quantization import (QAT, Int8Linear,
                                                     QuantedLayer,
                                                     convert_int8)
    from paddle_infer_tpu_torch.quantization.int8 import (int8_accumulate,
                                                          int8_linear)

    free_memory()
    prompts = bf16_serve["prompts"]
    am = build_llama(device)
    am = QAT().quantize(am)
    am.eval()
    wrapped = [m for m in am.modules() if isinstance(m, QuantedLayer)]
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in INT8_CAL_PROMPTS:
            am(torch.as_tensor(prompts[i][None], device=device))
    for m in wrapped:
        m._calibrating = False
    cal_s = time.perf_counter() - t0
    am = convert_int8(am)
    layers = [m for m in am.modules() if isinstance(m, Int8Linear)]
    scales = sorted(m.act_scale for m in layers)
    # the accumulator of one projection of each shape, against float64
    shapes = {}
    for m in layers:
        shapes.setdefault((m.in_features, m.out_features), m)
    gen = torch.Generator(device=device).manual_seed(0)
    for (K, N), m in sorted(shapes.items()):
        for rows in (64, 5):
            x = (torch.randn((rows, K), generator=gen, device=device)
                 * (m.act_scale * 40.0)).to(torch.bfloat16)
            acc = int8_accumulate(x, m.qweight, m.act_scale)
            xq = torch.clamp(torch.round(x.float() * (1.0 / m.act_scale)),
                             -127, 127)
            plain = xq.double() @ m.qweight.double()
            if acc.dtype != torch.int32 or not torch.equal(
                    acc.long(), plain.long()):
                raise AssertionError(
                    f"int8 activations: the {rows}x{K}x{N} accumulator "
                    f"differs from the exact product")
    print(f"[int8 act] ({card}) {len(layers)} Int8Linear layers, "
          f"calibrated on serve prompts {INT8_CAL_PROMPTS} in {cal_s:.1f}s "
          f"(act scales {scales[0]:.4g}..{scales[-1]:.4g}); the _int_mm "
          f"int32 accumulator bitwise the float64 product at "
          f"{sorted(shapes)} (64 and 5 rows)", flush=True)
    if device.type == "cuda":
        # one projection of each shape at the serve step's 8 x 512 rows:
        # int8_linear as served (column-major payload), with the payload
        # row-major, and the bf16 matmul it replaces
        for (K, N), m in sorted(shapes.items()):
            x = torch.randn((4096, K), generator=gen, device=device).to(
                torch.bfloat16)
            wb = (m.qweight.float() * m.w_scale).to(torch.bfloat16)
            rm = m.qweight.contiguous()
            t = {"int8_colmajor": time_ms(lambda: int8_linear(
                     x, m.qweight, m.w_scale, None, m.act_scale)),
                 "int8_rowmajor": time_ms(lambda: int8_linear(
                     x, rm, m.w_scale, None, m.act_scale)),
                 "bf16_matmul": time_ms(lambda: x @ wb)}
            print(f"[int8 act] ({card}) 4096 x {K} x {N}: "
                  + " ".join(f"{k}={v:.4f}" for k, v in t.items())
                  + " ms (CUDA-event median of 25)", flush=True)
            del wb, rm
    st = serve_counted(am, device, "int8 act", prompts=prompts,
                       max_new=MAX_NEW)
    L = am.config.num_hidden_layers
    _check_decode_launches(st, L, "int8 act")
    _check_ragged_launches(st, L, "int8 act")
    ids = torch.as_tensor(prompts[LORA_LOGIT_ROW][None], device=device)
    with torch.no_grad():
        got = am(ids)[0, -1].float()
        want = model(ids)[0, -1].float()
    scale = float(want.abs().max())
    dist = {"max_abs_over_scale": float((got - want).abs().max()) / scale,
            "mean_abs_over_mean_abs": float((got - want).abs().mean())
            / float(want.abs().mean()),
            "argmax_equal": bool(int(got.argmax()) == int(want.argmax()))}
    print(f"[int8 act] ({card}) step_ms_p50 int8={_p50_after_first(st):.2f}"
          f" bf16 serve={_p50_after_first(bf16_serve):.2f}; tokens_per_s "
          f"{st['tokens_per_s']:.2f}; last-position logits on the "
          f"{prompts[LORA_LOGIT_ROW].size}-token prompt against the bf16 "
          f"model {json.dumps(dist, sort_keys=True)}; launches "
          f"{st['launches']}", flush=True)
    del am
    free_memory()
    return {"run": st, "logits": dist}


def merged_reference_logits(model, device, factors, scale, prompt):
    """Last-position logits of an fp32 eager forward of ``model``'s
    weights with the adapter merged, ``W + scale * A @ B`` per layer:
    the yardstick of an adapter row's first-step logits."""
    import torch

    ref = build_llama(device, config=model.config, dtype=torch.float32)
    with torch.no_grad():
        own = dict(model.named_parameters())
        for name, p in ref.named_parameters():
            p.copy_(own[name])
        for path, (a, b) in factors.items():
            w = ref.get_submodule(path).weight
            w += float(scale) * (torch.as_tensor(a, device=device)
                                 @ torch.as_tensor(b, device=device))
        out = ref(torch.as_tensor(prompt[None], device=device))[0, -1]
        out = out.float().clone()
    del ref
    free_memory()
    return out


def adapter_first_logits(model, device, store, prompt, aid):
    """The first-step logits of ``prompt`` served alone under adapter
    ``aid`` (eager, so the step's logits can be read)."""
    import torch

    from paddle_infer_tpu_torch.inference.generation import \
        GenerationConfig
    from paddle_infer_tpu_torch.observability import get_compile_log

    get_compile_log().reset()
    with eager():
        core = make_core(model, device, adapter_store=store,
                         adapter_slots=LORA_SLOTS)
        eng = core._engine
        step = eng._model_step
        got = {}

        def record(params, ids, pos, caches):
            logits, new = step(params, ids, pos, caches)
            if "l" not in got:
                qlens = caches[0][4]
                got["l"] = logits[0, qlens[0].long() - 1].float().clone()
            return logits, new

        eng._model_step = record
        try:
            (req,) = core.submit(prompt, GenerationConfig(max_new_tokens=1),
                                 adapter_id=aid)
            while not req.done:
                core.run_once()
        finally:
            core.close()
            del eng._model_step
            free_memory()
    return got["l"]


def adapter_park_run(model, device, prompts, store, tag):
    """The mixed batch on a core with a host KV tier: after step
    ``LORA_PARK_AT`` row ``LORA_PARK_ROW`` is parked, and while it waits
    five other adapters are pinned and unpinned, so the LRU evicts its
    slot; it resumes at the next step, pinning its adapter again (an
    upload).  Returns the streams and the cache's counters."""
    import torch

    from paddle_infer_tpu_torch.observability import get_compile_log
    from paddle_infer_tpu_torch.ops import _build
    from paddle_infer_tpu_torch.serving import request as trequest

    log = get_compile_log()
    log.reset()
    core = make_core(model, device, kv_host_pages=TIER_HOST_PAGES,
                     adapter_store=store, adapter_slots=LORA_SLOTS)
    aids = LORA_MIXED
    try:
        trequest._rid_counter = itertools.count(1)
        for k in _build.KERNELS.values():
            k.launches = 0
        reqs = [core.submit(p, gen_config(MAX_NEW, i in SAMPLED),
                            adapter_id=aids[i])[0]
                for i, p in enumerate(prompts)]
        cache = core._adapters
        evicted = up0 = None
        for step in range(1, 4000):
            if all(r.done for r in reqs):
                break
            core.run_once()
            if step == LORA_PARK_AT:
                with core._step_lock:
                    s = next(s for s in core._slots if s is not None
                             and s["req"] is reqs[LORA_PARK_ROW])
                    if not core._park_slot(s, reason="adapters phase"):
                        raise AssertionError(f"{tag}: the row did not park")
                    up0 = cache.uploads
                    for aid in ("a3", "a4", "a5", "a6", "a7"):
                        cache.unpin(cache.pin(aid))
                    evicted = cache.slot_of(aids[LORA_PARK_ROW]) is None
        _sync(device)
        launches = {n: k.launches for n, k in _build.KERNELS.items()}
        snap = core.metrics_snapshot()
        out = {"streams": [list(r.tokens) for r in reqs],
               "uploads_after_park": cache.uploads - up0,
               "evicted": evicted, "adapters": snap["adapters"],
               "kv_tier": snap["kv_tier"], "steps": core._step_idx,
               "launches": launches, "pinned": cache.pinned_count}
        cache.check_invariants()
    finally:
        core.close()
        free_memory()
    if not out["evicted"] or out["kv_tier"]["resumes_total"] != 1 \
            or out["pinned"]:
        raise AssertionError(f"{tag}: evicted {out['evicted']}, tier "
                             f"{out['kv_tier']}, pinned {out['pinned']}")
    if log.summary()["post_warmup_decode_compiles"]:
        raise AssertionError(f"{tag}: a capture after warm-up")
    return out


def adapter_churn_run(model, device, store, ids, vocab, tag):
    """A loadgen trace whose every request draws its adapter from
    ``ids`` (24 over 7 usable slots), replayed at once on one core:
    every request DONE, no capture after warm-up; returns the cache's
    counters, the host wall of its uploads and three uploads timed to
    the end of their copies."""
    import torch

    from paddle_infer_tpu_torch.observability import get_compile_log
    from paddle_infer_tpu_torch.ops import _build
    from paddle_infer_tpu_torch.serving import RequestState
    from paddle_infer_tpu_torch.tools import loadgen

    tenants = ({"name": "tenants", "weight": 1.0,
                "prompt_len": LORA_CHURN_LENS[0],
                "max_new": LORA_CHURN_LENS[1], "timeout_s": None,
                "shared_prefix_len": 0, "cache_salt": None,
                "adapter_ids": list(ids)},)
    events = loadgen.generate_trace(tenants=tenants, vocab_size=vocab,
                                    **LORA_CHURN_TRACE)
    log = get_compile_log()
    log.reset()
    core = make_core(model, device, adapter_store=store,
                     adapter_slots=LORA_SLOTS)
    try:
        for k in _build.KERNELS.values():
            k.launches = 0
        t0 = time.perf_counter()
        handles = loadgen.replay(core, events, time_scale=0.0,
                                 timeout_s=600.0)
        _sync(device)
        wall = time.perf_counter() - t0
        launches = {n: k.launches for n, k in _build.KERNELS.items()}
        cache = core._adapters
        summ = cache.summary()
        host_ms = cache.upload_s / max(cache.uploads, 1) * 1e3
        timed = []
        with core._step_lock:
            cold = [a for a in ids if cache.slot_of(a) is None][:3]
            for aid in cold:
                _sync(device)
                t1 = time.perf_counter()
                slot = cache.pin(aid)
                _sync(device)
                timed.append((time.perf_counter() - t1) * 1e3)
                cache.unpin(slot)
        steps = core._step_idx
        cache.check_invariants()
    finally:
        core.close()
        free_memory()
    bad = [(i, r.state.value) for i, r in handles.items()
           if r.state != RequestState.DONE]
    post = log.summary()["post_warmup_decode_compiles"]
    if bad or post or log.count("serving-decode") != 1:
        raise AssertionError(f"{tag}: not DONE {bad}, captures "
                             f"{log.count('serving-decode')}, {post} after "
                             "warm-up")
    return {"requests": len(events), "distinct": len(
        {e["adapter_id"] for e in events}), "summary": summ,
            "upload_host_ms": host_ms, "upload_timed_ms": timed,
            "steps": steps, "wall_s": wall, "launches": launches}


def adapters_phase(model, device, card, bf16_serve):
    """Multi-LoRA serving on the serve model (converted in place by the
    first core; the last phase that uses it): rank 16, 8 slots, adapters
    from ``make_random_adapter``.  Raises unless (1) a converted core
    serving only base rows EQUALs the serve run, (2) in the mixed batch
    (``LORA_MIXED``) each adapter row EQUALs its prompt served alone
    under its adapter and each base row the serve run, (3) an adapter
    row's first-step logits lie within 5 % of the logit scale of an fp32
    eager forward with the adapter merged, (4) under oracle speculation
    the greedy rows EQUAL the mixed run's, (5) a row parked, its slot
    evicted and re-uploaded, EQUALs its unparked stream, (6) 24 adapters
    churn through a loadgen replay with no capture after warm-up; every
    run's kernels launch once a layer a step.  Prints (7) the step p50
    with 8 adapter rows beside the serve run's."""
    from paddle_infer_tpu_torch.serving import adapter_layer_spec

    L = model.config.num_hidden_layers
    prompts = bf16_serve["prompts"]
    spec = adapter_layer_spec(model)
    ids = [f"a{j}" for j in range(LORA_CHURN)]
    t0 = time.perf_counter()
    made = lora_adapters(spec, ids, 100)
    store = lora_store(spec, made)
    mb = sum(a.nbytes + b.nbytes for a, b in made["a0"][0].values()) / 1e6
    print(f"[adapters] ({card}) {len(spec)} target projections "
          f"({sorted({p.rsplit('.', 1)[-1] for p in spec})}), rank "
          f"{LORA_RANK}, {LORA_CHURN} adapters of {mb:.2f} MB made and "
          f"stored in {time.perf_counter() - t0:.1f}s", flush=True)
    f2, s2 = made[LORA_MIXED[LORA_LOGIT_ROW]]
    ref = merged_reference_logits(model, device, f2, s2,
                                  prompts[LORA_LOGIT_ROW])
    kw = dict(adapter_store=store, adapter_slots=LORA_SLOTS)
    runs = {}

    def run(tag, **more):
        more.setdefault("prompts", prompts)
        st = serve_counted(model, device, f"adapters {tag}", max_new=MAX_NEW,
                           **kw, **more)
        if not more.get("speculate"):
            _check_decode_launches(st, L, f"adapters {tag}")
        else:
            _check_verify_launches(st, L, f"adapters {tag}")
        _check_ragged_launches(st, L, f"adapters {tag}")
        runs[tag] = st
        return st

    # (1) slot-0 rows on a converted core: the serve run, bitwise
    run("slot-0")
    _equal_streams("adapters slot-0", bf16_serve["streams"],
                   runs["slot-0"]["streams"])
    # (2) the mixed batch, each adapter row against its single run
    mixed = run("mixed", adapter_ids=list(LORA_MIXED))
    base_rows = [i for i, a in enumerate(LORA_MIXED) if a is None]
    _equal_streams("adapters mixed base rows", bf16_serve["streams"],
                   mixed["streams"], base_rows)
    moved = []
    for i, aid in enumerate(LORA_MIXED):
        if aid is None:
            continue
        alone = run(f"alone {aid}", prompts=[prompts[i]], sampled=(),
                    rid_start=1 + i, adapter_ids=[aid])
        if alone["streams"][0] != mixed["streams"][i]:
            raise AssertionError(f"adapters: row {i} ({aid}) in the mixed "
                                 f"batch differs from its run alone")
        moved.append(mixed["streams"][i] != bf16_serve["streams"][i])
    print(f"[adapters] ({card}) adapter streams unlike the base model's: "
          f"{sum(moved)} of {len(moved)}", flush=True)
    if not any(moved):
        raise AssertionError("adapters: no adapter moved its stream off "
                             "the base model's")
    # (3) the paged bf16 adapter row against the fp32 merged forward
    got = adapter_first_logits(model, device, store,
                               prompts[LORA_LOGIT_ROW],
                               LORA_MIXED[LORA_LOGIT_ROW])
    rel = float((got - ref).abs().max()) / float(ref.abs().max())
    print(f"[adapters] ({card}) first-step logits of the "
          f"{prompts[LORA_LOGIT_ROW].size}-token row under "
          f"{LORA_MIXED[LORA_LOGIT_ROW]} against the fp32 merged forward: "
          f"max |diff| / max |ref| = {rel:.5f} (limit 0.05), argmax "
          f"{int(got.argmax())} vs {int(ref.argmax())}", flush=True)
    if not rel < 0.05:
        raise AssertionError(f"adapters: logits {rel:.4f} of the scale "
                             "from the merged reference")
    # (4) oracle speculation: greedy rows EQUAL
    sp = run("spec oracle", adapter_ids=list(LORA_MIXED), speculate=True,
             num_draft_tokens=NUM_DRAFT,
             draft_source=OracleDrafts(prompts, mixed["streams"]))
    greedy = [i for i in range(len(prompts)) if i not in SAMPLED]
    _equal_streams("adapters spec oracle", mixed["streams"],
                   sp["streams"], greedy)
    # (5) park, evict, re-upload, resume
    park = adapter_park_run(model, device, prompts, store, "adapters park")
    _equal_streams("adapters park", mixed["streams"], park["streams"])
    print(f"[adapters park] ({card}) row {LORA_PARK_ROW} "
          f"({LORA_MIXED[LORA_PARK_ROW]}) parked after step {LORA_PARK_AT},"
          f" its slot evicted while parked, re-uploaded on resume "
          f"(uploads after the park {park['uploads_after_park']}); streams "
          f"EQUAL to the unparked run; {park['steps']} steps; cache "
          f"{json.dumps({k: v for k, v in park['adapters'].items() if k != 'store'}, sort_keys=True)}",
          flush=True)
    # (6) churn through the loadgen replay
    churn = adapter_churn_run(model, device, store, ids,
                              model.config.vocab_size, "adapters churn")
    cs = churn["summary"]
    print(f"[adapters churn] ({card}) {churn['requests']} requests over "
          f"{churn['distinct']} adapters, {LORA_SLOTS - 1} usable slots: "
          f"uploads={cs['uploads']} evictions={cs['evictions']} "
          f"hits={cs['hits']} misses={cs['misses']} upload_bytes="
          f"{cs['upload_bytes']} upload host ms/adapter="
          f"{churn['upload_host_ms']:.2f}, timed to the copies' end "
          f"{[round(t, 2) for t in churn['upload_timed_ms']]} ms; "
          f"{churn['steps']} steps in {churn['wall_s']:.3f}s; "
          f"post_warmup_captures=0; launches {churn['launches']}",
          flush=True)
    # (7) every row under an adapter
    eight = run("8 rows", adapter_ids=[f"a{j % 7}" for j in range(8)])
    print(f"[adapters] ({card}) step_ms_p50 8 adapter rows="
          f"{_p50_after_first(eight):.2f} mixed (3)="
          f"{_p50_after_first(mixed):.2f} slot-0 only="
          f"{_p50_after_first(runs['slot-0']):.2f} bf16 serve (unconverted)="
          f"{_p50_after_first(bf16_serve):.2f}; tokens_per_s "
          f"{eight['tokens_per_s']:.2f}", flush=True)
    runs["park"] = park
    runs["churn"] = churn
    runs["logit_rel"] = rel
    return runs


def lora_server_run(model_dir, log_path, adapter_dir, server_args, spec,
                    vocab_size, card):
    """The same directory served with ``--weight_only int8 --adapter_dir``
    (the 4 adapters of ``LORA_SERVER_IDS``, written as ``.npz``
    checkpoints here): a body bound to ``l0`` answered (its tokens
    checked in process by ``weight_only_phase``), its id echoed, an
    unknown id answered 400 with ``UnknownAdapterError``, and
    ``/metrics`` carrying the ``weight_only`` and ``adapters`` sections
    and their families (valid exposition).  Returns what the in-process
    check needs."""
    import os

    from paddle_infer_tpu_torch.observability import (family_names,
                                                      validate_exposition)

    made = lora_adapters(spec, LORA_SERVER_IDS, 300)
    os.makedirs(adapter_dir, exist_ok=True)
    for aid, (f, sc) in made.items():
        np.savez(os.path.join(adapter_dir, f"{aid}.npz"),
                 scale=np.float32(sc),
                 **{f"{p}.{k}": v for p, (a, b) in f.items()
                    for k, v in (("a", a), ("b", b))})
    url, proc, up_s = start_server(
        model_dir, log_path, *server_args, "--weight_only", "int8",
        "--adapter_dir", adapter_dir, "--adapter_rank", str(LORA_RANK),
        "--adapter_slots", str(LORA_SLOTS))
    try:
        prompt = serve_prompts(vocab_size)[LORA_SERVER_PROMPT]
        t0 = time.perf_counter()
        body = _http_json(url, "/generate", {
            "ids": [prompt.tolist()], "max_new_tokens": MAX_NEW,
            "adapter_id": "l0"})
        gen_s = time.perf_counter() - t0
        if body.get("adapter_id") != "l0":
            raise AssertionError(f"http lora: adapter not echoed: {body}")
        code, _, raw = _http(url, "/generate", {
            "ids": [[1, 2, 3]], "max_new_tokens": 4, "adapter_id": "nope"})
        err = json.loads(raw)
        if code != 400 or err.get("error_type") != "UnknownAdapterError":
            raise AssertionError(f"http lora: unknown adapter answered "
                                 f"{code} {err}")
        snap = _http_json(url, "/metrics")
        code, _, raw = _http(url, "/metrics", accept="text/plain")
        text = raw.decode()
        fams = family_names(text)
        bad = validate_exposition(text)
        wo, ad = snap.get("weight_only"), snap.get("adapters")
        if (code != 200 or bad or not wo or not ad
                or wo["algos"] != ["weight_only_int8"]
                or ad["store"]["adapters"] != len(LORA_SERVER_IDS)
                or "adapter_uploads_total" not in fams
                or "weight_only_qweight_bytes" not in fams):
            raise AssertionError(f"http lora: exposition {code} {bad[:5]}, "
                                 f"weight_only {wo}, adapters {ad}")
        print(f"[http lora] ({card}) --weight_only int8 --adapter_dir "
              f"({len(LORA_SERVER_IDS)} .npz, rank {LORA_RANK}, "
              f"{LORA_SLOTS} slots): /health after {up_s:.1f}s; an l0 body "
              f"of {prompt.size} tokens answered in {gen_s:.3f}s; an "
              f"unknown id 400 UnknownAdapterError; weight_only "
              f"{json.dumps(wo, sort_keys=True)}; adapters uploads="
              f"{ad['uploads']} resident={ad['resident']}", flush=True)
        return {"prompt": prompt, "tokens": body["tokens"][0],
                "made": made, "spec": spec, "up_s": up_s, "gen_s": gen_s}
    except BaseException:
        print(f"[http lora] server log:\n{_tail(log_path)}", flush=True)
        raise
    finally:
        stop_server(proc)


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


# ---------------------------------------------------- phase 9d: legacy

LEGACY_CHUNK = 4            # decode steps per fused legacy chunk
LEGACY_PREFIX = (512, 300, 60)      # base prompt; tail = base[:300] + 60
LEGACY_FAULT_AT = 3         # the decode chunk whose failure loses the KV
# (c2) time to recover late in a long stream: a 33-token prompt, 512 new
# tokens, the KV lost at decode chunk 100 (about 400 tokens delivered)
LEGACY_RECOVERY = (33, 512, 100)
LEGACY_RID = 7000           # the prefix runs' first request id
SPEC_GAMMA = 4
SPEC_NEW = 32
SPEC_SAMPLED_NEW = 8        # the two seeded sampled calls' new tokens
SPEC_LENS = (128, 64, 33, 17)
SPEC_DRAFT_LAYERS = 2       # the bf16 draft: a seeded LLaMA at 7B widths
SPEC_FP32_LAYERS = 4        # the fp32 self-draft check's model


@contextlib.contextmanager
def graph_memory(record):
    """Inside the block each graph capture appends ``(site, key, bytes)``
    to ``record``: the card's reserved memory after the capture minus
    before it, the caching allocator's free blocks returned on both
    sides, so the bytes are what the graph holds (its private pool) and
    the tensors made with it.  Only on the card."""
    import torch

    from paddle_infer_tpu_torch.core import graphs

    capture = graphs._capture

    def measured(fn, args, site, key, sig):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved()
        out = capture(fn, args, site, key, sig)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        record.append((site, key, torch.cuda.memory_reserved() - before))
        return out

    graphs._capture = measured
    try:
        yield record
    finally:
        graphs._capture = capture


def _check_legacy_launches(st, L, chunk, tag, windowed=False):
    """The legacy programs' kernels: the decode kernel once per layer per
    step of every fused chunk, the flash forward once per layer per
    prefill (none for the ``windowed`` family, whose window attention is
    plain)."""
    dec = st["launches"]["paged_decode"]
    flash = st["launches"]["flash_fwd"]
    want = 0 if windowed else L * st["prefills"]
    if dec != L * chunk * st["chunks"] or flash != want:
        raise AssertionError(
            f"{tag}: paged_decode launched {dec} times in {st['chunks']} "
            f"chunks of {chunk} (want {L * chunk * st['chunks']}), "
            f"flash_fwd {flash} times in {st['prefills']} prefills (want "
            f"{want})")


def _prefill_records(recs):
    """The successful prefill records' ``(prompt tokens run, seconds in
    the program and its readback)``."""
    return [(r["prefill_tokens"], r["dispatch_s"]) for r in recs
            if r["kind"] == "prefill" and not r["failed"]]


def legacy_run(model, device, tag, prompts, max_new, sampled, rid_start,
               passes=1, chunk=LEGACY_CHUNK, plane=None, **core_kw):
    """``prompts`` through a legacy core (``ragged=False``,
    ``decode_chunk=chunk``; ``core_kw`` to ``make_core``), warmed up,
    ``passes`` times from request id ``rid_start`` (under an
    ``EngineSupervisor`` when a fault ``plane`` is given); every launch
    count zeroed just before each pass and read just after.  Returns the
    passes' numbers and the graph memory of each captured key."""
    import torch

    from paddle_infer_tpu_torch.core.graphs import graphs_enabled
    from paddle_infer_tpu_torch.observability import get_compile_log
    from paddle_infer_tpu_torch.ops import _build
    from paddle_infer_tpu_torch.serving import (EngineSupervisor,
                                                RequestState)
    from paddle_infer_tpu_torch.serving import request as trequest

    log = get_compile_log()
    log.reset()
    core = make_core(model, device, ragged=False, decode_chunk=chunk,
                     fault_plane=plane, **core_kw)
    sup = (EngineSupervisor(core, watchdog_s=60.0, max_retries=3,
                            backoff_base_s=0.0) if plane is not None
           else None)
    mem = []
    runs = []
    cuda = graphs_enabled(device)
    try:
        with (graph_memory(mem) if cuda else contextlib.nullcontext()):
            core.warm_up()
            for _ in range(passes):
                trequest._rid_counter = itertools.count(rid_start)
                for k in _build.KERNELS.values():
                    k.launches = 0
                trace0 = len(core.step_trace)
                rec0 = len(core.steplog.records())
                reqs = []
                t0 = time.perf_counter()
                for i, p in enumerate(prompts):
                    reqs += core.submit(p, gen_config(max_new, i in sampled))
                for _ in range(4000):
                    if all(r.done for r in reqs):
                        break
                    (sup or core).run_once()
                if cuda:
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                bad = [(r.rid, r.state.value, repr(r.error)) for r in reqs
                       if r.state != RequestState.DONE]
                if bad:
                    raise AssertionError(f"{tag}: requests not DONE: {bad}")
                trace = core.step_trace[trace0:]
                recs = core.steplog.records()[rec0:]
                runs.append({
                    "streams": [list(r.tokens) for r in reqs],
                    "rids": [r.rid for r in reqs],
                    "retries": [r.retries for r in reqs], "wall_s": wall,
                    "ttft_s": [r.first_token_at - r.arrival for r in reqs],
                    "chunks": len(trace),
                    "chunk_ms": [t["wall_s"] * 1e3 for t in trace],
                    "prefills": len(_prefill_records(recs)),
                    "prefill_s": _prefill_records(recs),
                    "launches": {n: k.launches
                                 for n, k in _build.KERNELS.items()},
                    "snap": core.metrics_snapshot()})
        plens = sorted({core._plen(len(p)) for p in prompts})
    finally:
        core.close()
        free_memory()
    vocab = model.config.vocab_size
    for st in runs:
        for s in st["streams"]:
            if len(s) != max_new or min(s) < 0 or max(s) >= vocab:
                raise AssertionError(f"{tag}: bad stream {s}")
    summary = log.summary()
    return {"runs": runs, "graph_bytes": mem, "plens": plens,
            "buckets": len(plens),
            "prefill_events": len(log.events("serving-prefill")),
            "decode_events": len(log.events("serving-decode")),
            "post_warmup": summary["post_warmup_decode_compiles"],
            "graphs": cuda}


def _legacy_line(tag, st, chunk, card):
    steps = st["chunk_ms"][1:] or st["chunk_ms"]
    p50 = float(np.median(steps)) if steps else float("nan")
    gen = sum(len(s) for s in st["streams"])
    print(f"[{tag}] ({card}) chunks={st['chunks']} prefills="
          f"{st['prefills']} wall_s={st['wall_s']:.3f} generated={gen} "
          f"tokens_per_s={gen / st['wall_s']:.2f} chunk_ms_p50={p50:.2f} "
          f"decode_ms_per_token={p50 / chunk:.3f} ttft_s_p50="
          f"{float(np.median(st['ttft_s'])):.3f} launches={st['launches']}",
          flush=True)
    return p50


def legacy_prefix_run(model, device, tag, prompts, max_new, rid0):
    """The prompts one after another on ONE legacy core with the prefix
    cache (each admitted once the previous finished), every launch count
    zeroed just before the first and read after the last; returns the
    streams, the cache's counters, the chunks, the prefills' records and
    the launches."""
    from paddle_infer_tpu_torch.observability import get_compile_log
    from paddle_infer_tpu_torch.ops import _build
    from paddle_infer_tpu_torch.serving import RequestState
    from paddle_infer_tpu_torch.serving import request as trequest

    get_compile_log().reset()
    core = make_core(model, device, ragged=False,
                     decode_chunk=LEGACY_CHUNK, enable_prefix_cache=True,
                     prefix_cache_headroom_pages=PREFIX_HEADROOM)
    streams, ttft = [], []
    try:
        trequest._rid_counter = itertools.count(rid0)
        for k in _build.KERNELS.values():
            k.launches = 0
        for p in prompts:
            (r,) = core.submit(p, gen_config(max_new, False))
            for _ in range(1000):
                if r.done:
                    break
                core.run_once()
            if r.state != RequestState.DONE:
                raise AssertionError(f"{tag}: request {r.rid} "
                                     f"{r.state.value}: {r.error!r}")
            streams.append(list(r.tokens))
            ttft.append(r.first_token_at - r.arrival)
        if device.type == "cuda":
            import torch

            torch.cuda.synchronize()
        launches = {n: k.launches for n, k in _build.KERNELS.items()}
        recs = core.steplog.records()
        stats = core.prefix_cache.stats_snapshot()
        copies = sum(1 for rec in recs if rec["kind"] == "page_copy")
        chunks = len(core.step_trace)
    finally:
        core.close()
        free_memory()
    return {"streams": streams, "stats": stats, "copies": copies,
            "ttft_s": ttft, "chunks": chunks, "launches": launches,
            "prefills": len(_prefill_records(recs)),
            "prefill_s": _prefill_records(recs)}


def legacy_recovery(model, device, card, prompt_len, max_new, fault_at,
                    chunk=LEGACY_CHUNK):
    """(c2) Time to recover late in a long stream: one greedy row of
    ``max_new`` tokens on a legacy core under the supervisor, the KV
    lost at decode chunk ``fault_at``.  The replay re-prefills the
    prompt and regenerates the delivered tokens silently, so the
    recovery (the faulted ``run_once`` to the row's next new token)
    grows with them.  Returns the run's numbers and launches."""
    import torch

    from paddle_infer_tpu_torch.ops import _build
    from paddle_infer_tpu_torch.serving import (EngineSupervisor,
                                                FaultPlane, FaultSpec,
                                                RequestState)

    plane = FaultPlane([FaultSpec("decode.step", at=fault_at,
                                  lose_kv=True)])
    core = make_core(model, device, ragged=False, decode_chunk=chunk,
                     fault_plane=plane)
    sup = EngineSupervisor(core, watchdog_s=60.0, max_retries=3,
                           backoff_base_s=0.0)
    cuda = device.type == "cuda"
    try:
        core.warm_up()
        (prompt,) = serve_prompts(model.config.vocab_size, (prompt_len,))
        for k in _build.KERNELS.values():
            k.launches = 0
        rec0 = len(core.steplog.records())
        t_fault = t_back = None
        delivered = 0
        t0 = time.perf_counter()
        (r,) = core.submit(prompt, gen_config(max_new, False))
        for _ in range(4 * max_new):
            if r.done:
                break
            t_before = time.perf_counter()
            sup.run_once()
            if t_fault is None and r.retries:
                t_fault, delivered = t_before, len(r.tokens)
            elif (t_fault is not None and t_back is None
                  and len(r.tokens) > delivered):
                if cuda:
                    torch.cuda.synchronize()
                t_back = time.perf_counter()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if (r.state != RequestState.DONE or len(r.tokens) != max_new
                or r.retries != 1 or t_back is None):
            raise AssertionError(
                f"legacy c2: request {r.state.value} with {len(r.tokens)} "
                f"of {max_new} tokens, retries {r.retries}: {r.error!r}")
        recs = core.steplog.records()[rec0:]
        chunk_s = [x["wall_s"] for x in recs
                   if x["kind"] == "decode" and not x["failed"]]
        st = {"launches": {n: k.launches for n, k in _build.KERNELS.items()},
              "chunks": len(chunk_s),
              "prefills": len(_prefill_records(recs)),
              "delivered": delivered, "recovery_s": t_back - t_fault,
              "wall_s": wall, "chunk_ms_p50": float(np.median(chunk_s)) * 1e3}
    finally:
        sup.close()
        free_memory()
    print(f"[legacy c2] ({card}) decode.step fault at chunk {fault_at} of a "
          f"{max_new}-token row lost the KV with {delivered} tokens "
          f"delivered: recovered in {st['recovery_s']:.3f} s "
          f"({st['recovery_s'] / delivered * 1e3:.3f} ms a delivered token; "
          f"one re-prefill and {-(-(delivered - 1) // chunk)} silent "
          f"chunks of {chunk}); chunk p50 {st['chunk_ms_p50']:.2f} ms; wall_s="
          f"{wall:.3f} chunks={st['chunks']} prefills={st['prefills']} "
          f"launches={st['launches']}", flush=True)
    return st


def legacy_spec(model, device, card, lens=SPEC_LENS, max_new=SPEC_NEW,
                gamma=SPEC_GAMMA, draft_layers=SPEC_DRAFT_LAYERS,
                fp32_layers=SPEC_FP32_LAYERS):
    """(d) the draft-model ``SpeculativeEngine``: the serve model as the
    target with a seeded ``draft_layers``-layer LLaMA at its widths
    (acceptance and agreement with the dense ``generate`` printed, two
    sampled calls with one seed EQUAL), then an ``fp32_layers``-layer
    fp32 copy (TF32 off) drafting for itself, EQUAL to it alone."""
    import copy
    import warnings

    import torch

    from paddle_infer_tpu_torch.inference import SpeculativeEngine
    from paddle_infer_tpu_torch.inference.generation import (
        GenerationConfig, GenerationEngine)

    ids, mask = gen_prompts(model.config.vocab_size, lens)
    greedy = GenerationConfig(max_new_tokens=max_new)
    sampled = GenerationConfig(
        max_new_tokens=min(max_new, SPEC_SAMPLED_NEW), do_sample=True,
        temperature=0.8, top_k=50, top_p=0.95, seed=1234)
    out = {}

    def timed(fn):
        t0 = time.perf_counter()
        r = fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    cfg = copy.copy(model.config)
    cfg.num_hidden_layers = draft_layers
    draft = build_llama(device, config=cfg, dtype=next(
        model.parameters()).dtype, seed=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        spec = SpeculativeEngine(model, draft, num_draft_tokens=gamma,
                                 device=device)
    want, dense_s = timed(lambda: GenerationEngine(model, device=device)
                          .generate(ids, greedy, attention_mask=mask))
    got, spec_s = timed(lambda: spec.generate(ids, greedy,
                                              attention_mask=mask))
    acc, iters = spec.last_acceptance, spec._last_iters
    agree = int((np.asarray(got) == np.asarray(want)).sum())
    s1 = spec.generate(ids, sampled, attention_mask=mask)
    acc_s = spec.last_acceptance
    s2 = spec.generate(ids, sampled, attention_mask=mask)
    if not np.array_equal(s1, s2):
        raise AssertionError("legacy d: two seeded sampled calls differ")
    print(f"[legacy d bf16] ({card}) gamma={gamma} draft_layers="
          f"{draft_layers} acceptance={acc} iterations={iters} "
          f"agree_with_dense={agree}/"
          f"{want.size} spec_wall_s={spec_s:.3f} dense_wall_s="
          f"{dense_s:.3f} sampled_equal=True sampled_acceptance={acc_s}",
          flush=True)
    out["bf16"] = {"acceptance": acc, "agree": agree,
                   "tokens": int(want.size)}
    del spec, draft
    free_memory()

    cfg = copy.copy(model.config)
    cfg.num_hidden_layers = fp32_layers
    m32 = build_llama(device, config=cfg, dtype=torch.float32, seed=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        spec = SpeculativeEngine(m32, m32, num_draft_tokens=gamma,
                                 device=device)
    want = GenerationEngine(m32, device=device).generate(
        ids, greedy, attention_mask=mask)
    got = spec.generate(ids, greedy, attention_mask=mask)
    if not np.array_equal(got, want):
        raise AssertionError(f"legacy d fp32: self-draft stream differs "
                             f"from the target alone:\n{got}\n{want}")
    print(f"[legacy d fp32] ({card}) layers={fp32_layers} self-draft "
          f"acceptance={spec.last_acceptance} iterations="
          f"{spec._last_iters} equal_to_target=True", flush=True)
    out["fp32"] = {"acceptance": spec.last_acceptance}
    del spec, m32
    free_memory()
    return out


def legacy_kernels(device, buckets, card, decode_lens=None, timed=True):
    """Kernels 1 and 4 against their plain versions at the legacy
    programs' shapes: the decode kernel over B=8 rows, the last two
    inactive (length 1 on a scratch page), the rest at the serve prompts
    plus half the new tokens; the flash forward at B=1, causal, one
    prompt of each plen bucket, bf16.  Returns ``{kernel: {tag:
    record}}``; raises on a disagreement."""
    import torch

    from paddle_infer_tpu_torch.ops import flash_attention as FA
    from paddle_infer_tpu_torch.ops import paged_attention as PA

    case = make_case(device)
    lens = np.asarray(decode_lens or [n + MAX_NEW // 2
                                      for n in PROMPT_LENS[:6]] + [1, 1],
                      np.int32)
    tables = case["tables"].clone()
    scratch = case["kp"].shape[0] - 1       # the page no table holds
    tables[len(lens) - 2:] = scratch
    lengths = torch.tensor(lens, device=device)
    q, _, _, kp, vp, kp_ref, vp_ref = _cast(case, "bf16")
    dec = PA.paged_attention_decode(q, kp, vp, tables, lengths)
    ref = PA._decode_plain(q.float(), kp_ref, vp_ref, tables, lengths)
    tol = TOL["bf16"]
    rec = {"max_abs_err": float((dec.float() - ref).abs().max()),
           "tol": tol,
           "ok": bool(torch.allclose(dec.float(), ref, atol=tol, rtol=tol))}
    if timed:
        rec["ms"] = time_ms(lambda: PA.paged_attention_decode(
            q, kp, vp, tables, lengths))
        rec["plain_ms"] = time_ms(lambda: PA._decode_plain(
            q, kp, vp, tables, lengths), reps=10)
        rec["bound_ms"], rec["bound_by"] = _bound(
            *_bytes_decode(case, "bf16", lens.astype(np.int64)), "bf16")
    out = {"paged_decode": {"legacy/bf16": rec}, "flash_fwd": {}}
    print(f"[legacy kernels] ({card}) paged_decode B=8 lengths "
          f"{lens.tolist()}: " + " ".join(
              f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
              for k, v in rec.items()), flush=True)
    for S in buckets:
        fc = dict(make_flash_case(device, 1, 32, S, S, 128, True, 0),
                  itemsize=2)
        qb, kb, vb = (fc[n].to(torch.bfloat16) for n in ("q", "k", "v"))
        cfg = dict(seed=FLASH_SEED, causal=True, scale=fc["scale"],
                   dropout_p=0.0, h=32)
        o, lse = FA.flash_fwd(qb, kb, vb, None, None, **cfg)
        ro, rl = FA._fwd_reference(qb.float(), kb.float(), vb.float(),
                                   None, None, **cfg)
        err = max(float((o.float() - ro).abs().max()),
                  float((lse.float() - rl).abs().max()))
        ok = bool(torch.allclose(o.float(), ro, atol=tol, rtol=tol)
                  and torch.allclose(lse.float(), rl, atol=tol, rtol=tol))
        frec = {"max_abs_err": err, "tol": tol, "ok": ok}
        if timed:
            frec["ms"] = time_ms(lambda: FA.flash_fwd(qb, kb, vb, None, None,
                                                      **cfg))
            frec["plain_ms"] = time_ms(lambda: FA._fwd_reference(
                qb.float(), kb.float(), vb.float(), None, None, **cfg),
                reps=5, warmup=1)
            frec["bound_ms"], frec["bound_by"] = _bound(
                *_flash_cost(fc, "flash_fwd"), "bf16")
        out["flash_fwd"][f"legacy S={S}/bf16"] = frec
        print(f"[legacy kernels] ({card}) flash_fwd B=1 S={S} causal: "
              + " ".join(f"{k}={v:.4g}" if isinstance(v, float)
                         else f"{k}={v}" for k, v in frec.items()),
              flush=True)
    bad = [(n, t) for n, r in out.items() for t, v in r.items()
           if not v["ok"]]
    if bad:
        raise AssertionError(f"legacy kernels disagree with their plain "
                             f"versions: {bad}")
    return out


def legacy_phase(model, device, card, serve_st=None,
                 prompt_lens=PROMPT_LENS, max_new=MAX_NEW, sampled=SAMPLED,
                 chunk=LEGACY_CHUNK, prefix=LEGACY_PREFIX,
                 recovery=LEGACY_RECOVERY, spec_kw=None):
    """The legacy ``ragged=False`` programs and the draft-model
    ``SpeculativeEngine`` on the serve model: (a) the serve prompts on a
    legacy core (graph streams EQUAL on a second pass and eager, one
    capture per plen bucket plus the decode key and none after, the
    decode and flash forward launches exact, graph memory per key, the
    per-token decode wall and the agreement with the ragged run
    ``serve_st``), (b) the prefix cache on the legacy path (warm EQUAL
    cold; the steady windowed prefill beside the plain one), (c) a
    replay after a decode chunk that loses the KV (EQUAL to (a)), (c2)
    ``legacy_recovery``, (d) ``legacy_spec``.  Returns the counted
    runs."""
    from paddle_infer_tpu_torch.serving import FaultPlane, FaultSpec

    L = model.config.num_hidden_layers
    vocab = model.config.vocab_size
    prompts = serve_prompts(vocab, prompt_lens)
    if serve_st is None:
        serve_st = serve(model, device, prompt_lens=prompt_lens,
                         max_new=max_new, sampled=sampled)

    # (a) graph run, two passes, then eager
    a = legacy_run(model, device, "legacy a", prompts, max_new, sampled, 1,
                   passes=2, chunk=chunk)
    first, second = a["runs"]
    kernels = (legacy_kernels(device, a["plens"], card)
               if device.type == "cuda" else {})
    _equal_streams("legacy a second pass", first["streams"],
                   second["streams"])
    if (a["prefill_events"] != a["buckets"] or a["decode_events"] != 1
            or a["post_warmup"]):
        raise AssertionError(
            f"legacy a: {a['prefill_events']} prefill captures for "
            f"{a['buckets']} plen buckets, {a['decode_events']} decode "
            f"captures, {a['post_warmup']} after warm-up (want one per "
            "bucket, one, none)")
    _check_legacy_launches(first, L, chunk, "legacy a")
    _check_legacy_launches(second, L, chunk, "legacy a pass 2")
    with eager():
        e = legacy_run(model, device, "legacy a eager", prompts, max_new,
                       sampled, 1, chunk=chunk)["runs"][0]
    _equal_streams("legacy a eager", first["streams"], e["streams"])
    _legacy_line("legacy a", first, chunk, card)
    p50 = _legacy_line("legacy a pass 2", second, chunk, card)
    _legacy_line("legacy a eager", e, chunk, card)
    for site, key, nbytes in a["graph_bytes"]:
        print(f"[legacy a] graph memory {site} {key}: "
              f"{nbytes / 2 ** 20:.1f} MiB", flush=True)
    ragged_p50 = _p50_after_first(serve_st)
    agree = sum(int(x == y) for ws, gs in zip(serve_st["streams"],
                                              first["streams"])
                for x, y in zip(ws, gs))
    print(f"[legacy a] ({card}) captures prefill={a['prefill_events']} "
          f"(buckets {a['buckets']}) decode={a['decode_events']} "
          f"post_warmup={a['post_warmup']}; decode_ms_per_token legacy="
          f"{p50 / chunk:.3f} (chunk p50 {p50:.2f} / {chunk}) ragged step "
          f"p50={ragged_p50:.2f}; tokens agreeing with the ragged run "
          f"{agree}/{sum(len(s) for s in first['streams'])} (not gated: "
          "flash prefill and ragged kernel round bf16 differently); "
          "graph=eager=second pass streams", flush=True)

    # (b) the prefix cache: cold, full warm hit, partial-tail warm hit
    rs = np.random.RandomState(11)
    n_base, n_shared, n_new = prefix
    base = rs.randint(0, vocab, (n_base,)).astype(np.int32)
    tail = np.concatenate([base[:n_shared],
                           rs.randint(0, vocab, (n_new,)).astype(np.int32)])
    # a second cold prompt of the base's bucket: the windowed family's
    # steady prefill (the first use of a key captures it)
    fresh = rs.randint(0, vocab, (n_base,)).astype(np.int32)
    warm = legacy_prefix_run(model, device, "legacy b",
                             [base, base, tail, fresh], max_new, LEGACY_RID)
    cold = legacy_prefix_run(model, device, "legacy b cold", [tail],
                             max_new, LEGACY_RID + 4)
    _check_legacy_launches(warm, L, LEGACY_CHUNK, "legacy b", True)
    _check_legacy_launches(cold, L, LEGACY_CHUNK, "legacy b cold", True)
    _equal_streams("legacy b full hit", [warm["streams"][0]],
                   [warm["streams"][1]])
    _equal_streams("legacy b partial hit", cold["streams"],
                   [warm["streams"][2]])
    if warm["stats"]["hits"] < 2 or warm["copies"] < 1:
        raise AssertionError(f"legacy b: hits {warm['stats']['hits']}, "
                             f"page copies {warm['copies']} (want >= 2, "
                             ">= 1)")
    print(f"[legacy b] ({card}) warm EQUAL cold: full hit and partial-tail "
          f"hit ({n_shared} shared + {n_new} new tokens); hits="
          f"{warm['stats']['hits']} page_copies={warm['copies']}; ttft_s "
          f"cold {warm['ttft_s'][0]:.3f} full hit {warm['ttft_s'][1]:.3f} "
          f"partial hit {warm['ttft_s'][2]:.3f} tail cold "
          f"{cold['ttft_s'][0]:.3f} (first uses capture their keys); "
          f"chunks={warm['chunks']}+{cold['chunks']} launches="
          f"{warm['launches']} + {cold['launches']}", flush=True)
    # the steady prefill of an n_base-token prompt: windowed (the fresh
    # cold prompt, its key already captured) beside build_prefill's
    # ((a)'s second pass, where the serve prompts hold that length)
    windowed_s = warm["prefill_s"][-1][1]
    plain_s = [t for n, t in second["prefill_s"] if n == n_base]
    from paddle_infer_tpu_torch.serving.programs import WINDOW_TILE

    print(f"[legacy b] ({card}) steady prefill of a {n_base}-token prompt: "
          f"windowed {windowed_s * 1e3:.2f} ms ({-(-n_base // WINDOW_TILE)} "
          f"tiles of {WINDOW_TILE} queries), build_prefill "
          + (f"{plain_s[0] * 1e3:.2f} ms" if plain_s else "not in (a)")
          + " (the program and its one readback)", flush=True)

    # (c) replay after a decode chunk that loses the KV
    plane = FaultPlane([FaultSpec("decode.step", at=LEGACY_FAULT_AT,
                                  lose_kv=True)])
    c = legacy_run(model, device, "legacy c", prompts, max_new, sampled, 1,
                   chunk=chunk, plane=plane)["runs"][0]
    _equal_streams("legacy c replay", first["streams"], c["streams"])
    if c["rids"] != first["rids"] or not all(c["retries"]) \
            or c["snap"]["resilience"]["engine_restarts"] != 1:
        raise AssertionError(
            f"legacy c: rids {c['rids']}, retries {c['retries']}, "
            f"restarts {c['snap']['resilience']['engine_restarts']} (want "
            "(a)'s rids, "
            "every row replayed once, one restart)")
    print(f"[legacy c] ({card}) decode.step fault at chunk "
          f"{LEGACY_FAULT_AT} lost the KV: {len(c['streams'])} rows "
          f"replayed (retries {c['retries']}), streams EQUAL to (a); "
          f"wall_s={c['wall_s']:.3f} against {first['wall_s']:.3f}",
          flush=True)
    c2 = legacy_recovery(model, device, card, *recovery, chunk=chunk)
    _check_legacy_launches(c2, L, chunk, "legacy c2")

    # (d) the draft-model SpeculativeEngine
    d = legacy_spec(model, device, card, **(spec_kw or {}))
    return {"a": first, "a2": second, "eager": e, "b": warm,
            "b cold": cold, "c": c, "c2": c2, "d": d, "kernels": kernels}


# -------------------------------------------------------- phase 9s: sharded

SHARD_LAYERS = 4            # the sharded phase's depth (of llama-7b's 32)
SHARD_RUNS = (("mp2", dict(mp=2)), ("mp2dp2", dict(mp=2, dp_replicas=2)),
              ("mp2 int8-wire", dict(mp=2, quantized_allreduce="int8")))
# the kernels at the shapes one shard gives them: (rows, heads) of the
# mp=2 shard (8 rows, 32 / 2 heads), an mp=2 x dp=2 shard (8 / 2 rows)
# and an mp=4 shard (32 / 4 heads); D = 128, page 16, as the serve cell
SHARD_KERNEL_SHAPES = ((8, 16), (4, 16), (4, 8))
# the flash forward at a shard of generate's prefill (mp=2: 16 heads;
# mp=4: 8), causal, bf16
SHARD_FLASH_SHAPES = (dict(B=2, H=16, Sq=1024, Sk=1024, D=128, causal=True,
                           pad=0),
                      dict(B=2, H=8, Sq=1024, Sk=1024, D=128, causal=True,
                           pad=0))
# quantized_psum on the card: a step's out-projection partial (8 rows x
# 512 positions x hidden 4096: 65536 blocks, two stages) and a size
# whose block count is odd (the exact-shape path)
SHARD_PSUM_SIZES = (8 * 512 * 4096, 700 * 4096 + 128)
SHARD_LOGIT_BAR = 0.05      # of the logit scale: PERF.md §2's bar
SHARD_GEN_LENS = (512, 128)
SHARD_GEN_NEW = 16


def _check_shard_launches(st, L, per_step, tag, names=(
        "paged_decode", "ragged_paged_attention")):
    """On a mesh each of the step's attention kernels launches once per
    shard (``per_step`` = mp x dp shards) a layer a step."""
    for name in names:
        n = st["launches"][name]
        if n != L * per_step * st["steps"]:
            raise AssertionError(
                f"{tag}: {name} launched {n} times in {st['steps']} steps "
                f"(want {L} layers x {per_step} shards per step)")


def _check_shard_generate_launches(launches, L, shards, tag):
    """A mesh's ``generate``: the flash forward once per shard a layer
    for the prefill, the decode kernel once per shard a layer a step."""
    want = {"flash_fwd": L * shards,
            "paged_decode": L * shards * (SHARD_GEN_NEW - 1)}
    if {n: launches[n] for n in want} != want:
        raise AssertionError(f"sharded generate {tag}: launches "
                             f"{launches}, want {want}")


def _ledger_check(tag, st, L, hidden, mp, itemsize, card):
    """The run's ``mp_allreduce`` ledger bytes against the analytic ring
    model over its step records' tokens (2 all-reduces a layer of a
    ``[tokens, hidden]`` activation, 2(r-1)/r of it per rank); returns
    the ``sharding`` section."""
    from paddle_infer_tpu_torch.parallel.collective import \
        quantized_wire_bytes

    sh = st["obs"]["snapshot"]["sharding"]
    recs = [r for r in st["obs"]["steplog"].records() if r["kind"] in
            STEP_KINDS]
    tokens = [r["decode_rows"] + r["prefill_tokens"] + r["draft_tokens"]
              for r in recs]
    quant = sh["quantized_allreduce"] == "int8"
    model = sum(2 * L * quantized_wire_bytes(t * hidden, mp, itemsize)[
        0 if quant else 1] for t in tokens if t > 0)
    by_op = sh["collectives"]["by_op_dtype"].get("mp_allreduce", {})
    got = sum(by_op.values())
    rec_sum = sum(r["ici_bytes_est"] for r in recs)
    print(f"[{tag}] ({card}) sharding: mesh_axes={sh['mesh_axes']} "
          f"devices={sh['devices']} params={sh['params_total']} "
          f"sharded={sh['sharded_params']} "
          f"replicated={sh['replicated_params']} "
          f"quantized_allreduce={sh['quantized_allreduce']!r}; ledger "
          f"mp_allreduce={by_op} bytes_saved="
          f"{sh['collectives']['bytes_saved_total']:.0f}, step records "
          f"ici_bytes_est sum={rec_sum:.0f}, ring model {model:.0f} over "
          f"{sum(tokens)} tokens in {len(recs)} steps", flush=True)
    if not (abs(got - model) <= 1e-6 * model and abs(rec_sum - model)
            <= 1e-6 * model):
        raise AssertionError(f"{tag}: mp_allreduce ledger {got}, records "
                             f"{rec_sum}, ring model {model}")
    return sh


def _agreement(want, got):
    """Tokens of each request equal position by position."""
    return [int(sum(a == b for a, b in zip(w, g))) for w, g in
            zip(want, got)]


def shard_kernels(device, card):
    """Kernels 1-4 at the per-shard shapes, each against its plain
    version (raises on a disagreement); the mp=2 shard's shape timed.
    Returns ``{kernel: {tag: record}}`` for the kernels line."""
    out = {}
    for i, (B, H) in enumerate(SHARD_KERNEL_SHAPES):
        tag = f"shard B{B} H{H}"
        print(f"[sharded kernels] {tag} D128 page16: decode, verify, ragged "
              f"at fp32 / bf16 / int8 pools ([P, {H}] scales)", flush=True)
        res = check_kernels(make_case(device, B=B, H=H), timed=(i == 0))
        for name, recs in res.items():
            for kind, rec in recs.items():
                out.setdefault(name, {})[f"{tag}/{kind}"] = rec
    for i, shape in enumerate(SHARD_FLASH_SHAPES):
        tag = f"shard B{shape['B']} H{shape['H']} S{shape['Sq']} causal"
        rec = check_flash(make_flash_case(device, **shape), "bf16", 0.0,
                          timed=(i == 0))["flash_fwd"]
        times = (f" ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
                 f"bound_ms={rec['bound_ms']:.4f} sdpa_ms="
                 f"{rec['library_ms']:.4f} device_ms={rec['device_ms']:.4f}"
                 f" clocks: {clocks_line()}" if i == 0 else "")
        print(f"[sharded kernels] {tag} D128 flash_fwd bf16: max_abs_err="
              f"{rec['max_abs_err']:.3e} tol={rec['tol']} ok={rec['ok']} "
              f"repeat_equal={rec['repeat_equal']}{times}", flush=True)
        if not rec["ok"]:
            raise AssertionError(f"flash_fwd at the shard shape {tag} "
                                 "disagrees with its plain version")
        out.setdefault("flash_fwd", {})[f"{tag}/bf16"] = rec
    return out


def shard_psum(device, card):
    """``quantized_psum`` on the card, two ranks of random partial
    sums, both paths: within ``quantization_error_bound`` of the exact
    float32 sum."""
    import torch

    from paddle_infer_tpu_torch.parallel import collective

    g = torch.Generator(device=device)
    g.manual_seed(11)
    for n in SHARD_PSUM_SIZES:
        parts = [torch.randn(n, generator=g, device=device)
                 for _ in range(2)]
        path = "two-stage" if (-(-n // collective._Q8_BLOCK)) % 2 == 0 \
            else "exact-shape"
        t0 = time.perf_counter()
        got = collective.quantized_psum(parts)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        ms = time_ms(lambda: collective.quantized_psum(parts), reps=10)
        err = float((got - (parts[0] + parts[1])).abs().max())
        bound = collective.quantization_error_bound(parts)
        q, fp = collective.quantized_wire_bytes(n, 2)
        print(f"[sharded psum] ({card}) n={n} {path}: max_abs_err="
              f"{err:.4e} bound={bound:.4e} ms={ms:.4f} (first call "
              f"{wall:.1f} ms) wire bytes int8={q:.0f} fp32={fp:.0f}",
              flush=True)
        if not err <= bound:
            raise AssertionError(f"quantized_psum n={n}: error {err} past "
                                 f"its bound {bound}")


def shard_generate(model, device, card, meshes):
    """``generate`` on the single-device engine and on each mesh's: the
    prefill's last-position logits (max-abs over the single engine's
    logit scale, gated at ``SHARD_LOGIT_BAR``), the greedy tokens that
    agree, and on the meshes the flash forward once per shard a layer a
    prefill and the decode kernel once per shard a layer a step."""
    import torch

    from paddle_infer_tpu_torch.inference.generation import (
        GenerationConfig, PagedGenerationEngine)
    from paddle_infer_tpu_torch.ops import _build
    from paddle_infer_tpu_torch.parallel.topology import create_hybrid_mesh
    from paddle_infer_tpu_torch.serving import ServingMesh

    L = model.config.num_hidden_layers
    ids, mask = gen_prompts(model.config.vocab_size, SHARD_GEN_LENS, seed=12)
    g = GenerationConfig(max_new_tokens=SHARD_GEN_NEW)
    base = PagedGenerationEngine(model, page_size=16, device=device)
    ref = _first_logits(base, lambda: base.generate(ids, g,
                                                    attention_mask=mask))
    want = base.generate(ids, g, attention_mask=mask)
    del base
    free_memory()
    scale = float(ref.abs().max())
    out = {}
    for tag, kw in meshes:
        cfg = ServingMesh(**kw)
        mesh = create_hybrid_mesh(mp=cfg.mp, dp=cfg.dp_replicas,
                                  devices=[device] * cfg.n_devices)
        eng = PagedGenerationEngine(
            model, page_size=16, mesh=mesh,
            quantized_allreduce=cfg.quantized_allreduce, device=device)
        lg = _first_logits(eng, lambda: eng.generate(ids, g,
                                                     attention_mask=mask))
        eng.generate(ids, g, attention_mask=mask)       # captures
        for k in _build.KERNELS.values():
            k.launches = 0
        t0 = time.perf_counter()
        got = eng.generate(ids, g, attention_mask=mask)
        _sync(device)
        wall = time.perf_counter() - t0
        launches = {n: k.launches for n, k in _build.KERNELS.items()}
        shards = cfg.mp * (cfg.dp_replicas if len(SHARD_GEN_LENS)
                           % cfg.dp_replicas == 0 else 1)
        _check_shard_generate_launches(launches, L, shards, tag)
        err = float((lg - ref).abs().max())
        agree = _agreement(want.tolist(), got.tolist())
        print(f"[sharded generate {tag}] ({card}) prefill logits max_abs="
              f"{err:.4e} of scale {scale:.4e} (bar {SHARD_LOGIT_BAR}); "
              f"greedy tokens agreeing with one device {agree} of "
              f"{SHARD_GEN_NEW}; launches flash_fwd="
              f"{launches['flash_fwd']} paged_decode="
              f"{launches['paged_decode']}; wall {wall:.3f}s", flush=True)
        exact = not cfg.quantized_allreduce
        if exact and not err <= SHARD_LOGIT_BAR * scale:
            raise AssertionError(f"sharded generate {tag}: prefill logits "
                                 f"{err} past {SHARD_LOGIT_BAR} x {scale}")
        out[tag] = {"launches": launches, "logit_err": err, "agree": agree,
                    "first_logits": lg}
        del eng
        free_memory()
    return out


def sharded_phase(model, device, card, single=None,
                  prompt_lens=PROMPT_LENS, max_new=MAX_NEW,
                  spec_lens=SPEC_PROMPT_LENS):
    """Sharded serving on the card, every mesh over ``device`` repeated:
    the kernels at the per-shard shapes; ``quantized_psum`` within its
    bound; (a) mp=2 and (b) mp=2 x dp=2 at the serve cell on graphs and
    eager (EQUAL), the decode and ragged kernels once per shard a layer
    a step, one capture and none after warm-up, the sharding section
    and the ledger's ``mp_allreduce`` bytes against the ring model, the
    tokens agreeing with the single-device run ``single`` (printed);
    warm = cold with the prefix cache and speculative = plain at mp=2
    (EQUAL); (c) the int8 wire at mp=2 on graphs and eager (EQUAL), its
    bytes saved in the ledger, the step log and the exposition; then
    ``generate`` per mesh (``shard_generate``); then (f) LoRA and int8
    activations at mp=2 (``sharded_quant_runs``; ``model`` takes the
    LoRA wrappers in place).  Returns the runs by tag with their
    launches."""
    import torch

    from paddle_infer_tpu_torch.observability import (render_prometheus,
                                                      validate_exposition)
    from paddle_infer_tpu_torch.parallel.collective import LEDGER
    from paddle_infer_tpu_torch.serving import ServingMesh

    L = model.config.num_hidden_layers
    hidden = model.config.hidden_size
    itemsize = next(model.parameters()).element_size()
    torch.cuda.reset_peak_memory_stats()
    kres = shard_kernels(device, card)
    shard_psum(device, card)
    serve_kw = dict(prompt_lens=prompt_lens, max_new=max_new)
    if single is None:
        single = serve_counted(model, device, "sharded single", **serve_kw)
    runs = {}
    for tag, kw in SHARD_RUNS:
        cfg = ServingMesh(**kw)
        per_step = cfg.mp * cfg.dp_replicas
        LEDGER.reset()
        st = serve_counted(model, device, f"sharded {tag}",
                           serving_mesh=cfg, **serve_kw)
        _check_shard_launches(st, L, per_step, f"sharded {tag}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        sh = _ledger_check(f"sharded {tag}", st, L, hidden, cfg.mp,
                           itemsize, card)
        ev = eager_twin(model, device, f"sharded {tag}", st, card,
                        serving_mesh=cfg, **serve_kw)
        agree = _agreement(single["streams"], st["streams"])
        scale = float(single["first_logits"].abs().max())
        lerr = float((st["first_logits"] - single["first_logits"])
                     .abs().max())
        print(f"[sharded {tag}] ({card}) first step's logits max_abs="
              f"{lerr:.4e} of scale {scale:.4e} (bar {SHARD_LOGIT_BAR})",
              flush=True)
        # the bar holds exact meshes; the int8 wire's distance is printed
        if not cfg.quantized_allreduce and not (
                lerr <= SHARD_LOGIT_BAR * scale):
            raise AssertionError(f"sharded {tag}: first step's logits "
                                 f"{lerr} past {SHARD_LOGIT_BAR} x {scale}")
        print(f"[sharded {tag}] ({card}) step_ms_p50 graph="
              f"{_p50_after_first(st):.2f} eager={_p50_after_first(ev):.2f}"
              f" (one device {_p50_after_first(single):.2f}) tokens_per_s "
              f"graph={st['tokens_per_s']:.2f} kernel launches a step: "
              f"{L} layers x {per_step} shards; post_warmup_captures="
              f"{st['post_warmup_captures']}; tokens agreeing with one "
              f"device {agree} of {max_new} (no gate: bf16 partial sums "
              f"add in another order); peak_mem_gb={peak:.1f}", flush=True)
        if cfg.quantized_allreduce:
            saved = sh["collectives"]["bytes_saved_total"]
            sl = st["obs"]["steplog"].summary()
            text = render_prometheus(st["obs"]["snapshot"],
                                     st["obs"]["compile_summary"])
            prom = [ln for ln in text.splitlines() if ln.startswith(
                ("collective_bytes", "serving_mesh_info"))]
            print(f"[sharded {tag}] ({card}) bytes saved: ledger "
                  f"{saved:.0f} steplog {sl['ici_bytes_saved_total']:.0f};"
                  f" exposition {prom}", flush=True)
            if not (saved > 0 and sl["ici_bytes_saved_total"] == saved
                    and validate_exposition(text) == []
                    and any(ln.startswith("collective_bytes_saved_total")
                            and abs(float(ln.split()[-1]) - saved)
                            <= 1e-5 * saved for ln in prom)):
                raise AssertionError(f"sharded {tag}: bytes saved ledger "
                                     f"{saved}, steplog {sl}, exposition "
                                     f"{prom}")
        st["obs"] = None
        runs[tag] = st
        del ev
        free_memory()

    # warm = cold with the prefix cache at mp=2, graphs
    mp2 = ServingMesh(mp=2)
    prompts = prefix_prompts(model.config.vocab_size)
    cold = prefix_run(model, device, prompts, False, "sharded prefix cold",
                      serving_mesh=mp2)
    warm = prefix_run(model, device, prompts, True, "sharded prefix warm",
                      serving_mesh=mp2)
    if warm["streams"] != cold["streams"]:
        raise AssertionError("sharded mp2: warm streams differ from cold")
    if min(warm["hits"]) < PREFIX_LEN // 16:
        raise AssertionError(f"sharded mp2: warm hits {warm['hits']}")
    for t, st in (("prefix cold", cold), ("prefix warm", warm)):
        _check_shard_launches(st, L, 2, f"sharded {t}")
        runs[t] = st
    print(f"[sharded prefix] ({card}) mp2 warm EQUAL to cold ({len(prompts)}"
          f" requests), ttft_p50_s cold="
          f"{float(np.median(cold['ttft_s'])):.4f} warm="
          f"{float(np.median(warm['ttft_s'])):.4f} hit_pages={warm['hits']}",
          flush=True)

    # speculative = plain at mp=2 (ngram drafts on tiled prompts)
    tiled = tiled_prompts(model.config.vocab_size, spec_lens, seed=4)
    plain = serve_counted(model, device, "sharded spec plain", prompts=tiled,
                          max_new=max_new, serving_mesh=mp2)
    spec = serve_counted(model, device, "sharded spec ngram", prompts=tiled,
                         max_new=max_new, serving_mesh=mp2, speculate=True,
                         num_draft_tokens=NUM_DRAFT, draft_source="ngram")
    greedy = [i for i in range(len(tiled)) if i not in SAMPLED]
    if any(spec["streams"][i] != plain["streams"][i] for i in greedy):
        raise AssertionError("sharded mp2: speculative greedy streams "
                             "differ from plain ones")
    _check_shard_launches(spec, L, 2, "sharded spec ngram",
                          ("paged_verify", "ragged_paged_attention"))
    print(f"[sharded spec] ({card}) mp2 ngram speculation: greedy streams "
          f"EQUAL to plain, drafts accepted {spec['drafts_accepted']} of "
          f"{spec['drafts_proposed']}, step_ms_p50 spec="
          f"{_p50_after_first(spec):.2f} plain={_p50_after_first(plain):.2f}",
          flush=True)
    for t, st in (("spec plain", plain), ("spec ngram", spec)):
        st["obs"] = None
        runs[t] = st

    gen = shard_generate(model, device, card, SHARD_RUNS)
    exact = gen["mp2"]["first_logits"]
    qerr = float((gen["mp2 int8-wire"]["first_logits"] - exact).abs().max())
    print(f"[sharded mp2 int8-wire] ({card}) prefill logits max_abs from "
          f"exact mp2 {qerr:.4e} of scale {float(exact.abs().max()):.4e}",
          flush=True)
    for tag, rec in gen.items():
        runs[f"generate {tag}"] = {"launches": rec["launches"]}
    runs.update(sharded_quant_runs(model, device, card, **serve_kw))
    runs["kernels"] = kres
    return runs


# (f) LoRA and int8 activations at mp=2: three adapter rows among the
# serve cell's eight requests
SHARD_LORA_IDS = ("s0", None, None, "s1", None, None, "s2", None)


def sharded_quant_runs(model, device, card, prompt_lens=PROMPT_LENS,
                       max_new=MAX_NEW):
    """(f) LoRA (three adapter rows; ``model`` is converted in place) and
    int8 activations (a fresh model of ``model``'s config, calibrated on
    two serve prompts) at mp=2 on the serve cell, each against its
    single-device run as (a) holds mp=2: the decode and ragged kernels
    once per shard a layer a step, graph EQUAL to eager, one capture and
    none after warm-up, the first step's logits within the bar.  Returns
    the runs by tag."""
    import torch

    from paddle_infer_tpu_torch.quantization import (QAT, QuantedLayer,
                                                     convert_int8)
    from paddle_infer_tpu_torch.serving import (ServingMesh,
                                                adapter_layer_spec)

    L = model.config.num_hidden_layers
    mp2 = ServingMesh(mp=2)
    spec = adapter_layer_spec(model)
    made = lora_adapters(spec, sorted(a for a in SHARD_LORA_IDS if a), 101)
    lora_kw = dict(adapter_ids=SHARD_LORA_IDS, adapter_slots=LORA_SLOTS)
    am = QAT().quantize(build_llama(device, config=model.config))
    am.eval()
    with torch.no_grad():
        for i in INT8_CAL_PROMPTS:
            am(torch.as_tensor(serve_prompts(am.config.vocab_size,
                                             prompt_lens)[i][None],
                               device=device))
    for m in am.modules():
        if isinstance(m, QuantedLayer):
            m._calibrating = False
    am = convert_int8(am)
    runs = {}
    for kind, m in (("lora", model), ("int8", am)):
        def kw(**more):
            base = dict(prompt_lens=prompt_lens, max_new=max_new, **more)
            if kind == "lora":
                base.update(lora_kw, adapter_store=lora_store(spec, made))
            return base

        single = serve_counted(m, device, f"sharded {kind} single", **kw())
        st = serve_counted(m, device, f"sharded {kind} mp2",
                           **kw(serving_mesh=mp2))
        _check_shard_launches(st, L, 2, f"sharded {kind} mp2")
        ev = eager_twin(m, device, f"sharded {kind} mp2", st, card,
                        **kw(serving_mesh=mp2))
        scale = float(single["first_logits"].abs().max())
        lerr = float((st["first_logits"] - single["first_logits"])
                     .abs().max())
        uploads = (st["obs"]["snapshot"].get("adapters") or {}).get(
            "uploads", 0)
        print(f"[sharded {kind} mp2] ({card}) step_ms_p50 graph="
              f"{_p50_after_first(st):.2f} eager={_p50_after_first(ev):.2f}"
              f" (one device {_p50_after_first(single):.2f}); first step's "
              f"logits max_abs={lerr:.4e} of scale {scale:.4e} (bar "
              f"{SHARD_LOGIT_BAR}); uploads={uploads}; post_warmup_captures="
              f"{st['post_warmup_captures']}; tokens agreeing with one "
              f"device {_agreement(single['streams'], st['streams'])} of "
              f"{max_new}", flush=True)
        if not lerr <= SHARD_LOGIT_BAR * scale:
            raise AssertionError(f"sharded {kind} mp2: first step's logits "
                                 f"{lerr} past {SHARD_LOGIT_BAR} x {scale}")
        if kind == "lora" and uploads < 3:
            raise AssertionError(f"sharded lora mp2: {uploads} uploads")
        for t, r in (("single", single), ("mp2", st), ("mp2 eager", ev)):
            r["obs"] = None
            runs[f"{kind} {t}"] = r
        del single, st, ev
        free_memory()
    del am
    free_memory()
    return runs


def sharded_ep_run(model, device, card, ep1, prompts, max_new):
    """(d) The MoE model over an ep=2 mesh (its expert stacks split, the
    dispatch buffer moved to the shards that own them and back) on the
    serve prompts: the routing of every step EQUAL to the ep=1 run
    ``ep1``'s, the step p50 and the ``ep_alltoall`` bytes."""
    from paddle_infer_tpu_torch.parallel.collective import LEDGER
    from paddle_infer_tpu_torch.serving import ServingMesh

    L = model.config.num_hidden_layers
    LEDGER.reset()
    st = serve_counted(model, device, "sharded ep2", prompts=prompts,
                       max_new=max_new, serving_mesh=ServingMesh(ep=2))
    _check_decode_launches(st, L, "sharded ep2")
    _check_ragged_launches(st, L, "sharded ep2")

    def routing(run):
        return [(r["moe_tokens_routed"], r["moe_tokens_dropped"])
                for r in run["obs"]["steplog"].records()
                if r["kind"] in STEP_KINDS]

    if routing(st) != routing(ep1):
        raise AssertionError("sharded ep2: per-step routed / dropped differ "
                             "from the ep=1 core's")
    sh = st["obs"]["snapshot"]["sharding"]
    a2a = sh["collectives"]["by_op_dtype"].get("ep_alltoall", {})
    moe = st["obs"]["snapshot"]["moe"]
    print(f"[sharded ep2] ({card}) mesh_axes={sh['mesh_axes']} "
          f"sharded_params={sh['sharded_params']} ep_alltoall bytes={a2a} "
          f"routed={moe['tokens_routed']} dropped={moe['tokens_dropped']} "
          f"(per step EQUAL to ep=1) step_ms_p50 ep2="
          f"{_p50_after_first(st):.2f} ep1={_p50_after_first(ep1):.2f} "
          f"tokens agreeing with ep=1 "
          f"{_agreement(ep1['streams'], st['streams'])} of {max_new}",
          flush=True)
    if not sum(a2a.values()) > 0 or moe["ep"] != 2:
        raise AssertionError(f"sharded ep2: no ep all-to-all bytes ({sh})")
    st["obs"] = None
    return st


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


# -------------------------------------------------------------- phase 10a

# gpt-moe-6.7b-8e: gpt3-6.7b's widths (hidden 4096, 32 heads of 128, an
# FFN of 16384 per expert, vocab 50304, 2048 positions) with MoEConfig's
# defaults (8 experts, GShard top-2, capacity factor 2.0), bf16, at 4
# of its 32 layers: a layer holds 1.14B parameters (2.28 GB), so 32 of
# them and the serve core's pools pass 80 GB; 16 ran until the default
# run, with the high-level API and MoE training phases added, passed
# 1100 s, 8 until the mesh training phase pushed it past again (4 since).
# Widths and the expert count are whole
MOE_LAYERS = 4
# run (c): 64 slots an expert.  Only a step's real tokens route (at most
# token_budget = 512; pads take no slot), about 128 an expert a full
# prompt step (top-1 and top-2): the default's 2048 never drops, 0.25's
# 256 seldom, this factor does
MOE_DROP_FACTOR = 0.0625
MOE_CAL_PROMPTS = (5, 6)    # serve prompts (128, 33 tokens) (f) calibrates on
MOE_LOGIT_ROW = 6           # the prompt whose last-position logits (f) reads


def moe_config(layers=MOE_LAYERS):
    from paddle_infer_tpu_torch.models import GPT_PRESETS, MoEConfig

    return MoEConfig(**dict(GPT_PRESETS["gpt3-6.7b"],
                            num_hidden_layers=layers))


def moe_layers(model):
    """The model's MoE FFNs, outermost (a core's serving wrappers once
    it converted them)."""
    from paddle_infer_tpu_torch.serving.moe.layer import _iter_moe_layers

    return list(_iter_moe_layers(model))


def _moe_line(tag, st, card):
    """The run's routing from its snapshot and its step log, which must
    agree; returns the snapshot's ``moe`` section."""
    moe = st["obs"]["snapshot"]["moe"]
    sl = st["obs"]["steplog"].summary()
    if (sl["moe_tokens_routed_total"], sl["moe_tokens_dropped_total"]) != (
            moe["tokens_routed"], moe["tokens_dropped"]):
        raise AssertionError(f"{tag}: the step log's routed / dropped "
                             f"totals differ from the snapshot's")
    print(f"[{tag}] ({card}) capacity={moe['capacity']} algo={moe['algo']} "
          f"expert_tokens={moe['expert_tokens']} "
          f"routed={moe['tokens_routed']} dropped={moe['tokens_dropped']} "
          f"dropped_ratio={moe['dropped_ratio']:.4f} "
          f"utilization_skew={moe['utilization_skew']:.3f} "
          f"gate_aux_loss={moe['gate_aux_loss']:.5f} (last step) "
          f"steplog routed={sl['moe_tokens_routed_total']} "
          f"dropped={sl['moe_tokens_dropped_total']} "
          f"step_ms_p50={_p50_after_first(st):.2f} "
          f"tokens_per_s={st['tokens_per_s']:.2f} "
          f"ttft_p50_s={float(np.median(st['ttft_s'])):.3f}", flush=True)
    return moe


def moe_convert_check(model, device, card, batch=8, seq=512):
    """(b) The first MoE layer, converted by the serve core, at its
    default capacity against its bare layer on one ``[batch, seq, d]``
    block: outputs and aux ``torch.equal``.  On the card both are timed,
    with the expert products alone beside them."""
    import torch

    from paddle_infer_tpu_torch.parallel.moe import (_capacity, _expert_ffn,
                                                      _gate_dispatch)

    lay = moe_layers(model)[0]
    inner = lay.inner
    cap = _capacity(batch * seq, inner.num_experts, inner.capacity_factor,
                    inner.top_k)
    if lay.capacity != cap:
        raise AssertionError(f"moe convert: serving capacity {lay.capacity}"
                             f", the bare layer's {cap} at {batch}x{seq}")
    d = inner.gate_weight.shape[0]
    gen = torch.Generator(device=device).manual_seed(3)
    x = torch.randn((batch, seq, d), generator=gen, device=device).to(
        inner.w1.dtype)
    with torch.inference_mode():
        got = lay(x)
        want = inner(x)
        if not (torch.equal(got, want) and torch.equal(lay.l_aux,
                                                       inner.l_aux)):
            raise AssertionError("moe convert: the converted layer differs "
                                 "from the bare layer at the default "
                                 "capacity")
        line = (f"[moe convert] ({card}) ServingMoELayer(capacity={cap}) "
                f"torch.equal to the bare MoELayer on a {batch}x{seq}x{d} "
                f"block (outputs and aux)")
        if device.type == "cuda":
            _, buf = _gate_dispatch(x, inner.gate_weight, inner.gate_kind,
                                    inner.top_k, cap)
            f = inner.w1.shape[2]
            conv = time_ms(lambda: lay(x))
            bare = time_ms(lambda: inner(x))
            ffn = time_ms(lambda: _expert_ffn(buf, inner.w1, inner.b1,
                                              inner.w2, inner.b2,
                                              inner.activation))
            flops = 4.0 * inner.num_experts * cap * d * f
            line += (f"; layer ms converted={conv:.3f} bare={bare:.3f}, "
                     f"expert products alone={ffn:.3f} "
                     f"({flops / ffn / 1e9:.1f} TFLOP/s over "
                     f"{flops / 1e12:.2f} TFLOP; CUDA-event median of 25)")
        print(line, flush=True)


def moe_dequantize_in_place(model):
    """Replace every ``WeightOnlyMoELayer`` by a float ``MoELayer`` in the
    model's dtype holding its dequantized stacks: the twin whose streams
    a weight-only core must EQUAL."""
    import torch

    from paddle_infer_tpu_torch.parallel.moe import MoELayer
    from paddle_infer_tpu_torch.quantization import WeightOnlyMoELayer
    from paddle_infer_tpu_torch.quantization.slim import _swap

    def plain(q):
        dtype = q.gate_weight.dtype
        lay = MoELayer(q.gate_weight.shape[0], q.b1.shape[1], q.num_experts,
                       gate=q.gate_kind, top_k=q.top_k,
                       capacity_factor=q.capacity_factor,
                       activation=q.activation, device=q.qw1.device,
                       dtype=dtype)
        with torch.no_grad():
            for name in ("gate_weight", "b1", "b2"):
                getattr(lay, name).copy_(getattr(q, name))
            lay.w1.copy_(q.dequantized("w1", dtype))
            lay.w2.copy_(q.dequantized("w2", dtype))
        return lay

    _swap(model, (WeightOnlyMoELayer,), plain)
    return model


def moe_calibrate_int8(model, device, prompts):
    """(f) Each MoE layer's two activation scales observed over
    ``prompts`` (eager forwards, the larger of the prompts' scales),
    then the float experts swapped for ``Int8MoELayer``s in place.
    Returns the scales' range."""
    import torch

    from paddle_infer_tpu_torch.quantization import (
        Int8MoELayer, calibrate_moe_act_scales)

    layers = moe_layers(model)
    seen = {i: [] for i in range(len(layers))}
    hooks = [lay.register_forward_pre_hook(
        lambda mod, args, i=i: seen[i].append(args[0].detach()))
        for i, lay in enumerate(layers)]
    try:
        with torch.no_grad():
            for p in prompts:
                model(torch.as_tensor(p[None], device=device))
    finally:
        for h in hooks:
            h.remove()
    scales = []
    for i, lay in enumerate(layers):
        got = [calibrate_moe_act_scales(lay.inner, x) for x in seen[i]]
        s_in, s_h = max(g[0] for g in got), max(g[1] for g in got)
        lay.inner = Int8MoELayer.from_moe(lay.inner, s_in, s_h)
        scales.append((s_in, s_h))
    return scales


def moe_phase(device, card, config=None, dtype=None, prompt_lens=PROMPT_LENS,
              max_new=MAX_NEW, spec_lens=SPEC_PROMPT_LENS,
              drop_factor=MOE_DROP_FACTOR, cal_prompts=MOE_CAL_PROMPTS,
              logit_row=MOE_LOGIT_ROW, convert_shape=(8, 512), ep_run=None,
              only_serve=False):
    """gpt-moe-6.7b-8e (or ``config``) behind the serve core's shape:
    (a) the serve prompts on graphs and again eager, streams EQUAL, the
    decode and ragged kernels once a layer a step, the routing from the
    snapshot and the step log; (b) ``moe_convert_check``; (c) capacity
    factor ``drop_factor``: drops in the snapshot, the step log and the
    exposition (streams printed, not gated); (d) ngram speculation on
    tiled prompts EQUAL to its plain twin, the verify kernel once a layer
    a step; (e) weight-only int8 experts EQUAL to the twin holding their
    dequantized stacks; (f) int8-activation experts calibrated on two
    serve prompts: one run, its last-position logits beside the bf16
    model's (not gated).  ``ep_run(model, (a), prompts, max_new)``, when
    given, runs after (a) on the same model (the sharded phase's ep=2
    run); ``only_serve`` stops after it.  Returns the runs by tag (each
    with its launches)."""
    import torch

    from paddle_infer_tpu_torch.models import GPTMoEForCausalLM
    from paddle_infer_tpu_torch.observability import render_prometheus
    from paddle_infer_tpu_torch.parallel.moe import MoELayer
    from paddle_infer_tpu_torch.quantization import (WeightOnlyMoELayer,
                                                     weight_only_summary)
    from paddle_infer_tpu_torch.quantization.slim import _swap

    cuda = device.type == "cuda"
    t_phase = time.perf_counter()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = config or moe_config()
    model = GPTMoEForCausalLM(cfg, device=device,
                              dtype=dtype or torch.bfloat16, seed=0)
    _sync(device)
    L = cfg.num_hidden_layers
    n = sum(p.numel() for p in model.parameters())
    print(f"[moe] {'gpt-moe-6.7b-8e' if config is None else 'gpt-moe'} "
          f"built in {time.perf_counter() - t0:.1f}s: hidden "
          f"{cfg.hidden_size}, layers {L}, {cfg.num_experts} experts of ffn "
          f"{cfg.intermediate_size}, {cfg.moe_gate} top-{cfg.moe_top_k}, "
          f"capacity factor {cfg.moe_capacity_factor}, vocab "
          f"{cfg.vocab_size}, params {n / 1e9:.2f}B "
          f"{str(next(model.parameters()).dtype)[6:]}", flush=True)
    prompts = serve_prompts(cfg.vocab_size, prompt_lens)
    runs = {}

    # (a) serve, graphs then eager
    st = serve_counted(model, device, "moe serve", prompts=prompts,
                       max_new=max_new)
    _check_decode_launches(st, L, "moe serve")
    _check_ragged_launches(st, L, "moe serve")
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
    ev = eager_twin(model, device, "moe serve", st, card, prompts=prompts,
                    max_new=max_new)
    moe = _moe_line("moe serve", st, card)
    if moe["tokens_routed"] <= 0 or moe["algo"] != "fp":
        raise AssertionError(f"moe serve: routed nothing ({moe})")
    print(f"[moe serve] ({card}) peak_mem_gb={peak:.1f} step_ms_p50 "
          f"graph={_p50_after_first(st):.2f} eager={_p50_after_first(ev):.2f}"
          f" tokens_per_s graph={st['tokens_per_s']:.2f} "
          f"eager={ev['tokens_per_s']:.2f} ttft_p50_s graph="
          f"{float(np.median(st['ttft_s'])):.3f}", flush=True)
    runs["serve"], runs["serve eager"] = st, ev
    if ep_run is not None:
        runs["sharded ep2"] = ep_run(model, st, prompts, max_new)
    if only_serve:
        del model
        free_memory()
        return runs
    ids = torch.as_tensor(prompts[logit_row][None], device=device)
    with torch.no_grad():
        bf16_logits = model(ids)[0, -1].float()

    # (b) converted against unconverted on one block
    moe_convert_check(model, device, card, *convert_shape)

    # (c) a capacity that drops, through the deployment's capacity factor
    for lay in moe_layers(model):
        lay.capacity_factor = lay.inner.capacity_factor = drop_factor
    try:
        dr = serve_counted(model, device, "moe drop", prompts=prompts,
                           max_new=max_new)
    finally:
        for lay in moe_layers(model):
            lay.capacity_factor = lay.inner.capacity_factor = \
                cfg.moe_capacity_factor
    dmoe = _moe_line("moe drop", dr, card)
    text = render_prometheus(dr["obs"]["snapshot"])
    prom = [float(ln.split()[-1]) for ln in text.splitlines()
            if ln.startswith("moe_tokens_dropped_total ")]
    sl = dr["obs"]["steplog"].summary()
    if not (dmoe["tokens_dropped"] > 0 and sl["moe_tokens_dropped_total"] > 0
            and prom and prom[0] > 0):
        raise AssertionError(f"moe drop: no drop surfaced at capacity "
                             f"{dmoe['capacity']} (snapshot "
                             f"{dmoe['tokens_dropped']}, step log "
                             f"{sl['moe_tokens_dropped_total']}, exposition "
                             f"{prom})")
    differ = sum(a != b for a, b in zip(dr["streams"], st["streams"]))
    print(f"[moe drop] ({card}) capacity factor {drop_factor}: dropped "
          f"{dmoe['tokens_dropped']} in the snapshot, "
          f"{sl['moe_tokens_dropped_total']} in the step log, "
          f"moe_tokens_dropped_total {prom[0]:.0f} in the exposition; "
          f"streams unlike (a)'s: {differ} of {len(st['streams'])}",
          flush=True)
    for i, s in enumerate(dr["streams"]):
        print(f"[moe drop] stream {i}: {list(s)}", flush=True)
    runs["drop"] = dr

    # (d) ngram speculation against its plain twin
    tiled = tiled_prompts(cfg.vocab_size, spec_lens, seed=5)
    kw = dict(prompts=tiled, max_new=max_new, sampled=())
    plain = serve_counted(model, device, "moe plain", **kw)
    spec = serve_counted(model, device, "moe ngram", speculate=True,
                         num_draft_tokens=NUM_DRAFT, draft_source="ngram",
                         **kw)
    _equal_streams("moe ngram", plain["streams"], spec["streams"])
    _check_verify_launches(spec, L, "moe ngram")
    _check_ragged_launches(spec, L, "moe ngram")
    print(f"[moe ngram] ({card}) streams EQUAL to the plain twin "
          f"({len(tiled)} requests); drafts proposed "
          f"{spec['drafts_proposed']} accepted {spec['drafts_accepted']}; "
          f"step_ms_p50 spec={_p50_after_first(spec):.2f} plain="
          f"{_p50_after_first(plain):.2f}", flush=True)
    runs["plain"], runs["ngram"] = plain, spec

    # (e) weight-only int8 experts against their dequantized twin
    t0 = time.perf_counter()
    _swap(model, (MoELayer,),
          lambda sub: WeightOnlyMoELayer.from_moe(sub, "weight_only_int8"))
    _sync(device)
    quant_s = time.perf_counter() - t0
    summ = weight_only_summary(model)
    wo = serve_counted(model, device, "moe weight_only int8",
                       prompts=prompts, max_new=max_new)
    _check_decode_launches(wo, L, "moe weight_only int8")
    _check_ragged_launches(wo, L, "moe weight_only int8")
    _moe_line("moe weight_only int8", wo, card)
    moe_dequantize_in_place(model)
    tw = serve_counted(model, device, "moe weight_only int8 twin",
                       prompts=prompts, max_new=max_new)
    _equal_streams("moe weight_only int8", tw["streams"], wo["streams"])
    print(f"[moe weight_only int8] ({card}) streams EQUAL to the "
          f"dequantized-experts twin ({len(prompts)} requests); quantize "
          f"{quant_s:.2f}s; payload {json.dumps(summ, sort_keys=True)}; "
          f"step_ms_p50 int8={_p50_after_first(wo):.2f} twin="
          f"{_p50_after_first(tw):.2f} bf16={_p50_after_first(st):.2f}",
          flush=True)
    runs["weight_only int8"], runs["weight_only int8 twin"] = wo, tw

    # (f) int8-activation experts, calibrated on two serve prompts
    t0 = time.perf_counter()
    scales = moe_calibrate_int8(model, device,
                                [prompts[i] for i in cal_prompts])
    cal_s = time.perf_counter() - t0
    ia = serve_counted(model, device, "moe int8 act", prompts=prompts,
                       max_new=max_new)
    _check_decode_launches(ia, L, "moe int8 act")
    _check_ragged_launches(ia, L, "moe int8 act")
    _moe_line("moe int8 act", ia, card)
    with torch.no_grad():
        got = model(ids)[0, -1].float()
    scale = float(bf16_logits.abs().max())
    dist = {"max_abs_over_scale":
            float((got - bf16_logits).abs().max()) / scale,
            "mean_abs_over_mean_abs": float((got - bf16_logits).abs().mean())
            / float(bf16_logits.abs().mean()),
            "argmax_equal": bool(int(got.argmax())
                                 == int(bf16_logits.argmax()))}
    print(f"[moe int8 act] ({card}) calibrated in {cal_s:.1f}s (act scales "
          f"in {min(s for s, _ in scales):.4g}..{max(s for s, _ in scales):.4g}"
          f", hidden {min(h for _, h in scales):.4g}.."
          f"{max(h for _, h in scales):.4g}); step_ms_p50 int8 act="
          f"{_p50_after_first(ia):.2f} bf16={_p50_after_first(st):.2f}; "
          f"last-position logits on the {prompts[logit_row].size}-token "
          f"prompt against the bf16 model (weight and activation "
          f"quantization) {json.dumps(dist, sort_keys=True)}", flush=True)
    runs["int8 act"] = ia
    del model
    free_memory()
    print(f"[moe] ({card}) phase wall {time.perf_counter() - t_phase:.1f}s; "
          "step_ms_p50 " + " ".join(
              f"{tag}={_p50_after_first(r):.2f}" for tag, r in runs.items()),
          flush=True)
    return runs


# --------------------------------------------------------------- phase 11

# (a) ERNIE-3.0-base attention with 10 % trailing padding as segment
# ids, (b) long causal (where the reference itself picks flash), (c)
# Sq < Sk causal, which exercises the offset Sk - Sq, (d) head_dim 256
# (the kernels' split accumulators), causal with padding segments, (e)
# the fine-tuning shape (ERNIE-3.0-base at 32 x 128, 10 % padding; the
# ``[hapi]`` phase runs it in fp32), (f) the ``[moe_train]`` step's
# causal attention (gpt-moe-6.7b-8e's 32 heads of 128 at 8 x 1024)
FLASH_SHAPES = {
    "a": dict(B=32, H=12, Sq=512, Sk=512, D=64, causal=False, pad=51),
    "b": dict(B=2, H=32, Sq=4096, Sk=4096, D=128, causal=True, pad=0),
    "c": dict(B=2, H=4, Sq=256, Sk=512, D=64, causal=True, pad=0),
    "d": dict(B=4, H=8, Sq=2000, Sk=2000, D=256, causal=True, pad=200),
    "e": dict(B=32, H=12, Sq=128, Sk=128, D=64, causal=False, pad=12),
    "f": dict(B=8, H=32, Sq=1024, Sk=1024, D=128, causal=True, pad=0),
}
FLASH_RUNS = (("a", "fp32", 0.1), ("a", "bf16", 0.1), ("a", "fp32", 0.0),
              ("a", "bf16", 0.0), ("b", "bf16", 0.0), ("c", "fp32", 0.1),
              ("c", "bf16", 0.1), ("c", "bf16", 0.0), ("d", "fp32", 0.1),
              ("d", "bf16", 0.1), ("d", "bf16", 0.0), ("a", "fp16", 0.1),
              ("a", "fp16", 0.0), ("d", "fp16", 0.1), ("e", "bf16", 0.1),
              ("e", "bf16", 0.0), ("e", "fp16", 0.1), ("e", "fp16", 0.0),
              ("e", "fp32", 0.1), ("e", "fp32", 0.0), ("f", "bf16", 0.1),
              ("f", "bf16", 0.0))
FLASH_TIMED = (("a", "bf16", 0.1), ("a", "bf16", 0.0), ("b", "bf16", 0.0),
               ("d", "bf16", 0.0), ("a", "fp16", 0.0), ("e", "bf16", 0.1),
               ("e", "bf16", 0.0), ("e", "fp16", 0.1), ("e", "fp16", 0.0),
               ("e", "fp32", 0.1), ("e", "fp32", 0.0), ("f", "bf16", 0.1),
               ("f", "bf16", 0.0))
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

    dt = {"fp32": torch.float32, "bf16": torch.bfloat16,
          "fp16": torch.float16}[kind]
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


# ------------------------------------------------------- phase 11 recipe

# the fine-tuning run: ERNIE-3.0-base classifying 32 x 128 (about 10 %
# trailing padding), the schedule of a GLUE-style recipe over 2 + 20
# steps, and the recompute / merge / O1 / optimizer runs beside it
FT_BATCH, FT_SEQ, FT_PEAK_LR = 32, 128, 5e-5
FT_WARMUP, FT_STEPS = 2, 20
RECIPE_STEPS = 3            # recompute and merge runs: steps per side
SCALER_STEPS, SCALER_BAD = 6, 2     # eager scaler run; the inf's step
SCALER_INIT = 2.0 ** 12
OPT_LAYERS, OPT_BATCH = 2, 8        # [train opt]: depth and batch x 512


def finetune_batch(vocab, batch, seq, seed=0):
    """Random ids, ``seq // 10`` trailing pads per row (mask 0) and a
    label the first token decides (id below half the vocabulary), so a
    classifier can learn it."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (batch, seq)).astype(np.int32)
    mask = np.ones((batch, seq), np.int32)
    mask[:, seq - max(1, seq // 10):] = 0
    labels = (ids[:, 0] < vocab // 2).astype(np.int32)
    return ids, mask, labels


def _cls_loss(m, ids, mask, labels):
    from paddle_infer_tpu_torch.nn import functional as PF

    return PF.cross_entropy(m(ids, attention_mask=mask), labels)


def no_decay(name):
    """AdamW's decay rule of the recipes: no decay for biases and norms."""
    return not (name.endswith("bias") or "norm" in name)


def ft_schedule(peak_lr, steps):
    """``LinearWarmup(PolynomialDecay(peak, steps), 10)``: the schedule
    of the fine-tuning run."""
    from paddle_infer_tpu_torch.optimizer import lr as L

    return L.LinearWarmup(L.PolynomialDecay(peak_lr, steps, end_lr=0.0),
                          warmup_steps=10, start_lr=0.0, end_lr=peak_lr)


def _strategy(device, amp=None, **fields):
    """``fleet.init`` on ``device`` with a strategy of ``fields`` and,
    with ``amp`` ("O1" / "O2" / "O1-f16"), that AMP level in bf16 (f16
    for the last)."""
    from paddle_infer_tpu_torch.parallel import DistributedStrategy, fleet

    st = DistributedStrategy(**fields)
    if amp:
        st.amp = True
        st.amp_configs = {"level": amp[:2], "dtype":
                          "float16" if amp.endswith("f16") else "bfloat16"}
    fleet.init(strategy=st, devices=[device])
    return st


@contextlib.contextmanager
def flash_calls():
    """``(dtype, head_dim, causal)`` of every flash wrapper call while
    open (a graph's capture runs them; its replays do not)."""
    from paddle_infer_tpu_torch.ops import flash_attention as FA

    seen = set()
    saved = {n: getattr(FA, n) for n in ("flash_fwd", "flash_dkdv",
                                         "flash_dq")}

    def spy(name, fn):
        def call(q, *a, **k):
            causal = a[5] if name == "flash_fwd" else a[8]
            seen.add((name, str(q.dtype).replace("torch.", ""),
                      int(q.shape[-1]), bool(causal)))
            return fn(q, *a, **k)
        return call
    for n, fn in saved.items():
        setattr(FA, n, spy(n, fn))
    try:
        yield seen
    finally:
        for n, fn in saved.items():
            setattr(FA, n, fn)


def _flash_launches(since=None):
    """The flash kernels' launch counts (less ``since``'s)."""
    from paddle_infer_tpu_torch.ops import _build

    return {n: _build.KERNELS[n].launches - (since or {}).get(n, 0)
            for n in ("flash_fwd", "flash_dkdv", "flash_dq")}


def _check_flash_launches(tag, got, steps, per_step):
    """Each flash kernel launched ``per_step[kernel]`` times per step."""
    want = {n: per_step[n] * steps for n in got}
    print(f"[{tag}] flash launches {got} (want {want})", flush=True)
    if got != want:
        raise AssertionError(f"{tag}: flash launches {got}, want {want}")


def _per_step(L, fwd=1, bwd=1):
    return {"flash_fwd": fwd * L, "flash_dkdv": bwd * L, "flash_dq": bwd * L}


def finetune_run(device, cfg, batch, seq, warmup, steps, peak_lr,
                 launches_per_step):
    """ERNIE sequence classification through ``FleetTrainStep``: O2
    bf16, dropout as ``cfg``, AdamW (weight decay 0.01 but biases and
    norms, the fine-tuning schedule, ``ClipGradByGlobalNorm(1.0)``),
    ``warmup`` + ``steps`` steps alternating two fixed batches.  Raises
    unless every step's learning rate (the value the step's staged
    buffer held) equals the schedule's host sequence in float32 and
    differs from the step before's, the compile log holds one ``train-step``
    event and none after warm-up, each flash kernel launched
    ``launches_per_step`` per step over the ``steps``, and every loss
    is finite."""
    import torch

    from paddle_infer_tpu_torch.models.ernie import \
        ErnieForSequenceClassification
    from paddle_infer_tpu_torch.observability import get_compile_log
    from paddle_infer_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm
    from paddle_infer_tpu_torch.parallel import FleetTrainStep

    log = get_compile_log()
    log.reset()
    total = warmup + steps
    st = _strategy(device, amp="O2")
    model = ErnieForSequenceClassification(cfg, num_classes=2,
                                           device=device, seed=0)
    opt = AdamW(learning_rate=ft_schedule(peak_lr, total),
                weight_decay=0.01, apply_decay_param_fun=no_decay,
                grad_clip=ClipGradByGlobalNorm(1.0))
    step = FleetTrainStep(model, _cls_loss, opt, strategy=st)
    host = ft_schedule(peak_lr, total)
    want_lr = []
    for _ in range(total):
        want_lr.append(float(np.float32(host())))
        host.step()
    batches = [[torch.from_numpy(a).to(device)
                for a in finetune_batch(cfg.vocab_size, batch, seq, seed)]
               for seed in (0, 1)]
    losses, lrs, ms = [], [], []
    for i in range(total):
        if i == warmup:
            if device.type == "cuda":
                torch.cuda.synchronize()
            t0 = _flash_launches()
        t = time.perf_counter()
        losses.append(float(step(*batches[i % 2])))
        ms.append((time.perf_counter() - t) * 1e3)
        lrs.append(float(step._scalars.host["lr"]))
    launches = _flash_launches(t0)
    events = log.events("train-step")
    post_warm = log.summary()["post_warmup_compiles"]
    if lrs != want_lr or any(a == b for a, b in zip(lrs, lrs[1:])):
        raise AssertionError(f"fine-tuning learning rates {lrs}, want the "
                             f"schedule's {want_lr}, changing every step")
    if len(events) != 1 or post_warm:
        raise AssertionError(f"compile log: {len(events)} train-step "
                             f"events, {post_warm} after warm-up (want 1, 0)")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite fine-tuning loss {losses}")
    _check_flash_launches("train ft", launches, steps,
                          _per_step(launches_per_step))
    return {"losses": losses, "lrs": lrs, "step_ms": ms,
            "step_ms_p50": float(np.median(ms[warmup:])),
            "launches": launches, "captures": len(events), "step": step,
            "data": batches[0]}


def train_ft(device, card, cfg=None, batch=FT_BATCH, seq=FT_SEQ,
             warmup=FT_WARMUP, steps=FT_STEPS, peak_lr=FT_PEAK_LR,
             launches_per_step=None):
    """``[train ft]``: ``finetune_run`` on the graph, then eager from the
    same seeds; raises unless the losses are EQUAL and each batch's
    losses fall (the mean of its last quarter below that of its
    first)."""
    from paddle_infer_tpu_torch.models.ernie import ErnieConfig

    cfg = cfg or ErnieConfig.from_preset("ernie-3.0-base")
    if launches_per_step is None:
        launches_per_step = cfg.num_hidden_layers if device.type == "cuda" \
            else 0
    runs = {}
    for mode in ("graph", "eager"):
        with eager() if mode == "eager" else contextlib.nullcontext():
            st = runs[mode] = finetune_run(device, cfg, batch, seq, warmup,
                                           steps, peak_lr, launches_per_step)
            if device.type == "cuda" and mode == "graph":
                st["profile"] = profile_train(st["step"], st["data"],
                                              tag="ft graph")
        st["step"].release_graphs()
        del st["step"], st["data"]
        free_memory()
    g, e = runs["graph"], runs["eager"]
    equal = g["losses"] == e["losses"]
    print(f"[train ft] ernie classification {batch}x{seq} O2 bf16 "
          f"({card}): step_ms_p50 graph={g['step_ms_p50']:.2f} eager="
          f"{e['step_ms_p50']:.2f} captures={g['captures']} lr "
          + " ".join(f"{x:.3e}" for x in g["lrs"]) + " losses "
          + " ".join(f"{x:.4f}" for x in g["losses"])
          + f" losses_equal={equal}", flush=True)
    if not equal:
        raise AssertionError("fine-tuning graph losses differ from eager: "
                             f"{g['losses']} {e['losses']}")
    own = g["losses"][warmup:]
    for b in (0, 1):
        seq_b = own[b::2]
        k = max(1, len(seq_b) // 4)
        if not np.mean(seq_b[-k:]) < np.mean(seq_b[:k]):
            raise AssertionError(f"fine-tuning loss on batch {b} did not go "
                                 f"down: {seq_b}")
    return g


def _pretrain_step(device, cfg, strategy, lr=1e-4, seed=0):
    """ERNIE pretraining on ``device`` through ``FleetTrainStep`` with
    AdamW at ``lr``, weights and keys seeded by ``seed``."""
    from paddle_infer_tpu_torch.models.ernie import ErnieForPretraining
    from paddle_infer_tpu_torch.optimizer import AdamW
    from paddle_infer_tpu_torch.parallel import FleetTrainStep

    model = ErnieForPretraining(cfg, device=device, seed=seed)
    opt = AdamW(learning_rate=lr, weight_decay=0.01,
                apply_decay_param_fun=no_decay)
    return FleetTrainStep(model, _pretrain_loss, opt, strategy=strategy)


def recompute_pair(device, card, cfg=None, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                   steps=RECIPE_STEPS, layers_fwd=None):
    """``[train recompute]``: ERNIE pretraining O2 bf16 with dropout 0.1,
    ``steps`` steps with ``recompute`` and ``steps`` without, each on the
    graph from the same weights and keys.  Raises unless the losses and
    every parameter after the steps are EQUAL (the same kernels at the
    same shapes: the recomputed forward gives the bits of the first) and
    the flash forward launched twice per layer per step under recompute
    (once otherwise), dK/dV and dQ once.  Prints each run's allocation
    peak."""
    import torch

    from paddle_infer_tpu_torch.models.ernie import ErnieConfig

    cfg = cfg or ErnieConfig.from_preset("ernie-3.0-base")
    L = cfg.num_hidden_layers if device.type == "cuda" else 0
    data = [torch.from_numpy(a).to(device)
            for a in pretrain_batch(cfg.vocab_size, batch, seq)]
    runs = {}
    for name, fields in (("recompute", {"recompute": True}), ("plain", {})):
        step = _pretrain_step(device, cfg, _strategy(device, amp="O2",
                                                     **fields))
        step.keys.seed(3)
        free_memory()
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = _flash_launches()
        losses, ms = [], []
        for _ in range(steps):
            t = time.perf_counter()
            losses.append(float(step(*data)))
            ms.append((time.perf_counter() - t) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 1e9 \
            if device.type == "cuda" else 0.0
        _check_flash_launches(f"train recompute {name}", _flash_launches(t0),
                              steps, _per_step(L, fwd=2 if name ==
                                               "recompute" else 1))
        runs[name] = {"losses": losses, "peak_alloc_gb": peak,
                      "replay_ms": float(np.median(ms[1:])),
                      "params": {n: p.detach().clone()
                                 for n, p in step.params.items()}}
        step.release_graphs()
        del step
        free_memory()
    r, p = runs["recompute"], runs["plain"]
    same = all(torch.equal(r["params"][n], p["params"][n])
               for n in p["params"])
    print(f"[train recompute] {batch}x{seq} O2 bf16 dropout 0.1 ({card}): "
          f"losses recompute " + " ".join(f"{x:.6f}" for x in r["losses"])
          + " plain " + " ".join(f"{x:.6f}" for x in p["losses"])
          + f" losses_equal={r['losses'] == p['losses']} params_equal={same}"
          f" peak_alloc_gb recompute={r['peak_alloc_gb']:.2f} plain="
          f"{p['peak_alloc_gb']:.2f} (the graphs' capture pools included)"
          f" replay_ms recompute={r['replay_ms']:.2f} plain="
          f"{p['replay_ms']:.2f}", flush=True)
    if r["losses"] != p["losses"] or not same:
        raise AssertionError("recompute changed the step's bits")
    return {k: {kk: v for kk, v in run.items() if kk != "params"}
            for k, run in runs.items()}


def _o2_grads(step, data):
    """One eager step's loss and float32 gradients (lr 0: the weights
    stay), keys seeded as every side of a comparison."""
    step.keys.seed(11)
    loss = float(step(*data))
    return loss, {n: q.grad.float().clone() for n, q in step.params.items()}


def merge_run(device, card, cfg=None, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
              steps=RECIPE_STEPS, k_steps=2):
    """``[train merge]``: ERNIE pretraining O2 bf16 with
    ``gradient_merge`` (``k_steps`` micro-batches of ``batch / k_steps``
    rows), dropout 0.1, ``steps`` steps on the graph: each flash kernel
    launched ``k_steps`` times per layer per step.  Then, eager at
    dropout 0 and lr 0 on one model, whose every row holds the same
    number of valid tokens (so the mean over micro-batches is the batch
    mean): the merged step, the plain step and the plain fp32 step;
    raises unless the merged loss lies within 2e-2 of the plain one and
    every merged gradient within 5e-2 of the plain one's max-abs or
    twice the plain O2 step's distance from the fp32 step (PERF.md §2's
    O2 limits)."""
    import torch

    from paddle_infer_tpu_torch.models.ernie import ErnieConfig

    cfg = cfg or ErnieConfig.from_preset("ernie-3.0-base")
    L = cfg.num_hidden_layers if device.type == "cuda" else 0
    merge = dict(gradient_merge=True,
                 gradient_merge_configs={"k_steps": k_steps})
    data = [torch.from_numpy(a).to(device)
            for a in pretrain_batch(cfg.vocab_size, batch, seq)]
    step = _pretrain_step(device, cfg, _strategy(device, amp="O2", **merge))
    t0 = _flash_launches()
    losses = [float(step(*data)) for _ in range(steps)]
    _check_flash_launches("train merge", _flash_launches(t0), steps,
                          _per_step(L, fwd=k_steps, bwd=k_steps))
    step.release_graphs()
    del step
    free_memory()
    cfg0 = type(cfg)(**dict(vars(cfg), hidden_dropout_prob=0.0,
                            attention_probs_dropout_prob=0.0))
    with eager():
        from paddle_infer_tpu_torch.parallel import FleetTrainStep

        base = _pretrain_step(device, cfg0, _strategy(device), lr=0.0)
        sides = {}
        for name, amp, fields in (("merged", "O2", merge),
                                  ("plain", "O2", {}), ("fp32", None, {})):
            st = _strategy(device, amp=amp, **fields)
            sides[name] = _o2_grads(FleetTrainStep(
                base.model, _pretrain_loss, base.optimizer, strategy=st),
                data)
    (lm, gm), (lp, gp), (_, g32) = (sides[n] for n in ("merged", "plain",
                                                        "fp32"))
    rel = abs(lm - lp) / abs(lp)
    worst, where = 0.0, ""
    for n in gp:
        allowed = max(5e-2 * float(gp[n].abs().max()),
                      2 * float((gp[n] - g32[n]).abs().max()), 1e-30)
        r_ = float((gm[n] - gp[n]).abs().max()) / allowed
        if r_ > worst:
            worst, where = r_, n
    print(f"[train merge] k_steps={k_steps} {batch}x{seq} O2 bf16 ({card}): "
          f"graph losses " + " ".join(f"{x:.4f}" for x in losses)
          + f"; dropout 0: loss merged={lm:.6f} plain={lp:.6f} rel="
          f"{rel:.3e} (tol 2e-2) worst grad err/allowed={worst:.3e} "
          f"({where})", flush=True)
    if not all(np.isfinite(losses)) or rel > 2e-2 or worst > 1.0:
        raise AssertionError("the merged step leaves the plain step's O2 "
                             "limits")
    del base, sides
    free_memory()
    return {"losses": losses, "rel": rel, "worst": worst}


def o1_run(device, card, cfg=None, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
           steps=2):
    """``[train o1]``: ERNIE pretraining at AMP level O1 in bf16, eager
    fp32 first (lr 0, so the weights stay) on the same keys, then
    ``steps`` O1 steps on the graph.  Raises unless the first O1 loss
    lies within 2e-2 relative of the fp32 one and the flash kernels took
    bf16 (once per layer per step each)."""
    import torch

    from paddle_infer_tpu_torch.models.ernie import ErnieConfig
    from paddle_infer_tpu_torch.parallel import FleetTrainStep

    cfg = cfg or ErnieConfig.from_preset("ernie-3.0-base")
    L = cfg.num_hidden_layers if device.type == "cuda" else 0
    data = [torch.from_numpy(a).to(device)
            for a in pretrain_batch(cfg.vocab_size, batch, seq)]
    with eager():
        fp32 = _pretrain_step(device, cfg, _strategy(device), lr=0.0)
        fp32.keys.seed(5)
        l32 = float(fp32(*data))
    step = FleetTrainStep(fp32.model, _pretrain_loss, fp32.optimizer,
                          strategy=_strategy(device, amp="O1"))
    step.keys.seed(5)
    t0 = _flash_launches()
    with flash_calls() as calls:
        losses = [float(step(*data)) for _ in range(steps)]
    seen = {c[1] for c in calls}
    rel = abs(losses[0] - l32) / abs(l32)
    print(f"[train o1] {batch}x{seq} bf16 ({card}): loss O1={losses[0]:.6f} "
          f"fp32={l32:.6f} rel={rel:.3e} (tol 2e-2) flash dtypes "
          f"{sorted(seen)}", flush=True)
    _check_flash_launches("train o1", _flash_launches(t0), steps,
                          _per_step(L))
    if rel > 2e-2 or (L and seen != {"bfloat16"}):
        raise AssertionError("the O1 step leaves the fp32 step's limit or "
                             "its attention was not bf16")
    step.release_graphs()
    del step, fp32
    free_memory()
    return {"losses": losses, "fp32": l32, "rel": rel}


def scaler_run(device, card, cfg=None, batch=FT_BATCH, seq=FT_SEQ,
               steps=SCALER_STEPS, bad=SCALER_BAD, lr=FT_PEAK_LR):
    """``[train scaler]``: the eager loop on ERNIE sequence
    classification, ``auto_cast(level="O1", dtype="float16")`` with
    ``GradScaler(init_loss_scaling=SCALER_INIT)``, AdamW over
    ``model.named_parameters()``: ``loss = scaler.scale(loss);
    loss.backward(); scaler.step(opt); scaler.update();
    opt.clear_grad()``, with an inf written into one gradient at step
    ``bad``.  Raises unless that step alone is skipped with every
    parameter bitwise unchanged, the scale halves there and then counts
    good steps as the reference's rule does (scales and counters equal
    the rule's replay), the other steps move the parameters, and the
    flash kernels took float16, once per layer per step each."""
    import torch

    from paddle_infer_tpu_torch import amp
    from paddle_infer_tpu_torch.models.ernie import (
        ErnieConfig, ErnieForSequenceClassification)
    from paddle_infer_tpu_torch.nn import functional as PF
    from paddle_infer_tpu_torch.optimizer import AdamW

    cfg = cfg or ErnieConfig.from_preset("ernie-3.0-base")
    L = cfg.num_hidden_layers if device.type == "cuda" else 0
    model = ErnieForSequenceClassification(cfg, num_classes=2,
                                           device=device, seed=0)
    opt = AdamW(lr, parameters=model.named_parameters(), weight_decay=0.01,
                apply_decay_param_fun=no_decay)
    scaler = amp.GradScaler(init_loss_scaling=SCALER_INIT)
    ids, mask, labels = (torch.from_numpy(a).to(device) for a in
                         finetune_batch(cfg.vocab_size, batch, seq))
    first = next(iter(model.parameters()))
    rows, want = [], []
    scale, good = SCALER_INIT, 0                 # the reference's rule
    t0 = _flash_launches()
    with flash_calls() as calls:
        for i in range(steps):
            with amp.auto_cast(level="O1", dtype="float16"):
                loss = PF.cross_entropy(model(ids, attention_mask=mask),
                                        labels)
            scaler.scale(loss).backward()
            if i == bad:
                first.grad.view(-1)[0] = float("inf")
            before = [p.detach().clone() for p in model.parameters()]
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
            moved = not all(torch.equal(b, p) for b, p in
                            zip(before, model.parameters()))
            rows.append((float(loss.detach()), scaler._found_inf, moved,
                         scaler.get_loss_scaling(), scaler._good_steps))
            if i == bad:
                scale, good = max(scale * 0.5, 1.0), 0
            else:
                good += 1
                if good >= 1000:
                    scale, good = scale * 2.0, 0
            want.append((i == bad, i != bad, scale, good))
    seen = {c[1] for c in calls}
    print(f"[train scaler] eager O1 float16 {batch}x{seq} ({card}): "
          "(loss, skipped, moved, scale, good steps) "
          + " ".join(f"({l:.4f}, {f}, {m}, {s:g}, {g})"
                     for l, f, m, s, g in rows)
          + f" flash dtypes {sorted(seen)}", flush=True)
    _check_flash_launches("train scaler", _flash_launches(t0), steps,
                          _per_step(L))
    got = [(f, m, s, g) for _, f, m, s, g in rows]
    if got != want or not all(np.isfinite(r[0]) for r in rows):
        raise AssertionError(f"GradScaler run {got}, want {want}")
    if L and seen != {"float16"}:
        raise AssertionError(f"flash kernels took {seen}, want float16")
    del model, opt
    free_memory()
    return rows


# [train opt]: the optimizers besides AdamW (and L1Decay), two steps each
OPT_CASES = (
    ("SGD", dict(learning_rate=1e-3)),
    ("Momentum", dict(learning_rate=1e-3, momentum=0.9)),
    ("Adagrad", dict(learning_rate=1e-3)),
    ("RMSProp", dict(learning_rate=1e-4, momentum=0.9, centered=True)),
    ("Lamb", dict(learning_rate=1e-3, lamb_weight_decay=0.01)),
    ("Lars", dict(learning_rate=1e-2, exclude_from_weight_decay=["bias",
                                                                  "norm"])),
    ("Adadelta", dict(learning_rate=1.0)),
    ("Adamax", dict(learning_rate=1e-3)),
    ("Adam+L1Decay", dict(learning_rate=1e-4)),
)


def _opt(name, kw):
    from paddle_infer_tpu_torch import optimizer as O
    from paddle_infer_tpu_torch.regularizer import L1Decay

    if name == "Adam+L1Decay":
        return O.Adam(weight_decay=L1Decay(1e-4), **kw)
    return getattr(O, name)(**kw)


def optimizers_run(device, card, cfg=None, layers=OPT_LAYERS,
                   batch=OPT_BATCH, seq=TRAIN_SEQ, cases=OPT_CASES):
    """``[train opt]``: each optimizer of ``cases`` for two ERNIE
    pretraining steps (O2 bf16, dropout 0.1, ERNIE-3.0-base widths at
    ``layers`` layers) on the graph and again eager from the same seeds.
    Raises unless every loss and parameter is finite, the losses and
    parameters of the two runs are EQUAL, and each graph run captured
    once."""
    import torch

    from paddle_infer_tpu_torch.models.ernie import (ErnieConfig,
                                                     ErnieForPretraining)
    from paddle_infer_tpu_torch.observability import get_compile_log
    from paddle_infer_tpu_torch.parallel import FleetTrainStep

    base = cfg or ErnieConfig.from_preset("ernie-3.0-base")
    cfg = type(base)(**dict(vars(base), num_hidden_layers=layers))
    data = [torch.from_numpy(a).to(device)
            for a in pretrain_batch(cfg.vocab_size, batch, seq)]
    log = get_compile_log()
    out = {}
    for name, kw in cases:
        runs = {}
        for mode in ("graph", "eager"):
            log.reset()
            with eager() if mode == "eager" else contextlib.nullcontext():
                model = ErnieForPretraining(cfg, device=device, seed=0)
                step = FleetTrainStep(model, _pretrain_loss, _opt(name, kw),
                                      strategy=_strategy(device, amp="O2"))
                step.keys.seed(2)
                losses = [float(step(*data))]
                t = time.perf_counter()
                losses.append(float(step(*data)))
                runs[mode] = (losses, [p.detach().clone()
                                       for p in step.params.values()],
                              len(log.events("train-step")),
                              (time.perf_counter() - t) * 1e3)
                step.release_graphs()
                del step, model
        (lg, pg, cap, ms), (le, pe, _, _) = runs["graph"], runs["eager"]
        finite = all(np.isfinite(lg)) and all(torch.isfinite(p).all()
                                              for p in pg)
        equal = lg == le and all(torch.equal(a, b) for a, b in zip(pg, pe))
        print(f"[train opt] {name} ({card}): losses "
              + " ".join(f"{x:.4f}" for x in lg)
              + f" finite={finite} graph_equals_eager={equal} captures="
              f"{cap} second_step_ms={ms:.2f}", flush=True)
        if not (finite and equal and cap == 1):
            raise AssertionError(f"[train opt] {name} failed")
        out[name] = lg
        del runs, pg, pe
        free_memory()
    return out


def recipe_phase(device, card):
    """Phase 11.5, the training recipe: fine-tuning (schedule, clip), then
    recompute, gradient merge, O1, the eager scaler loop and the other
    optimizers; returns each run's flash launches."""
    launches = {}
    for tag, fn in (("train ft", train_ft), ("train recompute",
                                             recompute_pair),
                    ("train merge", merge_run), ("train o1", o1_run),
                    ("train scaler", scaler_run),
                    ("train opt", optimizers_run)):
        t0 = _flash_launches()
        fn(device, card)
        launches[tag] = _flash_launches(t0)
        free_memory()
        lap(tag)
    return launches


# ------------------------------------------------- phases 11.6 and 11.7

# ernie-3.0-base's widths at 6 of its 12 layers: the eager loop is host
# bound, so the depth sets the phase's wall (12 until the mesh training
# phase pushed the default run past 1100 s)
HAPI_LAYERS = 6
HAPI_TRAIN_ROWS = 512
HAPI_EVAL_ROWS = 128
HAPI_BATCH = 32
HAPI_SEQ = 128
HAPI_EPOCHS = 2
HAPI_PEAK_LR = 1e-4
HAPI_WORKERS = 2
HAPI_ACC_BAR = 0.9
MOE_TRAIN_LAYERS = 1        # of gpt-moe-6.7b-8e's 32: 2 ran out of memory (PERF.md §4)
MOE_TRAIN_BATCH = 8
MOE_TRAIN_SEQ = 1024
MOE_TRAIN_WARMUP = 2
MOE_TRAIN_STEPS = 10
MOE_TRAIN_LR = 1e-4
MOE_AUX_COEF = 0.01


class MarkedRows:
    """A synthetic classification set made from a seed: random token rows
    of ``seq`` ids in ``[3, vocab)`` whose first token, 1 or 2, is the
    marker that decides the label (0 or 1).  Items are numpy, so the
    loader's workers build batches without torch; a module-level class,
    so a fork server's workers can unpickle it."""

    def __init__(self, n, seq, vocab, seed):
        rng = np.random.RandomState(seed)
        self.labels = rng.randint(0, 2, n).astype(np.int64)
        self.ids = rng.randint(3, vocab, (n, seq)).astype(np.int64)
        self.ids[:, 0] = self.labels + 1

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        return self.ids[i], self.labels[i]


class _HapiProbe:
    """A ``hapi`` callback: each training batch's wall (its loss read
    back included), loss and flash launches, and each epoch's training
    wall (up to its last batch: the epoch's evaluation is left out)."""

    def __init__(self):
        self.batch_ms, self.losses, self.batch_launches = [], [], []
        self.epoch_s = []

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *a, **k: None
        raise AttributeError(name)

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch_t = time.perf_counter()

    def on_train_batch_begin(self, step, logs=None):
        self._t, self._l = time.perf_counter(), _flash_launches()

    def on_train_batch_end(self, step, logs=None):
        self._end = time.perf_counter()
        self.batch_ms.append((self._end - self._t) * 1e3)
        self.losses.append(logs["loss"])
        self.batch_launches.append(_flash_launches(self._l))

    def on_epoch_end(self, epoch, logs=None):
        self.epoch_s.append(self._end - self._epoch_t)


def profile_hapi(hm, batches, steps=2):
    """Where a ``hapi`` training batch's time goes: ``steps`` calls of
    ``Model.train_batch`` under ``torch.profiler`` (``profile_train``:
    device busy and idle share, flash / matmul / other), then each of
    ``batches`` once more through the body of ``train_batch`` on the
    host clock, the card synchronized between its parts: forward and
    loss, ``backward``, the optimizer's ``step`` and ``clear_grad``, the
    read back.  Prints both; returns the profile and the parts' medians
    in ms."""
    import torch

    prof = profile_train(lambda *b: hm.train_batch(list(b))[0],
                         batches[0], steps=steps, tag="hapi eager")
    sync = torch.cuda.synchronize
    parts = {"forward": [], "backward": [], "optimizer": [], "read": []}
    net, opt = hm.network, hm._optimizer
    net.train()
    for b in batches:
        sync()
        t0 = time.perf_counter()
        ins, labs = hm._batch(b, None)
        out = net(*ins)
        loss = hm._loss(out, *labs)
        sync()
        t1 = time.perf_counter()
        loss.backward()
        sync()
        t2 = time.perf_counter()
        opt.step()
        opt.clear_grad()
        sync()
        t3 = time.perf_counter()
        hm._read_back(loss, out, labs)
        t4 = time.perf_counter()
        for k, a, z in (("forward", t0, t1), ("backward", t1, t2),
                        ("optimizer", t2, t3), ("read", t3, t4)):
            parts[k].append((z - a) * 1e3)
    med = {k: float(np.median(v)) for k, v in parts.items()}
    print(f"[profile] hapi split ({len(batches)} batches, synchronized "
          "between parts, ms p50): " + " ".join(
              f"{k}={v:.2f}" for k, v in med.items())
          + f" sum={sum(med.values()):.2f}", flush=True)
    return dict(prof, split_ms=med)


def hapi_phase(device, card, cfg=None, train_rows=HAPI_TRAIN_ROWS,
               eval_rows=HAPI_EVAL_ROWS, batch=HAPI_BATCH, seq=HAPI_SEQ,
               epochs=HAPI_EPOCHS, workers=HAPI_WORKERS,
               acc_bar=HAPI_ACC_BAR, peak_lr=HAPI_PEAK_LR,
               launches_per_batch=None):
    """Phase 11.6, ``[hapi]``: ``hapi.Model`` over
    ``ErnieForSequenceClassification`` (fp32, the reference ``Model`` has
    no AMP) fed by ``io.DataLoader(shuffle=True, num_workers=2)`` worker
    processes: ``prepare(AdamW + LinearWarmup, CrossEntropyLoss,
    Accuracy)``, ``fit`` with ``EarlyStopping``, ``LRSchedulerCallback``
    and a checkpoint directory, ``evaluate``, ``predict``, ``save`` /
    ``load`` into a fresh model, ``summary``.  The eager loop has no
    graph, so it runs once.  Raises unless the loss falls, held-out
    accuracy reaches ``acc_bar``, the loaded model's predictions are
    EQUAL to the trained one's, the loader's workers are processes other
    than this one, and the flash kernels (f32) launch
    ``launches_per_batch`` each per training batch and the forward that
    many per evaluation or prediction batch."""
    import tempfile

    import torch

    from paddle_infer_tpu_torch import io as pio
    from paddle_infer_tpu_torch import nn as pnn
    from paddle_infer_tpu_torch.hapi import (EarlyStopping,
                                             LRSchedulerCallback, Model)
    from paddle_infer_tpu_torch.io.worker import default_start_method
    from paddle_infer_tpu_torch.metric import Accuracy
    from paddle_infer_tpu_torch.models.ernie import (
        ErnieConfig, ErnieForSequenceClassification)
    from paddle_infer_tpu_torch.optimizer import AdamW
    from paddle_infer_tpu_torch.optimizer import lr as L

    cfg = cfg or ErnieConfig.from_preset("ernie-3.0-base",
                                     num_hidden_layers=HAPI_LAYERS)
    if launches_per_batch is None:
        launches_per_batch = cfg.num_hidden_layers \
            if device.type == "cuda" else 0
    train = pio.DataLoader(MarkedRows(train_rows, seq, cfg.vocab_size, 0),
                           batch_size=batch, shuffle=True,
                           num_workers=workers)
    held = pio.DataLoader(MarkedRows(eval_rows, seq, cfg.vocab_size, 1),
                          batch_size=batch, num_workers=workers)
    n_train, n_eval = len(train), len(held)
    start_method = default_start_method()
    caught = warnings.catch_warnings(record=True)
    seen = caught.__enter__()
    warnings.simplefilter("always")
    # the loader on its own, two epochs: the first starts the workers'
    # fork server (a CUDA process's start method), the second forks its
    # workers from it, as each of the fit's epochs does
    walls = []
    for seed in (0, 1):
        np.random.seed(seed)
        stamps = [time.perf_counter()]
        for _ in train:
            stamps.append(time.perf_counter())
        walls.append(stamps)
    loader_first_s = walls[0][-1] - walls[0][0]
    loader_bps = n_train / (walls[1][-1] - walls[1][0])
    loader_steady = (n_train - 1) / (walls[1][-1] - walls[1][1])
    loader_pids = set(train.last_worker_pids)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model = ErnieForSequenceClassification(cfg, num_classes=2,
                                           device=device, seed=0)
    total = epochs * n_train
    sched = L.LinearWarmup(L.PolynomialDecay(peak_lr, total, end_lr=0.0),
                           warmup_steps=max(1, total // 8), start_lr=0.0,
                           end_lr=peak_lr)
    hm = Model(model)
    hm.prepare(optimizer=AdamW(learning_rate=sched,
                               parameters=model.parameters(),
                               weight_decay=0.01),
               loss=pnn.CrossEntropyLoss(), metrics=Accuracy())
    probe = _HapiProbe()
    stop = EarlyStopping(monitor="eval_loss", patience=1)
    lr_cb = LRSchedulerCallback(by_step=True)
    with tempfile.TemporaryDirectory() as ckpt:
        np.random.seed(1)
        t0 = _flash_launches()
        t = time.perf_counter()
        hist = hm.fit(train, eval_data=held, epochs=epochs, log_freq=8,
                      verbose=1, save_dir=ckpt,
                      callbacks=[probe, stop, lr_cb])
        fit_s = time.perf_counter() - t
        fit_launches = _flash_launches(t0)
        saved = sorted(os.listdir(ckpt))
        fit_pids = set(train.last_worker_pids)
        t0 = _flash_launches()
        t = time.perf_counter()
        logs = hm.evaluate(held)
        eval_s = time.perf_counter() - t
        eval_launches = _flash_launches(t0)
        t0 = _flash_launches()
        preds = hm.predict(held)
        pred_launches = _flash_launches(t0)
        path = os.path.join(ckpt, "trained")
        hm.save(path)
        fresh = ErnieForSequenceClassification(cfg, num_classes=2,
                                               device=device, seed=7)
        hm2 = Model(fresh).prepare(loss=pnn.CrossEntropyLoss())
        hm2.load(path, reset_optimizer=True)
        preds2 = hm2.predict(held)
    caught.__exit__(None, None, None)
    forks = sorted({str(w.message)[:80] for w in seen
                    if "fork" in str(w.message)})
    peak = torch.cuda.max_memory_allocated() / 1e9 \
        if device.type == "cuda" else 0.0
    rows = hm.summary(input_size=(batch, seq), dtype="int64")
    equal = len(preds) == len(preds2) == n_eval and all(
        np.array_equal(a, b) for a, b in zip(preds, preds2))
    steps = len(probe.batch_ms)
    p50 = float(np.median(probe.batch_ms[1:] or probe.batch_ms))
    half = len(probe.batch_ms) // 2
    spread = " ".join(f"{np.min(x):.2f}/{np.median(x):.2f}/{np.max(x):.2f}"
                      for x in (probe.batch_ms[1:half] or [0.0],
                                probe.batch_ms[half:] or [0.0]))
    fit_bps = steps / sum(probe.epoch_s)
    per = _per_step(launches_per_batch)
    print(f"[hapi] ernie-3.0-base x{cfg.num_hidden_layers} classification "
          f"fp32 {batch}x{seq}, "
          f"{train_rows} + {eval_rows} rows, {epochs} epochs, {workers} "
          f"worker processes ({card}): step_ms_p50={p50:.2f} (min / "
          f"p50 / max by epoch {spread}; host load {os.getloadavg()[0]:.2f} "
          f"on {len(os.sched_getaffinity(0))} cores) fit "
          f"{fit_s:.2f}s loader: first epoch {loader_first_s:.2f}s, then "
          f"batches_per_s={loader_bps:.1f} (after its first batch "
          f"{loader_steady:.1f}); fit batches_per_s={fit_bps:.2f} (after "
          f"the first, {1e3 / p50:.2f}) peak_gb={peak:.2f} "
          f"start_method={start_method} history "
          + " ".join(f"{x:.4f}" for x in hist["loss"])
          + f" eval {logs} eval_s={eval_s:.2f} stopped_epoch="
          f"{stop.stopped_epoch} checkpoints={saved} predictions_equal="
          f"{equal} summary_rows={len(rows['layers'])} params="
          f"{rows['total_params']} loader_pids={sorted(loader_pids)} "
          f"fit_pids={sorted(fit_pids)} this={os.getpid()} fork "
          f"warnings {forks}", flush=True)
    print(f"[hapi] flash launches fit {fit_launches} evaluate "
          f"{eval_launches} predict {pred_launches}; per training batch "
          f"{probe.batch_launches[0]}", flush=True)
    k = max(1, len(probe.losses) // 8)
    if not (hist["loss"][-1] < hist["loss"][0] and np.mean(
            probe.losses[-k:]) < np.mean(probe.losses[:k])):
        raise AssertionError(f"hapi: the loss did not fall: epochs "
                             f"{hist['loss']}, batches {probe.losses}")
    if not logs.get("acc", 0.0) >= acc_bar:
        raise AssertionError(f"hapi: held-out accuracy {logs} < {acc_bar}")
    if not equal:
        raise AssertionError("hapi: predictions after load differ")
    for pids in (loader_pids, fit_pids):
        if not pids or len(pids) > workers or os.getpid() in pids:
            raise AssertionError(f"hapi: loader pids {pids}, want up to "
                                 f"{workers} worker processes, not this "
                                 f"one ({os.getpid()})")
    bad = [b for b in probe.batch_launches if b != per]
    want_fit = {k: v * steps for k, v in per.items()}
    want_fit["flash_fwd"] += launches_per_batch * len(hist["loss"]) * n_eval
    want_eval = {"flash_fwd": launches_per_batch * n_eval, "flash_dkdv": 0,
                 "flash_dq": 0}
    if bad or fit_launches != want_fit or eval_launches != want_eval \
            or pred_launches != want_eval:
        raise AssertionError(
            f"hapi: flash launches per batch {bad[:2]} (want {per}), fit "
            f"{fit_launches} (want {want_fit}), evaluate {eval_launches} "
            f"/ predict {pred_launches} (want {want_eval})")
    if "final.pdparams" not in saved or "0.pdparams" not in saved:
        raise AssertionError(f"hapi: checkpoints {saved}")
    if device.type == "cuda":
        # after the checks: these batches train the model further
        profile_hapi(hm, list(held))
    del hm, hm2, model, fresh
    return {"step_ms_p50": p50, "launches": {
        k: fit_launches[k] + eval_launches[k] + pred_launches[k]
        for k in fit_launches}}


def _moe_lm_loss(m, ids, labels):
    from paddle_infer_tpu_torch.models import gpt_lm_loss

    return gpt_lm_loss(m(ids), labels) + MOE_AUX_COEF * m.moe_aux_loss()


def _is_moe_tensor(name):
    return name.rsplit(".", 1)[-1] in ("gate_weight", "w1", "b1", "w2", "b2")


def moe_train_run(device, config, batch, seq, warmup, steps, trained=None,
                  seed=0):
    """``GPTMoEForCausalLM`` through ``FleetTrainStep``: O2 bf16, AdamW,
    ``gpt_lm_loss + 0.01 * moe_aux_loss()``, ``warmup + steps`` steps on
    one seeded batch; returns the losses, step walls, flash launches over
    the timed steps, captures, the final parameters on the host, the last
    aux loss and each MoE layer's routing.  With ``trained`` (another
    run's final parameters from the same seed), ``moved`` lists the gate
    and expert tensors whose initial values differ from those."""
    import torch

    from paddle_infer_tpu_torch.models import GPTMoEForCausalLM
    from paddle_infer_tpu_torch.observability import get_compile_log
    from paddle_infer_tpu_torch.optimizer import AdamW
    from paddle_infer_tpu_torch.parallel import FleetTrainStep

    log = get_compile_log()
    log.reset()
    model = GPTMoEForCausalLM(config, device=device, seed=seed)
    model.train()
    step = FleetTrainStep(model, _moe_lm_loss,
                          AdamW(learning_rate=MOE_TRAIN_LR,
                                weight_decay=0.01,
                                apply_decay_param_fun=no_decay),
                          strategy=_strategy(device, amp="O2"))
    moe_names = sorted(n for n in step.params if _is_moe_tensor(n))
    moved = None if trained is None else [
        n for n in moe_names if not torch.equal(
            step.params[n].detach(), trained[n].to(device))]
    rng = np.random.RandomState(seed)
    ids = torch.from_numpy(rng.randint(
        0, config.vocab_size, (batch, seq)).astype(np.int64)).to(device)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    with flash_calls() as calls, warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        for i in range(warmup + steps):
            if i == warmup:
                t0 = _flash_launches()
            t = time.perf_counter()
            losses.append(float(step(ids, ids)))
            ms.append((time.perf_counter() - t) * 1e3)
    launches = _flash_launches(t0)
    # autograd warns when a capture reuses a gradient accumulator that an
    # earlier step's graph (made on another stream) still holds
    stream_warnings = sorted({str(w.message)[:120] for w in seen
                              if "AccumulateGrad" in str(w.message)})
    aux = float(model.moe_aux_loss().detach())
    peak = torch.cuda.max_memory_allocated() / 1e9 \
        if device.type == "cuda" else 0.0
    out = {"losses": losses, "step_ms": ms,
           "step_ms_p50": float(np.median(ms[warmup:])),
           "launches": launches, "calls": sorted(calls),
           "captures": len(log.events("train-step")),
           "post_warm": log.summary()["post_warmup_compiles"],
           "aux": aux, "moved": moved, "moe_names": moe_names,
           "stream_warnings": stream_warnings,
           "peak_gb": peak, "n_params": sum(p.numel() for p in
                                            step.params.values())}
    step.release_graphs()
    out["final"] = {n: p.detach().to("cpu", copy=True)
                    for n, p in step.params.items()}
    out["routing"] = _moe_routing(model, ids)
    del step, model
    free_memory()
    return out


def _moe_routing(model, ids):
    """Each MoE layer's ``(routed, dropped)`` assignments on ``ids``: one
    more O2 forward without grad, each layer's input caught by a hook and
    routed as the layer routes it."""
    import torch

    from paddle_infer_tpu_torch import amp
    from paddle_infer_tpu_torch.parallel import moe as M

    seen = []

    def hook(layer, inputs):
        x = amp.cast(inputs[0], "fused_moe")
        xt = x.reshape(-1, x.shape[-1])
        gw = amp.cast(layer.gate_weight, "fused_moe")
        cap = M._capacity(xt.shape[0], layer.num_experts,
                          layer.capacity_factor, layer.top_k)
        r = M.route(M._gate_logits(xt, gw), layer.gate_kind, layer.top_k,
                    cap)
        seen.append((int(r.keep.sum()), int((~r.keep).sum())))

    layers = [m for m in model.modules() if isinstance(m, M.MoELayer)]
    handles = [m.register_forward_pre_hook(hook) for m in layers]
    try:
        with torch.no_grad(), amp.amp_scope(True, torch.bfloat16, "O2"):
            model(ids)
    finally:
        for h in handles:
            h.remove()
    return seen


def expert_tflops(device, config, batch, seq, reps=5):
    """The expert products of one layer at the step's shapes (bf16
    ``[E, C, d] x [E, d, f]`` and back, forward and backward) timed with
    CUDA events: ``(ms, TFLOP/s)``."""
    import torch

    from paddle_infer_tpu_torch.parallel import moe as M

    e, d, f = config.num_experts, config.hidden_size, \
        config.intermediate_size
    c = M._capacity(batch * seq, e, config.moe_capacity_factor,
                    config.moe_top_k)
    g = torch.Generator(device=device).manual_seed(0)
    mk = (lambda *s: (torch.randn(*s, generator=g, device=device) * 0.02)
          .to(torch.bfloat16).requires_grad_(True))
    x, w1, b1, w2, b2 = mk(e, c, d), mk(e, d, f), mk(e, f), mk(e, f, d), \
        mk(e, d)
    dy = torch.randn(e, c, d, generator=g, device=device).to(torch.bfloat16)

    def run():
        out = M._expert_ffn(x, w1, b1, w2, b2, "gelu")
        torch.autograd.grad(out, (x, w1, w2), dy)

    ms = time_ms(run, reps=reps, warmup=1)
    flops = 3 * 2 * 2 * e * c * d * f
    return ms, flops / (ms * 1e-3) / 1e12


def moe_train_phase(device, card, config=None, batch=MOE_TRAIN_BATCH,
                    seq=MOE_TRAIN_SEQ, warmup=MOE_TRAIN_WARMUP,
                    steps=MOE_TRAIN_STEPS, launches_per_step=None):
    """Phase 11.7, ``[moe_train]``: ``gpt-moe-6.7b-8e`` at
    ``MOE_TRAIN_LAYERS`` layers through ``FleetTrainStep`` on one CUDA
    graph, then the same seeds eager.  Raises unless the losses and every
    parameter of the graph run are EQUAL to eager's, there is one capture
    and none after warm-up, every expert and gate tensor moved, the aux
    loss is finite and above 0, the flash kernels ran in bf16, causal at
    head_dim 128, once per layer per step each, and autograd gave no
    warning that a step reused a gradient accumulator made on another
    stream."""
    import torch

    config = config or moe_config(MOE_TRAIN_LAYERS)
    if launches_per_step is None:
        launches_per_step = config.num_hidden_layers \
            if device.type == "cuda" else 0
    g = moe_train_run(device, config, batch, seq, warmup, steps)
    lap("moe_train graph")
    with eager():
        e = moe_train_run(device, config, batch, seq, warmup, steps,
                          trained=g["final"])
    lap("moe_train eager")
    equal_losses = g["losses"] == e["losses"]
    equal_params = all(torch.equal(g["final"][n], e["final"][n])
                       for n in g["final"])
    g["final"] = e["final"] = None
    per = _per_step(launches_per_step)
    ms_e, tflops = expert_tflops(device, config, batch, seq) \
        if device.type == "cuda" else (0.0, 0.0)
    routed = [r for r, _ in e["routing"]]
    dropped = [dr for _, dr in e["routing"]]
    print(f"[moe_train] gpt-moe-6.7b-8e x{config.num_hidden_layers} "
          f"({g['n_params'] / 1e9:.3f}B params) {batch}x{seq} O2 bf16 AdamW, "
          f"loss + {MOE_AUX_COEF} aux ({card}): step_ms_p50 graph="
          f"{g['step_ms_p50']:.2f} eager={e['step_ms_p50']:.2f} captures="
          f"{g['captures']} post_warmup={g['post_warm']} losses "
          + " ".join(f"{x:.4f}" for x in g["losses"])
          + f" losses_equal={equal_losses} params_equal={equal_params} "
          f"aux={g['aux']:.6f}/{e['aux']:.6f} moved={len(e['moved'])}/"
          f"{len(e['moe_names'])} routed={routed} dropped={dropped} "
          f"peak_gb graph={g['peak_gb']:.2f} eager={e['peak_gb']:.2f} "
          f"expert_products_ms={ms_e:.3f} expert_tflops={tflops:.1f} "
          f"flash {g['launches']} calls {g['calls']} AccumulateGrad "
          f"stream warnings {g['stream_warnings'] + e['stream_warnings']}",
          flush=True)
    if g["stream_warnings"] or e["stream_warnings"]:
        raise AssertionError(f"moe_train: autograd reused a gradient "
                             f"accumulator across streams: "
                             f"{g['stream_warnings'] + e['stream_warnings']}")
    if not (equal_losses and equal_params):
        raise AssertionError(f"moe_train: graph run differs from eager "
                             f"(losses {g['losses']} / {e['losses']}, "
                             f"params equal {equal_params})")
    if g["captures"] != 1 or g["post_warm"]:
        raise AssertionError(f"moe_train: {g['captures']} captures, "
                             f"{g['post_warm']} after warm-up")
    if e["moved"] != e["moe_names"] or not e["moe_names"]:
        raise AssertionError(
            "moe_train: expert / gate tensors that did not move: "
            f"{sorted(set(e['moe_names']) - set(e['moved']))}")
    for r in (g, e):
        if not (np.isfinite(r["aux"]) and r["aux"] > 0):
            raise AssertionError(f"moe_train: aux loss {r['aux']}")
        if not all(np.isfinite(r["losses"])):
            raise AssertionError(f"moe_train: losses {r['losses']}")
        _check_flash_launches("moe_train", r["launches"], steps, per)
    if device.type == "cuda":
        want = {(n, "bfloat16", config.hidden_size
                 // config.num_attention_heads, True)
                for n in ("flash_fwd", "flash_dkdv", "flash_dq")}
        for r in (g, e):
            if set(r["calls"]) != want:
                raise AssertionError(f"moe_train: flash calls {r['calls']}, "
                                     f"want {sorted(want)}")
    launches = {k: g["launches"][k] + e["launches"][k]
                for k in g["launches"]}
    return {"step_ms_p50": g["step_ms_p50"], "launches": launches,
            "tflops": tflops}


# ------------------------------------------------------------ mesh_train

MESH_BATCH, MESH_SEQ = 32, 512          # (a), (b), (c): ERNIE-3.0-base cell
MESH_WARMUP, MESH_STEPS, MESH_EAGER = 2, 10, 3
PIPE_LAYERS, PIPE_MICRO, PIPE_REPS = 12, 4, 1
SEP_SHAPE = dict(B=2, H=12, S=4096, D=64)
MOE_EP_WARMUP, MOE_EP_STEPS = 2, 5
O2_LOSS_TOL, O2_GRAD_TOL = 2e-2, 5e-2   # PERF.md §2's O2 limits
# the flash kernels at the shapes one mesh shard gives them, bf16: (a)'s
# dp=2 x mp=2 shard of ERNIE-3.0-base (16 rows, 6 heads, dropout 0.1),
# (d)'s Ulysses shard (6 of 12 heads over the whole 4096 sequence) and
# (e)'s attention (ep splits the experts only)
MESH_FLASH_SHAPES = {
    "mesh a": dict(B=16, H=6, Sq=512, Sk=512, D=64, causal=False, pad=51),
    "mesh d": dict(B=2, H=6, Sq=4096, Sk=4096, D=64, causal=True, pad=0),
    "mesh e": dict(B=8, H=32, Sq=1024, Sk=1024, D=128, causal=True, pad=0),
}
MESH_FLASH_RUNS = (("mesh a", "bf16", 0.1), ("mesh d", "bf16", 0.0),
                   ("mesh e", "bf16", 0.0))


def _ms(device, fn, reps):
    """A call's median time: CUDA events on the card (``time_ms``), the
    host's clock elsewhere (a CPU rehearsal)."""
    if device.type == "cuda":
        return time_ms(fn, reps=reps, warmup=1)
    fn()
    walls = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t) * 1e3)
    return float(np.median(walls))


def _mesh_init(device, n, amp=None, stage=None, **degrees):
    """``fleet.init`` over ``device`` repeated ``n`` times with the
    hybrid ``degrees``, AMP O2 bf16 with ``amp``, ZeRO ``stage``."""
    from paddle_infer_tpu_torch.parallel import DistributedStrategy, fleet

    st = DistributedStrategy()
    st.hybrid_configs = dict(st.hybrid_configs, **degrees)
    if amp:
        st.amp = True
        st.amp_configs = {"level": "O2", "dtype": "bfloat16"}
    if stage:
        st.sharding = True
        st.sharding_configs = {"stage": stage}
    fleet.init(strategy=st, devices=[device] * n)
    return st


def _grads_close(tag, want, got, ltol, gtol):
    """``(loss, grads)`` pairs: the loss within ``ltol`` relative, each
    gradient within ``gtol`` of its max-abs; prints the worst."""
    (lw, gw), (lg, gg) = want, got
    rel = abs(lg - lw) / abs(lw)
    worst = max((float((gg[n] - gw[n]).abs().max())
                 / max(float(gw[n].abs().max()), 1e-30), n) for n in gw)
    print(f"[{tag}] loss one-device={lw:.6f} mesh={lg:.6f} rel={rel:.3e} "
          f"(tol {ltol}); worst grad err over max-abs {worst[0]:.3e} "
          f"({worst[1]}, tol {gtol})", flush=True)
    if not (rel <= ltol and worst[0] <= gtol):
        raise AssertionError(f"{tag}: mesh step off the one-device step")


def _first_step(step, data, seed=11):
    """One step's loss and float32 gradients from seeded keys."""
    step.keys.seed(seed)
    loss = float(step(*data))
    return loss, {n: p.grad.float().clone() for n, p in step.params.items()}


def mesh_ernie(device, card, cfg=None, batch=MESH_BATCH, seq=MESH_SEQ,
               warmup=MESH_WARMUP, steps=MESH_STEPS, eager_steps=MESH_EAGER,
               launches_per_step=None):
    """(a) ERNIE-3.0-base pretraining at dp=2 x mp=2 on ``device``
    repeated, O2 bf16, AdamW, dropout 0.1: ``warmup`` + ``steps`` steps
    on the graph, then ``eager_steps`` eager steps from the same weights
    and keys, EQUAL to the graph run's first steps (losses and the
    parameters after them); one capture, none after warm-up; the flash
    kernels once per (dp, mp) shard a layer a step.  At dropout 0 the
    first step's loss and gradients within the O2 limits of the
    one-device step on the same weights and keys."""
    import torch

    from paddle_infer_tpu_torch.models.ernie import ErnieConfig
    from paddle_infer_tpu_torch.observability import get_compile_log

    cfg = cfg or ErnieConfig.from_preset("ernie-3.0-base")
    cuda = device.type == "cuda"
    L = cfg.num_hidden_layers
    shards = 4
    data = [torch.from_numpy(a).to(device)
            for a in pretrain_batch(cfg.vocab_size, batch, seq)]
    # parity at dropout 0: the one-device step against the mesh step
    cfg0 = ErnieConfig(**dict(vars(cfg), hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0))
    runs = []
    for n, deg in ((1, {}), (4, dict(dp_degree=2, mp_degree=2))):
        step = _pretrain_step(device, cfg0, _mesh_init(device, n, amp=True,
                                                       **deg), lr=0.0)
        with eager():
            runs.append(_first_step(step, data))
        del step
        free_memory()
    _grads_close("mesh_train a parity", runs[0], runs[1], O2_LOSS_TOL,
                 O2_GRAD_TOL)
    del runs
    free_memory()

    def run(n_steps):
        log = get_compile_log()
        log.reset()
        step = _pretrain_step(device, cfg, _mesh_init(
            device, 4, amp=True, dp_degree=2, mp_degree=2))
        step.keys.seed(3)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        losses, ms, kept, t0 = [], [], None, None
        for i in range(n_steps):
            if i == warmup:
                t0 = _flash_launches()
            t = time.perf_counter()
            losses.append(float(step(*data)))
            ms.append((time.perf_counter() - t) * 1e3)
            if i + 1 == eager_steps:
                kept = {n: p.detach().clone()
                        for n, p in step.params.items()}
        return {"losses": losses, "ms": ms, "kept": kept,
                "launches": _flash_launches(t0) if t0 else None,
                "captures": len(log.events("train-step")),
                "post_warm": log.summary()["post_warmup_compiles"],
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9
                if cuda else 0.0, "step": step}

    g = run(warmup + steps)
    prof = profile_train(g["step"], data, steps=2, tag="mesh a dp2 x mp2") \
        if cuda else {"idle_share": 0.0}
    g["step"].release_graphs()
    g["step"] = None
    free_memory()
    with eager():
        e = run(eager_steps)
    e["step"] = None
    free_memory()
    same_losses = g["losses"][:eager_steps] == e["losses"]
    same_params = all(torch.equal(g["kept"][n], e["kept"][n])
                      for n in e["kept"])
    per_step = {n: v / steps for n, v in g["launches"].items()}
    p50 = float(np.median(g["ms"][warmup:]))
    print(f"[mesh_train a] ernie-3.0-base dp=2 x mp=2 on one card "
          f"({card}) {batch}x{seq} O2 bf16 AdamW dropout 0.1: step_ms_p50="
          f"{p50:.2f} idle_share={prof['idle_share']:.3f} losses "
          + " ".join(f"{x:.4f}" for x in g["losses"])
          + f" graph_vs_eager losses_equal={same_losses} params_equal="
          f"{same_params} (first {eager_steps} steps) captures="
          f"{g['captures']} post_warmup={g['post_warm']} flash launches a "
          f"step {per_step} = {L} layers x {shards} shards "
          f"({ {n: v / shards for n, v in per_step.items()} } per shard) "
          f"peak_gb={g['peak_gb']:.2f}", flush=True)
    if not (same_losses and same_params):
        raise AssertionError("mesh_train a: graph run differs from eager")
    if g["captures"] != 1 or g["post_warm"]:
        raise AssertionError(f"mesh_train a: {g['captures']} captures, "
                             f"{g['post_warm']} after warm-up")
    if not all(np.isfinite(g["losses"])):
        raise AssertionError(f"mesh_train a: losses {g['losses']}")
    per = launches_per_step if launches_per_step is not None else (
        L * shards if cuda else 0)
    _check_flash_launches("mesh_train a", g["launches"], steps,
                          _per_step(per))
    return {"step_ms_p50": p50, "idle_share": prof["idle_share"],
            "launches": {n: v + (e["launches"] or {}).get(n, 0)
                         for n, v in g["launches"].items()}}


def _zero_expected(p, stage, size=2):
    """The reference's ZeRO rules for parameter ``p`` at ``stage`` over
    ``sharding=size``: ``(param, slot, gradient)`` specs.  A rank >= 2
    tensor whose dim 0 is free and divides puts dim 0 on ``sharding``:
    its slots at every stage, its gradient from stage 2, the parameter
    itself at stage 3."""
    d = tuple(getattr(p, "dist_attr", None) or ())
    d += (None,) * (p.dim() - len(d))
    on = (("sharding",) + d[1:] if p.dim() >= 2 and d[0] is None
          and p.shape[0] % size == 0 else d)
    return (on if stage == 3 else d), on, (on if stage >= 2 else d)


def mesh_zero(device, card, cfg=None, batch=MESH_BATCH, seq=MESH_SEQ):
    """(b) ZeRO stages 1-3 at dp=2 x sharding=2 against dp=2 alone:
    ERNIE-3.0-base at dropout 0, fp32, AdamW, one eager step each from
    the same weights and keys.  On the port a stage changes the recorded
    placement, not the arithmetic (the ``sharding`` ranks of a replica
    group share its rows), so the parameters after the step must EQUAL
    dp=2's, and every recorded parameter, slot and gradient spec must
    equal the reference's rule (``_zero_expected``).  Prints the counts
    on ``sharding``; returns each step's wall (ms) by stage, None for
    dp=2 alone."""
    import torch

    from paddle_infer_tpu_torch.models.ernie import ErnieConfig

    base = cfg or ErnieConfig.from_preset("ernie-3.0-base")
    cfg = ErnieConfig(**dict(vars(base), hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0))
    data = [torch.from_numpy(a).to(device)
            for a in pretrain_batch(cfg.vocab_size, batch, seq)]
    ref, walls = None, {}
    for stage in (None, 1, 2, 3):
        n = 2 if stage is None else 4
        deg = dict(dp_degree=2) if stage is None else dict(
            dp_degree=2, sharding_degree=2)
        step = _pretrain_step(device, cfg, _mesh_init(device, n, stage=stage,
                                                      **deg))
        step.keys.seed(5)
        with eager():
            t = time.perf_counter()
            float(step(*data))
            walls[stage] = ms = (time.perf_counter() - t) * 1e3
        params = {k: p.detach().clone() for k, p in step.params.items()}
        if stage is None:
            ref = params
        else:
            bad = [k for k in ref if not torch.equal(params[k], ref[k])]
            wrong = [k for k, p in step.params.items()
                     if (step.param_specs[k], step.grad_specs[k])
                     != _zero_expected(p, stage)[::2]
                     or {v for v in step.opt_specs[k].values() if v}
                     != {_zero_expected(p, stage)[1]}]
            w = "ernie.layers.0.mlp.fc1.weight"
            on = [sum("sharding" in v for v in specs) for specs in (
                step.param_specs.values(),
                [v for sl in step.opt_specs.values() for v in sl.values()],
                step.grad_specs.values())]
            print(f"[mesh_train b] stage {stage} dp=2 x sharding=2 ({card}) "
                  f"fp32 {batch}x{seq}, one eager step: {ms:.2f} ms (dp=2 "
                  f"alone {walls[None]:.2f}); params EQUAL dp=2 alone: "
                  f"{not bad}; recorded specs equal the reference's rules: "
                  f"{not wrong} (on sharding: params {on[0]}, slots "
                  f"{on[1]}, gradients {on[2]}); fc1.weight param/slots/"
                  f"grad {step.param_specs[w]} {step.opt_specs[w]} "
                  f"{step.grad_specs[w]}", flush=True)
            if bad or wrong:
                raise AssertionError(
                    f"mesh_train b: stage {stage} parameters off dp=2 alone "
                    f"{bad[:4]}, specs off the rules {wrong[:4]}")
        del step
        free_memory()
    return walls


def mesh_pipeline(device, card, layers=PIPE_LAYERS, micro=PIPE_MICRO,
                  batch=MESH_BATCH, seq=MESH_SEQ, hidden=768, heads=12,
                  ffn=3072, reps=PIPE_REPS):
    """(c) ``PipelineStack`` at pp=2: ``layers`` ERNIE-3.0-base blocks,
    ``micro`` micro-batches, fp32, against the same stack applied in
    sequence (the loss the output's product with a fixed random
    cotangent); loss and every gradient within 1e-4 of its max-abs, for
    interleave 1 and 2; prints each forward + backward's p50."""
    import torch

    from paddle_infer_tpu_torch.models.transformer_block import \
        ParallelTransformerLayer
    from paddle_infer_tpu_torch.parallel import (LayerDesc, PipelineStack,
                                                 topology)

    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(batch, seq, hidden, generator=g, device=device)
    # a fixed cotangent: a post-LN block's output is normalized, so the
    # mean of its squares would be a constant with no gradient
    co = torch.randn(batch, seq, hidden, generator=g, device=device)
    stack = PipelineStack(LayerDesc(
        ParallelTransformerLayer, hidden, heads, ffn, dropout=0.0,
        device=device), num_layers=layers, micro_batches=micro)
    stack.eval()

    def fwd_bwd():
        for p in stack.parameters():
            p.grad = None
        loss = (stack(x) * co).mean()
        loss.backward()
        return float(loss.detach()), {n: p.grad.clone()
                                      for n, p in stack.named_parameters()}

    seq_run = fwd_bwd()
    t_seq = _ms(device, fwd_bwd, reps)
    res = {}
    for il in (1, 2):
        stack.interleave = il
        topology.set_current_mesh(topology.create_hybrid_mesh(
            pp=2, devices=[device] * 2))
        try:
            pp_run = fwd_bwd()
            t_pp = _ms(device, fwd_bwd, reps)
        finally:
            topology.set_current_mesh(None)
        rel = abs(pp_run[0] - seq_run[0]) / abs(seq_run[0])
        worst = max(float((pp_run[1][n] - seq_run[1][n]).abs().max())
                    / max(float(seq_run[1][n].abs().max()), 1e-30)
                    for n in seq_run[1])
        print(f"[mesh_train c] pipeline pp=2 interleave={il} ({card}) "
              f"{layers} blocks {hidden}/{heads}/{ffn} fp32 {batch}x{seq}, "
              f"{micro} micro-batches: fwd+bwd ms p50 pipelined={t_pp:.2f} "
              f"sequential={t_seq:.2f}; loss rel err {rel:.3e}, worst grad "
              f"err over max-abs {worst:.3e} (tol 1e-4)", flush=True)
        if not (rel <= 1e-4 and worst <= 1e-4):
            raise AssertionError(f"mesh_train c: interleave {il} off the "
                                 "sequential stack")
        res[il] = t_pp
        del pp_run
    del stack, seq_run
    free_memory()
    return res


def mesh_sep(device, card, shape=SEP_SHAPE, reps=5):
    """(d) ring and Ulysses attention at sep=2, causal, bf16, forward
    and backward, against unsplit ``sdpa`` (the flash kernels) on the
    same inputs, within the bf16 limit; Ulysses launches each flash
    kernel once per shard."""
    import torch

    from paddle_infer_tpu_torch.ops.attention import sdpa
    from paddle_infer_tpu_torch.parallel import (ring_attention, topology,
                                                 ulysses_attention)

    B, H, S, D = shape["B"], shape["H"], shape["S"], shape["D"]
    g = torch.Generator(device=device).manual_seed(4)
    mk = lambda: (torch.randn(B, S, H, D, generator=g, device=device)
                  * 0.5).to(torch.bfloat16)
    q, k, v, do = mk(), mk(), mk(), mk()
    mesh = topology.create_hybrid_mesh(sep=2, devices=[device] * 2)

    def run(fn):
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*ts)
        out.backward(do)
        return [out.detach()] + [t.grad for t in ts]

    fns = {"unsplit": lambda a, b, c: sdpa(a, b, c, is_causal=True),
           "ring": lambda a, b, c: ring_attention(a, b, c, mesh=mesh,
                                                  is_causal=True),
           "ulysses": lambda a, b, c: ulysses_attention(a, b, c, mesh=mesh,
                                                        is_causal=True)}
    want = run(fns["unsplit"])
    res = {}
    for name in ("ring", "ulysses"):
        t0 = _flash_launches()
        got = run(fns[name])
        launches = _flash_launches(t0)
        err = max(float((a.float() - b.float()).abs().max())
                  / max(float(b.float().abs().max()), 1.0)
                  for a, b in zip(got, want))
        ms = _ms(device, lambda: run(fns[name]), reps)
        res[name] = ms
        res[f"{name} launches"] = launches
        print(f"[mesh_train d] {name} sep=2 ({card}) causal bf16 B={B} "
              f"H={H} S={S} D={D}: fwd+bwd ms={ms:.3f} (unsplit flash "
              f"{_ms(device, lambda: run(fns['unsplit']), reps):.3f}"
              f"); out/dq/dk/dv max err over max(max-abs, 1) {err:.3e} (tol "
              f"{TOL['bf16']}); flash launches {launches}", flush=True)
        if not err <= TOL["bf16"]:
            raise AssertionError(f"mesh_train d: {name} off unsplit sdpa")
        if name == "ulysses" and device.type == "cuda" and launches != {
                "flash_fwd": 2, "flash_dkdv": 2, "flash_dq": 2}:
            raise AssertionError(f"mesh_train d: ulysses launches "
                                 f"{launches}, want each once per shard")
    return res


def mesh_moe(device, card, config=None, batch=MOE_TRAIN_BATCH,
             seq=MOE_TRAIN_SEQ, warmup=MOE_EP_WARMUP, steps=MOE_EP_STEPS):
    """(e) ``gpt-moe-6.7b-8e`` at 1 layer, ep=2 on ``device`` repeated,
    O2 bf16 AdamW: the first step's loss and gradients within the O2
    limits of the ep=1 step on the same weights and keys, then
    ``warmup + steps`` graph steps (one capture, none after)."""
    import torch

    from paddle_infer_tpu_torch.models import GPTMoEForCausalLM
    from paddle_infer_tpu_torch.observability import get_compile_log
    from paddle_infer_tpu_torch.optimizer import AdamW
    from paddle_infer_tpu_torch.parallel import FleetTrainStep

    config = config or moe_config(MOE_TRAIN_LAYERS)
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, config.vocab_size, (batch, seq))
                           .astype(np.int64)).to(device)

    def build(ep, lr):
        model = GPTMoEForCausalLM(config, device=device, seed=0)
        model.train()
        st = _mesh_init(device, ep, amp=True, ep_degree=ep)
        return FleetTrainStep(model, _moe_lm_loss, AdamW(
            learning_rate=lr, weight_decay=0.01,
            apply_decay_param_fun=no_decay), strategy=st)

    firsts = []
    for ep in (1, 2):
        step = build(ep, 0.0)
        with eager():
            firsts.append(_first_step(step, (ids, ids)))
        del step
        free_memory()
    _grads_close("mesh_train e parity", firsts[0], firsts[1], O2_LOSS_TOL,
                 O2_GRAD_TOL)
    del firsts
    free_memory()
    log = get_compile_log()
    log.reset()
    step = build(2, MOE_TRAIN_LR)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for i in range(warmup + steps):
        t = time.perf_counter()
        losses.append(float(step(ids, ids)))
        ms.append((time.perf_counter() - t) * 1e3)
    routing = _moe_routing(step.model, ids)
    peak = torch.cuda.max_memory_allocated() / 1e9 \
        if device.type == "cuda" else 0.0
    caps = len(log.events("train-step"))
    post = log.summary()["post_warmup_compiles"]
    p50 = float(np.median(ms[warmup:]))
    print(f"[mesh_train e] gpt-moe-6.7b-8e x{config.num_hidden_layers} ep=2 "
          f"on one card ({card}) {batch}x{seq} O2 bf16 AdamW: step_ms_p50="
          f"{p50:.2f} losses " + " ".join(f"{x:.4f}" for x in losses)
          + f" routed={[r for r, _ in routing]} dropped="
          f"{[d for _, d in routing]} captures={caps} post_warmup={post} "
          f"peak_gb={peak:.2f}", flush=True)
    if caps != 1 or post or not all(np.isfinite(losses)):
        raise AssertionError(f"mesh_train e: captures {caps}, post {post}, "
                             f"losses {losses}")
    step.release_graphs()
    del step
    free_memory()
    return {"step_ms_p50": p50}


def mesh_train_phase(device, card):
    """Phase 11.8, ``[mesh_train]``: the flash kernels at the per-shard
    shapes against their plain versions, then (a) dp x mp, (b) ZeRO,
    (c) pp, (d) sep and (e) ep training, every mesh over ``device``
    repeated.  Returns the kernel records and the launches."""
    fres = flash_kernels_phase(device, shapes=MESH_FLASH_SHAPES,
                               runs=MESH_FLASH_RUNS,
                               timed_runs=MESH_FLASH_RUNS)
    lap("mesh_train kernels")
    t0 = _flash_launches()
    a = mesh_ernie(device, card)
    lap("mesh_train a")
    launches = {"mesh_train a": a["launches"]}
    mesh_zero(device, card)
    lap("mesh_train b")
    mesh_pipeline(device, card)
    lap("mesh_train c")
    t1 = _flash_launches()
    # (d)'s line counts one Ulysses forward and backward; its unsplit
    # reference and the timed repeats count nowhere
    launches["mesh_train d"] = mesh_sep(device, card)["ulysses launches"]
    d_all = _flash_launches(t1)
    lap("mesh_train d")
    t2 = _flash_launches()
    mesh_moe(device, card)
    launches["mesh_train e"] = _flash_launches(t2)
    lap("mesh_train e")
    launches["mesh_train other"] = {
        n: v - d_all[n] - sum(r[n] for t, r in launches.items()
                              if t != "mesh_train d")
        for n, v in _flash_launches(t0).items()}
    return {"kernels": fres, "launches": launches}


# ------------------------------------------------------------------ main

PHASES = ("kernels", "serve", "legacy", "sharded", "gpt", "moe", "train",
          "hapi", "moe_train", "mesh_train")
_RUN_T0 = [0.0]


def lap(tag):
    """Print the seconds since the run started, after a phase."""
    print(f"[time] {tag} done at {time.perf_counter() - _RUN_T0[0]:.1f}s",
          flush=True)


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else list(argv)
    unknown = [a for a in argv if a not in PHASES + ("card", "build")]
    if unknown:
        print(f"chip_smoke: unknown phases {unknown}; choose from card, "
              f"build, {', '.join(PHASES)} (default: all)", file=sys.stderr)
        return 2
    want = set(argv) & set(PHASES) if argv else set(PHASES)
    _RUN_T0[0] = time.perf_counter()
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
    kres = {name: {} for name in _build.KERNELS}
    by_run = {name: {} for name in _build.KERNELS}
    if "kernels" in want:
        kres.update(check_kernels(case))
        kres["ragged_paged_attention"].update({
            f"p/{kind}": rec for kind, rec in check_ragged(
                prefill_case(case), tag="p").items()})
        check_chunk_independence(device)
        lap("kernels")
    if want & {"serve", "legacy"}:
        t0 = time.perf_counter()
        model = build_llama(device)
        torch.cuda.synchronize()
        print(f"[serve] llama-7b built in {time.perf_counter() - t0:.1f}s: "
              f"hidden {model.config.hidden_size}, layers "
              f"{model.config.num_hidden_layers}, params "
              f"{sum(p.numel() for p in model.parameters()) / 1e9:.2f}B "
              "bf16", flush=True)
    stats = lora_http = None
    if "serve" in want:
        stats, lora_http = serve_phases(model, device, card, case, by_run)
        lap("serve (phases 4-9)")
    if "legacy" in want:
        # phase 9d: the legacy programs and the draft-model
        # SpeculativeEngine on the serve model (alone: after its own
        # ragged serve run)
        lres = legacy_phase(model, device, card, serve_st=stats)
        for name, recs in lres.pop("kernels").items():
            kres[name].update(recs)
        for tag in ("a", "a2", "eager", "b", "b cold", "c", "c2"):
            for name in ("paged_decode", "flash_fwd"):
                by_run[name][f"legacy {tag}"] = \
                    lres[tag]["launches"][name]
        del lres
        free_memory()
        lap("legacy (9d)")
    if "sharded" in want:
        # phase 9s: sharded serving on LLaMA-7B's widths at SHARD_LAYERS
        # layers (the run's time limit cut its depth), with its own
        # one-device serve run
        from paddle_infer_tpu_torch.models import LlamaConfig

        smodel = build_llama(device, config=LlamaConfig.from_preset(
            "llama-7b", num_hidden_layers=SHARD_LAYERS))
        sres = sharded_phase(smodel, device, card)
        del smodel
        for name, recs in sres.pop("kernels").items():
            kres[name].update(recs)
        for name in ("paged_decode", "ragged_paged_attention",
                     "paged_verify", "flash_fwd"):
            by_run[name].update({f"sharded {tag}": st["launches"][name]
                                 for tag, st in sres.items()
                                 if st["launches"][name]})
        del sres
        lap("sharded (9s)")
    if "serve" in want:
        serve_quant_phases(model, device, card, stats, lora_http, by_run)
        lap("serve (phases 9a-9c)")
    if want & {"serve", "legacy"}:
        del model
        free_memory()

    if "gpt" in want:
        # phase 10: GPT, with the LLaMA model freed first
        gst = gpt_phase(device, card=card)
        by_run["paged_verify"]["gpt"] = gst["launches"]["paged_verify"]
        by_run["ragged_paged_attention"]["gpt"] = \
            gst["launches"]["ragged_paged_attention"]
        del gst
        free_memory()
        lap("gpt (10)")
    if "moe" in want or "sharded" in want:
        # phase 10a: GPT-MoE (4 of gpt3-6.7b's layers, 8 experts), GPT
        # freed; the sharded phase's ep=2 run (d) on its model after (a)
        mres = moe_phase(device, card, ep_run=(
            (lambda m, st, prompts, max_new: sharded_ep_run(
                m, device, card, st, prompts, max_new))
            if "sharded" in want else None), only_serve="moe" not in want)
        for name in ("paged_decode", "ragged_paged_attention",
                     "paged_verify"):
            by_run[name].update({f"moe {tag}": st["launches"][name]
                                 for tag, st in mres.items()
                                 if st["launches"][name]})
        del mres
        free_memory()
        lap("moe (10a, with the sharded ep run)")

    if "train" in want:
        # phase 11: training, GPT freed first
        fres = flash_kernels_phase(device)
        hybrid_vs_flash(device)
        lap("flash kernels (11.1)")
        tst = train_pair(device, card)
        lap("train steps (11.2)")
        by_run["flash_fwd"]["train"] = tst["launches"]["flash_fwd"]
        for name in ("flash_dkdv", "flash_dq"):
            by_run[name]["train"] = tst["launches"][name]
        for name in ("flash_fwd", "flash_dkdv", "flash_dq"):
            kres[name]["bf16"] = dict(fres[("a", "bf16", 0.1)][name])
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
        lap("train (11)")
        # phase 11.5: the training recipe (fine-tuning with a schedule and
        # a clip, recompute, gradient merge, O1, the scaler loop in
        # float16, the other optimizers)
        for tag, got in recipe_phase(device, card).items():
            for name, n in got.items():
                by_run[name][tag] = n
        lap("train recipe (11.5)")
    if "hapi" in want:
        # phase 11.6: the high-level API over ERNIE fine-tuning, fed by
        # the DataLoader's worker processes (f32 flash kernels)
        hres = hapi_phase(device, card)
        for name, n in hres["launches"].items():
            by_run[name]["hapi"] = n
        del hres
        free_memory()
        lap("hapi (11.6)")
    if "moe_train" in want:
        # phase 11.7: GPT-MoE training through FleetTrainStep, graph and
        # eager (bf16 flash kernels, causal at head_dim 128)
        mtres = moe_train_phase(device, card)
        for name, n in mtres["launches"].items():
            by_run[name]["moe_train"] = n
        del mtres
        free_memory()
        lap("moe_train (11.7)")
    if "mesh_train" in want:
        # phase 11.8: hybrid-parallel training on meshes over the card
        # repeated (dp x mp, ZeRO, pp, sep, ep), the flash kernels held
        # to their plain versions at the per-shard shapes first
        xres = mesh_train_phase(device, card)
        for (tag, kind, p), rec in xres["kernels"].items():
            for name, r in rec.items():
                kres[name][f"{tag}/{kind}/dropout{p}"] = r
        for tag, got in xres["launches"].items():
            for name, n in got.items():
                by_run[name][tag] = n
        del xres
        free_memory()
        lap("mesh_train (11.8)")

    # phase 12: the kernels line, the card line, the result line
    launches = {name: sum(runs.values()) for name, runs in by_run.items()}
    if "kernels" in want and "train" in want:
        print_kernels_line(kres, launches, by_run)
    else:
        print(f"[kernels] line left out: phases {sorted(want)} ran, the "
              f"line needs kernels and train; launches {launches}",
              flush=True)
    print(f"[card] {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def print_kernels_line(kres, launches, by_run):
    """The kernels line: each kernel's bf16 record from the kernels and
    train phases, its launches over every run that drove the port (by
    run beside them) and every record it has (per-shard shapes too)."""
    from paddle_infer_tpu_torch.ops import _build

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
            "launches_by_run": by_run[name]})
    print(json.dumps({"kernels": line}), flush=True)


def serve_phases(model, device, card, case, by_run):
    """Phases 4 to 9 on the serve model: serve, spec, prefix, resilience,
    int8, kv_tier, structured, http, sched, fleet and generate; the
    paged kernels' launches by run into ``by_run``.  Returns the serve
    run and the generate phase's counts."""
    import torch

    from paddle_infer_tpu_torch.ops import _build
    from paddle_infer_tpu_torch.ops import ragged_paged_attention as RPA

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
    lap("serve (4)")

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
    by_run["paged_verify"].update({f"llama {t}": runs[t]["launches"][
        "paged_verify"] for t in ("b", "c")})
    lap("spec (5)")
    for name in ("paged_decode", "ragged_paged_attention"):
        by_run[name]["serve"] = launches[name]

    # phase 6: the prefix cache, warm against cold, on bf16 pools
    pruns = prefix_phase(model, device, card)
    lap("prefix (6)")
    # phase 7: replay through faults under the supervisor
    rres = resilience_phase(model, device, card)
    lap("resilience (7)")
    # phase 8: int8 pools (serve, reference, prefix, speculation, the
    # writer alone, a profile)
    iruns = int8_phase(model, device, card, stats)
    lap("int8 (8)")
    for name in ("paged_decode", "ragged_paged_attention"):
        by_run[name].update({
            "prefix warm": pruns["warm"]["launches"][name],
            "resilience clean": rres["clean"]["launches"][name],
            "resilience faulted": rres["faulted"]["launches"][name],
            "int8 serve": iruns["serve"]["launches"][name],
            "int8 prefix warm": iruns["prefix"]["warm"]["launches"][name]})
    by_run["paged_verify"]["int8 spec"] = \
        iruns["spec"]["launches"]["paged_verify"]

    # phase 8a: the host KV tier (parks, supervised allocation faults,
    # demote / promote, swap faults); phase 8b: constrained decoding
    tres = kv_tier_phase(model, device, card, stats, iruns["serve"],
                         pruns["cold"])
    lap("kv_tier (8a)")
    gres = structured_phase(model, device, card, stats)
    lap("structured (8b)")
    for name in ("paged_decode", "ragged_paged_attention"):
        by_run[name].update({tag: st["launches"][name]
                             for tag, st in tres.items()})
        by_run[name].update({f"structured {k}": st["launches"][name]
                             for k, st in gres.items()})
    by_run["paged_verify"]["structured spec"] = \
        gres["b"]["launches"]["paged_verify"]

    # phase 8c: the HTTP front end over a save_pretrained directory, in
    # its own process; phase 8d: the SLO scheduler under a replayed trace
    hres = http_phase(model, device, card)
    lap("http (8c)")
    sres = sched_phase(model, device, card)
    lap("sched (8d)")
    # phase 8e: the disaggregated fleet (two replicas, one model)
    fleet = fleet_phase(model, device, card, stats, pruns["cold"]["streams"],
                        server=hres["fleet"])
    lap("fleet (8e)")
    for name in ("paged_decode", "ragged_paged_attention"):
        by_run[name].update({
            "http (server process)": hres["launches"][name],
            "http fleet (server process)": hres["fleet"]["launches"][name],
            **{f"sched {run}": sres[run]["launches"][name]
               for run, _, _ in SCHED_RUNS},
            **{f"fleet {run}": st["launches"][name]
               for run, st in fleet.items()}})

    # phase 9: the engines' own entry points on the same model
    gen = generate_phase(model, device, card)
    by_run["paged_decode"]["generate"] = gen["decode"]
    by_run["flash_fwd"]["generate"] = gen["flash"]
    return stats, hres["lora"]


def serve_quant_phases(model, device, card, stats, lora_http, by_run):
    """Phases 9a to 9c (weight-only, int8 activations, adapters; the
    last converts the serve model in place); launches into ``by_run``."""

    # phase 9a: weight-only LLaMA-7B (int8, int4) against its
    # dequantized twin, and the adapter server's stream in process;
    # phase 9b: int8 activations; phase 9c: multi-LoRA on the serve
    # model, which it converts in place (nothing after uses it)
    wres = weight_only_phase(device, card, stats, lora_http)
    lap("weight_only (9a)")
    ares = int8_act_phase(model, device, card, stats)
    lap("int8 act (9b)")
    lres = adapters_phase(model, device, card, stats)
    quant_runs = {f"weight_only {a} {k}": wres[a][k]
                  for a in ("int8", "int4") for k in ("run", "twin")}
    quant_runs["int8 act"] = ares["run"]
    quant_runs.update({f"adapters {k}": v for k, v in lres.items()
                       if isinstance(v, dict) and "launches" in v})
    for name in ("paged_decode", "ragged_paged_attention", "paged_verify"):
        by_run.setdefault(name, {}).update({
            tag: st["launches"][name] for tag, st in quant_runs.items()
            if st["launches"][name]})


if __name__ == "__main__":
    sys.exit(main())
