"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card (it exits
non-zero, printing no result, without one).  All five CUDA sources are
built first, in parallel (one ``nvcc`` each, into ``.torch_ext/``).  The
kernels and the TPU kernels they replace (``REPLACES``, ``VMM_REPLACES``,
``FLASH_REPLACES``, ``DENSE_REPLACES``, ``EXACT_REPLACES``):

    paged_decode.cu     src/repro/kernels/decode_attention/paged_kernel.py:150
    paged_exact.cu      src/repro/kernels/decode_attention/paged_kernel.py:116
    mxfp4_vmm.cu        src/repro/kernels/mxfp4_vmm/kernel.py:80
    flash_attention.cu  src/repro/kernels/flash_attention/kernel.py:74
    dense_decode.cu     src/repro/kernels/decode_attention/kernel.py:67

``--only kernel_exact,check`` (any of the kernel phases, quantize,
deployment, dryrun, check, check_mla, check_moe, check_window, check_state; serve and
serve_spec_draft on a llama3-8b built first; serve_phi3,
serve_phi3_static, serve_phi3_quantized and serve_phi3_spec on a
phi3-mini-3.8b built first; serve_danube, serve_danube_static and
serve_danube_quantized on an h2o-danube-1.8b built first;
serve_mamba2 and serve_mamba2_static on a mamba2-370m built first;
serve_hymba, serve_hymba_static and serve_hymba_quantized on a
hymba-1.5b built first; serve_mla,
serve_mla_static, serve_mla_quantized and serve_mla_spec on a
deepseek-v2-lite-16b built first; serve_moe, serve_moe_static,
serve_moe_quantized and serve_moe_spec on a llama4-scout built first;
serve_moe_maverick on a llama4-maverick built first; serve_tp on a
llama3-8b built first, with its own tp=1 sessions; serve_disagg on a
llama3-8b built first, after the two colocated phases it is compared
with; serve_vlm on an internvl2-26b built first; serve_cli,
train_hubert, train, train_cli, train_tp, serve_static_tp,
serve_disagg_tp and examples, which build their own models; sim
last, over the serve
phases of that run) builds and runs just those phases and prints no
result line: for quick checks of one kernel or path.

Phases, each of which fails the run if it fails:

1. kernel — hold the paged decode kernel against its plain PyTorch version
   on the card at llama3-8b decode shapes (H 32, KVH 8, D 128, page 16;
   bf16 and f32 pools; B 1 and 8; ragged positions up to 4096, dead pages
   on a poisoned scratch page, a sliding window), and its tensor-core
   variant also at D 64, rep 5, rep 8 and page 32 (``TC_GEOMS``; bf16 each
   output within one bf16 ulp of its magnitude plus 1e-4, f32 1e-5).  Then
   time kernel, plain version, ``F.scaled_dot_product_attention`` on the
   gathered view (with ``enable_gqa`` and on K/V repeated to H heads; the
   faster is ``library_ms``, a yardstick the port never calls) and a plain
   read of the same K/V bytes (``stream_read_ms``) at B 8 with 1024 and
   4096 context, with CUDA events and the L2 cache flushed between
   launches.
2. kernel_scaled — the same kernel over fp8 and int8 code pools with f32
   per-token scale pools (poisoned scratch page and scales, a window; the
   ``TC_GEOMS`` too), held against its plain version (bf16 q: one bf16
   ulp + 1e-4 per element; f32 q: 1e-5) and timed at B 8, ctx 1024 and
   4096 beside SDPA on the dequantized bf16 view and a plain read of the
   codes and scales.
3. kernel_mxfp4 — the MXFP4 VMM kernel against its plain version (f32
   output within 1e-5 of max |out|; bf16 output == the f32 output rounded)
   at the four llama3-8b projection shapes for M 1, 8, 16, 64, 256 and
   2048 (both schedules: ``decode`` up to M 16, ``wgmma`` above; M 8 and
   16 also forced onto ``wgmma``), the serve path's grouped launches (q/k/v
   and gate/up, M 8 and 256), ragged M and N (the byte-copy path, single
   and grouped), E8M0 scales >= 128, and llama3-70b's four projection
   shapes (K 8192 to N 8192, 1024, 28672; K 28672 to N 8192) at M 8 and
   256, and deepseek-v2-lite-16b's four launches (wq K 2048 -> N 3072, wo
   2048 -> 2048, the dense layer's gate/up grouped 2048 -> 2 x 10944, a
   ragged N on the byte-copy path, and w_down 10944 -> 2048) at the M its
   serve path gives them: 8 (a decode step) and 256, 512, 1024 and 2048
   (prefill chunk calls of 1, 2, 4 and 8 rows).  Each shape is timed
   beside its bound, a plain read of its bytes (``stream_read_ms``) and
   ``torch.matmul`` of x with the pre-dequantized bf16 weight (a different
   function: it streams 3.76x the bytes); both schedules are timed at M 8
   and 16 (the crossover); the headline is one llama3-8b layer at M 8 in
   the serve path's four launches, and the same layer at M 256 is printed
   beside the seven ``torch.matmul`` calls.
4. kernel_flash — the flash-attention kernel against its plain version at
   llama3-8b prefill geometry (H 32, KVH 8, D 128): B 1 and 8 at
   Sq = Skv = 1024, a ragged S 1000, an MHA (rep 1) case, a D 64 case
   (H 16, KVH 4, S 1000), a rep 5 case (H 40, KVH 8, S 1000: the
   14B models' heads) and a rep 8 case (H 64, KVH 8: llama3-70b's heads),
   causal and not, bf16 and f32 (bf16: each output
   row, one query in one head, within 2^-6 of its largest value, the worst
   row's share of that printed; f32: 1e-5).  Timed at B 8 and B 1
   (causal) and B 8 (not) beside
   its bound and ``F.scaled_dot_product_attention(is_causal=...,
   enable_gqa=True)`` (a yardstick the port never calls).
5. kernel_dense_decode — the dense-cache decode kernel against its plain
   version: B 1 and 8, caches of 2048 and 4096 tokens, ragged cur_len (one
   full, one of a single token), the legacy speculative engine's B 1 step
   (cur_len 288 of 512), a D 64 case (H 16, KVH 4, B 8) and
   llama4-scout's heads (H 40, KVH 8: rep 5, B 8, S 2048), the tail past
   cur_len poisoned with +-1e4, bf16 and f32 (bf16: each output within
   2^-7 of its magnitude plus 1e-4; f32: 1e-5).  Timed at B 8 with cur_len
   1088 of 2048 (the static serve's last step; also at rep 5) and 4096
   of 4096, and at B 1 with 288 of 512, beside its bound, SDPA on the
   cache sliced to
   cur_len, and a plain contiguous read of the same K/V bytes
   (``stream_read_ms``, a torch sum: the card's practical read rate under
   this timer).  Every timing line of the kernel phases carries
   ``kernel_over_library`` (its time over SDPA's, where there is one) and
   ``bound_over_kernel`` (its share of the roofline).
6b. kernel_headdims — every attention kernel at phi3-mini's head dim 96
   (full MHA, rep 1) and h2o-danube's 80 (rep 4), bf16 and f32 (and for
   the paged kernels fp8 and int8 pools; the exact one at C 1 and 5 with
   its bitwise invariance), and the flash kernel's sliding window (windows
   of 1 to 1000 keys, causal and not, the mma.sync variant too), with the
   tolerances above, the paged kernels also over a ring table whose blocks
   behind the window are the poisoned scratch page; then each timed at
   the two models' serve shapes beside its bound, its plain version and
   SDPA (with an explicit window mask for the windowed flash), and
   ``mxfp4_vmm`` held and timed at their projections (M 8 and 2048).
   Returns one kernels-line entry per variant.
6c. kernel_hymba — the kernels on hymba-1.5b's path at its shapes (D 64,
   25 query heads over 5: rep 5): flash with its 1024-token window and
   without (its global layers), dense decode over a wrapped 1024-entry
   ring and a ragged 3200-entry cache, the paged online kernel over bf16
   and f32 pools with and without a ring table, bf16 and f32, at the
   tolerances of kernel_headdims; ``mxfp4_vmm`` at its four launches
   (q/k/v grouped at K 1600, which is not a whole number of the decode
   schedule's 128-row K stages; gate/up to 5504; down from 5504) for M 1,
   8 and 2048.  Each timed at hymba's serve shapes beside its bound, its
   plain version and the library call; one kernels-line entry each.
6d. kernel_flash_mla — the flash kernel at MLA's head dims (D 192 of q/k,
   Dv 128 of v; deepseek-v2-lite): every variant (wgmma and mma.sync in
   bf16, the second forced with ``kind="mma"``; fma in f32) against the
   plain version at deepseek's static prefill (B 8, S 1024, H = KVH = 16,
   causal and not), a ragged S 1000, GQA 4:1 and rep 136, at the flash
   tolerances; timed at B 8, S 1024, causal beside its bound, the plain
   version and SDPA under each backend (the fastest that takes Dv != D is
   ``library_ms``).  Its kernels-line entry takes its launches from
   serve_mla_static.
6e. kernel_frontends — flash at hubert's shape (B 4, S 1500, H = KVH =
   16, D 80, non-causal; causal too) and at internvl2's prefill (B 4, S
   1024, H 48, KVH 8: rep 6, causal; a ragged non-causal S 1000), the
   dense decode at internvl2's (B 8, 1088 of 2048, rep 6; ragged
   cur_len), bf16 and f32, against the plain versions (``KernelHolds``);
   each timed beside its bound, the plain version and SDPA.
6. kernel_exact — the exact-accumulator paged kernel (the speculative
   verify step's attention) against its plain multi-query version: B 1 and
   8, C 1 and 5 queries per slot, ragged starts up to 4096 with one row at
   0, bf16, f32, fp8 and int8 pools (code pools also with an f32 q), a
   sliding window, the ``TC_GEOMS``; dead table entries on a poisoned
   scratch page and every
   pool position after a row's last query filled with +-1e4 (bf16 output
   within one bf16 ulp + 1e-4 per element, f32 1e-5).  Its contract, bit
   for bit: query j of a C-query launch equals a one-query launch at
   start + j, and a row of a batch equals the row launched alone with a
   wider page table.  Timed at B 8, C 5, context 1024 and 4096 beside its
   bound, its plain version, ``F.scaled_dot_product_attention`` with
   the per-row causal mask (``enable_gqa=True``, a yardstick the port never
   calls) and a plain read of each slot's live K/V bytes.  Every kernel
   phase prints which variant (``tensor_core`` or ``cuda_core``,
   ``paged_kernel.variant``) each case ran.
7. quantize — the port's ``quantize_mxfp4`` and ``kv_quantize`` give the
   same bits on the card as on the CPU for one llama3-8b projection.
8. deployment — ``DeploymentSpec(sku="h100")`` and ``sku="rpu-cu"`` (one
   RPU compute unit over the default HBM-CO candidate) resolved for
   llama3-8b in bf16, and llama3-8b, llama3-70b and llama3-405b with mxfp4
   weights and fp8 KV, from ``meta``-device models (no weights allocated:
   checked): each budget printed beside ``torch.cuda.mem_get_info()``'s
   total; llama3-405b must raise ``DeploymentError`` on one H100.
   deepseek-v2-lite-16b on h100 with bf16 and with mxfp4 weights must
   resolve, and with an fp8 cache must raise ``DeploymentError``.
9. serve — llama3-8b at full width, its depth cut to ``LLAMA_LAYERS``
   (8 of 32: the earlier models' depths are cut so that the whole run,
   stateful models at full depth included, stays near 600 s; random bf16
   weights from a seeded generator, ~5.6 GB) behind
   ``LLMEngine(backend="continuous")`` answers 8 requests (prompts of 128-1024 tokens, two sharing a 512-token
   prefix, 4 greedy and 4 sampled, 64 new tokens each).  Every request must
   finish, the prefix index must be hit, the decode kernel must have run
   once per layer per decode step (bf16 and fp8: its tensor-core variant,
   ``kernels.VARIANT_LAUNCHES``), and a second identical session must
   reproduce every stream, greedy and sampled.  Eight decode-only steps of
   that second session are traced with ``torch.profiler``: device busy
   time per step, the device's idle share, time by kernel, and the host
   ops that take most host time.  Then prompt scoring (``serve_scoring``):
   the 1024-token prompt alone, in a session unscored and in one with
   ``prompt_logprobs``; the scored first token must equal the unscored
   one, the scores agree with ``Model.forward``'s on the card within
   ``SCORE_REL_TOL`` of each position's largest |logit|, and the scored
   chunk calls are timed beside the unscored ones.  Then the prompt twice
   in one batch, one copy scored (``mixed_batch_scoring``): equal first
   tokens, no scores on the unscored copy, the scored copy's within the
   same limit.
10. serve_static — the same model behind ``LLMEngine(backend="static",
   max_len=2048)`` answers 8 prompts of 1024 tokens (4 greedy, 4 sampled,
   64 new tokens each); every request finishes, the flash kernel runs once
   per layer (one prefill call) and the dense decode kernel once per layer
   per decode step (63), and a second identical call reproduces every
   stream.  A call with ``prompt_logprobs`` (two prompts, 4 new tokens)
   must launch the flash kernel twice per layer (prefill and
   ``Model.forward``) and give finite
   scores <= 0.  Reports tokens/s, prefill s, decode step ms and peak GB,
   and the device time of ``STATIC_PROFILE_STEPS`` (4) decode steps (a
   profiled 5-token call minus a 1-token one): busy ms per step, idle
   share, time by kernel.
11. serve_quantized — the continuous serve with ``weight_format="mxfp4"``
   and ``cache_dtype="fp8"``: the same checks as serve, and the MXFP4
   kernel must have run 4 x layers x (decode steps + prefill chunk calls)
   times (q/k/v and gate/up grouped; the decode schedule on decode steps,
   wgmma on prefill calls, ``kernels.VARIANT_LAUNCHES``) and the
   scale-pool decode kernel once per layer per decode step.  Each distinct
   (M, K, Ns) the session gave the MXFP4 kernel is then held against the
   plain version as in kernel_mxfp4, on the activations and weights of its
   first launch (``vmm_calls``; those launches are not counted).
11b. serve_disagg — the serve phase's requests behind
   ``LLMEngine(disaggregate=True)``: a prefill-phase and a decode-phase
   engine on the one card, joined by the KV-page handoff (host staging),
   in bf16 and then with mxfp4 weights over fp8 pools, each beside the
   colocated phase of the same options (serve, serve_quantized).  Every
   request is handed off (the later 512-token sharer through a
   decode-side prefix hit), the handoff's bytes equal its pages times a
   page of every leaf, the paged decode kernel (and ``mxfp4_vmm``)
   launch as serve's checks say, and every greedy stream equals the
   colocated one or parts at a near-tie.  Then untraced sessions of a
   colocated engine and the disaggregated one, A B B A (a trace slows the
   host for the sessions after it).  Reports TTFT p50, the decode step's
   wall, busy and idle share (8 traced decode-only steps), tokens/s, and
   the handoff's pages, bytes and ms, beside colocated's.
12. serve_spec — the serve phase's requests behind
   ``LLMEngine(backend="continuous", speculative=SpeculativeConfig(
   gamma=4))``, a self-draft: every request finishes, a second session
   reproduces every stream (greedy and sampled), the exact kernel runs once
   per layer a window (the verify step) and the paged decode kernel 5 times
   per layer (four draft steps and the backfill), both as tensor-core
   variants; then
   a short session over fp8 pools (4 requests, 32 new tokens) with the
   same launch checks on the scale-pool kernels reports its accepted
   proposals per window.  Reports tokens/s, ms and tokens
   per window, accepted proposals per window, the host's waits per window
   and, over 8 traced decode-only windows, device busy time and idle share;
   and, as a reading, how far each greedy stream agrees with the serve
   phase's (the exact and online kernels round apart, so a bf16 near-tie
   may flip).  Then ``LLMEngine(backend="speculative")`` with the model as
   its own draft, one greedy 256-token prompt, 32 new tokens: the dense
   decode kernel must run per layer 2 (gamma + 1) x the windows the engine
   counts (draft steps with the backfill, and target steps) and the flash
   kernel twice per layer (the two prompt prefills), and a
   second call reproduces the stream (phase serve_spec_legacy).
12b. serve_tp — tensor-parallel serving: two ranks (spawned processes)
   share ``cuda:0`` over a gloo group (NCCL refuses two ranks on one
   device) as a (1, 2) ``DeviceMesh``; gloo takes the CUDA tensors of
   its all-gathers and all-reduces itself (counted as ``gloo_cuda``), and
   the ring matmuls' hops stage through pinned host memory, counted.
   llama3-8b at ``TP_LLAMA_LAYERS`` (4) layers, full width, serves the
   llama mix in gather, psum, MXFP4 + fp8 gather and MXFP4 + fp8 psum
   modes (psum dequantizes its row-sharded MXFP4 shards), then
   deepseek-v2-lite-16b at ``TP_DEEPSEEK_LAYERS`` (2: MLA, then MLA +
   MoE) in gather mode (MLA heads 16 -> 8, latent pools and experts
   replicated).  Per rank: the paged decode launches equal layers
   x decode steps at local heads (16 query / 4 KV for llama), every
   distinct ``mxfp4_vmm`` launch (N/2, and full K in the closing weights)
   held at 1e-5 on the path's own activations, the collective bytes of a
   decode-only step equal ``psum_bytes_per_step``, the pools' bytes a
   token half of tp=1's (llama), the decode step's wall and device-busy
   time.  Against tp=1 sessions of the same knobs on the card: the first
   decode step's logits within ``SCORE_REL_TOL`` of their largest, and
   the greedy streams under the near-tie rule; deepseek's (MoE: a decode
   batch gives each expert one token, so its rows couple) may also part
   at or after the session's first divergence, a routing flip that must
   itself be a near tie or a request whose sampled stream parted
   (``RouteLog``, ``tp_moe_divergence``).
   Then the two ring matmuls on the group (x (8, 4096) . W (4096, 14336),
   x (8, 14336) . W (14336, 4096), bf16) against ``torch.matmul`` in f32
   (``RING_REL_TOL``), and which collectives gloo takes on CUDA tensors
   directly.  Launches per rank come back through the spawn's queue; the
   kernels line sums them (``launches_serve_tp``).  No reading is a
   tensor-parallel speed: two processes share one card.
12c. serve_disagg_tp — disaggregated serving across rank groups: three
   ranks (spawned processes) share ``cuda:0`` over gloo as a (1, 3) mesh
   that ``split_mesh`` cuts 1:2, the prefill engine tp 1 on rank 0 and
   the decode engine tp 2 on ranks 1-2, each rank mirroring the other
   phase's schedule and the KV pages handed off by head, each decode rank
   receiving the half its heads hold.  llama3-8b at ``TP_LLAMA_LAYERS``
   layers serves the serve phase's mix over bf16 pools, then fp8 pools,
   beside one-card colocated and disaggregated sessions of the same
   options run first.  Holds: every request finishes, the same on every
   rank; every chain is handed off, its chains, pages and bytes (summed
   over the decode ranks, each receiving half) the one-card session's;
   the paged decode kernel once a layer a decode step on each decode
   rank (tensor-core variant); greedy streams equal the one-card
   colocated ones or part at a near tie (``tp_near_ties``).  Reports TTFT
   p50, the decode step's wall, busy and idle share on a decode rank, and
   the handoff's pages, bytes, ms a transfer and GB/s.  The kernels line
   sums the decode ranks' launches (``launches_serve_disagg_tp``).
13. serve_spec_draft — speculation with a cheap draft: the draft is the
   model's first 2 of its 8 layers (``runtime/spec_pair.build_pair``: shared
   tensors; the deeper ``wo``/``w_down`` damped by 0.005 in place, so this
   runs last on the model).  Plain and speculative (gamma 4) engines, both
   sized by ``DeploymentSpec(sku="h100", max_len=512, page_size=16,
   max_slots=8)``, serve 8 greedy requests (256-token prompts, 64 new)
   twice each, in turns and before any trace,
   the faster rep kept: tokens/s and the speedup; accepted per
   window against the model at the measured per-token acceptance; the
   median window and step against ``spec_window_seconds`` and
   ``step_seconds``, and the device busy time of 8 traced ones; the pools'
   bytes (``memory_allocated`` growth at set-up, the pool leaves) against
   ``pool_bytes_per_device`` (the leaves less the scratch page must equal
   it).  The paged kernel must launch once per layer per plain step and
   once per draft layer per draft or backfill step, the exact kernel once
   per target layer per window; greedy speculative streams must equal the
   plain ones or part where the plain stream's top-2 gap is at most
   ``NEAR_TIE_BF16_ULPS`` bf16 ulps of the top logit.
13b. serve_phi3, serve_phi3_static, serve_phi3_quantized, serve_phi3_spec
   — after llama3-8b is freed, phi3-mini-3.8b at full width and
   ``PHI3_LAYERS`` (8) of its 32 layers (full MHA at head dim 96; 2.2 GB
   of random bf16 weights; all 32 until the stateful phases joined): the serve,
   serve_static and serve_quantized phases' mixes and checks (continuous
   bf16 with a scored prompt; static 8 x 1024; mxfp4 + fp8 KV), and
   self-draft ``speculative=`` and the legacy backend as serve_mla_spec.
13c. serve_danube, serve_danube_static, serve_danube_quantized — after
   phi3 is freed, h2o-danube-1.8b at full width and ``DANUBE_LAYERS`` (6)
   of its 24 layers (GQA 32 over 8 at head dim 80, every layer a
   4096-token window; 1.2 GB): continuous
   bf16 over ring pages (``DANUBE_MIX``: 2 prompts of 6144 tokens, 2 of
   4000 with 256 new, which cross the window while decoding, 4 of 512;
   page 16, chunk 256), the ring's pool, its most live blocks a slot
   (within ``ring_blocks_cap``), its pages in use against what the mix
   would hold without a ring, and the pages reclaimed printed, every page
   back at the end, a 6144-token prompt scored against ``Model.forward``
   (windowed flash) at every position; static 2 x 6144 (windowed flash
   prefill, dense decode over the wrapped 4096-entry ring); mxfp4 + fp8
   KV on the mix's first 4 requests.
13d. serve_mamba2, serve_mamba2_static — after danube is freed,
   mamba2-370m at full width and ``MAMBA2_LAYERS`` (24) of its 48 layers
   of the Mamba2 SSD mixer (all 48 until the dryrun phase, which runs
   the full depth, joined; d_model 1024, state 128): continuous bf16 on
   the serve phase's mix (no prefix hit: a pure-state model has no full
   space; its per-slot state pools, 25.5 MB a slot at 24 layers, held
   against ``state_bytes_per_slot``;
   a scored prompt against ``Model.forward``) and static 8 x 1024.  The
   reference computes the mixer in plain jnp, so no kernel may launch;
   the traced steps split device time by the ``ssm_mixer`` range.
13e. serve_hymba, serve_hymba_static, serve_hymba_quantized — after
   mamba2 is freed, hymba-1.5b at full width and ``HYMBA_LAYERS`` (8) of
   its 32 layers (32 until the training phases joined, 16 until the
   dryrun phase did; GQA attention, 25 heads over 5 at D 64, beside a
   Mamba2 mixer of 50 heads, state 16; global at layers 0 and 7, a
   1024-token window elsewhere):
   continuous bf16 on ``HYMBA_MIX`` (2 prompts of 3072 tokens and 2 of
   1500 with 256 new, past the window, whose rings wrap while decoding; 4
   of 512 with 64 new, two sharing a 384-token prefix; page 16, chunk
   256): the
   windowed layers' ring (``RingWatch``), the prefix pages shared while
   the prompt is recomputed (``recompute_shared``: no prompt token
   skipped), the state pools, a 3072-token scored prompt; static 2 x
   3072; the continuous mix with mxfp4 attention and MLP projections over
   bf16 pools (4 ``mxfp4_vmm`` launches a layer a call).
14. serve_mla — after ``del`` of hymba, deepseek-v2-lite-16b at full
   width and ``DEEPSEEK_LAYERS`` (4) of its 27 layers (MLA attention, 1
   dense layer, MoE layers of 64 routed experts, top 6, and 2 shared;
   random bf16 weights from a seeded generator) behind
   ``LLMEngine(backend="continuous")``:
   the serve phase's requests and checks (every request finishes, the
   prefix index is hit, a second session reproduces every stream, a
   scored prompt's first token and scores against ``Model.forward``; the
   prompt is scored in an engine of its own whose chunk is the prompt's
   length, since MoE capacity counts a call's tokens, and the mixed-batch
   check is GQA's only).  MLA
   attention and MoE are plain torch on the paged path, as the reference
   computes them outside any Pallas kernel: no kernel may launch in the
   sessions; the scored prompt's ``Model.forward`` runs the flash kernel
   (D 192 / Dv 128) once a layer.  The traced steps
   split device time by the model's named ranges (``SPANS``: MLA
   attention, MoE dispatch, experts and combine, the head).  Reports
   tokens/s, TTFT p50, decode step ms and peak GB.
15. serve_mla_static — the same model behind ``LLMEngine(backend=
   "static")``: 8 prompts of 1024 tokens, 64 new each, twice (every stream
   reproduces), then a ``prompt_logprobs`` call (finite scores <= 0).  The
   flash kernel (D 192 / Dv 128) runs every MLA layer's prefill and
   ``Model.forward`` (one launch a layer a call: 4 in the prefill, 8 in
   the scored call); decoding stays in the latent space, no kernel.  The
   device time of 4 decode steps by kernel and by named range, and of the
   prefill by range.
16. serve_mla_quantized — serve_mla with ``weight_format="mxfp4"`` over
   bf16 pools: the same checks, and ``mxfp4_vmm`` must launch 2 a layer
   plus 2 for the dense layer's MLP per decode step and per prefill chunk
   call (wq and wo, gate/up and down; ``vmm_launches_per_call``), on the
   decode schedule at decode steps and wgmma at prefill calls; and each
   shape it gave the kernel is held against the plain version, as in
   serve_quantized.
17. serve_mla_spec — continuous ``speculative=SpeculativeConfig(gamma=4)``
   with a self-draft: 4 requests, 32 new tokens, twice (every stream
   reproduces); accepted proposals per window as a reading only (a draft
   step's and a verify step's MoE capacity count other batches).  Then
   the legacy ``backend="speculative"`` on one greedy 256-token prompt,
   32 new, twice (``serve_moe_spec_phase``).
18. check — a narrow 2-layer llama-shaped model in f32 served on the card
   (kernel path) and on the CPU (plain path) from the same weights must
   emit the same token streams: continuous dense (greedy and sampled), and
   greedy with mxfp4 weights over f32, int8 and fp8 pools; static (greedy
   and sampled, prompt scores within 1e-4); and on the card static against
   continuous (greedy).  Speculative (gamma 4, self-draft, greedy): the
   continuous engine's on the card against the CPU and against the plain
   engine on the card; every window accepts all gamma proposals unless the
   request's stream holds a near-tie (on the CPU: every window); the legacy
   backend on the card against the CPU.  Except for the dense continuous case, a greedy
   stream may part only at a near-tie: a step whose top-2 logit gap on the
   CPU is below ``NEAR_TIE`` (the bf16 activation cast of the mxfp4 op,
   and the kernels' other orders of f32 sums, turn last-bit differences
   into a flipped argmax now and then).  Then a narrow 2-layer
   deepseek-shaped model (1 mla_dense + 1 mla_moe, 8 experts, top 2, the
   capacity path forced), f32, card against CPU: continuous, static,
   continuous speculative and legacy speculative, greedy, under the same
   near-tie rule (``check_mla``; at deepseek's head dims, so its static
   and legacy paths run the flash kernel's f32 variant at D 192 / Dv 128).
   Then one training step of each family's narrow f32 model
   (``check_train``: dense with qk-norm and bias, windowed, MLA + MoE,
   GQA + MoE, SSM, hybrid, audio, vision) on the card against the CPU
   from the same weights: loss, every gradient leaf and every updated
   leaf within stated tolerances, no kernel launched; and the narrow
   vision model's static greedy stream, card against CPU.
19. serve_moe, serve_moe_static, serve_moe_quantized, serve_moe_spec —
   after deepseek is freed, llama4-scout at full width (d_model 5120, 40
   query heads over 8, head dim 128, 16 experts of 8192 plus a shared one,
   vocab 202048) and ``SCOUT_LAYERS`` (4) of its 48 layers, of random
   bf16 weights: the serve phase's requests and checks (continuous
   bf16 with a scored prompt; static 8 x 1024; mxfp4 attention
   projections over fp8 pools, 2 ``mxfp4_vmm`` launches a layer, each
   shape held on its own activations; self-draft ``speculative=`` and the
   legacy backend, as serve_mla_spec).  GQA attention runs the port's
   kernels (paged online over bf16 and fp8 pools, paged exact, flash,
   dense decode), MoE plain torch; the traced steps split device time by
   the named ranges (``gqa_attention``, MoE dispatch, experts, combine,
   head).
20. serve_moe_maverick — after scout is freed, llama4-maverick at full
   width for one period (``attn_dense`` + ``attn_moe``, 128 experts:
   the capacity path at every batch, 1 row an expert at 8 slots; 37.1 GB),
   one continuous bf16 session with serve's checks.
20b. check_window — narrow phi3- and danube-shaped models (2 layers, D
   96 and D 80, danube with a 64-token window and prompts past it), f32,
   card against CPU: continuous (greedy and sampled), static, and static
   against continuous on the card, under the near-tie rule; f32 runs the
   kernels' CUDA-core variants at the new head dims.
20c. check_state — narrow mamba2- and hymba-shaped models (2 and 3
   layers; hymba global, windowed (64), global, rep 5 at D 64), f32, card
   against CPU: the continuous engine with a forced preemption and
   iterations that mix prefilling and decoding slots (``state_ok``), and
   the static engine, under the near-tie rule.
21. check_moe — two narrow llama4-shaped models (scout's period, dense
   MoE; maverick's period x 2, capacity forced), f32, card against CPU:
   continuous with a prefix hit, static, continuous and legacy
   speculative, greedy, under the near-tie rule.
20d. serve_vlm — after maverick is freed, internvl2-26b at full width
   and ``VLM_LAYERS`` (8) of its 48 layers (4.26 B params, 8.55 GB)
   behind the static ``ServeEngine``: 4 prompts of 256 random image
   embeddings ahead of 768 text tokens (greedy and sampled rows), 64 new
   tokens, twice (the re-run reproduces every stream; its TTFT and
   decode step are the readings); the flash kernel once a layer in the
   prefill (rep 6), the dense decode kernel once a layer a step; the
   device time of 4 decode steps (as serve_static).
20d'. kernel_dryrun (with the kernel phases) — flash at qwen3-14b's
   prefill_32k (B 1, S 32768, H 40, KVH 8, D 128, causal; held against
   ``blocked_attention``) and the dense decode at qwen3-14b's decode_32k
   (B 4 x 32768 entries, rep 5, D 128) and hymba-1.5b's long_500k global
   layers (B 1 x 524288 entries, D 64, rep 5), each also at a ragged
   cur_len, then timed beside its bound, plain version and SDPA.
   dryrun — after serve_vlm, the dry-run's five card cells
   (``DRYRUN_CELLS``) through ``launch.dryrun.run_cell(device="cuda")``:
   each counted on meta at the card's rows (FLOPs, ``bound_bytes``,
   ``bound_s`` from the H100's data sheet), then timed at full width and
   depth (a warm-up step, the median wall of 2, the busy ms of a profiled
   one, peak GB); every kernel the count saw launched 4 times as often on
   the card and no other, and each step's output is finite.
20e. train_hubert — hubert-xlarge at full size (48 layers, 1.26 B
   params): a no-grad ``Model.forward`` over B 4 x 1500 frames (48
   non-causal flash launches at D 80; its logits against the plain
   path's by relative L2 error, the error after layers 1, 6, 24 and 48,
   flash's and plain's errors against an f32 plain forward, and two
   faulty attentions that the hold must refuse), then 4
   AdamW steps with ``remat=True`` at B 4 x 1024 frames: no kernel
   launches in a step (attention under autograd is the plain
   ``blocked_attention``, 2 calls a layer a step), step ms, tokens/s,
   the model-FLOPs share of 989 TFLOP/s, peak GB, and the plain
   attention's share of a traced step's device time (a layer's attention
   timed alone, times 48).
20f. train — h2o-danube-1.8b at full width and 2 of its 24 layers
   through ``run_training`` (remat, B 4 x 2048, 12 steps, a checkpoint
   every 5 and at the last, ~3 GB each): an injected failure at step 8
   restores step 5 (the replayed steps' losses compared bit for bit with
   the first pass's), then a second call on the same directory resumes
   at 12 and runs to 14; step ms, save and restore seconds and bytes.
20g. train_cli — ``repro_torch.launch.train.main`` (danube's reduced
   config on the card, 20 steps, a temporary checkpoint directory) must
   return 0 and print the reference's summary line.
20h. train_tp — parallel training: two ranks (spawned processes) share
   ``cuda:0`` over gloo.  qwen3-14b at full width (2 of 40 layers, B 4 x
   1024) on (1, 2) (TP + sequence parallelism, 2 steps), (2, 1) (DP +
   FSDP) and (2 pods, 1, 1) (the int8 cross-pod mean), 1 step each, and
   deepseek-v2-lite (2 of 27 layers, capacity path, 32 experts a rank)
   on (1, 2), 2 steps, each against a tp=1 session of the same
   seed-built weights run first; then a reduced checkpoint written on
   (1, 2) and restored on (2, 1).  Holds: each rank stores the plan's
   bytes, each kind of collective bytes equals ``predict_step_bytes``,
   losses within ``TRAIN_TP_LOSS_ABS`` of tp=1's, every session's sampled
   gradients (with pods their exact cross-pod mean) by an f32 witness,
   routing flips within the f32 witness's gaps, the
   compressed mean within half a code step, the checkpoint bitwise; no
   hand-written kernel launches (training runs none).
20i. serve_static_tp — sharded static serving: two ranks share
   ``cuda:0`` over gloo on a (1, 2) mesh, ``make_plan``'s plans run by
   ``ServeEngine``: qwen3-14b (2 of 40 layers, B 4 x 1024-token prompts,
   32 new) on the decode plan (full TP, the KV cache split by sequence),
   deepseek-v2-lite (2 of 27 layers) expert parallel on the decode plan,
   hymba-1.5b (4 of 32 layers, its global layers 0 and 3) on the
   long_decode plan (B 1, a 12288-token prompt into 16384 entries, 64
   new), each beside a tp=1 session first.  Holds: each rank stores the
   plan's weight and KV bytes, its collective bytes by kind equal
   ``predict_serve_bytes``, flash once a layer and the dense decode's
   partial mode once a GQA layer a step, the first token's logits within
   ``SCORE_REL_TOL`` of tp=1's, greedy streams part only at near ties
   (the MoE model at or after a routing flip that is a near tie).  Then
   the partial mode against its plain version at B 8 (1024 valid of a
   2048-entry cache) and at qwen3 decode_32k's shape (B 128, 16384 valid
   of 32768), each split in two with the second half empty, timed beside
   the whole-cache kernel, its bound and the memory-efficient SDPA with
   its log-sum-exp.
21b. serve_cli — ``repro_torch.launch.serve.main`` in this process:
   ``--no-reduced --arch llama3-8b --continuous --disaggregate 1:1`` (all
   32 layers, 4 requests of 256 tokens, 16 new) and ``--fleet --calibrate``
   (a 2-layer llama3-8b engine timed into a latency table in a temporary
   directory, and the simulator cross-checked against its replay); each
   must return 0.
21c. examples — the four ``examples/torch_*.py`` as subprocesses at short
   settings: quickstart (qwen3-14b at full width, 2 layers), serve_decode
   (``--layers 2 --batch 4 --new 16``), train_small (``--steps 20
   --no-failure``, checkpoints in a temporary directory) and
   design_space; each must exit 0 and print its summary lines, and the
   quickstart's static section must launch the flash and dense decode
   kernels once a layer a prefill and a decode step.
22. sim — host only: the paper's H100 model (``sim.gpu_model``) for each
   serve phase's config as served, beside its measured wall and
   device-busy decode step, and ``iso_tdp_comparison`` for llama3-405b
   and llama4-scout, printed as modeled.

Output: the card's name and power limit early, one JSON line per phase,
the kernels line (the six kernels at llama3-8b's shapes, then their D 96
and D 80 variants and ``mxfp4_vmm`` at phi3's and danube's projections,
then the same kernels at hymba's shapes, then flash at D 192 / Dv 128,
then flash at hubert's and internvl2's shapes and the dense decode at
internvl2's, then flash at S 32768 and the dense decode at 32768 and
524288 entries (launches from the dryrun phase's cells), then the dense
decode's partial mode (launches from serve_static_tp's two ranks);
``launches`` from the serve phase that runs each, on its own
model, or hubert's no-grad forward; the paged decode kernels' and
``mxfp4_vmm``'s ``launches_serve_tp`` summed over serve_tp's ranks, the
paged kernels' ``launches_serve_disagg_tp`` over serve_disagg_tp's
decode ranks), and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# the port's package, from the checkout this script sits in (outside a
# checkout of the repo the import fails and the script exits non-zero)
sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch.kernels.cost import (  # noqa: E402
    PEAK_OPS_PER_S, dense_bound, flash_bound, paged_bound,
    vmm_bound, vmm_bytes,
)

KERNEL_SOURCE = "src/repro_torch/kernels/decode_attention/csrc/paged_decode.cu"
REPLACES = "src/repro/kernels/decode_attention/paged_kernel.py:150"
VMM_SOURCE = "src/repro_torch/kernels/mxfp4_vmm/csrc/mxfp4_vmm.cu"
VMM_REPLACES = "src/repro/kernels/mxfp4_vmm/kernel.py:80"
FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:74"
DENSE_SOURCE = "src/repro_torch/kernels/decode_attention/csrc/dense_decode.cu"
DENSE_REPLACES = "src/repro/kernels/decode_attention/kernel.py:67"
EXACT_SOURCE = "src/repro_torch/kernels/decode_attention/csrc/paged_exact.cu"
EXACT_REPLACES = ("src/repro/kernels/decode_attention/paged_kernel.py:116 "
                  "(_exact_kernel, via paged_decode_attention(accum=\"exact\")"
                  " at :150)")
H, KVH, D, PAGE = 32, 8, 128, 16           # llama3-8b decode geometry
GEOM = (H, KVH, D, PAGE)
SCOUT_HEADS = (40, 8)      # llama4-scout's query and KV heads (rep 5)
# more geometries of the bf16 / code-pool tensor-core kernels: D 64 (GQA
# 4:1), rep 5 (qwen2.5-14b / qwen3-14b: 40 heads over 8), a page of 32, and
# rep 8 (the exact kernel's 64-row M tile at C 5)
TC_GEOMS = ((16, 4, 64, 16), (40, 8, 128, 16), (32, 8, 128, 32),
            (64, 8, 128, 16))
NEAR_TIE = 0.02       # top-2 logit gap below which card and CPU may differ
# bf16 logits of the full-size model: a near-tie is a top-2 gap of at most
# this many bf16 ulps of the top logit (the head's output is bf16, so gaps
# come in ulps)
NEAR_TIE_BF16_ULPS = 2


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()
    return out.splitlines()[0]


# ---------------------------------------------------------------------------
# 1. kernel phase
# ---------------------------------------------------------------------------


def paged_case(torch, rng, B, n_blocks, dtype, pos, dev, geom=GEOM):
    """Random pools with a poisoned scratch page 0, per-row permuted page
    tables whose entries past each row's position point at page 0;
    ``geom`` is (H, KVH, D, page)."""
    h, kvh, d, page = geom
    P = 1 + B * n_blocks
    table = rng.permutation(np.arange(1, P)).reshape(B, n_blocks)
    live = np.arange(n_blocks)[None, :] <= (pos // page)[:, None]
    table = np.where(live, table, 0).astype(np.int32)
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    kp = torch.randn((P, page, kvh, d), generator=gen, device=dev).to(dtype)
    vp = torch.randn((P, page, kvh, d), generator=gen, device=dev).to(dtype)
    kp[0], vp[0] = 1e4, -1e4
    q = torch.randn((B, h, d), generator=gen, device=dev).to(dtype)
    return (q, kp, vp, torch.as_tensor(table, device=dev),
            torch.as_tensor(pos.astype(np.int32), device=dev))


def time_ms(torch, fn, flush, iters=30, warmup=3) -> float:
    """Median device time of ``fn`` over ``iters`` launches, each after a
    512 MB memset that evicts the 50 MB L2 (the serve path meets every
    layer's pages cold) and keeps the device busy while the host enqueues;
    ``warmup`` calls first."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def stream_read_ms(torch, nbytes: int, flush) -> float:
    """The card's practical read rate under ``time_ms``: one contiguous
    read (a bf16 sum) of ``nbytes``, the bytes a kernel must read."""
    stream = torch.empty(nbytes // 2, dtype=torch.bfloat16, device="cuda")
    ms = time_ms(torch, lambda: stream.sum(), flush)
    del stream
    return ms


def ratios(row: dict) -> dict:
    """The timing line's yardsticks that survive a change of card: the
    kernel's time over the library call's, and the bound over the
    kernel's time (its share of the roofline)."""
    if row.get("library_ms"):
        row["kernel_over_library"] = row["ms"] / row["library_ms"]
    row["bound_over_kernel"] = row["bound_ms"] / row["ms"]
    return row


def build_phase() -> None:
    """Build every CUDA source of the port at once (one ``nvcc`` each, in
    parallel) and print each compiler report."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels._build import library_path
    from repro_torch.kernels.decode_attention import kernel as dense_kernel
    from repro_torch.kernels.decode_attention import paged_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.mxfp4_vmm import kernel as vmm_kernel

    libs = {"paged_decode": (paged_kernel._lib, paged_kernel.SOURCE),
            "paged_exact": (paged_kernel._exact_lib, paged_kernel.EXACT_SOURCE),
            "mxfp4_vmm": (vmm_kernel._lib, vmm_kernel.SOURCE),
            "flash_attention": (flash_kernel._lib, flash_kernel.SOURCE),
            "dense_decode": (dense_kernel._lib, dense_kernel.SOURCE)}
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(libs)) as ex:
        for fut in [ex.submit(load) for load, _ in libs.values()]:
            fut.result()
    print(f"kernel build: {time.monotonic() - t0:.1f} s for {len(libs)} "
          f"sources in parallel")
    for name, (_, source) in libs.items():
        log = library_path(name, [source]).parent / "build.log"
        print(f"  {name}: -Xptxas -v report in {log}")
        for line in log.read_text().splitlines():
            if "Used" in line or "spill" in line:
                print("    ptxas:", line.strip())


def sdpa_ms(torch, F, q, k_d, v_d, mask, flush) -> dict:
    """SDPA on the gathered (B, KVH, S, D) view, timed two ways: with
    ``enable_gqa=True`` on the KVH heads, and on K/V repeated to the H
    query heads (which reads rep x the bytes).  A yardstick only."""
    q4 = q[:, :, None, :]
    rep = q.shape[1] // k_d.shape[1]
    k_r = torch.repeat_interleave(k_d, rep, dim=1).contiguous()
    v_r = torch.repeat_interleave(v_d, rep, dim=1).contiguous()
    k_g, v_g = k_d.contiguous(), v_d.contiguous()
    return {"sdpa_gqa_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, k_g, v_g, attn_mask=mask, enable_gqa=True), flush),
            "sdpa_repeat_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, k_r, v_r, attn_mask=mask), flush)}


def kernel_phase(torch) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import paged_kernel
    from repro_torch.kernels.decode_attention.ref import (
        gather_pages, paged_decode_attention_ref, paged_valid_mask,
    )

    dev = torch.device("cuda")

    rng = np.random.default_rng(0)
    # f32: absolute (f32 sums in another order).  bf16: element by element,
    # one bf16 ulp of each output plus 1e-4, the dense decode's rule
    tol_f32, atol_bf16 = 1e-5, 1e-4
    errs, shares = {}, []
    cases = [(dtype_name, B, window, GEOM)
             for dtype_name in ("bfloat16", "float32")
             for B, window in ((1, None), (8, None), (8, 1000), (8, 1))]
    cases += [("bfloat16", 8, window, geom) for geom in TC_GEOMS
              for window in (None, 1000)]
    for dtype_name, B, window, geom in cases:
        dtype = getattr(torch, dtype_name)
        page = geom[3]
        n_blocks = 4096 // page + 4
        pos = rng.integers(0, 4096, B)
        pos[0] = 4095 if B == 1 else page + page // 2    # mid-page
        q, kp, vp, table, p = paged_case(torch, rng, B, n_blocks, dtype,
                                         pos, dev, geom)
        kind = paged_kernel.variant(q.dtype, kp.dtype, geom[2], page)
        out = paged_kernel.paged_decode_attention(q, kp, vp, table, p,
                                                  window=window)
        ref = paged_decode_attention_ref(q, kp, vp, table, p,
                                         window=window)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if dtype_name == "float32":
            ok, limit = err <= tol_f32, f"{tol_f32}"
        else:
            share = ulp_limit_share(out, ref, atol_bf16)
            shares.append(share)
            ok = share <= 1.0
            limit = (f"2^-7 |ref| + {atol_bf16} per element; worst "
                     f"element at {share:.3g} of it")
        print(f"  kernel vs plain ({kind}): {dtype_name} pools B={B} "
              f"H, KVH, D, page={geom} window={window}: max abs err "
              f"{err:.3g} (tolerance {limit})")
        if not ok:
            raise AssertionError(f"paged_decode_attention disagrees with "
                                 f"its plain version: {err} ({limit})")
        errs[dtype_name] = max(errs.get(dtype_name, 0.0), err)

    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=dev)
    timings = []
    for ctx in (1024, 4096):
        B = 8
        pos = np.full(B, ctx - 1)
        q, kp, vp, table, p = paged_case(torch, rng, B, ctx // PAGE,
                                         torch.bfloat16, pos, dev)
        k_d = gather_pages(kp, table).transpose(1, 2)       # (B, KVH, S, D)
        v_d = gather_pages(vp, table).transpose(1, 2)
        mask = paged_valid_mask(table, PAGE, p)[:, None, None, :]
        row = {"ctx": ctx, "B": B, "pools": "bfloat16",
               "ms": time_ms(torch, lambda: paged_kernel.paged_decode_attention(
                   q, kp, vp, table, p), flush),
               "plain_ms": time_ms(torch, lambda: paged_decode_attention_ref(
                   q, kp, vp, table, p), flush),
               **sdpa_ms(torch, F, q, k_d, v_d, mask, flush)}
        row["library_ms"] = min(row["sdpa_gqa_ms"], row["sdpa_repeat_ms"])
        row["bound_ms"], row["bound_by"] = paged_bound(pos, None, B, "bfloat16",
                                                      2, geom=GEOM)
        row["stream_read_ms"] = stream_read_ms(
            torch, 2 * B * ctx * KVH * D * 2, flush)
        timings.append(ratios(row))
        print("  timing:", json.dumps(row))
    del flush
    head = timings[0]
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": REPLACES,
            "launches": None, "max_abs_err": errs["bfloat16"],
            "max_abs_err_f32": errs["float32"],
            "max_bf16_limit_share": max(shares),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "library": "the faster of F.scaled_dot_product_attention("
                       "enable_gqa=True) on the gathered KVH-head view and "
                       "SDPA on K/V repeated to H heads",
            "us": head["ms"] * 1e3, "ref_us": head["plain_ms"] * 1e3,
            "sdpa_us": head["library_ms"] * 1e3,
            "stream_read_ms": head["stream_read_ms"], "timings": timings}


# ---------------------------------------------------------------------------
# 2. scale-pool decode kernel phase (fp8 / int8 code pools)
# ---------------------------------------------------------------------------


def quantized_case(torch, rng, B, n_blocks, cache_dtype, pos, dev,
                   geom=GEOM):
    """``paged_case`` pools written through ``kv_quantize``; the scratch
    page's codes and scales poisoned."""
    from repro_torch.quant import kv as kvq

    q, kp, vp, table, p = paged_case(torch, rng, B, n_blocks, torch.float32,
                                     pos, dev, geom)
    kc, ks = kvq.kv_quantize(kp, cache_dtype)
    vc, vs = kvq.kv_quantize(vp, cache_dtype)
    ks[0], vs[0] = 1e4, -1e4
    return q.to(torch.bfloat16), kc, vc, ks, vs, table, p


def kernel_scaled_phase(torch) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import paged_kernel
    from repro_torch.kernels.decode_attention.ref import (
        gather_pages, paged_decode_attention_ref, paged_valid_mask,
    )
    from repro_torch.quant import kv as kvq

    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    # bf16 output: one bf16 ulp of each output plus 1e-4 (the f32 sums run
    # in another order), element by element; f32 output: 1e-5 absolute
    atol_bf16 = 1e-4
    err_max, shares = 0.0, []
    cases = [(cache_dtype, B, window, GEOM) for cache_dtype in ("fp8", "int8")
             for B, window in ((1, None), (8, None), (8, 1000), (8, 1))]
    cases += [(cache_dtype, 8, 1000, geom) for cache_dtype in ("fp8", "int8")
              for geom in TC_GEOMS]
    for cache_dtype, B, window, geom in cases:
        page = geom[3]
        n_blocks = 4096 // page + 4
        pos = rng.integers(0, 4096, B)
        pos[0] = 4095 if B == 1 else page + page // 2
        q, kc, vc, ks, vs, table, p = quantized_case(
            torch, rng, B, n_blocks, cache_dtype, pos, dev, geom)
        for q_in in (q, q.float()):
            kind = paged_kernel.variant(q_in.dtype, kc.dtype, geom[2],
                                        page)
            out = paged_kernel.paged_decode_attention(
                q_in, kc, vc, table, p, k_scales=ks, v_scales=vs,
                window=window)
            ref = paged_decode_attention_ref(
                q_in, kc, vc, table, p, k_scales=ks, v_scales=vs,
                window=window)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            if q_in.dtype == torch.bfloat16:
                share = ulp_limit_share(out, ref, atol_bf16)
                shares.append(share)
                ok = share <= 1.0
                limit = (f"2^-7 |ref| + {atol_bf16} per element; worst "
                         f"element at {share:.3g} of it")
            else:
                ok, limit = err <= 1e-5, "1e-05"
            print(f"  scaled kernel vs plain ({kind}): {cache_dtype} "
                  f"pools, q {str(q_in.dtype)[6:]} B={B} H, KVH, D, "
                  f"page={geom} window={window}: max abs err {err:.3g} "
                  f"(tolerance {limit})")
            if not ok:
                raise AssertionError(f"scale-pool decode kernel disagrees "
                                     f"with its plain version: {err} "
                                     f"({limit})")
            if q_in.dtype == torch.bfloat16:
                err_max = max(err_max, err)

    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=dev)
    timings = []
    for cache_dtype in ("fp8", "int8"):
        for ctx in (1024, 4096):
            B = 8
            pos = np.full(B, ctx - 1)
            q, kc, vc, ks, vs, table, p = quantized_case(
                torch, rng, B, ctx // PAGE, cache_dtype, pos, dev)
            # SDPA on the pre-dequantized bf16 view: another function (it
            # reads bf16 K/V, twice the bytes), timed as a yardstick only
            k_d = kvq.kv_dequantize(gather_pages(kc, table),
                                    gather_pages(ks, table), torch.bfloat16)
            v_d = kvq.kv_dequantize(gather_pages(vc, table),
                                    gather_pages(vs, table), torch.bfloat16)
            mask = paged_valid_mask(table, PAGE, p)[:, None, None, :]
            row = {"ctx": ctx, "B": B, "pools": cache_dtype,
                   "ms": time_ms(torch, lambda: paged_kernel.paged_decode_attention(
                       q, kc, vc, table, p, k_scales=ks, v_scales=vs), flush),
                   "plain_ms": time_ms(torch, lambda: paged_decode_attention_ref(
                       q, kc, vc, table, p, k_scales=ks, v_scales=vs), flush),
                   **sdpa_ms(torch, F, q, k_d.transpose(1, 2),
                             v_d.transpose(1, 2), mask, flush)}
            row["sdpa_on_dequantized_bf16_ms"] = min(row["sdpa_gqa_ms"],
                                                     row["sdpa_repeat_ms"])
            row["bound_ms"], row["bound_by"] = paged_bound(
                pos, None, B, cache_dtype, 1, q_itemsize=2, scale_itemsize=4,
                geom=GEOM)
            # 1-byte codes and a 4-byte scale per token and kv head, K and V
            row["stream_read_ms"] = stream_read_ms(
                torch, 2 * B * ctx * KVH * (D + 4), flush)
            timings.append(ratios(row))
            print("  timing:", json.dumps(row))
    del flush
    head = timings[0]                       # fp8 pools, B 8, ctx 1024
    return {"name": paged_kernel.NAME_SCALED, "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": REPLACES + " (k_scales/"
            "v_scales branch, paged_kernel.py:94-98, :202-207)",
            "launches": None, "max_abs_err": err_max,
            "max_bf16_limit_share": max(shares),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None, "stream_read_ms": head["stream_read_ms"],
            "sdpa_on_dequantized_bf16_ms": head["sdpa_on_dequantized_bf16_ms"],
            "timings": timings}


# ---------------------------------------------------------------------------
# 3. MXFP4 VMM kernel phase
# ---------------------------------------------------------------------------

# llama3-8b projections (K, N), each with its count in one decoder layer
PROJECTIONS = {"wq/wo": ((4096, 4096), 2), "wk/wv": ((4096, 1024), 2),
               "w_gate/w_up": ((4096, 14336), 2), "w_down": ((14336, 4096), 1)}
# the serve path's four launches a layer: q/k/v and gate/up grouped
LAYER_LAUNCHES = {"qkv": (4096, (4096, 1024, 1024)), "wo": (4096, (4096,)),
                  "gate/up": (4096, (14336, 14336)), "w_down": (14336, (4096,))}
VMM_ROWS = (1, 8, 16, 64, 256, 2048)   # decode steps to prefill chunk batches
VMM_CROSSOVER_ROWS = (8, 16)           # both schedules timed
# llama3-70b projections (K, N): the widths a 70B deployment streams
PROJECTIONS_70B = {"wq/wo": (8192, 8192), "wk/wv": (8192, 1024),
                   "w_gate/w_up": (8192, 28672), "w_down": (28672, 8192)}
VMM_70B_ROWS = (8, 256)
# deepseek-v2-lite-16b's MXFP4 launches (K, Ns): MLA's wq and wo, and the
# dense first layer's gate/up (grouped; N 10944 is not a multiple of the
# 128-column tile, so it takes the byte-copy path) and w_down.  The MoE
# layers' experts are not quantized (the reference skips the moe subtree)
DS_LAUNCHES = {"wq": (2048, (3072,)), "wo": (2048, (2048,)),
               "gate/up": (2048, (10944, 10944)), "w_down": (10944, (2048,))}
# the rows the serve path gives them: decode steps (M 8, one per slot) and
# prefill chunk calls of 8, 4, 2 and 1 rows of 256 tokens
DS_ROWS = (8, 256, 512, 1024, 2048)
VMM_TOL = 1e-5          # relative to max |out|: f32 sums in another order


def hold_vmm(torch, x, ws, variant=None) -> tuple[float, str, int]:
    """Hold one ``mxfp4_vmm`` launch (x (M, K) bf16; ``ws``, 1..3
    (codes, scales) pairs sharing K) against the plain version per weight:
    f32 out within ``VMM_TOL`` of max |out|, bf16 out == f32 out rounded
    (the same sums).  Returns the worst error, the schedule and the grid."""
    from repro_torch.kernels.mxfp4_vmm import kernel as vmm_kernel
    from repro_torch.kernels.mxfp4_vmm.ref import mxfp4_vmm_ref

    (m, k), ns = x.shape, [c.shape[-1] for c, _ in ws]
    out = vmm_kernel.mxfp4_vmm_group(x, ws, variant=variant)
    out16 = vmm_kernel.mxfp4_vmm_group(x, ws, torch.bfloat16, variant)
    sched = vmm_kernel.schedule(m, k, ns, vmm_kernel._num_sms(0), variant)
    worst = 0.0
    for o, o16, (codes, scales) in zip(out, out16, ws):
        ref = mxfp4_vmm_ref(x, codes, scales)
        torch.cuda.synchronize()
        err = ((o - ref).abs().max() / ref.abs().max()).item()
        if not err <= VMM_TOL:
            raise AssertionError(f"mxfp4_vmm ({sched.variant}) disagrees "
                                 f"with its plain version at M={m} K={k} "
                                 f"N={ns}: {err}")
        if not torch.equal(o16, o.to(torch.bfloat16)):
            raise AssertionError(f"mxfp4_vmm's bf16 output is not its f32 "
                                 f"output rounded at {(m, k, ns)}")
        worst = max(worst, err)
    return worst, sched.variant, sched.grid


@contextlib.contextmanager
def vmm_calls():
    """Record the first inputs of each distinct (M, K, Ns) launch of
    ``mxfp4_vmm`` that the serve path makes (the activations cloned, the
    weights by reference), so that each shape the path gave the kernel can
    be held against the plain version after the run, outside its counts."""
    from repro_torch.kernels.mxfp4_vmm import ops

    seen, launch = {}, ops.mxfp4_vmm_group

    def recording(x, weights, *args, **kw):
        key = (*x.shape, tuple(c.shape[-1] for c, _ in weights))
        if key not in seen:
            seen[key] = (x.clone(), list(weights))
        return launch(x, weights, *args, **kw)

    ops.mxfp4_vmm_group = recording
    try:
        yield seen
    finally:
        ops.mxfp4_vmm_group = launch


def kernel_mxfp4_phase(torch) -> dict:
    from repro_torch.kernels.mxfp4_vmm import kernel as vmm_kernel
    from repro_torch.kernels.mxfp4_vmm.ref import mxfp4_vmm_ref
    from repro_torch.quant import formats

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=dev)
    weights = {}

    def weight(k, n, scale=0.02):
        if (k, n, scale) not in weights:
            w = (torch.randn((k, n), generator=gen, device=dev) * scale)
            weights[(k, n, scale)] = formats.quantize_mxfp4(w.to(torch.bfloat16))
        return weights[(k, n, scale)]

    def rows(m, k):
        return torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)

    err_max, checked = 0.0, []

    def check(m, k, ns, variant=None, scale=0.02):
        """Hold one launch (single or grouped) against the plain version
        per weight (``hold_vmm``)."""
        nonlocal err_max
        ws = [(p.codes, p.scales) for p in (weight(k, n, scale) for n in ns)]
        worst, variant, grid = hold_vmm(torch, rows(m, k), ws, variant)
        err_max = max(err_max, worst)
        checked.append({"M": m, "K": k, "N": list(ns),
                        "schedule": variant, "grid": grid,
                        "max_rel_err": worst})
        print(f"  mxfp4_vmm vs plain: M={m} K={k} N={list(ns)} "
              f"({variant}, grid {grid}"
              f"{', E8M0 scales >= 128' if scale > 1 else ''}): max rel err "
              f"{worst:.3g} (tolerance {VMM_TOL})")

    for (k, n), _ in PROJECTIONS.values():
        for m in VMM_ROWS:
            check(m, k, (n,))
        for m in VMM_CROSSOVER_ROWS:
            check(m, k, (n,), "wgmma")
    for k, ns in LAYER_LAUNCHES.values():
        for m in (8, 256):
            check(m, k, ns)
    check(37, 544, (1000,))                     # ragged M, N: byte copies
    check(5, 544, (1000, 5))
    check(300, 544, (1000, 5))
    for m in (8, 256):                          # E8M0 scales >= 128
        check(m, 4096, (1024,), scale=2.0 ** 20)
    for k, n in PROJECTIONS_70B.values():
        for m in VMM_70B_ROWS:
            check(m, k, (n,))
    for k, ns in DS_LAUNCHES.values():
        for m in DS_ROWS:
            check(m, k, ns)

    def timed(m, k, ns, variant=None):
        ws = [(weight(k, n).codes, weight(k, n).scales) for n in ns]
        x = rows(m, k)
        return time_ms(torch, lambda: vmm_kernel.mxfp4_vmm_group(
            x, ws, torch.bfloat16, variant), flush)

    def timing_rows(shapes, ms, label=""):
        out = []
        for k, n in shapes:
            p = weight(k, n)
            w_bf16 = formats.dequantize_mxfp4(p, torch.bfloat16)
            for m in ms:
                x = rows(m, k)
                # timed as the serve path calls it: bf16 output
                row = {"M": m, "K": k, "N": n,
                       "schedule": vmm_kernel.schedule(
                           m, k, (n,), vmm_kernel._num_sms(0)).variant,
                       "ms": timed(m, k, (n,)),
                       "plain_ms": time_ms(torch, lambda: mxfp4_vmm_ref(
                           x, p.codes, p.scales).to(torch.bfloat16), flush,
                           iters=10),
                       "bf16_matmul_ms": time_ms(torch, lambda: torch.matmul(
                           x, w_bf16), flush),
                       "stream_read_ms": stream_read_ms(
                           torch, vmm_bytes(m, k, (n,)), flush)}
                row["bound_ms"], row["bound_by"] = vmm_bound(m, k, (n,))
                row["kernel_over_bf16_matmul"] = (row["ms"]
                                                  / row["bf16_matmul_ms"])
                out.append(ratios(row))
                print(f"  timing{label}:", json.dumps(row))
            del w_bf16
        return out

    def launch_rows(launches, ms, label):
        """Each launch as the serve path makes it (grouped weights in one
        launch), beside the per-weight plain versions and ``torch.matmul``
        calls summed."""
        out = []
        for name, (k, ns) in launches.items():
            ps = [weight(k, n) for n in ns]
            dq = [formats.dequantize_mxfp4(p, torch.bfloat16) for p in ps]
            for m in ms:
                x = rows(m, k)
                row = {"launch": name, "M": m, "K": k, "N": list(ns),
                       "schedule": vmm_kernel.schedule(
                           m, k, ns, vmm_kernel._num_sms(0)).variant,
                       "ms": timed(m, k, ns),
                       "plain_ms": sum(time_ms(torch, lambda p=p: mxfp4_vmm_ref(
                           x, p.codes, p.scales).to(torch.bfloat16), flush,
                           iters=10) for p in ps),
                       "bf16_matmul_ms": sum(time_ms(
                           torch, lambda w=w: torch.matmul(x, w), flush)
                           for w in dq),
                       "stream_read_ms": stream_read_ms(
                           torch, vmm_bytes(m, k, ns), flush)}
                row["bound_ms"], row["bound_by"] = vmm_bound(m, k, ns)
                row["kernel_over_bf16_matmul"] = (row["ms"]
                                                  / row["bf16_matmul_ms"])
                out.append(ratios(row))
                print(f"  timing{label}:", json.dumps(row))
            del dq
        return out

    timings = timing_rows([kn for kn, _ in PROJECTIONS.values()], VMM_ROWS)
    timings_70b = timing_rows(PROJECTIONS_70B.values(), VMM_70B_ROWS,
                              " llama3-70b")
    timings_ds = launch_rows(DS_LAUNCHES, DS_ROWS, " deepseek-v2-lite-16b")
    crossover = []
    for (k, n), _ in PROJECTIONS.values():
        for m in VMM_CROSSOVER_ROWS:
            row = {"M": m, "K": k, "N": n,
                   "decode_ms": timed(m, k, (n,), "decode"),
                   "wgmma_ms": timed(m, k, (n,), "wgmma")}
            crossover.append(row)
            print("  crossover:", json.dumps(row))

    # headline: one decoder layer at decode (M = 8) in the serve path's
    # four launches; per-layer sums of the per-weight yardsticks
    def layer(m):
        launches = {name: timed(m, k, ns) for name, (k, ns) in
                    LAYER_LAUNCHES.items()}
        bounds = [vmm_bound(m, k, ns)[0] for k, ns in LAYER_LAUNCHES.values()]
        per_weight = {key: sum(r[key] * cnt for r in timings
                               for (kn, cnt) in PROJECTIONS.values()
                               if r["M"] == m and (r["K"], r["N"]) == kn)
                      for key in ("plain_ms", "bf16_matmul_ms")}
        reads = {name: stream_read_ms(torch, vmm_bytes(m, k, ns), flush)
                 for name, (k, ns) in LAYER_LAUNCHES.items()}
        return {"M": m, "launches_ms": launches,
                "ms": sum(launches.values()), "bound_ms": sum(bounds),
                "launches_stream_read_ms": reads,
                "stream_read_ms": sum(reads.values()), **per_weight}
    head, prefill = layer(8), layer(256)
    print("  layer M 8:", json.dumps(head))
    print("  layer M 256:", json.dumps(prefill))
    del flush, weights
    return {"name": vmm_kernel.NAME, "route": "cuda", "source": VMM_SOURCE,
            "replaces": VMM_REPLACES, "launches": None,
            "max_abs_err": err_max, "max_abs_err_is": "relative to max |out|",
            "headline": "one llama3-8b layer at M 8 in the serve path's 4 "
                        "launches (q/k/v grouped, o, gate/up grouped, down)",
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "stream_read_ms": head["stream_read_ms"],
            "launches_ms": head["launches_ms"],
            "bf16_matmul_ms_note": "torch.matmul on the pre-dequantized bf16 "
                                   "weight: another function, 3.76x the bytes",
            "bf16_matmul_ms": head["bf16_matmul_ms"],
            "layer_m256": prefill, "crossover": crossover,
            "checked": checked, "timings": timings,
            "timings_llama3_70b": timings_70b,
            "timings_deepseek_v2_lite_16b": timings_ds}


# ---------------------------------------------------------------------------
# 4. flash-attention kernel phase (static prefill, prompt scoring)
# ---------------------------------------------------------------------------


def row_rel_err(out, ref) -> float:
    """The worst row's relative error: for each output row (one query in
    one head), max |out - ref| over the head dim / max |ref| over it."""
    diff = (out.float() - ref.float()).abs().amax(-1)
    scale = ref.float().abs().amax(-1).clamp_min(1e-6)
    return (diff / scale).max().item()


def ulp_limit_share(out, ref, atol) -> float:
    """max |out - ref| / (2^-7 |ref| + atol), element by element: at most 1
    when each output is within one bf16 ulp (<= 2^-7 of its magnitude) of
    its plain version's, plus ``atol`` for f32 sums in another order."""
    ref = ref.float()
    limit = 2.0 ** -7 * ref.abs() + atol
    return ((out.float() - ref).abs() / limit).max().item()


def kernel_flash_phase(torch) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention.ops import gqa_flash_attention

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    # f32: absolute (the kernel's f32 FMAs sum in another order).  bf16:
    # relative per output row (one query in one head), so that late causal
    # rows, whose outputs are ~20x smaller than row 0's, are held to their
    # own scale: two bf16 ulps of the row's largest output (the kernel
    # rounds P to bf16 for the tensor cores, and both sides round the
    # output)
    tol = {"float32": 1e-5, "bfloat16": 2.0 ** -6}

    def inputs(B, S, h, kvh, dtype, d=D):
        q = torch.randn((B, S, h, d), generator=gen, device=dev).to(dtype)
        k = torch.randn((B, S, kvh, d), generator=gen, device=dev).to(dtype)
        v = torch.randn((B, S, kvh, d), generator=gen, device=dev).to(dtype)
        return q, k, v

    errs = {"float32": 0.0, "bfloat16": 0.0}
    rel_max = 0.0
    cases = [(1, 1024, H, KVH, D), (8, 1024, H, KVH, D),
             (2, 1000, H, KVH, D),        # ragged S
             (1, 1024, H, H, D),          # MHA (rep 1)
             (2, 1000, 16, 4, 64),        # D 64 (GQA 4:1, ragged)
             # rep 5 (qwen2.5-14b / qwen3-14b heads): an item is 25
             # positions x 5 heads, 125 of its 128 rows, and a position
             # straddles the two consumer warpgroups
             (2, 1000, 40, 8, D),
             (2, 1000, 64, 8, D)]         # llama3-70b heads (rep 8)
    for dtype_name in ("bfloat16", "float32"):
        for B, S, h, kvh, d in cases:
            for causal in (True, False):
                q, k, v = inputs(B, S, h, kvh, getattr(torch, dtype_name), d)
                out = flash_kernel.flash_attention(q, k, v, causal=causal)
                ref = gqa_flash_attention(q, k, v, causal=causal,
                                          impl="reference")
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                measure = (err if dtype_name == "float32"
                           else row_rel_err(out, ref))
                print(f"  flash vs plain: {dtype_name} B={B} S={S} H={h} "
                      f"KVH={kvh} D={d} causal={causal}: max abs err "
                      f"{err:.3g}"
                      + ("" if dtype_name == "float32" else
                         f", worst row's rel err {measure:.3g}")
                      + f" (tolerance {tol[dtype_name]:.3g}"
                      + ("" if dtype_name == "float32" else " per row")
                      + f"; worst at {measure / tol[dtype_name]:.3g} of "
                        "it)")
                if not measure <= tol[dtype_name]:
                    raise AssertionError(f"flash_attention disagrees with its "
                                         f"plain version: {measure} > "
                                         f"{tol[dtype_name]}")
                errs[dtype_name] = max(errs[dtype_name], err)
                if dtype_name == "bfloat16":
                    rel_max = max(rel_max, measure)
                del q, k, v, out, ref

    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=dev)
    timings = []
    for B, causal in ((8, True), (1, True), (8, False)):
        S = 1024
        q, k, v = inputs(B, S, H, KVH, torch.bfloat16)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        row = {"B": B, "S": S, "causal": causal, "dtype": "bfloat16",
               "ms": time_ms(torch, lambda: flash_kernel.flash_attention(
                   q, k, v, causal=causal), flush),
               "plain_ms": time_ms(torch, lambda: gqa_flash_attention(
                   q, k, v, causal=causal, impl="reference"), flush,
                   iters=10),
               "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=causal, enable_gqa=True), flush)}
        row["bound_ms"], row["bound_by"] = flash_bound(
            B, S, S, H, KVH, causal, 2, "bfloat16", D)
        timings.append(ratios(row))
        print("  timing:", json.dumps(row))
        del q, k, v, qt, kt, vt
    qf, kf, vf = (t.float() for t in inputs(8, 1024, H, KVH, torch.bfloat16))
    f32 = {"B": 8, "S": 1024, "causal": True, "dtype": "float32",
           "ms": time_ms(torch, lambda: flash_kernel.flash_attention(
               qf, kf, vf, causal=True), flush)}
    f32["bound_ms"], f32["bound_by"] = flash_bound(8, 1024, 1024, H, KVH,
                                                   True, 4, "float32", D)
    timings.append(ratios(f32))
    print("  timing:", json.dumps(f32))
    # a plain read of the bytes the headline must read: q, k and v
    head = timings[0]                       # B 8, S 1024, causal, bf16
    head["stream_read_ms"] = stream_read_ms(
        torch, 2 * D * 8 * 1024 * (H + 2 * KVH), flush)
    del flush, qf, kf, vf
    return {"name": flash_kernel.NAME, "route": "cuda",
            "source": FLASH_SOURCE, "replaces": FLASH_REPLACES,
            "launches": None, "max_abs_err": errs["bfloat16"],
            "max_row_rel_err": rel_max,
            "max_bf16_limit_share": rel_max / tol["bfloat16"],
            "max_abs_err_f32": errs["float32"],
            "headline": "B 8, Sq = Skv = 1024, causal, bf16 (the static "
                        "prefill of one layer)",
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "stream_read_ms": head["stream_read_ms"],
            "library": "F.scaled_dot_product_attention(is_causal=True, "
                       "enable_gqa=True)", "timings": timings}


# ---------------------------------------------------------------------------
# 5. dense decode kernel phase (static decode step)
# ---------------------------------------------------------------------------


def dense_case(torch, gen, B, S, dtype, cur_len, dev, h=H, kvh=KVH, d=D):
    """A random dense cache whose tail at and past each row's cur_len is
    poisoned (K 1e4, V -1e4): a read of it would show."""
    q = torch.randn((B, h, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, S, kvh, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, S, kvh, d), generator=gen, device=dev).to(dtype)
    cl = torch.as_tensor(np.asarray(cur_len, np.int32), device=dev)
    dead = (torch.arange(S, device=dev)[None, :] >= cl[:, None].long())
    k[dead] = 1e4
    v[dead] = -1e4
    return q, k, v, cl


def kernel_dense_decode_phase(torch) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import kernel as dense_kernel
    from repro_torch.models.common import decode_attention_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(22)
    rng = np.random.default_rng(4)
    # f32: absolute.  bf16: element by element, one bf16 ulp of each
    # output (both sides sum in f32 and round once, to bf16) plus 1e-4
    # for the f32 sums' other order; the limit's share is reported
    tol_f32, atol_bf16 = 1e-5, 1e-4
    errs, shares = {}, []
    for dtype_name in ("bfloat16", "float32"):
        cases = []
        for B in (1, 8):
            for S in (2048, 4096):
                cur_len = rng.integers(1, S + 1, B)
                cur_len[0] = S if B == 1 else 1          # full; one token
                cases.append((B, S, cur_len, H, KVH, D))
        # the legacy speculative engine's step (B 1, max_len 512), D 64
        # (GQA 4:1), and llama4-scout's heads (H 40, KVH 8: rep 5)
        cases += [(1, 512, np.array([288]), H, KVH, D),
                  (8, 2048, rng.integers(1, 2049, 8), 16, 4, 64),
                  (8, 2048, rng.integers(1, 2049, 8), *SCOUT_HEADS, D)]
        for B, S, cur_len, h, kvh, d in cases:
            q, k, v, cl = dense_case(torch, gen, B, S,
                                     getattr(torch, dtype_name), cur_len,
                                     dev, h, kvh, d)
            out = dense_kernel.decode_attention(q, k, v, cl)
            ref = decode_attention_ref(q, k, v, cl)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            if dtype_name == "float32":
                ok, limit = err <= tol_f32, f"{tol_f32}"
            else:
                share = ulp_limit_share(out, ref, atol_bf16)
                shares.append(share)
                ok = share <= 1.0
                limit = (f"2^-7 |ref| + {atol_bf16} per element; "
                         f"worst element at {share:.3g} of it")
            print(f"  dense decode vs plain: {dtype_name} B={B} S={S} "
                  f"H={h} KVH={kvh} D={d} cur_len {cur_len.tolist()[:4]}"
                  f"...: max abs err "
                  f"{err:.3g} (tolerance {limit})")
            if not ok:
                raise AssertionError(f"decode_attention disagrees with "
                                     f"its plain version: {err} "
                                     f"({limit})")
            errs[dtype_name] = max(errs.get(dtype_name, 0.0), err)

    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=dev)
    timings = []
    # the static serve's last decode step (8 prompts of 1024 + 64 new
    # tokens in a 2048-token cache), a full 4096-token cache, the legacy
    # speculative engine's B 1 step at 288 of 512, and the static serve's
    # last step at llama4-scout's heads (rep 5)
    for B, S, ctx, h, kvh in ((8, 2048, 1088, H, KVH), (8, 4096, 4096, H, KVH),
                              (1, 512, 288, H, KVH),
                              (8, 2048, 1088, *SCOUT_HEADS)):
        cur_len = np.full(B, ctx)
        q, k, v, cl = dense_case(torch, gen, B, S, torch.bfloat16, cur_len,
                                 dev, h, kvh)
        q4 = q[:, :, None, :]
        ks = k[:, :ctx].transpose(1, 2)            # the valid prefix
        vs = v[:, :ctx].transpose(1, 2)
        row = {"B": B, "S": S, "cur_len": ctx, "H": h, "KVH": kvh,
               "cache": "bfloat16",
               "ms": time_ms(torch, lambda: dense_kernel.decode_attention(
                   q, k, v, cl), flush),
               "plain_ms": time_ms(torch, lambda: decode_attention_ref(
                   q, k, v, cl), flush),
               "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                   q4, ks, vs, enable_gqa=True), flush)}
        row["bound_ms"], row["bound_by"] = dense_bound(cur_len, B, 2,
                                                       "bfloat16", h, kvh, D)
        # the card's practical read rate under this timer: one contiguous
        # read (a sum) of the K/V bytes the kernel must read
        row["stream_read_ms"] = stream_read_ms(torch, 2 * B * ctx * kvh * D * 2,
                                               flush)
        timings.append(ratios(row))
        print("  timing:", json.dumps(row))
    del flush
    head = timings[0]
    return {"name": dense_kernel.NAME, "route": "cuda",
            "source": DENSE_SOURCE, "replaces": DENSE_REPLACES,
            "launches": None, "max_abs_err": errs["bfloat16"],
            "max_abs_err_f32": errs["float32"],
            "max_bf16_limit_share": max(shares),
            "headline": "B 8, cur_len 1088 of a 2048-token bf16 cache",
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "library": "F.scaled_dot_product_attention(enable_gqa=True) on "
                       "the cache sliced to cur_len", "timings": timings}


# ---------------------------------------------------------------------------
# 6. exact-accumulator paged decode (the speculative verify step)
# ---------------------------------------------------------------------------

GAMMA = 4                  # speculative lookahead of serve_spec and check
VERIFY_C = GAMMA + 1       # queries per slot in one verify step


def exact_case(torch, rng, B, C, n_blocks, pools, start, dev, geom=GEOM):
    """Random pools (f32, bf16, or fp8/int8 codes written through
    ``kv_quantize``) with a poisoned scratch page 0 (codes and scales),
    per-row permuted page tables whose entries past each row's last query
    (start + C - 1) point at page 0, and every pool position after a row's
    last query in its live pages filled with K 1e4, V -1e4: the causal mask
    must give all of them zero weight.  ``geom`` is (H, KVH, D, page)."""
    from repro_torch.quant import kv as kvq

    h, kvh, d, page = geom
    P = 1 + B * n_blocks
    table = rng.permutation(np.arange(1, P)).reshape(B, n_blocks)
    last = start + C - 1
    live = np.arange(n_blocks)[None, :] <= (last // page)[:, None]
    table = np.where(live, table, 0).astype(np.int32)
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    kp = torch.randn((P, page, kvh, d), generator=gen, device=dev)
    vp = torch.randn((P, page, kvh, d), generator=gen, device=dev)
    kp[0], vp[0] = 1e4, -1e4
    pages, offs = [], []
    for b in range(B):
        for t in range(last[b] + 1, (last[b] // page + 1) * page):
            pages.append(table[b, t // page])
            offs.append(t % page)
    if pages:
        idx = (torch.as_tensor(pages, device=dev),
               torch.as_tensor(offs, device=dev))
        kp[idx], vp[idx] = 1e4, -1e4
    q = torch.randn((B, C, h, d), generator=gen, device=dev)
    scales = {}
    if pools in ("fp8", "int8"):
        kp, ks = kvq.kv_quantize(kp, pools)
        vp, vs = kvq.kv_quantize(vp, pools)
        ks[0], vs[0] = 1e4, -1e4
        scales = dict(k_scales=ks, v_scales=vs)
        q = q.to(torch.bfloat16)
    else:
        dt = getattr(torch, pools)
        kp, vp, q = kp.to(dt), vp.to(dt), q.to(dt)
    return (q, kp, vp, torch.as_tensor(table, device=dev),
            torch.as_tensor(start.astype(np.int32), device=dev), scales)


def exact_invariance(torch, paged_kernel, q, kp, vp, table, st, out, kw,
                     name) -> None:
    """The exact kernel's contract, bit for bit: query j of a C-query
    launch is a one-query launch at start + j; row b of a batch is that row
    launched alone, with a wider page table."""
    B, C = q.shape[:2]
    for j in range(C if C > 1 else 0):
        one = paged_kernel.paged_decode_multi_attention(
            q[:, j:j + 1].contiguous(), kp, vp, table, st + j, **kw)
        if not torch.equal(one[:, 0], out[:, j]):
            raise AssertionError(f"exact kernel: query {j} of a C={C} launch "
                                 f"differs from a C=1 launch ({name})")
    wide = torch.cat([table, torch.zeros_like(table[:, :64])], dim=1)
    for b in range(B if B > 1 else 0):
        alone = paged_kernel.paged_decode_multi_attention(
            q[b:b + 1].contiguous(), kp, vp, wide[b:b + 1].contiguous(),
            st[b:b + 1].contiguous(), **kw)
        if not torch.equal(alone[0], out[b]):
            raise AssertionError(f"exact kernel: row {b} of a B={B} launch "
                                 f"differs from the row alone ({name})")


def kernel_exact_phase(torch) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import paged_kernel
    from repro_torch.kernels.decode_attention.ref import (
        gather_pages, paged_decode_multi_attention_ref,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(6)
    # f32 q and pools: absolute 1e-5 (f32 sums in another order).  bf16
    # output: element by element, one bf16 ulp of each output plus 1e-4
    tol_f32, atol_bf16 = 1e-5, 1e-4
    errs, shares, cases = {}, [], 0
    grid = [(pools, B, C, window, GEOM)
            for pools in ("bfloat16", "float32", "fp8", "int8")
            for B, C, window in ((1, 1, None), (1, VERIFY_C, None),
                                 (8, 1, None), (8, VERIFY_C, None),
                                 (8, VERIFY_C, 1000))]
    grid += [(pools, 8, VERIFY_C, 1000, geom) for pools in ("bfloat16", "fp8")
             for geom in TC_GEOMS]
    for pools, B, C, window, geom in grid:
        page = geom[3]
        n_blocks = 4096 // page + 4
        start = rng.integers(0, 4096 - C + 1, B)
        start[0] = 0 if B > 1 else 4096 - C          # one row at 0
        q, kp, vp, table, st, scales = exact_case(
            torch, rng, B, C, n_blocks, pools, start, dev, geom)
        kw = dict(window=window, **scales)
        for q_in in ((q, q.float()) if scales else (q,)):
            kind = paged_kernel.variant(q_in.dtype, kp.dtype, geom[2],
                                        page)
            out = paged_kernel.paged_decode_multi_attention(
                q_in, kp, vp, table, st, **kw)
            ref = paged_decode_multi_attention_ref(q_in, kp, vp, table,
                                                   st, **kw)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            if q_in.dtype == torch.float32:
                ok, limit = err <= tol_f32, f"{tol_f32}"
            else:
                share = ulp_limit_share(out, ref, atol_bf16)
                shares.append(share)
                ok = share <= 1.0
                limit = (f"2^-7 |ref| + {atol_bf16} per element; worst "
                         f"element at {share:.3g} of it")
            name = f"{pools} pools, q {str(q_in.dtype)[6:]}"
            print(f"  exact kernel vs plain ({kind}): {name} B={B} "
                  f"C={C} H, KVH, D, page={geom} window={window}: max "
                  f"abs err {err:.3g} (tolerance {limit})")
            if not ok:
                raise AssertionError(f"paged_decode_multi_attention "
                                     f"disagrees with its plain version "
                                     f"({name}, B={B}, C={C}): {err}")
            errs[name] = max(errs.get(name, 0.0), err)
            cases += 1
            exact_invariance(torch, paged_kernel, q_in, kp, vp, table,
                             st, out, kw, name)

    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=dev)
    timings = []
    B, C = 8, VERIFY_C
    for ctx in (1024, 4096):
        start = np.full(B, ctx - C)                  # last query at ctx - 1
        q, kp, vp, table, st, _ = exact_case(torch, rng, B, C, ctx // PAGE,
                                             "bfloat16", start, dev)
        # SDPA on the gathered dense view with each row's causal mask: a
        # yardstick the port never calls
        k_d = gather_pages(kp, table).transpose(1, 2)   # (B, KVH, S, D)
        v_d = gather_pages(vp, table).transpose(1, 2)
        pos = st[:, None].long() + torch.arange(C, device=dev)[None, :]
        mask = (torch.arange(ctx, device=dev)[None, None, :]
                <= pos[:, :, None])[:, None]            # (B, 1, C, S)
        q_s = q.transpose(1, 2)                          # (B, H, C, D)
        row = {"ctx": ctx, "B": B, "C": C, "pools": "bfloat16",
               "ms": time_ms(torch, lambda: paged_kernel.paged_decode_multi_attention(
                   q, kp, vp, table, st), flush),
               "plain_ms": time_ms(torch, lambda: paged_decode_multi_attention_ref(
                   q, kp, vp, table, st), flush),
               "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                   q_s, k_d, v_d, attn_mask=mask, enable_gqa=True), flush)}
        row["bound_ms"], row["bound_by"] = paged_bound(start, None, B,
                                                       "bfloat16", 2, C=C,
                                                       geom=GEOM)
        # each slot's live tokens once, for all C queries
        row["stream_read_ms"] = stream_read_ms(torch, 2 * B * ctx * KVH * D * 2,
                                               flush)
        timings.append(ratios(row))
        print("  timing:", json.dumps(row))
    del flush
    head = timings[0]
    return {"name": paged_kernel.NAME_EXACT, "route": "cuda",
            "source": EXACT_SOURCE, "replaces": EXACT_REPLACES,
            "launches": None, "cases": cases,
            "max_abs_err": max(v for k, v in errs.items() if "q bfloat16" in k),
            "max_abs_err_f32": max(v for k, v in errs.items()
                                   if "q float32" in k),
            "max_bf16_limit_share": max(shares),
            "bitwise_invariance": "query j of C=5 == C=1 at start+j; row b "
                                  "of B=8 == the row alone, wider table",
            "headline": f"B 8, C {C}, context 1024, bf16 pools",
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "library": "F.scaled_dot_product_attention(attn_mask=<per-row "
                       "causal mask>, enable_gqa=True) on the gathered view",
            "stream_read_ms": head["stream_read_ms"], "timings": timings}


# ---------------------------------------------------------------------------
# 6b. head dims 80 and 96 and the sliding window (phi3-mini, h2o-danube)
# ---------------------------------------------------------------------------

PHI3, DANUBE = "phi3-mini-3.8b", "h2o-danube-1.8b"
PHI3_GEOM = (32, 32, 96, 16)       # H, KVH, D, page: full MHA (rep 1)
DANUBE_GEOM = (32, 8, 80, 16)      # GQA rep 4
DANUBE_WINDOW = 4096
# their MXFP4 launches (K, Ns): q/k/v grouped, o, gate/up grouped, down
PHI3_LAUNCHES = {"qkv": (3072, (3072, 3072, 3072)), "wo": (3072, (3072,)),
                 "gate/up": (3072, (8192, 8192)), "w_down": (8192, (3072,))}
DANUBE_LAUNCHES = {"qkv": (2560, (2560, 640, 640)), "wo": (2560, (2560,)),
                   "gate/up": (2560, (6912, 6912)),
                   "w_down": (6912, (2560,))}
HEADDIM_VMM_ROWS = (8, 2048)       # a decode step of 8 slots; 8 chunk rows


def ring_table(table, pos, window, page):
    """A ring space's view of ``table``: the blocks wholly behind each
    row's window point at the (poisoned) scratch page 0, as
    ``RingPageSpace.reclaim`` leaves them."""
    first = np.maximum(pos - window + 1, 0) // page
    dead = np.arange(table.shape[1])[None, :] < first[:, None]
    return np.where(dead, 0, table).astype(np.int32)


class KernelHolds:
    """Holds kernels against their plain versions at the tolerances of the
    D 64 / 128 phases (f32: 1e-5; bf16 flash: 2^-6 of each row's largest
    value; other bf16: one bf16 ulp + 1e-4 per element), printing each
    case, keeping each kernel's worst error by dtype, and makes the
    kernels-line entries from those (``launches`` set later from the
    serve phases)."""
    ATOL_BF16, TOL_F32, FLASH_TOL = 1e-4, 1e-5, 2.0 ** -6

    def __init__(self, torch):
        self.torch = torch
        self.worst = {}            # "kernel:dtype" -> worst max abs err
        self.checked = []

    def hold(self, name, label, out, ref, bf16_rel=False):
        self.torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if out.dtype == self.torch.float32:
            ok, measure, limit = err <= self.TOL_F32, err, f"{self.TOL_F32}"
        elif bf16_rel:
            measure = row_rel_err(out, ref)
            ok, limit = (measure <= self.FLASH_TOL,
                         f"{self.FLASH_TOL:.3g} per row")
        else:
            measure = ulp_limit_share(out, ref, self.ATOL_BF16)
            ok, limit = (measure <= 1.0,
                         f"2^-7 |ref| + {self.ATOL_BF16} per element")
        print(f"  {name} vs plain: {label}: max abs err {err:.3g}, measure "
              f"{measure:.3g} (tolerance {limit})")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"at {label}: {measure} ({limit})")
        key = (f"{name}:"
               f"{'f32' if out.dtype == self.torch.float32 else 'bf16'}")
        self.worst[key] = max(self.worst.get(key, 0.0), err)
        self.checked.append(label)

    def entry(self, name, source, replaces, row, label, **extra) -> dict:
        kernel = name.split(":")[0]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": None,
                "max_abs_err": self.worst[f"{kernel}:bf16"],
                "max_abs_err_f32": self.worst.get(f"{kernel}:f32"),
                "headline": label, "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row.get("library_ms"), **extra}


def kernel_headdims_phase(torch) -> dict:
    """Every attention kernel at the head dims of phi3-mini (D 96, rep 1)
    and h2o-danube (D 80, rep 4), and the flash kernel's sliding window,
    held against the plain versions (the tolerances of the D 64 / 128
    phases) and timed at the two models' serve shapes; and ``mxfp4_vmm`` at
    their projections.  Returns one kernel line entry per new variant (its
    ``launches`` are set from the serve phases)."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import kernel as dense_kernel
    from repro_torch.kernels.decode_attention import paged_kernel
    from repro_torch.kernels.decode_attention.ref import (
        gather_pages, paged_decode_attention_ref,
        paged_decode_multi_attention_ref, paged_valid_mask,
    )
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention.ops import gqa_flash_attention
    from repro_torch.kernels.mxfp4_vmm import kernel as vmm_kernel
    from repro_torch.kernels.mxfp4_vmm.ref import mxfp4_vmm_ref
    from repro_torch.models.common import decode_attention_ref
    from repro_torch.quant import formats
    from repro_torch.quant import kv as kvq

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    rng = np.random.default_rng(23)
    holds = KernelHolds(torch)
    hold, entry, worst = holds.hold, holds.entry, holds.worst

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # -- flash: D 96 (MHA) and D 80 (GQA 4:1), windows below, at and past a
    # key tile (96 keys), the window of a single key, causal or not; an
    # MHA head count past an item (rep 136: the mma.sync kernel)
    flash_cases = [(2, 1000, 32, 32, 96, None), (1, 1024, 32, 32, 96, 500),
                   (2, 1000, 32, 8, 80, None), (1, 3000, 32, 8, 80, 1000),
                   (2, 700, 32, 8, 80, 100), (1, 300, 32, 8, 80, 1),
                   (1, 300, 136, 1, 80, 100), (1, 300, 136, 1, 96, None)]
    for dtype_name in ("bfloat16", "float32"):
        for B, S, h, kvh, d, window in flash_cases:
            for causal in (True, False):
                dt = getattr(torch, dtype_name)
                q, k, v = randn(B, S, h, d, dtype=dt), randn(B, S, kvh, d, dtype=dt), \
                    randn(B, S, kvh, d, dtype=dt)
                kind = flash_kernel.variant(dt, d, h // kvh)
                out = flash_kernel.flash_attention(q, k, v, causal=causal,
                                                   window=window)
                ref = gqa_flash_attention(q, k, v, causal=causal,
                                          window=window, impl="reference")
                hold("flash_attention", f"{kind} {dtype_name} B={B} S={S} "
                     f"H={h} KVH={kvh} D={d} causal={causal} "
                     f"window={window}", out, ref, bf16_rel=True)
                del q, k, v, out, ref

    # -- dense decode: D 96 rep 1 and D 80 rep 4, ragged cur_len, the tail
    # poisoned; a full 4096-entry cache (danube's wrapped ring)
    for dtype_name in ("bfloat16", "float32"):
        for h, kvh, d in (PHI3_GEOM[:3], DANUBE_GEOM[:3]):
            for B, S in ((1, 2048), (8, 4096)):
                cur_len = rng.integers(1, S + 1, B)
                cur_len[0] = S
                q, k, v, cl = dense_case(torch, gen, B, S,
                                         getattr(torch, dtype_name), cur_len,
                                         dev, h, kvh, d)
                kind = dense_kernel.variant(q.dtype, k.dtype, d)
                hold("decode_attention", f"{kind} {dtype_name} B={B} S={S} "
                     f"H={h} KVH={kvh} D={d}",
                     dense_kernel.decode_attention(q, k, v, cl),
                     decode_attention_ref(q, k, v, cl))

    # -- paged online and exact, bf16 / f32 / fp8 / int8 pools, windows,
    # and a ring table whose blocks behind the window are the scratch page
    for geom in (PHI3_GEOM, DANUBE_GEOM):
        h, kvh, d, page = geom
        for pools in ("bfloat16", "float32", "fp8", "int8"):
            for B, window, ring in ((8, None, False), (8, 1000, True),
                                    (8, 1, False)):
                n_blocks = 4096 // page + 4
                pos = rng.integers(0, 4096, B)
                pos[0] = page + page // 2
                if pools in ("fp8", "int8"):
                    q, kp, vp, ks, vs, table, p = quantized_case(
                        torch, rng, B, n_blocks, pools, pos, dev, geom)
                    scales = dict(k_scales=ks, v_scales=vs)
                    qs = (q, q.float())
                else:
                    q, kp, vp, table, p = paged_case(
                        torch, rng, B, n_blocks, getattr(torch, pools), pos,
                        dev, geom)
                    scales, qs = {}, (q,)
                if ring:
                    table = torch.as_tensor(ring_table(
                        table.cpu().numpy(), pos, window, page), device=dev)
                for q_in in qs:
                    kind = paged_kernel.variant(q_in.dtype, kp.dtype, d, page)
                    label = (f"{kind} {pools} pools q {str(q_in.dtype)[6:]} "
                             f"B={B} H, KVH, D, page={geom} window={window}"
                             f"{' ring table' if ring else ''}")
                    hold(paged_kernel.NAME_SCALED if scales else
                         paged_kernel.NAME, label,
                         paged_kernel.paged_decode_attention(
                             q_in, kp, vp, table, p, window=window, **scales),
                         paged_decode_attention_ref(
                             q_in, kp, vp, table, p, window=window, **scales))
    for geom in (PHI3_GEOM, DANUBE_GEOM):
        h, kvh, d, page = geom
        for pools in ("bfloat16", "float32", "fp8", "int8"):
            for B, C, window in ((1, 1, None), (8, VERIFY_C, None),
                                 (8, VERIFY_C, 1000)):
                n_blocks = 4096 // page + 4
                start = rng.integers(0, 4096 - C + 1, B)
                start[0] = 0
                q, kp, vp, table, st, scales = exact_case(
                    torch, rng, B, C, n_blocks, pools, start, dev, geom)
                kw = dict(window=window, **scales)
                for q_in in ((q, q.float()) if scales else (q,)):
                    kind = paged_kernel.variant(q_in.dtype, kp.dtype, d, page)
                    out = paged_kernel.paged_decode_multi_attention(
                        q_in, kp, vp, table, st, **kw)
                    name = f"{pools} pools, q {str(q_in.dtype)[6:]}"
                    hold(paged_kernel.NAME_EXACT, f"{kind} {name} B={B} C={C} "
                         f"H, KVH, D, page={geom} window={window}", out,
                         paged_decode_multi_attention_ref(q_in, kp, vp, table,
                                                          st, **kw))
                    exact_invariance(torch, paged_kernel, q_in, kp, vp, table,
                                     st, out, kw, name)

    # -- mxfp4_vmm at phi3's and danube's launches
    vmm_err = 0.0
    weights = {}

    def weight(k, n):
        if (k, n) not in weights:
            w = torch.randn((k, n), generator=gen, device=dev) * 0.02
            weights[(k, n)] = formats.quantize_mxfp4(w.to(torch.bfloat16))
        return weights[(k, n)]

    for launches in (PHI3_LAUNCHES, DANUBE_LAUNCHES):
        for k, ns in launches.values():
            for m in HEADDIM_VMM_ROWS:
                ws = [(weight(k, n).codes, weight(k, n).scales) for n in ns]
                err, sched, _ = hold_vmm(torch, randn(m, k), ws)
                vmm_err = max(vmm_err, err)
                print(f"  mxfp4_vmm vs plain: M={m} K={k} N={list(ns)} "
                      f"({sched}): max rel err {err:.3g} (tolerance {VMM_TOL})")

    # -- timings at the serve shapes, the L2 flushed
    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=dev)
    entries = []

    for name, (B, S, h, kvh, d, window, label) in (
            ("flash_attention:D96", (8, 1024, 32, 32, 96, None,
                                     "phi3 prefill: B 8, S 1024, H = KVH = 32, "
                                     "D 96, causal")),
            ("flash_attention:D80:window4096",
             (2, 6144, 32, 8, 80, DANUBE_WINDOW,
              "danube prefill: B 2, S 6144, H 32, KVH 8, D 80, causal, "
              "window 4096")),
            ("flash_attention:D80", (2, 6144, 32, 8, 80, None,
                                     "the same without the window"))):
        q, k, v = randn(B, S, h, d), randn(B, S, kvh, d), randn(B, S, kvh, d)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        if window is None:
            lib = lambda: F.scaled_dot_product_attention(     # noqa: E731
                qt, kt, vt, is_causal=True, enable_gqa=True)
            library = "F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)"
        else:
            i = torch.arange(S, device=dev)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
            lib = lambda: F.scaled_dot_product_attention(     # noqa: E731
                qt, kt, vt, attn_mask=mask, enable_gqa=True)
            library = ("F.scaled_dot_product_attention(attn_mask=<causal "
                       "window mask>, enable_gqa=True)")
        row = {"ms": time_ms(torch, lambda: flash_kernel.flash_attention(
                   q, k, v, causal=True, window=window), flush),
               "plain_ms": time_ms(torch, lambda: gqa_flash_attention(
                   q, k, v, causal=True, window=window, impl="reference"),
                   flush, iters=5),
               "library_ms": time_ms(torch, lib, flush)}
        row["bound_ms"], row["bound_by"] = flash_bound(
            B, S, S, h, kvh, True, 2, "bfloat16", d=d, window=window)
        print(f"  timing {name}:", json.dumps(ratios(row)))
        if window is None and d == 80:
            # not on danube's path (every layer windowed): a yardstick of
            # the window's saving, kept beside the windowed entry
            entries[-1]["without_window"] = {**row, "headline": label}
        else:
            entries.append(entry(name, FLASH_SOURCE, FLASH_REPLACES, row,
                                 label, variant=flash_kernel.variant(
                                     q.dtype, d, h // kvh), library=library))
        del q, k, v, qt, kt, vt

    for name, (B, S, ctx, geom, label) in (
            ("decode_attention:D96", (8, 2048, 1088, PHI3_GEOM,
                                      "phi3 static decode: B 8, rep 1, "
                                      "cur_len 1088 of 2048")),
            ("decode_attention:D80", (2, 4096, 4096, DANUBE_GEOM,
                                      "danube static decode: B 2, rep 4, a "
                                      "wrapped 4096-entry ring (cur_len 4096)"))):
        h, kvh, d, _ = geom
        cur_len = np.full(B, ctx)
        q, k, v, cl = dense_case(torch, gen, B, S, torch.bfloat16, cur_len,
                                 dev, h, kvh, d)
        q4, ks_, vs_ = q[:, :, None, :], k[:, :ctx].transpose(1, 2), \
            v[:, :ctx].transpose(1, 2)
        row = {"ms": time_ms(torch, lambda: dense_kernel.decode_attention(
                   q, k, v, cl), flush),
               "plain_ms": time_ms(torch, lambda: decode_attention_ref(
                   q, k, v, cl), flush),
               "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                   q4, ks_, vs_, enable_gqa=True), flush)}
        row["bound_ms"], row["bound_by"] = dense_bound(cur_len, B, 2,
                                                       "bfloat16", h, kvh, d)
        print(f"  timing {name}:", json.dumps(ratios(row)))
        entries.append(entry(name, DENSE_SOURCE, DENSE_REPLACES, row, label,
                             variant=dense_kernel.variant(q.dtype, k.dtype, d),
                             library="F.scaled_dot_product_attention("
                                     "enable_gqa=True) on the cache sliced "
                                     "to cur_len"))
        del q, k, v, ks_, vs_

    for name, (B, ctx, window, geom, pools, label) in (
            ("paged_decode_attention:D96",
             (8, 1024, None, PHI3_GEOM, "bfloat16",
              "phi3 decode: B 8, rep 1, ctx 1024, bf16 pools")),
            ("paged_decode_attention:D80:window4096",
             (8, 6144, DANUBE_WINDOW, DANUBE_GEOM, "bfloat16",
              "danube decode: B 8, rep 4, ctx 6144, window 4096, the blocks "
              "behind it on the scratch page")),
            ("paged_decode_attention_scaled:D96",
             (8, 1024, None, PHI3_GEOM, "fp8",
              "phi3 decode: B 8, rep 1, ctx 1024, fp8 pools")),
            ("paged_decode_attention_scaled:D80:window4096",
             (8, 6144, DANUBE_WINDOW, DANUBE_GEOM, "fp8",
              "danube decode: B 8, rep 4, ctx 6144, window 4096, fp8 "
              "pools"))):
        h, kvh, d, page = geom
        pos = np.full(B, ctx - 1)
        if pools == "fp8":
            q, kp, vp, ks, vs, table, p = quantized_case(
                torch, rng, B, ctx // page, "fp8", pos, dev, geom)
            scales = dict(k_scales=ks, v_scales=vs)
            k_d = kvq.kv_dequantize(gather_pages(kp, table),
                                    gather_pages(ks, table), torch.bfloat16)
            v_d = kvq.kv_dequantize(gather_pages(vp, table),
                                    gather_pages(vs, table), torch.bfloat16)
        else:
            q, kp, vp, table, p = paged_case(torch, rng, B, ctx // page,
                                             torch.bfloat16, pos, dev, geom)
            scales = {}
            k_d, v_d = gather_pages(kp, table), gather_pages(vp, table)
        if window is not None:
            table = torch.as_tensor(ring_table(table.cpu().numpy(), pos,
                                               window, page), device=dev)
        mask = paged_valid_mask(table, page, p, window=window)[:, None, None, :]
        sd = sdpa_ms(torch, F, q, k_d.transpose(1, 2), v_d.transpose(1, 2),
                     mask, flush)
        row = {"ms": time_ms(torch, lambda: paged_kernel.paged_decode_attention(
                   q, kp, vp, table, p, window=window, **scales), flush),
               "plain_ms": time_ms(torch, lambda: paged_decode_attention_ref(
                   q, kp, vp, table, p, window=window, **scales), flush),
               "library_ms": min(sd.values())}
        row["bound_ms"], row["bound_by"] = paged_bound(
            pos, window, B, "fp8" if scales else "bfloat16",
            1 if scales else 2, q_itemsize=2,
            scale_itemsize=4 if scales else 0, geom=geom)
        print(f"  timing {name}:", json.dumps(ratios(row)))
        entries.append(entry(
            name, KERNEL_SOURCE, REPLACES + (" (k_scales/v_scales branch)"
                                             if scales else ""), row, label,
            variant=paged_kernel.variant(q.dtype, kp.dtype, d, page),
            library=("the faster of SDPA(enable_gqa=True) and SDPA on K/V "
                     "repeated to H heads, on the gathered"
                     + (" dequantized bf16" if scales else "") + " view")))
        del q, kp, vp, k_d, v_d

    B, C, ctx = 8, VERIFY_C, 1024
    h, kvh, d, page = PHI3_GEOM
    start = np.full(B, ctx - C)
    q, kp, vp, table, st, _ = exact_case(torch, rng, B, C, ctx // page,
                                         "bfloat16", start, dev, PHI3_GEOM)
    k_d = gather_pages(kp, table).transpose(1, 2)
    v_d = gather_pages(vp, table).transpose(1, 2)
    posq = st[:, None].long() + torch.arange(C, device=dev)[None, :]
    mask = (torch.arange(ctx, device=dev)[None, None, :]
            <= posq[:, :, None])[:, None]
    q_s = q.transpose(1, 2)
    row = {"ms": time_ms(torch, lambda: paged_kernel.paged_decode_multi_attention(
               q, kp, vp, table, st), flush),
           "plain_ms": time_ms(torch, lambda: paged_decode_multi_attention_ref(
               q, kp, vp, table, st), flush),
           "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
               q_s, k_d, v_d, attn_mask=mask, enable_gqa=True), flush)}
    row["bound_ms"], row["bound_by"] = paged_bound(start, None, B, "bfloat16",
                                                   2, C=C, geom=PHI3_GEOM)
    print("  timing paged_decode_attention_exact:D96:", json.dumps(ratios(row)))
    entries.append(entry(
        "paged_decode_attention_exact:D96", EXACT_SOURCE, EXACT_REPLACES, row,
        "phi3 verify step: B 8, C 5, rep 1, ctx 1024, bf16 pools",
        variant=paged_kernel.variant(q.dtype, kp.dtype, d, page),
        library="F.scaled_dot_product_attention(attn_mask=<per-row causal "
                "mask>, enable_gqa=True) on the gathered view"))
    del q, kp, vp, k_d, v_d

    for model_name, launches in (("phi3", PHI3_LAUNCHES),
                                 ("danube", DANUBE_LAUNCHES)):
        per_m = {}
        for m in HEADDIM_VMM_ROWS:
            ms = plain = lib = bnd = 0.0
            for k, ns in launches.values():
                ps = [weight(k, n) for n in ns]
                ws = [(p.codes, p.scales) for p in ps]
                x = randn(m, k)
                ms += time_ms(torch, lambda: vmm_kernel.mxfp4_vmm_group(
                    x, ws, torch.bfloat16), flush)
                plain += sum(time_ms(torch, lambda p=p: mxfp4_vmm_ref(
                    x, p.codes, p.scales).to(torch.bfloat16), flush, iters=10)
                    for p in ps)
                dq = [formats.dequantize_mxfp4(p, torch.bfloat16) for p in ps]
                lib += sum(time_ms(torch, lambda w=w: torch.matmul(x, w), flush)
                           for w in dq)
                bnd += vmm_bound(m, k, ns)[0]
                del dq
            per_m[m] = {"ms": ms, "plain_ms": plain, "bf16_matmul_ms": lib,
                        "bound_ms": bnd}
            print(f"  timing mxfp4_vmm:{model_name} layer M {m}:",
                  json.dumps(per_m[m]))
        head = per_m[8]
        entries.append({
            "name": f"mxfp4_vmm:{model_name}", "route": "cuda",
            "source": VMM_SOURCE, "replaces": VMM_REPLACES, "launches": None,
            "max_abs_err": vmm_err, "max_abs_err_is": "relative to max |out|",
            "headline": f"one {model_name} layer at M 8 in the serve path's 4 "
                        f"launches (q/k/v grouped, o, gate/up grouped, down)",
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "bf16_matmul_ms": head["bf16_matmul_ms"],
            "layer_m2048": per_m[2048]})
    del flush, weights
    return {"phase": "kernel_headdims", "checked": len(holds.checked),
            "worst": worst, "mxfp4_vmm_max_rel_err": vmm_err,
            "entries": entries}


# ---------------------------------------------------------------------------
# 7. quantize phase: the card's bits are the CPU's
# ---------------------------------------------------------------------------


MLA_FLASH = (192, 128)     # deepseek-v2-lite: q.k over hd 128 + rope 64, v_hd 128
DS_HEADS = 16              # its query heads (the expansion makes KVH = H)


def sdpa_backends_ms(torch, q, k, v, causal, flush) -> dict:
    """``F.scaled_dot_product_attention`` on (B, H, S, .) views under each
    backend alone (``sdpa_kernel``): its time, or None where the backend
    refuses the call.  A yardstick the port never calls."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    out = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                F.scaled_dot_product_attention(q, k, v, is_causal=causal)
                torch.cuda.synchronize()
                out[backend.name] = time_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=causal), flush, iters=10)
        except RuntimeError:
            out[backend.name] = None
    return out


def kernel_flash_mla_phase(torch) -> dict:
    """The flash kernel at MLA's head dims (D 192 of q/k, Dv 128 of v):
    every variant (fma in f32; wgmma and mma.sync in bf16, the second
    forced with ``kind="mma"``) held against the plain version at
    deepseek-v2-lite's static prefill shapes (B 8, S 1024, H = KVH = 16,
    causal and not), a ragged S 1000, a GQA 4:1 case and an MHA head count
    past an item (rep 136), at the flash tolerances (bf16: 2^-6 of each
    row's largest value; f32: 1e-5).  Then each variant timed at B 8, S
    1024, causal, beside its bound, the plain version and SDPA under each
    of its backends (the fastest that takes the call is ``library_ms``).
    Returns one kernels-line entry (``launches`` set from
    serve_mla_static)."""
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention.ops import gqa_flash_attention

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(24)
    holds = KernelHolds(torch)
    d, dv = MLA_FLASH

    def inputs(B, S, h, kvh, dtype):
        return (torch.randn((B, S, h, d), generator=gen, device=dev).to(dtype),
                torch.randn((B, S, kvh, d), generator=gen, device=dev).to(dtype),
                torch.randn((B, S, kvh, dv), generator=gen, device=dev).to(dtype))

    cases = [(8, 1024, DS_HEADS, DS_HEADS, True),
             (8, 1024, DS_HEADS, DS_HEADS, False),
             (2, 1000, DS_HEADS, DS_HEADS, True),      # ragged S
             (2, 1000, DS_HEADS, 4, False),            # GQA 4:1
             (1, 300, 136, 1, True)]                   # past an item
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        for B, S, h, kvh, causal in cases:
            q, k, v = inputs(B, S, h, kvh, dt)
            ref = gqa_flash_attention(q, k, v, causal=causal,
                                      impl="reference")
            chosen = flash_kernel.variant(dt, d, h // kvh, dv)
            kinds = [chosen] + (["mma"] if chosen == "wgmma" else [])
            for kind in kinds:
                out = flash_kernel.flash_attention(q, k, v, causal=causal,
                                                   kind=kind)
                holds.hold("flash_attention", f"{kind} {dtype_name} B={B} "
                           f"S={S} H={h} KVH={kvh} D={d} Dv={dv} "
                           f"causal={causal}", out, ref, bf16_rel=True)
                del out
            del q, k, v, ref

    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=dev)
    B, S, h = 8, 1024, DS_HEADS
    q, k, v = inputs(B, S, h, h, torch.bfloat16)
    row = {"B": B, "S": S, "H": h, "D": d, "Dv": dv, "causal": True,
           "dtype": "bfloat16",
           "ms": time_ms(torch, lambda: flash_kernel.flash_attention(
               q, k, v, causal=True), flush),
           "mma_ms": time_ms(torch, lambda: flash_kernel.flash_attention(
               q, k, v, causal=True, kind="mma"), flush, iters=10),
           "plain_ms": time_ms(torch, lambda: gqa_flash_attention(
               q, k, v, causal=True, impl="reference"), flush, iters=5)}
    sdpa = sdpa_backends_ms(torch, q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), True, flush)
    ran = {name: t for name, t in sdpa.items() if t is not None}
    library = min(ran, key=ran.get) if ran else None
    row.update(sdpa_ms_by_backend=sdpa,
               library_ms=ran[library] if library else None,
               library=(f"F.scaled_dot_product_attention(is_causal=True), "
                        f"backend {library}" if library else None))
    row["bound_ms"], row["bound_by"] = flash_bound(
        B, S, S, h, h, True, 2, "bfloat16", d=d, dv=dv)
    qf, kf, vf = q.float(), k.float(), v.float()
    row["fma_f32_ms"] = time_ms(torch, lambda: flash_kernel.flash_attention(
        qf, kf, vf, causal=True), flush, iters=5)
    row["fma_f32_bound_ms"] = flash_bound(B, S, S, h, h, True, 4, "float32",
                                          d=d, dv=dv)[0]
    print("  timing flash D 192 / Dv 128:", json.dumps(ratios(row)))
    del q, k, v, qf, kf, vf, flush
    return {"phase": "kernel_flash_mla", "checked": len(holds.checked),
            "entry": holds.entry(
                "flash_attention:D192_Dv128", FLASH_SOURCE, FLASH_REPLACES,
                row, "deepseek-v2-lite static prefill of one layer: B 8, "
                     "S 1024, H = KVH = 16, D 192 / Dv 128, causal, bf16",
                variant="wgmma", mma_ms=row["mma_ms"],
                fma_f32_ms=row["fma_f32_ms"], library=row["library"],
                sdpa_ms_by_backend=sdpa)}


def quantize_phase(torch) -> dict:
    from repro_torch.quant import formats
    from repro_torch.quant import kv as kvq

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    w = (torch.randn((4096, 14336), generator=gen, device=dev) * 0.02).to(
        torch.bfloat16)                          # one llama3-8b w_gate
    w[:32, 0] = 0.0                              # a zero block
    w[32:64, 1] *= 0.0
    w[40, 1] = 2.0 ** -13                        # amax an exact power of two
    on_card, on_cpu = formats.quantize_mxfp4(w), formats.quantize_mxfp4(w.cpu())
    same_w = (torch.equal(on_card.codes.cpu(), on_cpu.codes)
              and torch.equal(on_card.scales.cpu(), on_cpu.scales))
    kvals = w[:, :1024].reshape(4096, KVH, D)    # 4096 tokens' K of a layer
    kv_diff = {}
    for cache_dtype in ("fp8", "int8"):
        c1, s1 = kvq.kv_quantize(kvals, cache_dtype)
        c2, s2 = kvq.kv_quantize(kvals.cpu(), cache_dtype)
        kv_diff[cache_dtype] = {
            "codes": int((kvq.raw_view(c1).cpu() != kvq.raw_view(c2)).sum()),
            "scales": int((s1.cpu() != s2).sum())}
    same_kv = not any(n for d in kv_diff.values() for n in d.values())
    if not (same_w and same_kv):
        raise AssertionError(f"quantization differs between card and CPU: "
                             f"mxfp4 equal {same_w}, kv differences {kv_diff}")
    return {"phase": "quantize", "mxfp4_bits_equal": same_w,
            "kv_bits_equal": same_kv, "weight": "(4096, 14336) bf16"}


# ---------------------------------------------------------------------------
# 8. deployment phase: DeploymentSpec pricing, no weights allocated
# ---------------------------------------------------------------------------

# (config, weight_format, cache_dtype); llama3-405b cannot fit one H100
DEPLOYMENTS = (("llama3-8b", None, None), ("llama3-8b", "mxfp4", "fp8"),
               ("llama3-70b", "mxfp4", "fp8"), ("llama3-405b", "mxfp4", "fp8"))
DEPLOY_MAX_LEN = 2048
# deepseek-v2-lite-16b (MLA + MoE) on one H100: bf16 and mxfp4 weights
# over bf16 latent pools resolve; an fp8 cache must raise (MLA latent
# pools have no quantized form)
DEPLOYMENTS_MLA = (("deepseek-v2-lite-16b", None, None),
                   ("deepseek-v2-lite-16b", "mxfp4", None),
                   ("deepseek-v2-lite-16b", None, "fp8"))


def deployment_phase(torch) -> dict:
    """Resolve ``DeploymentSpec(sku="h100")`` and ``sku="rpu-cu"`` (one
    RPU compute unit over the default HBM-CO candidate) for each of
    ``DEPLOYMENTS``, pricing the weights exactly from a ``meta``-device
    model (shapes only).  llama3-405b must raise ``DeploymentError`` on one
    H100; nothing may be allocated on the card.  Each resolved budget is
    printed beside the card's ``torch.cuda.mem_get_info()`` total.  Then
    ``DEPLOYMENTS_MLA`` on h100: deepseek-v2-lite-16b resolves with bf16
    and with mxfp4 weights, and an fp8 cache raises."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.runtime.deployment import DeploymentError, DeploymentSpec

    free, total = torch.cuda.mem_get_info()
    allocated = torch.cuda.memory_allocated()
    rows = []
    for sku, name, fmt, cache in (
            [(sku, *d) for sku in ("h100", "rpu-cu") for d in DEPLOYMENTS]
            + [("h100", *d) for d in DEPLOYMENTS_MLA]):
        model = Model(get_config(name), device="meta")
        spec = DeploymentSpec(sku=sku, weight_format=fmt,
                              cache_dtype=cache, max_len=DEPLOY_MAX_LEN)
        row = {"sku": sku, "model": name, "weight_format": fmt,
               "cache_dtype": cache, "max_len": DEPLOY_MAX_LEN}
        try:
            dep = spec.resolve(model, params=model)
        except DeploymentError as e:
            row["deployment_error"] = str(e)
        else:
            row.update(dep.as_dict(),
                       pool_bytes_per_device=dep.pool_bytes_per_device)
            print(f"  {name} {fmt or 'bf16'} {cache or 'bf16'} on {sku}"
                  f" (card total {total / 2 ** 30:.2f} GiB):")
            for line in dep.describe().splitlines():
                print("    " + line)
        print("  deployment:", json.dumps(row))
        rows.append(row)
    refused = {(r["sku"], r["model"]) for r in rows
               if "deployment_error" in r}
    if ("h100", "llama3-405b") not in refused:
        raise AssertionError("llama3-405b resolved on one H100; it must "
                             "raise DeploymentError")
    for name, _, _ in DEPLOYMENTS[:3]:
        if ("h100", name) in refused:
            raise AssertionError(f"{name} did not resolve on one H100")
    mla = {(r["weight_format"], r["cache_dtype"]): r for r in rows
           if r["model"] == DEPLOYMENTS_MLA[0][0]}
    for (fmt, cache), r in mla.items():
        if ("deployment_error" in r) != (cache == "fp8") or (
                cache == "fp8" and "MLA" not in r["deployment_error"]):
            raise AssertionError(f"deepseek-v2-lite-16b {fmt} {cache} on one "
                                 f"H100: {r.get('deployment_error', 'resolved')}"
                                 f"; bf16 pools must resolve, fp8 must raise "
                                 f"DeploymentError naming MLA")
    if torch.cuda.memory_allocated() != allocated:
        raise AssertionError("pricing allocated memory on the card")
    return {"phase": "deployment", "card_mem_total_bytes": total,
            "card_mem_free_bytes": free,
            "h100_capacity_bytes_modeled": next(
                r["capacity_bytes"] for r in rows if r["sku"] == "h100"
                and "capacity_bytes" in r),
            "rows": rows}


# ---------------------------------------------------------------------------
# 9, 11-13. continuous serve phases (bf16 with prompt scoring; mxfp4 + fp8;
# speculative: self-draft, legacy, truncated draft)
# ---------------------------------------------------------------------------

PROMPT_LENS = [128, 1024, 300, 612, 777, 200, 450, 712]
SHARED = (3, 7)           # requests 3 and 7 share a 512-token prefix


def serve_requests(sp_cls, vocab: int):
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, vocab, 512)
    prompts = []
    for i, n in enumerate(PROMPT_LENS):
        tail = rng.integers(0, vocab, n - (512 if i in SHARED else 0))
        prompts.append(np.concatenate([prefix, tail]) if i in SHARED else tail)
    sps = []
    for i in range(len(PROMPT_LENS)):
        if i % 2 == 0:
            sps.append(sp_cls(max_tokens=64))
        else:
            sps.append(sp_cls(max_tokens=64, temperature=0.8, top_p=0.9,
                              top_k=40, seed=1000 + i))
    return prompts, sps


def serve_session(llm, prompts, sps, on_decode_step=None, late=SHARED,
                  watch=None):
    """One session through the incremental interface.  With ``late`` =
    (first, then), request ``then`` is added once request ``first`` has its
    first token (in the llama mix, 3 and 7: 3's prompt blocks are indexed
    and 7 shares them); with ``late=None`` every request is added at once.
    ``on_decode_step`` runs after every step taken once every request has
    its first token (decode-only steps).  ``watch`` (e.g. ``RingWatch``)
    is started after the reset, read after every step and stopped at the
    end.  Returns (streams, finished outputs, stats, decode-only step
    seconds)."""
    llm.reset()
    if watch is not None:
        watch.start(llm)
    for i, (p, sp) in enumerate(zip(prompts, sps)):
        if late is None or i != late[1]:
            llm.add_request(p, sp, rid=i)
    streams = {i: [] for i in range(len(prompts))}
    finished = {}
    decode_steps = []
    added_late = late is None
    try:
        while llm.has_unfinished() or not added_late:
            all_started = added_late and all(streams.values())
            t = time.perf_counter()
            outs = llm.step()              # ends in a device -> host copy
            if all_started:
                decode_steps.append(time.perf_counter() - t)
                if on_decode_step is not None:
                    on_decode_step()
            for o in outs:
                streams[o.rid].extend(o.new_token_ids)
                if o.finished:
                    finished[o.rid] = o
            if watch is not None:
                watch.step()
            if not added_late and streams[late[0]]:
                llm.add_request(prompts[late[1]], sps[late[1]], rid=late[1])
                added_late = True
    finally:
        if watch is not None:
            watch.stop()
    return streams, finished, llm.stats(), decode_steps


PROFILE = dict(wait=4, warmup=2, active=8, repeat=1)   # decode-only steps
# the host's waits for the device (as scripts/host_syncs.py counts them): a
# synchronize, or a host-to-device copy from pageable memory
HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "Memcpy HtoD (Pageable -> Device)")


# the model's named profiler ranges (``models.common.span``): GQA and MLA
# attention (projections in, attention, no output projection), the SSM
# mixer (in projections to out projection), MoE dispatch / experts /
# combine, and the head
SPANS = ("gqa_attention", "mla_attention", "ssm_mixer", "moe_dispatch",
         "moe_experts", "moe_combine", "head")


def trace_summary(prof) -> dict:
    """One pass over a ``torch.profiler`` trace's raw events
    (``prof.profiler.kineto_results``): device time (us) by kernel name;
    device time (ms) of the kernels launched inside each of the model's
    named ranges (``SPANS``; a kernel counts in a range when the host op
    or range it is linked to starts inside it on the same thread, as a
    host-side range's ``device_time_total`` counts the kernels of the ops
    under it); host self time (us) by op name (an event's time less its
    direct children's on its thread; the step and named ranges left
    out); and the count of each host wait (``HOST_WAITS``).  The
    profiler's own ``events()`` / ``key_averages()`` build a
    ``FunctionEvent`` tree first, ~70 us of host time an event: tens of
    seconds for a trace of a few steps of a 32-layer stateful model.  The
    device-side copies of the named ranges (first kernel to last, idle
    gaps included) are not device activity and count nowhere."""
    import bisect

    from torch.autograd import DeviceType

    device, linked, waits = {}, [], {}
    host = {}                     # thread -> [(start, end, name, id)]
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name in HOST_WAITS:
            waits[name] = waits.get(name, 0) + 1
        if e.device_type() == DeviceType.CUDA:
            # device activity (kernels, copies, memsets); each step and
            # named range is also recorded as a device-side range
            # spanning its kernels, which is not
            if name not in SPANS and not name.startswith("ProfilerStep"):
                device[name] = device.get(name, 0.0) + e.duration_ns() / 1e3
                linked.append((e.linked_correlation_id(), e.duration_ns()))
        elif not e.is_async():
            start = e.start_ns()
            host.setdefault(e.start_thread_id(), []).append(
                (start, start + e.duration_ns(), name, e.correlation_id()))
    self_us, starts, ranges = {}, {}, {}
    for tid, evs in host.items():
        evs.sort(key=lambda r: (r[0], -r[1]))
        stack = []                # open ancestors: [end, name, self ns]
        for start, end, name, cid in evs:
            while stack and stack[-1][0] <= start:
                done = stack.pop()
                self_us[done[1]] = self_us.get(done[1], 0.0) + done[2] / 1e3
            if stack:
                stack[-1][2] -= end - start
            stack.append([end, name, end - start])
            # runtime and driver calls (cuda*, cu*) carry the device's
            # correlation ids; ops and ranges are what a kernel links to
            if not name.startswith("cu"):
                starts[cid] = (tid, start)
                if name in SPANS:
                    ranges.setdefault(tid, []).append((start, end, name))
        for _, name, ns in stack:
            self_us[name] = self_us.get(name, 0.0) + ns / 1e3
    # the named ranges do not nest in one another: the last one to start
    # at or before a launch is the only one that can hold it
    for r in ranges.values():
        r.sort()
    heads = {tid: [r[0] for r in rs] for tid, rs in ranges.items()}
    spans = {}
    for cid, ns in linked:
        tid, t = starts.get(cid, (None, 0))
        if tid not in ranges:
            continue
        i = bisect.bisect_right(heads[tid], t) - 1
        if i >= 0 and t < ranges[tid][i][1]:
            name = ranges[tid][i][2]
            spans[name] = spans.get(name, 0.0) + ns / 1e6
    return {"device_us": device, "spans_ms": spans,
            "host_self_us": {k: v for k, v in self_us.items()
                             if k not in SPANS
                             and not k.startswith("ProfilerStep")},
            "waits": waits}


def device_breakdown(prof, step_s: float) -> dict:
    """Device time per profiled decode-only step by kernel name, the
    device's idle share of a step, and the host ops that take most host
    time under the tracer.  One stream, so kernel times add up to busy
    time; the step's wall time ``step_s`` is the median decode step of the
    untraced first session (host tracing slows every step of the traced
    one, so its own wall times would overstate idleness)."""
    trace = trace_summary(prof)
    times, host = trace["device_us"], trace["host_self_us"]
    n = PROFILE["active"]
    waits = sum(trace["waits"].values())
    busy = sum(times.values()) / 1e6
    if busy == 0:
        return {"device_time": "not measured (the profiler saw no device "
                               "activity)", "step_ms": 1e3 * step_s}
    top = sorted(times.items(), key=lambda kv: -kv[1])[:8]
    decode = sum(t for k, t in times.items() if "paged_decode" in k) / 1e6
    exact = sum(t for k, t in times.items() if "exact_" in k) / 1e6
    vmm = {k: t for k, t in times.items() if "mxfp4" in k}
    return {"steps": n, "step_ms": 1e3 * step_s,
            "device_busy_ms_per_step": 1e3 * busy / n,
            "device_idle_share": 1 - busy / n / step_s,
            "decode_attention_ms_per_step": 1e3 * decode / n,
            "exact_attention_ms_per_step": 1e3 * exact / n,
            "host_waits_per_step": waits / n,
            "mxfp4_vmm_ms_per_step": sum(vmm.values()) / 1e3 / n,
            "mxfp4_kernels_ms_per_step": {k[:70]: t / 1e3 / n
                                          for k, t in vmm.items()},
            # host time under the tracer (it slows the host): where the
            # host's share goes, not how long a step takes
            "top_host_ops_ms_per_step_traced": {
                k[:50]: t / 1e3 / n for k, t in
                sorted(host.items(), key=lambda kv: -kv[1])[:10]},
            "top_kernels_ms_per_step": {k[:70]: t / 1e3 / n for k, t in top},
            "spans_device_ms_per_step": {
                k: t / n for k, t in trace["spans_ms"].items()}}


def vmm_launches_per_call(model, psum: bool = False) -> int:
    """MXFP4 launches of one decode step or prefill chunk call: per layer
    one for the attention's input projections (GQA: q/k/v grouped; MLA:
    wq) and one for its output projection, and for a dense MLP one for
    gate/up (grouped) and one for down.  MoE experts and the SSM mixer are
    not quantized.  llama3-8b: 4 x 32 = 128; deepseek-v2-lite-16b: 4 + 2 x
    26 = 56; hymba-1.5b: 4 x 32 = 128; mamba2-370m: 0.  ``psum``: a
    tensor-parallel psum rank dequantizes its row-sharded output and down
    projections (``parallel.hints.tp_row_dot``), so only the column half
    launches."""
    per = 1 if psum else 2
    return sum(0 if blk.kind == "ssm" else per + (0 if blk.is_moe else per)
               for blk in model.layers)


def gqa_layers(model) -> int:
    """Layers whose attention is GQA (the port's kernels run it): the
    ``attn_*`` kinds and the attention half of ``hybrid``."""
    return sum(blk.kind in ("attn_dense", "attn_moe", "hybrid")
               for blk in model.layers)


def mla_layers(model) -> int:
    """Layers whose attention is MLA (``mla_dense``, ``mla_moe``): the
    flash kernel runs their static prefill and ``Model.forward``."""
    return sum(blk.kind.startswith("mla") for blk in model.layers)


def state_readings(llm) -> dict:
    """A stateful engine's SSM state pools: bytes a slot, held against
    ``state_bytes_per_slot`` (what ``DeploymentSpec`` prices), and in all;
    empty for a stateless model."""
    from repro_torch.runtime.state_cache import state_bytes_per_slot

    eng = llm._eng
    if getattr(eng, "_states", None) is None:
        return {}
    total = sum(a.nbytes for s in eng._states for a in s.values())
    per = total // eng.num_slots
    if per != state_bytes_per_slot(eng.model.cfg):
        raise AssertionError(f"state pools hold {per} B a slot, "
                             f"state_bytes_per_slot says "
                             f"{state_bytes_per_slot(eng.model.cfg)}")
    return {"state_pool_bytes_per_slot": per,
            "state_pool_gb": total / 1e9}


# depth of the llama3-8b serve phases (its widths stay full): 8 of 32
# layers, as the other earlier models' cuts, keep the whole script near
# 600 s on a host that is not slowed
LLAMA_LAYERS = 8


def build_llama(torch):
    """llama3-8b at full width and ``LLAMA_LAYERS`` layers (random bf16
    weights from a seed)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=LLAMA_LAYERS)
    t0 = time.monotonic()
    model = Model(cfg, device="cuda").init(seed=0)
    torch.cuda.synchronize()
    print(f"serve: llama3-8b {cfg.n_layers} layers, "
          f"{model.param_count() / 1e9:.2f} B params bf16, random init "
          f"{time.monotonic() - t0:.1f} s")
    return model


# phases whose serve session is followed by a scored prompt (the mix's
# second; in danube's mix 6144 tokens, scored past the window)
SCORED_PHASES = ("serve", "serve_mla", "serve_moe", "serve_phi3",
                 "serve_danube", "serve_mamba2", "serve_hymba")


def serve_phase(torch, model, phase: str = "serve", requests=None,
                max_len: int = 2048, late=SHARED, expect_prefix_hit=True,
                watch=None, min_prefix_hit: int = 512 - 16,
                **engine_kw) -> dict:
    """Serve a request mix twice through ``LLMEngine`` (``engine_kw``:
    ``weight_format``, ``cache_dtype``) and check streams and launches:
    every request ends with its ``max_tokens``, the re-run (traced over 8
    decode-only steps) reproduces every stream, greedy and sampled, and
    every kernel of the path launched as often as the steps and calls
    say.  ``requests(sp_cls, vocab)`` gives the mix (default
    ``serve_requests``, with request 7 added ``late`` so it hits the prefix
    index for at least ``min_prefix_hit`` tokens; ``expect_prefix_hit=
    False``: no token may hit).  A model with SSM state and full-context
    layers (hymba) shares the prefix pages but recomputes the prompt
    (``recompute_shared``): no prompt token may be skipped.  ``watch``
    reads the first session step by step (``serve_session``) and its
    ``check()`` adds its readings to the result.  Phases in
    ``SCORED_PHASES`` also score the mix's second prompt
    (``serve_scoring``)."""
    from repro_torch.kernels import LAUNCHES, VARIANT_LAUNCHES
    from repro_torch.kernels.decode_attention.paged_kernel import (
        NAME, NAME_SCALED,
    )
    from repro_torch.kernels.mxfp4_vmm.kernel import NAME as VMM
    from repro_torch.quant.linear import serve_weight_bytes
    from repro_torch.runtime.llm import LLMEngine
    from repro_torch.runtime.sampling import SamplingParams

    cfg = model.cfg
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    llm = LLMEngine(model, backend="continuous", device="cuda", num_slots=8,
                    page_size=16, max_len=max_len, prefill_chunk=256,
                    **engine_kw)
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    prompts, sps = (requests or serve_requests)(SamplingParams,
                                                cfg.vocab_size)

    LAUNCHES.clear()
    VARIANT_LAUNCHES.clear()
    with vmm_calls() as vmm_inputs:
        streams, finished, stats, decode_steps = serve_session(
            llm, prompts, sps, late=late, watch=watch)
    torch.cuda.synchronize()
    launches = {k: v for k, v in LAUNCHES.items() if v}
    variants = {k: v for k, v in VARIANT_LAUNCHES.items() if v}
    # every shape the path gave mxfp4_vmm, on its own activations and
    # weights, against the plain version (these launches are not counted)
    vmm_held = []
    for (m, k, ns), (x, ws) in sorted(vmm_inputs.items()):
        err, variant, _ = hold_vmm(torch, x, ws)
        vmm_held.append({"M": m, "K": k, "N": list(ns), "schedule": variant,
                         "max_rel_err": err})
    del vmm_inputs

    for i, sp in enumerate(sps):
        o = finished.get(i)
        if (o is None or o.finish_reason != "length"
                or len(o.token_ids) != sp.max_tokens):
            raise AssertionError(f"{phase} request {i} did not finish with "
                                 f"{sp.max_tokens} tokens: {o}")
        if o.token_ids != streams[i]:
            raise AssertionError(f"{phase} request {i}: streamed deltas "
                                 f"differ from the final token_ids")
        if not all(0 <= t < cfg.vocab_size for t in o.token_ids):
            raise AssertionError(f"{phase} request {i}: token outside the "
                                 f"vocabulary")
    if (stats.prefix_hit_tokens < min_prefix_hit if expect_prefix_hit
            else stats.prefix_hit_tokens):
        raise AssertionError(f"{phase}: {stats.prefix_hit_tokens} prefix hit "
                             f"tokens (want "
                             f"{f'>= {min_prefix_hit}' if expect_prefix_hit else 0})")
    recompute = llm._eng.cache.recompute_shared
    if recompute and stats.prefill_tokens != stats.prompt_tokens:
        raise AssertionError(f"{phase}: shared prefix pages must be "
                             f"recomputed: {stats.prefill_tokens} prompt "
                             f"tokens computed of {stats.prompt_tokens}")
    readings = watch.check() if watch is not None else {}
    readings.update(state_readings(llm))
    if recompute:
        readings["recompute_shared"] = {
            "prefix_hit_tokens": stats.prefix_hit_tokens,
            "shared_pages": stats.prefix_hit_tokens // llm._eng.page_size,
            "prefill_tokens": stats.prefill_tokens,
            "prompt_tokens": stats.prompt_tokens}
    decode_kernel = (NAME_SCALED if engine_kw.get("cache_dtype") in
                     ("fp8", "int8") else NAME)
    # GQA layers: the paged decode kernel once per layer per decode step
    # (bf16 activations over bf16 or fp8 pools: the tensor-core variant);
    # MLA layers decode by plain einsums, as in the reference: no kernel
    want, want_variants = {}, {}
    if gqa_layers(model):
        want[decode_kernel] = gqa_layers(model) * stats.steps
        want_variants[f"{decode_kernel}:tensor_core"] = want[decode_kernel]
    if engine_kw.get("weight_format") == "mxfp4":
        # decode steps (M = the slots) on the decode schedule, prefill
        # chunk calls (M = rows x 256) on wgmma
        per = vmm_launches_per_call(model)
        want[VMM] = per * (stats.steps + stats.prefill_calls)
        want_variants[f"{VMM}:decode"] = per * stats.steps
        want_variants[f"{VMM}:wgmma"] = per * stats.prefill_calls
    if launches != want or 0 in want.values():
        raise AssertionError(f"kernel launches {launches}, want {want} "
                             f"({stats.steps} decode steps, "
                             f"{stats.prefill_calls} prefill chunk calls, "
                             f"{cfg.n_layers} layers)")
    if variants != want_variants:
        raise AssertionError(f"kernel variants {variants}, want "
                             f"{want_variants}")

    # the re-run doubles as the profiled window: 8 decode-only steps
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(**PROFILE)) as prof:
        again, _, stats2, _ = serve_session(llm, prompts, sps,
                                            on_decode_step=prof.step,
                                            late=late)
    breakdown = device_breakdown(prof, float(np.median(decode_steps)))
    for i in range(len(prompts)):
        if again[i] != streams[i]:
            kind = "greedy" if sps[i].is_greedy else "sampled"
            raise AssertionError(f"{phase} {kind} request {i} did not "
                                 f"reproduce its stream on the re-run")
    write_cost = (gqa_write_cost(torch, llm, model, prompts, sps, streams)
                  if phase == "serve" else None)
    scoring = None
    if phase in SCORED_PHASES:
        # an MoE model's capacity counts the call's tokens: its prompt is
        # scored in one call of the prompt's length, the T of Model.forward
        score_llm = llm if not cfg.moe else LLMEngine(
            model, backend="continuous", device="cuda", num_slots=8,
            page_size=16, max_len=max_len, prefill_chunk=len(prompts[1]))
        scoring = serve_scoring(torch, score_llm, model, prompts[1])
        if not cfg.moe:
            scoring["mixed_batch"] = mixed_batch_scoring(torch, llm, model,
                                                         prompts[1])
        del score_llm
    ttft = stats.latency_quantiles("ttft")
    result = {"phase": phase, **{k: str(v) for k, v in engine_kw.items()},
              "requests": len(prompts),
              "prompt_tokens": [len(p) for p in prompts],
              "new_tokens": stats.total_tokens,
              "tokens_per_s": stats.total_tokens / stats.wall,
              "wall_s": stats.wall, "ttft_p50_s": ttft["p50"],
              "ttft_mean_s": ttft["mean"],
              "decode_step_ms_mean": 1e3 * float(np.mean(decode_steps)),
              "decode_only_steps": len(decode_steps),
              "decode_steps": stats.steps, "prefill_chunks": stats.chunks,
              "prefill_calls": stats.prefill_calls,
              "prefix_hit_tokens": stats.prefix_hit_tokens,
              "kernel_launches": launches, "kernel_variants": variants,
              "mxfp4_vmm_held": vmm_held, "engine_setup_s": setup_s,
              "served_weight_gb": serve_weight_bytes(
                  model, engine_kw.get("weight_format")) / 1e9,
              "rerun_identical": True, "rerun_wall_s": stats2.wall,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "sim_context": float(np.mean([len(p) + sp.max_tokens / 2
                                            for p, sp in zip(prompts, sps)])),
              **readings,
              "profiled_decode_steps": breakdown, "_streams": streams}
    if scoring is not None:
        result["prompt_scoring"] = scoring
    if write_cost is not None:
        result["gqa_write_cost"] = write_cost
    del llm
    torch.cuda.empty_cache()
    return result


def page_bytes(eng) -> int:
    """Bytes of one page over every pool leaf an engine's handoff moves
    (``_pool_leaves``: k/v codes, scale leaves, the draft's pools)."""
    return sum(raw[0].numel() * raw.element_size()
               for raw in eng._pool_leaves())


def serve_disagg_phase(torch, model, colocated: dict | None = None) -> dict:
    """The serve phase's mix through ``LLMEngine(disaggregate=True)``: a
    prefill-phase and a decode-phase engine on the one card, joined by the
    KV-page handoff (host staging).  Twice: bf16, then mxfp4 weights over
    fp8 pools, each beside the colocated phase of the same engine options
    in this call (``colocated``: "serve" and "serve_quantized").  Every
    request finishes with its 64 tokens; every request is handed off, the
    later 512-token sharer through a decode-side prefix hit; the handoff's
    bytes equal its pages times the bytes of a page of every leaf; the
    paged decode kernel runs once a GQA layer a decode step (and
    ``mxfp4_vmm`` 4 a layer a decode step or prefill call); each greedy
    stream equals the colocated one or parts at a near-tie
    (``divergences``, on a CPU copy of the model built only then).  Then
    untraced sessions of a colocated engine of the same options (A) and
    of the disaggregated one (B) in the order A B B A, each side's
    readings the median of its two: a profiler trace slows the sessions
    that follow it on the host, so the colocated phase's own first
    session, which ran before any trace, is no fair yardstick.  A last
    session traces 8 decode-only steps.  Reports TTFT p50, the decode
    step's wall, busy and idle share, tokens/s and the handoff's pages,
    bytes and ms a transfer beside the colocated numbers.  Without
    ``colocated`` (``--only serve_disagg``) the two colocated phases run
    first."""
    from repro_torch.kernels import LAUNCHES, VARIANT_LAUNCHES
    from repro_torch.kernels.decode_attention.paged_kernel import (
        NAME, NAME_SCALED,
    )
    from repro_torch.kernels.mxfp4_vmm.kernel import NAME as VMM
    from repro_torch.runtime.llm import LLMEngine
    from repro_torch.runtime.sampling import SamplingParams
    from torch.profiler import ProfilerActivity, profile, schedule

    cfg = model.cfg
    if colocated is None:
        colocated = {"serve": serve_phase(torch, model),
                     "serve_quantized": serve_phase(
                         torch, model, phase="serve_quantized",
                         weight_format="mxfp4", cache_dtype="fp8")}
    prompts, sps = serve_requests(SamplingParams, cfg.vocab_size)
    runs = {}
    cpu_model = None
    for label, base, kw in (("bf16", "serve", {}),
                            ("mxfp4_fp8", "serve_quantized",
                             dict(weight_format="mxfp4", cache_dtype="fp8"))):
        co = colocated[base]
        llm = LLMEngine(model, backend="continuous", device="cuda",
                        num_slots=8, page_size=16, max_len=2048,
                        prefill_chunk=256, disaggregate=True, **kw)
        eng = llm._eng
        LAUNCHES.clear()
        VARIANT_LAUNCHES.clear()
        streams, finished, stats, decode_steps = serve_session(llm, prompts,
                                                               sps)
        torch.cuda.synchronize()
        launches = {k: v for k, v in LAUNCHES.items() if v}
        for i, sp in enumerate(sps):
            o = finished.get(i)
            if (o is None or o.finish_reason != "length"
                    or len(o.token_ids) != sp.max_tokens
                    or o.token_ids != streams[i]):
                raise AssertionError(f"serve_disagg {label} request {i}: "
                                     f"{o}")
        per_page = page_bytes(eng.decode)
        if not (stats.handoffs >= len(prompts)
                and stats.handoff_shared_tokens >= 512 - 16
                and stats.handoff_bytes == stats.handoff_pages * per_page
                and page_bytes(eng.prefill) == per_page):
            raise AssertionError(
                f"serve_disagg {label}: {stats.handoffs} handoffs, "
                f"{stats.handoff_pages} pages, {stats.handoff_bytes} bytes "
                f"(a page {per_page} B), {stats.handoff_shared_tokens} "
                f"prefix-shared tokens")
        decode_kernel = NAME_SCALED if kw else NAME
        want = {decode_kernel: gqa_layers(model) * stats.steps}
        if kw:
            want[VMM] = vmm_launches_per_call(model) * (stats.steps
                                                        + stats.prefill_calls)
        if launches != want:
            raise AssertionError(f"serve_disagg {label} launched {launches}, "
                                 f"want {want}")
        # greedy streams against the colocated engine's
        want_streams = co["_streams"]
        got = [finished[i] for i in range(len(prompts))]
        ref = [dataclasses.replace(finished[i], token_ids=want_streams[i])
               for i in range(len(prompts))]
        greedy = [i for i, sp in enumerate(sps) if sp.is_greedy]
        gap_model = None
        if any(got[i].token_ids != ref[i].token_ids for i in greedy):
            # the near-tie rule's CPU model, built only when a stream parts
            from repro_torch.models.model import Model
            from repro_torch.quant.linear import quantize_params
            if cpu_model is None:
                cpu_model = Model(cfg, device="cpu")
                cpu_model.load_state_dict({k: v.cpu() for k, v in
                                           model.state_dict().items()})
            gap_model = (quantize_params(cpu_model, kw["weight_format"])
                         if kw else cpu_model)
        near = divergences(
            torch, f"serve_disagg {label} vs colocated",
            [got[i] for i in greedy], [ref[i] for i in greedy],
            [prompts[i] for i in greedy], [sps[i] for i in greedy],
            gap_model, kw.get("cache_dtype"), True)
        sampled_equal = [got[i].token_ids == ref[i].token_ids
                         for i, sp in enumerate(sps) if not sp.is_greedy]
        co_llm = LLMEngine(model, backend="continuous", device="cuda",
                           num_slots=8, page_size=16, max_len=2048,
                           prefill_chunk=256, **kw)
        ab = {"colocated": [], "disaggregated": []}
        for side in ("colocated", "disaggregated", "disaggregated",
                     "colocated"):
            _, _, st, steps = serve_session(
                co_llm if side == "colocated" else llm, prompts, sps)
            ab[side].append({"ttft_p50_s": st.latency_quantiles("ttft")["p50"],
                             "decode_step_ms": 1e3 * float(np.median(steps)),
                             "tokens_per_s": st.total_tokens / st.wall})
        ab = {side: {k: float(np.median([r[k] for r in runs]))
                     for k in runs[0]} | {"sessions": runs}
              for side, runs in ab.items()}
        del co_llm
        # the re-run doubles as the profiled window: 8 decode-only steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(**PROFILE)) as prof:
            serve_session(llm, prompts, sps, on_decode_step=prof.step)
        breakdown = device_breakdown(prof, float(np.median(decode_steps)))
        ho = eng.handoff
        ttft = stats.latency_quantiles("ttft")
        cob = co["profiled_decode_steps"]
        runs[label] = {
            "handoffs": stats.handoffs, "handoff_pages": stats.handoff_pages,
            "handoff_bytes": stats.handoff_bytes,
            "handoff_shared_tokens": stats.handoff_shared_tokens,
            "page_bytes": per_page,
            "handoff_ms_total": 1e3 * ho.seconds,
            "handoff_ms_per_transfer": 1e3 * ho.seconds / max(ho.transfers,
                                                              1),
            "handoff_gb_per_s": stats.handoff_bytes / max(ho.seconds,
                                                          1e-9) / 1e9,
            "handoff_deferrals": ho.deferrals,
            "prefill_engine": {"slots": eng.prefill.num_slots,
                               "pages": eng.prefill.num_pages},
            "decode_engine": {"slots": eng.decode.num_slots,
                              "pages": eng.decode.num_pages},
            "tokens_per_s": stats.total_tokens / stats.wall,
            "wall_s": stats.wall, "ttft_p50_s": ttft["p50"],
            "decode_step_ms_mean": 1e3 * float(np.mean(decode_steps)),
            "decode_step_ms_median": 1e3 * float(np.median(decode_steps)),
            "decode_steps": stats.steps, "prefill_calls": stats.prefill_calls,
            "prefix_hit_tokens": stats.prefix_hit_tokens,
            "kernel_launches": launches,
            "greedy_equal_to_colocated": not near, "near_ties": near,
            "sampled_equal_to_colocated": sampled_equal,
            "profiled_decode_steps": breakdown,
            "untraced_abba": ab,
            "colocated": {
                "tokens_per_s": co["tokens_per_s"],
                "ttft_p50_s": co["ttft_p50_s"],
                "decode_step_ms_mean": co["decode_step_ms_mean"],
                "device_busy_ms_per_step": cob.get("device_busy_ms_per_step"),
                "device_idle_share": cob.get("device_idle_share"),
                "step_ms": cob.get("step_ms")}}
        print(f"  serve_disagg {label}:", json.dumps(
            {k: v for k, v in runs[label].items()
             if k != "profiled_decode_steps"}))
        del llm, eng
        gc.collect()
        torch.cuda.empty_cache()
    del cpu_model, gap_model
    return {"phase": "serve_disagg", "layers": cfg.n_layers, **runs}


# ---------------------------------------------------------------------------
# serve_tp: tensor-parallel serving, two ranks sharing the one card
# ---------------------------------------------------------------------------

TP_RANKS = 2
TP_TIMEOUT_S = 60          # every collective of the ranks' process group
TP_JOIN_S = 600            # the two ranks, joined with a deadline
TP_ENGINE = dict(num_slots=8, page_size=16, max_len=2048, prefill_chunk=256)
# the phase's depths, cut below the other phases' (8 and 4) to keep the
# whole script near its budget: its steps are host-bound, one gloo meeting
# a column pair
TP_LLAMA_LAYERS, TP_DEEPSEEK_LAYERS = 4, 2
# (label, reduce, engine kwargs) of the llama3-8b sessions; deepseek runs
# gather mode only
TP_MODES = (("gather", "gather", {}), ("psum", "psum", {}),
            ("gather_mxfp4_fp8", "gather",
             {"weight_format": "mxfp4", "cache_dtype": "fp8"}),
            ("psum_mxfp4_fp8", "psum",
             {"weight_format": "mxfp4", "cache_dtype": "fp8"}))
# the ring matmuls at llama3-8b's MLP shapes: (M, K, N, mode)
RING_SHAPES = ((8, 4096, 14336, "ag"), (8, 14336, 4096, "rs"))
# bf16 output of f32 sums in another order than torch.matmul's f32
# product: each element within one bf16 ulp of its magnitude (2^-7: the
# rounding, which the order of the sums may tip) plus 2^-12 of the largest
RING_REL_TOL, RING_ABS_TOL = 2.0 ** -7, 2.0 ** -12


def tp_models(reduced: bool = False) -> dict:
    """The phase's two models, as (config name, layers): llama3-8b and
    deepseek-v2-lite-16b at ``TP_LLAMA_LAYERS`` / ``TP_DEEPSEEK_LAYERS``,
    full width;
    ``reduced`` gives their tiny configs (a CPU rehearsal of the phase)."""
    return {"llama": ("llama3-8b", TP_LLAMA_LAYERS, reduced),
            "deepseek": ("deepseek-v2-lite-16b", TP_DEEPSEEK_LAYERS,
                         reduced)}


def tp_build(torch, name: str, layers: int, reduced: bool, device: str):
    """A model of ``name`` at ``layers`` layers (its reduced config when
    ``reduced``), random weights from seed 0, the same on every rank."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models.model import Model

    cfg = get_config(name)
    cfg = (reduced_config(cfg) if reduced
           else dataclasses.replace(cfg, n_layers=layers))
    return Model(cfg, device=device).init(seed=0)


def tp_paged_logits(torch, model, cache_dtype, tokens,
                    decode_last: bool = False) -> np.ndarray:
    """The logits ``model``'s paged path gives after ``tokens`` into fresh
    pools of ``cache_dtype`` (fp8 codes too): one prefill chunk of them
    all, or with ``decode_last`` of all but the last, then the last as one
    decode step.  Collective inside a TP region the caller opened."""
    dev = model.device
    n = len(tokens)
    blocks = -(-n // PAGE)
    pools = model.init_paged_cache(blocks + 1, PAGE, dtype=cache_dtype)
    table = torch.arange(1, blocks + 1, dtype=torch.int32, device=dev)[None]
    toks = torch.as_tensor(np.asarray(tokens), device=dev)[None]
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    m = n - 1 if decode_last else n
    logits = model.prefill_chunk_paged(toks[:, :m], pools, table, zero,
                                       torch.full_like(zero, m))
    if decode_last:
        logits = model.decode_step_paged(toks[0, -1:], pools, table,
                                         torch.full_like(zero, m))
    return logits[0, :model.cfg.vocab_size].float().cpu().numpy()


def tp_probe_logits(torch, llm, prompt) -> np.ndarray:
    """The first decode step's logits of ``llm``'s engine model for
    ``prompt`` (``tp_paged_logits`` with ``decode_last``; inside the
    engine's TP region on a mesh)."""
    eng = llm._eng
    with eng._tp_region():
        return tp_paged_logits(torch, eng.model, eng.cache_dtype, prompt,
                               decode_last=True)


class RouteLog:
    """Every MoE routing of a serve session in call order, as
    ``serve_session``'s ``watch``: each call's expert ids and router
    logits (kept on the device while the session runs) and whose each
    row is: a decode row the request id of its slot, a prefill position
    below its row's ``valid`` -2 (a prompt token), padding -1 (computed
    over the scratch page); the routing calls made by the end of each
    step, and the step that emitted each token of each request.
    ``result()`` brings them to the host."""

    def start(self, llm):
        import torch

        from repro_torch.models import moe

        self.moe, self.real = moe, moe._routing
        self.llm, self.real_step = llm, llm.step
        self.model = model = llm._eng.model
        real_decode = model.decode_step_paged
        real_chunk = model.prefill_chunk_paged
        self.calls, self.calls_at, self.emitted = [], [], {}
        self.rows = None

        def decode(tokens, pools, page_table, *args, **kw):
            self.rows = np.full(page_table.shape[0], -1)
            for req in llm._eng._sched.decoding():
                self.rows[req.slot] = req.rid
            return real_decode(tokens, pools, page_table, *args, **kw)

        def chunk(tokens, pools, page_table, start, valid, *args, **kw):
            cols = torch.arange(tokens.shape[1], device=valid.device)
            live = (cols[None] < valid[:, None]).reshape(-1).cpu().numpy()
            self.rows = np.where(live, -2, -1)
            return real_chunk(tokens, pools, page_table, start, valid,
                              *args, **kw)

        def routing(x2d, router, k):
            w, ids = self.real(x2d, router, k)
            if self.rows is None or len(self.rows) != x2d.shape[0]:
                raise AssertionError(f"a routing over {x2d.shape[0]} rows "
                                     f"outside a paged call")
            self.calls.append((ids, x2d.float() @ router.float(), self.rows))
            return w, ids

        def step():
            outs = self.real_step()
            n = len(self.calls_at)
            self.calls_at.append(len(self.calls))
            for o in outs:
                self.emitted.setdefault(o.rid, []).extend(
                    [n] * len(o.new_token_ids))
            return outs
        moe._routing = routing
        llm.step = step
        model.decode_step_paged = decode
        model.prefill_chunk_paged = chunk

    def step(self):
        pass

    def stop(self):
        self.moe._routing = self.real
        del self.llm.step                  # the class's methods again
        del self.model.decode_step_paged
        del self.model.prefill_chunk_paged

    def result(self) -> dict:
        return {"ids": [i.cpu().numpy() for i, _, _ in self.calls],
                "logits": [lg.cpu().numpy() for _, lg, _ in self.calls],
                "rows": [v for _, _, v in self.calls],
                "calls_at": list(self.calls_at), "emitted": self.emitted}


def tp_moe_divergence(got: dict, want: dict, got_streams: dict,
                      want_streams: dict) -> dict | None:
    """Where an MoE session on the TP ranks (``got``: its ``RouteLog`` and
    streams) first diverges from tp=1's (``want``), the two having run one
    schedule.  An MoE batch couples its rows (each expert takes
    ``ceil(T k / E x 1.25)`` tokens: one at deepseek's decode), so after
    the first divergence any row may change by far more than rounding.
    The first divergence is the first routing call that either routes a
    live row otherwise (a flip) or holds a decode row of a request whose
    tokens parted in an earlier step (a parted request: its input
    differs).  Returns its step and kind; for a flip, the flipped rows
    and how near a tie each was on tp=1's own router logits: the gap
    between tp=1's k-th choice and the lowest of the TP choice, as a share
    of ``SCORE_REL_TOL`` x the row's largest |router logit| (at or under
    1: a near tie of four bf16 ulps, ``forced_routes``' measure).  None
    when nothing diverges."""
    if got["calls_at"] != want["calls_at"]:
        raise AssertionError("serve_tp: the TP and tp=1 sessions ran "
                             "different schedules")
    parted = {}                  # request -> the step of its first parting
    for i, toks in want_streams.items():
        j = next((j for j, (x, y) in enumerate(zip(got_streams[i], toks))
                  if x != y), None)
        if j is not None:
            parted[i] = want["emitted"][i][j]
    for c, (a, b) in enumerate(zip(got["ids"], want["ids"])):
        rows = want["rows"][c]
        if a.shape != b.shape or not np.array_equal(rows, got["rows"][c]):
            raise AssertionError(f"serve_tp: routing call {c} has shape "
                                 f"{a.shape} (tp=1 {b.shape}) or other rows")
        step = next(s for s, n in enumerate(want["calls_at"]) if n > c)
        stale = [int(r) for r in rows if r >= 0 and parted.get(r, step) < step]
        if stale:
            return {"step": step, "kind": "parted_request", "call": c,
                    "requests": sorted(set(stale))}
        differ = (np.sort(a, -1) != np.sort(b, -1)).any(-1) & (rows != -1)
        if not differ.any():
            continue
        lg = want["logits"][c]
        shares = [float((lg[r, b[r]].min() - lg[r, a[r]].min())
                        / (SCORE_REL_TOL * np.abs(lg[r]).max()))
                  for r in np.nonzero(differ)[0]]
        return {"step": step, "kind": "route_flip", "call": c,
                "rows": len(shares), "gap_share": max(shares)}
    return None


def tp_session(torch, model, mesh, reduce: str, kw: dict,
               routes: bool = False) -> dict:
    """One session of the llama mix on this rank: the engine over ``mesh``,
    its kernel launches (this process's), every distinct ``mxfp4_vmm``
    launch held on the path's own activations, the collectives of each
    decode-only step against ``psum_bytes_per_step``, the pools' bytes a
    token, the decode steps' wall and device time (8 traced), the streams
    and the first decode step's logits of the mix's first prompt; with
    ``routes`` the session's ``RouteLog`` too."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.kernels import LAUNCHES, VARIANT_LAUNCHES
    from repro_torch.kernels.decode_attention.paged_kernel import (
        NAME, NAME_SCALED,
    )
    from repro_torch.kernels.mxfp4_vmm.kernel import NAME as VMM
    from repro_torch.runtime.llm import LLMEngine
    from repro_torch.runtime.sampling import SamplingParams

    cfg = model.cfg
    llm = LLMEngine(model, backend="continuous", device=model.device,
                    mesh=mesh, tp_reduce=reduce, **TP_ENGINE, **kw)
    eng, comm, plan = llm._eng, llm._eng._tp, llm.serve_plan
    prompts, sps = serve_requests(SamplingParams, cfg.vocab_size)
    on_card = model.device.type == "cuda"
    steps, last = [], [dict(comm.counts)]

    def on_step():
        if on_card:
            prof.step()
        cur = dict(comm.counts)
        steps.append({k: v - last[0].get(k, 0) for k, v in cur.items()})
        last[0] = cur

    LAUNCHES.clear()
    VARIANT_LAUNCHES.clear()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    log = RouteLog() if routes else None
    with vmm_calls() as vmm_inputs, profile(
            activities=acts, schedule=schedule(**PROFILE)) as prof:
        streams, finished, stats, decode_steps = serve_session(
            llm, prompts, sps, on_decode_step=on_step, watch=log)
    if on_card:
        torch.cuda.synchronize()
    launches = {k: v for k, v in LAUNCHES.items() if v}
    variants = {k: v for k, v in VARIANT_LAUNCHES.items() if v}
    vmm_held = []
    for (m, k, ns), (x, ws) in sorted(vmm_inputs.items() if on_card
                                      else ()):
        err, variant, _ = hold_vmm(torch, x, ws)
        vmm_held.append({"M": m, "K": k, "N": list(ns), "schedule": variant,
                         "max_rel_err": err})
    del vmm_inputs
    for i, sp in enumerate(sps):
        o = finished.get(i)
        if (o is None or o.finish_reason != "length"
                or len(o.token_ids) != sp.max_tokens):
            raise AssertionError(f"serve_tp {reduce}{kw}: request {i} did "
                                 f"not finish with {sp.max_tokens} tokens")
    # paged decode: once per GQA layer per decode step, at local heads
    want = {}
    if gqa_layers(model):
        kname = NAME_SCALED if kw.get("cache_dtype") else NAME
        want[kname] = gqa_layers(model) * stats.steps
        if on_card and variants.get(f"{kname}:tensor_core") != want[kname]:
            raise AssertionError(f"serve_tp: {variants}, want every "
                                 f"{kname} launch on the tensor-core variant")
    if kw.get("weight_format") == "mxfp4":
        want[VMM] = vmm_launches_per_call(model, reduce == "psum") * (
            stats.steps + stats.prefill_calls)
    if on_card and launches != want:
        raise AssertionError(f"serve_tp {reduce}{kw}: kernel launches "
                             f"{launches}, want {want} ({stats.steps} "
                             f"decode steps, {stats.prefill_calls} prefill "
                             f"calls)")
    # the collectives of a decode-only step (the first delta holds the
    # session before it) against the plan's prediction
    act_bytes = 4 if reduce == "psum" else 2      # f32 partials / bf16
    predicted = plan.psum_bytes_per_step(eng._price_model, eng.num_slots,
                                         dtype_bytes=act_bytes)
    per_step = steps[1:]
    got = sorted({s.get("bytes", 0) for s in per_step})
    if got != [predicted]:
        raise AssertionError(f"serve_tp {reduce}{kw}: collective bytes a "
                             f"decode step {got}, psum_bytes_per_step "
                             f"says {predicted}")
    pool_bytes = sum(a.nbytes for pool in eng._pools for a in pool.values())
    per_token = pool_bytes // ((eng.num_pages) * eng.page_size)
    if per_token != eng.kv_token_bytes_per_device():
        raise AssertionError(f"serve_tp: pools hold {per_token} B a token, "
                             f"kv_token_bytes_per_device says "
                             f"{eng.kv_token_bytes_per_device()}")
    step_s = float(np.median(decode_steps))
    breakdown = (device_breakdown(prof, step_s) if on_card
                 else {"device_time": "not measured (CPU)"})
    one = per_step[-1]
    result = {
        "reduce": plan.reduce, "tp": plan.tp, "kv_repl": plan.kv_repl,
        **{k: str(v) for k, v in kw.items()},
        "local_heads": [eng.model.cfg.n_heads, eng.model.cfg.n_kv_heads],
        "collective_backend": comm.backend,
        "collectives_per_decode_step": {
            k: v for k, v in one.items() if k not in ("bytes",)},
        "collective_bytes_per_decode_step": one.get("bytes", 0),
        "psum_bytes_per_step": predicted,
        "host_copies_total": comm.counts.get("host_copies", 0),
        "host_bytes_total": comm.counts.get("host_bytes", 0),
        "kv_token_bytes": eng.kv_token_bytes_per_device(),
        "decode_steps": stats.steps, "prefill_calls": stats.prefill_calls,
        "decode_step_ms_median": 1e3 * step_s,
        "decode_only_steps": len(decode_steps),
        "device_busy_ms_per_step": breakdown.get("device_busy_ms_per_step"),
        "device_idle_share": breakdown.get("device_idle_share"),
        "tokens_per_s": stats.total_tokens / stats.wall,
        "prefix_hit_tokens": stats.prefix_hit_tokens,
        "kernel_launches": launches, "kernel_variants": variants,
        "mxfp4_vmm_held": vmm_held,
        "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                        if on_card else None),
        "_streams": {i: list(o.token_ids) for i, o in finished.items()},
        "_logits": tp_probe_logits(torch, llm, prompts[0]),
        "_routes": log.result() if routes else None}
    del llm, eng
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return result


def tp_rings(torch, mesh, device: str) -> list:
    """The two ring matmuls on the mesh's model group at ``RING_SHAPES``,
    bf16, each rank's fragments of one seeded x and W, held against
    ``torch.matmul`` of the same bf16 values in f32, and timed (CUDA
    events around the whole call, host staging of the hops included)."""
    from repro_torch.parallel.collective_matmul import (
        ring_allgather_matmul, ring_matmul_reducescatter,
    )
    from repro_torch.parallel.hints import TPComm

    comm = TPComm(mesh.get_group("model"))
    p, r = comm.size, comm.rank
    out = []
    for m, k, n, mode in RING_SHAPES:
        g = torch.Generator(device=device).manual_seed(k + n)
        x = torch.randn(m, k, generator=g, device=device).to(torch.bfloat16)
        w = (torch.randn(k, n, generator=g, device=device)
             / math.sqrt(k)).to(torch.bfloat16)
        kp, nl = k // p, n // p
        xf = x[:, r * kp:(r + 1) * kp]
        if mode == "ag":
            fn = lambda: ring_allgather_matmul(      # noqa: E731
                xf, w[:, r * nl:(r + 1) * nl], comm)
        else:
            fn = lambda: ring_matmul_reducescatter(  # noqa: E731
                xf, w[r * kp:(r + 1) * kp], comm)
        got = fn()
        want = (x.float() @ w.float())[:, r * nl:(r + 1) * nl]
        lim = RING_REL_TOL * want.abs() + RING_ABS_TOL * want.abs().max()
        share = float(((got.float() - want).abs() / lim).max())
        if not share <= 1.0:
            raise AssertionError(f"ring {mode} at {(m, k, n)} disagrees "
                                 f"with torch.matmul: {share} of the limit")
        ms = None
        if device == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                fn()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 5
        out.append({"mode": mode, "M": m, "K": k, "N": n,
                    "max_err_share": share, "ms_with_staging": ms})
    return out


def tp_gloo_cuda_probe(torch) -> dict:
    """Which collectives the installed torch's gloo group takes on CUDA
    tensors directly (on a group of its own, after the sessions): the
    serve path hands its all-gathers and all-reduces of CUDA tensors to
    gloo as they are (``parallel.hints.TPComm``), so a refusal here
    would have failed the sessions first.  The ring's point-to-point hops
    are not probed: gloo's send and recv take a raw pointer, which on a
    CUDA tensor would reach the host transport, so they stage."""
    import torch.distributed as dist

    group = dist.new_group(backend="gloo")
    n = dist.get_world_size()
    t = torch.ones(4, device="cuda")
    ops = {"all_reduce": lambda: dist.all_reduce(t, group=group),
           "broadcast": lambda: dist.broadcast(t, src=0, group=group),
           "all_gather": lambda: dist.all_gather(
               [torch.empty_like(t) for _ in range(n)], t, group=group),
           "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
               torch.empty(4 * n, device="cuda"), t, group=group)}
    out = {}
    for name, op in ops.items():
        try:
            op()
            torch.cuda.synchronize()
            out[name] = "accepted"
        except Exception as e:          # a refusal is the finding
            out[name] = f"refused: {type(e).__name__}: {str(e)[:120]}"
    return out


def tp_rank(rank: int, rdzv: str, queue, models: dict, device: str) -> None:
    """One rank of the phase (a spawned process): join the gloo group,
    build the models from the same seed as every rank, serve each mode,
    run the ring matmuls and the gloo probe, and send the readings to the
    parent through ``queue``."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_world, parse_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device == "cpu":
        torch.set_num_threads(1)
    backend = init_world(device, backend="gloo", rank=rank,
                         world_size=TP_RANKS, init_method=rdzv,
                         timeout_s=TP_TIMEOUT_S)
    try:
        mesh = parse_mesh(f"1x{TP_RANKS}", device)
        runs = {}
        model = tp_build(torch, *models["llama"], device)
        for label, reduce, kw in TP_MODES:
            runs[label] = tp_session(torch, model, mesh, reduce, kw)
        del model
        gc.collect()
        model = tp_build(torch, *models["deepseek"], device)
        runs["deepseek_gather"] = tp_session(torch, model, mesh, "gather", {},
                                             routes=True)
        del model
        gc.collect()
        rings = tp_rings(torch, mesh, device)
        probe = tp_gloo_cuda_probe(torch) if device == "cuda" else {}
        queue.put((rank, {"runs": runs, "rings": rings, "backend": backend,
                          "gloo_cuda_probe": probe}))
    finally:
        dist.destroy_process_group()


def tp_near_ties(torch, got, want, prompts, sps, ref) -> tuple:
    """Where the TP streams part from tp=1's: a greedy stream may part only
    at a near tie, a top-2 gap within ``NEAR_TIE_BF16_ULPS`` bf16 ulps of
    the top logit (serve_spec_draft's rule), measured on tp=1's own serve
    numerics: its engine model (the mxfp4 view too) over pools of the
    session's cache dtype (fp8 codes too), after the prompt and the
    tokens before the parting one.  Returns the parting points and those
    that are not near ties."""
    near, bad = [], []
    for i, sp in enumerate(sps):
        a, b = got[i], want[i]
        if a == b or not sp.is_greedy:
            continue
        t = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        logits = tp_paged_logits(torch, ref["model"], ref["cache_dtype"],
                                 np.concatenate([prompts[i], b[:t]]))
        top = np.sort(logits)[-2:]
        gap = float(top[1] - top[0])
        ulp = 2.0 ** (math.floor(math.log2(abs(float(top[1])))) - 7)
        near.append({"request": i, "token": t, "gap_bf16_ulps": gap / ulp})
        if not gap <= NEAR_TIE_BF16_ULPS * ulp:
            bad.append(near[-1])
    return near, bad


def serve_tp_phase(torch, models: dict | None = None,
                   device: str = "cuda") -> dict:
    """Tensor-parallel serving on the card: two ranks (spawned processes)
    sharing ``cuda:0`` over a gloo group (NCCL refuses two ranks on one
    device), a (1, 2) mesh.  llama3-8b at ``TP_LLAMA_LAYERS`` layers, full
    width, in gather, psum and MXFP4 + fp8 gather modes, and
    deepseek-v2-lite-16b at ``TP_DEEPSEEK_LAYERS`` in gather mode (MLA heads
    16 -> 8, latent pools and experts replicated), each serving the llama
    mix, and llama's MXFP4 + fp8 weights once more in psum mode; then the
    two ring matmuls on the group.  Per rank: the paged
    decode launches equal layers x decode steps (at 16 query / 4 KV heads
    for llama), every distinct ``mxfp4_vmm`` launch (N/2 and full K) held
    at 1e-5 on its own activations, the collective bytes of a decode step
    equal ``psum_bytes_per_step``, the pools' bytes a token are half of
    tp=1's, and the decode step's wall and device-busy time.  Against the
    tp=1 engine on the same card (sessions of this phase, same knobs): the
    first decode step's logits within ``SCORE_REL_TOL`` of their largest;
    greedy streams agree under the near-tie rule, and deepseek's may also
    part at or after the session's first divergence: a routing flip, itself
    a near tie on tp=1's router logits, or a request whose sampled stream
    parted, either of which reaches every row through the expert capacity
    (``tp_moe_divergence``; both sessions run one schedule).  The tp=1
    models are built as the ranks build theirs (``tp_build``); ``models``
    / ``device`` let a CPU rehearsal run the phase at reduced size.  No
    number here is a tensor-parallel speed: both ranks share one card and
    gloo copies every collective through the host."""
    import multiprocessing as mproc
    import queue as queue_mod
    import tempfile

    from repro_torch.runtime.llm import LLMEngine
    from repro_torch.runtime.sampling import SamplingParams

    models = models or tp_models()
    on_card = device == "cuda"
    model = tp_build(torch, *models["llama"], device)

    def tp1(m, kw, routes=False):
        prompts, sps = serve_requests(SamplingParams, m.cfg.vocab_size)
        llm = LLMEngine(m, backend="continuous", device=device,
                        **TP_ENGINE, **kw)
        log = RouteLog() if routes else None
        streams, _, _, steps = serve_session(llm, prompts, sps, watch=log)
        out = {"streams": streams, "routes": log and log.result(),
               "kv_token_bytes":
               llm.kv_token_bytes_per_device(),
               "decode_step_ms_median": 1e3 * float(np.median(steps)),
               "logits": tp_probe_logits(torch, llm, prompts[0]),
               # the near-tie rule's gaps come from these (mxfp4 view)
               "model": llm._eng.model, "cache_dtype": llm._eng.cache_dtype}
        del llm
        gc.collect()
        return out

    # the tp=1 sessions first, alone on the card: one for each engine
    # configuration (gather and psum modes share it)
    ref, by_kw = {}, {}
    for label, _, kw in TP_MODES:
        key = json.dumps(kw, sort_keys=True)
        if key not in by_kw:
            by_kw[key] = tp1(model, kw)
        ref[label] = by_kw[key]
    del by_kw
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mproc.get_context("spawn")
        q = ctx.Queue()
        procs = [ctx.Process(target=tp_rank,
                             args=(r, f"file://{tmp}/rdzv", q, models,
                                   device)) for r in range(TP_RANKS)]
        for p in procs:
            p.start()
        ranks, deadline = {}, time.monotonic() + TP_JOIN_S
        try:
            while len(ranks) < TP_RANKS:
                try:
                    r, res = q.get(timeout=2.0)
                    ranks[r] = res
                except queue_mod.Empty:
                    dead = [p.exitcode for p in procs
                            if p.exitcode not in (None, 0)]
                    if dead:
                        raise AssertionError(f"serve_tp: a rank failed "
                                             f"(exit codes {dead})")
                    if time.monotonic() > deadline:
                        raise AssertionError(f"serve_tp: ranks not done "
                                             f"after {TP_JOIN_S} s")
            for p in procs:
                p.join(timeout=TP_TIMEOUT_S)
                if p.exitcode != 0:
                    raise AssertionError(f"serve_tp: rank exit code "
                                         f"{p.exitcode}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    # deepseek's tp=1 session once the ranks are gone
    ds = tp_build(torch, *models["deepseek"], device)
    ref["deepseek_gather"] = tp1(ds, {}, routes=True)

    out = {"phase": "serve_tp", "ranks": TP_RANKS, "mesh": f"1x{TP_RANKS}",
           "card_shared_by_ranks": True,
           "collective_backend": ranks[0]["backend"],
           "gloo_cuda_probe": ranks[0]["gloo_cuda_probe"],
           "rings": {r: ranks[r]["rings"] for r in ranks}}
    summed = {}
    for label in ranks[0]["runs"]:
        per_rank = [ranks[r]["runs"][label] for r in range(TP_RANKS)]
        streams = [pr.pop("_streams") for pr in per_rank]
        logits = [pr.pop("_logits") for pr in per_rank]
        routes = [pr.pop("_routes") for pr in per_rank][0]
        if any(s != streams[0] for s in streams[1:]):
            raise AssertionError(f"serve_tp {label}: ranks' streams differ")
        if any(not np.array_equal(lg, logits[0]) for lg in logits[1:]):
            raise AssertionError(f"serve_tp {label}: ranks' logits differ")
        want = ref[label]
        kv1 = want["kv_token_bytes"]
        # GQA pools hold half the KV heads a rank; MLA's latent pools
        # replicate
        share = 1 if label.startswith("deepseek") else TP_RANKS
        for pr in per_rank:
            if pr["kv_token_bytes"] * share != kv1:
                raise AssertionError(f"serve_tp {label}: {pr['kv_token_bytes']}"
                                     f" B a token a rank, tp=1 {kv1}")
            for k, v in pr["kernel_launches"].items():
                summed[k] = summed.get(k, 0) + v
        prompts, sps = serve_requests(SamplingParams,
                                      want["model"].cfg.vocab_size)
        near, bad = tp_near_ties(torch, streams[0], want["streams"],
                                 prompts, sps, want)
        first = None
        if routes is not None:
            # MoE: a greedy parting at or after the first divergence (a
            # routing flip, itself a near tie, or a request whose sampled
            # stream parted) may follow from it through the batch's expert
            # capacity; one before it must be a near tie of the logits
            first = tp_moe_divergence(routes, want["routes"], streams[0],
                                      want["streams"])
            for p in near:
                p["step"] = want["routes"]["emitted"][p["request"]][p["token"]]
                p["after_first_divergence"] = (first is not None
                                               and p["step"] >= first["step"])
            bad = [p for p in bad if not p["after_first_divergence"]]
        lg1 = want["logits"]
        logit_share = float(np.abs(logits[0] - lg1).max()
                            / (SCORE_REL_TOL * np.abs(lg1).max()))
        row = {"per_rank": per_rank, "tp1_kv_token_bytes": kv1,
               "tp1_decode_step_ms_median": want["decode_step_ms_median"],
               "greedy_streams_equal": sum(
                   streams[0][i] == want["streams"][i]
                   for i, sp in enumerate(sps) if sp.is_greedy),
               "sampled_streams_equal": sum(
                   streams[0][i] == want["streams"][i]
                   for i, sp in enumerate(sps) if not sp.is_greedy),
               "greedy_near_ties": near,
               "first_decode_logits_share_of_limit": logit_share,
               **({"first_divergence": first} if routes is not None
                  else {})}
        out[label] = row
        print(f"  serve_tp {label}:", json.dumps(
            {k: v for k, v in row.items() if k != "per_rank"}
            | {"ranks": [{k: pr[k] for k in (
                "decode_step_ms_median", "device_busy_ms_per_step",
                "device_idle_share", "collective_bytes_per_decode_step",
                "psum_bytes_per_step", "host_copies_total", "kv_token_bytes",
                "kernel_launches", "peak_mem_gb")} for pr in per_rank]}))
        if first is not None and first["kind"] == "route_flip" \
                and not first["gap_share"] <= 1.0:
            raise AssertionError(f"serve_tp {label}: the first divergence "
                                 f"is a routing flip and no near tie: "
                                 f"{first}")
        if bad:
            raise AssertionError(f"serve_tp {label}: greedy streams part "
                                 f"from tp=1 at gaps above "
                                 f"{NEAR_TIE_BF16_ULPS} bf16 ulps: {bad}")
        if not logit_share <= 1.0:
            raise AssertionError(f"serve_tp {label}: first decode logits at "
                                 f"{logit_share} of {SCORE_REL_TOL} x max")
    out["kernel_launches_summed"] = summed
    del model, ds, ref
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# serve_disagg_tp: disaggregated serving across rank groups on the one card
# ---------------------------------------------------------------------------

DISAGG_TP_RANKS = 3
DISAGG_TP_MESH, DISAGG_TP_SPLIT = "1x3", (1, 2)     # prefill tp 1, decode tp 2
DISAGG_TP_SESSIONS = (("bf16", {}), ("fp8", {"cache_dtype": "fp8"}))


def disagg_tp_session(torch, model, pm, dm, kw: dict) -> dict:
    """One session of the llama mix on this rank of a disaggregated engine
    over ``split_mesh``'s slices ``pm`` (prefill) and ``dm`` (decode): the
    rank's phase, its kernel launches, the merged stats (the same on every
    serving rank), its own handoff share and wall, the decode-only steps'
    wall and (8 traced) device time, and the streams."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.kernels import LAUNCHES, VARIANT_LAUNCHES
    from repro_torch.kernels.decode_attention.paged_kernel import (
        NAME, NAME_SCALED,
    )
    from repro_torch.runtime.llm import LLMEngine
    from repro_torch.runtime.sampling import SamplingParams

    cfg = model.cfg
    on_card = model.device.type == "cuda"
    llm = LLMEngine(model, backend="continuous", device=model.device,
                    disaggregate=True, prefill_mesh=pm, decode_mesh=dm,
                    **TP_ENGINE, **kw)
    eng = llm._eng
    role = "decode" if eng.decode.member else "prefill"
    prompts, sps = serve_requests(SamplingParams, cfg.vocab_size)
    LAUNCHES.clear()
    VARIANT_LAUNCHES.clear()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    with profile(activities=acts, schedule=schedule(**PROFILE)) as prof:
        streams, finished, stats, decode_steps = serve_session(
            llm, prompts, sps, on_decode_step=prof.step if on_card else None)
    if on_card:
        torch.cuda.synchronize()
    launches = {k: v for k, v in LAUNCHES.items() if v}
    variants = {k: v for k, v in VARIANT_LAUNCHES.items() if v}
    for i, sp in enumerate(sps):
        o = finished.get(i)
        if (o is None or o.finish_reason != "length"
                or len(o.token_ids) != sp.max_tokens
                or o.token_ids != streams[i]):
            raise AssertionError(f"serve_disagg_tp {kw}: request {i} did "
                                 f"not finish with {sp.max_tokens} tokens")
    if stats.handoffs < len(prompts):
        raise AssertionError(f"serve_disagg_tp {kw}: {stats.handoffs} "
                             f"handoffs for {len(prompts)} requests")
    # the paged decode kernel: once a GQA layer a decode step on each
    # decode rank (at its local heads), never on the prefill rank
    kname = NAME_SCALED if kw.get("cache_dtype") else NAME
    want = {kname: gqa_layers(model) * stats.steps} if role == "decode" \
        else {}
    if on_card and launches != want:
        raise AssertionError(f"serve_disagg_tp {kw} ({role} rank): kernel "
                             f"launches {launches}, want {want}")
    if on_card and role == "decode" \
            and variants.get(f"{kname}:tensor_core") != want[kname]:
        raise AssertionError(f"serve_disagg_tp: {variants}, want every "
                             f"{kname} launch on the tensor-core variant")
    step_s = float(np.median(decode_steps))
    breakdown = (device_breakdown(prof, step_s) if on_card
                 else {"device_time": "not measured (CPU)"})
    ho = eng.handoff
    own = eng.decode if role == "decode" else eng.prefill
    result = {
        "role": role, "tp": own.serve_plan.tp,
        "local_heads": ([own.model.cfg.n_heads, own.model.cfg.n_kv_heads]),
        "kv_token_bytes": own.kv_token_bytes_per_device(),
        "handoffs": stats.handoffs, "handoff_pages": stats.handoff_pages,
        "handoff_bytes": stats.handoff_bytes,
        "handoff_shared_tokens": stats.handoff_shared_tokens,
        "handoff_deferrals": ho.deferrals,
        "own_handoff_bytes": ho.bytes_moved,
        "own_handoff_ms_total": 1e3 * ho.seconds,
        "own_handoff_ms_per_transfer": 1e3 * ho.seconds / max(ho.transfers,
                                                              1),
        "own_handoff_gb_per_s": ho.bytes_moved / max(ho.seconds, 1e-9) / 1e9,
        "phase_broadcasts": eng.link.broadcasts,
        "ttft_p50_s": stats.latency_quantiles("ttft")["p50"],
        "tokens_per_s": stats.total_tokens / stats.wall,
        "wall_s": stats.wall, "decode_steps": stats.steps,
        "prefill_calls": stats.prefill_calls,
        "decode_step_ms_median": 1e3 * step_s,
        "decode_only_steps": len(decode_steps),
        "device_busy_ms_per_step": breakdown.get("device_busy_ms_per_step"),
        "device_idle_share": breakdown.get("device_idle_share"),
        "kernel_launches": launches, "kernel_variants": variants,
        "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                        if on_card else None),
        "_streams": {i: list(o.token_ids) for i, o in finished.items()}}
    del llm, eng, ho, own
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return result


def disagg_tp_warmup(model, meshes: dict) -> None:
    """Two short requests through a disaggregated engine (on ``meshes``,
    or one card without them), so that the first session's readings hold
    no first use (CUDA, kernel loads, gloo's first meetings, pinned
    staging)."""
    from repro_torch.runtime.llm import LLMEngine
    from repro_torch.runtime.sampling import SamplingParams

    llm = LLMEngine(model, backend="continuous", device=model.device,
                    disaggregate=True, **meshes, **TP_ENGINE)
    gen = np.random.default_rng(0)
    llm.generate([gen.integers(0, model.cfg.vocab_size, 300)
                  for _ in range(2)], SamplingParams(max_tokens=4))
    del llm
    gc.collect()


def disagg_tp_rank(rank: int, rdzv: str, queue, model_spec: tuple,
                   device: str) -> None:
    """One rank of the phase (a spawned process): join the gloo group, cut
    the (1, 3) mesh into its 1:2 phase slices (every rank calls
    ``split_mesh``), build the model from the same seed as every rank,
    serve each session, and send the readings through ``queue``."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_world, parse_mesh
    from repro_torch.parallel.plan import split_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device == "cpu":
        torch.set_num_threads(1)
    init_world(device, backend="gloo", rank=rank,
               world_size=DISAGG_TP_RANKS, init_method=rdzv,
               timeout_s=TP_TIMEOUT_S)
    try:
        pm, dm = split_mesh(parse_mesh(DISAGG_TP_MESH, device),
                            *DISAGG_TP_SPLIT)
        model = tp_build(torch, *model_spec, device)
        disagg_tp_warmup(model, dict(prefill_mesh=pm, decode_mesh=dm))
        runs = {label: disagg_tp_session(torch, model, pm, dm, kw)
                for label, kw in DISAGG_TP_SESSIONS}
        queue.put((rank, runs))
    finally:
        dist.destroy_process_group()


def serve_disagg_tp_phase(torch, reduced: bool = False,
                          device: str = "cuda") -> dict:
    """Disaggregated serving across rank groups on the card: three ranks
    (spawned processes) share ``cuda:0`` over a gloo group as a (1, 3)
    mesh that ``split_mesh`` cuts 1:2: the prefill engine is tp 1 on rank
    0, the decode engine tp 2 on ranks 1-2 (16 query / 4 KV heads a
    rank), each rank mirroring the other phase's schedule, the KV pages
    handed from rank 0 to ranks 1 and 2 by head (each the half its heads
    hold) through the host over gloo.  llama3-8b at ``TP_LLAMA_LAYERS``
    layers, full width, serves the serve phase's mix over bf16 pools,
    then fp8 pools.  Holds: every request finishes with its 64 tokens,
    the same on every rank; every chain is handed off; the handoff's
    chains and pages equal the one-card ``DisaggServeEngine``'s on the
    same model and mix (this phase's own session), and its bytes summed
    over the decode ranks equal that session's, each decode rank
    receiving half and the prefill rank sending all; the paged decode
    kernel (``_scaled`` over fp8) launches once a layer a decode step on
    each decode rank, on its tensor-core variant, and never on the
    prefill rank; each greedy stream equals the one-card colocated
    engine's of the same options, or parts at a near tie
    (``tp_near_ties``: a top-2 gap within ``NEAR_TIE_BF16_ULPS`` bf16
    ulps on the one-card engine's own paged path, measured on the card:
    the decode group runs psum TP, whose sums differ from one card's in
    order).  Reports TTFT p50, the decode step's wall, busy and idle
    share on decode rank 1, and the handoff's pages, bytes, ms a
    transfer and GB/s on each rank, beside the one-card session's.  No
    reading is a disaggregated speed: three processes share one card
    and gloo stages every byte through the host.  ``reduced`` / ``device``
    let a CPU rehearsal run the phase at the reduced config."""
    import multiprocessing as mproc
    import queue as queue_mod
    import tempfile

    from repro_torch.runtime.llm import LLMEngine
    from repro_torch.runtime.sampling import SamplingParams

    on_card = device == "cuda"
    model_spec = tp_models(reduced)["llama"]
    model = tp_build(torch, *model_spec, device)
    prompts, sps = serve_requests(SamplingParams, model.cfg.vocab_size)
    # the one-card sessions first, alone on the card: colocated (streams
    # and the near-tie rule's model) and disaggregated (the handoff)
    disagg_tp_warmup(model, {})
    ref = {}
    for label, kw in DISAGG_TP_SESSIONS:
        co = LLMEngine(model, backend="continuous", device=device,
                       **TP_ENGINE, **kw)
        streams, _, _, _ = serve_session(co, prompts, sps)
        one = LLMEngine(model, backend="continuous", device=device,
                        disaggregate=True, **TP_ENGINE, **kw)
        _, _, st, steps = serve_session(one, prompts, sps)
        ho = one._eng.handoff
        ref[label] = {
            "streams": streams, "model": co._eng.model,
            "cache_dtype": co._eng.cache_dtype,
            "handoffs": st.handoffs, "handoff_pages": st.handoff_pages,
            "handoff_bytes": st.handoff_bytes,
            "handoff_ms_per_transfer": 1e3 * ho.seconds / max(ho.transfers,
                                                              1),
            "handoff_gb_per_s": st.handoff_bytes / max(ho.seconds, 1e-9)
            / 1e9,
            "ttft_p50_s": st.latency_quantiles("ttft")["p50"],
            "decode_step_ms_median": 1e3 * float(np.median(steps))}
        del co, one, ho
        gc.collect()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mproc.get_context("spawn")
        q = ctx.Queue()
        procs = [ctx.Process(target=disagg_tp_rank,
                             args=(r, f"file://{tmp}/rdzv", q, model_spec,
                                   device))
                 for r in range(DISAGG_TP_RANKS)]
        for p in procs:
            p.start()
        ranks, deadline = {}, time.monotonic() + TP_JOIN_S
        try:
            while len(ranks) < DISAGG_TP_RANKS:
                try:
                    r, res = q.get(timeout=2.0)
                    ranks[r] = res
                except queue_mod.Empty:
                    dead = [p.exitcode for p in procs
                            if p.exitcode not in (None, 0)]
                    if dead:
                        raise AssertionError(f"serve_disagg_tp: a rank "
                                             f"failed (exit codes {dead})")
                    if time.monotonic() > deadline:
                        raise AssertionError(f"serve_disagg_tp: ranks not "
                                             f"done after {TP_JOIN_S} s")
            for p in procs:
                p.join(timeout=TP_TIMEOUT_S)
                if p.exitcode != 0:
                    raise AssertionError(f"serve_disagg_tp: rank exit code "
                                         f"{p.exitcode}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    out = {"phase": "serve_disagg_tp", "ranks": DISAGG_TP_RANKS,
           "mesh": DISAGG_TP_MESH, "split": list(DISAGG_TP_SPLIT),
           "layers": model.cfg.n_layers, "card_shared_by_ranks": True}
    summed = {}
    for label, _ in DISAGG_TP_SESSIONS:
        per_rank = [ranks[r][label] for r in range(DISAGG_TP_RANKS)]
        streams = [pr.pop("_streams") for pr in per_rank]
        if any(s != streams[0] for s in streams[1:]):
            raise AssertionError(f"serve_disagg_tp {label}: ranks' streams "
                                 f"differ")
        merged = {k: per_rank[0][k] for k in (
            "handoffs", "handoff_pages", "handoff_bytes",
            "handoff_shared_tokens")}
        if any({k: pr[k] for k in merged} != merged for pr in per_rank):
            raise AssertionError(f"serve_disagg_tp {label}: ranks' merged "
                                 f"stats differ")
        want = ref[label]
        roles = [pr["role"] for pr in per_rank]
        dec = [pr for pr in per_rank if pr["role"] == "decode"]
        pre = [pr for pr in per_rank if pr["role"] == "prefill"]
        if roles != ["prefill", "decode", "decode"] \
                or [pr["tp"] for pr in per_rank] != [1, 2, 2]:
            raise AssertionError(f"serve_disagg_tp {label}: roles {roles}")
        if (merged["handoffs"], merged["handoff_pages"],
                merged["handoff_bytes"]) != (
                want["handoffs"], want["handoff_pages"],
                want["handoff_bytes"]):
            raise AssertionError(f"serve_disagg_tp {label}: handoff {merged}"
                                 f", one card {want}")
        if [pr["own_handoff_bytes"] for pr in dec] != \
                [want["handoff_bytes"] // 2] * 2 \
                or pre[0]["own_handoff_bytes"] != want["handoff_bytes"]:
            raise AssertionError(
                f"serve_disagg_tp {label}: decode ranks received "
                f"{[pr['own_handoff_bytes'] for pr in dec]}, the prefill "
                f"rank sent {pre[0]['own_handoff_bytes']}, one card moved "
                f"{want['handoff_bytes']}")
        for pr in dec:
            for k, v in pr["kernel_launches"].items():
                summed[k] = summed.get(k, 0) + v
        near, bad = tp_near_ties(torch, streams[0], want["streams"],
                                 prompts, sps, want)
        row = {"per_rank": per_rank, **merged,
               "one_card": {k: v for k, v in want.items()
                            if k not in ("streams", "model",
                                         "cache_dtype")},
               "greedy_streams_equal": sum(
                   streams[0][i] == want["streams"][i]
                   for i, sp in enumerate(sps) if sp.is_greedy),
               "sampled_streams_equal": sum(
                   streams[0][i] == want["streams"][i]
                   for i, sp in enumerate(sps) if not sp.is_greedy),
               "greedy_near_ties": near}
        out[label] = row
        print(f"  serve_disagg_tp {label}:", json.dumps(
            {k: v for k, v in row.items() if k != "per_rank"}
            | {"ranks": [{k: pr[k] for k in (
                "role", "tp", "local_heads", "ttft_p50_s",
                "decode_step_ms_median", "device_busy_ms_per_step",
                "device_idle_share", "own_handoff_bytes",
                "own_handoff_ms_per_transfer", "own_handoff_gb_per_s",
                "kernel_launches", "peak_mem_gb")} for pr in per_rank]}))
        if bad:
            raise AssertionError(f"serve_disagg_tp {label}: greedy streams "
                                 f"part from one card's at gaps above "
                                 f"{NEAR_TIE_BF16_ULPS} bf16 ulps: {bad}")
    out["kernel_launches_summed"] = summed
    del model, ref
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# examples: the port's four examples as a user runs them
# ---------------------------------------------------------------------------

# (example, its flags on the card, lines its output must hold)
EXAMPLES = (
    ("torch_quickstart.py", ["--arch", "qwen3-14b", "--layers", "2"],
     ("== HBM-CO (paper §III) ==", "energy ratio: 2.43x",
      "== PyTorch framework: qwen3-14b at 2 layers", "step 4: loss",
      "generated:", "== DeploymentSpec", "deployment: h100")),
    ("torch_serve_decode.py", ["--layers", "2", "--batch", "4", "--new",
                               "16"],
     ("[static decode] 4 requests x 16 tokens", "greedy row:",
      "sampled row:", "deployment: rpu-cu",
      "[continuous] streamed deltas per request: {0: 8, 1: 8, 2: 8, 3: 8}")),
    ("torch_train_small.py", ["--steps", "20", "--no-failure"],
     ("model: lm-100m", "done: 20 steps")),
    ("torch_design_space.py", [],
     ("model llama3-70b:", "frontier SKUs:", "   CUs")),
)
EXAMPLE_TIMEOUT_S = 300


def examples_phase(torch) -> dict:
    """The four ``examples/torch_*.py`` as subprocesses on the card, at
    short settings (``EXAMPLES``): quickstart with qwen3-14b at full width
    cut to 2 layers, serve_decode at 2 layers (danube's widths, 4 requests
    of 16 tokens), train_small 20 steps of lm-100m with its checkpoints in
    a temporary directory, design_space as it is.  Each must exit 0 and
    print its summary lines, and the quickstart's static section must
    launch the flash kernel (once a layer a prefill) and the dense decode
    kernel (once a layer a decode step), as its ``kernel launches`` line
    reports; section 4 serves MXFP4 weights through ``mxfp4_vmm`` over
    bf16 pages through the paged decode kernel."""
    import tempfile

    out = {"phase": "examples"}
    env = {**os.environ, "PYTHONPATH": os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "src")}
    with tempfile.TemporaryDirectory() as tmp:
        for name, flags, lines in EXAMPLES:
            extra = (["--ckpt-dir", os.path.join(tmp, "ckpt")]
                     if name == "torch_train_small.py" else [])
            t = time.monotonic()
            r = subprocess.run(
                [sys.executable, os.path.join(
                    os.path.dirname(os.path.abspath(__file__)), "examples",
                    name), *flags, *extra],
                env=env, cwd=tmp, capture_output=True, text=True,
                timeout=EXAMPLE_TIMEOUT_S)
            seconds = time.monotonic() - t
            if r.returncode != 0:
                raise AssertionError(f"examples: {name} exited "
                                     f"{r.returncode}: {r.stdout[-2000:]}"
                                     f"{r.stderr[-4000:]}")
            missing = [ln for ln in lines if ln not in r.stdout]
            if missing:
                raise AssertionError(f"examples: {name} printed no "
                                     f"{missing}: {r.stdout[-3000:]}")
            launches = [json.loads(ln.split(": ", 1)[1].replace("'", '"'))
                        for ln in r.stdout.splitlines()
                        if ln.strip().startswith("kernel launches:")]
            out[name] = {"seconds": seconds, "kernel_launches": launches,
                         "tail": r.stdout.splitlines()[-3:]}
            print(f"  examples {name}: {seconds:.1f} s, launches "
                  f"{launches}")
    cfg_layers = 2
    static, cont = out["torch_quickstart.py"]["kernel_launches"]
    # two 16-token prompts: one prefill (flash once a layer) and 7 decode
    # steps (the dense decode once a layer each)
    want = {"flash_attention": cfg_layers,
            "decode_attention": cfg_layers * 7}
    if {k: static.get(k, 0) for k in want} != want:
        raise AssertionError(f"examples: the quickstart's static section "
                             f"launched {static}, want {want}")
    if not cont.get("mxfp4_vmm") or not cont.get("paged_decode_attention"):
        raise AssertionError(f"examples: the quickstart's continuous "
                             f"section launched {cont}")
    return out


# ---------------------------------------------------------------------------
# train_tp: parallel training, two ranks sharing the one card
# ---------------------------------------------------------------------------

TRAIN_TP_RANKS = 2
TRAIN_TP_JOIN_S = 600
TRAIN_TP_LAYERS = 2            # qwen3-14b: 2 of 40; deepseek: 2 of 27
TRAIN_TP_BATCH, TRAIN_TP_SEQ = 4, 1024
TRAIN_TP_STEPS = 2
TRAIN_TP_LR = 1e-4
# (label, model, mesh, pods, steps, traced): qwen3 on (1, 2) is TP with
# sequence parallelism, on (2, 1) DP with FSDP, on (2 pods, 1, 1) DP over
# two pods with the int8 cross-pod mean; deepseek on (1, 2), on the
# capacity path with 32 of its 64 experts a rank.  The FSDP sessions move
# the whole weights and gradients through gloo's host copies every step
# (~4.4 GB a rank): one step each; the last step of a traced session is
# traced (busy ms)
TRAIN_TP_SESSIONS = (("qwen_1x2", "qwen", "1x2", 0, 2, False),
                     ("qwen_2x1", "qwen", "2x1", 0, 1, False),
                     ("deepseek_1x2", "deepseek", "1x2", 0, 2, True),
                     ("qwen_pods_2x1x1", "qwen", "2x1x1", 2, 1, False))
# gloo's rate on one card's CUDA tensors, both ways of moving them: its own
# copies (all-gather) and ours through pinned memory (reduce-scatter)
TRAIN_TP_PROBE_BYTES = 1 << 26
# one leaf of each kind whose gradient, gathered whole, is held / read:
# vocabulary rows, vocabulary columns, a replicated norm, column- and
# row-parallel projections, a per-head norm, KV columns (qwen3's 8 KV
# heads, 4 a rank); MLA's up-projection and its replicated latent
# projection, the router, the experts, a shared expert
TRAIN_TP_LEAVES = {
    "qwen": ("embed", "head", "final_norm", "layers.0.ln1",
             "layers.0.attn.wq", "layers.0.attn.wk", "layers.0.attn.q_norm",
             "layers.0.attn.wo", "layers.1.mlp.w_gate", "layers.1.mlp.w_down"),
    "deepseek": ("embed", "layers.0.attn.w_uk", "layers.0.attn.w_dkv",
                 "layers.1.moe.router", "layers.1.moe.w_gate",
                 "layers.1.moe.shared.w_down"),
    # the pods session keeps its in-pod gradients too: no vocabulary leaf
    # (1.6 GB each), for the memory of two ranks holding residuals
    "qwen_pods": ("final_norm", "layers.0.ln1", "layers.0.attn.wq",
                  "layers.0.attn.wk", "layers.0.attn.q_norm",
                  "layers.0.attn.wo", "layers.1.mlp.w_gate",
                  "layers.1.mlp.w_down")}
# a bf16 gradient of the sharded step against tp=1's: the same step in f32
# on the card is the witness; the sharded step must be as close to it as
# tp=1 is, to within this factor, plus 2^-8 of the witness's largest
# magnitude (bf16's half ulp: where tp=1 is already exact)
TRAIN_TP_GRAD_FACTOR = 2.0
TRAIN_TP_GRAD_FLOOR = 2.0 ** -8
# |loss - tp=1's loss|, absolute: a bf16 model's reduction order (partial
# sums over ranks) at a loss near ln(152064) = 11.9
TRAIN_TP_LOSS_ABS = 2e-2
# a token whose experts differ between the sharded step and tp=1 must be a
# near tie of tp=1's router: the gap between its k-th and (k+1)-th
# probabilities within this factor of the largest gap at which tp=1's own
# bf16 routing flips against the same forward in f32 (the witness; a
# first limit of 2^-10, from an estimate of the rounding, missed: a flip
# at 1.08e-3, measured on one H100)
TRAIN_TP_ROUTE_FACTOR = 2.0


def train_tp_models(reduced: bool = False) -> dict:
    """The phase's models as (config name, layers, reduced); ``reduced``
    gives their tiny configs (the CPU rehearsal)."""
    return {"qwen": ("qwen3-14b", TRAIN_TP_LAYERS, reduced),
            "deepseek": ("deepseek-v2-lite-16b", TRAIN_TP_LAYERS, reduced)}


def train_tp_cfg(name: str, layers: int, reduced: bool):
    from repro_torch.configs import get_config, reduced_config
    cfg = get_config(name)
    return (reduced_config(cfg) if reduced
            else dataclasses.replace(cfg, n_layers=layers))


def train_tp_batches(cfg, batch: int, seq: int) -> list:
    """The sessions' global batches, from a seed (numpy tokens)."""
    rng = np.random.default_rng(11)
    return [rng.integers(0, cfg.vocab_size, (batch, seq), dtype=np.int32)
            for _ in range(TRAIN_TP_STEPS)]


class RouteRecorder:
    """The MoE layers' routing (probabilities and expert ids) of the
    forwards run while it is on (``moe._routing`` wrapped)."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.models import moe
        self._orig = moe._routing

        def routing(x2d, router, k):
            w, ids = self._orig(x2d, router, k)
            probs = torch_softmax(x2d, router)
            self.calls.append((probs.detach().cpu(), ids.detach().cpu()))
            return w, ids
        moe._routing = routing
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._routing = self._orig
        return False


def torch_softmax(x2d, router):
    import torch
    return torch.softmax(x2d.float() @ router.float(), dim=-1)


def routing_divergence(got, want, k: int) -> dict:
    """Tokens whose top-k experts differ between two recorded forwards of
    one MoE layer, and at each such token the gap between the k-th and
    the (k+1)-th probability of ``want``'s router (a flip must be a near
    tie of its probabilities)."""
    pg, ig = got
    pw, iw = want
    diff = ~(ig.sort(dim=-1).values == iw.sort(dim=-1).values).all(dim=-1)
    rows = diff.nonzero()[:, 0]
    top = pw.sort(dim=-1, descending=True).values
    gaps = (top[rows, k - 1] - top[rows, k]).tolist()
    return {"tokens": int(iw.shape[0]), "flipped": int(rows.numel()),
            "first": int(rows[0]) if rows.numel() else None,
            "max_gap_at_flip": max(gaps) if gaps else None}


# the elements of a held gradient that are compared: every column of the
# first rows the batch's tokens look up (an embedding's gradient lives
# there), or a seeded sample of the leaf
TRAIN_TP_SAMPLE = 1 << 18
TRAIN_TP_EMBED_ROWS = 64


def grad_sample_index(torch, name: str, shape, tokens: np.ndarray):
    """Flat indices of the compared elements of leaf ``name`` (CPU int64):
    the same in the parent and on every rank."""
    n = math.prod(shape)
    if name == "embed":
        rows = torch.from_numpy(np.unique(tokens)[:TRAIN_TP_EMBED_ROWS])
        cols = torch.arange(shape[1])
        return (rows[:, None] * shape[1] + cols[None, :]).reshape(-1)
    if n <= TRAIN_TP_SAMPLE:
        return torch.arange(n)
    gen = torch.Generator().manual_seed(sum(map(ord, name)))
    return torch.randint(n, (TRAIN_TP_SAMPLE,), generator=gen)


def grad_sample(torch, lay, name: str, shard, idx):
    """The elements ``idx`` of a sharded leaf's whole gradient, on every
    rank: each rank adds those in its stored block (a block several ranks
    hold, only the first: ``TrainLayout.owner``) into a zero vector, then
    one all-reduce over the world.  No rank gathers the leaf."""
    leaf = lay.leaves[name]
    coords = torch.unravel_index(idx, leaf.shape)
    mine = torch.ones(idx.shape, dtype=torch.bool)
    local = []
    for c, b in zip(coords, leaf.block):
        mine &= (c >= b.start) & (c < b.stop)
        local.append((c - b.start).clamp(0, b.stop - b.start - 1))
    vals = torch.zeros(idx.shape, dtype=torch.float32, device=shard.device)
    if lay.owner(name):
        got = shard.float()[tuple(t.to(shard.device) for t in local)]
        vals = torch.where(mine.to(shard.device), got, vals)
    return lay.groups.comms["world"].all_reduce_op(vals).cpu()


def train_tp_one(torch, key: str, spec: tuple, device: str) -> dict:
    """tp=1 on the card: ``TRAIN_TP_STEPS`` steps of the seed-built model,
    the losses, the held leaves' gradients of the first step (f32, on
    the host), the routing of deepseek's MoE layer, and the f32 witness
    (the first step's loss, gradients and routing in f32)."""
    from repro_torch.models.model import Model
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step

    cfg = train_tp_cfg(*spec)
    dev = torch.device(device)
    batches = train_tp_batches(cfg, TRAIN_TP_BATCH, TRAIN_TP_SEQ
                               if not spec[2] else 32)
    model = Model(cfg, device=dev, moe_impl="capacity" if cfg.moe else "auto")
    state = init_train_state(model, seed=0)
    step = make_train_step(model, AdamWConfig(lr=TRAIN_TP_LR),
                           keep_grads=TRAIN_TP_LEAVES[key])
    out = {"losses": [], "step_ms": []}
    if on_cuda(dev):
        torch.cuda.reset_peak_memory_stats()
    for i, b in enumerate(batches):
        sync(torch, dev)
        t0 = time.perf_counter()
        with RouteRecorder() as rec:
            state, met = step(state, {"tokens": torch.from_numpy(b).to(dev)})
            loss = float(met["loss"])
        out["step_ms"].append(1e3 * (time.perf_counter() - t0))
        out["losses"].append(loss)
        if i == 0:
            out["grads"] = {n: step.grads[n].float().reshape(-1)[
                grad_sample_index(torch, n, step.grads[n].shape,
                                  batches[0]).to(dev)].cpu()
                            for n in TRAIN_TP_LEAVES[key]}
            out["routes"] = rec.calls
    out["peak_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                      if on_cuda(dev) else None)
    del state, step, model
    gc.collect()
    # the witness: the first step's loss and gradients in f32 (and its
    # routing, for the MoE)
    model = Model(cfg, device=dev, moe_impl="capacity" if cfg.moe
                  else "auto").init(0).float()
    model.requires_grad_(True)
    with RouteRecorder() as rec:
        loss = model.loss({"tokens": torch.from_numpy(batches[0]).to(dev)})
    loss.backward()
    named = dict(model.named_parameters())
    out["f32"] = {"loss": float(loss.detach()),
                  "grads": {n: named[n].grad.float().reshape(-1)[
                      grad_sample_index(torch, n, named[n].shape,
                                        batches[0]).to(dev)].cpu()
                            for n in TRAIN_TP_LEAVES[key]}}
    out["f32_routes"] = rec.calls
    del model, named, loss
    gc.collect()
    if on_cuda(dev):
        torch.cuda.empty_cache()
    return out


def on_cuda(dev) -> bool:
    return dev.type == "cuda"


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def train_tp_session(torch, key, spec, mesh_spec: str, pods: int,
                     device: str, steps: int = TRAIN_TP_STEPS,
                     traced: bool = False) -> dict:
    """One session on this rank: the sharded state of the seed-built
    model, ``steps`` steps (with ``traced`` the last under the
    profiler), and the readings: losses, stored bytes against the plan's,
    the last step's collective calls and bytes by kind against
    ``predict_step_bytes``,
    step wall / busy ms, peak GB, the held leaves' gradients gathered
    whole, deepseek's routing, and with pods the compression's bound."""
    import torch.distributed as dist

    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.models.model import Model
    from repro_torch.parallel.plan import make_plan
    from repro_torch.parallel.train import predict_step_bytes, state_bytes
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step

    cfg = train_tp_cfg(*spec)
    dev = torch.device(device)
    batches = train_tp_batches(cfg, TRAIN_TP_BATCH, TRAIN_TP_SEQ
                               if not spec[2] else 32)[:steps]
    leaves = TRAIN_TP_LEAVES["qwen_pods" if pods else key]
    mesh = parse_mesh(mesh_spec, device)
    model = Model(cfg, device=dev, moe_impl="capacity" if cfg.moe else "auto")
    plan = make_plan(cfg, mesh, global_batch=TRAIN_TP_BATCH,
                     shape_kind="train")
    state = init_train_state(model, seed=0, plan=plan, n_pods=pods)
    model.to("meta")                  # the whole weights: the shards stay
    gc.collect()
    if on_cuda(dev):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    lay = state.layout
    dtypes = {n: p.dtype for n, p in state.params.items()}
    held = sum(t.nbytes for tree in (state.params, state.opt_state["m"],
                                     state.opt_state["v"])
               for t in tree.values())
    plan_bytes = state_bytes(lay, dtypes, 4)
    step = make_train_step(model, AdamWConfig(lr=TRAIN_TP_LR), plan=plan,
                           compress_pods=bool(pods), keep_grads=leaves)
    out = {"losses": [], "step_ms": []}
    LAUNCHES.clear()
    for i, b in enumerate(batches):
        local = lay.local_rows({"tokens": torch.from_numpy(b).to(dev)})
        last = i == len(batches) - 1
        if last:
            lay.groups.reset_counts()
        sync(torch, dev)
        t0 = time.perf_counter()
        prof = None
        with RouteRecorder() as rec:
            if last and traced and on_cuda(dev):
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    state, met = step(state, local)
                    loss = float(met["loss"])
            else:
                state, met = step(state, local)
                loss = float(met["loss"])
        out["step_ms"].append(1e3 * (time.perf_counter() - t0))
        out["losses"].append(loss)
        if last:
            counts = lay.groups.counts()
            out["counts"] = {k: v for k, v in counts.items()
                             if not k.startswith("step:") and v}
            out["step_counts"] = {k: v for k, v in counts.items()
                                  if k.startswith("step:") and v}
            out["predicted"] = predict_step_bytes(lay, local, dtypes)
        if i == 0:
            out["grads"] = {n: grad_sample(
                torch, lay, n, step.grads[n],
                grad_sample_index(torch, n, lay.leaves[n].shape, b))
                for n in leaves}
            out["routes"] = rec.calls
            if pods:
                # |mean - the pods' exact mean| <= half a code step of the
                # pods' scales, plus the cast of the mean to bf16; the
                # exact mean (the step's gradient) is held as tp=1's
                bound, pod_mean = {}, {}
                for n in leaves:
                    g = lay.gather_pod_regions(n, step.pod_grads[n]).float()
                    scales = g.flatten(1).abs().amax(dim=1) / 127.0
                    exact = g.mean(dim=0)
                    idx = grad_sample_index(torch, n, lay.leaves[n].shape, b)
                    pod_mean[n] = exact.reshape(-1)[idx.to(dev)].cpu()
                    synced = lay.gather_full(n, step.grads[n]).float()
                    err = (synced - exact).abs().max()
                    limit = 0.5 * scales.mean() + 2.0 ** -8 * exact.abs().max()
                    resid = lay.gather_pod_regions(n, state.err[n]).abs().max()
                    bound[n] = {"err": float(err), "limit": float(limit),
                                "residual_max": float(resid),
                                "half_code_step": float(0.5 * scales.max())}
                out["compression"] = bound
                out["pod_mean_grads"] = pod_mean
    if prof is not None:
        busy = sum(trace_summary(prof)["device_us"].values()) / 1e3
        out["busy_ms"] = busy
    else:
        out["busy_ms"] = None
    out.update({
        "mesh": mesh_spec, "stored_bytes": held,
        "plan_bytes": plan_bytes["params"] + plan_bytes["moments"],
        "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                    if on_cuda(dev) else None),
        "kernel_launches": {k: v for k, v in LAUNCHES.items() if v},
        "host_copies": out["counts"].get("host_copies", 0),
        "host_bytes": out["counts"].get("host_bytes", 0)})
    del state, step
    gc.collect()
    dist.barrier()
    if on_cuda(dev):
        torch.cuda.empty_cache()
    return out


def train_tp_checkpoint(torch, device: str, tmp: str) -> dict:
    """A checkpoint written by (1, 2) and restored by (2, 1): every leaf
    bitwise, and a step on each mesh after it agrees.  The reduced qwen3
    (a full-width state is ~22 GB of files: minutes of disk, past the
    phase's budget)."""
    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.models.model import Model
    from repro_torch.parallel.plan import make_plan
    from repro_torch.train import (
        AdamWConfig, init_train_state, make_train_step, restore_latest,
        save_checkpoint,
    )

    cfg = train_tp_cfg("qwen3-14b", 2, True)
    dev = torch.device(device)
    tokens = torch.from_numpy(train_tp_batches(cfg, 8, 32)[0]).to(dev)
    out = {}
    states = {}
    for spec in ("1x2", "2x1"):
        mesh = parse_mesh(spec, device)
        plan = make_plan(cfg, mesh, global_batch=8, shape_kind="train")
        states[spec] = (init_train_state(Model(cfg, device=dev), seed=0,
                                         plan=plan), plan)
    state, plan = states["1x2"]
    step12 = make_train_step(Model(cfg, device="meta"),
                             AdamWConfig(lr=TRAIN_TP_LR), plan=plan)
    state, _ = step12(state, state.layout.local_rows({"tokens": tokens}))
    t0 = time.perf_counter()
    save_checkpoint(tmp, 1, state)
    out["save_s"] = time.perf_counter() - t0
    template, plan21 = states["2x1"]
    t0 = time.perf_counter()
    back, at = restore_latest(tmp, template)
    out["restore_s"] = time.perf_counter() - t0
    whole = {n: state.layout.gather_full(n, p.detach())
             for n, p in state.params.items()}
    again = {n: back.layout.gather_full(n, p.detach())
             for n, p in back.params.items()}
    out["restored_step"] = at
    out["bitwise"] = all(torch.equal(whole[n], again[n]) for n in whole)
    step21 = make_train_step(Model(cfg, device="meta"),
                             AdamWConfig(lr=TRAIN_TP_LR), plan=plan21)
    _, m21 = step21(back, back.layout.local_rows({"tokens": tokens}))
    _, m12 = step12(state, state.layout.local_rows({"tokens": tokens}))
    out["next_loss"] = {"restored_2x1": float(m21["loss"]),
                        "saved_1x2": float(m12["loss"])}
    return out


def train_tp_gloo_probe(torch, device: str) -> dict:
    """GB/s of a ``TRAIN_TP_PROBE_BYTES`` bf16 all-gather (gloo's own
    copies of the CUDA tensor) and reduce-scatter (staged through pinned
    host memory by ``TPComm``) between the two ranks: what the sessions'
    collectives cost a byte."""
    import torch.distributed as dist

    from repro_torch.parallel.hints import TPComm

    comm = TPComm(None)
    x = torch.ones(TRAIN_TP_PROBE_BYTES // 2, dtype=torch.bfloat16,
                   device=device)
    out = {}
    for name, op in (("all_gather", lambda: comm.all_gather_dim(x, 0)),
                     ("reduce_scatter",
                      lambda: comm.reduce_scatter_dim(x, 0))):
        op()                                  # warm
        dist.barrier()
        sync(torch, torch.device(device))
        t0 = time.perf_counter()
        op()
        sync(torch, torch.device(device))
        out[f"{name}_gb_per_s"] = x.nbytes / (time.perf_counter() - t0) / 1e9
    return out


def train_tp_rank(rank: int, rdzv: str, queue, models: dict, device: str,
                  tmp: str) -> None:
    """One rank of the phase (a spawned process): every session on its
    mesh, then the checkpoint; the readings to the parent through
    ``queue``."""
    # two ranks share the card with a few GB to spare: no fragmentation
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_world

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device == "cpu":
        torch.set_num_threads(1)
    t_rank = time.perf_counter()
    init_world(device, backend="gloo", rank=rank, world_size=TRAIN_TP_RANKS,
               init_method=rdzv, timeout_s=TP_TIMEOUT_S)
    try:
        runs = {}
        probe = train_tp_gloo_probe(torch, device)
        for label, key, spec, pods, steps, traced in TRAIN_TP_SESSIONS:
            t0 = time.perf_counter()
            runs[label] = train_tp_session(torch, key, models[key], spec,
                                           pods, device, steps, traced)
            runs[label]["session_s"] = time.perf_counter() - t0
            if rank == 0:
                print(f"  train_tp rank 0: {label} done in "
                      f"{runs[label]['session_s']:.1f} s, steps "
                      f"{[round(x) for x in runs[label]['step_ms']]} ms, "
                      f"peak {runs[label]['peak_gb']} GB", flush=True)
        t0 = time.perf_counter()
        ckpt = train_tp_checkpoint(torch, device, os.path.join(tmp, "ckpt"))
        ckpt["session_s"] = time.perf_counter() - t0
        ckpt["rank_seconds"] = time.perf_counter() - t_rank
        # through a file: a queue would pass the tensors as shared memory,
        # gone once this process exits
        path = os.path.join(tmp, f"rank{rank}.pt")
        torch.save({"runs": runs, "checkpoint": ckpt, "gloo_probe": probe},
                   path)
        queue.put((rank, path))
    finally:
        dist.destroy_process_group()


def grad_hold(got: dict, tp1: dict, witness: dict) -> dict:
    """Per leaf: max |sharded - tp=1|, and the sharded step's and tp=1's
    max distance from the f32 witness; ok when the sharded step is within
    ``TRAIN_TP_GRAD_FACTOR`` of tp=1's distance plus the floor."""
    out = {}
    for n, w in witness.items():
        top = float(w.abs().max())
        d_tp = float((got[n] - w).abs().max())
        d_one = float((tp1[n] - w).abs().max())
        limit = TRAIN_TP_GRAD_FACTOR * d_one + TRAIN_TP_GRAD_FLOOR * top
        out[n] = {"vs_tp1": float((got[n] - tp1[n]).abs().max()),
                  "tp_vs_f32": d_tp, "tp1_vs_f32": d_one, "limit": limit,
                  "ok": d_tp <= limit}
    return out


def train_tp_phase(torch, models: dict | None = None,
                   device: str = "cuda") -> dict:
    """Parallel training on the card: two ranks (spawned processes) sharing
    ``cuda:0`` over a gloo group.  qwen3-14b at full width (``TRAIN_TP_LAYERS``
    of 40 layers), B ``TRAIN_TP_BATCH`` x ``TRAIN_TP_SEQ``, ``TRAIN_TP_STEPS``
    steps on (1, 2) (TP with sequence parallelism) and (2, 1) (DP with
    FSDP), on (2 pods, 1, 1) with the int8 cross-pod mean, and
    deepseek-v2-lite at full width (2 of 27 layers: one dense, one MoE) on
    (1, 2) on the capacity path; then a checkpoint of the reduced qwen3
    written on (1, 2) and restored on (2, 1).  Each session against a tp=1
    session of the same seed-built weights and batches, run first here
    (and freed before the ranks start).  Holds: every rank stores the
    plan's bytes; each second step's collective bytes by kind equal the
    prediction; every loss within ``TRAIN_TP_LOSS_ABS`` of tp=1's; every
    session's held gradients (with pods the exact cross-pod mean of the
    in-pod ones) by the f32 witness (``grad_hold``); deepseek's routing
    flips are near ties (``TRAIN_TP_ROUTE_FACTOR`` of tp=1's own flips
    against f32); the compressed mean within half a code step of
    the pods' exact mean; the checkpoint bitwise.  Training launches no
    hand-written kernel (attention under autograd is plain): the count is
    printed.  No number here is a parallel speed: both ranks share one
    card and gloo copies every collective through the host."""
    import multiprocessing as mproc
    import queue as queue_mod
    import tempfile

    models = models or train_tp_models()
    t_phase = time.monotonic()
    ref = {}
    for key in models:
        ref[key] = train_tp_one(torch, key, models[key], device)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.monotonic() - t_phase
    print(f"  train_tp tp=1 ({t_ref:.1f} s): " + json.dumps(
        {k: {"losses": v["losses"], "step_ms": v["step_ms"],
             "peak_gb": v["peak_gb"]} for k, v in ref.items()}), flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_tp_") as tmp:
        ctx = mproc.get_context("spawn")
        q = ctx.Queue()
        procs = [ctx.Process(target=train_tp_rank,
                             args=(r, f"file://{tmp}/rdzv", q, models,
                                   device, tmp))
                 for r in range(TRAIN_TP_RANKS)]
        for p in procs:
            p.start()
        ranks, deadline = {}, time.monotonic() + TRAIN_TP_JOIN_S
        try:
            while len(ranks) < TRAIN_TP_RANKS:
                try:
                    r, path = q.get(timeout=2.0)
                    ranks[r] = torch.load(path, weights_only=False)
                except queue_mod.Empty:
                    dead = [p.exitcode for p in procs
                            if p.exitcode not in (None, 0)]
                    if dead:
                        raise AssertionError(f"train_tp: a rank failed "
                                             f"(exit codes {dead})")
                    if time.monotonic() > deadline:
                        raise AssertionError(f"train_tp: ranks not done "
                                             f"after {TRAIN_TP_JOIN_S} s")
            for p in procs:
                p.join(timeout=TP_TIMEOUT_S)
                if p.exitcode != 0:
                    raise AssertionError(f"train_tp: rank exit code "
                                         f"{p.exitcode}")
            t_ranks = time.monotonic() - t_phase - t_ref
            print(f"  train_tp: the ranks took {t_ranks:.1f} s (spawn to "
                  f"exit)", flush=True)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    out = {"phase": "train_tp", "ranks": TRAIN_TP_RANKS,
           "card_shared_by_ranks": True, "collective_backend": "gloo",
           "tp1_seconds": t_ref, "ranks_seconds": t_ranks, "sessions": {}}
    problems = []
    launched = {}
    out["gloo_probe"] = ranks[0]["gloo_probe"]
    for label, key, spec, pods, _, _ in TRAIN_TP_SESSIONS:
        per = [ranks[r]["runs"][label] for r in range(TRAIN_TP_RANKS)]
        one = ref[key]
        first = per[0]
        row = {"model": key, "mesh": spec, "pods": pods,
               "tp1_losses": one["losses"], "tp1_step_ms": one["step_ms"],
               "tp1_peak_gb": one["peak_gb"], "ranks": []}
        for r, pr in enumerate(per):
            if pr["losses"] != first["losses"]:
                problems.append(f"{label}: rank {r}'s losses differ")
            if pr["stored_bytes"] != pr["plan_bytes"]:
                problems.append(f"{label}: rank {r} stores "
                                f"{pr['stored_bytes']} B, the plan "
                                f"{pr['plan_bytes']}")
            got = {k: v for k, v in pr["counts"].items()
                   if k.endswith("_bytes") and k not in ("host_bytes",)}
            if got != pr["predicted"]:
                problems.append(f"{label}: rank {r} collective bytes "
                                f"{got} != predicted {pr['predicted']}")
            for k, v in pr["kernel_launches"].items():
                launched[k] = launched.get(k, 0) + v
            row["ranks"].append({
                "stored_gb": pr["stored_bytes"] / 1e9,
                "plan_gb": pr["plan_bytes"] / 1e9,
                "collective_bytes_by_kind": got,
                "collective_calls_by_kind": {
                    k: v for k, v in pr["counts"].items()
                    if not k.endswith("_bytes") and ":" in k},
                "step_phase_bytes": {k: v for k, v in
                                     pr["step_counts"].items()
                                     if k.endswith("_bytes")},
                "host_copies": pr["host_copies"],
                "host_gb": pr["host_bytes"] / 1e9,
                "step_ms": pr["step_ms"], "busy_ms": pr["busy_ms"],
                "peak_gb": pr["peak_gb"], "session_s": pr["session_s"]})
        row["losses"] = first["losses"]
        row["loss_minus_tp1"] = [a - b for a, b in zip(first["losses"],
                                                       one["losses"])]
        one_grads = {n: one["grads"][n] for n in first["grads"]}
        if not all(abs(d) <= TRAIN_TP_LOSS_ABS
                   for d in row["loss_minus_tp1"]):
            problems.append(f"{label}: losses {first['losses']} vs tp=1 "
                            f"{one['losses']}")
        # the step's gradients (with pods their exact cross-pod mean, which
        # the compression then rounds: held below) by the f32 witness
        got = first["pod_mean_grads"] if pods else first["grads"]
        held = grad_hold(got, one_grads, {n: one["f32"]["grads"][n]
                                          for n in got})
        row["grads"] = held
        row["f32_loss"] = one["f32"]["loss"]
        bad = [n for n, h in held.items() if not h["ok"]]
        if bad:
            problems.append(f"{label}: gradients past the witness's "
                            f"limit: {bad}")
        if key == "deepseek":
            k = train_tp_cfg(*models[key]).n_experts_per_token
            div = [routing_divergence(g, w, k) for g, w in
                   zip(first["routes"], one["routes"])]
            wit = [routing_divergence(g, w, k) for g, w in
                   zip(one["routes"], one["f32_routes"])]
            row["routing_divergence"] = div
            row["tp1_vs_f32_routing"] = wit
            for d, w in zip(div, wit):
                limit = TRAIN_TP_ROUTE_FACTOR * (w["max_gap_at_flip"] or 0.0)
                if d["flipped"] and not d["max_gap_at_flip"] <= limit:
                    problems.append(f"{label}: a routing flip at a gap of "
                                    f"{d['max_gap_at_flip']}, past "
                                    f"{limit} (tp=1 against f32: {w})")
        if pods:
            row["compression"] = first["compression"]
            for n, c in first["compression"].items():
                if not c["err"] <= c["limit"] or not (
                        c["residual_max"] <= c["half_code_step"] * 1.0001):
                    problems.append(f"{label}: compression of {n}: {c}")
        out["sessions"][label] = row
        print(f"  train_tp {label}:", json.dumps(
            {k: v for k, v in row.items() if k != "grads"}
            | ({"grads": {n: {k: h[k] for k in ("vs_tp1", "tp_vs_f32",
                                                 "tp1_vs_f32", "limit")}
                          for n, h in row["grads"].items()}}
               if "grads" in row else {})))
    ck = [ranks[r]["checkpoint"] for r in range(TRAIN_TP_RANKS)]
    out["checkpoint"] = ck[0]
    for c in ck:
        if not c["bitwise"] or c["restored_step"] != 1 or abs(
                c["next_loss"]["restored_2x1"]
                - c["next_loss"]["saved_1x2"]) > TRAIN_TP_LOSS_ABS:
            problems.append(f"train_tp checkpoint: {c}")
    out["kernel_launches"] = launched
    print(f"  train_tp: hand-written kernel launches in the sessions: "
          f"{sum(launched.values())} ({launched})")
    if launched:
        problems.append(f"train_tp launched kernels: {launched}")
    out["phase_s"] = time.monotonic() - t_phase
    if problems:
        raise AssertionError("train_tp: " + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# serve_static_tp: sharded static serving, two ranks sharing the one card
# ---------------------------------------------------------------------------

STATIC_TP_RANKS = 2
STATIC_TP_JOIN_S = 600
# (label, config, layers, plan kind, rows, prompt tokens, cache entries,
# new tokens) of the phase's sessions on a (1, 2) mesh, each beside a tp=1
# session of the same seed-built weights: qwen3-14b on the decode plan
# (full tensor parallelism, the cache split by sequence: the prompt fills
# rank 0's half and part of rank 1's), deepseek-v2-lite expert parallel
# (32 experts a rank), hymba-1.5b on the long_decode plan over a 16384-entry
# cache (its global layers 0 and 3; 1 and 2 a 1024-entry ring).  Depths
# cut to keep the phase near its budget (qwen 4 and hymba 8 layers took
# 114 s on a slow host: each decode step meets the other rank ~7 times a
# layer through gloo)
STATIC_TP_SESSIONS = (
    ("qwen3_decode", "qwen3-14b", 2, "decode", 4, 1024, 1056, 32),
    ("deepseek_decode", "deepseek-v2-lite-16b", 2, "decode", 4, 1024, 1056,
     32),
    ("hymba_long_decode", "hymba-1.5b", 4, "long_decode", 1, 12288, 16384,
     64),
)
STATIC_TP_PROFILE_STEPS = 2
# the partial mode's holds and timings: (label, B, cache entries, valid
# entries of the rows in turn, H, KVH, D), each cache split in two as the
# (1, 2) mesh splits a session's: an empty second shard (B 8), the
# sessions' own shards (qwen3's first decode step, 528 + 497 valid;
# hymba's global cache, 8192 + 4097, and its full 1024-entry ring at D 64,
# rep 5) and qwen3 decode_32k's (rows of 16384 + 0 and 16384 + 8193)
STATIC_TP_PARTIAL_SHAPES = (
    ("empty_shard", 8, 2048, (1024,), H, KVH, D),
    ("qwen3_session", 4, 1056, (1025,), 40, 8, 128),
    ("hymba_global", 1, 16384, (12289,), 25, 5, 64),
    ("hymba_ring", 1, 1024, (1024,), 25, 5, 64),
    ("decode_32k", 128, 32768, (16384, 24577), 40, 8, 128),
)


def static_tp_sessions(reduced: bool = False) -> tuple:
    """The sessions; ``reduced`` cuts them to the tiny configs (a CPU
    rehearsal: 10-token prompts into 24-entry caches, hymba at 3 layers:
    global, windowed, global)."""
    if not reduced:
        return STATIC_TP_SESSIONS
    return tuple((label, name, 3 if "hymba" in name else 2, kind, rows, 10,
                  24, 6) for label, name, _, kind, rows, *_ in
                 STATIC_TP_SESSIONS)


def static_tp_build(torch, session: tuple, reduced: bool, device: str):
    """The session's model: full width at its layers (the reduced config
    at its layers), random weights from seed 0, the same on every rank."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models.model import Model

    _, name, layers, *_ = session
    cfg = get_config(name)
    cfg = reduced_config(cfg) if reduced else cfg
    cfg = dataclasses.replace(cfg, n_layers=layers)
    model = Model(cfg, device=device).init(seed=0)
    return model.float() if reduced else model


def static_tp_inputs(torch, cfg, session: tuple):
    """(prompt tokens (rows, prompt), SamplingParams per row): greedy and
    sampled rows in turn."""
    from repro_torch.runtime.sampling import SamplingParams

    _, _, _, _, rows, prompt, _, _ = session
    rng = np.random.default_rng(29)
    toks = rng.integers(0, cfg.vocab_size, (rows, prompt))
    sps = [SamplingParams() if i % 2 == 0 else
           SamplingParams(temperature=0.8, top_p=0.9, top_k=40, seed=3000 + i)
           for i in range(rows)]
    return toks, sps


class StaticRouteLog:
    """Every MoE routing of a static session in call order, as
    ``tp_moe_divergence`` reads them: each call's expert ids and router
    logits, its rows (a prefill's prompt tokens -2, a decode step's its
    rows' request ids), the calls made by the end of each step (the
    prefill's with the first token), and the step that emitted each
    token."""

    def __init__(self, rows: int, new: int):
        self.rows_n, self.new = rows, new
        self.calls = []

    def __enter__(self):
        from repro_torch.models import moe

        self.moe, self.real = moe, moe._routing

        def routing(x2d, router, k):
            w, ids = self.real(x2d, router, k)
            self.calls.append((ids, x2d.float() @ router.float()))
            return w, ids
        moe._routing = routing
        return self

    def __exit__(self, *exc):
        self.moe._routing = self.real

    def result(self) -> dict:
        t = self.rows_n
        n_moe = next(i for i, (ids, _) in enumerate(self.calls)
                     if ids.shape[0] == t)         # the prefill's calls
        rows = [np.full(ids.shape[0], -2) if i < n_moe else np.arange(t)
                for i, (ids, _) in enumerate(self.calls)]
        return {"ids": [i.cpu().numpy() for i, _ in self.calls],
                "logits": [lg.cpu().numpy() for _, lg in self.calls],
                "rows": rows,
                "calls_at": [n_moe * (j + 1) for j in range(self.new)],
                "emitted": {i: list(range(self.new)) for i in range(t)}}


def static_tp_probe(torch, eng, tokens, steps: int, on_card: bool) -> dict:
    """The first token's logits (the engine's prefill, this rank's rows)
    and, on the card, the device busy time of ``steps`` decode steps from
    that prefill (``device_time_by_kernel``)."""
    inputs = eng._inputs({"tokens": tokens})
    if eng.layout is not None:
        inputs = eng.layout.local_rows(inputs)
    logits, cache, plen = eng._prefill(inputs)
    # the vocabulary's columns (the padding ones sit at -1e30)
    first = logits[:, :eng.model.cfg.vocab_size].float().cpu().numpy()
    if not on_card:
        return {"logits": first, "busy_ms": None}
    state = {"nxt": logits.argmax(-1).to(torch.int32)}

    def run():
        for j in range(steps):
            with eng._region():
                lg = eng.model.decode_step(state["nxt"], cache, plen + j)
            state["nxt"] = lg.argmax(-1).to(torch.int32)
    per_kernel, _ = device_time_by_kernel(torch, run)
    return {"logits": first, "busy_ms": sum(per_kernel.values()) / steps}


def static_tp_session(torch, model, session: tuple, device: str,
                      mesh=None) -> dict:
    """One session: ``ServeEngine`` (on ``mesh`` under the session's plan,
    or tp=1) generates the session's rows; the launches of flash and the
    dense decode, the step's wall, the first token's logits and the busy
    ms of ``STATIC_TP_PROFILE_STEPS`` decode steps; on the mesh also the
    weight and cache bytes the rank stores against the plan's shard
    shapes, and the collective calls and bytes of the session against
    ``predict_serve_bytes`` (one prefill and ``new - 1`` decode steps)."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.parallel.plan import make_plan, shard_shape
    from repro_torch.parallel.serve import predict_serve_bytes
    from repro_torch.runtime.engine import ServeEngine

    label, _, _, kind, rows, prompt, cache_len, new = session
    t_session = time.monotonic()
    cfg = model.cfg
    on_card = device == "cuda"
    tokens, sps = static_tp_inputs(torch, cfg, session)
    plan = None if mesh is None else make_plan(cfg, mesh, global_batch=rows,
                                               shape_kind=kind)
    whole = sum(p.numel() * p.element_size() for p in model.parameters())
    eng = ServeEngine(model, device=device, max_len=cache_len, plan=plan)
    dtype = next(model.parameters()).dtype
    del model
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    lay = eng.layout
    if lay is not None:
        lay.groups.reset_counts()
    log = StaticRouteLog(rows, new) if cfg.moe else None
    LAUNCHES.clear()
    with log or contextlib.nullcontext():
        res = eng.generate({"tokens": tokens}, max_new_tokens=new,
                           sampling_params=sps)
    sync(torch, torch.device(device))
    launches = {k: v for k, v in LAUNCHES.items() if v}
    out = {"label": label, "kernel_launches": launches,
           "decode_step_ms": 1e3 * res.decode_s / max(new - 1, 1),
           "prefill_s": res.prefill_s,
           "_streams": res.tokens.cpu().numpy().tolist(),
           "_routes": log and log.result()}
    if on_card:
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if lay is not None:
        counts = lay.groups.counts()
        local = rows // lay.batch_comm.size
        kw = dict(rows=local, seq=prompt, max_len=cache_len, act_dtype=dtype)
        pre = predict_serve_bytes(lay, eng.model, step="prefill", **kw)
        dec = predict_serve_bytes(lay, eng.model, step="decode", **kw)
        want = {k: pre.get(k, 0) + (new - 1) * dec.get(k, 0)
                for k in set(pre) | set(dec)}
        # the collectives' bytes (gloo's staging through the host,
        # ``host_bytes``, is no collective of the plan)
        got = {k: v for k, v in counts.items() if k.endswith("_bytes") and v
               and k != "host_bytes"}
        meta = eng.model
        plan_w = sum(math.prod(plan.shard_shape(n, p.shape))
                     * lay.params[n].element_size()
                     for n, p in meta.named_parameters())
        glob = meta.init_cache(rows, cache_len)
        specs = plan.cache_shardings(glob)
        mine = lay.init_cache(meta, local, cache_len, device="meta")

        def kv_bytes(tree, spec=None):
            n = 0
            for layer, sp in zip(tree, spec or tree):
                parts = [(layer, sp)] if "attn" not in layer else [
                    (layer["attn"], sp["attn"])]
                for c, s in parts:
                    for key in ("k", "v", "c_kv", "k_rope"):
                        if key in c:
                            shape = (tuple(c[key].shape) if spec is None else
                                     shard_shape(s[key], tuple(c[key].shape),
                                                 plan.mesh))
                            n += math.prod(shape) * c[key].element_size()
            return n
        out.update({
            "plan": {"dp": list(plan.dp), "tp": plan.tp,
                     "cache_seq": plan.cache_seq,
                     "ep": lay.ep_comm is not None},
            "weight_bytes": lay.stored_bytes(), "plan_weight_bytes": plan_w,
            "whole_weight_bytes": whole,
            "cache_kv_bytes": kv_bytes(mine),
            "plan_cache_kv_bytes": kv_bytes(glob, specs),
            "collective_calls": {k: v for k, v in counts.items()
                                 if not k.endswith("bytes") and v
                                 and k not in ("host_copies", "gloo_cuda")},
            "collective_bytes": got, "predicted_bytes": {
                k: v for k, v in want.items() if v},
            "collective_bytes_per_decode_step": sum(dec.values()),
            "host_copies": counts.get("host_copies", 0)})
    probe = static_tp_probe(torch, eng, tokens, STATIC_TP_PROFILE_STEPS,
                            on_card)
    out["_logits"] = probe["logits"]
    out["device_busy_ms_per_step"] = probe["busy_ms"]
    if probe["busy_ms"] is not None:
        out["device_idle_share"] = 1 - probe["busy_ms"] / out["decode_step_ms"]
    out["session_s"] = time.monotonic() - t_session
    del eng
    gc.collect()
    return out


def static_tp_rank(rank: int, rdzv: str, queue, sessions: tuple,
                   reduced: bool, device: str) -> None:
    """One rank of the phase (a spawned process): join the gloo group,
    build each session's model from the same seed as every rank, serve
    it on the (1, 2) mesh, and send the readings to the parent."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_world, parse_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device == "cpu":
        torch.set_num_threads(1)
    backend = init_world(device, backend="gloo", rank=rank,
                         world_size=STATIC_TP_RANKS, init_method=rdzv,
                         timeout_s=TP_TIMEOUT_S)
    try:
        mesh = parse_mesh(f"1x{STATIC_TP_RANKS}", device)
        runs = {}
        for s in sessions:
            model = static_tp_build(torch, s, reduced, device)
            runs[s[0]] = static_tp_session(torch, model, s, device, mesh)
            del model
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
        queue.put((rank, {"runs": runs, "backend": backend}))
    finally:
        dist.destroy_process_group()


def stacked_comm(n: int):
    """A stand-in group of ``n`` ranks whose tensors are stacked along dim
    0 of one tensor on one process: its all-reduce reduces over that dim
    and gives every rank the result, so ``combine_partials`` runs its own
    collectives on the card without a second process."""
    from repro_torch.parallel.train import _SoloComm

    class Stacked(_SoloComm):
        def _reduce_(self, out, op):
            red = (out.amax(0, keepdim=True) if op == "max"
                   else out.sum(0, keepdim=True))
            out.copy_(red.expand_as(out))
    comm = Stacked()
    comm.size = n
    return comm


def partial_library(torch, q, k, v, c: int, h: int, kvh: int) -> tuple:
    """The library's one call with a log-sum-exp at the partial mode's
    K/V bytes: ``aten._scaled_dot_product_efficient_attention(
    compute_log_sumexp=True)`` with the ``rep`` query heads of each KV head
    as ``rep`` query rows over that head's first ``c`` entries, K/V not
    repeated.  Returns (fn, layout): the K/V a strided view of the cache,
    or a contiguous copy where the call refuses the view."""
    B, _, d = q.shape
    q4 = q.view(B, kvh, h // kvh, d)
    kt, vt = k[:, :c].transpose(1, 2), v[:, :c].transpose(1, 2)

    def call(kk, vv):
        return torch.ops.aten._scaled_dot_product_efficient_attention(
            q4, kk, vv, None, True)
    try:
        call(kt, vt)
        return (lambda: call(kt, vt)), "strided view"
    except RuntimeError:
        kc, vc = kt.contiguous(), vt.contiguous()
        call(kc, vc)
        return (lambda: call(kc, vc)), "contiguous copy"


def static_tp_partial_kernel(torch) -> dict:
    """The dense decode kernel's partial mode on the card: each shape of
    ``STATIC_TP_PARTIAL_SHAPES`` split in two (rank 0's half and rank 1's,
    its tail past the valid entries poisoned), each half held against the
    plain partial version (out within one bf16 ulp plus 1e-4, lse within
    1e-3; an empty shard's rows exactly 0 and -inf), the two halves merged
    by ``parallel.hints.combine_partials`` (on a ``stacked_comm``) against
    the whole-cache kernel (within one bf16 ulp of the whole plus half one
    of each weighted half, plus 1e-4: each half is rounded to bf16 before
    the merge), then each half timed beside the whole-cache kernel, its
    bound (``kernels/cost.py``, with the lse write), the plain version and
    the library's call (``partial_library``), whose output and lse are
    held to the kernel's as well."""
    from repro_torch.kernels.decode_attention import kernel as dense_kernel
    from repro_torch.models.common import decode_attention_ref
    from repro_torch.parallel.hints import combine_partials

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)
    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=dev)
    timings, errs, shares, merges = [], [], [], []
    for label, B, S, ctx, h, kvh, d in STATIC_TP_PARTIAL_SHAPES:
        half = S // 2
        ctx = np.resize(np.asarray(ctx), B)
        valid = [np.minimum(ctx, half), np.clip(ctx - half, 0, half)]
        q, k, v, cl = dense_case(torch, gen, B, S, torch.bfloat16, ctx, dev,
                                 h, kvh, d)
        shards = []
        for j in range(2):
            kj = k[:, j * half:(j + 1) * half].contiguous()
            vj = v[:, j * half:(j + 1) * half].contiguous()
            cj = torch.clamp(cl - j * half, 0, half).to(torch.int32)
            shards.append((kj, vj, cj))
        parts = [dense_kernel.decode_attention(q, kj, vj, cj,
                                               return_lse=True)
                 for kj, vj, cj in shards]
        whole = dense_kernel.decode_attention(q, k, v, cl)
        torch.cuda.synchronize()
        for (kj, vj, cj), (out, lse) in zip(shards, parts):
            for r0 in range(0, B, 16):          # the plain side by rows
                rs = slice(r0, r0 + 16)
                ro, rl = decode_attention_ref(q[rs], kj[rs], vj[rs], cj[rs],
                                              return_lse=True)
                live = cj[rs] > 0
                if bool(live.any()):
                    shares.append(ulp_limit_share(out[rs][live],
                                                  ro[live], 1e-4))
                    errs.append((lse[rs][live] - rl[live]).abs().max().item())
                if bool((~live).any()):
                    dead_o, dead_l = out[rs][~live], lse[rs][~live]
                    if not (bool((dead_o == 0).all())
                            and bool(torch.isneginf(dead_l).all())):
                        raise AssertionError("partial mode: an empty shard's "
                                             "rows are not 0 and -inf")
        outs = torch.stack([p[0] for p in parts])
        lses = torch.stack([p[1] for p in parts])
        merged = combine_partials(outs, lses, stacked_comm(2))[0]
        wgt = torch.softmax(lses, 0)[..., None]
        limit = (2.0 ** -7 * whole.float().abs()
                 + 2.0 ** -8 * (wgt * outs.float().abs()).sum(0) + 1e-4)
        merge_share = ((merged - whole.float()).abs() / limit).max().item()
        merges.append(merge_share)
        k0, v0, c0 = shards[0]
        k1, v1, c1 = shards[1]
        row = {"label": label, "B": B, "S": S, "shard": half,
               "cur_len": sorted(set(ctx.tolist())),
               "shard_valid": [sorted(set(c.tolist())) for c in valid],
               "H": h, "KVH": kvh,
               "D": d, "cache": "bfloat16",
               "ms": time_ms(torch, lambda: dense_kernel.decode_attention(
                   q, k0, v0, c0, return_lse=True), flush),
               "shard1_ms": time_ms(
                   torch, lambda: dense_kernel.decode_attention(
                       q, k1, v1, c1, return_lse=True), flush),
               "whole_cache_ms": time_ms(
                   torch, lambda: dense_kernel.decode_attention(q, k, v, cl),
                   flush, iters=10),
               "plain_ms": time_ms(torch, lambda: decode_attention_ref(
                   q, k0, v0, c0, return_lse=True), flush, iters=5,
                   warmup=1),
               "merge_share_of_limit": merge_share}
        row["bound_ms"], row["bound_by"] = dense_bound(
            valid[0], B, 2, "bfloat16", h, kvh, d, True)
        # the library's call over rank 0's half (as many valid entries in
        # every row), at the kernel's K/V bytes
        lib, row["library_layout"] = partial_library(
            torch, q, k0, v0, int(valid[0][0]), h, kvh)
        lo, ll = lib()[:2]
        o0, l0 = parts[0]
        row["library_bf16_limit_share"] = ulp_limit_share(
            lo.reshape(B, h, d), o0, 1e-4)
        row["library_lse_err"] = (ll[..., :h // kvh].reshape(B, h)
                                  - l0).abs().max().item()
        row["library_ms"] = time_ms(torch, lib, flush)
        timings.append(ratios(row))
        print("  partial mode:", json.dumps(row))
        del q, k, v, cl, shards, parts, whole, merged, outs, lses, lib, lo
        torch.cuda.empty_cache()
    if max(shares) > 1.0 or max(errs) > 1e-3 or max(merges) > 1.0:
        raise AssertionError(f"partial mode disagrees: bf16 share "
                             f"{max(shares)}, lse err {max(errs)}, "
                             f"merge share {max(merges)}")
    del flush
    head = timings[0]
    return {"name": f"{dense_kernel.NAME}:partial", "route": "cuda",
            "source": DENSE_SOURCE, "replaces": DENSE_REPLACES,
            "launches": None, "max_abs_err": max(errs),
            "max_abs_err_of": "lse",
            "max_bf16_limit_share": max(shares),
            "max_merge_share_of_limit": max(merges),
            "headline": "B 8, 1024 valid entries in the first 1024-entry "
                        "half of a 2048-entry bf16 cache (return_lse)",
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "library": "aten._scaled_dot_product_efficient_attention("
                       "compute_log_sumexp=True), each KV head's rep query "
                       "heads as rep query rows, K/V not repeated",
            "timings": timings}


def static_top2_gap(torch, model, tokens) -> float:
    """The top-2 gap, in bf16 ulps of the top logit, of ``model``'s
    next-token logits after ``tokens`` (one static prefill)."""
    cache = model.init_cache(1, len(tokens) + 1)
    dev = next(model.parameters()).device
    with torch.no_grad():
        lg = model.prefill(torch.as_tensor(np.asarray(tokens)[None],
                                           device=dev), cache)
    top = np.sort(lg[0, :model.cfg.vocab_size].float().cpu().numpy())[-2:]
    ulp = 2.0 ** (math.floor(math.log2(abs(float(top[1])))) - 7)
    return float(top[1] - top[0]) / ulp


def serve_static_tp_phase(torch, reduced: bool = False,
                          device: str = "cuda") -> dict:
    """Sharded static serving on the card: two ranks (spawned processes)
    sharing ``cuda:0`` over gloo, a (1, 2) mesh, ``make_plan``'s plans run
    by ``ServeEngine`` (``parallel/serve.py``) for the sessions of
    ``STATIC_TP_SESSIONS``, each beside a tp=1 session of the same
    seed-built weights run first in this process.  Per rank and session:
    the weight and KV bytes it stores equal the plan's shard shapes, the
    collective bytes by kind equal ``predict_serve_bytes``, flash launches
    once a layer and the dense decode (its partial mode) once a GQA layer
    a decode step; the step's wall and busy ms.  Against tp=1: the first
    token's logits within ``SCORE_REL_TOL`` of their largest, and a greedy
    stream parts only at a near tie (``NEAR_TIE_BF16_ULPS``), or for the
    MoE model at or after the session's first divergence, a routing flip
    that is itself a near tie (``tp_moe_divergence``).  Then the partial
    mode's kernel check and timings (``static_tp_partial_kernel``).
    ``reduced`` / ``device`` rehearse it on the CPU at the tiny configs.
    No number here is a tensor-parallel speed: both ranks share one card
    and gloo copies every collective through the host."""
    import multiprocessing as mproc
    import queue as queue_mod
    import tempfile

    t_phase = time.monotonic()
    on_card = device == "cuda"
    sessions = static_tp_sessions(reduced)
    out = {"phase": "serve_static_tp", "ranks": STATIC_TP_RANKS,
           "mesh": f"1x{STATIC_TP_RANKS}", "card_shared_by_ranks": on_card}
    if on_card:
        out["partial_kernel"] = static_tp_partial_kernel(torch)
    ref = {}
    for s in sessions:
        model = static_tp_build(torch, s, reduced, device)
        ref[s[0]] = static_tp_session(torch, model, s, device)
        del model
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mproc.get_context("spawn")
        q = ctx.Queue()
        procs = [ctx.Process(target=static_tp_rank,
                             args=(r, f"file://{tmp}/rdzv", q, sessions,
                                   reduced, device))
                 for r in range(STATIC_TP_RANKS)]
        for p in procs:
            p.start()
        ranks, deadline = {}, time.monotonic() + STATIC_TP_JOIN_S
        try:
            while len(ranks) < STATIC_TP_RANKS:
                try:
                    r, res = q.get(timeout=2.0)
                    ranks[r] = res
                except queue_mod.Empty:
                    dead = [p.exitcode for p in procs
                            if p.exitcode not in (None, 0)]
                    if dead:
                        raise AssertionError(f"serve_static_tp: a rank "
                                             f"failed (exit codes {dead})")
                    if time.monotonic() > deadline:
                        raise AssertionError(f"serve_static_tp: ranks not "
                                             f"done after {STATIC_TP_JOIN_S} s")
            for p in procs:
                p.join(timeout=TP_TIMEOUT_S)
                if p.exitcode != 0:
                    raise AssertionError(f"serve_static_tp: rank exit code "
                                         f"{p.exitcode}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    out["collective_backend"] = ranks[0]["backend"]
    problems, summed = [], {}
    for s in sessions:
        label, name, layers, kind, rows, prompt, cache_len, new = s
        per_rank = [ranks[r]["runs"][label] for r in range(STATIC_TP_RANKS)]
        streams = [pr.pop("_streams") for pr in per_rank]
        logits = [pr.pop("_logits") for pr in per_rank]
        routes = [pr.pop("_routes") for pr in per_rank][0]
        want = ref[label]
        want_streams = want.pop("_streams")
        want_logits = want.pop("_logits")
        want_routes = want.pop("_routes")
        if any(st != streams[0] for st in streams[1:]):
            problems.append(f"{label}: the ranks' streams differ")
        n_attn = layers                # every layer attends here
        mla = name.startswith("deepseek")
        for pr in per_rank:
            for k, v in pr["kernel_launches"].items():
                summed[k] = summed.get(k, 0) + v
            if pr["weight_bytes"] != pr["plan_weight_bytes"]:
                problems.append(f"{label}: a rank stores "
                                f"{pr['weight_bytes']} weight bytes, the "
                                f"plan {pr['plan_weight_bytes']}")
            if pr["cache_kv_bytes"] != pr["plan_cache_kv_bytes"]:
                problems.append(f"{label}: a rank's KV cache is "
                                f"{pr['cache_kv_bytes']} bytes, the plan's "
                                f"{pr['plan_cache_kv_bytes']}")
            if pr["collective_bytes"] != pr["predicted_bytes"]:
                problems.append(f"{label}: collective bytes "
                                f"{pr['collective_bytes']}, predicted "
                                f"{pr['predicted_bytes']}")
            if on_card:
                want_l = {"flash_attention": n_attn}
                if not mla:
                    want_l["decode_attention"] = n_attn * (new - 1)
                if pr["kernel_launches"] != want_l:
                    problems.append(f"{label}: launches "
                                    f"{pr['kernel_launches']}, want {want_l}")
        greedy = [i for i in range(rows) if i % 2 == 0]
        first = None
        if routes is not None:
            first = tp_moe_divergence(routes, want_routes,
                                      dict(enumerate(streams[0])),
                                      dict(enumerate(want_streams)))
        partings, bad = [], []
        for i in greedy:
            a, b = streams[0][i], want_streams[i]
            if a == b:
                continue
            t = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
            p = {"row": i, "token": t}
            if first is not None and t >= first["step"]:
                p["after_first_divergence"] = True
            else:
                model = static_tp_build(torch, s, reduced, device)
                prompt_toks = static_tp_inputs(torch, model.cfg, s)[0][i]
                p["gap_bf16_ulps"] = static_top2_gap(
                    torch, model, np.concatenate([prompt_toks, b[:t]]))
                del model
                gc.collect()
                if not p["gap_bf16_ulps"] <= NEAR_TIE_BF16_ULPS:
                    bad.append(p)
            partings.append(p)
        lg0 = np.concatenate(logits[:1])   # rank 0's rows: every row here
        share = float(np.abs(lg0 - want_logits).max()
                      / (SCORE_REL_TOL * np.abs(want_logits).max()))
        waived = first is not None and first["step"] == 0
        row = {"tp1_decode_step_ms": want["decode_step_ms"],
               "tp1_device_busy_ms_per_step": want["device_busy_ms_per_step"],
               "tp1_kernel_launches": want["kernel_launches"],
               "tp1_session_s": want["session_s"],
               "greedy_streams_equal": sum(streams[0][i] == want_streams[i]
                                           for i in greedy),
               "sampled_streams_equal": sum(
                   streams[0][i] == want_streams[i]
                   for i in range(rows) if i not in greedy),
               "rows": rows, "greedy_partings": partings,
               "first_token_logits_share_of_limit": share,
               **({"first_divergence": first} if routes is not None else {}),
               "per_rank": per_rank}
        out[label] = row
        print(f"  serve_static_tp {label}:", json.dumps(
            {k: v for k, v in row.items() if k != "per_rank"}
            | {"ranks": [{k: pr.get(k) for k in (
                "decode_step_ms", "device_busy_ms_per_step",
                "device_idle_share", "weight_bytes", "plan_weight_bytes",
                "cache_kv_bytes", "plan_cache_kv_bytes",
                "collective_calls", "collective_bytes_per_decode_step",
                "kernel_launches", "peak_mem_gb", "plan", "session_s",
                "prefill_s")}
                for pr in per_rank]}, default=str))
        if first is not None and first["kind"] == "route_flip" \
                and not first["gap_share"] <= 1.0:
            problems.append(f"{label}: the first divergence is a routing "
                            f"flip and no near tie: {first}")
        if bad:
            problems.append(f"{label}: greedy streams part from tp=1 above "
                            f"{NEAR_TIE_BF16_ULPS} bf16 ulps: {bad}")
        if not share <= 1.0 and not waived:
            problems.append(f"{label}: first-token logits at {share} of "
                            f"{SCORE_REL_TOL} x max")
    out["kernel_launches_summed"] = summed
    if on_card:
        out["partial_kernel"]["launches"] = summed.get("decode_attention", 0)
        if not out["partial_kernel"]["launches"]:
            problems.append("the dense decode's partial mode never "
                            "launched on the mesh")
    out["phase_s"] = time.monotonic() - t_phase
    if problems:
        raise AssertionError("serve_static_tp: " + "; ".join(problems))
    return out


# the launcher on the card, in process: full-width llama3-8b served
# disaggregated, and the fleet calibration's real engine (2 of its layers)
SERVE_CLI = ["--no-reduced", "--arch", "llama3-8b", "--continuous",
             "--disaggregate", "1:1", "--num-requests", "4", "--batch", "4",
             "--prompt-len", "256", "--max-new", "16"]
FLEET_CLI = ["--fleet", "--calibrate", "--arch", "llama3-8b", "--no-reduced",
             "--layers", "2", "--requests", "24", "--rate", "30"]


def serve_cli_phase(torch) -> dict:
    """``repro_torch.launch.serve.main`` on the card, in this process:
    ``SERVE_CLI`` (llama3-8b at all 32 layers, random weights, through
    ``LLMEngine(disaggregate=True)``) and ``FLEET_CLI`` (``--fleet
    --calibrate``: a 2-layer llama3-8b engine timed into a latency table,
    written to a temporary directory, and the simulator cross-checked
    against the engine's replay).  Each must return 0; the output is
    printed as it comes."""
    import tempfile

    from repro_torch.launch.serve import main as serve_main

    walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, argv in (("serve", SERVE_CLI),
                           ("fleet_calibrate",
                            FLEET_CLI + ["--calibration-dir", tmp])):
            print(f"  serve_cli: python -m repro_torch.launch.serve "
                  f"{' '.join(argv)}")
            t0 = time.monotonic()
            rc = serve_main(list(argv))
            sys.stdout.flush()
            walls[name] = time.monotonic() - t0
            if rc != 0:
                raise AssertionError(f"serve_cli {name} returned {rc}")
            gc.collect()
            torch.cuda.empty_cache()
        tables = sorted(p.name for p in Path(tmp).iterdir())
    if not tables:
        raise AssertionError("--fleet --calibrate wrote no table")
    return {"phase": "serve_cli", "returned": 0, "wall_s": walls,
            "calibration_tables": tables}


def gqa_write_cost(torch, llm, model, prompts, sps, streams) -> dict:
    """What ``attention_backends.last_writes`` would cost a model without
    MoE: the serve session again, its GQA pool writes plain (A, as the
    port writes them there) and ``coupled`` (B: each write with the value
    of the last writer of its place, as in an MoE model), in the order
    A B B A.  Each session must reproduce ``streams``: only the
    scratch page, which no live row reads, can tell the two apart.
    Returns the median decode-only step of each session."""
    steps = {"plain": [], "last_writes": []}
    for name in ("plain", "last_writes", "last_writes", "plain"):
        for blk in model.layers:
            blk.attn.coupled = name == "last_writes"
        try:
            got, _, _, decode_steps = serve_session(llm, prompts, sps)
        finally:
            for blk in model.layers:
                blk.attn.coupled = model.cfg.moe
        if got != streams:
            raise AssertionError(f"{name} pool writes changed a stream")
        steps[name].append(1e3 * float(np.median(decode_steps)))
    return {"order": "A B B A", **{f"{k}_decode_step_ms": v
                                           for k, v in steps.items()},
            "last_writes_over_plain": (sum(steps["last_writes"])
                                       / sum(steps["plain"]))}


SCORED_NEW = 4
# |continuous score - Model.forward score| per prompt position, over the
# largest |logit| of that position: four bf16 ulps.  Each side rounds its
# logits to bf16 (half an ulp), and the hidden states reach the head
# through other attention arithmetic (flash: P rounded to bf16; chunked
# prefill: f32 over gathered pages)
SCORE_REL_TOL = 2.0 ** -5


@contextlib.contextmanager
def recorded_routes(tokens: int):
    """The expert ids (T, k) of every MoE routing over ``tokens`` tokens
    while the block runs, in call order (one per MoE layer of a call).
    They stay on the device: recording adds no wait for it."""
    from repro_torch.models import moe

    routes, real = [], moe._routing

    def routing(x2d, router, k):
        w, ids = real(x2d, router, k)
        if x2d.shape[0] == tokens:
            routes.append(ids)
        return w, ids
    moe._routing = routing
    try:
        yield routes
    finally:
        moe._routing = real


@contextlib.contextmanager
def forced_routes(torch, routes):
    """Every MoE routing over the tokens of ``routes`` takes, in call
    order, the expert ids of ``routes``, weighted by its own router's
    softmax over them and renormalised as ``moe._routing`` does.  Yields
    a dict of readings: the routings replayed, the tokens whose choice
    was forced away from its own top-k, and the largest gap, over those
    tokens, between the router logit of its own k-th choice and the
    lowest forced one, as a share of ``SCORE_REL_TOL`` x the token's
    largest |router logit| (at or under 1: a near tie of four ulps)."""
    from repro_torch.models import moe

    real, todo = moe._routing, list(routes)
    seen = {"routings": 0, "route_flips": 0, "route_flip_gap_share": 0.0}

    def routing(x2d, router, k):
        if not todo or x2d.shape[0] != todo[0].shape[0]:
            return real(x2d, router, k)
        ids = todo.pop(0)
        logits = x2d.float() @ router.float()
        _, own = real(x2d, router, k)
        kth = logits.gather(-1, own).amin(-1)
        gap = kth - logits.gather(-1, ids).amin(-1)
        limit = SCORE_REL_TOL * logits.abs().amax(-1)
        flips = (own.sort(-1).values != ids.sort(-1).values).any(-1)
        seen["routings"] += 1
        seen["route_flips"] += int(flips.sum())
        seen["route_flip_gap_share"] = max(
            seen["route_flip_gap_share"],
            float(torch.where(flips, gap / limit, 0.0).max()))
        w = torch.softmax(logits, dim=-1).gather(-1, ids)
        return w / torch.clamp_min(w.sum(dim=-1, keepdim=True), 1e-9), ids
    moe._routing = routing
    try:
        yield seen
    finally:
        moe._routing = real
    if todo:
        raise AssertionError(f"{len(todo)} of {len(routes)} recorded "
                             f"routings were not replayed")


def serve_scoring(torch, llm, model, prompt) -> dict:
    """Prompt scoring in the continuous engine (``prompt_logprobs``): the
    serve phase's 1024-token prompt alone through ``llm`` (greedy,
    ``SCORED_NEW`` new tokens), in a session unscored and then in one
    scored.  The scored session's first token must equal the unscored
    one's; its 1023 scores are held against ``Model.forward``'s on the card
    (the static backend's scores), each within ``SCORE_REL_TOL`` of its
    position's largest |logit|; the scored chunk calls are timed beside
    the unscored session's.  In an MoE model the two calls' attention
    rounds apart, and a routing choice near a tie may then go to another
    expert, which moves that position and, through attention, every later
    one by far more than rounding: ``Model.forward`` there takes the
    scored call's expert ids (``forced_routes``), so every position is
    held."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.flash_attention.kernel import NAME as FLASH
    from repro_torch.runtime.sampling import SamplingParams

    eng = llm._eng
    times = {"_chunk_impl": [], "_chunk_scored_impl": []}

    def timed_calls(name):
        fn = getattr(eng, name)

        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t)
            return out
        setattr(eng, name, run)

    for name in times:
        timed_calls(name)
    try:
        unscored = llm.generate([prompt], [SamplingParams(
            max_tokens=SCORED_NEW)])[0]
        with recorded_routes(len(prompt)) as routes:
            scored = llm.generate([prompt], [SamplingParams(
                max_tokens=SCORED_NEW, prompt_logprobs=True)])[0]
    finally:
        for name in times:
            delattr(eng, name)                  # the class's methods again
    if scored.token_ids[0] != unscored.token_ids[0]:
        raise AssertionError(f"scoring changed the first token: unscored "
                             f"{unscored.token_ids}, scored "
                             f"{scored.token_ids}")
    got = np.asarray(scored.prompt_logprobs)
    LAUNCHES.clear()
    diff, share, scale, forced = scores_vs_forward(torch, model, prompt,
                                                   got, routes)
    # Model.forward: flash once a GQA or MLA layer (MLA at D 192 / Dv 128)
    forward_flash = LAUNCHES.get(FLASH, 0)
    if forward_flash != gqa_layers(model) + mla_layers(model):
        raise AssertionError(f"Model.forward launched flash {forward_flash} "
                             f"times, want one a GQA or MLA layer")
    res = {"prompt_tokens": len(prompt), "new_tokens": SCORED_NEW,
           "held_positions": len(diff), **forced,
           "forward_flash_launches": forward_flash,
           "first_token_equal": True,
           "chunk": eng.prefill_chunk,
           "stream_equal": scored.token_ids == unscored.token_ids,
           "scores_max_abs_diff_vs_forward": float(diff.max()),
           "scores_mean_abs_diff_vs_forward": float(diff.mean()),
           "score_rel_tolerance": SCORE_REL_TOL,
           "score_limit_share": share,
           "max_abs_logit_median": float(np.median(scale)),
           "mean_score": float(got.mean()),
           "chunk_calls": len(times["_chunk_impl"]),
           "unscored_chunk_call_ms": [1e3 * t for t in
                                      times["_chunk_impl"]],
           "scored_chunk_call_ms": [1e3 * t for t in
                                    times["_chunk_scored_impl"]]}
    print("  prompt scoring:", json.dumps(res))
    return res


def scores_vs_forward(torch, model, prompt, got, routes=()) -> tuple:
    """Hold prompt scores ``got`` against ``Model.forward``'s on the card,
    each within ``SCORE_REL_TOL`` of its position's largest |logit|, at
    every position; in an MoE model the forward call takes the expert ids
    ``routes`` of the scoring call (``forced_routes``).  Returns |diff|,
    the worst share of the limit, the per-position largest |logit| and
    what ``forced_routes`` saw (empty without ``routes``)."""
    toks = torch.as_tensor(np.asarray(prompt), device="cuda")[None].long()
    forced = {}
    with (forced_routes(torch, routes) if routes
          else contextlib.nullcontext(forced)) as forced:
        logits = model.forward(toks)[0, :-1, :model.cfg.vocab_size].float()
    ls = torch.log_softmax(logits, dim=-1)
    want = torch.gather(ls, -1, toks[0, 1:, None])[:, 0].cpu().numpy()
    scale = logits.abs().amax(-1).cpu().numpy()
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"continuous prompt scores: shape {got.shape} "
                             f"(want {want.shape}) or not finite")
    diff = np.abs(got - want)
    share = float((diff / (SCORE_REL_TOL * scale)).max())
    if not share <= 1.0:
        raise AssertionError(f"continuous prompt scores vs Model.forward: "
                             f"max |diff| {diff.max()} over {len(diff)} "
                             f"positions, at {share} of the limit "
                             f"{SCORE_REL_TOL} x max |logit| ({forced})")
    return diff, share, scale, forced


def mixed_batch_scoring(torch, llm, model, prompt) -> dict:
    """GQA only: two copies of ``prompt`` in one batch, one scored, ride the
    same chunk calls.  Their first tokens must be equal, the unscored copy
    must come back without scores and the scored one's are held against
    ``Model.forward`` as in ``serve_scoring``.  (An MoE model's copies
    would compete for expert capacity and keep different assignments.)"""
    from repro_torch.runtime.sampling import SamplingParams

    plain = SamplingParams(max_tokens=SCORED_NEW)
    scored = SamplingParams(max_tokens=SCORED_NEW, prompt_logprobs=True)
    outs = llm.generate([prompt, prompt], [plain, scored])
    if outs[0].token_ids[0] != outs[1].token_ids[0]:
        raise AssertionError(f"scoring changed the first token in a mixed "
                             f"batch: {[o.token_ids for o in outs]}")
    if outs[0].prompt_logprobs is not None:
        raise AssertionError("an unscored request came back with scores")
    _, share, _, _ = scores_vs_forward(torch, model, prompt,
                                      np.asarray(outs[1].prompt_logprobs))
    return {"first_token_equal": True, "unscored_without_scores": True,
            "score_limit_share": share,
            "stream_equal": outs[0].token_ids == outs[1].token_ids}


def serve_spec_phase(torch, model, plain_streams) -> dict:
    """The ``serve`` phase's requests behind ``LLMEngine(backend=
    "continuous", speculative=SpeculativeConfig(gamma=GAMMA))``, a
    self-draft, twice (the re-run must reproduce every stream, greedy and
    sampled, and is traced over 8 decode-only windows).  Every window runs
    the paged decode kernel once per layer for each of its gamma draft
    steps and the backfill step, and the exact kernel once per layer for
    the verify step.  The greedy streams' agreement with the plain serve's
    (``plain_streams``) is a reading: the exact and online kernels round
    apart, so a bf16 near-tie may flip."""
    from repro_torch.kernels import LAUNCHES, VARIANT_LAUNCHES
    from repro_torch.kernels.decode_attention.paged_kernel import (
        NAME, NAME_EXACT,
    )
    from repro_torch.runtime.llm import LLMEngine
    from repro_torch.runtime.sampling import SamplingParams
    from repro_torch.runtime.speculative import SpeculativeConfig

    cfg = model.cfg
    torch.cuda.reset_peak_memory_stats()
    llm = LLMEngine(model, backend="continuous", device="cuda", num_slots=8,
                    page_size=16, max_len=2048, prefill_chunk=256,
                    speculative=SpeculativeConfig(gamma=GAMMA))
    prompts, sps = serve_requests(SamplingParams, cfg.vocab_size)
    LAUNCHES.clear()
    VARIANT_LAUNCHES.clear()
    streams, finished, stats, windows_s = serve_session(llm, prompts, sps)
    torch.cuda.synchronize()
    launches = {k: v for k, v in LAUNCHES.items() if v}
    variants = {k: v for k, v in VARIANT_LAUNCHES.items() if v}
    for i in range(len(prompts)):
        o = finished.get(i)
        if o is None or o.finish_reason != "length" or len(o.token_ids) != 64:
            raise AssertionError(f"spec request {i} did not finish with 64 "
                                 f"tokens: {o}")
        if o.token_ids != streams[i] or not all(
                0 <= t < cfg.vocab_size for t in o.token_ids):
            raise AssertionError(f"spec request {i}: streamed deltas differ "
                                 f"from token_ids, or a token is outside "
                                 f"the vocabulary")
    want = {NAME_EXACT: cfg.n_layers * stats.steps,
            NAME: cfg.n_layers * (GAMMA + 1) * stats.steps}
    want_variants = {f"{k}:tensor_core": v for k, v in want.items()}
    if (launches != want or variants != want_variants
            or stats.spec_windows == 0):
        raise AssertionError(f"serve_spec launched {launches} ({variants}), "
                             f"want {want} on the tensor-core kernels "
                             f"({stats.steps} windows, {cfg.n_layers} "
                             f"layers)")

    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(**PROFILE)) as prof:
        again, _, stats2, _ = serve_session(llm, prompts, sps,
                                            on_decode_step=prof.step)
    breakdown = device_breakdown(prof, float(np.median(windows_s)))
    for i in range(len(prompts)):
        if again[i] != streams[i]:
            kind = "greedy" if sps[i].is_greedy else "sampled"
            raise AssertionError(f"spec {kind} request {i} did not "
                                 f"reproduce its stream on the re-run")
    agree = {}
    for i, sp in enumerate(sps):
        if sp.is_greedy:
            a, b = streams[i], plain_streams[i]
            agree[i] = (64 if a == b else
                        next(t for t, (x, y) in enumerate(zip(a, b))
                             if x != y))
    ttft = stats.latency_quantiles("ttft")
    slot_windows = stats.spec_windows
    result = {"phase": "serve_spec", "gamma": GAMMA, "draft": "self",
              "requests": len(prompts), "new_tokens": stats.total_tokens,
              "tokens_per_s": stats.total_tokens / stats.wall,
              "wall_s": stats.wall, "ttft_p50_s": ttft["p50"],
              "windows": stats.steps,
              "ms_per_window_decode_only": 1e3 * float(np.mean(windows_s)),
              "decode_only_windows": len(windows_s),
              "decode_only_tokens_per_s": 8 * (stats.accepted_per_window + 1)
              / float(np.mean(windows_s)),
              "slot_windows": slot_windows,
              "tokens_per_slot_window": (stats.spec_accepted + slot_windows)
              / max(slot_windows, 1),
              "accepted_per_window": stats.accepted_per_window,
              "spec_drafted": stats.spec_drafted,
              "spec_accepted": stats.spec_accepted,
              "spec_wasted": stats.spec_wasted,
              "host_waits_per_window": breakdown.get("host_waits_per_step"),
              "kernel_launches": launches, "kernel_variants": variants,
              "rerun_identical": True, "rerun_wall_s": stats2.wall,
              "greedy_agreement_with_serve": {
                  "reading": "tokens equal before the first difference "
                             "(64 = the whole stream)", **{
                      str(k): v for k, v in agree.items()}},
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "profiled_windows": breakdown}
    del llm
    torch.cuda.empty_cache()
    result["fp8_session"] = serve_spec_fp8(torch, model, prompts, sps)
    return result


SPEC_FP8_REQUESTS, SPEC_FP8_NEW = 4, 32


def serve_spec_fp8(torch, model, prompts, sps) -> dict:
    """Speculation over fp8 code pools, the one place the scale-pool online
    kernel (draft steps) and the exact kernel's code-pool path (verify)
    meet on a serve path: the serve phase's first 4 requests (2 greedy, 2
    sampled), 32 new tokens each, gamma 4.  Every request finishes, both
    kernels launch as the tensor-core variant, once per layer per draft or
    backfill step and once per layer per window."""
    from repro_torch.kernels import LAUNCHES, VARIANT_LAUNCHES
    from repro_torch.kernels.decode_attention.paged_kernel import (
        NAME_EXACT, NAME_SCALED,
    )
    from repro_torch.runtime.llm import LLMEngine
    from repro_torch.runtime.speculative import SpeculativeConfig

    cfg = model.cfg
    llm = LLMEngine(model, backend="continuous", device="cuda", num_slots=8,
                    page_size=16, max_len=2048, prefill_chunk=256,
                    cache_dtype="fp8",
                    speculative=SpeculativeConfig(gamma=GAMMA))
    reqs = [dataclasses.replace(sp, max_tokens=SPEC_FP8_NEW)
            for sp in sps[:SPEC_FP8_REQUESTS]]
    LAUNCHES.clear()
    VARIANT_LAUNCHES.clear()
    t0 = time.perf_counter()
    outs = llm.generate(prompts[:SPEC_FP8_REQUESTS], reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = llm.last_stats
    launches = {k: v for k, v in LAUNCHES.items() if v}
    variants = {k: v for k, v in VARIANT_LAUNCHES.items() if v}
    for o in outs:
        if (o.finish_reason != "length" or len(o.token_ids) != SPEC_FP8_NEW
                or not all(0 <= t < cfg.vocab_size for t in o.token_ids)):
            raise AssertionError(f"spec fp8 request {o.rid}: {o}")
    want = {NAME_EXACT: cfg.n_layers * stats.steps,
            NAME_SCALED: cfg.n_layers * (GAMMA + 1) * stats.steps}
    want_variants = {f"{k}:tensor_core": v for k, v in want.items()}
    if (launches != want or variants != want_variants
            or stats.spec_windows == 0):
        raise AssertionError(f"spec fp8 launched {launches} ({variants}), "
                             f"want {want} on the tensor-core kernels "
                             f"({stats.steps} windows)")
    del llm
    torch.cuda.empty_cache()
    return {"cache_dtype": "fp8", "requests": SPEC_FP8_REQUESTS,
            "new_tokens": stats.total_tokens, "wall_s": wall,
            "windows": stats.steps, "slot_windows": stats.spec_windows,
            "accepted_per_window": stats.accepted_per_window,
            "spec_drafted": stats.spec_drafted,
            "spec_accepted": stats.spec_accepted,
            "kernel_launches": launches, "kernel_variants": variants}


LEGACY_PROMPT, LEGACY_NEW = 256, 32


def serve_spec_legacy_phase(torch, model) -> dict:
    """``LLMEngine(backend="speculative")`` with the model as its own
    draft: one greedy prompt of 256 tokens, 32 new.  The dense decode
    kernel must run once per layer for every draft and target step the
    engine counts, the flash kernel once per layer for each of the two
    prompt prefills; a second call reproduces the stream."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.decode_attention.kernel import NAME as DENSE
    from repro_torch.kernels.flash_attention.kernel import NAME as FLASH
    from repro_torch.runtime.llm import LLMEngine
    from repro_torch.runtime.sampling import SamplingParams

    cfg = model.cfg
    prompt = np.random.default_rng(9).integers(0, cfg.vocab_size,
                                               LEGACY_PROMPT)
    llm = LLMEngine(model, backend="speculative", device="cuda", gamma=GAMMA,
                    max_len=512)
    sp = SamplingParams(max_tokens=LEGACY_NEW)
    LAUNCHES.clear()
    t0 = time.perf_counter()
    out = llm.generate([prompt], sp)[0]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in LAUNCHES.items() if v}
    m = out.metrics
    if (out.finish_reason != "length" or len(out.token_ids) != LEGACY_NEW
            or not all(0 <= t < cfg.vocab_size for t in out.token_ids)):
        raise AssertionError(f"legacy speculative request: {out}")
    # a window: gamma draft steps + the backfill, gamma + 1 target steps
    steps = 2 * (GAMMA + 1) * m["windows"]
    want = {FLASH: 2 * cfg.n_layers, DENSE: cfg.n_layers * steps}
    if launches != want:
        raise AssertionError(f"legacy speculative launched {launches}, want "
                             f"{want} ({m})")
    again = llm.generate([prompt], sp)[0]
    if again.token_ids != out.token_ids:
        raise AssertionError("legacy speculative stream did not reproduce")
    return {"phase": "serve_spec_legacy", "gamma": GAMMA, "draft": "self",
            "prompt_tokens": LEGACY_PROMPT, "new_tokens": LEGACY_NEW,
            "wall_s": wall, "tokens_per_s": LEGACY_NEW / wall,
            "windows": m["windows"],
            "accepted_per_window": m["accepted_per_window"],
            "single_token_steps": steps, "kernel_launches": launches,
            "rerun_identical": True}


# serve_spec_draft: a truncated draft (the target's first layers, deeper
# blocks damped; ``runtime/spec_pair.py``) against plain decoding, both
# sized by a DeploymentSpec
DRAFT_LAYERS, DRAFT_DAMP = 2, 0.005     # a quarter of LLAMA_LAYERS
DRAFT_REQUESTS, DRAFT_PROMPT, DRAFT_NEW = 8, 256, 64
DRAFT_ORDER = ("plain", "spec", "spec", "plain")     # two reps each


def spec_draft_session(torch, llm, prompts, sp, on_step=None,
                       steady_limit=None):
    """One session through the incremental interface: every request added
    at once.  Returns (streams, stats, seconds of each step taken while
    every request is decoding and none has finished); ``on_step`` runs
    after each such step, and the session stops after ``steady_limit`` of
    them (its requests left unfinished)."""
    llm.reset()
    for i, p in enumerate(prompts):
        llm.add_request(p, sp, rid=i)
    streams = {i: [] for i in range(len(prompts))}
    steady, done = [], set()
    while llm.has_unfinished():
        all_started = all(streams.values()) and not done
        t = time.perf_counter()
        outs = llm.step()                   # ends in a device -> host copy
        if all_started:
            steady.append(time.perf_counter() - t)
            if on_step is not None:
                on_step()
            if steady_limit is not None and len(steady) >= steady_limit:
                break
        for o in outs:
            streams[o.rid].extend(o.new_token_ids)
            if o.finished:
                done.add(o.rid)
    return streams, llm.stats(), steady


def serve_spec_draft_phase(torch, model) -> dict:
    """Speculative decoding with a cheap draft: the target is the full
    llama3-8b, the draft its first ``DRAFT_LAYERS`` layers (``build_pair``:
    shared tensors; the target's deeper ``wo``/``w_down`` scaled by
    ``DRAFT_DAMP`` in place, so this phase runs after every other serve
    phase).  Two engines, both ``LLMEngine(backend="continuous",
    spec=DeploymentSpec(sku="h100", max_len=512, page_size=16,
    max_slots=8))``, one plain and one with
    ``speculative=SpeculativeConfig(draft_model=draft, gamma=GAMMA)``, serve
    8 greedy requests (distinct 256-token prompts, ``DRAFT_NEW`` new
    tokens) twice each, in turns (``DRAFT_ORDER``) and before any trace;
    the faster rep of each gives tokens/s and the speedup.  Then one
    traced session of each (device busy time).  The plain engine must
    launch the paged kernel once per
    layer per step; the speculative one the paged kernel once per draft
    layer per draft or backfill step and the exact kernel once per target
    layer per window.  Greedy speculative streams must equal the plain
    ones, or part at a near-tie: where they part, the plain stream's top-2
    logit gap (by ``Model.forward`` on the card) is at most
    ``NEAR_TIE_BF16_ULPS`` bf16 ulps of the top logit.  The measured
    per-token acceptance is priced back through ``resolve(...,
    spec_accept_rate=alpha)``: measured accepted per window, window and
    step time against the modeled ones; the pools each engine allocates
    (``torch.cuda.memory_allocated`` growth at set-up) against
    ``pool_bytes_per_device``."""
    from repro_torch.kernels import LAUNCHES, VARIANT_LAUNCHES
    from repro_torch.kernels.decode_attention.paged_kernel import (
        NAME, NAME_EXACT,
    )
    from repro_torch.runtime.deployment import DeploymentSpec
    from repro_torch.runtime.llm import LLMEngine
    from repro_torch.runtime.sampling import SamplingParams
    from repro_torch.runtime.spec_pair import build_pair
    from repro_torch.runtime.speculative import SpeculativeConfig

    target, draft = build_pair(model, DRAFT_LAYERS, DRAFT_DAMP)
    cfg = target.cfg
    spec = DeploymentSpec(sku="h100", max_len=512, page_size=16, max_slots=8)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, DRAFT_PROMPT)
               for _ in range(DRAFT_REQUESTS)]
    sp = SamplingParams(max_tokens=DRAFT_NEW)
    engines, runs = {}, {}
    for name, sc in (("plain", None),
                     ("spec", SpeculativeConfig(draft_model=draft,
                                                gamma=GAMMA))):
        free, total = torch.cuda.mem_get_info()
        llm = LLMEngine(target, backend="continuous", device="cuda",
                        spec=spec, speculative=sc)
        dep = llm.deployment
        if dep.num_slots < DRAFT_REQUESTS:
            raise AssertionError(f"{name}: the spec gives {dep.num_slots} "
                                 f"slots for {DRAFT_REQUESTS} requests")
        if dep.pool_bytes_per_device >= free:
            raise AssertionError(f"{name}: the spec's pools "
                                 f"({dep.pool_bytes_per_device} B) do not "
                                 f"fit the card's free {free} B")
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        llm.reset()                          # allocates the pools
        torch.cuda.synchronize()
        growth = torch.cuda.memory_allocated() - before
        leaves = sum(leaf.nbytes for leaf in llm._eng._pool_leaves())
        scratch = dep.kv_token_bytes * dep.page_size
        if leaves - scratch != dep.pool_bytes_per_device:
            raise AssertionError(f"{name}: pools take {leaves} B, "
                                 f"{leaves - scratch} without the scratch "
                                 f"page, budget {dep.pool_bytes_per_device}")
        engines[name] = llm
        runs[name] = dict(
            num_slots=dep.num_slots, num_pages=dep.num_pages,
            prefill_chunk=dep.prefill_chunk,
            max_decode_slots=dep.max_decode_slots,
            pool_bytes_per_device=dep.pool_bytes_per_device,
            pool_leaf_bytes=leaves, pool_alloc_growth_bytes=growth,
            card_mem_total_bytes=total, card_mem_free_bytes_before=free)

    def rep(name):
        """One checked session of engine ``name``."""
        LAUNCHES.clear()
        VARIANT_LAUNCHES.clear()
        streams, stats, steady = spec_draft_session(torch, engines[name],
                                                    prompts, sp)
        torch.cuda.synchronize()
        launches = {k: v for k, v in LAUNCHES.items() if v}
        variants = {k: v for k, v in VARIANT_LAUNCHES.items() if v}
        for i, st in streams.items():
            out = stats.outputs[i]
            if (out.finish_reason != "length" or st != out.token_ids
                    or len(st) != DRAFT_NEW
                    or not all(0 <= t < cfg.vocab_size for t in st)):
                raise AssertionError(f"{name} request {i}: {out}")
        if name == "plain":
            want = {NAME: cfg.n_layers * stats.steps}
        else:
            want = {NAME: DRAFT_LAYERS * (GAMMA + 1) * stats.steps,
                    NAME_EXACT: cfg.n_layers * stats.steps}
        want_variants = {f"{k}:tensor_core": v for k, v in want.items()}
        if launches != want or variants != want_variants:
            raise AssertionError(f"{name} launched {launches} ({variants}), "
                                 f"want {want} on the tensor-core kernels "
                                 f"({stats.steps} steps)")
        return stats.wall, streams, stats, steady, launches

    # the reps in turns (plain, spec, spec, plain), all before any trace
    reps = {"plain": [], "spec": []}
    for name in DRAFT_ORDER:
        reps[name].append(rep(name))
    for name, llm in engines.items():
        wall, streams, stats, steady, launches = min(reps[name],
                                                     key=lambda r: r[0])
        if any(r[1] != streams for r in reps[name]):
            raise AssertionError(f"{name}: a rep did not reproduce the "
                                 f"streams")
        # one more session, traced over 8 steady steps (windows) and cut
        # there: device busy time against the untraced median
        from torch.profiler import ProfilerActivity, profile, schedule
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(**PROFILE)) as prof:
            spec_draft_session(torch, llm, prompts, sp, on_step=prof.step,
                               steady_limit=sum(PROFILE.values()))
        runs[name].update(
            wall_s=wall, rep_walls_s=[r[0] for r in reps[name]],
            tokens_per_s=stats.total_tokens / wall,
            new_tokens=stats.total_tokens, steps=stats.steps,
            steady_steps=len(steady),
            steady_step_ms=1e3 * float(np.median(steady)),
            ttft_p50_s=stats.ttft_quantiles()[0],
            kernel_launches=launches,
            profiled_steady_steps=device_breakdown(
                prof, float(np.median(steady))),
            _streams=streams, _stats=stats)
    del engines, llm
    torch.cuda.empty_cache()
    plain, spec_run = runs["plain"], runs["spec"]
    st = spec_run.pop("_stats")
    plain.pop("_stats")
    alpha = st.spec_accepted / max(st.spec_drafted, 1)
    near_ties, bad = [], []
    pstreams = plain.pop("_streams")
    sstreams = spec_run.pop("_streams")
    for i in range(DRAFT_REQUESTS):
        a, b = sstreams[i], pstreams[i]
        if a == b:
            continue
        t = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        toks = torch.as_tensor(np.concatenate([prompts[i], b[:t]]),
                               device="cuda")[None].long()
        top = target.forward(toks)[0, -1, :cfg.vocab_size].float().topk(
            2).values
        gap = float(top[0] - top[1])
        ulp = 2.0 ** (math.floor(math.log2(abs(float(top[0])))) - 7)
        near_ties.append({"request": i, "token": t, "gap": gap,
                          "gap_bf16_ulps": gap / ulp})
        if not gap <= NEAR_TIE_BF16_ULPS * ulp:
            bad.append(near_ties[-1])
    modeled = spec.resolve(target, params=target, draft=draft,
                           draft_params=draft, gamma=GAMMA,
                           spec_accept_rate=alpha)
    plain_dep = spec.resolve(target, params=target)
    window_ms = spec_run["steady_step_ms"]
    step_ms = plain["steady_step_ms"]
    busy = {k: r["profiled_steady_steps"].get("device_busy_ms_per_step")
            for k, r in runs.items()}
    result = {"phase": "serve_spec_draft", "gamma": GAMMA,
            "draft": f"first {DRAFT_LAYERS} of {cfg.n_layers} layers, "
                     f"deeper wo/w_down x {DRAFT_DAMP}",
            "requests": DRAFT_REQUESTS, "prompt_tokens": DRAFT_PROMPT,
            "new_tokens_each": DRAFT_NEW, "rep_order": DRAFT_ORDER,
            "plain": plain, "spec": spec_run,
            "speedup": spec_run["tokens_per_s"] / plain["tokens_per_s"],
            "accepted_per_window": st.accepted_per_window,
            "per_token_acceptance": alpha,
            "accepted_per_window_modeled": modeled.spec_expected_accepted,
            "window_ms_measured": window_ms,
            "window_ms_modeled": 1e3 * modeled.spec_window_seconds,
            "step_ms_measured": step_ms,
            "step_ms_modeled": 1e3 * plain_dep.step_seconds,
            "device_busy_ms_per_step": busy["plain"],
            "device_busy_ms_per_window": busy["spec"],
            "tokens_per_s_ceiling_modeled": {
                "plain": plain_dep.tokens_per_s_ceiling,
                "spec": modeled.spec_tokens_per_s_ceiling},
            "greedy_near_ties": near_ties,
            "greedy_streams_equal": DRAFT_REQUESTS - len(near_ties)}
    if bad:
        print("  serve_spec_draft:", json.dumps(result))
        raise AssertionError(f"greedy speculative streams part from plain "
                             f"decoding at gaps above "
                             f"{NEAR_TIE_BF16_ULPS} bf16 ulps: {bad}")
    return result


# ---------------------------------------------------------------------------
# 10. static serve phase
# ---------------------------------------------------------------------------

STATIC_PROMPT, STATIC_NEW = 1024, 64
# decode steps of the static phases' device-time trace (16 until the
# stateful models joined: a trace is read in time proportional to its
# ops, ~55 small ones a layer a step for them)
STATIC_PROFILE_STEPS = 4


def device_time_by_kernel(torch, fn) -> tuple[dict, dict]:
    """Device time (ms) of everything ``fn`` ran on the card, by kernel
    name, and of the model's named ranges (``SPANS``), from one
    ``torch.profiler`` trace (``trace_summary``)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    trace = trace_summary(prof)
    return ({k: t / 1e3 for k, t in trace["device_us"].items()},
            trace["spans_ms"])


def serve_static_phase(torch, model, phase: str = "serve_static",
                       n_prompts: int = 8, prompt_len: int = STATIC_PROMPT,
                       max_len: int = 2048) -> dict:
    """``LLMEngine(backend="static")`` answers ``n_prompts`` prompts of
    ``prompt_len`` tokens (greedy and sampled in turn; 8 of 1024 unless
    the phase says otherwise) with 64 new tokens each, twice (the re-run
    must reproduce every stream), then scores two prompts
    (``prompt_logprobs``).  The flash kernel must run once per layer per
    prefill or forward call and the dense decode kernel once per layer per
    decode step.  A profiled call of ``STATIC_PROFILE_STEPS`` + 1 new tokens
    minus one of 1 gives the device time of that many decode steps."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.decode_attention.kernel import NAME as DENSE
    from repro_torch.kernels.flash_attention.kernel import NAME as FLASH
    from repro_torch.runtime.llm import LLMEngine
    from repro_torch.runtime.sampling import SamplingParams
    from repro_torch.runtime.state_cache import state_bytes_per_slot

    cfg = model.cfg
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, prompt_len)
               for _ in range(n_prompts)]
    sps = [SamplingParams(max_tokens=STATIC_NEW) if i % 2 == 0 else
           SamplingParams(max_tokens=STATIC_NEW, temperature=0.8, top_p=0.9,
                          top_k=40, seed=2000 + i) for i in range(n_prompts)]
    torch.cuda.reset_peak_memory_stats()
    llm = LLMEngine(model, backend="static", device="cuda", max_len=max_len)
    n_gqa = gqa_layers(model)
    n_flash = n_gqa + mla_layers(model)
    per_token = (cfg.kv_lora_rank + cfg.rope_head_dim if cfg.mla
                 else 2 * cfg.n_kv_heads * cfg.hd if n_gqa else 0)
    # a windowed layer's cache holds min(max_len, window) entries: a ring;
    # an ssm layer keeps only its state
    cache_gb = sum(n_prompts * min(max_len, win or max_len) * per_token * 2
                   for win, blk in zip(model.windows, model.layers)
                   if blk.kind != "ssm") / 1e9

    def want_launches(calls, steps):
        # flash runs every GQA and MLA layer's prefill and forward (MLA's
        # at D 192 / Dv 128); MLA decodes by the absorbed einsums, as the
        # reference does, and an ssm layer has no attention
        want = {FLASH: n_flash * calls} if n_flash else {}
        if n_gqa:
            want[DENSE] = n_gqa * steps
        return want

    LAUNCHES.clear()
    t0 = time.perf_counter()
    outs = llm.generate(prompts, sps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in LAUNCHES.items() if v}
    for i, o in enumerate(outs):
        if (not o.finished or o.finish_reason != "length"
                or len(o.token_ids) != STATIC_NEW
                or not all(0 <= t < cfg.vocab_size for t in o.token_ids)):
            raise AssertionError(f"static request {i}: {o}")
    want = want_launches(1, STATIC_NEW - 1)
    if launches != want:
        raise AssertionError(f"static serve launched {launches}, want {want} "
                             f"(1 prefill call, {STATIC_NEW - 1} decode "
                             f"steps, {n_gqa} GQA layers)")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    again = llm.generate(prompts, sps)
    for i, (a, o) in enumerate(zip(again, outs)):
        if a.token_ids != o.token_ids:
            kind = "greedy" if sps[i].is_greedy else "sampled"
            raise AssertionError(f"static {kind} request {i} did not "
                                 f"reproduce its stream on the re-run")

    LAUNCHES.clear()
    scored = llm.generate(prompts[:2], SamplingParams(max_tokens=4,
                                                      prompt_logprobs=True))
    torch.cuda.synchronize()
    launches_scored = {k: v for k, v in LAUNCHES.items() if v}
    want = want_launches(2, 3)              # prefill + forward; 3 steps
    if launches_scored != want:
        raise AssertionError(f"scored static call launched "
                             f"{launches_scored}, want {want}")
    for o in scored:
        plp = np.asarray(o.prompt_logprobs)
        if plp.shape != (prompt_len - 1,) or not (
                np.isfinite(plp).all() and (plp <= 0).all()):
            raise AssertionError(f"prompt_logprobs of request {o.rid}: shape "
                                 f"{plp.shape}, finite {np.isfinite(plp).all()}")

    # device time of the profiled decode steps: a call of
    # STATIC_PROFILE_STEPS + 1 tokens minus a 1-token one
    steps = STATIC_PROFILE_STEPS
    one = [dataclasses.replace(sp, max_tokens=1) for sp in sps]
    many = [dataclasses.replace(sp, max_tokens=steps + 1) for sp in sps]
    t_one, s_one = device_time_by_kernel(
        torch, lambda: llm.generate(prompts, one))
    t_many, s_many = device_time_by_kernel(
        torch, lambda: llm.generate(prompts, many))
    per_step = {k: (t_many.get(k, 0.0) - t_one.get(k, 0.0)) / steps
                for k in set(t_many) | set(t_one)}
    span_step = {k: (s_many.get(k, 0.0) - s_one.get(k, 0.0)) / steps
                 for k in set(s_many) | set(s_one)}
    busy = sum(per_step.values())
    step_ms = 1e3 * outs[0].metrics["tpot"]
    top = sorted(per_step.items(), key=lambda kv: -kv[1])[:8]
    result = {"phase": phase, "requests": len(prompts),
              "prompt_tokens": prompt_len,
              "new_tokens": n_prompts * STATIC_NEW,
              "tokens_per_s": n_prompts * STATIC_NEW / wall, "wall_s": wall,
              "sim_context": prompt_len + STATIC_NEW / 2,
              "sim_batch": n_prompts,
              "prefill_s": outs[0].metrics["ttft"],
              "decode_step_ms": step_ms,
              "kernel_launches": launches,
              "kernel_launches_scored_call": launches_scored,
              "flash_layers": n_flash,
              "rerun_identical": True, "dense_cache_gb": cache_gb,
              "state_cache_gb": (n_prompts * state_bytes_per_slot(cfg) / 1e9
                                 if model.needs_state else 0.0),
              "peak_mem_gb": peak_gb,
              "profiled_decode_steps": {
                  "steps": steps, "device_busy_ms_per_step": busy,
                  "device_idle_share": 1 - busy / step_ms,
                  "decode_attention_ms_per_step": sum(
                      t for k, t in per_step.items() if "dense_decode" in k),
                  "prefill_flash_ms": t_one.get(next(
                      (k for k in t_one if "flash_fwd" in k), ""), 0.0),
                  "prefill_device_ms": sum(t_one.values()),
                  "prefill_spans_device_ms": s_one,
                  "spans_device_ms_per_step": span_step,
                  "top_kernels_ms_per_step": {k[:70]: t for k, t in top}}}
    del llm
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# 18. check phase: kernel path on the card == plain path on the CPU
# ---------------------------------------------------------------------------


def cpu_top2_gap(torch, model, prompt, tokens, cache_dtype) -> float:
    """Gap between the two largest logits the CPU model gives after
    ``prompt + tokens`` (one prefill chunk into fresh pools)."""
    toks = torch.as_tensor(np.concatenate([prompt, tokens]), dtype=torch.int64)
    n = len(toks)
    n_blocks = -(-n // PAGE)
    pools = model.init_paged_cache(n_blocks + 1, PAGE, dtype=cache_dtype)
    table = torch.arange(1, n_blocks + 1, dtype=torch.int32)[None]
    zero = torch.zeros(1, dtype=torch.int32)
    states = model.init_state_pools(1) if model.needs_state else None
    logits = model.prefill_chunk_paged(toks[None], pools, table, zero,
                                       torch.full((1,), n, dtype=torch.int32),
                                       states=states, slot_idx=zero)
    top = logits[0].topk(2).values
    return float(top[0] - top[1])


def divergences(torch, label, got, want, prompts, reqs, gap_model,
                cache_dtype, ties_ok) -> list[dict]:
    """Where two runs' streams part.  A greedy stream may part only at a
    near-tie (``ties_ok``): a step whose top-2 logit gap on the CPU model
    ``gap_model`` is below ``NEAR_TIE``; any other difference fails."""
    near_ties = []
    for g, c, prompt, sp in zip(got, want, prompts, reqs):
        if g.token_ids == c.token_ids:
            continue
        t = next(i for i, (a, b) in enumerate(zip(g.token_ids, c.token_ids))
                 if a != b)
        gap = None
        if ties_ok and sp.is_greedy:
            gap = cpu_top2_gap(torch, gap_model, prompt,
                               np.asarray(c.token_ids[:t]), cache_dtype)
        if gap is None or gap >= NEAR_TIE:
            raise AssertionError(
                f"{label}, request {g.rid}: {g.token_ids} vs {c.token_ids} "
                f"(first difference at token {t}, CPU top-2 gap {gap}, "
                f"near-tie below {NEAR_TIE})")
        near_ties.append({"request": g.rid, "token": t, "cpu_gap": gap})
        print(f"  check {label}: request {g.rid} diverges at token {t} at a "
              f"near-tie (CPU top-2 logit gap {gap:.3g} < {NEAR_TIE})")
    return near_ties


def stream_min_gap(torch, model, prompt, tokens) -> float:
    """The smallest top-2 logit gap the CPU model gives at the positions
    that chose ``tokens`` after ``prompt`` (one ``Model.forward``)."""
    toks = torch.as_tensor(np.concatenate([prompt, tokens]),
                           dtype=torch.int64)[None]
    logits = model.forward(toks)[0, len(prompt) - 1:-1]
    top = logits.topk(2, dim=-1).values
    return float((top[:, 0] - top[:, 1]).min())


def spec_checks(torch, cpu, gpu, prompts, greedy, s_prompts, kw) -> list:
    """Speculative decoding on the narrow f32 model, greedy: the
    continuous engine's self-draft speculation on the card against the
    same on the CPU and against the plain engine on the card, acceptance
    gamma in every window of a request unless its stream holds a near-tie,
    and the legacy backend on the card against the CPU."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.decode_attention.kernel import NAME as DENSE
    from repro_torch.kernels.decode_attention.paged_kernel import (
        NAME, NAME_EXACT,
    )
    from repro_torch.kernels.flash_attention.kernel import NAME as FLASH
    from repro_torch.runtime.llm import LLMEngine
    from repro_torch.runtime.speculative import SpeculativeConfig

    f32 = torch.float32
    results = []
    spec_kw = dict(kw, cache_dtype=f32,
                   speculative=SpeculativeConfig(gamma=GAMMA))
    LAUNCHES.clear()
    llm_gpu = LLMEngine(gpu, device="cuda", **spec_kw)
    sp_gpu = llm_gpu.generate(prompts, greedy)
    launches = {k: v for k, v in LAUNCHES.items() if v}
    windows = llm_gpu.last_stats.steps
    want = {NAME_EXACT: gpu.cfg.n_layers * windows,
            NAME: gpu.cfg.n_layers * (GAMMA + 1) * windows}
    if launches != want:
        raise AssertionError(f"spec card run launched {launches}, want "
                             f"{want}")
    llm_cpu = LLMEngine(cpu, device="cpu", **spec_kw)
    sp_cpu = llm_cpu.generate(prompts, greedy)
    plain_gpu = LLMEngine(gpu, device="cuda", cache_dtype=f32,
                          **kw).generate(prompts, greedy)
    near = divergences(torch, "spec f32, card vs CPU", sp_gpu, sp_cpu,
                       prompts, greedy, cpu, f32, True)
    results.append({"case": "continuous spec f32 (self-draft, gamma "
                    f"{GAMMA}), card vs CPU, greedy",
                    "identical": not near, "near_ties": near,
                    "kernel_launches": launches})
    near = divergences(torch, "spec vs plain, card", sp_gpu, plain_gpu,
                       prompts, greedy, cpu, f32, True)
    results.append({"case": "continuous spec vs plain f32, card, greedy",
                    "identical": not near, "near_ties": near})
    # acceptance: gamma in every window on the CPU (virtual slots are the
    # plain decode step bit for bit); on the card a request may lose a
    # proposal only where its stream holds a near-tie
    accept = {}
    for label, llm, outs in (("cpu", llm_cpu, sp_cpu),
                             ("card", llm_gpu, sp_gpu)):
        for rid, rec in llm.last_stats.per_request.items():
            full = GAMMA * rec["spec_windows"]
            accept[f"{label} request {rid}"] = (rec["spec_accepted"], full)
            if rec["spec_accepted"] == full:
                continue
            gap = stream_min_gap(torch, cpu, prompts[rid],
                                 np.asarray(outs[rid].token_ids))
            if label == "cpu" or gap >= NEAR_TIE:
                raise AssertionError(
                    f"self-draft spec on the {label}, request {rid}: "
                    f"accepted {rec['spec_accepted']} of {full} proposals "
                    f"(smallest CPU top-2 gap of its stream {gap})")
    results.append({"case": "self-draft acceptance (accepted, drafted)",
                    "per_request": accept})
    # the legacy backend (dense caches; the flash and dense decode kernels)
    leg_kw = dict(backend="speculative", gamma=GAMMA, max_len=128,
                  cache_dtype=f32)
    leg_prompts, leg_greedy = s_prompts[:2], greedy[:2]
    LAUNCHES.clear()
    leg_gpu = LLMEngine(gpu, device="cuda", **leg_kw).generate(leg_prompts,
                                                               leg_greedy)
    launches = {k: v for k, v in LAUNCHES.items() if v}
    steps = sum(2 * (GAMMA + 1) * o.metrics["windows"] for o in leg_gpu)
    want = {FLASH: 2 * len(leg_prompts) * gpu.cfg.n_layers,
            DENSE: steps * gpu.cfg.n_layers}
    if launches != want:
        raise AssertionError(f"legacy spec card run launched {launches}, "
                             f"want {want}")
    leg_cpu = LLMEngine(cpu, device="cpu", **leg_kw).generate(leg_prompts,
                                                              leg_greedy)
    near = divergences(torch, "legacy spec f32, card vs CPU", leg_gpu,
                       leg_cpu, leg_prompts, leg_greedy, cpu, f32, True)
    results.append({"case": "legacy speculative f32, card vs CPU, greedy",
                    "identical": not near, "near_ties": near,
                    "kernel_launches": launches})
    return results


def check_phase(torch) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.decode_attention.kernel import NAME as DENSE
    from repro_torch.kernels.decode_attention.paged_kernel import (
        NAME, NAME_SCALED,
    )
    from repro_torch.kernels.flash_attention.kernel import NAME as FLASH
    from repro_torch.kernels.mxfp4_vmm.kernel import NAME as VMM
    from repro_torch.models.model import Model
    from repro_torch.quant.linear import quantize_params
    from repro_torch.runtime.llm import LLMEngine
    from repro_torch.runtime.sampling import SamplingParams

    cfg = dataclasses.replace(get_config("llama3-8b"), name="llama3-narrow",
                              n_layers=2, d_model=512, n_heads=8,
                              n_kv_heads=2, head_dim=128, d_ff=1024,
                              vocab_size=4000, vocab_pad_multiple=512)
    cpu = Model(cfg, device="cpu").init(seed=5).float()
    gpu = Model(cfg, device="cuda").float()
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (40, 75, 19, 100)]
    sps = [SamplingParams(max_tokens=16),
           SamplingParams(max_tokens=16, temperature=0.9, top_k=20, seed=4),
           SamplingParams(max_tokens=16),
           SamplingParams(max_tokens=16, temperature=0.7, top_p=0.9, seed=8)]
    greedy = [SamplingParams(max_tokens=16)] * len(prompts)
    kw = dict(backend="continuous", num_slots=4, page_size=16, max_len=256,
              prefill_chunk=32)
    # dense: greedy and sampled streams identical.  mxfp4: the op rounds
    # the f32 activations to bf16, which turns the card's last-bit f32
    # differences (other sum orders) into whole bf16 steps of an input now
    # and then, so logits differ at ~1e-4; greedy streams may then part at
    # a near-tie, and nowhere else
    cases = [  # (label, engine options, requests, near-ties allowed)
        ("dense f32", dict(cache_dtype=torch.float32), sps, False),
        ("mxfp4, f32 pools", dict(cache_dtype=torch.float32,
                                  weight_format="mxfp4"), greedy, True),
        ("mxfp4, int8 pools", dict(cache_dtype="int8",
                                   weight_format="mxfp4"), greedy, True),
        ("mxfp4, fp8 pools", dict(cache_dtype="fp8",
                                  weight_format="mxfp4"), greedy, True)]
    results = []
    for label, opts, reqs, ties_ok in cases:
        LAUNCHES.clear()
        on_gpu = LLMEngine(gpu, device="cuda", **kw, **opts).generate(
            prompts, reqs)
        launches = {k: v for k, v in LAUNCHES.items() if v}
        on_cpu = LLMEngine(cpu, device="cpu", **kw, **opts).generate(
            prompts, reqs)
        want = {NAME_SCALED if isinstance(opts["cache_dtype"], str) else NAME}
        if "weight_format" in opts:
            want.add(VMM)
        if set(launches) != want:
            raise AssertionError(f"{label}: the card run launched {launches}, "
                                 f"want each of {sorted(want)}")
        view = (quantize_params(cpu, opts["weight_format"])
                if "weight_format" in opts else cpu)
        near_ties = divergences(torch, label, on_gpu, on_cpu, prompts, reqs,
                                view, opts["cache_dtype"], ties_ok)
        results.append({"case": label, "identical": not near_ties,
                        "near_ties": near_ties, "kernel_launches": launches})

    # static (f32 dense cache): card against CPU, greedy and sampled, and
    # prompt scores; then static against continuous on the card, greedy.
    # The flash and dense decode kernels sum in other orders than
    # blocked_attention and the paged kernel, so a greedy stream may part
    # at a near-tie, and nowhere else
    s_prompts = [rng.integers(0, cfg.vocab_size, 48) for _ in range(4)]
    s_sps = [SamplingParams(max_tokens=16, prompt_logprobs=True)] + sps[1:]
    s_greedy = [SamplingParams(max_tokens=16)] * len(s_prompts)
    static_kw = dict(backend="static", max_len=128, cache_dtype=torch.float32)
    LAUNCHES.clear()
    st_gpu = LLMEngine(gpu, device="cuda", **static_kw).generate(s_prompts,
                                                                 s_sps)
    launches = {k: v for k, v in LAUNCHES.items() if v}
    st_cpu = LLMEngine(cpu, device="cpu", **static_kw).generate(s_prompts,
                                                                s_sps)
    want = {FLASH: 2 * cfg.n_layers, DENSE: 15 * cfg.n_layers}
    if launches != want:                 # prefill + forward; 15 steps
        raise AssertionError(f"static card run launched {launches}, want "
                             f"{want}")
    near_ties = divergences(torch, "static f32", st_gpu, st_cpu, s_prompts,
                            s_sps, cpu, torch.float32, True)
    plp_err = float(np.abs(np.asarray(st_gpu[0].prompt_logprobs)
                           - np.asarray(st_cpu[0].prompt_logprobs)).max())
    if not plp_err <= 1e-4:
        raise AssertionError(f"static prompt_logprobs card vs CPU differ by "
                             f"{plp_err} (tolerance 1e-4)")
    results.append({"case": "static f32, card vs CPU",
                    "identical": not near_ties, "near_ties": near_ties,
                    "prompt_logprobs_max_abs_err": plp_err,
                    "kernel_launches": launches})
    st_greedy = LLMEngine(gpu, device="cuda", **static_kw).generate(
        s_prompts, s_greedy)
    cont_greedy = LLMEngine(gpu, device="cuda", cache_dtype=torch.float32,
                            **kw).generate(s_prompts, s_greedy)
    near_ties = divergences(torch, "static vs continuous, card", st_greedy,
                            cont_greedy, s_prompts, s_greedy, cpu,
                            torch.float32, True)
    results.append({"case": "static vs continuous f32, card, greedy",
                    "identical": not near_ties, "near_ties": near_ties})
    results += spec_checks(torch, cpu, gpu, prompts, greedy, s_prompts, kw)
    del cpu, gpu
    torch.cuda.empty_cache()
    results += check_mla(torch)
    results += check_train(torch)
    return {"phase": "check", "model": "llama3-8b widths cut to d_model 512, "
            "2 layers, f32; deepseek-v2-lite-16b cut to d_model 512, 2 "
            "layers, 8 experts, f32; a training step of each family's narrow "
            "f32 model (TRAIN_CHECKS)", "requests": len(prompts),
            "near_tie_gap": NEAR_TIE, "cases": results}


# ---------------------------------------------------------------------------
# 14-17. deepseek-v2-lite-16b: MLA attention and MoE (plain torch on the
# card, as the reference computes them outside any Pallas kernel), its
# MXFP4 projections through mxfp4_vmm; and the narrow MLA + MoE check
# ---------------------------------------------------------------------------


# depth of deepseek-v2-lite-16b's serve phases (widths full): 4 of its 27
# layers since the stateful phases joined the script, which keeps the
# whole run well inside its 1200 s limit
DEEPSEEK_LAYERS = 4


def build_deepseek(torch):
    """deepseek-v2-lite-16b at full width and ``DEEPSEEK_LAYERS`` layers (1
    mla_dense, the rest mla_moe with 64 routed experts, top 6, and 2
    shared; random bf16 weights from a seed, drawn on the card one expert
    at a time)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"),
                              n_layers=DEEPSEEK_LAYERS)
    t0 = time.monotonic()
    model = Model(cfg, device="cuda").init(seed=0)
    torch.cuda.synchronize()
    print(f"serve_mla: {cfg.name} {cfg.n_layers} layers, "
          f"{model.param_count() / 1e9:.2f} B params bf16 "
          f"({torch.cuda.memory_allocated() / 1e9:.2f} GB on the card), "
          f"random init {time.monotonic() - t0:.1f} s")
    return model


MOE_SPEC_REQUESTS, MOE_SPEC_NEW = 4, 32


def serve_moe_spec_phase(torch, model, phase: str) -> dict:
    """An MoE model (deepseek-v2-lite-16b, llama4-scout) behind
    ``LLMEngine(backend="continuous", speculative=SpeculativeConfig(
    gamma=GAMMA))``, a self-draft: the serve phase's first 4 requests (2
    greedy, 2 sampled), 32 new tokens each, twice; every request finishes
    and the second session reproduces every stream.  Accepted proposals
    per window are a reading only: a draft step's MoE counts the slots (T
    = 8) and a verify step's T = 8 x (gamma + 1), so under capacity the two
    may drop other assignments, and a GQA model's draft and verify steps
    run the online and exact kernels, which round apart.  Then the legacy
    ``backend="speculative"`` on one greedy 256-token prompt, 32 new
    tokens, twice.  MLA and MoE launch no kernel on the continuous
    backend (bf16 weights), MLA the flash kernel (D 192 / Dv 128) once a
    layer per prompt prefill on the legacy one; GQA
    layers launch the paged decode kernel once per layer for each of the
    gamma draft steps and the backfill and the exact kernel once per layer
    a window (both tensor-core variants), and on the legacy backend the
    flash kernel once per layer per prompt prefill and the dense decode
    kernel once per layer per single-token step."""
    from repro_torch.kernels import LAUNCHES, VARIANT_LAUNCHES
    from repro_torch.kernels.decode_attention.kernel import NAME as DENSE
    from repro_torch.kernels.decode_attention.paged_kernel import (
        NAME, NAME_EXACT,
    )
    from repro_torch.kernels.flash_attention.kernel import NAME as FLASH
    from repro_torch.runtime.llm import LLMEngine
    from repro_torch.runtime.sampling import SamplingParams
    from repro_torch.runtime.speculative import SpeculativeConfig

    cfg = model.cfg
    prompts, sps = serve_requests(SamplingParams, cfg.vocab_size)
    prompts = prompts[:MOE_SPEC_REQUESTS]
    reqs = [dataclasses.replace(sp, max_tokens=MOE_SPEC_NEW)
            for sp in sps[:MOE_SPEC_REQUESTS]]
    torch.cuda.reset_peak_memory_stats()
    llm = LLMEngine(model, backend="continuous", device="cuda", num_slots=8,
                    page_size=16, max_len=2048, prefill_chunk=256,
                    speculative=SpeculativeConfig(gamma=GAMMA))
    LAUNCHES.clear()
    VARIANT_LAUNCHES.clear()
    t0 = time.perf_counter()
    outs = llm.generate(prompts, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = llm.last_stats
    launches = {k: v for k, v in LAUNCHES.items() if v}
    variants = {k: v for k, v in VARIANT_LAUNCHES.items() if v}
    for o in outs:
        if (o.finish_reason != "length" or len(o.token_ids) != MOE_SPEC_NEW
                or not all(0 <= t < cfg.vocab_size for t in o.token_ids)):
            raise AssertionError(f"{phase} request {o.rid}: {o}")
    want = {} if cfg.mla else {
        NAME_EXACT: cfg.n_layers * stats.steps,
        NAME: cfg.n_layers * (GAMMA + 1) * stats.steps}
    want_variants = {f"{k}:tensor_core": v for k, v in want.items()}
    if (launches != want or variants != want_variants
            or stats.spec_windows == 0):
        raise AssertionError(f"{phase} launched {launches} ({variants}) "
                             f"with {stats.spec_windows} slot windows; want "
                             f"{want} on the tensor-core kernels and some "
                             f"windows")
    again = llm.generate(prompts, reqs)
    for i, (a, o) in enumerate(zip(again, outs)):
        if a.token_ids != o.token_ids:
            kind = "greedy" if reqs[i].is_greedy else "sampled"
            raise AssertionError(f"{phase} {kind} request {i} did not "
                                 f"reproduce its stream")
    spec = {"gamma": GAMMA, "draft": "self", "requests": len(prompts),
            "new_tokens": stats.total_tokens, "wall_s": wall,
            "tokens_per_s": stats.total_tokens / wall,
            "windows": stats.steps, "slot_windows": stats.spec_windows,
            "accepted_per_window_reading": stats.accepted_per_window,
            "spec_drafted": stats.spec_drafted,
            "spec_accepted": stats.spec_accepted,
            "kernel_launches": launches, "kernel_variants": variants,
            "rerun_identical": True,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del llm
    torch.cuda.empty_cache()

    prompt = np.random.default_rng(9).integers(0, cfg.vocab_size,
                                               LEGACY_PROMPT)
    llm = LLMEngine(model, backend="speculative", device="cuda", gamma=GAMMA,
                    max_len=512)
    sp = SamplingParams(max_tokens=LEGACY_NEW)
    LAUNCHES.clear()
    t0 = time.perf_counter()
    out = llm.generate([prompt], sp)[0]
    torch.cuda.synchronize()
    lwall = time.perf_counter() - t0
    launches = {k: v for k, v in LAUNCHES.items() if v}
    # a window: gamma draft steps + the backfill, gamma + 1 target steps
    steps = 2 * (GAMMA + 1) * out.metrics["windows"]
    # MLA: flash at D 192 / Dv 128 in both prompt prefills, no decode kernel
    want = ({FLASH: 2 * cfg.n_layers} if cfg.mla else
            {FLASH: 2 * cfg.n_layers, DENSE: cfg.n_layers * steps})
    if (out.finish_reason != "length" or len(out.token_ids) != LEGACY_NEW
            or not all(0 <= t < cfg.vocab_size for t in out.token_ids)
            or launches != want):
        raise AssertionError(f"{phase} legacy speculative request: {out}, "
                             f"launches {launches}, want {want}")
    again = llm.generate([prompt], sp)[0]
    if again.token_ids != out.token_ids:
        raise AssertionError(f"{phase} legacy speculative stream did not "
                             f"reproduce")
    del llm
    torch.cuda.empty_cache()
    return {"phase": phase, "continuous": spec,
            "legacy": {"prompt_tokens": LEGACY_PROMPT,
                       "new_tokens": LEGACY_NEW, "wall_s": lwall,
                       "tokens_per_s": LEGACY_NEW / lwall,
                       "windows": out.metrics["windows"],
                       "accepted_per_window_reading":
                           out.metrics["accepted_per_window"],
                       "kernel_launches": launches,
                       "rerun_identical": True}}


def check_mla(torch) -> list[dict]:
    """A narrow 2-layer deepseek-shaped model (1 mla_dense + 1 mla_moe;
    d_model 512, 4 heads at deepseek's head dims (q.k 128 + 64, v 128), 8
    experts, top 2, the capacity path forced), f32, card against CPU
    through ``check_narrow_moe``.  The static and legacy speculative paths
    run the flash kernel's f32 variant at D 192 / Dv 128; the continuous
    paths launch no kernel."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(
        get_config("deepseek-v2-lite-16b"), name="deepseek-narrow",
        n_layers=2, d_model=512, n_heads=4, n_kv_heads=4, head_dim=128,
        rope_head_dim=64, v_head_dim=128, kv_lora_rank=128, d_ff=1024,
        n_experts=8, n_experts_per_token=2, n_shared_experts=1,
        moe_d_ff=256, vocab_size=4000, vocab_pad_multiple=512)
    return check_narrow_moe(torch, "MLA+MoE", cfg, "capacity", seed=6)


def mla_phases() -> dict:
    """The deepseek-v2-lite-16b phases, in their order: continuous (with
    prompt scoring), static, mxfp4 weights over bf16 pools, speculative."""
    return {"serve_mla": lambda t, m: serve_phase(t, m, phase="serve_mla"),
            "serve_mla_static": lambda t, m: serve_static_phase(
                t, m, phase="serve_mla_static"),
            "serve_mla_quantized": lambda t, m: serve_phase(
                t, m, phase="serve_mla_quantized", weight_format="mxfp4"),
            "serve_mla_spec": lambda t, m: serve_moe_spec_phase(
                t, m, phase="serve_mla_spec")}


# ---------------------------------------------------------------------------
# 19-23. llama4 (GQA attention through the port's kernels, MoE in plain
# torch, as the reference computes it outside any Pallas kernel); the
# paper's H100 and RPU models beside the card's steps
# ---------------------------------------------------------------------------

SCOUT = "llama4-scout-109b-a17b"
MAVERICK = "llama4-maverick-400b-a17b"
# depth of llama4-scout's serve phases (widths full): 4 of its 48 layers
# since the stateful phases joined the script (8 before); maverick runs
# one period (attn_dense + attn_moe)
SCOUT_LAYERS, MAVERICK_LAYERS = 4, 2


def build_llama4(torch, name: str, n_layers: int):
    """A llama4 config at full width, its depth cut to ``n_layers``
    (random bf16 weights from a seed, drawn on the card one expert at a
    time)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(get_config(name), n_layers=n_layers)
    t0 = time.monotonic()
    model = Model(cfg, device="cuda").init(seed=0)
    torch.cuda.synchronize()
    print(f"llama4: {cfg.name} {cfg.n_layers} of 48 layers, "
          f"{model.param_count() / 1e9:.2f} B params bf16 "
          f"({torch.cuda.memory_allocated() / 1e9:.2f} GB on the card), "
          f"random init {time.monotonic() - t0:.1f} s")
    return model


def build_scout(torch):
    return build_llama4(torch, SCOUT, SCOUT_LAYERS)


def build_maverick(torch):
    return build_llama4(torch, MAVERICK, MAVERICK_LAYERS)


def moe_phases() -> dict:
    """llama4-scout's phases, in their order: continuous bf16 (with prompt
    scoring), static, mxfp4 attention over fp8 pools, speculative (both
    backends)."""
    return {"serve_moe": lambda t, m: serve_phase(t, m, phase="serve_moe"),
            "serve_moe_static": lambda t, m: serve_static_phase(
                t, m, phase="serve_moe_static"),
            "serve_moe_quantized": lambda t, m: serve_phase(
                t, m, phase="serve_moe_quantized", weight_format="mxfp4",
                cache_dtype="fp8"),
            "serve_moe_spec": lambda t, m: serve_moe_spec_phase(
                t, m, phase="serve_moe_spec")}


def maverick_phases() -> dict:
    """llama4-maverick's one phase: continuous bf16 at one period."""
    return {"serve_moe_maverick": lambda t, m: serve_phase(
        t, m, phase="serve_moe_maverick")}


def serve_late(llm, prompts, reqs, late: int):
    """Requests through the incremental interface, the one at ``late``
    added once request 0 has its first token (so 0's prompt pages are
    indexed and ``late`` can share them).  Returns the finished outputs
    in request order."""
    for i, (p, sp) in enumerate(zip(prompts, reqs)):
        if i != late:
            llm.add_request(p, sp, rid=i)
    done, started, added = {}, False, False
    while llm.has_unfinished() or not added:
        for o in llm.step():
            started = started or (o.rid == 0 and bool(o.new_token_ids))
            if o.finished:
                done[o.rid] = o
        if started and not added:
            llm.add_request(prompts[late], reqs[late], rid=late)
            added = True
    return [done[i] for i in range(len(prompts))]


def check_narrow_moe(torch, label, cfg, impl, seed) -> list[dict]:
    """A narrow f32 MoE model served on the card and on the CPU from the
    same weights: continuous (a request that shares another's prompt
    pages, so the prefix index is hit, and one that scores its prompt),
    static, continuous speculative (self-draft, gamma ``GAMMA``) and the
    legacy speculative backend, greedy.  Each pair of streams must be
    equal or part at a near-tie (``divergences``), the scores within 1e-4.
    GQA layers in f32 run the CUDA-core kernels (the paged decode kernel
    on continuous steps, the exact one on verify steps, flash and dense
    decode on the static and legacy paths); MLA layers launch flash (D 192
    / Dv 128) on the static and legacy paths and nothing else.
    Streams of two backends are not compared: under capacity their MoE
    counts other token batches (the capacity-drop rule)."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.decode_attention.kernel import NAME as DENSE
    from repro_torch.kernels.decode_attention.paged_kernel import (
        NAME, NAME_EXACT,
    )
    from repro_torch.kernels.flash_attention.kernel import NAME as FLASH
    from repro_torch.models.model import Model
    from repro_torch.runtime.llm import LLMEngine
    from repro_torch.runtime.sampling import SamplingParams
    from repro_torch.runtime.speculative import SpeculativeConfig

    cpu = Model(cfg, device="cpu", moe_impl=impl).init(seed=seed).float()
    gpu = Model(cfg, device="cuda", moe_impl=impl).float()
    gpu.load_state_dict(cpu.state_dict())
    f32 = torch.float32
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (70, 40, 19, 100)]
    prompts[3] = np.concatenate([prompts[0][:64], prompts[3][64:]])
    s_prompts = [rng.integers(0, cfg.vocab_size, 48) for _ in range(4)]
    greedy = [SamplingParams(max_tokens=16)] * 4
    scored = [greedy[0], SamplingParams(max_tokens=16, prompt_logprobs=True),
              *greedy[2:]]
    kw = dict(backend="continuous", num_slots=4, page_size=16, max_len=256,
              prefill_chunk=32, cache_dtype=f32)
    gqa = not cfg.mla
    cases = [  # (case, engine options, prompts, requests, kernels)
        ("continuous", kw, prompts, scored, {NAME}),
        ("static", dict(backend="static", max_len=128, cache_dtype=f32),
         s_prompts, greedy, {FLASH, DENSE}),
        ("continuous spec (self-draft)",
         dict(kw, speculative=SpeculativeConfig(gamma=GAMMA)), prompts,
         greedy, {NAME, NAME_EXACT}),
        ("legacy speculative", dict(backend="speculative", gamma=GAMMA,
                                    max_len=128, cache_dtype=f32),
         s_prompts[:2], greedy[:2], {FLASH, DENSE})]
    results = []
    for case, opts, ps, reqs, kernels in cases:
        runs = {}
        for dev, model in (("cuda", gpu), ("cpu", cpu)):
            LAUNCHES.clear()
            llm = LLMEngine(model, device=dev, **opts)
            if opts["backend"] == "continuous":
                outs = serve_late(llm, ps, reqs, late=3)
                hits = llm.stats().prefix_hit_tokens
                if hits < 48:
                    raise AssertionError(f"{label} {case} on {dev}: {hits} "
                                         f"prefix-hit tokens")
            else:
                outs = llm.generate(ps, reqs)
            runs[dev] = (outs, {k: v for k, v in LAUNCHES.items() if v})
        launches = runs["cuda"][1]
        want = kernels if gqa else kernels & {FLASH}
        if set(launches) != want or runs["cpu"][1]:
            raise AssertionError(f"{label} {case}: the card run launched "
                                 f"{launches}, want each of "
                                 f"{sorted(want) or 'none'}; "
                                 f"the CPU run {runs['cpu'][1]}")
        near = divergences(torch, f"{label} {case}, card vs CPU",
                           runs["cuda"][0], runs["cpu"][0], ps, reqs, cpu,
                           f32, True)
        row = {"case": f"{label} ({cfg.n_layers} layers, {impl}) {case} "
                       f"f32, card vs CPU, greedy",
               "identical": not near, "near_ties": near,
               "kernel_launches": launches}
        if reqs is scored:
            plp = [np.asarray(runs[d][0][1].prompt_logprobs)
                   for d in ("cuda", "cpu")]
            row["prompt_logprobs_max_abs_err"] = err = float(
                np.abs(plp[0] - plp[1]).max())
            if not err <= 1e-4:
                raise AssertionError(f"{label} {case}: prompt_logprobs card "
                                     f"vs CPU differ by {err} (tolerance "
                                     f"1e-4)")
        results.append(row)
    del cpu, gpu
    torch.cuda.empty_cache()
    return results


def check_moe(torch) -> dict:
    """Two narrow llama4-shaped models through ``check_narrow_moe``:
    scout's period (every layer ``attn_moe``; 16 experts, top 1, the dense
    MoE path) and maverick's (``attn_dense`` + ``attn_moe`` x 2, 8
    experts, the capacity path forced, so rows compete for capacity and
    what idle rows write to the scratch page could reach them)."""
    from repro_torch.configs import get_config

    narrow = dict(d_model=512, n_heads=10, n_kv_heads=2, head_dim=64,
                  d_ff=1024, moe_d_ff=512, vocab_size=4000,
                  vocab_pad_multiple=512)
    scout = dataclasses.replace(get_config(SCOUT), name="llama4-scout-narrow",
                                n_layers=2, **narrow)
    maverick = dataclasses.replace(
        get_config(MAVERICK), name="llama4-maverick-narrow", n_layers=4,
        n_experts=8, **narrow)
    return {"phase": "check_moe", "near_tie_gap": NEAR_TIE,
            "model": "llama4 widths cut to d_model 512, 10 heads over 2, "
                     "head dim 64, f32",
            "cases": (check_narrow_moe(torch, "scout-narrow", scout, "auto", 7)
                      + check_narrow_moe(torch, "maverick-narrow", maverick,
                                         "capacity", 7))}


# ---------------------------------------------------------------------------
# 24-27. phi3-mini-3.8b (full MHA at head dim 96) and h2o-danube-1.8b
# (GQA at head dim 80, every layer a 4096-token window over ring pages),
# full size
# ---------------------------------------------------------------------------

# danube's continuous mix: two prompts past the window, two that cross it
# while decoding, four short ones (prompt tokens, new tokens)
DANUBE_MIX = ((6144, 64), (6144, 64), (4000, 256), (4000, 256),
              (512, 64), (512, 64), (512, 64), (512, 64))
DANUBE_MAX_LEN = 6400                  # 6144 + 256, a multiple of the page
DANUBE_STATIC = (2, 6144)              # prompts of the static phase
DANUBE_QUANTIZED_REQUESTS = 4


def build_full(torch, name: str, n_layers: int | None = None):
    """A config at full width, every layer or its first ``n_layers``
    (random bf16 weights from a seed)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    cfg = get_config(name)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    t0 = time.monotonic()
    model = Model(cfg, device="cuda").init(seed=0)
    torch.cuda.synchronize()
    print(f"{name}: {cfg.n_layers} layers, {model.param_count() / 1e9:.2f} B "
          f"params bf16 ({torch.cuda.memory_allocated() / 1e9:.2f} GB on the "
          f"card), random init {time.monotonic() - t0:.1f} s")
    return model


# depths of phi3's and danube's phases (full width): a quarter of their
# layers since the stateful phases joined the script at full depth, which
# keeps it near 600 s
PHI3_LAYERS, DANUBE_LAYERS = 8, 6


def build_phi3(torch):
    return build_full(torch, PHI3, PHI3_LAYERS)


def build_danube(torch):
    return build_full(torch, DANUBE, DANUBE_LAYERS)


def danube_requests(sp_cls, vocab: int):
    rng = np.random.default_rng(5)
    prompts, sps = [], []
    for i, (n, new) in enumerate(DANUBE_MIX):
        prompts.append(rng.integers(0, vocab, n))
        sps.append(sp_cls(max_tokens=new) if i % 2 == 0 else
                   sp_cls(max_tokens=new, temperature=0.8, top_p=0.9,
                          top_k=40, seed=3000 + i))
    return prompts, sps


class RingWatch:
    """Reads a ring layout's session after every step (``serve_session``'s
    ``watch``): the ring's invariants hold; the most live ring blocks of
    any decoding slot, the ring pages in use, and the pages the same
    requests would hold in one full space (each running request's written
    positions, page by page), at their peaks; and the pages ``reclaim``
    returned.  ``check()`` holds them (live blocks within
    ``ring_blocks_cap``, a page reclaimed, every page back at the end),
    prints them and returns them with the ring pool's size."""

    def start(self, llm):
        self.eng = llm._eng
        self.cache, self.real = self.eng.cache, self.eng.cache.reclaim
        self.readings = {"most_live_blocks": 0, "most_pages_in_use": 0,
                         "most_pages_without_ring": 0, "pages_reclaimed": 0}

        def counting(slot, pos_next):
            n = self.real(slot, pos_next)
            self.readings["pages_reclaimed"] += n
            return n
        self.cache.reclaim = counting

    def step(self):
        r, space, sched = self.readings, self.cache.ring, self.eng._sched
        space.check()
        r["most_live_blocks"] = max([r["most_live_blocks"]] + [
            space.live_blocks(q.slot) for q in sched.decoding()])
        r["most_pages_in_use"] = max(r["most_pages_in_use"],
                                     space.allocator.num_live)
        r["most_pages_without_ring"] = max(
            r["most_pages_without_ring"],
            sum(-(-q.pos // self.eng.page_size)
                for q in sched.running.values()))

    def stop(self):
        self.cache.reclaim = self.real
        self.readings["pages_left_at_end"] = self.cache.ring.allocator.num_live

    def check(self) -> dict:
        from repro_torch.runtime.state_cache import ring_blocks_cap

        eng, r = self.eng, self.readings
        cap = ring_blocks_cap(eng.model.cfg.sliding_window, eng.page_size)
        if (r["most_live_blocks"] > cap or r["pages_left_at_end"]
                or not r["pages_reclaimed"]):
            raise AssertionError(f"ring readings {r} (decode cap {cap} "
                                 f"blocks a slot; want a page reclaimed and "
                                 f"none left)")
        # the windowed layers' pools are the ring pools (all of danube's)
        page_bytes = sum(leaf.nbytes // leaf.shape[0] for win, pool in
                         zip(eng.model.windows, eng._pools)
                         if win is not None for leaf in pool.values())
        print(f"  ring: pool {eng.ring_pages} pages, most live blocks of a "
              f"slot {r['most_live_blocks']} (cap {cap}), pages in use "
              f"{r['most_pages_in_use']} against "
              f"{r['most_pages_without_ring']} without a ring, reclaimed "
              f"{r['pages_reclaimed']}")
        return {"ring_pool_pages": eng.ring_pages,
                "ring_pool_gb": eng.ring_pages * page_bytes / 1e9,
                "ring_blocks_cap": cap, **r}


def serve_danube_phase(torch, model, phase: str = "serve_danube",
                       n_requests: int = len(DANUBE_MIX),
                       **engine_kw) -> dict:
    """danube's continuous mix (``DANUBE_MIX``, page 16, chunk 256; the
    first ``n_requests``, every one added at once) through ``serve_phase``:
    its layers keep their pages in a ring space (``RingWatch``), the paged
    decode kernel runs once a layer a decode step (tensor cores, window
    4096 over the ring table), and no prompt token hits a prefix index.
    The bf16 phase scores a 6144-token prompt, held against
    ``Model.forward`` (the windowed flash kernel) at every position."""
    def requests(sp_cls, vocab):
        prompts, sps = danube_requests(sp_cls, vocab)
        return prompts[:n_requests], sps[:n_requests]
    return serve_phase(torch, model, phase=phase, requests=requests,
                       max_len=DANUBE_MAX_LEN, late=None,
                       expect_prefix_hit=False, watch=RingWatch(),
                       **engine_kw)


def phi3_phases() -> dict:
    """phi3-mini-3.8b's phases, in their order: continuous bf16 (with prompt
    scoring), static, mxfp4 weights over fp8 pools, speculative (both
    backends)."""
    return {"serve_phi3": lambda t, m: serve_phase(t, m, phase="serve_phi3"),
            "serve_phi3_static": lambda t, m: serve_static_phase(
                t, m, phase="serve_phi3_static"),
            "serve_phi3_quantized": lambda t, m: serve_phase(
                t, m, phase="serve_phi3_quantized", weight_format="mxfp4",
                cache_dtype="fp8"),
            "serve_phi3_spec": lambda t, m: serve_moe_spec_phase(
                t, m, phase="serve_phi3_spec")}


def danube_phases() -> dict:
    """h2o-danube-1.8b's phases, in their order: continuous bf16 (with a
    6144-token scored prompt), static (2 x 6144 prompts: windowed flash
    prefill, decode over the wrapped 4096-entry ring), mxfp4 weights over
    fp8 pools (the mix's first 4 requests)."""
    n, s = DANUBE_STATIC
    return {"serve_danube": serve_danube_phase,
            "serve_danube_static": lambda t, m: serve_static_phase(
                t, m, phase="serve_danube_static", n_prompts=n,
                prompt_len=s, max_len=s + STATIC_NEW),
            "serve_danube_quantized": lambda t, m: serve_danube_phase(
                t, m, phase="serve_danube_quantized",
                n_requests=DANUBE_QUANTIZED_REQUESTS, weight_format="mxfp4",
                cache_dtype="fp8")}


def check_window(torch) -> dict:
    """phi3's and danube's attention at their head dims, card against CPU
    in f32, on narrow models (2 layers; phi3: H = KVH = 4, D 96; danube:
    H 8, KVH 2, D 80, window 64, prompts past it): the continuous engine
    (greedy and sampled), the static engine, and static against
    continuous on the card, greedy.  f32 runs the kernels' CUDA-core
    variants (the flash kernel's FMA one) at D 80 and 96; a greedy stream
    may part at a near-tie only."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models.model import Model
    from repro_torch.runtime.llm import LLMEngine
    from repro_torch.runtime.sampling import SamplingParams

    f32 = torch.float32
    narrow = {PHI3: dict(n_layers=2, d_model=384, n_heads=4, n_kv_heads=4,
                         d_ff=768, vocab_size=4000, vocab_pad_multiple=512),
              DANUBE: dict(n_layers=2, d_model=640, n_heads=8, n_kv_heads=2,
                           d_ff=1024, vocab_size=4000, vocab_pad_multiple=512,
                           sliding_window=64)}
    results = []
    for name, kw in narrow.items():
        cfg = dataclasses.replace(get_config(name), name=f"{name}-narrow",
                                  **kw)
        cpu = Model(cfg, device="cpu").init(seed=6).float()
        gpu = Model(cfg, device="cuda").float()
        gpu.load_state_dict(cpu.state_dict())
        rng = np.random.default_rng(3)
        prompts = [rng.integers(0, cfg.vocab_size, n) for n in (90, 150, 33,
                                                                 120)]
        sps = [SamplingParams(max_tokens=24),
               SamplingParams(max_tokens=24, temperature=0.9, top_k=20,
                              seed=4),
               SamplingParams(max_tokens=24),
               SamplingParams(max_tokens=24, temperature=0.7, top_p=0.9,
                              seed=8)]
        greedy = [SamplingParams(max_tokens=24)] * len(prompts)
        cont = dict(backend="continuous", num_slots=4, page_size=16,
                    max_len=256, prefill_chunk=32, cache_dtype=f32)
        LAUNCHES.clear()
        on_gpu = LLMEngine(gpu, device="cuda", **cont).generate(prompts, sps)
        launches = {k: v for k, v in LAUNCHES.items() if v}
        on_cpu = LLMEngine(cpu, device="cpu", **cont).generate(prompts, sps)
        near = divergences(torch, f"{name} continuous f32", on_gpu, on_cpu,
                           prompts, sps, cpu, f32, True)
        results.append({"case": f"{name} continuous f32, card vs CPU",
                        "identical": not near, "near_ties": near,
                        "kernel_launches": launches})
        s_prompts = [rng.integers(0, cfg.vocab_size, 100) for _ in range(3)]
        static = dict(backend="static", max_len=160, cache_dtype=f32)
        LAUNCHES.clear()
        st_gpu = LLMEngine(gpu, device="cuda", **static).generate(
            s_prompts, sps[:3])
        launches = {k: v for k, v in LAUNCHES.items() if v}
        st_cpu = LLMEngine(cpu, device="cpu", **static).generate(
            s_prompts, sps[:3])
        near = divergences(torch, f"{name} static f32", st_gpu, st_cpu,
                           s_prompts, sps[:3], cpu, f32, True)
        results.append({"case": f"{name} static f32, card vs CPU",
                        "identical": not near, "near_ties": near,
                        "kernel_launches": launches})
        st_greedy = LLMEngine(gpu, device="cuda", **static).generate(
            s_prompts, greedy[:3])
        cont_greedy = LLMEngine(gpu, device="cuda", **cont).generate(
            s_prompts, greedy[:3])
        near = divergences(torch, f"{name} static vs continuous, card",
                           st_greedy, cont_greedy, s_prompts, greedy[:3], cpu,
                           f32, True)
        results.append({"case": f"{name} static vs continuous f32, card, "
                        "greedy", "identical": not near, "near_ties": near})
        del cpu, gpu
        torch.cuda.empty_cache()
    return {"phase": "check_window", "cases": results}


# ---------------------------------------------------------------------------
# stateful layouts: mamba2-370m (SSM blocks only) and hymba-1.5b (attention
# and SSM heads side by side in every layer)
# ---------------------------------------------------------------------------

MAMBA2, HYMBA = "mamba2-370m", "hymba-1.5b"
HYMBA_GEOM = (25, 5, 64, 16)       # H, KVH, D, page: GQA rep 5
HYMBA_WINDOW = 1024
# hymba's MXFP4 launches (K, Ns): q/k/v grouped, o, gate/up grouped, down
HYMBA_LAUNCHES = {"qkv": (1600, (1600, 320, 320)), "wo": (1600, (1600,)),
                  "gate/up": (1600, (5504, 5504)), "w_down": (5504, (1600,))}
# (prompt, new tokens): two of 3072 and two of 1500, past the window, whose
# rings wrap while they decode, four of 512 (5 and 7 share a 384-token
# prefix); the second, 3072 tokens, is the scored one
HYMBA_MIX = ((1500, 256), (3072, 256), (3072, 256), (1500, 256),
             (512, 64), (512, 64), (512, 64), (512, 64))
HYMBA_SHARED = (5, 7)
HYMBA_PREFIX = 384
HYMBA_MAX_LEN = 3072 + 256
HYMBA_STATIC = (2, 3072)           # prompts of the static phase


# the stateful serve phases' depths: their continuous phases are
# host-bound (~2 ms a layer a decode step for mamba2, ~4 for hymba), so
# they were cut when the training and dryrun phases joined the script
# (the dryrun phase runs both models at full depth): mamba2 24 of 48,
# hymba 8 of 32 (global at layers 0 and 7, a 1024-token window on the
# other 6)
MAMBA2_LAYERS, HYMBA_LAYERS = 24, 8


def build_mamba2(torch):
    return build_full(torch, MAMBA2, MAMBA2_LAYERS)


def build_hymba(torch):
    return build_full(torch, HYMBA, HYMBA_LAYERS)


def hymba_requests(sp_cls, vocab: int):
    rng = np.random.default_rng(9)
    prefix = rng.integers(0, vocab, HYMBA_PREFIX)
    prompts, sps = [], []
    for i, (n, new) in enumerate(HYMBA_MIX):
        if i in HYMBA_SHARED:
            prompts.append(np.concatenate(
                [prefix, rng.integers(0, vocab, n - HYMBA_PREFIX)]))
        else:
            prompts.append(rng.integers(0, vocab, n))
        sps.append(sp_cls(max_tokens=new) if i % 2 == 0 else
                   sp_cls(max_tokens=new, temperature=0.8, top_p=0.9,
                          top_k=40, seed=4000 + i))
    return prompts, sps


def serve_hymba_phase(torch, model, phase: str = "serve_hymba",
                      **engine_kw) -> dict:
    """hymba's continuous mix (``HYMBA_MIX``, page 16, chunk 256) through
    ``serve_phase``: its windowed layers keep their pages in a ring
    space (``RingWatch``), its global layers in the full space, where
    request 7 shares request 5's 384-token prefix for capacity while its
    prompt is recomputed (``recompute_shared``); every layer's SSM state
    sits in the per-slot pools; the paged decode kernel runs once a layer
    a decode step (tensor cores, D 64, rep 5; window 1024 over the ring
    table on the windowed layers).  The bf16 phase scores a 3072-token
    prompt against ``Model.forward``."""
    return serve_phase(torch, model, phase=phase, requests=hymba_requests,
                       max_len=HYMBA_MAX_LEN, late=HYMBA_SHARED,
                       watch=RingWatch(), min_prefix_hit=HYMBA_PREFIX - PAGE,
                       **engine_kw)


def mamba2_phases() -> dict:
    """mamba2-370m's phases: continuous bf16 on the serve phase's mix (no
    prefix hit: a pure-state model has no full space; a scored prompt),
    static 8 x 1024.  No kernel runs on either path: the reference
    computes the SSD mixer in plain jnp, the port in plain torch."""
    return {"serve_mamba2": lambda t, m: serve_phase(
                t, m, phase="serve_mamba2", expect_prefix_hit=False),
            "serve_mamba2_static": lambda t, m: serve_static_phase(
                t, m, phase="serve_mamba2_static")}


def hymba_phases() -> dict:
    """hymba-1.5b's phases: continuous bf16 (``serve_hymba_phase``),
    static 2 x 3072 (windowed flash prefill, dense decode over the wrapped
    1024-entry ring on the windowed layers), and the continuous mix with
    mxfp4 attention and MLP projections over bf16 pools (the SSM mixer
    stays bf16; a quantized cache is refused for stateful models)."""
    n, s = HYMBA_STATIC
    return {"serve_hymba": serve_hymba_phase,
            "serve_hymba_static": lambda t, m: serve_static_phase(
                t, m, phase="serve_hymba_static", n_prompts=n,
                prompt_len=s, max_len=s + STATIC_NEW),
            "serve_hymba_quantized": lambda t, m: serve_hymba_phase(
                t, m, phase="serve_hymba_quantized", weight_format="mxfp4")}


def kernel_hymba_phase(torch) -> dict:
    """The kernels on hymba's path at its shapes (D 64, 25 heads over 5:
    rep 5): flash with the 1024-token window (and without, for its global
    layers), dense decode over a wrapped 1024-entry ring and over a
    ragged full cache, the paged online kernel over bf16 and f32 pools
    with and without a ring table (blocks behind the window on the
    poisoned scratch page), held against the plain versions at the
    tolerances of ``kernel_headdims``; ``mxfp4_vmm`` at hymba's four
    launches for M 1, 8 and 2048 (K 1600 is 12.5 of the decode schedule's
    128-row K stages).  Each is timed at hymba's serve shapes beside its
    bound, its plain version and the library call.  Returns one kernels
    line entry each (``launches`` set from hymba's serve phases)."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import kernel as dense_kernel
    from repro_torch.kernels.decode_attention import paged_kernel
    from repro_torch.kernels.decode_attention.ref import (
        gather_pages, paged_decode_attention_ref, paged_valid_mask,
    )
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention.ops import gqa_flash_attention
    from repro_torch.kernels.mxfp4_vmm import kernel as vmm_kernel
    from repro_torch.kernels.mxfp4_vmm.ref import mxfp4_vmm_ref
    from repro_torch.models.common import decode_attention_ref
    from repro_torch.quant import formats

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(29)
    rng = np.random.default_rng(29)
    h, kvh, d, page = HYMBA_GEOM
    holds = KernelHolds(torch)
    hold, entry, worst = holds.hold, holds.entry, holds.worst

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        for B, S, window in ((2, 3072, HYMBA_WINDOW), (1, 1000, None),
                             (2, 700, 100)):
            for causal in (True, False):
                q, k, v = randn(B, S, h, d, dtype=dt), \
                    randn(B, S, kvh, d, dtype=dt), randn(B, S, kvh, d, dtype=dt)
                kind = flash_kernel.variant(dt, d, h // kvh)
                hold("flash_attention", f"{kind} {dtype_name} B={B} S={S} "
                     f"H={h} KVH={kvh} D={d} causal={causal} window={window}",
                     flash_kernel.flash_attention(q, k, v, causal=causal,
                                                  window=window),
                     gqa_flash_attention(q, k, v, causal=causal,
                                         window=window, impl="reference"),
                     bf16_rel=True)
                del q, k, v
        for B, S, full in ((2, HYMBA_WINDOW, True), (8, 3200, False)):
            cur_len = (np.full(B, S) if full
                       else rng.integers(1, S + 1, B))
            cur_len[0] = S
            q, k, v, cl = dense_case(torch, gen, B, S, dt, cur_len, dev, h,
                                     kvh, d)
            kind = dense_kernel.variant(q.dtype, k.dtype, d)
            hold("decode_attention", f"{kind} {dtype_name} B={B} S={S} "
                 f"H={h} KVH={kvh} D={d}"
                 + (" (a wrapped ring)" if full else " ragged"),
                 dense_kernel.decode_attention(q, k, v, cl),
                 decode_attention_ref(q, k, v, cl))
        for B, window, ring in ((8, None, False), (8, HYMBA_WINDOW, True),
                                (8, HYMBA_WINDOW, False)):
            n_blocks = HYMBA_MAX_LEN // page
            pos = rng.integers(0, HYMBA_MAX_LEN, B)
            pos[0] = page + page // 2
            pos[1] = HYMBA_MAX_LEN - 1
            q, kp, vp, table, p = paged_case(torch, rng, B, n_blocks, dt, pos,
                                             dev, HYMBA_GEOM)
            if ring:
                table = torch.as_tensor(ring_table(table.cpu().numpy(), pos,
                                                   window, page), device=dev)
            kind = paged_kernel.variant(q.dtype, kp.dtype, d, page)
            hold(paged_kernel.NAME, f"{kind} {dtype_name} pools B={B} H, KVH, "
                 f"D, page={HYMBA_GEOM} window={window}"
                 f"{' ring table' if ring else ''}",
                 paged_kernel.paged_decode_attention(q, kp, vp, table, p,
                                                     window=window),
                 paged_decode_attention_ref(q, kp, vp, table, p,
                                            window=window))
            del q, kp, vp

    vmm_err = 0.0
    weights = {}

    def weight(k, n):
        if (k, n) not in weights:
            w = torch.randn((k, n), generator=gen, device=dev) * 0.02
            weights[(k, n)] = formats.quantize_mxfp4(w.to(torch.bfloat16))
        return weights[(k, n)]

    for k, ns in HYMBA_LAUNCHES.values():
        for m in (1, 8, 2048):
            ws = [(weight(k, n).codes, weight(k, n).scales) for n in ns]
            err, sched, _ = hold_vmm(torch, randn(m, k), ws)
            vmm_err = max(vmm_err, err)
            print(f"  mxfp4_vmm vs plain: M={m} K={k} N={list(ns)} ({sched}): "
                  f"max rel err {err:.3g} (tolerance {VMM_TOL})")

    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=dev)
    entries = []

    B, S = HYMBA_STATIC
    q, k, v = randn(B, S, h, d), randn(B, S, kvh, d), randn(B, S, kvh, d)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    i = torch.arange(S, device=dev)
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - HYMBA_WINDOW)
    for window, lib, library in (
            (HYMBA_WINDOW, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True),
             "F.scaled_dot_product_attention(attn_mask=<causal window "
             "mask>, enable_gqa=True)"),
            (None, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True),
             "F.scaled_dot_product_attention(is_causal=True, "
             "enable_gqa=True)")):
        row = {"ms": time_ms(torch, lambda: flash_kernel.flash_attention(
                   q, k, v, causal=True, window=window), flush),
               "plain_ms": time_ms(torch, lambda: gqa_flash_attention(
                   q, k, v, causal=True, window=window, impl="reference"),
                   flush, iters=5),
               "library_ms": time_ms(torch, lib, flush)}
        row["bound_ms"], row["bound_by"] = flash_bound(
            B, S, S, h, kvh, True, 2, "bfloat16", d=d, window=window)
        name = ("flash_attention:D64:rep5"
                + (f":window{window}" if window else ""))
        print(f"  timing {name}:", json.dumps(ratios(row)))
        entries.append(entry(name, FLASH_SOURCE, FLASH_REPLACES, row,
                             f"hymba prefill: B {B}, S {S}, H 25, KVH 5, D 64,"
                             f" causal, window {window} ("
                             + ("its windowed layers" if window
                                else "its global layers") + ")",
                             variant=flash_kernel.variant(q.dtype, d, h // kvh),
                             library=library))
    del q, k, v, qt, kt, vt, mask

    for name, (B, S, ctx, label) in (
            ("decode_attention:D64:rep5:ring1024",
             (2, HYMBA_WINDOW, HYMBA_WINDOW,
              "hymba static decode, windowed layer: B 2, rep 5, a wrapped "
              "1024-entry ring (cur_len 1024)")),
            ("decode_attention:D64:rep5",
             (2, HYMBA_STATIC[1] + STATIC_NEW, HYMBA_STATIC[1] + 32,
              "hymba static decode, global layer: B 2, rep 5, cur_len 3104 "
              "of 3136"))):
        cur_len = np.full(B, ctx)
        q, k, v, cl = dense_case(torch, gen, B, S, torch.bfloat16, cur_len,
                                 dev, h, kvh, d)
        q4, ks_, vs_ = q[:, :, None, :], k[:, :ctx].transpose(1, 2), \
            v[:, :ctx].transpose(1, 2)
        row = {"ms": time_ms(torch, lambda: dense_kernel.decode_attention(
                   q, k, v, cl), flush),
               "plain_ms": time_ms(torch, lambda: decode_attention_ref(
                   q, k, v, cl), flush),
               "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                   q4, ks_, vs_, enable_gqa=True), flush)}
        row["bound_ms"], row["bound_by"] = dense_bound(cur_len, B, 2,
                                                       "bfloat16", h, kvh, d)
        print(f"  timing {name}:", json.dumps(ratios(row)))
        entries.append(entry(name, DENSE_SOURCE, DENSE_REPLACES, row, label,
                             variant=dense_kernel.variant(q.dtype, k.dtype, d),
                             library="F.scaled_dot_product_attention("
                                     "enable_gqa=True) on the cache sliced "
                                     "to cur_len"))
        del q, k, v, ks_, vs_

    for name, (window, ctx, label) in (
            ("paged_decode_attention:D64:rep5:window1024",
             (HYMBA_WINDOW, 3072, "hymba decode, windowed layer: B 8, rep "
              "5, ctx 3072, window 1024 over the ring table")),
            ("paged_decode_attention:D64:rep5",
             (None, 3072, "hymba decode, global layer: B 8, rep 5, ctx "
              "3072"))):
        B = 8
        pos = np.full(B, ctx - 1)
        q, kp, vp, table, p = paged_case(torch, rng, B, ctx // page,
                                         torch.bfloat16, pos, dev, HYMBA_GEOM)
        if window is not None:
            table = torch.as_tensor(ring_table(table.cpu().numpy(), pos,
                                               window, page), device=dev)
        k_d, v_d = gather_pages(kp, table), gather_pages(vp, table)
        mask = paged_valid_mask(table, page, p, window=window)[:, None, None, :]
        sd = sdpa_ms(torch, F, q, k_d.transpose(1, 2), v_d.transpose(1, 2),
                     mask, flush)
        row = {"ms": time_ms(torch, lambda: paged_kernel.paged_decode_attention(
                   q, kp, vp, table, p, window=window), flush),
               "plain_ms": time_ms(torch, lambda: paged_decode_attention_ref(
                   q, kp, vp, table, p, window=window), flush),
               "library_ms": min(sd.values())}
        row["bound_ms"], row["bound_by"] = paged_bound(
            pos, window, B, "bfloat16", 2, geom=HYMBA_GEOM)
        print(f"  timing {name}:", json.dumps(ratios(row)))
        entries.append(entry(
            name, KERNEL_SOURCE, REPLACES, row, label,
            variant=paged_kernel.variant(q.dtype, kp.dtype, d, page),
            library="the faster of SDPA(enable_gqa=True) and SDPA on K/V "
                    "repeated to H heads, on the gathered view"))
        del q, kp, vp, k_d, v_d

    per_m = {}
    for m in (8, 2048):
        ms = plain = lib = bnd = 0.0
        for k, ns in HYMBA_LAUNCHES.values():
            ps = [weight(k, n) for n in ns]
            ws = [(w.codes, w.scales) for w in ps]
            x = randn(m, k)
            ms += time_ms(torch, lambda: vmm_kernel.mxfp4_vmm_group(
                x, ws, torch.bfloat16), flush)
            plain += sum(time_ms(torch, lambda w=w: mxfp4_vmm_ref(
                x, w.codes, w.scales).to(torch.bfloat16), flush, iters=10)
                for w in ps)
            dq = [formats.dequantize_mxfp4(w, torch.bfloat16) for w in ps]
            lib += sum(time_ms(torch, lambda w=w: torch.matmul(x, w), flush)
                       for w in dq)
            bnd += vmm_bound(m, k, ns)[0]
            del dq
        per_m[m] = {"ms": ms, "plain_ms": plain, "bf16_matmul_ms": lib,
                    "bound_ms": bnd}
        print(f"  timing mxfp4_vmm:hymba layer M {m}:", json.dumps(per_m[m]))
    head = per_m[8]
    entries.append({
        "name": "mxfp4_vmm:hymba", "route": "cuda", "source": VMM_SOURCE,
        "replaces": VMM_REPLACES, "launches": None, "max_abs_err": vmm_err,
        "max_abs_err_is": "relative to max |out|",
        "headline": "one hymba layer at M 8 in the serve path's 4 launches "
                    "(q/k/v grouped at K 1600, o, gate/up grouped, down)",
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "bf16_matmul_ms": head["bf16_matmul_ms"],
        "layer_m2048": per_m[2048]})
    del flush, weights
    return {"phase": "kernel_hymba", "checked": len(holds.checked),
            "worst": worst,
            "mxfp4_vmm_max_rel_err": vmm_err, "entries": entries}


def drive_preempting(llm, prompts, sps, preempt_at: int = 6):
    """Serve through the incremental interface; at iteration
    ``preempt_at`` the decoding request with the lowest rid is preempted
    (its restart zeroes its state rows inside its first chunk).  Returns
    the finished outputs in rid order, the preemptions, and the
    iterations in which some slots prefilled while others decoded (the
    decode step's ``state_ok`` then commits only the decoding ones)."""
    for i, (p, sp) in enumerate(zip(prompts, sps)):
        llm.add_request(p, sp, rid=i)
    eng = llm._eng
    done, it, mixed, preempted = {}, 0, 0, False
    while llm.has_unfinished():
        it += 1
        dec = sorted(eng._sched.decoding(), key=lambda r: r.rid)
        if it >= preempt_at and not preempted and dec:
            eng._sched.preempt(dec[0])
            preempted = True
        mixed += bool(eng._sched.prefilling() and eng._sched.decoding())
        for o in llm.step():
            if o.finished:
                done[o.rid] = o
    return ([done[i] for i in range(len(prompts))],
            llm.stats().preemptions, mixed)


def check_state(torch) -> dict:
    """Narrow mamba2- and hymba-shaped models (2 and 3 layers; hymba
    global, windowed (64 tokens), global, 5 query heads over 1 at D 64),
    f32, card against CPU: the continuous engine (greedy and sampled, 4
    slots for 6 requests, chunk 32, prompts past the window) with one
    request preempted mid-decode and iterations that mix prefilling and
    decoding slots, and the static engine; a greedy stream may part at a
    near-tie only.  f32 runs the attention kernels' CUDA-core variants;
    the SSM mixer is plain torch on both devices."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models.model import Model
    from repro_torch.runtime.llm import LLMEngine
    from repro_torch.runtime.sampling import SamplingParams

    f32 = torch.float32
    narrow = {MAMBA2: dict(n_layers=2, d_model=256, vocab_size=4000,
                           vocab_pad_multiple=512, ssm_state=64,
                           ssm_chunk=64),
              HYMBA: dict(n_layers=3, global_attn_every=3, d_model=320,
                          n_heads=5, n_kv_heads=1, head_dim=64, d_ff=640,
                          vocab_size=4000, vocab_pad_multiple=512,
                          sliding_window=64, ssm_chunk=64)}
    results = []
    for name, kw in narrow.items():
        cfg = dataclasses.replace(get_config(name), name=f"{name}-narrow",
                                  **kw)
        cpu = Model(cfg, device="cpu").init(seed=8).float()
        gpu = Model(cfg, device="cuda").float()
        gpu.load_state_dict(cpu.state_dict())
        rng = np.random.default_rng(4)
        prompts = [rng.integers(0, cfg.vocab_size, n)
                   for n in (90, 150, 33, 120, 70, 45)]
        sps = [SamplingParams(max_tokens=24) if i % 2 == 0 else
               SamplingParams(max_tokens=24, temperature=0.9, top_k=20,
                              seed=40 + i) for i in range(len(prompts))]
        cont = dict(backend="continuous", num_slots=4, page_size=16,
                    max_len=256, prefill_chunk=32, cache_dtype=f32)
        LAUNCHES.clear()
        on_gpu, pre_gpu, mixed = drive_preempting(
            LLMEngine(gpu, device="cuda", **cont), prompts, sps)
        launches = {k: v for k, v in LAUNCHES.items() if v}
        on_cpu, pre_cpu, _ = drive_preempting(
            LLMEngine(cpu, device="cpu", **cont), prompts, sps)
        if not (pre_gpu and pre_cpu and mixed):
            raise AssertionError(f"check_state {name}: preemptions "
                                 f"{pre_gpu}/{pre_cpu}, mixed iterations "
                                 f"{mixed}: the case did not happen")
        near = divergences(torch, f"{name} continuous f32", on_gpu, on_cpu,
                           prompts, sps, cpu, f32, True)
        results.append({"case": f"{name} continuous f32, card vs CPU, a "
                        "forced preemption", "identical": not near,
                        "near_ties": near, "preemptions": pre_gpu,
                        "mixed_iterations": mixed,
                        "kernel_launches": launches})
        s_prompts = [rng.integers(0, cfg.vocab_size, 100) for _ in range(3)]
        static = dict(backend="static", max_len=160, cache_dtype=f32)
        LAUNCHES.clear()
        st_gpu = LLMEngine(gpu, device="cuda", **static).generate(
            s_prompts, sps[:3])
        launches = {k: v for k, v in LAUNCHES.items() if v}
        st_cpu = LLMEngine(cpu, device="cpu", **static).generate(
            s_prompts, sps[:3])
        near = divergences(torch, f"{name} static f32", st_gpu, st_cpu,
                           s_prompts, sps[:3], cpu, f32, True)
        results.append({"case": f"{name} static f32, card vs CPU",
                        "identical": not near, "near_ties": near,
                        "kernel_launches": launches})
        del cpu, gpu
        torch.cuda.empty_cache()
    return {"phase": "check_state", "cases": results}


SIM_LABEL = "modeled (paper's H100 and RPU models), not measured"


def sim_phase(torch, served) -> dict:
    """The paper's H100 decode model (``sim.gpu_model.gpu_decode_latency``)
    beside each serve phase's measured decode step: the config as served
    (its cut depth), 1 GPU, batch 8, the phase's mean decode context, bf16
    (16 bits) or MXFP4 (4.25) weights and bf16 (16) or fp8 (8) KV; one
    line a phase with the measured wall and device-busy steps and their
    ratios to the model.  Speculative windows are left out: the model has
    no window.  Then ``iso_tdp_comparison`` for llama3-405b (the paper's
    headline) and llama4-scout, full size, printed as modeled.  Host only;
    no constant of the models is changed."""
    from repro_torch.configs import get_config
    from repro_torch.sim.gpu_model import GPUSystemConfig, gpu_decode_latency
    from repro_torch.sim.scaling import iso_tdp_comparison

    rows = []
    for name, cfg, r in served:
        if "profiled_decode_steps" in r:              # continuous / static
            # None where the profiler saw no device time
            busy = r["profiled_decode_steps"].get("device_busy_ms_per_step")
            static = "decode_step_ms" in r
            step = (r["decode_step_ms"] if static
                    else r["profiled_decode_steps"]["step_ms"])
            ctx = r.get("sim_context", float(np.mean(PROMPT_LENS)) + 32)
            batch = r.get("sim_batch", 8)
            wfmt, cache = r.get("weight_format"), r.get("cache_dtype")
        elif name == "serve_spec_draft":              # its plain engine
            busy, step = r["device_busy_ms_per_step"], r["step_ms_measured"]
            ctx, wfmt, cache = DRAFT_PROMPT + DRAFT_NEW / 2, None, None
            batch = 8
        else:
            continue
        gpu = GPUSystemConfig(n_gpus=1,
                              weight_bits=4.25 if wfmt == "mxfp4" else 16.0,
                              kv_bits=8.0 if cache in ("fp8", "int8") else 16.0)
        g = gpu_decode_latency(cfg, gpu, batch=batch,
                               seq_len=int(round(ctx)))
        row = {"phase": name, "model": cfg.name, "layers": cfg.n_layers,
               "batch": batch, "context": ctx, "weight_bits": gpu.weight_bits,
               "kv_bits": gpu.kv_bits, "measured_step_ms": step,
               "measured_busy_ms": busy, "modeled_ms": 1e3 * g.total_s,
               "modeled_mem_ms": 1e3 * g.mem_s,
               "modeled_overhead_ms": 1e3 * g.overhead_s,
               "modeled_bw_utilization": g.bw_utilization,
               "step_over_modeled": step / (1e3 * g.total_s),
               "busy_over_modeled": (None if busy is None
                                     else busy / (1e3 * g.total_s))}
        print("  sim:", json.dumps(row))
        rows.append(row)
    iso = {}
    for arch in ("llama3-405b", SCOUT):
        iso[arch] = iso_tdp_comparison(get_config(arch), batch=1,
                                       seq_len=8192)
        print("  sim:", SIM_LABEL, json.dumps(iso[arch]))
    if not rows or not all(math.isfinite(x["modeled_ms"]) for x in rows):
        raise AssertionError(f"sim: no serve phase to compare ({rows})")
    return {"phase": "sim", "serve_phases": rows,
            "iso_tdp_comparison": {"label": SIM_LABEL, **iso}}


# ---------------------------------------------------------------------------
# training and the modality frontends: hubert-xlarge (an audio encoder:
# non-causal attention at D 80, H = KVH = 16) trains at full size;
# internvl2-26b (256 image embeddings ahead of the text, 48 query heads
# over 8: rep 6) serves image prompts; h2o-danube-1.8b trains through the
# fault-tolerant loop and the launcher
# ---------------------------------------------------------------------------

HUBERT, INTERNVL2 = "hubert-xlarge", "internvl2-26b"
HUBERT_FRAMES = 1500          # a 30 s clip at 50 frames/s
HUBERT_GEOM = (16, 16, 80)    # H, KVH, D
VLM_GEOM = (48, 8, 128)       # H, KVH, D: rep 6
VLM_LAYERS = 8                # of internvl2's 48, full width (~4.4 B params)
VLM_BATCH, VLM_TEXT, VLM_NEW, VLM_MAX_LEN = 4, 768, 64, 2048
TRAIN_BATCH = 4
HUBERT_TRAIN_FRAMES, HUBERT_TRAIN_STEPS = 1024, 4
# the loop phase: danube at full width and 2 of its 24 layers (~0.30 B
# params; a checkpoint of weights and f32 moments is ~3 GB; 4 layers
# until the dryrun phase joined the script)
TRAIN_LAYERS, TRAIN_SEQ = 2, 2048
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT, TRAIN_RESUME_TO = 12, 5, 8, 14
# the launcher on the card: danube's reduced config (training runs no
# kernel, so head dim 16 trains on the card), 20 steps
TRAIN_CLI = ["--arch", "h2o-danube-1.8b", "--steps", "20", "--batch", "4",
             "--seq", "256", "--ckpt-every", "10", "--device", "cuda"]
# the no-grad forward (flash) against the plain path: the relative L2
# error of all logits (the real vocabulary's columns).  48 bf16 layers of
# random weights, each rounding its attention output in another order,
# grow a last-bit difference with depth.  A second limit: flash's error
# against an f32 plain forward of the same weights is at most
# FORWARD_F32_RATIO times the bf16 plain path's.  Each run shows the hold
# can see a fault: the forward with each wrong attention of HUBERT_FAULTS
# must fail one of the two
FORWARD_REL_TOL = 2.0 ** -4
FORWARD_F32_RATIO = 2.0
HUBERT_HOLD_DEPTHS = (1, 6, 24, 48)
# the faults: a causal mask on the encoder, and the keys of the ragged
# tail past the last 64-frame block (1500 = 23 x 64 + 28) dropped
HUBERT_FAULTS = ("causal_mask", "tail_dropped")
# bf16 TFLOP/s of the card, dense (the model-FLOPs share's denominator)
PEAK_BF16 = PEAK_OPS_PER_S["bfloat16"]


def kernel_frontends_phase(torch) -> dict:
    """The two kernels on the frontends' paths at their shapes, held
    against the plain versions at the tolerances of ``KernelHolds`` (bf16
    and f32): flash non-causal at hubert's (B 4, S 1500, H = KVH = 16, D
    80; causal too) and causal at internvl2's static prefill (B 4, S 1024
    = 256 image + 768 text positions, H 48, KVH 8, D 128: rep 6; a ragged
    non-causal S 1000), and the dense decode at internvl2's decode (B 8,
    1088 of 2048, rep 6; ragged cur_len too).  Each timed at its shape
    beside its bound, its plain version and SDPA.  Returns one kernels
    line entry each (``launches`` set from train_hubert's no-grad forward
    and serve_vlm)."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import kernel as dense_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention.ops import gqa_flash_attention
    from repro_torch.models.common import decode_attention_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)
    rng = np.random.default_rng(31)
    holds = KernelHolds(torch)
    hold, entry = holds.hold, holds.entry
    hh, hkvh, hd = HUBERT_GEOM
    vh, vkvh, vd = VLM_GEOM
    s_vlm = VLM_TEXT + 256

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    flash_cases = [("hubert", 4, HUBERT_FRAMES, hh, hkvh, hd, False),
                   ("hubert", 4, HUBERT_FRAMES, hh, hkvh, hd, True),
                   ("internvl2", 4, s_vlm, vh, vkvh, vd, True),
                   ("internvl2", 2, 1000, vh, vkvh, vd, False)]
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        for label, B, S, h, kvh, d, causal in flash_cases:
            if dt == torch.float32:          # the fma variant: a short case
                B, S = 1, 600
            q, k, v = (randn(B, S, h, d, dtype=dt), randn(B, S, kvh, d, dtype=dt),
                       randn(B, S, kvh, d, dtype=dt))
            kind = flash_kernel.variant(dt, d, h // kvh)
            hold("flash_attention", f"{kind} {dtype_name} {label} B={B} S={S} "
                 f"H={h} KVH={kvh} D={d} causal={causal}",
                 flash_kernel.flash_attention(q, k, v, causal=causal),
                 gqa_flash_attention(q, k, v, causal=causal, impl="reference"),
                 bf16_rel=True)
            del q, k, v
        for B, S, cur_len in ((8, VLM_MAX_LEN, np.full(8, 1088)),
                              (8, VLM_MAX_LEN, rng.integers(1, VLM_MAX_LEN + 1, 8)),
                              (1, 1088, np.array([1088]))):
            q, k, v, cl = dense_case(torch, gen, B, S, dt, cur_len, dev, vh,
                                     vkvh, vd)
            kind = dense_kernel.variant(q.dtype, k.dtype, vd)
            hold("decode_attention", f"{kind} {dtype_name} internvl2 B={B} "
                 f"S={S} H={vh} KVH={vkvh} D={vd} cur_len "
                 f"{cur_len.tolist()[:4]}",
                 dense_kernel.decode_attention(q, k, v, cl),
                 decode_attention_ref(q, k, v, cl))
            del q, k, v

    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=dev)
    entries = []
    for name, (label, B, S, h, kvh, d, causal) in (
            ("flash_attention:D80:noncausal", flash_cases[0]),
            ("flash_attention:rep6", flash_cases[2])):
        q, k, v = randn(B, S, h, d), randn(B, S, kvh, d), randn(B, S, kvh, d)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        row = {"ms": time_ms(torch, lambda: flash_kernel.flash_attention(
                   q, k, v, causal=causal), flush),
               "plain_ms": time_ms(torch, lambda: gqa_flash_attention(
                   q, k, v, causal=causal, impl="reference"), flush, iters=5),
               "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=causal, enable_gqa=True), flush)}
        row["bound_ms"], row["bound_by"] = flash_bound(
            B, S, S, h, kvh, causal, 2, "bfloat16", d=d)
        print(f"  timing {name}:", json.dumps(ratios(row)))
        what = ("hubert's no-grad forward: B 4, S 1500 frames, H = KVH = 16, "
                "D 80, non-causal" if label == "hubert" else
                "internvl2's static prefill: B 4, S 1024 (256 image + 768 "
                "text), H 48, KVH 8 (rep 6), D 128, causal")
        entries.append(entry(name, FLASH_SOURCE, FLASH_REPLACES, row, what,
                             variant=flash_kernel.variant(q.dtype, d, h // kvh),
                             library=f"F.scaled_dot_product_attention("
                                     f"is_causal={causal}, enable_gqa=True)"))
        del q, k, v, qt, kt, vt
    B, S, ctx = 8, VLM_MAX_LEN, 1088
    cur_len = np.full(B, ctx)
    q, k, v, cl = dense_case(torch, gen, B, S, torch.bfloat16, cur_len, dev,
                             vh, vkvh, vd)
    q4, ks_, vs_ = q[:, :, None, :], k[:, :ctx].transpose(1, 2), \
        v[:, :ctx].transpose(1, 2)
    row = {"ms": time_ms(torch, lambda: dense_kernel.decode_attention(
               q, k, v, cl), flush),
           "plain_ms": time_ms(torch, lambda: decode_attention_ref(
               q, k, v, cl), flush),
           "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
               q4, ks_, vs_, enable_gqa=True), flush)}
    row["bound_ms"], row["bound_by"] = dense_bound(cur_len, B, 2, "bfloat16",
                                                   vh, vkvh, vd)
    print("  timing decode_attention:rep6:", json.dumps(ratios(row)))
    entries.append(entry("decode_attention:rep6", DENSE_SOURCE, DENSE_REPLACES,
                         row, "internvl2's static decode: B 8, cur_len 1088 "
                         "of 2048, H 48, KVH 8 (rep 6), D 128",
                         variant=dense_kernel.variant(q.dtype, k.dtype, vd),
                         library="F.scaled_dot_product_attention("
                                 "enable_gqa=True) on the cache sliced to "
                                 "cur_len"))
    del q, k, v, ks_, vs_, flush
    return {"phase": "kernel_frontends", "checked": len(holds.checked),
            "worst": holds.worst, "entries": entries}


# ---------------------------------------------------------------------------
# the dry-run: its kernels at the cells' lengths, then five cells timed
# ---------------------------------------------------------------------------

# (arch, shape, rows on the card): counted on meta at those rows, then
# timed at full width and depth (the global batch cut where one card must)
DRYRUN_CELLS = (("qwen3-14b", "prefill_32k", 1),
                ("qwen3-14b", "decode_32k", 4),
                ("mamba2-370m", "decode_32k", 128),
                ("hymba-1.5b", "long_500k", 1),
                ("h2o-danube-1.8b", "train_4k", 1))
QWEN3_GEOM = (40, 8, 128)          # H, KVH, D: rep 5
HYMBA_HEADS = HYMBA_GEOM[:3]       # 25, 5, 64
LONG_CTX = 524288                  # long_500k's cache


def kernel_dryrun_phase(torch) -> dict:
    """Flash and the dense decode at the lengths the dry-run cells give
    them, held against their plain versions at ``KernelHolds``'
    tolerances, then timed beside their bounds, plain versions and SDPA:
    flash at qwen3-14b's prefill_32k (B 1, S 32768, H 40, KVH 8, D 128,
    causal; plain: ``blocked_attention``, the path's own, since the
    reference op's full (S x S) scores would not fit), the dense decode
    at qwen3-14b's decode_32k (B 4 x 32768 entries, rep 5, D 128) and at
    hymba-1.5b's long_500k global layers (B 1 x 524288 entries, H 25,
    KVH 5, D 64), each also at a ragged cur_len.  Returns one kernels
    line entry each (``launches`` set from the dryrun phase)."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import kernel as dense_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.models.common import blocked_attention, decode_attention_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(41)
    holds = KernelHolds(torch)
    hold, entry = holds.hold, holds.entry
    qh, qkvh, qd = QWEN3_GEOM
    yh, ykvh, yd = HYMBA_HEADS
    S = 32768

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=dev)
    q, k, v = randn(1, S, qh, qd), randn(1, S, qkvh, qd), randn(1, S, qkvh, qd)
    out = flash_kernel.flash_attention(q, k, v, causal=True)
    hold("flash_attention", f"wgmma bfloat16 qwen3 prefill_32k B=1 S={S} "
         f"H={qh} KVH={qkvh} D={qd} causal", out,
         blocked_attention(q, k, v, causal=True), bf16_rel=True)
    del out
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    row = {"ms": time_ms(torch, lambda: flash_kernel.flash_attention(
               q, k, v, causal=True), flush, iters=10),
           "plain_ms": time_ms(torch, lambda: blocked_attention(
               q, k, v, causal=True), flush, iters=1, warmup=1),
           "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
               qt, kt, vt, is_causal=True, enable_gqa=True), flush, iters=10)}
    row["bound_ms"], row["bound_by"] = flash_bound(1, S, S, qh, qkvh, True, 2,
                                                   "bfloat16", qd)
    print("  timing flash_attention:S32768:rep5:", json.dumps(ratios(row)))
    entries = [entry("flash_attention:S32768:rep5", FLASH_SOURCE,
                     FLASH_REPLACES, row, "qwen3-14b's prefill_32k: B 1, S "
                     "32768, H 40, KVH 8 (rep 5), D 128, causal",
                     variant=flash_kernel.variant(q.dtype, qd, qh // qkvh),
                     plain="models.common.blocked_attention",
                     library="F.scaled_dot_product_attention(is_causal=True, "
                             "enable_gqa=True)")]
    del q, k, v, qt, kt, vt
    for name, B, S, (h, kvh, d), ragged, label in (
            ("decode_attention:32k:rep5", 4, 32768, QWEN3_GEOM, 20001,
             "qwen3-14b's decode_32k: B 4, 32768 of 32768 entries, H 40, "
             "KVH 8 (rep 5), D 128"),
            ("decode_attention:512k:D64:rep5", 1, LONG_CTX, HYMBA_HEADS,
             300001, "hymba-1.5b's long_500k global layers: B 1, 524288 of "
             "524288 entries, H 25, KVH 5 (rep 5), D 64")):
        # a ragged cur_len, then the path's own (every entry), timed after
        for cur_len in (np.full(B, ragged), np.full(B, S)):
            q, k, v, cl = dense_case(torch, gen, B, S, torch.bfloat16, cur_len,
                                     dev, h, kvh, d)
            hold("decode_attention", f"tensor_core bfloat16 B={B} S={S} H={h} "
                 f"KVH={kvh} D={d} cur_len {int(cur_len[0])}",
                 dense_kernel.decode_attention(q, k, v, cl),
                 decode_attention_ref(q, k, v, cl))
        q4, ks_, vs_ = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
        row = {"ms": time_ms(torch, lambda: dense_kernel.decode_attention(
                   q, k, v, cl), flush),
               "plain_ms": time_ms(torch, lambda: decode_attention_ref(
                   q, k, v, cl), flush, iters=5),
               "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                   q4, ks_, vs_, enable_gqa=True), flush, iters=10)}
        row["bound_ms"], row["bound_by"] = dense_bound(cur_len, B, 2,
                                                       "bfloat16", h, kvh, d)
        row["stream_read_ms"] = stream_read_ms(torch, 2 * B * S * kvh * d * 2,
                                               flush)
        print(f"  timing {name}:", json.dumps(ratios(row)))
        entries.append(entry(name, DENSE_SOURCE, DENSE_REPLACES, row, label,
                             variant=dense_kernel.variant(q.dtype, k.dtype, d),
                             stream_read_ms=row["stream_read_ms"],
                             library="F.scaled_dot_product_attention("
                                     "enable_gqa=True) on the cache sliced to "
                                     "cur_len (all of it)"))
        del q, k, v, cl, q4, ks_, vs_
    del flush
    return {"phase": "kernel_dryrun", "checked": len(holds.checked),
            "worst": holds.worst, "entries": entries}


def dryrun_phase(torch) -> dict:
    """The dry-run's five card cells (``DRYRUN_CELLS``), one after
    another, each through ``launch.dryrun.run_cell(device="cuda")``: the
    step counted on meta at the card's rows (FLOPs, ``bound_bytes``,
    ``bound_s`` against the H100's data sheet), then built at full width
    and depth on the card (random weights and caches from a seed) and
    timed: a warm-up step, the median wall of 2, one profiled step (busy
    ms), the peak memory.  The kernel counts are set to 0 just before each
    cell and read after it: every kernel the count saw on meta launched
    on the card, once a step (4 steps), and no other; and the step's
    output is finite (tokens within the vocabulary)."""
    from repro_torch import kernels
    from repro_torch.launch import dryrun

    cells, launches = [], {}
    for arch, shape, batch in DRYRUN_CELLS:
        t = time.monotonic()
        kernels.LAUNCHES.clear()
        rec = dryrun.run_cell(arch, shape, device="cuda", batch=batch,
                              out_dir=None)
        got = {k: n for k, n in kernels.LAUNCHES.items() if n}
        gc.collect()
        torch.cuda.empty_cache()
        m = rec["measured"]
        steps = dryrun.REPS + 2
        want = {k: steps * c["launches"] for k, c in rec["kernels"].items()}
        if got != want:
            raise AssertionError(f"{arch} x {shape}: launches on the card "
                                 f"{got}, counted on meta x {steps} steps "
                                 f"{want}")
        if not (m["output_ok"] and all(
                math.isfinite(m[k]) and m[k] > 0
                for k in ("wall_ms", "busy_ms", "peak_gb"))):
            raise AssertionError(f"{arch} x {shape}: {m}")
        cell = {"arch": arch, "shape": shape, "batch": batch,
                "flops": rec["flops_per_device"],
                "bound_bytes": rec["bound_bytes_per_device"],
                "op_bytes": rec["bytes_per_device"],
                "argument_gb": rec["memory_analysis"][
                    "argument_size_in_bytes"] / 1e9,
                "bound_ms": rec["bound_s"] * 1e3, "dominant": rec["dominant"],
                "model_flops": rec["model_flops_total"],
                "useful_flops_ratio": rec["useful_flops_ratio"],
                "count_s": rec["count_s"], "kernels_counted": rec["kernels"],
                "launches": got, "seconds": time.monotonic() - t,
                **{k: m[k] for k in ("wall_ms", "wall_ms_all", "busy_ms",
                                     "share_wall", "share_busy", "held_gb",
                                     "peak_gb")}}
        cell["model_flops_share_wall"] = (rec["model_flops_total"]
                                          / (m["wall_ms"] / 1e3)
                                          / PEAK_OPS_PER_S["bfloat16"])
        print("  cell:", json.dumps(cell))
        cells.append(cell)
        launches[f"{arch}:{shape}"] = got
    return {"phase": "dryrun", "cells": cells, "kernel_launches": launches}


def build_vlm(torch):
    return build_full(torch, INTERNVL2, VLM_LAYERS)


def serve_vlm_phase(torch, model) -> dict:
    """internvl2-26b at full width and ``VLM_LAYERS`` layers behind the
    static ``ServeEngine``: ``VLM_BATCH`` prompts of 256 random image
    embeddings ahead of 768 text tokens (greedy and sampled rows in turn),
    64 new tokens each, twice (the re-run must reproduce every stream;
    its times are the phase's readings, the first call's beside them).
    The flash kernel must run once a layer in the prefill (rep 6, the 1024
    positions causal) and the dense decode kernel once a layer a decode
    step.  Reports TTFT (the prefill and the first draw), the decode
    step's wall time, and the device time of ``STATIC_PROFILE_STEPS``
    decode steps (a profiled call of that many + 1 new tokens minus one of
    1): busy ms a step, idle share, time by kernel."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.decode_attention.kernel import NAME as DENSE
    from repro_torch.kernels.flash_attention.kernel import NAME as FLASH
    from repro_torch.runtime.engine import ServeEngine
    from repro_torch.runtime.sampling import SamplingParams

    cfg = model.cfg
    ni = cfg.n_frontend_tokens
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    gen = torch.Generator(device=dev).manual_seed(11)
    batch = {"tokens": torch.as_tensor(rng.integers(
                 0, cfg.vocab_size, (VLM_BATCH, VLM_TEXT)), device=dev),
             "image_embeds": torch.randn((VLM_BATCH, ni, cfg.d_model),
                                         generator=gen, device=dev
                                         ).to(torch.bfloat16)}
    sps = [SamplingParams() if i % 2 == 0 else
           SamplingParams(temperature=0.8, top_p=0.9, top_k=40, seed=3000 + i)
           for i in range(VLM_BATCH)]
    layers_ = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(model, device="cuda", max_len=VLM_MAX_LEN)
    _, _, plen = eng.prefill(batch)
    if plen != ni + VLM_TEXT:
        raise AssertionError(f"prompt length {plen}, want {ni + VLM_TEXT} "
                             f"(image positions count)")
    LAUNCHES.clear()
    t0 = time.perf_counter()
    out = eng.generate(batch, max_new_tokens=VLM_NEW, sampling_params=sps)
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in LAUNCHES.items() if v}
    want = {FLASH: layers_, DENSE: layers_ * (VLM_NEW - 1)}
    if launches != want:
        raise AssertionError(f"serve_vlm launched {launches}, want {want}")
    toks = out.tokens.cpu().numpy()
    if toks.shape != (VLM_BATCH, VLM_NEW) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"serve_vlm tokens {toks.shape}: out of range")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    again = eng.generate(batch, max_new_tokens=VLM_NEW, sampling_params=sps)
    wall_again = time.perf_counter() - t0
    if not torch.equal(again.tokens, out.tokens):
        raise AssertionError("serve_vlm: a second call did not reproduce "
                             "every stream")
    steps = STATIC_PROFILE_STEPS
    t_one, _ = device_time_by_kernel(torch, lambda: eng.generate(
        batch, max_new_tokens=1, sampling_params=sps))
    t_many, _ = device_time_by_kernel(torch, lambda: eng.generate(
        batch, max_new_tokens=steps + 1, sampling_params=sps))
    per_step = {k: (t_many.get(k, 0.0) - t_one.get(k, 0.0)) / steps
                for k in set(t_many) | set(t_one)}
    busy = sum(per_step.values())
    step_ms = 1e3 * again.decode_s / (VLM_NEW - 1)
    top = sorted(per_step.items(), key=lambda kv: -kv[1])[:8]
    result = {"phase": "serve_vlm", "model": f"{cfg.name}, {layers_} of 48 "
              f"layers, full width, bf16", "params_b": model.param_count() / 1e9,
              "batch": VLM_BATCH, "image_positions": ni,
              "text_tokens": VLM_TEXT, "prompt_positions": plen,
              "new_tokens": VLM_BATCH * VLM_NEW,
              "greedy_rows": [0, 2], "sampled_rows": [1, 3],
              "ttft_s": again.prefill_s, "ttft_s_first_call": out.prefill_s,
              "decode_step_ms": step_ms,
              "decode_step_ms_first_call": 1e3 * out.decode_s / (VLM_NEW - 1),
              "tokens_per_s": VLM_BATCH * VLM_NEW / wall_again,
              "wall_s": wall_again, "wall_s_first_call": wall,
              "peak_mem_gb": peak_gb, "kernel_launches": launches,
              "rerun_identical": True,
              "sim_context": plen + VLM_NEW / 2, "sim_batch": VLM_BATCH,
              "profiled_decode_steps": {
                  "steps": steps, "device_busy_ms_per_step": busy,
                  "device_idle_share": 1 - busy / step_ms,
                  "decode_attention_ms_per_step": sum(
                      t for k, t in per_step.items() if "dense_decode" in k),
                  "prefill_flash_ms": sum(t for k, t in t_one.items()
                                          if "flash_fwd" in k),
                  "prefill_device_ms": sum(t_one.values()),
                  "top_kernels_ms_per_step": {k[:70]: t for k, t in top}}}
    del eng
    return result


def _model_flops(model, tokens: int, seq: int, batch: int) -> tuple[int, int]:
    """FLOPs of one training step: the model's (6 per weight of a
    projection and token, and 3 forward passes of attention's q.k and p.v)
    and the hardware's with ``remat`` (8 and 4: each layer's forward runs
    again in the backward pass)."""
    cfg = model.cfg
    n_mm = sum(p.numel() for p in model.parameters() if p.ndim >= 2)
    pairs = seq * seq if not cfg.causal else seq * (seq + 1) // 2
    attn = 4 * batch * pairs * cfg.n_heads * cfg.hd * cfg.n_layers
    return 6 * n_mm * tokens + 3 * attn, 8 * n_mm * tokens + 4 * attn


def hubert_forward_hold(torch, model, batch) -> dict:
    """``Model.forward``'s loop run five ways on one batch, under no grad:
    the flash path; the plain path (``layers.kernel_path`` patched off);
    an f32 copy of the model on the plain path; and the plain path with
    each fault of ``HUBERT_FAULTS``.  The relative L2 error of the hidden
    state after each layer of ``HUBERT_HOLD_DEPTHS`` and of the logits
    (the real vocabulary's columns, in f32), for each pair read."""
    import copy
    from unittest import mock

    from repro_torch.models import layers
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import blocked_attention

    cfg = model.cfg
    tail = HUBERT_FRAMES - HUBERT_FRAMES % 64

    def run(m):
        x, kept = m._embed_inputs(batch), {}
        for i, (win, blk) in enumerate(zip(m.windows, m.layers), 1):
            x = model_lib._block_forward(blk, x, cfg, win)
            if i in HUBERT_HOLD_DEPTHS:
                kept[str(i)] = x.float()
        kept["logits"] = m._head(x)[..., :cfg.vocab_size].float()
        return kept

    plain = mock.patch.object(layers, "kernel_path", lambda device: False)
    faults = {
        "causal_mask": lambda q, k, v, c, window: blocked_attention(
            q, k, v, causal=True),
        "tail_dropped": lambda q, k, v, c, window: blocked_attention(
            q, k[:, :tail], v[:, :tail], causal=False)}
    out = {"flash": run(model)}
    with plain:
        out["plain"] = run(model)
        for name, attn in faults.items():
            with mock.patch.object(layers, "_full_attention", attn):
                out[name] = run(model)
        m32 = copy.deepcopy(model).float()
        out["f32"] = run(m32)
        del m32

    def rel(a, b):
        return {k: float((a[k] - b[k]).norm() / b[k].norm()) for k in b}

    pairs = {"flash_vs_plain": ("flash", "plain"),
             "flash_vs_f32": ("flash", "f32"),
             "plain_vs_f32": ("plain", "f32"),
             **{f"{name}_vs_plain": (name, "plain") for name in faults},
             **{f"{name}_vs_f32": (name, "f32") for name in faults}}
    lf, pf = out["flash"]["logits"], out["plain"]["logits"]
    return {"rel_l2": {k: rel(out[a], out[b]) for k, (a, b) in pairs.items()},
            "argmax_agreement":
                float((lf.argmax(-1) == pf.argmax(-1)).float().mean())}


def train_hubert_phase(torch) -> dict:
    """hubert-xlarge at full size (48 layers; its parameter count held to
    the reference's published-size figure, 1.26 B within 30%): one
    ``Model.forward`` under no grad over B 4 x 1500 frames (48 non-causal
    flash launches, its logits held against the plain path's: their
    relative L2 error within ``FORWARD_REL_TOL``, backed by the witnesses
    of ``hubert_forward_hold``), then
    ``HUBERT_TRAIN_STEPS`` AdamW steps with ``remat=True`` at B 4 x 1024
    frames: no kernel may launch inside a step (attention under autograd
    is the plain ``blocked_attention``, 2 calls a layer a step with the
    recompute), the losses finite.  Reports step ms, tokens/s, the
    model-FLOPs share of the card's bf16 peak, peak GB, and
    ``blocked_attention``'s share of a step's device time: a layer's
    attention (a forward and a forward with backward at the step's shapes,
    timed alone) times 48 over one traced step's device busy time."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.models import layers
    from repro_torch.models.common import blocked_attention
    from repro_torch.models.footprint import compute_footprint
    from repro_torch.models.model import Model
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step
    from repro_torch.train.loop import batch_to

    dev = torch.device("cuda")
    cfg = get_config(HUBERT)
    t0 = time.monotonic()
    model = Model(cfg, device=dev).init(seed=0)
    torch.cuda.synchronize()
    n_params = model.param_count()
    print(f"{HUBERT}: {cfg.n_layers} layers, {n_params / 1e9:.3f} B params "
          f"bf16, random init {time.monotonic() - t0:.1f} s")
    if not abs(n_params / 1e9 - 1.26) <= 0.30 * 1.26:
        raise AssertionError(f"hubert has {n_params} parameters, the "
                             f"published figure is 1.26 B (within 30%)")

    gen = torch.Generator(device=dev).manual_seed(12)
    feats = torch.randn((TRAIN_BATCH, HUBERT_FRAMES, cfg.d_model),
                        generator=gen, device=dev)
    with torch.no_grad():
        LAUNCHES.clear()
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits = model.forward({"features": feats})
        torch.cuda.synchronize()
        fwd_ms = 1e3 * (time.perf_counter() - t)
        launches = {k: v for k, v in LAUNCHES.items() if v}
        if launches != {flash_kernel.NAME: cfg.n_layers}:
            raise AssertionError(f"hubert's no-grad forward launched "
                                 f"{launches}, want {cfg.n_layers} flash")
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("hubert's forward logits are not finite")
        del logits
        hold = hubert_forward_hold(torch, model, {"features": feats})
        # the hold's flash run launches as many again, its plain runs none
        if {k: 2 * v for k, v in launches.items()} != {
                k: v for k, v in LAUNCHES.items() if v}:
            raise AssertionError(f"the hold launched {dict(LAUNCHES)}: a "
                                 f"plain forward launched a kernel")
    del feats
    print(f"  hubert forward, relative L2 error by depth "
          f"{list(HUBERT_HOLD_DEPTHS)} and of the logits:")
    for key, errs in hold["rel_l2"].items():
        print(f"    {key:>22}: " + " ".join(
            f"{errs[str(dp)]:.4g}" for dp in HUBERT_HOLD_DEPTHS)
            + f" | logits {errs['logits']:.4g}")
    errs = {k: v["logits"] for k, v in hold["rel_l2"].items()}

    def verdict(path):
        """(relative L2 from the plain path, error against the f32 forward
        over the plain path's) of a path's logits, and whether both hold."""
        r = errs[f"{path}_vs_plain"]
        q = errs[f"{path}_vs_f32"] / errs["plain_vs_f32"]
        return r, q, r <= FORWARD_REL_TOL and q <= FORWARD_F32_RATIO

    rel_l2, ratio, ok = verdict("flash")
    caught = {k: not verdict(k)[2] for k in HUBERT_FAULTS}
    print(f"  flash vs plain {rel_l2:.4g} (tolerance {FORWARD_REL_TOL:.4g}); "
          f"flash's error against the f32 forward over plain's {ratio:.4g} "
          f"(at most {FORWARD_F32_RATIO}); the faults read "
          + ", ".join(f"{k} {verdict(k)[0]:.4g} / {verdict(k)[1]:.4g}"
                      for k in HUBERT_FAULTS)
          + f" (each must fail the hold); argmax agreement "
          f"{hold['argmax_agreement']:.4f}")
    if not ok:
        raise AssertionError(f"hubert's flash forward: {rel_l2} from the "
                             f"plain path (relative L2; tolerance "
                             f"{FORWARD_REL_TOL}), {ratio}x the plain path's "
                             f"error against f32 (at most "
                             f"{FORWARD_F32_RATIO})")
    if not all(caught.values()):
        raise AssertionError(f"the hold passes a faulty attention: {caught}")
    hold["faults_caught"] = caught

    # training: fresh trainable weights (the model's earlier ones freed)
    state = init_train_state(model, seed=0)
    opt = AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=HUBERT_TRAIN_STEPS)
    step_fn = make_train_step(model, opt, remat=True)
    pipe = SyntheticTokenPipeline(cfg, global_batch=TRAIN_BATCH,
                                  seq_len=HUBERT_TRAIN_FRAMES, seed=0)
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    layers.AUTOGRAD_ATTENTION["gqa"] = 0
    losses, step_ms = [], []
    for i in range(HUBERT_TRAIN_STEPS):
        batch = batch_to(pipe.get_batch(i), dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, met = step_fn(state, batch)
        losses.append(float(met["loss"]))
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t))
    launched = {k: v for k, v in LAUNCHES.items() if v}
    if launched:
        raise AssertionError(f"kernels launched inside a training step: "
                             f"{launched}")
    calls = layers.AUTOGRAD_ATTENTION["gqa"]
    if calls != 2 * cfg.n_layers * HUBERT_TRAIN_STEPS:
        raise AssertionError(f"{calls} plain attention calls under autograd, "
                             f"want 2 a layer a step (forward, recompute)")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"hubert losses {losses}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    state_gb = (sum(p.numel() * p.element_size() * 2
                    for p in state.params.values())
                + sum(t.numel() * t.element_size()
                      for acc in ("m", "v")
                      for t in state.opt_state[acc].values())) / 1e9
    batch = batch_to(pipe.get_batch(HUBERT_TRAIN_STEPS), dev)
    t_dev, _ = device_time_by_kernel(torch, lambda: step_fn(state, batch))
    busy_ms = sum(t_dev.values())

    # one layer's attention at the step's shapes, alone: a forward (the
    # remat pass) and a forward with its backward
    B, S, h, d = TRAIN_BATCH, HUBERT_TRAIN_FRAMES, cfg.n_heads, cfg.hd
    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=dev)
    q, k, v = (torch.randn((B, S, h, d), generator=gen, device=dev).to(
        torch.bfloat16).requires_grad_(True) for _ in range(3))
    g_out = torch.randn((B, S, h, d), generator=gen, device=dev).to(
        torch.bfloat16)

    def fwd_bwd():
        blocked_attention(q, k, v, causal=False).backward(g_out)

    with torch.no_grad():
        attn_fwd_ms = time_ms(torch, lambda: blocked_attention(
            q, k, v, causal=False), flush, iters=10)
        flash_fwd_ms = time_ms(torch, lambda: flash_kernel.flash_attention(
            q, k, v, causal=False), flush, iters=10)
    attn_fwd_bwd_ms = time_ms(torch, fwd_bwd, flush, iters=10)
    attn_step_ms = cfg.n_layers * (attn_fwd_ms + attn_fwd_bwd_ms)
    del q, k, v, g_out, flush
    step = float(np.median(step_ms[1:]))
    tokens = TRAIN_BATCH * HUBERT_TRAIN_FRAMES
    model_flops, hw_flops = _model_flops(model, tokens, HUBERT_TRAIN_FRAMES,
                                         TRAIN_BATCH)
    result = {"phase": "train_hubert",
              "model": f"{cfg.name}, all {cfg.n_layers} layers, bf16 weights, "
                       f"f32 AdamW moments, remat",
              "params": n_params,
              "footprint_total_params": compute_footprint(cfg).total_params,
              "forward": {"batch": TRAIN_BATCH, "frames": HUBERT_FRAMES,
                          "ms": fwd_ms, "flash_launches": launches,
                          "vs_plain_rel_l2": rel_l2,
                          "tolerance": FORWARD_REL_TOL,
                          "vs_f32_over_plain_vs_f32": ratio,
                          "f32_ratio_limit": FORWARD_F32_RATIO,
                          **hold},
              "train": {"batch": TRAIN_BATCH, "frames": HUBERT_TRAIN_FRAMES,
                        "steps": HUBERT_TRAIN_STEPS, "losses": losses,
                        "step_ms": step_ms, "step_ms_median_after_first": step,
                        "tokens_per_s": tokens / step * 1e3,
                        "model_tflop_per_step": model_flops / 1e12,
                        "hardware_tflop_per_step_remat": hw_flops / 1e12,
                        "model_flops_share_of_peak":
                            model_flops / (step / 1e3) / PEAK_BF16,
                        "kernel_launches_in_steps": launched,
                        "plain_attention_calls": calls,
                        "peak_mem_gb": peak_gb,
                        "weights_grads_moments_gb": state_gb,
                        "traced_step_device_busy_ms": busy_ms,
                        "traced_step_device_idle_share":
                            max(0.0, 1 - busy_ms / step),
                        "blocked_attention": {
                            "layer_forward_ms": attn_fwd_ms,
                            "layer_forward_backward_ms": attn_fwd_bwd_ms,
                            "ms_per_step": attn_step_ms,
                            "share_of_step_device_time":
                                attn_step_ms / busy_ms,
                            "flash_forward_ms_same_shape": flash_fwd_ms},
                        "top_kernels_ms": {k[:70]: t for k, t in sorted(
                            t_dev.items(), key=lambda kv: -kv[1])[:8]}}}
    del state, model
    return result


def train_phase(torch) -> dict:
    """h2o-danube-1.8b at full width and ``TRAIN_LAYERS`` layers through
    ``run_training`` (remat, B 4 x S 2048, ``TRAIN_STEPS`` steps, a
    checkpoint every ``TRAIN_CKPT_EVERY`` and at the last): an injected
    failure at step ``TRAIN_FAIL_AT`` restores the checkpoint of step 5 and
    replays steps 5-7, then a second ``run_training`` call on the same
    directory resumes at step 12 and runs to ``TRAIN_RESUME_TO``.  Every
    loss finite, one rollback, the committed checkpoints as the schedule
    says, no kernel launched.  Reports the losses, whether the replayed
    steps reproduce the first pass's losses bit for bit, step ms, save and
    restore seconds and bytes."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models.model import Model
    from repro_torch.train import (
        AdamWConfig, LoopConfig, init_train_state, list_checkpoints,
        make_train_step, run_training,
    )
    import tempfile

    cfg = dataclasses.replace(get_config(DANUBE), n_layers=TRAIN_LAYERS)
    model = Model(cfg, device="cuda")
    state = init_train_state(model, seed=0)
    n_params = model.param_count()
    step_fn = make_train_step(model, AdamWConfig(
        lr=3e-4, warmup_steps=2, total_steps=TRAIN_RESUME_TO), remat=True)
    pipe = SyntheticTokenPipeline(cfg, global_batch=TRAIN_BATCH,
                                  seq_len=TRAIN_SEQ, seed=0)
    fired = []

    def fail_once(step):
        if step == TRAIN_FAIL_AT and not fired:
            fired.append(step)
            return True
        return False

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as d:
        LAUNCHES.clear()
        t0 = time.perf_counter()
        res = run_training(step_fn, state, pipe, LoopConfig(
            total_steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT_EVERY, ckpt_dir=d),
            failure_fn=fail_once)
        wall = time.perf_counter() - t0
        replay = TRAIN_FAIL_AT - TRAIN_CKPT_EVERY
        committed = list_checkpoints(d)
        want_ckpts = [TRAIN_CKPT_EVERY, 2 * TRAIN_CKPT_EVERY, TRAIN_STEPS]
        if (res.rollbacks != 1 or int(res.state.step) != TRAIN_STEPS
                or len(res.losses) != TRAIN_STEPS + replay
                or committed != want_ckpts
                or not all(math.isfinite(x) for x in res.losses)):
            raise AssertionError(
                f"train: rollbacks {res.rollbacks}, step "
                f"{int(res.state.step)}, {len(res.losses)} losses "
                f"{res.losses}, checkpoints {committed} (want {want_ckpts})")
        first = res.losses[TRAIN_CKPT_EVERY:TRAIN_FAIL_AT]
        again = res.losses[TRAIN_FAIL_AT:TRAIN_FAIL_AT + replay]
        ckpt_bytes = os.path.getsize(os.path.join(
            d, f"step_{TRAIN_CKPT_EVERY:08d}", "arrays.npz"))
        del res.state, state
        res2 = run_training(step_fn, init_train_state(model, seed=1), pipe,
                            LoopConfig(total_steps=TRAIN_RESUME_TO,
                                       ckpt_every=TRAIN_CKPT_EVERY,
                                       ckpt_dir=d))
        if (res2.resumed_from != TRAIN_STEPS
                or len(res2.losses) != TRAIN_RESUME_TO - TRAIN_STEPS
                or int(res2.state.step) != TRAIN_RESUME_TO
                or not all(math.isfinite(x) for x in res2.losses)):
            raise AssertionError(f"train: the second call resumed from "
                                 f"{res2.resumed_from} with losses "
                                 f"{res2.losses}")
        launched = {k: v for k, v in LAUNCHES.items() if v}
        if launched:
            raise AssertionError(f"train launched kernels: {launched}")
        resumed = (res2.resumed_from, res2.losses, res2.timings)
        del res2
    steps_ms = [1e3 * s for s in res.timings["step_s"]]
    return {"phase": "train",
            "model": f"{cfg.name}, {TRAIN_LAYERS} of 24 layers, full width, "
                     f"remat", "params": n_params, "batch": TRAIN_BATCH,
            "seq": TRAIN_SEQ, "losses": res.losses, "rollbacks": res.rollbacks,
            "checkpoints": committed, "resumed_from": resumed[0],
            "resumed_losses": resumed[1],
            "replayed_steps_bitwise_equal": first == again,
            "replayed_losses": {"first_pass": first, "after_restore": again},
            "step_ms": steps_ms,
            "step_ms_median": float(np.median(steps_ms[1:])),
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ
                            / float(np.median(steps_ms[1:])) * 1e3,
            "checkpoint_bytes": ckpt_bytes,
            "save_s": res.timings["save_s"] + resumed[2]["save_s"],
            "restore_s": res.timings["restore_s"] + resumed[2]["restore_s"],
            "loop_wall_s": wall}


def train_cli_phase(torch) -> dict:
    """``repro_torch.launch.train.main(TRAIN_CLI)`` in this process with a
    temporary checkpoint directory: returns 0 and prints the reference's
    summary line."""
    import io
    import tempfile

    from repro_torch.launch.train import main as train_main

    buf = io.StringIO()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as d, \
            contextlib.redirect_stdout(buf):
        t0 = time.perf_counter()
        rc = train_main(TRAIN_CLI + ["--ckpt-dir", d])
        wall = time.perf_counter() - t0
    out = buf.getvalue().strip().splitlines()
    print("  " + "\n  ".join(out))
    line = out[-1] if out else ""
    if rc != 0 or not (line.startswith("arch=h2o-danube-1.8b-reduced ")
                       and " steps=20 first_loss=" in line):
        raise AssertionError(f"the training launcher returned {rc}: {line!r}")
    return {"phase": "train_cli", "argv": TRAIN_CLI, "returncode": rc,
            "summary": line, "wall_s": wall}


TRAIN_CHECKS = (  # (family, config, narrow fields, MoE strategy)
    ("dense, qk-norm and qkv bias", "qwen3-14b",
     dict(qkv_bias=True, n_layers=2, d_model=512, n_heads=8, n_kv_heads=2,
          head_dim=64, d_ff=1024), "auto"),
    ("windowed", DANUBE, dict(n_layers=2, d_model=640, n_heads=8,
                              n_kv_heads=2, d_ff=1024, sliding_window=64),
     "auto"),
    ("MLA + MoE", "deepseek-v2-lite-16b",
     dict(n_layers=2, d_model=512, n_heads=4, n_kv_heads=4, head_dim=128,
          rope_head_dim=64, v_head_dim=128, kv_lora_rank=128, d_ff=1024,
          n_experts=8, n_experts_per_token=2, n_shared_experts=1,
          moe_d_ff=256), "capacity"),
    ("GQA + MoE", SCOUT, dict(n_layers=2, d_model=512, n_heads=10,
                              n_kv_heads=2, head_dim=64, d_ff=1024,
                              moe_d_ff=512), "auto"),
    ("SSM", MAMBA2, dict(n_layers=2, d_model=256, ssm_state=64,
                         ssm_chunk=64), "auto"),
    ("hybrid", HYMBA, dict(n_layers=3, global_attn_every=3, d_model=320,
                           n_heads=5, n_kv_heads=1, head_dim=64, d_ff=640,
                           sliding_window=64, ssm_chunk=64), "auto"),
    ("audio", HUBERT, dict(n_layers=2, d_model=320, n_heads=4, n_kv_heads=4,
                           head_dim=80, d_ff=640), "auto"),
    ("vision", INTERNVL2, dict(n_layers=2, d_model=768, n_heads=12,
                               n_kv_heads=2, head_dim=64, d_ff=1024,
                               n_frontend_tokens=16), "auto"))
TRAIN_CHECK_LR = 1e-3


def check_train(torch) -> list[dict]:
    """One training step of each family's narrow f32 model (``TRAIN_CHECKS``:
    2-3 layers at head dims the kernels take) on the card against the same
    step on the CPU from the same weights and batch (B 2 x 128 positions):
    the loss within 1e-5 (relative), each gradient leaf within 1e-4 of its
    norm plus 1e-6 of the whole gradient's, each updated leaf within 1e-5
    of its magnitude (+1e-6) except at most 1% of its entries, whose
    gradient is near zero and may take the other sign on one side, moving
    the weight by up to 2 lr more; a leaf whose gradient is rounding
    noise (its norm under 1e-6 of the whole gradient's: top-1 routing's
    router, whose gradient is zero in exact arithmetic) is left out of the
    update comparison, as Adam scales that noise to steps of ~lr of either
    sign on either side.  No kernel may launch on the card.
    Then the narrow vision model's static greedy stream (image embeddings
    ahead of the prompt) on the card against the CPU: equal, or parting
    at a near-tie only."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.decode_attention.kernel import NAME as DENSE
    from repro_torch.kernels.flash_attention.kernel import NAME as FLASH
    from repro_torch.models.model import Model
    from repro_torch.runtime.engine import ServeEngine
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step
    from repro_torch.train.loop import batch_to
    from repro_torch.train.train_step import bind_params

    results = []
    vision = None
    for family, name, kw, impl in TRAIN_CHECKS:
        cfg = dataclasses.replace(get_config(name), name=f"{name}-narrow",
                                  vocab_size=4000, vocab_pad_multiple=512,
                                  **kw)
        cpu = Model(cfg, device="cpu", moe_impl=impl).init(seed=9).float()
        gpu = Model(cfg, device="cuda", moe_impl=impl).float()
        gpu.load_state_dict(cpu.state_dict())
        batch = SyntheticTokenPipeline(cfg, global_batch=2, seq_len=128,
                                       seed=1).get_batch(0)
        got = {}
        for dev, model in (("cuda", gpu), ("cpu", cpu)):
            LAUNCHES.clear()
            b = batch_to(batch, torch.device(dev))
            state = init_train_state(model)
            bind_params(model, state.params)
            model.loss(b).backward()
            grads = {n: p.grad.detach().clone()
                     for n, p in state.params.items()}
            step = make_train_step(model, AdamWConfig(
                lr=TRAIN_CHECK_LR, warmup_steps=1, total_steps=10))
            state, met = step(state, b)
            got[dev] = (float(met["loss"]), grads,
                        {n: p.detach().cpu() for n, p in
                         state.params.items()},
                        {k: v for k, v in LAUNCHES.items() if v})
        (lg, gg, pg, launched), (lc, gc_, pc, _) = got["cuda"], got["cpu"]
        if launched:
            raise AssertionError(f"{family} training step launched "
                                 f"{launched} on the card")
        loss_rel = abs(lg - lc) / abs(lc)
        total = math.sqrt(sum(float(g.double().norm()) ** 2
                              for g in gc_.values()))
        grad_worst, upd_worst, flipped, noise = 0.0, 0.0, 0.0, []
        for n, g in gc_.items():
            err = float((gg[n].cpu().double() - g.double()).norm())
            grad_worst = max(grad_worst, err / max(float(g.double().norm()),
                                                   1e-30))
            if not err <= 1e-4 * float(g.double().norm()) + 1e-6 * total:
                raise AssertionError(f"{family}: gradient {n} card vs CPU "
                                     f"differs by {err}")
            if float(g.double().norm()) <= 1e-6 * total:
                noise.append(n)
                continue
            w = pc[n].double()
            diff = (pg[n].double() - w).abs()
            tol = 1e-5 * float(w.abs().max()) + 1e-6
            share = float((diff > tol).double().mean())
            flipped = max(flipped, share)
            upd_worst = max(upd_worst, float(diff.max()))
            if share > 0.01 or float(diff.max()) > tol + 2 * TRAIN_CHECK_LR:
                raise AssertionError(f"{family}: updated {n} card vs CPU: "
                                     f"{share:.3g} of entries beyond {tol}, "
                                     f"max {float(diff.max())}")
        if not loss_rel <= 1e-5:
            raise AssertionError(f"{family}: loss {lg} on the card, {lc} on "
                                 f"the CPU")
        row = {"case": f"train step, {family} ({name} narrow, "
                       f"{cfg.n_layers} layers, f32), card vs CPU",
               "loss_rel_err": loss_rel, "grad_worst_rel_err": grad_worst,
               "updated_max_abs_err": upd_worst,
               "updated_share_beyond_tol": flipped,
               "noise_gradient_leaves": noise, "kernel_launches": {}}
        print("  check:", json.dumps(row))
        results.append(row)
        if cfg.frontend == "vision":
            vision = (cfg, cpu, gpu)
        else:
            del cpu, gpu
    # the vision model's static greedy stream, card vs CPU
    cfg, cpu, gpu = vision
    rng = np.random.default_rng(13)
    ni = cfg.n_frontend_tokens
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 48)),
             "image_embeds": rng.standard_normal((2, ni, cfg.d_model)
                                                 ).astype(np.float32)}
    streams = {}
    for dev, model in (("cuda", gpu), ("cpu", cpu)):
        LAUNCHES.clear()
        out = ServeEngine(model, device=dev, max_len=128,
                          cache_dtype=torch.float32).generate(
            batch, max_new_tokens=16)
        streams[dev] = (out.tokens.cpu().numpy(),
                        {k: v for k, v in LAUNCHES.items() if v})
    launched = streams["cuda"][1]
    want = {FLASH: cfg.n_layers, DENSE: 15 * cfg.n_layers}
    if launched != want:
        raise AssertionError(f"vision static card run launched {launched}, "
                             f"want {want}")
    near = []
    for row, (g, c) in enumerate(zip(streams["cuda"][0], streams["cpu"][0])):
        if (g == c).all():
            continue
        t = int(np.argmax(g != c))
        with torch.no_grad():
            toks = torch.as_tensor(np.concatenate([batch["tokens"][row],
                                                   c[:t]]))[None]
            img = torch.as_tensor(batch["image_embeds"][row:row + 1])
            top = cpu.forward({"tokens": toks, "image_embeds": img})[
                0, -1].topk(2).values
        gap = float(top[0] - top[1])
        if not gap < NEAR_TIE:
            raise AssertionError(f"vision stream {row}: {g} vs {c} (token {t},"
                                 f" CPU top-2 gap {gap})")
        near.append({"row": row, "token": t, "cpu_gap": gap})
    results.append({"case": "internvl2 (narrow, f32) static greedy, image "
                            "embeddings + prompt, card vs CPU",
                    "identical": not near, "near_ties": near,
                    "kernel_launches": launched})
    del cpu, gpu
    torch.cuda.empty_cache()
    return results


def train_phases() -> dict:
    """The training and frontend phases that build their own models, in
    their order."""
    return {"train_hubert": train_hubert_phase, "train": train_phase,
            "train_cli": train_cli_phase}


KERNEL_PHASES = ("kernel", "kernel_scaled", "kernel_mxfp4", "kernel_flash",
                 "kernel_dense_decode", "kernel_exact", "kernel_headdims",
                 "kernel_hymba", "kernel_flash_mla", "kernel_frontends",
                 "kernel_dryrun", "quantize")


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=None,
                    help="comma-separated phases to run after the build "
                         f"({', '.join(KERNEL_PHASES)}, deployment, dryrun, "
                         "check, "
                         "check_mla, check_moe, check_window, check_state, "
                         "serve_cli, train_hubert, train, train_cli, "
                         "train_tp, serve_static_tp, serve_disagg_tp, "
                         "examples, or, on a "
                         "llama3-8b built "
                         "first, serve, serve_disagg, serve_tp (with its "
                         "tp=1 sessions) and serve_spec_draft, "
                         "on a "
                         "deepseek-v2-lite-16b built first, "
                         f"{', '.join(mla_phases())}, on mamba2-370m "
                         f"{', '.join(mamba2_phases())}, on hymba-1.5b "
                         f"{', '.join(hymba_phases())}, on llama4-scout at "
                         f"{SCOUT_LAYERS} layers, {', '.join(moe_phases())}, "
                         "on llama4-maverick at one period, "
                         f"serve_moe_maverick, on internvl2-26b at "
                         f"{VLM_LAYERS} layers, serve_vlm; then sim over the "
                         "serve "
                         "phases run); a partial run prints no result line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this smoke test needs an NVIDIA GPU", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line())             # as nvidia-smi gives it: name, power limit
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.monotonic()
    build_phase()

    def timed(name, fn, *args, **kw):
        t = time.monotonic()
        out = fn(torch, *args, **kw)
        # an engine's scheduler and its callbacks form a reference cycle:
        # collect it, so the next phase starts with only the live model on
        # the card (and its peak reading is its own)
        gc.collect()
        torch.cuda.empty_cache()
        line = out if "phase" in out else {"phase": name}
        print(json.dumps({**{k: v for k, v in line.items()
                             if not k.startswith("_")},
                          "seconds": time.monotonic() - t}))
        return out

    phases = {"kernel": kernel_phase, "kernel_scaled": kernel_scaled_phase,
              "kernel_mxfp4": kernel_mxfp4_phase,
              "kernel_flash": kernel_flash_phase,
              "kernel_dense_decode": kernel_dense_decode_phase,
              "kernel_exact": kernel_exact_phase,
              "kernel_headdims": kernel_headdims_phase,
              "kernel_hymba": kernel_hymba_phase,
              "kernel_flash_mla": kernel_flash_mla_phase,
              "kernel_frontends": kernel_frontends_phase,
              "kernel_dryrun": kernel_dryrun_phase, "dryrun": dryrun_phase,
              "quantize": quantize_phase, "deployment": deployment_phase,
              "check": check_phase,
              "check_mla": lambda t: {"phase": "check_mla",
                                      "cases": check_mla(t)},
              "check_moe": check_moe, "check_window": check_window,
              "check_state": check_state, "serve_cli": serve_cli_phase,
              "serve_tp": serve_tp_phase, "train_tp": train_tp_phase,
              "serve_disagg_tp": serve_disagg_tp_phase,
              "examples": examples_phase,
              "serve_static_tp": serve_static_tp_phase,
              **train_phases()}
    # the model phases that run alone: llama3-8b or deepseek-v2-lite-16b
    # is built for them first
    model_phases = {"serve": (build_llama, serve_phase),
                    "serve_disagg": (build_llama, serve_disagg_phase),
                    "serve_spec_draft": (build_llama, serve_spec_draft_phase),
                    **{name: (build_deepseek, fn) for name, fn in
                       mla_phases().items()},
                    **{name: (build_scout, fn) for name, fn in
                       moe_phases().items()},
                    **{name: (build_maverick, fn) for name, fn in
                       maverick_phases().items()},
                    **{name: (build_phi3, fn) for name, fn in
                       phi3_phases().items()},
                    **{name: (build_danube, fn) for name, fn in
                       danube_phases().items()},
                    **{name: (build_mamba2, fn) for name, fn in
                       mamba2_phases().items()},
                    **{name: (build_hymba, fn) for name, fn in
                       hymba_phases().items()},
                    "serve_vlm": (build_vlm, serve_vlm_phase)}
    served = []             # (phase, config as served, result) for sim
    if args.only is not None:
        names = args.only.split(",")
        models = {}
        for name in names:
            if name in model_phases:
                build, fn = model_phases[name]
                if build not in models:
                    models.clear()              # one model on the card
                    gc.collect()
                    torch.cuda.empty_cache()
                    models[build] = build(torch)
                served.append((name, models[build].cfg,
                               timed(name, fn, models[build])))
            elif name == "sim":
                timed(name, sim_phase, served)
            else:
                timed(name, phases[name])
        print(f"partial run ({args.only}): {time.monotonic() - t0:.1f} s, "
              f"no result line")
        return 0
    kernel = timed("kernel", kernel_phase)
    scaled = timed("kernel_scaled", kernel_scaled_phase)
    vmm = timed("kernel_mxfp4", kernel_mxfp4_phase)
    flash = timed("kernel_flash", kernel_flash_phase)
    dense = timed("kernel_dense_decode", kernel_dense_decode_phase)
    exact = timed("kernel_exact", kernel_exact_phase)
    headdims = timed("kernel_headdims", kernel_headdims_phase)
    hymba_kernels = timed("kernel_hymba", kernel_hymba_phase)
    flash_mla = timed("kernel_flash_mla", kernel_flash_mla_phase)
    frontends = timed("kernel_frontends", kernel_frontends_phase)
    dry_kernels = timed("kernel_dryrun", kernel_dryrun_phase)
    timed("quantize", quantize_phase)
    timed("deployment", deployment_phase)
    model = build_llama(torch)
    serve = timed("serve", serve_phase, model)
    static = timed("serve_static", serve_static_phase, model)
    serve_q = timed("serve_quantized", serve_phase, model,
                    phase="serve_quantized", weight_format="mxfp4",
                    cache_dtype="fp8")
    timed("serve_disagg", serve_disagg_phase, model,
          {"serve": serve, "serve_quantized": serve_q})
    spec = timed("serve_spec", serve_spec_phase, model, serve["_streams"])
    timed("serve_spec_legacy", serve_spec_legacy_phase, model)
    tp = timed("serve_tp", serve_tp_phase)
    disagg_tp = timed("serve_disagg_tp", serve_disagg_tp_phase)
    served += [("serve", model.cfg, serve), ("serve_static", model.cfg, static),
               ("serve_quantized", model.cfg, serve_q)]
    # damps the model's deeper blocks in place: the last phase to use it
    served.append(("serve_spec_draft", model.cfg,
                   timed("serve_spec_draft", serve_spec_draft_phase, model)))
    # one model on the card at a time: each is freed (and the engines'
    # reference cycles collected) before the next is built
    for build, model_phase_fns in (
            (build_phi3, phi3_phases()), (build_danube, danube_phases()),
            (build_mamba2, mamba2_phases()), (build_hymba, hymba_phases()),
            (build_deepseek, mla_phases()), (build_scout, moe_phases()),
            (build_maverick, maverick_phases()),
            (build_vlm, {"serve_vlm": serve_vlm_phase})):
        del model
        gc.collect()
        torch.cuda.empty_cache()
        model = build(torch)
        for name, fn in model_phase_fns.items():
            served.append((name, model.cfg, timed(name, fn, model)))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    static_tp = timed("serve_static_tp", serve_static_tp_phase)
    dry = timed("dryrun", dryrun_phase)
    trained = {name: timed(name, fn) for name, fn in train_phases().items()}
    timed("train_tp", train_tp_phase)
    timed("serve_cli", serve_cli_phase)
    timed("examples", examples_phase)
    timed("check", check_phase)
    timed("check_window", check_window)
    timed("check_state", check_state)
    timed("check_moe", check_moe)
    timed("sim", sim_phase, served)
    kernel["launches"] = serve["kernel_launches"][kernel["name"]]
    scaled["launches"] = serve_q["kernel_launches"][scaled["name"]]
    vmm["launches"] = serve_q["kernel_launches"][vmm["name"]]
    flash["launches"] = static["kernel_launches"][flash["name"]]
    dense["launches"] = static["kernel_launches"][dense["name"]]
    exact["launches"] = spec["kernel_launches"][exact["name"]]
    kernels = [kernel, scaled, vmm, flash, dense, exact]
    # the kernels of the tensor-parallel path: their launches summed over
    # serve_tp's two ranks (each counts its own process's)
    for k in (kernel, scaled, vmm):
        k["launches_serve_tp"] = tp["kernel_launches_summed"].get(k["name"],
                                                                  0)
        if not k["launches_serve_tp"]:
            raise AssertionError(f"{k['name']} never launched in serve_tp")
    # the paged decode kernels on the disaggregated path across rank
    # groups: their launches summed over serve_disagg_tp's decode ranks
    for k in (kernel, scaled):
        k["launches_serve_disagg_tp"] = disagg_tp[
            "kernel_launches_summed"].get(k["name"], 0)
        if not k["launches_serve_disagg_tp"]:
            raise AssertionError(f"{k['name']} never launched in "
                                 f"serve_disagg_tp")
    # the same kernels on llama4-scout's path (its first session of each
    # phase): every one of them launched there too
    moe = {name: r for name, _, r in served}
    for k, phase in ((kernel, "serve_moe"), (scaled, "serve_moe_quantized"),
                     (vmm, "serve_moe_quantized"), (flash, "serve_moe_static"),
                     (dense, "serve_moe_static"), (exact, "serve_moe_spec")):
        r = moe[phase]
        k["launches_llama4_scout"] = r.get("continuous", r)[
            "kernel_launches"].get(k["name"], 0)
        if not k["launches_llama4_scout"]:
            raise AssertionError(f"{k['name']} never launched in {phase}")
    # the D 96 and D 80 variants: their launches on phi3's and danube's
    # paths (each serve phase's first session; counts cleared before it)
    for entry in headdims["entries"]:
        name, _, shape = entry["name"].partition(":")
        model = "phi3" if shape.startswith(("D96", "phi3")) else "danube"
        phase = {"flash_attention": "serve_{}_static",
                 "decode_attention": "serve_{}_static",
                 "paged_decode_attention": "serve_{}",
                 "paged_decode_attention_scaled": "serve_{}_quantized",
                 "paged_decode_attention_exact": "serve_{}_spec",
                 "mxfp4_vmm": "serve_{}_quantized"}[name].format(model)
        r = moe[phase]
        entry["launches"] = r.get("continuous", r)["kernel_launches"].get(
            name, 0)
        entry["launches_in"] = phase
        if not entry["launches"]:
            raise AssertionError(f"{entry['name']} never launched in {phase}")
    kernels += headdims["entries"]
    # the same kernels at hymba's shapes: their launches on hymba's paths
    for entry in hymba_kernels["entries"]:
        name = entry["name"].partition(":")[0]
        phase = {"flash_attention": "serve_hymba_static",
                 "decode_attention": "serve_hymba_static",
                 "paged_decode_attention": "serve_hymba",
                 "mxfp4_vmm": "serve_hymba_quantized"}[name]
        entry["launches"] = moe[phase]["kernel_launches"].get(name, 0)
        entry["launches_in"] = phase
        if not entry["launches"]:
            raise AssertionError(f"{entry['name']} never launched in {phase}")
    kernels += hymba_kernels["entries"]
    # flash at MLA's D 192 / Dv 128: its launches on deepseek's static path
    entry = flash_mla["entry"]
    entry["launches"] = moe["serve_mla_static"]["kernel_launches"].get(
        entry["name"].partition(":")[0], 0)
    entry["launches_in"] = "serve_mla_static"
    if not entry["launches"]:
        raise AssertionError(f"{entry['name']} never launched in "
                             f"serve_mla_static")
    kernels.append(entry)
    # the frontends' shapes: flash at D 80 non-causal from hubert's no-grad
    # forward, flash at rep 6 and the dense decode at rep 6 from serve_vlm
    for entry in frontends["entries"]:
        name = entry["name"]
        if name.startswith("flash_attention:D80"):
            entry["launches"] = trained["train_hubert"]["forward"][
                "flash_launches"].get("flash_attention", 0)
            entry["launches_in"] = "train_hubert (no-grad forward)"
        else:
            entry["launches"] = moe["serve_vlm"]["kernel_launches"].get(
                name.partition(":")[0], 0)
            entry["launches_in"] = "serve_vlm"
        if not entry["launches"]:
            raise AssertionError(f"{name} never launched in "
                                 f"{entry['launches_in']}")
    kernels += frontends["entries"]
    # flash at S 32768 and the dense decode at 32768 and 524288 entries:
    # their launches in the dryrun phase's cells
    for entry in dry_kernels["entries"]:
        name = entry["name"].partition(":")[0]
        cell = ("qwen3-14b:prefill_32k" if name == "flash_attention" else
                "hymba-1.5b:long_500k" if "512k" in entry["name"] else
                "qwen3-14b:decode_32k")
        entry["launches"] = dry["kernel_launches"][cell].get(name, 0)
        entry["launches_in"] = f"dryrun ({cell})"
        if not entry["launches"]:
            raise AssertionError(f"{entry['name']} never launched in "
                                 f"{entry['launches_in']}")
    kernels += dry_kernels["entries"]
    # the dense decode's partial mode: its launches on the two ranks of
    # serve_static_tp (every static decode layer on the mesh runs it)
    entry = static_tp["partial_kernel"]
    entry["launches_in"] = "serve_static_tp (both ranks)"
    kernels.append(entry)
    for k in kernels:
        if not all(math.isfinite(k[key]) for key in ("ms", "plain_ms",
                                                     "bound_ms")):
            raise AssertionError(f"non-finite kernel timing: {k}")
    print(f"total {time.monotonic() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
