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
deployment, check, check_mla, check_moe, check_window, check_state; serve and
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
serve_moe_maverick on a llama4-maverick built first; serve_disagg on a
llama3-8b built first, after the two colocated phases it is compared
with; serve_cli, which builds its own models; sim last, over the serve
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
   without (its 3 global layers), dense decode over a wrapped 1024-entry
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
   mamba2-370m at full size (48 layers of the Mamba2 SSD mixer, d_model
   1024, state 128, 0.74 GB): continuous bf16 on the serve phase's mix
   (no prefix hit: a pure-state model has no full space; its per-slot
   state pools, 50.99 MB a slot, held against ``state_bytes_per_slot``;
   a scored prompt against ``Model.forward``) and static 8 x 1024.  The
   reference computes the mixer in plain jnp, so no kernel may launch;
   the traced steps split device time by the ``ssm_mixer`` range.
13e. serve_hymba, serve_hymba_static, serve_hymba_quantized — after
   mamba2 is freed, hymba-1.5b at full size (32 layers of GQA attention,
   25 heads over 5 at D 64, beside a Mamba2 mixer of 50 heads, state 16;
   global at layers 0, 16 and 31, a 1024-token window elsewhere; 3.3 GB):
   continuous bf16 on ``HYMBA_MIX`` (2 prompts of 3072 tokens and 2 of
   1500 with 256 new, past the window, whose rings wrap while decoding; 4
   of 512 with 64 new, two sharing a 384-token prefix; page 16, chunk
   256): the
   windowed layers' ring (``RingWatch``), the prefix pages shared while
   the prompt is recomputed (``recompute_shared``: no prompt token
   skipped), the state pools, a 3072-token scored prompt; static 2 x
   3072; the continuous mix with mxfp4 attention and MLP projections over
   bf16 pools (128 ``mxfp4_vmm`` launches a call).
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
21b. serve_cli — ``repro_torch.launch.serve.main`` in this process:
   ``--no-reduced --arch llama3-8b --continuous --disaggregate 1:1`` (all
   32 layers, 4 requests of 256 tokens, 16 new) and ``--fleet --calibrate``
   (a 2-layer llama3-8b engine timed into a latency table in a temporary
   directory, and the simulator cross-checked against its replay); each
   must return 0.
22. sim — host only: the paper's H100 model (``sim.gpu_model``) for each
   serve phase's config as served, beside its measured wall and
   device-busy decode step, and ``iso_tdp_comparison`` for llama3-405b
   and llama4-scout, printed as modeled.

Output: the card's name and power limit early, one JSON line per phase,
the kernels line (the six kernels at llama3-8b's shapes, then their D 96
and D 80 variants and ``mxfp4_vmm`` at phi3's and danube's projections,
then the same kernels at hymba's shapes, then flash at D 192 / Dv 128;
``launches`` from the serve phase that runs each, on its own model), and
last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

PEAK_BYTES_PER_S = 3.35e12                 # H100 SXM HBM3
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12,   # dense, no sparsity
                  "fp8": 1979e12, "int8": 1979e12}
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


def time_ms(torch, fn, flush, iters=30) -> float:
    """Median device time of ``fn`` over ``iters`` launches, each after a
    512 MB memset that evicts the 50 MB L2 (the serve path meets every
    layer's pages cold) and keeps the device busy while the host enqueues."""
    for _ in range(3):
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


def roofline(nbytes: int, ops: int, ops_type: str) -> tuple[float, str]:
    """The larger of bytes over the memory rate and ops over the peak rate
    of their type, in ms, and which of the two it is."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[ops_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ratios(row: dict) -> dict:
    """The timing line's yardsticks that survive a change of card: the
    kernel's time over the library call's, and the bound over the
    kernel's time (its share of the roofline)."""
    if row.get("library_ms"):
        row["kernel_over_library"] = row["ms"] / row["library_ms"]
    row["bound_over_kernel"] = row["bound_ms"] / row["ms"]
    return row


def paged_bound(pos, window, B, dtype_name, itemsize, q_itemsize=None,
                scale_itemsize=0, C=1, geom=GEOM) -> tuple[float, str]:
    """Least time for the work of a paged decode (C 1) or verify (C > 1)
    launch: each slot's live K/V tokens read once for all C queries (codes
    and, for code pools, their per-token scales), q read and out written
    once, plus the live table entries and positions; ops are q.k and p.v,
    4 flops per visible (query, key) pair, head and head dim, at the
    pools' peak rate."""
    h, kvh, d, page = geom
    q_itemsize = itemsize if q_itemsize is None else q_itemsize
    last = pos + C - 1
    lo = np.zeros_like(pos) if window is None else np.maximum(pos - window + 1, 0)
    tokens = int(np.sum(last - lo + 1))
    pages = int(np.sum(last // page - lo // page + 1))
    visible = 0
    for j in range(C):
        p = pos + j
        first = (np.zeros_like(p) if window is None
                 else np.maximum(p - window + 1, 0))
        visible += int(np.sum(p - first + 1))
    nbytes = (2 * tokens * kvh * (d * itemsize + scale_itemsize)
              + 2 * B * C * h * d * q_itemsize + 4 * pages + 4 * B)
    return roofline(nbytes, 4 * visible * h * d, dtype_name)


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
                                                      2)
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
                pos, None, B, cache_dtype, 1, q_itemsize=2, scale_itemsize=4)
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


def vmm_bytes(m: int, k: int, ns) -> int:
    """Codes (K/2 x N) and scales (K/32 x N) of each weight and bf16 x read
    once, bf16 outputs written once (the serve path's output)."""
    return sum(k * n // 2 + k * n // 32 + 2 * m * n for n in ns) + 2 * m * k


def vmm_bound(m: int, k: int, ns) -> tuple[float, str]:
    """``vmm_bytes`` against 2 M K N operations on bf16 tensor cores."""
    return roofline(vmm_bytes(m, k, ns), 2 * m * k * sum(ns), "bfloat16")


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


def window_pairs(Sq, Skv, causal, window) -> int:
    """Visible (query, key) pairs of one head: keys j <= i when causal,
    j > i - window with a window."""
    i = np.arange(Sq)
    hi = np.minimum(i + 1, Skv) if causal else np.full(Sq, Skv)
    lo = np.zeros(Sq, np.int64) if window is None else np.maximum(i - window + 1, 0)
    return int(np.maximum(hi - lo, 0).sum())


def flash_bound(B, Sq, Skv, h, kvh, causal, itemsize, dtype_name, d=D,
                window=None, dv=None):
    """q, k, v read once and out written once; 2 flops per visible (query,
    key) pair (``window_pairs``) and head dim of q.k (D) and of p.v (Dv,
    D unless given), at the inputs' peak rate."""
    dv = d if dv is None else dv
    nbytes = itemsize * B * (Sq * h * (d + dv) + Skv * kvh * (d + dv))
    return roofline(nbytes, 2 * B * h * (d + dv) * window_pairs(
        Sq, Skv, causal, window), dtype_name)


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
            B, S, S, H, KVH, causal, 2, "bfloat16")
        timings.append(ratios(row))
        print("  timing:", json.dumps(row))
        del q, k, v, qt, kt, vt
    qf, kf, vf = (t.float() for t in inputs(8, 1024, H, KVH, torch.bfloat16))
    f32 = {"B": 8, "S": 1024, "causal": True, "dtype": "float32",
           "ms": time_ms(torch, lambda: flash_kernel.flash_attention(
               qf, kf, vf, causal=True), flush)}
    f32["bound_ms"], f32["bound_by"] = flash_bound(8, 1024, 1024, H, KVH,
                                                   True, 4, "float32")
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


def dense_bound(cur_len, B, itemsize, dtype_name, h=H, kvh=KVH, d=D):
    """Each valid K/V token read once, q read and out written once, cur_len
    read; 4 flops per valid token, head and head dim."""
    tokens = int(np.sum(cur_len))
    nbytes = 2 * tokens * kvh * d * itemsize + 2 * B * h * d * itemsize + 4 * B
    return roofline(nbytes, 4 * tokens * h * d, dtype_name)


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
                                                       "bfloat16", h, kvh)
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
                                                       "bfloat16", 2, C=C)
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


def vmm_launches_per_call(model) -> int:
    """MXFP4 launches of one decode step or prefill chunk call: per layer
    one for the attention's input projections (GQA: q/k/v grouped; MLA:
    wq) and one for its output projection, and for a dense MLP one for
    gate/up (grouped) and one for down.  MoE experts and the SSM mixer are
    not quantized.  llama3-8b: 4 x 32 = 128; deepseek-v2-lite-16b: 4 + 2 x
    26 = 56; hymba-1.5b: 4 x 32 = 128; mamba2-370m: 0."""
    return sum(0 if blk.kind == "ssm" else 2 + (0 if blk.is_moe else 2)
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
    return {"phase": "check", "model": "llama3-8b widths cut to d_model 512, "
            "2 layers, f32; deepseek-v2-lite-16b cut to d_model 512, 2 "
            "layers, 8 experts, f32", "requests": len(prompts),
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


def build_mamba2(torch):
    return build_full(torch, MAMBA2)


def build_hymba(torch):
    return build_full(torch, HYMBA)


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
    ``serve_phase``: its 29 windowed layers keep their pages in a ring
    space (``RingWatch``), its 3 global layers in the full space, where
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
                             + ("29 windowed layers" if window
                                else "3 global layers") + ")",
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


KERNEL_PHASES = ("kernel", "kernel_scaled", "kernel_mxfp4", "kernel_flash",
                 "kernel_dense_decode", "kernel_exact", "kernel_headdims",
                 "kernel_hymba", "kernel_flash_mla", "quantize")


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=None,
                    help="comma-separated phases to run after the build "
                         f"({', '.join(KERNEL_PHASES)}, deployment, check, "
                         "check_mla, check_moe, check_window, check_state, "
                         "serve_cli, or, on a llama3-8b built "
                         "first, serve, serve_disagg and serve_spec_draft, "
                         "on a "
                         "deepseek-v2-lite-16b built first, "
                         f"{', '.join(mla_phases())}, on mamba2-370m "
                         f"{', '.join(mamba2_phases())}, on hymba-1.5b "
                         f"{', '.join(hymba_phases())}, on llama4-scout at "
                         f"{SCOUT_LAYERS} layers, {', '.join(moe_phases())}, "
                         "on llama4-maverick at one period, "
                         "serve_moe_maverick; then sim over the serve "
                         "phases run); a partial run prints no result line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this smoke test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

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
              "quantize": quantize_phase, "deployment": deployment_phase,
              "check": check_phase,
              "check_mla": lambda t: {"phase": "check_mla",
                                      "cases": check_mla(t)},
              "check_moe": check_moe, "check_window": check_window,
              "check_state": check_state, "serve_cli": serve_cli_phase}
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
                       hymba_phases().items()}}
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
            (build_maverick, maverick_phases())):
        del model
        gc.collect()
        torch.cuda.empty_cache()
        model = build(torch)
        for name, fn in model_phase_fns.items():
            served.append((name, model.cfg, timed(name, fn, model)))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    timed("serve_cli", serve_cli_phase)
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
