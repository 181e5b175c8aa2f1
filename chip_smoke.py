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

``--only kernel_exact,check`` (any of the kernel phases, quantize, check)
builds and runs just those phases and prints no result line: for quick
checks of one kernel.

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
   and grouped) and E8M0 scales >= 128.  Each shape is timed beside its
   bound, a plain read of its bytes (``stream_read_ms``) and
   ``torch.matmul`` of x with the pre-dequantized bf16 weight (a different
   function: it streams 3.76x the bytes); both schedules are timed at M 8
   and 16 (the crossover); the headline is one llama3-8b layer at M 8 in
   the serve path's four launches, and the same layer at M 256 is printed
   beside the seven ``torch.matmul`` calls.
4. kernel_flash — the flash-attention kernel against its plain version at
   llama3-8b prefill geometry (H 32, KVH 8, D 128): B 1 and 8 at
   Sq = Skv = 1024, a ragged S 1000, an MHA (rep 1) case, a D 64 case
   (H 16, KVH 4, S 1000) and a rep 5 case (H 40, KVH 8, S 1000: the
   14B models' heads), causal and not, bf16 and f32 (bf16: each output
   row, one query in one head, within 2^-6 of its largest value, the worst
   row's share of that printed; f32: 1e-5).  Timed at B 8 and B 1
   (causal) and B 8 (not) beside
   its bound and ``F.scaled_dot_product_attention(is_causal=...,
   enable_gqa=True)`` (a yardstick the port never calls).
5. kernel_dense_decode — the dense-cache decode kernel against its plain
   version: B 1 and 8, caches of 2048 and 4096 tokens, ragged cur_len (one
   full, one of a single token), the legacy speculative engine's B 1 step
   (cur_len 288 of 512) and a D 64 case (H 16, KVH 4, B 8), the tail past
   cur_len poisoned with +-1e4, bf16 and f32 (bf16: each output within
   2^-7 of its magnitude plus 1e-4; f32: 1e-5).  Timed at B 8 with cur_len
   1088 of 2048 (the static serve's last step) and 4096 of 4096, and at
   B 1 with 288 of 512, beside its bound, SDPA on the cache sliced to
   cur_len, and a plain contiguous read of the same K/V bytes
   (``stream_read_ms``, a torch sum: the card's practical read rate under
   this timer).  Every timing line of the kernel phases carries
   ``kernel_over_library`` (its time over SDPA's, where there is one) and
   ``bound_over_kernel`` (its share of the roofline).
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
8. serve — llama3-8b at full width and depth (random bf16 weights from a
   seeded generator, ~16 GB) behind ``LLMEngine(backend="continuous")``
   answers 8 requests (prompts of 128-1024 tokens, two sharing a 512-token
   prefix, 4 greedy and 4 sampled, 64 new tokens each).  Every request must
   finish, the prefix index must be hit, the decode kernel must have run
   once per layer per decode step (bf16 and fp8: its tensor-core variant,
   ``kernels.VARIANT_LAUNCHES``), and a second identical session must
   reproduce every stream, greedy and sampled.  Eight decode-only steps of
   that second session are traced with ``torch.profiler``: device busy
   time per step, the device's idle share, time by kernel, and the host
   ops that take most host time.
9. serve_static — the same model behind ``LLMEngine(backend="static",
   max_len=2048)`` answers 8 prompts of 1024 tokens (4 greedy, 4 sampled,
   64 new tokens each); every request finishes, the flash kernel runs 32
   times (one prefill call) and the dense decode kernel 32 x 63 times, and
   a second identical call reproduces every stream.  A call with
   ``prompt_logprobs`` (two prompts, 4 new tokens) must launch the flash
   kernel 32 x 2 times (prefill and ``Model.forward``) and give finite
   scores <= 0.  Reports tokens/s, prefill s, decode step ms and peak GB,
   and the device time of 16 decode steps (a profiled 17-token call minus
   a 1-token one): busy ms per step, idle share, time by kernel.
10. serve_quantized — the continuous serve with ``weight_format="mxfp4"``
   and ``cache_dtype="fp8"``: the same checks as serve, and the MXFP4
   kernel must have run 4 x layers x (decode steps + prefill chunk calls)
   times (q/k/v and gate/up grouped; the decode schedule on decode steps,
   wgmma on prefill calls, ``kernels.VARIANT_LAUNCHES``) and the
   scale-pool decode kernel once per layer per decode step.
11. serve_spec — the serve phase's requests behind
   ``LLMEngine(backend="continuous", speculative=SpeculativeConfig(
   gamma=4))``, a self-draft: every request finishes, a second session
   reproduces every stream (greedy and sampled), the exact kernel runs 32
   times a window (the verify step) and the paged decode kernel 32 x 5
   (four draft steps and the backfill), both as tensor-core variants; then
   a short session over fp8 pools (4 requests, 32 new tokens) with the
   same launch checks on the scale-pool kernels reports its accepted
   proposals per window.  Reports tokens/s, ms and tokens
   per window, accepted proposals per window, the host's waits per window
   and, over 8 traced decode-only windows, device busy time and idle share;
   and, as a reading, how far each greedy stream agrees with the serve
   phase's (the exact and online kernels round apart, so a bf16 near-tie
   may flip).  Then ``LLMEngine(backend="speculative")`` with the model as
   its own draft, one greedy 256-token prompt, 32 new tokens: the dense
   decode kernel must run 32 x 2 (gamma + 1) x the windows the engine
   counts (draft steps with the backfill, and target steps) and the flash
   kernel 32 x 2 (the two prompt prefills), and a
   second call reproduces the stream (phase serve_spec_legacy).
12. check — a narrow 2-layer llama-shaped model in f32 served on the card
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
   into a flipped argmax now and then).

Output: the card's name and power limit early, one JSON line per phase,
the kernels line (six entries; ``launches`` from the serve phase that runs
each kernel), and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
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
# more geometries of the bf16 / code-pool tensor-core kernels: D 64 (GQA
# 4:1), rep 5 (qwen2.5-14b / qwen3-14b: 40 heads over 8), a page of 32, and
# rep 8 (the exact kernel's 64-row M tile at C 5)
TC_GEOMS = ((16, 4, 64, 16), (40, 8, 128, 16), (32, 8, 128, 32),
            (64, 8, 128, 16))
NEAR_TIE = 0.02       # top-2 logit gap below which card and CPU may differ


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


def bound(pos, window, B, dtype_name, itemsize, q_itemsize=None,
          scale_itemsize=0) -> tuple[float, str]:
    """Least time for the work: each live K/V token read once (codes and,
    for code pools, their per-token scales), q read and out written once,
    plus the live table entries and positions; ops are q.k and p.v (2 flops
    per multiply-add) at the pools' peak rate."""
    q_itemsize = itemsize if q_itemsize is None else q_itemsize
    lo = np.zeros_like(pos) if window is None else np.maximum(pos - window + 1, 0)
    tokens = int(np.sum(pos - lo + 1))
    pages = int(np.sum(pos // PAGE - lo // PAGE + 1))
    nbytes = (2 * tokens * KVH * (D * itemsize + scale_itemsize)
              + 2 * B * H * D * q_itemsize + 4 * pages + 4 * B)
    return roofline(nbytes, 4 * tokens * H * D, dtype_name)


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
        row["bound_ms"], row["bound_by"] = bound(pos, None, B, "bfloat16", 2)
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
            row["bound_ms"], row["bound_by"] = bound(
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
    tol = 1e-5          # relative to max |out|: f32 sums in another order
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
        per weight: f32 out within ``tol`` of max |out|, bf16 out == f32
        out rounded."""
        nonlocal err_max
        ps = [weight(k, n, scale) for n in ns]
        x = rows(m, k)
        ws = [(p.codes, p.scales) for p in ps]
        out = vmm_kernel.mxfp4_vmm_group(x, ws, variant=variant)
        out16 = vmm_kernel.mxfp4_vmm_group(x, ws, torch.bfloat16, variant)
        sched = vmm_kernel.schedule(m, k, ns, vmm_kernel._num_sms(0), variant)
        worst = 0.0
        for o, o16, p in zip(out, out16, ps):
            ref = mxfp4_vmm_ref(x, p.codes, p.scales)
            torch.cuda.synchronize()
            err = ((o - ref).abs().max() / ref.abs().max()).item()
            if not err <= tol:
                raise AssertionError(f"mxfp4_vmm ({sched.variant}) disagrees "
                                     f"with its plain version at M={m} K={k} "
                                     f"N={ns}: {err}")
            if not torch.equal(o16, o.to(torch.bfloat16)):    # same sums
                raise AssertionError(f"mxfp4_vmm's bf16 output is not its "
                                     f"f32 output rounded at {(m, k, ns)}")
            worst = max(worst, err)
        err_max = max(err_max, worst)
        checked.append({"M": m, "K": k, "N": list(ns),
                        "schedule": sched.variant, "grid": sched.grid,
                        "max_rel_err": worst})
        print(f"  mxfp4_vmm vs plain: M={m} K={k} N={list(ns)} "
              f"({sched.variant}, grid {sched.grid}"
              f"{', E8M0 scales >= 128' if scale > 1 else ''}): max rel err "
              f"{worst:.3g} (tolerance {tol})")

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

    def timed(m, k, ns, variant=None):
        ws = [(weight(k, n).codes, weight(k, n).scales) for n in ns]
        x = rows(m, k)
        return time_ms(torch, lambda: vmm_kernel.mxfp4_vmm_group(
            x, ws, torch.bfloat16, variant), flush)

    timings = []
    for (k, n), _ in PROJECTIONS.values():
        p = weight(k, n)
        w_bf16 = formats.dequantize_mxfp4(p, torch.bfloat16)
        for m in VMM_ROWS:
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
            row["kernel_over_bf16_matmul"] = row["ms"] / row["bf16_matmul_ms"]
            timings.append(ratios(row))
            print("  timing:", json.dumps(row))
        del w_bf16
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
            "checked": checked, "timings": timings}


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


def flash_bound(B, Sq, Skv, h, kvh, causal, itemsize, dtype_name, d=D):
    """q, k, v read once and out written once; 4 flops (q.k and p.v) per
    visible (query, key) pair and head dim, at the inputs' peak rate."""
    if causal:
        pairs = sum(min(i + 1, Skv) for i in range(Sq))
    else:
        pairs = Sq * Skv
    nbytes = itemsize * d * B * (2 * Sq * h + 2 * Skv * kvh)
    return roofline(nbytes, 4 * B * h * d * pairs, dtype_name)



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
             (2, 1000, 40, 8, D)]
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


def dense_bound(cur_len, B, itemsize, dtype_name):
    """Each valid K/V token read once, q read and out written once, cur_len
    read; 4 flops per valid token, head and head dim."""
    tokens = int(np.sum(cur_len))
    nbytes = 2 * tokens * KVH * D * itemsize + 2 * B * H * D * itemsize + 4 * B
    return roofline(nbytes, 4 * tokens * H * D, dtype_name)


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
        # the legacy speculative engine's step (B 1, max_len 512), and
        # D 64 (GQA 4:1)
        cases += [(1, 512, np.array([288]), H, KVH, D),
                  (8, 2048, rng.integers(1, 2049, 8), 16, 4, 64)]
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
    # tokens in a 2048-token cache), a full 4096-token cache, and the
    # legacy speculative engine's B 1 step at 288 of 512
    for B, S, ctx in ((8, 2048, 1088), (8, 4096, 4096), (1, 512, 288)):
        cur_len = np.full(B, ctx)
        q, k, v, cl = dense_case(torch, gen, B, S, torch.bfloat16, cur_len,
                                 dev)
        q4 = q[:, :, None, :]
        ks = k[:, :ctx].transpose(1, 2)            # the valid prefix
        vs = v[:, :ctx].transpose(1, 2)
        row = {"B": B, "S": S, "cur_len": ctx, "cache": "bfloat16",
               "ms": time_ms(torch, lambda: dense_kernel.decode_attention(
                   q, k, v, cl), flush),
               "plain_ms": time_ms(torch, lambda: decode_attention_ref(
                   q, k, v, cl), flush),
               "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                   q4, ks, vs, enable_gqa=True), flush)}
        row["bound_ms"], row["bound_by"] = dense_bound(cur_len, B, 2,
                                                       "bfloat16")
        # the card's practical read rate under this timer: one contiguous
        # read (a sum) of the K/V bytes the kernel must read
        row["stream_read_ms"] = stream_read_ms(torch, 2 * B * ctx * KVH * D * 2,
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


def exact_bound(start, C, B, window, itemsize, q_itemsize, dtype_name,
                scale_itemsize=0):
    """Least time for the work: the live K/V tokens of each slot read once
    for all C queries (codes and their scales for code pools), q read and
    out written once, the live table entries and the starts; ops are q.k
    and p.v, 4 flops per visible (query, key) pair, head and head dim."""
    last = start + C - 1
    lo = (np.zeros_like(start) if window is None
          else np.maximum(start - window + 1, 0))
    tokens = int(np.sum(last - lo + 1))
    pages = int(np.sum(last // PAGE - lo // PAGE + 1))
    visible = 0
    for j in range(C):
        p = start + j
        first = np.zeros_like(p) if window is None else np.maximum(p - window + 1, 0)
        visible += int(np.sum(p - first + 1))
    nbytes = (2 * tokens * KVH * (D * itemsize + scale_itemsize)
              + 2 * B * C * H * D * q_itemsize + 4 * pages + 4 * B)
    return roofline(nbytes, 4 * visible * H * D, dtype_name)


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
        row["bound_ms"], row["bound_by"] = exact_bound(start, C, B, None, 2,
                                                       2, "bfloat16")
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
# 7. quantize phase: the card's bits are the CPU's
# ---------------------------------------------------------------------------


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
# 8, 10, 11. continuous serve phases (bf16; mxfp4 + fp8; speculative)
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


def serve_session(llm, prompts, sps, on_decode_step=None):
    """One session through the incremental interface.  Request 7 is added
    once request 3 has its first token, so 3's prompt blocks are indexed
    and 7 shares them.  ``on_decode_step`` runs after every step taken once
    all 8 requests have their first token (decode-only steps).  Returns
    (streams, finished outputs, stats, decode-only step seconds)."""
    llm.reset()
    late = SHARED[1]
    for i, (p, sp) in enumerate(zip(prompts, sps)):
        if i != late:
            llm.add_request(p, sp, rid=i)
    streams = {i: [] for i in range(len(prompts))}
    finished = {}
    decode_steps = []
    added_late = False
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
        if not added_late and streams[SHARED[0]]:
            llm.add_request(prompts[late], sps[late], rid=late)
            added_late = True
    return streams, finished, llm.stats(), decode_steps


PROFILE = dict(wait=4, warmup=2, active=8, repeat=1)   # decode-only steps
# the host's waits for the device (as scripts/host_syncs.py counts them): a
# synchronize, or a host-to-device copy from pageable memory
HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "Memcpy HtoD (Pageable -> Device)")


def device_breakdown(prof, step_s: float) -> dict:
    """Device time per profiled decode-only step by kernel name, the
    device's idle share of a step, and the host ops that take most host
    time under the tracer.  One stream, so kernel times add up to busy
    time; the step's wall time ``step_s`` is the median decode step of the
    untraced first session (host tracing slows every step of the traced
    one, so its own wall times would overstate idleness)."""
    from torch.autograd import DeviceType

    times, host = {}, {}
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", 0) or 0     # microseconds
        host[evt.key] = getattr(evt, "self_cpu_time_total", 0) or 0
        # device activity only (kernels, copies, memsets): the host ops
        # carry the device time of what they launched, and each profiler
        # step is also recorded as a device-side range spanning its kernels
        if (t > 0 and getattr(evt, "device_type", None) == DeviceType.CUDA
                and not evt.key.startswith("ProfilerStep")):
            times[evt.key] = times.get(evt.key, 0) + t
    n = PROFILE["active"]
    waits = sum(evt.count for evt in prof.key_averages()
                if evt.key in HOST_WAITS)
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
            "top_kernels_ms_per_step": {k[:70]: t / 1e3 / n for k, t in top}}


def build_llama(torch):
    """Full-size llama3-8b (32 layers, random bf16 weights from a seed)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    cfg = get_config("llama3-8b")
    t0 = time.monotonic()
    model = Model(cfg, device="cuda").init(seed=0)
    torch.cuda.synchronize()
    print(f"serve: llama3-8b {cfg.n_layers} layers, "
          f"{model.param_count() / 1e9:.2f} B params bf16, random init "
          f"{time.monotonic() - t0:.1f} s")
    return model


def serve_phase(torch, model, phase: str = "serve", **engine_kw) -> dict:
    """Serve the request mix twice through ``LLMEngine`` (``engine_kw``:
    ``weight_format``, ``cache_dtype``) and check streams and launches."""
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
                    page_size=16, max_len=2048, prefill_chunk=256, **engine_kw)
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    prompts, sps = serve_requests(SamplingParams, cfg.vocab_size)

    LAUNCHES.clear()
    VARIANT_LAUNCHES.clear()
    streams, finished, stats, decode_steps = serve_session(llm, prompts, sps)
    torch.cuda.synchronize()
    launches = {k: v for k, v in LAUNCHES.items() if v}
    variants = {k: v for k, v in VARIANT_LAUNCHES.items() if v}

    for i in range(len(prompts)):
        o = finished.get(i)
        if o is None or o.finish_reason != "length" or len(o.token_ids) != 64:
            raise AssertionError(f"request {i} did not finish with 64 tokens: "
                                 f"{o}")
        if o.token_ids != streams[i]:
            raise AssertionError(f"request {i}: streamed deltas differ from "
                                 f"the final token_ids")
        if not all(0 <= t < cfg.vocab_size for t in o.token_ids):
            raise AssertionError(f"request {i}: token outside the vocabulary")
    if stats.prefix_hit_tokens < 512 - PAGE:
        raise AssertionError(f"prefix index not hit: {stats.prefix_hit_tokens}")
    decode_kernel = (NAME_SCALED if engine_kw.get("cache_dtype") in
                     ("fp8", "int8") else NAME)
    want = {decode_kernel: cfg.n_layers * stats.steps}
    # bf16 activations over bf16 or fp8 pools: the tensor-core kernel
    want_variants = {f"{decode_kernel}:tensor_core": want[decode_kernel]}
    if engine_kw.get("weight_format") == "mxfp4":
        # 4 launches a layer (q/k/v grouped, o, gate/up grouped, down):
        # decode steps (M = the slots) on the decode schedule, prefill
        # chunk calls (M = rows x 256) on wgmma
        want[VMM] = 4 * cfg.n_layers * (stats.steps + stats.prefill_calls)
        want_variants[f"{VMM}:decode"] = 4 * cfg.n_layers * stats.steps
        want_variants[f"{VMM}:wgmma"] = 4 * cfg.n_layers * stats.prefill_calls
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
                                            on_decode_step=prof.step)
    breakdown = device_breakdown(prof, float(np.median(decode_steps)))
    for i in range(len(prompts)):
        if again[i] != streams[i]:
            kind = "greedy" if sps[i].is_greedy else "sampled"
            raise AssertionError(f"{kind} request {i} did not reproduce "
                                 f"its stream on the re-run")
    ttft = stats.latency_quantiles("ttft")
    result = {"phase": phase, **{k: str(v) for k, v in engine_kw.items()},
              "requests": len(prompts),
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
              "engine_setup_s": setup_s,
              "served_weight_gb": serve_weight_bytes(
                  model, engine_kw.get("weight_format")) / 1e9,
              "rerun_identical": True, "rerun_wall_s": stats2.wall,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "profiled_decode_steps": breakdown, "_streams": streams}
    del llm
    torch.cuda.empty_cache()
    return result


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


# ---------------------------------------------------------------------------
# 9. static serve phase
# ---------------------------------------------------------------------------

STATIC_PROMPT, STATIC_NEW = 1024, 64


def device_time_by_kernel(torch, fn) -> dict:
    """Device time (ms) of everything ``fn`` ran on the card, by kernel
    name, from one ``torch.profiler`` trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    times = {}
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", 0) or 0     # microseconds
        if t > 0 and getattr(evt, "device_type", None) == DeviceType.CUDA:
            times[evt.key] = times.get(evt.key, 0) + t / 1e3
    return times


def serve_static_phase(torch, model) -> dict:
    """``LLMEngine(backend="static")`` answers 8 prompts of 1024 tokens (4
    greedy, 4 sampled) with 64 new tokens each, twice (the re-run must
    reproduce every stream), then scores two prompts
    (``prompt_logprobs``).  The flash kernel must run once per layer per
    prefill or forward call and the dense decode kernel once per layer per
    decode step.  A profiled call of 17 new tokens minus one of 1 gives the
    device time of 16 decode steps."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.decode_attention.kernel import NAME as DENSE
    from repro_torch.kernels.flash_attention.kernel import NAME as FLASH
    from repro_torch.runtime.llm import LLMEngine
    from repro_torch.runtime.sampling import SamplingParams

    cfg = model.cfg
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, STATIC_PROMPT) for _ in range(8)]
    sps = [SamplingParams(max_tokens=STATIC_NEW) if i % 2 == 0 else
           SamplingParams(max_tokens=STATIC_NEW, temperature=0.8, top_p=0.9,
                          top_k=40, seed=2000 + i) for i in range(8)]
    torch.cuda.reset_peak_memory_stats()
    llm = LLMEngine(model, backend="static", device="cuda", max_len=2048)
    cache_gb = 2 * cfg.n_layers * 8 * 2048 * cfg.n_kv_heads * cfg.hd * 2 / 1e9

    def want_launches(calls, steps):
        return {FLASH: cfg.n_layers * calls, DENSE: cfg.n_layers * steps}

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
                             f"steps, {cfg.n_layers} layers)")
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
        if plp.shape != (STATIC_PROMPT - 1,) or not (
                np.isfinite(plp).all() and (plp <= 0).all()):
            raise AssertionError(f"prompt_logprobs of request {o.rid}: shape "
                                 f"{plp.shape}, finite {np.isfinite(plp).all()}")

    # device time of 16 decode steps: a 17-token call minus a 1-token one
    one = [dataclasses.replace(sp, max_tokens=1) for sp in sps]
    many = [dataclasses.replace(sp, max_tokens=17) for sp in sps]
    t_one = device_time_by_kernel(torch, lambda: llm.generate(prompts, one))
    t_many = device_time_by_kernel(torch, lambda: llm.generate(prompts, many))
    per_step = {k: (t_many.get(k, 0.0) - t_one.get(k, 0.0)) / 16
                for k in set(t_many) | set(t_one)}
    busy = sum(per_step.values())
    step_ms = 1e3 * outs[0].metrics["tpot"]
    top = sorted(per_step.items(), key=lambda kv: -kv[1])[:8]
    result = {"phase": "serve_static", "requests": len(prompts),
              "prompt_tokens": STATIC_PROMPT, "new_tokens": 8 * STATIC_NEW,
              "tokens_per_s": 8 * STATIC_NEW / wall, "wall_s": wall,
              "prefill_s": outs[0].metrics["ttft"],
              "decode_step_ms": step_ms,
              "kernel_launches": launches,
              "kernel_launches_scored_call": launches_scored,
              "rerun_identical": True, "dense_cache_gb": cache_gb,
              "peak_mem_gb": peak_gb,
              "profiled_decode_steps": {
                  "steps": 16, "device_busy_ms_per_step": busy,
                  "device_idle_share": 1 - busy / step_ms,
                  "decode_attention_ms_per_step": sum(
                      t for k, t in per_step.items() if "dense_decode" in k),
                  "prefill_flash_ms": t_one.get(next(
                      (k for k in t_one if "flash_fwd" in k), ""), 0.0),
                  "prefill_device_ms": sum(t_one.values()),
                  "top_kernels_ms_per_step": {k[:70]: t for k, t in top}}}
    del llm
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# 12. check phase: kernel path on the card == plain path on the CPU
# ---------------------------------------------------------------------------


def cpu_top2_gap(torch, model, prompt, tokens, cache_dtype) -> float:
    """Gap between the two largest logits the CPU model gives after
    ``prompt + tokens`` (one prefill chunk into fresh pools)."""
    toks = torch.as_tensor(np.concatenate([prompt, tokens]), dtype=torch.int64)
    n = len(toks)
    n_blocks = -(-n // PAGE)
    pools = model.init_paged_cache(n_blocks + 1, PAGE, dtype=cache_dtype)
    table = torch.arange(1, n_blocks + 1, dtype=torch.int32)[None]
    logits = model.prefill_chunk_paged(toks[None], pools, table,
                                       torch.zeros(1, dtype=torch.int32),
                                       torch.full((1,), n, dtype=torch.int32))
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
    return {"phase": "check", "model": "llama3-8b widths cut to d_model 512, "
            "2 layers, f32", "requests": len(prompts),
            "near_tie_gap": NEAR_TIE, "cases": results}


KERNEL_PHASES = ("kernel", "kernel_scaled", "kernel_mxfp4", "kernel_flash",
                 "kernel_dense_decode", "kernel_exact", "quantize")


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=None,
                    help="comma-separated kernel phases to run after the "
                         f"build ({', '.join(KERNEL_PHASES)}) or 'check'; "
                         "a partial run prints no result line")
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
              "quantize": quantize_phase, "check": check_phase}
    if args.only is not None:
        for name in args.only.split(","):
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
    timed("quantize", quantize_phase)
    model = build_llama(torch)
    serve = timed("serve", serve_phase, model)
    static = timed("serve_static", serve_static_phase, model)
    serve_q = timed("serve_quantized", serve_phase, model,
                    phase="serve_quantized", weight_format="mxfp4",
                    cache_dtype="fp8")
    spec = timed("serve_spec", serve_spec_phase, model, serve["_streams"])
    timed("serve_spec_legacy", serve_spec_legacy_phase, model)
    del model
    torch.cuda.empty_cache()
    timed("check", check_phase)
    kernel["launches"] = serve["kernel_launches"][kernel["name"]]
    scaled["launches"] = serve_q["kernel_launches"][scaled["name"]]
    vmm["launches"] = serve_q["kernel_launches"][vmm["name"]]
    flash["launches"] = static["kernel_launches"][flash["name"]]
    dense["launches"] = static["kernel_launches"][dense["name"]]
    exact["launches"] = spec["kernel_launches"][exact["name"]]
    kernels = [kernel, scaled, vmm, flash, dense, exact]
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
