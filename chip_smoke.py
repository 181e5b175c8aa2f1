"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card (it exits
non-zero, printing no result, without one).  Phases, each of which fails
the run if it fails:

1. kernel — build every CUDA kernel of the serve path from the repo's
   sources (``nvcc`` into ``.torch_ext/``) and hold it against its plain
   PyTorch version on the card at llama3-8b decode shapes (H 32, KVH 8,
   D 128, page 16; bf16 and f32 pools; B 1 and 8; ragged positions up to
   4096, dead pages on a poisoned scratch page, a sliding window).  Then
   time kernel, plain version and ``F.scaled_dot_product_attention`` on the
   gathered dense view (a yardstick the port never calls) at B 8 with 1024
   and 4096 context, with CUDA events and the L2 cache flushed between
   launches.
2. serve — llama3-8b at full width and depth (random bf16 weights from a
   seeded generator, ~16 GB) behind ``LLMEngine(backend="continuous")``
   answers 8 requests (prompts of 128-1024 tokens, two sharing a 512-token
   prefix, 4 greedy and 4 sampled, 64 new tokens each).  Every request must
   finish, the prefix index must be hit, the decode kernel must have run
   once per layer per decode step, and a second identical session must
   reproduce every stream, greedy and sampled.  Eight decode-only steps of
   that second session are traced with ``torch.profiler``: device busy
   time per step, the device's idle share, time by kernel.
3. check — a narrow 2-layer llama-shaped model in f32 served on the card
   (kernel path) and on the CPU (plain path) from the same weights must
   emit the same token streams.

Output: the card's name and power limit early, one JSON line per phase,
the kernels line, and last ``{"ok": true, "device": {...}}``.
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
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}   # dense, no sparsity
KERNEL_SOURCE = "src/repro_torch/kernels/decode_attention/csrc/paged_decode.cu"
REPLACES = "src/repro/kernels/decode_attention/paged_kernel.py:150"
H, KVH, D, PAGE = 32, 8, 128, 16           # llama3-8b decode geometry


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()
    return out.splitlines()[0]


# ---------------------------------------------------------------------------
# 1. kernel phase
# ---------------------------------------------------------------------------


def paged_case(torch, rng, B, n_blocks, dtype, pos, dev):
    """Random pools with a poisoned scratch page 0, per-row permuted page
    tables whose entries past each row's position point at page 0."""
    P = 1 + B * n_blocks
    table = rng.permutation(np.arange(1, P)).reshape(B, n_blocks)
    live = np.arange(n_blocks)[None, :] <= (pos // PAGE)[:, None]
    table = np.where(live, table, 0).astype(np.int32)
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    kp = torch.randn((P, PAGE, KVH, D), generator=gen, device=dev).to(dtype)
    vp = torch.randn((P, PAGE, KVH, D), generator=gen, device=dev).to(dtype)
    kp[0], vp[0] = 1e4, -1e4
    q = torch.randn((B, H, D), generator=gen, device=dev).to(dtype)
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


def bound(pos, window, B, dtype_name, itemsize) -> tuple[float, str]:
    """Least time for the work: each live K/V token read once, q read and
    out written once, plus the live table entries and positions; ops are
    q.k and p.v (2 flops per multiply-add) at the inputs' peak rate."""
    lo = np.zeros_like(pos) if window is None else np.maximum(pos - window + 1, 0)
    tokens = int(np.sum(pos - lo + 1))
    pages = int(np.sum(pos // PAGE - lo // PAGE + 1))
    nbytes = (2 * tokens * KVH * D * itemsize + 2 * B * H * D * itemsize
              + 4 * pages + 4 * B)
    ops = 4 * tokens * H * D
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(torch) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels._build import library_path
    from repro_torch.kernels.decode_attention import paged_kernel
    from repro_torch.kernels.decode_attention.ref import (
        gather_pages, paged_decode_attention_ref, paged_valid_mask,
    )

    dev = torch.device("cuda")
    t0 = time.monotonic()
    paged_kernel._lib()
    log = library_path("paged_decode", [paged_kernel.SOURCE]).parent / "build.log"
    print(f"kernel build: {time.monotonic() - t0:.1f} s "
          f"(-Xptxas -v report in {log})")
    for line in log.read_text().splitlines():
        if "Used" in line or "spill" in line:
            print("  ptxas:", line.strip())

    rng = np.random.default_rng(0)
    tol = {"float32": 1e-5, "bfloat16": 2e-2}
    errs = {}
    n_blocks = 4096 // PAGE + 4
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        for B, window in ((1, None), (8, None), (8, 1000), (8, 1)):
            pos = rng.integers(0, 4096, B)
            pos[0] = 4095 if B == 1 else PAGE + PAGE // 2    # mid-page
            q, kp, vp, table, p = paged_case(torch, rng, B, n_blocks, dtype,
                                             pos, dev)
            out = paged_kernel.paged_decode_attention(q, kp, vp, table, p,
                                                      window=window)
            ref = paged_decode_attention_ref(q, kp, vp, table, p,
                                             window=window)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            print(f"  kernel vs plain: {dtype_name} pools B={B} "
                  f"window={window}: max abs err {err:.3g} "
                  f"(tolerance {tol[dtype_name]})")
            if not err <= tol[dtype_name]:
                raise AssertionError(f"paged_decode_attention disagrees with "
                                     f"its plain version: {err} > "
                                     f"{tol[dtype_name]}")
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
        k_d = torch.repeat_interleave(k_d, H // KVH, dim=1).contiguous()
        v_d = torch.repeat_interleave(v_d, H // KVH, dim=1).contiguous()
        mask = paged_valid_mask(table, PAGE, p)[:, None, None, :]
        q4 = q[:, :, None, :]
        row = {"ctx": ctx, "B": B, "pools": "bfloat16",
               "ms": time_ms(torch, lambda: paged_kernel.paged_decode_attention(
                   q, kp, vp, table, p), flush),
               "plain_ms": time_ms(torch, lambda: paged_decode_attention_ref(
                   q, kp, vp, table, p), flush),
               "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                   q4, k_d, v_d, attn_mask=mask), flush)}
        row["bound_ms"], row["bound_by"] = bound(pos, None, B, "bfloat16", 2)
        timings.append(row)
        print("  timing:", json.dumps(row))
    del flush
    head = timings[0]
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": REPLACES,
            "launches": None, "max_abs_err": errs["bfloat16"],
            "max_abs_err_f32": errs["float32"],
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "us": head["ms"] * 1e3, "ref_us": head["plain_ms"] * 1e3,
            "sdpa_us": head["library_ms"] * 1e3, "timings": timings}


# ---------------------------------------------------------------------------
# 2. serve phase
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


def device_breakdown(prof, step_s: float) -> dict:
    """Device time per profiled decode-only step by kernel name, and the
    device's idle share of a step.  One stream, so kernel times add up to
    busy time; the step's wall time ``step_s`` is the median of the same
    session's steps outside the profiler's window (tracing slows the host
    side, so the traced steps' own wall time would overstate idleness)."""
    times = {}
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", 0) or 0     # microseconds
        if t > 0:
            times[evt.key] = times.get(evt.key, 0) + t
    n = PROFILE["active"]
    busy = sum(times.values()) / 1e6
    if busy == 0:
        return {"device_time": "not measured (the profiler saw no device "
                               "activity)", "step_ms": 1e3 * step_s}
    top = sorted(times.items(), key=lambda kv: -kv[1])[:8]
    decode = sum(t for k, t in times.items() if "paged_decode" in k) / 1e6
    return {"steps": n, "step_ms": 1e3 * step_s,
            "device_busy_ms_per_step": 1e3 * busy / n,
            "device_idle_share": 1 - busy / n / step_s,
            "decode_attention_ms_per_step": 1e3 * decode / n,
            "top_kernels_ms_per_step": {k[:70]: t / 1e3 / n for k, t in top}}


def serve_phase(torch) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models.model import Model
    from repro_torch.runtime.llm import LLMEngine
    from repro_torch.runtime.sampling import SamplingParams

    cfg = get_config("llama3-8b")
    t0 = time.monotonic()
    model = Model(cfg, device="cuda").init(seed=0)
    torch.cuda.synchronize()
    n_params = model.param_count()
    print(f"serve: llama3-8b {cfg.n_layers} layers, {n_params / 1e9:.2f} B "
          f"params bf16, random init {time.monotonic() - t0:.1f} s")
    llm = LLMEngine(model, backend="continuous", device="cuda", num_slots=8,
                    page_size=16, max_len=2048, prefill_chunk=256)
    prompts, sps = serve_requests(SamplingParams, cfg.vocab_size)

    LAUNCHES.clear()
    streams, finished, stats, decode_steps = serve_session(llm, prompts, sps)
    launches = LAUNCHES["paged_decode_attention"]
    torch.cuda.synchronize()

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
    if launches != cfg.n_layers * stats.steps or launches == 0:
        raise AssertionError(f"paged_decode_attention ran {launches} times in "
                             f"{stats.steps} decode steps x {cfg.n_layers} "
                             f"layers")

    # the re-run doubles as the profiled window: 8 decode-only steps
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(**PROFILE)) as prof:
        again, _, stats2, steps2 = serve_session(llm, prompts, sps,
                                                 on_decode_step=prof.step)
    last = PROFILE["wait"] + PROFILE["warmup"] + PROFILE["active"]
    breakdown = device_breakdown(
        prof, float(np.median(steps2[:PROFILE["wait"]] + steps2[last:])))
    for i in range(len(prompts)):
        if again[i] != streams[i]:
            kind = "greedy" if sps[i].is_greedy else "sampled"
            raise AssertionError(f"{kind} request {i} did not reproduce "
                                 f"its stream on the re-run")
    ttft = stats.latency_quantiles("ttft")
    result = {"phase": "serve", "requests": len(prompts),
              "new_tokens": stats.total_tokens,
              "tokens_per_s": stats.total_tokens / stats.wall,
              "wall_s": stats.wall, "ttft_p50_s": ttft["p50"],
              "ttft_mean_s": ttft["mean"],
              "decode_step_ms_mean": 1e3 * float(np.mean(decode_steps)),
              "decode_only_steps": len(decode_steps),
              "decode_steps": stats.steps, "prefill_chunks": stats.chunks,
              "prefix_hit_tokens": stats.prefix_hit_tokens,
              "kernel_launches": launches,
              "rerun_identical": True, "rerun_wall_s": stats2.wall,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "profiled_decode_steps": breakdown}
    del llm, model
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# 3. check phase: kernel path on the card == plain path on the CPU
# ---------------------------------------------------------------------------


def check_phase(torch) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models.model import Model
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
    kw = dict(backend="continuous", num_slots=4, page_size=16, max_len=256,
              prefill_chunk=32, cache_dtype=torch.float32)
    LAUNCHES.clear()
    on_gpu = LLMEngine(gpu, device="cuda", **kw).generate(prompts, sps)
    launches = LAUNCHES["paged_decode_attention"]
    on_cpu = LLMEngine(cpu, device="cpu", **kw).generate(prompts, sps)
    for g, c in zip(on_gpu, on_cpu):
        if g.token_ids != c.token_ids:
            raise AssertionError(f"request {g.rid}: card {g.token_ids} vs "
                                 f"CPU {c.token_ids}")
    if launches == 0:
        raise AssertionError("the card run did not launch the decode kernel")
    return {"phase": "check", "model": "llama3-8b widths cut to d_model 512, "
            "2 layers, f32", "requests": len(prompts), "identical": True,
            "kernel_launches": launches}


def main() -> int:
    import torch

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
    kernel = kernel_phase(torch)
    print(json.dumps({"phase": "kernel", "seconds": time.monotonic() - t0}))
    t1 = time.monotonic()
    serve = serve_phase(torch)
    kernel["launches"] = serve["kernel_launches"]
    print(json.dumps({**serve, "seconds": time.monotonic() - t1}))
    t2 = time.monotonic()
    check = check_phase(torch)
    print(json.dumps({**check, "seconds": time.monotonic() - t2}))
    if not all(math.isfinite(kernel[k]) for k in ("ms", "plain_ms", "bound_ms")):
        raise AssertionError(f"non-finite kernel timing: {kernel}")
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
