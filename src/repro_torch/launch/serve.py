"""Serving launcher of the port: one ``LLMEngine`` front-end, three backends.

    python -m repro_torch.launch.serve --arch llama3-8b --no-reduced \
        --continuous --disaggregate 1:1 --num-requests 4 --batch 4 \
        --prompt-len 256 --max-new 16            # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --continuous --num-requests 8 --batch 4 --prompt-len 16

``--backend static`` runs the prompt batch through one prefill over a
dense cache and a decode loop (on the card the flash and dense decode
kernels).  ``--backend continuous`` (also ``--continuous``) runs
iteration-level batching over the block-paged KV cache: requests arrive as
a Poisson process (``--arrival-rate`` req/s) and are admitted into freed
decode slots.  ``--backend speculative`` (also ``--speculative``) runs the
legacy draft/target speculative decoding with a draft of a quarter of the
target's layers.

Per-request generation is a ``SamplingParams``: ``--temperature``,
``--top-k``, ``--top-p``, ``--min-p``, ``--stop-token`` (repeatable) and
``--seed`` apply to every request; ``--sampling-mix`` serves a mix instead
(comma-separated ``temp:top_p[:top_k]`` specs cycled across requests, all
through one decode step: per-slot sampling params are data).

Continuous admission runs chunked prefill (``--prefill-chunk`` tokens per
iteration per request) and shares prompt prefixes through the page pool's
prefix index (``--num-prompts`` distinct prompts over ``--num-requests``
requests; ``--no-prefix-cache`` turns it off).  ``--spec-draft reduced
--gamma 4`` turns on speculative decoding inside the continuous engine.
``--disaggregate P:D`` splits it into a prefill-phase and a decode-phase
engine behind the KV-page handoff; without ``--mesh`` (the only way the
port runs: ``--mesh`` and a ``--tp-reduce`` other than ``auto`` raise,
tensor parallelism is not ported) both phase engines share the one device.
``--sku`` / ``--hbmco`` / ``--weight-format`` size the engine from a
``DeploymentSpec``; ``--fleet`` hands every other argument to
``repro_torch.launch.fleet`` (simulate, ``--plan``, ``--calibrate``).

The model runs on the card unless ``--device cpu`` is given; its weights
are random, from ``--seed``, and so are the prompts (a ``torch.Generator``
seeded by ``--seed``).  ``--reduced`` (the default) takes the family's
tiny config, whose head dim 16 only the CPU's plain path takes: on the
card pass ``--no-reduced`` (a full config's widths).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.quant import formats
from repro_torch.runtime.deployment import DeploymentSpec
from repro_torch.runtime.engine import _unported
from repro_torch.runtime.llm import LLMEngine
from repro_torch.runtime.sampling import SamplingParams

# "fp8" / "int8" are the quantized page pools of quant/kv.py: codes in the
# narrow dtype + per-token, per-KV-head f32 scales beside them in the pool
CACHE_DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16,
                "f32": torch.float32, "fp8": "fp8", "int8": "int8"}


def parse_mix(spec: str, base: SamplingParams) -> list[SamplingParams]:
    """``temp:top_p[:top_k]`` specs, comma-separated, cycled per request."""
    out = []
    for part in spec.split(","):
        fields = part.split(":")
        if not 2 <= len(fields) <= 3:
            raise ValueError(f"bad --sampling-mix entry {part!r} "
                             "(want temp:top_p[:top_k])")
        out.append(SamplingParams(
            temperature=float(fields[0]), top_p=float(fields[1]),
            top_k=int(fields[2]) if len(fields) == 3 else 0,
            min_p=base.min_p, seed=base.seed,
            stop_token_ids=base.stop_token_ids))
    return out


def _draft(cfg, device, seed: int) -> Model:
    """The draft of ``--speculative`` / ``--spec-draft reduced``: the
    target's config at a quarter of its layers (at least 2), its own
    random weights."""
    draft_cfg = dataclasses.replace(cfg, name=cfg.name + "-draft",
                                    n_layers=max(2, cfg.n_layers // 4))
    return Model(draft_cfg, device=device).init(seed=seed + 3)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--no-reduced", dest="reduced", action="store_false")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the kernels) or cpu (their "
                         "plain versions)")
    ap.add_argument("--backend", default=None,
                    choices=["static", "continuous", "speculative"])
    ap.add_argument("--continuous", action="store_true",
                    help="alias for --backend continuous")
    ap.add_argument("--speculative", action="store_true",
                    help="alias for --backend speculative")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=32)
    # -- per-request sampling -------------------------------------------
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--min-p", type=float, default=0.0)
    ap.add_argument("--stop-token", type=int, action="append", default=[],
                    help="finish a request when this token id is emitted "
                         "(repeatable)")
    ap.add_argument("--sampling-mix", default=None,
                    help="comma-separated temp:top_p[:top_k] specs cycled "
                         "across requests (one decode step, per-slot data)")
    # -- continuous-batching knobs --------------------------------------
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="Poisson request arrival rate in req/s "
                         "(0 = all requests arrive at t=0)")
    ap.add_argument("--num-requests", type=int, default=0,
                    help="total requests for continuous (default 3x batch)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV page size in tokens for continuous")
    ap.add_argument("--prefill-chunk", type=int, default=64,
                    help="prefill chunk size in tokens for continuous")
    ap.add_argument("--num-prompts", type=int, default=0,
                    help="distinct prompts for continuous (0 = all "
                         "distinct; lower values share prefixes)")
    ap.add_argument("--no-prefix-cache", dest="prefix_cache",
                    action="store_false", default=True,
                    help="disable prompt-prefix page sharing")
    ap.add_argument("--spec-draft", default=None,
                    choices=["self", "reduced"],
                    help="speculative decoding in the continuous backend: "
                         "'reduced' drafts with an n_layers/4 copy of the "
                         "target, 'self' with the target itself")
    ap.add_argument("--gamma", type=int, default=4,
                    help="draft lookahead per speculative window")
    ap.add_argument("--disaggregate", default=None, metavar="P:D",
                    help="phase-split continuous serving behind the KV-page "
                         "handoff; without --mesh the two phase engines "
                         "share the one device")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="tensor-parallel serving (not ported: raises)")
    ap.add_argument("--tp-reduce", default="auto",
                    choices=["auto", "gather", "psum"],
                    help="how a tensor-parallel column pair closes (not "
                         "ported: anything but auto raises)")
    # -- hardware-aware deployment (DeploymentSpec) ----------------------
    ap.add_argument("--sku", default=None,
                    help="deployment hardware point: rpu-cu | tpu-v5e | "
                         "h100 | h200.  Giving --sku/--hbmco/--weight-"
                         "format sizes the engine from a DeploymentSpec: "
                         "pool pages and decode slots from the per-device "
                         "memory budget and the bandwidth roofline instead "
                         "of --batch")
    ap.add_argument("--hbmco", default=None,
                    help="HBM-CO memory stack: hbm3e-like | hbmco-768MB | "
                         "co-r<R>c<C>b<B>m<MB>")
    ap.add_argument("--weight-format", default=None,
                    choices=sorted(formats.FORMAT_NAMES),
                    help="block-quantized weight format (mxfp4 runs the "
                         "MXFP4 VMM kernel on the card)")
    ap.add_argument("--cache-dtype", default=None,
                    choices=sorted(CACHE_DTYPES),
                    help="KV page-pool dtype; fp8/int8 keep quantized codes "
                         "+ per-token scales (continuous backend only)")
    ap.add_argument("--max-slots", type=int, default=32,
                    help="cap on the spec-derived decode slot count")
    ap.add_argument("--seed", type=int, default=0,
                    help="weights, prompts AND per-request sampling seed")
    return ap


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--fleet" in argv:
        # fleet-level serving (router + simulator + autoscaler) has its
        # own argument surface: delegate everything else to it
        argv.remove("--fleet")
        from repro_torch.launch.fleet import main as fleet_main
        return fleet_main(argv)
    args = build_parser().parse_args(argv)
    backend = args.backend or ("continuous" if args.continuous else
                               "speculative" if args.speculative else
                               "static")
    if args.mesh is not None or args.tp_reduce != "auto":
        raise _unported("tensor-parallel serving (--mesh / --tp-reduce)",
                        "Tensor parallelism")
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    model = Model(cfg, device=device).init(seed=args.seed)

    disagg = None
    if args.disaggregate:
        if backend != "continuous":
            print("--disaggregate splits the continuous backend; "
                  f"ignoring it for backend={backend}")
        else:
            try:
                p_dev, d_dev = (int(x) for x in args.disaggregate.split(":"))
            except ValueError:
                print(f"--disaggregate wants 'P:D', got "
                      f"{args.disaggregate!r}")
                return 1
            disagg = (p_dev, d_dev)
    max_len = args.prompt_len + args.max_new + 1
    if args.spec_draft is not None and backend == "continuous":
        # verify windows may overshoot by up to gamma draft positions
        max_len += args.gamma

    cache_dtype = CACHE_DTYPES.get(args.cache_dtype)
    spec = None
    if args.sku or args.hbmco or args.weight_format:
        spec = DeploymentSpec(
            sku=args.sku or "rpu-cu", hbmco=args.hbmco,
            weight_format=args.weight_format, cache_dtype=cache_dtype,
            max_len=max_len, page_size=args.page_size,
            prefill_chunk=args.prefill_chunk, max_slots=args.max_slots)

    base = SamplingParams(
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        min_p=args.min_p, seed=args.seed,
        stop_token_ids=tuple(args.stop_token))

    spec_cfg = None
    if args.spec_draft is not None:
        if backend != "continuous":
            print(f"--spec-draft configures the continuous backend; "
                  f"ignoring it for backend={backend}")
        else:
            from repro_torch.runtime.speculative import SpeculativeConfig
            spec_cfg = SpeculativeConfig(
                draft_model=(_draft(cfg, device, args.seed)
                             if args.spec_draft == "reduced" else None),
                gamma=args.gamma)

    gen = torch.Generator().manual_seed(args.seed)
    if backend == "continuous":
        n_req = args.num_requests or 3 * args.batch
        rng = np.random.default_rng(args.seed)
        gaps = (rng.exponential(1.0 / args.arrival_rate, n_req)
                if args.arrival_rate > 0 else np.zeros(n_req))
        arrivals = np.cumsum(gaps)
        n_distinct = args.num_prompts or n_req
        pool_prompts = torch.randint(0, cfg.vocab_size,
                                     (n_distinct, args.prompt_len),
                                     generator=gen).numpy()
        picks = np.random.default_rng(args.seed + 1).integers(
            0, n_distinct, n_req)
        mix = parse_mix(args.sampling_mix, base) if args.sampling_mix \
            else [base]
        sps = [mix[i % len(mix)] for i in range(n_req)]
        dkw = dict(disaggregate=disagg is not None)
        if spec is not None:
            # hardware-derived pool and slots: no manual num_pages knob
            llm = LLMEngine(model, backend="continuous", device=device,
                            spec=spec, speculative=spec_cfg,
                            enable_prefix_cache=args.prefix_cache, **dkw)
            print(llm.deployment.describe())
            if disagg is not None:
                print(llm._eng.prefill.deployment.describe())
            slots = llm._eng.num_slots
        else:
            slots = args.batch
            llm = LLMEngine(
                model, backend="continuous", device=device, max_len=max_len,
                num_slots=slots, page_size=args.page_size,
                num_pages=1 + slots * -(-max_len // args.page_size) * 2,
                prefill_chunk=args.prefill_chunk, cache_dtype=cache_dtype,
                enable_prefix_cache=args.prefix_cache, speculative=spec_cfg,
                **dkw)
        t0 = time.time()
        outs = llm.generate([pool_prompts[picks[i]] for i in range(n_req)],
                            sps, max_new_tokens=args.max_new,
                            arrival_times=arrivals)
        dt = time.time() - t0
        stats = llm.last_stats
        n_tok = sum(len(o.token_ids) for o in outs)
        print(f"arch={cfg.name} continuous slots={slots} "
              f"requests={n_req} rate={args.arrival_rate}/s "
              f"steps={stats.steps} occupancy={stats.occupancy:.2f} "
              f"preemptions={stats.preemptions} device={device}")
        if args.sampling_mix:
            print(f"sampling mix: {args.sampling_mix} "
                  f"(one decode step, per-slot data)")
        print(f"tokens={n_tok} wall={dt:.2f}s ({n_tok / dt:.1f} tok/s)")
        print(f"prefill: {stats.chunks} chunks, "
              f"{stats.prefill_tokens}/{stats.prompt_tokens} prompt "
              f"tokens computed, prefix hit rate "
              f"{stats.prefix_hit_rate:.2f}, cow={stats.cow_events}")
        if spec_cfg is not None:
            print(f"speculative: gamma={args.gamma} "
                  f"draft={args.spec_draft} "
                  f"windows={stats.spec_windows} "
                  f"accepted/window={stats.accepted_per_window:.2f} "
                  f"drafted={stats.spec_drafted} "
                  f"wasted={stats.spec_wasted}")
        if disagg is not None:
            print(f"handoff: {stats.handoffs} chains, "
                  f"{stats.handoff_pages} pages, "
                  f"{stats.handoff_bytes} bytes, "
                  f"{stats.handoff_shared_tokens} prefix-shared tokens")
        q = stats.ttft_quantiles()
        if q is not None:
            print(f"ttft p50={q[0] * 1e3:.1f}ms p99={q[1] * 1e3:.1f}ms")
        reasons = {}
        for o in outs:
            reasons[o.finish_reason] = reasons.get(o.finish_reason, 0) + 1
        if spec_cfg is not None:
            per_req = " ".join(
                f"r{rid}:p{st['preemptions']}/c{st['chunks']}"
                f"/w{st['spec_windows']}/a{st['spec_accepted']}"
                for rid, st in sorted(stats.per_request.items()))
        else:
            per_req = " ".join(
                f"r{rid}:p{st['preemptions']}/c{st['chunks']}"
                for rid, st in sorted(stats.per_request.items()))
        print(f"finish reasons: {reasons}")
        print(f"per-request preemptions/chunks: {per_req}")
        print("sample:", outs[0].token_ids[:16])
        return 0

    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen).numpy()
    if backend == "speculative":
        llm = LLMEngine(model, backend="speculative", device=device,
                        max_len=max_len,
                        draft_model=_draft(cfg, device, args.seed), gamma=4)
        t0 = time.time()
        outs = llm.generate(prompts[:1], base, max_new_tokens=args.max_new)
        dt = time.time() - t0
        m = outs[0].metrics
        print(f"speculative: accepted/window="
              f"{m['accepted_per_window']:.2f} over {m['windows']} windows")
    else:
        llm = LLMEngine(model, backend="static", device=device,
                        max_len=max_len, spec=spec, cache_dtype=cache_dtype)
        if spec is not None:
            print(llm.deployment.describe())
        t0 = time.time()
        outs = llm.generate(prompts, base, max_new_tokens=args.max_new)
        dt = time.time() - t0

    n_tok = sum(len(o.token_ids) for o in outs)
    print(f"arch={cfg.name} backend={backend} batch={len(outs)} "
          f"new_tokens={len(outs[0].token_ids)} device={device} "
          f"wall={dt:.2f}s ({n_tok / dt:.1f} tok/s)")
    print("sample:", outs[0].token_ids[:16])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
