"""End-to-end serving driver on the PyTorch port (the paper's kind:
low-latency decode).  ``examples/serve_decode.py`` on ``repro_torch``.

One ``LLMEngine`` front-end, three execution backends:
  * ``static``   — prefill, then a decode loop that hands the device
    nothing from the host (on the card the flash kernel runs every
    prefill layer and the dense decode kernel every decode layer);
  * ``continuous`` — iteration-level batching over the block-paged KV
    cache, streaming ``RequestOutput`` deltas as tokens land;
  * ``speculative`` — draft/target speculative decoding (paper Fig 14,
    lossless).

Every request carries its own ``SamplingParams`` — the demo serves a
heterogeneous greedy + sampled mix through the one decode step.

  python examples/torch_serve_decode.py [--arch h2o-danube-1.8b]
      [--batch 8] [--new 48] [--layers 2] [--speculative]     # on the card
  PYTHONPATH=src python examples/torch_serve_decode.py --device cpu

With ``--device cpu`` the model is the reference's reduced config; on the
card it is the full-width config cut to ``--layers`` layers (the reduced
config's head dim 16 has no kernel there, and no kernel falls back to its
plain version), and the continuous section keeps bf16 pages (the paged
decode kernel's) where the CPU keeps the reference's f32 ones.
"""
import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.device import resolve_device
from repro_torch.kernels import LAUNCHES
from repro_torch.models.model import Model
from repro_torch.runtime.deployment import DeploymentSpec
from repro_torch.runtime.llm import LLMEngine
from repro_torch.runtime.sampling import SamplingParams


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new", type=int, default=48)
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--speculative", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--layers", type=int, default=2,
                    help="layers of the full-width model on the card")
    args = ap.parse_args()
    device = resolve_device(args.device)
    on_card = device.type == "cuda"

    cfg = get_config(args.arch)
    cfg = (dataclasses.replace(cfg, n_layers=args.layers) if on_card
           else reduced_config(cfg))
    model = Model(cfg, device=device).init(seed=0)
    gen = torch.Generator().manual_seed(1)
    prompts = list(torch.randint(0, cfg.vocab_size,
                                 (args.batch, args.prompt_len),
                                 generator=gen).numpy())

    # -- static batch: prefill, then the decode loop --------------------------
    llm = LLMEngine(model, backend="static", device=device,
                    max_len=args.prompt_len + args.new + 1)
    # a per-request mix: half greedy, half sampled with distinct seeds —
    # all data, one decode step
    mix = [SamplingParams() if i % 2 == 0 else
           SamplingParams(temperature=args.temperature, top_p=0.95, seed=i)
           for i in range(args.batch)]
    llm.generate(prompts, mix, max_new_tokens=2)     # warm-up (kernel load)
    LAUNCHES.clear()
    t0 = time.time()
    outs = llm.generate(prompts, mix, max_new_tokens=args.new)
    dt = time.time() - t0
    total = sum(len(o.token_ids) for o in outs)
    print(f"[static decode] {args.batch} requests x {args.new} tokens in "
          f"{dt:.2f}s = {total/dt:.0f} tok/s")
    print("  greedy row:", outs[0].token_ids[:12])
    print("  sampled row:", outs[1].token_ids[:12])
    print(f"  kernel launches: {dict(sorted(LAUNCHES.items()))}")

    # -- continuous batching: the pool/slot budget comes from a hardware
    # spec (paper's HBM-CO candidate device), not a hand-tuned knob -------
    try:
        spec = DeploymentSpec(sku="rpu-cu", hbmco="hbmco-768MB",
                              weight_format="mxfp4",
                              max_len=args.prompt_len + args.new + 1,
                              cache_dtype=(torch.bfloat16 if on_card
                                           else torch.float32),
                              max_slots=min(4, args.batch))
        cllm = LLMEngine(model, backend="continuous", device=device,
                         spec=spec)
        print(cllm.deployment.describe())
        stream: dict[int, int] = {}
        LAUNCHES.clear()
        cllm.generate(prompts[:4], mix[:4], max_new_tokens=8,
                      on_output=lambda o: stream.__setitem__(
                          o.rid, stream.get(o.rid, 0) + len(o.new_token_ids)))
        print(f"[continuous] streamed deltas per request: "
              f"{dict(sorted(stream.items()))} "
              f"(occupancy {cllm.last_stats.occupancy:.2f})")
        print(f"  kernel launches: {dict(sorted(LAUNCHES.items()))}")
    except NotImplementedError as e:
        print(f"[continuous] skipped for {cfg.name}: {e}")

    if args.speculative:
        # With an agreeing draft (here: the target itself) every window
        # accepts all gamma tokens; real deployments use a small trained
        # draft (paper: Llama3-8B drafting for 70B, 4.6/8 accepted).
        # Untrained random drafts accept ~0 — run one of each to show the
        # acceptance machinery.
        sllm = LLMEngine(model, backend="speculative", device=device,
                         max_len=args.prompt_len + args.new + 8, gamma=4)
        out = sllm.generate(prompts[:1], max_new_tokens=args.new)[0]
        print(f"[speculative, ideal draft] {out.metrics['windows']} windows, "
              f"{out.metrics['accepted_per_window']:.2f}/4 accepted  tokens: "
              f"{out.token_ids[:8]}")
        draft_cfg = dataclasses.replace(cfg, name="draft",
                                        n_layers=max(2, cfg.n_layers // 2))
        draft = Model(draft_cfg, device=device).init(seed=2)
        dllm = LLMEngine(model, backend="speculative", device=device,
                         max_len=args.prompt_len + args.new + 8,
                         draft_model=draft, gamma=4)
        out = dllm.generate(prompts[:1], max_new_tokens=args.new)[0]
        print(f"[speculative, random draft] {out.metrics['windows']} windows, "
              f"{out.metrics['accepted_per_window']:.2f}/4 accepted "
              "(untrained draft: low acceptance expected; output stays "
              "lossless)")


if __name__ == "__main__":
    main()
