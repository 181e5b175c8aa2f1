"""Quickstart on the PyTorch port: the three layers of the RPU reproduction
in about a minute.  ``examples/quickstart.py`` on ``repro_torch``.

  1. analytical core   — design an HBM-CO memory + RPU for a model
  2. simulator         — latency/energy of the deployment (paper Figs 8-12)
  3. PyTorch framework — run a real model: train steps + decode
  4. the seam          — a DeploymentSpec sizes the continuous engine

  python examples/torch_quickstart.py                  # on the card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Sections 1 and 2, and section 4's deployment on the CPU, print what the
reference's quickstart prints.  With ``--device cpu`` sections 3 and 4 run
the reference's reduced qwen3-14b; on the card they run qwen3-14b at full
width, cut to ``--layers`` layers (the reduced config's head dim 16 has
no kernel there, and no kernel falls back to its plain version): the
static decode runs the flash and dense decode kernels, whose launches
section 3 prints, and section 4 serves MXFP4 weights through the MXFP4
VMM kernel and bf16 pages through the paged decode kernel, priced for the
H100 it runs on (an RPU CU's 1.5 GB cannot hold those widths).
"""
import argparse
import dataclasses

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.hbmco import CANDIDATE_CO, HBM3E_LIKE
from repro_torch.device import resolve_device
from repro_torch.kernels import LAUNCHES
from repro_torch.models.model import Model
from repro_torch.runtime.deployment import DeploymentSpec
from repro_torch.runtime.llm import LLMEngine
from repro_torch.runtime.sampling import SamplingParams
from repro_torch.sim.scaling import iso_tdp_comparison, rpu_point
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import init_train_state, make_train_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--layers", type=int, default=2,
                    help="layers of the full-width model on the card")
    args = ap.parse_args()
    device = resolve_device(args.device)
    on_card = device.type == "cuda"

    # ------------------------------------------------ 1. analytical core
    print("== HBM-CO (paper §III) ==")
    print(" ", HBM3E_LIKE.describe())
    print(" ", CANDIDATE_CO.describe())
    print(f"  energy ratio: {HBM3E_LIKE.energy_pj_per_bit / CANDIDATE_CO.energy_pj_per_bit:.2f}x"
          f"  (paper: 2.4x)")

    # ------------------------------------------------ 2. simulator
    print("\n== RPU deployment for Llama3-70B (paper §VIII) ==")
    p = rpu_point(get_config("llama3-70b"), 204, batch=1, seq_len=8192)
    print(f"  204 CUs, SKU {p.sku.name}: {p.ms_per_token:.2f} ms/token "
          f"(paper: 0.4), {p.tdp_w:.0f} W")
    r = iso_tdp_comparison(get_config("llama3-70b"), batch=1, seq_len=8192)
    print(f"  ISO-TDP vs {r['n_gpus']}xH100: {r['speedup']:.1f}x lower latency")

    # ------------------------------------------------ 3. PyTorch framework
    cfg = get_config(args.arch)
    if on_card:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
        label = f"{cfg.name} at {cfg.n_layers} layers"
    else:
        cfg = reduced_config(cfg)
        label = f"reduced {args.arch.split('-')[0]}"
    print(f"\n== PyTorch framework: {label}, 5 train steps + decode "
          f"({device.type}) ==")
    model = Model(cfg, device=device)
    state = init_train_state(model, 0)
    step = make_train_step(model, AdamWConfig(lr=1e-3))
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 64),
                                     generator=gen).to(device)}
    for i in range(5):
        state, metrics = step(state, batch)
        print(f"  step {i}: loss {float(metrics['loss']):.4f}")
    for p_ in model.parameters():
        p_.requires_grad_(False)
    prompts = [batch["tokens"][0, :16].cpu(), batch["tokens"][1, :16].cpu()]

    LAUNCHES.clear()
    llm = LLMEngine(model, backend="static", device=device, max_len=80)
    outs = llm.generate(prompts, SamplingParams(max_tokens=8))
    print(f"  generated: {[o.token_ids for o in outs]}")
    print(f"  kernel launches: {dict(sorted(LAUNCHES.items()))}")

    # ---------------------------------------- 4. the seam: spec -> runtime
    # The analytic core (1-2) sizes the serving runtime (3): a hardware
    # point resolves into the paged-KV pool and decode-slot budget.
    print("\n== DeploymentSpec: HBM-CO budget drives the real engine ==")
    if on_card:
        spec = DeploymentSpec(sku="h100", weight_format="mxfp4", max_len=80,
                              cache_dtype=torch.bfloat16, max_slots=4)
    else:
        spec = DeploymentSpec(sku="rpu-cu", hbmco=CANDIDATE_CO,
                              weight_format="mxfp4", max_len=80,
                              cache_dtype=torch.float32, max_slots=4)
    LAUNCHES.clear()
    sllm = LLMEngine(model, backend="continuous", device=device, spec=spec)
    print(sllm.deployment.describe())
    outs = sllm.generate(prompts, SamplingParams(max_tokens=8))
    print(f"  generated: {[o.token_ids for o in outs]}")
    print(f"  kernel launches: {dict(sorted(LAUNCHES.items()))}")


if __name__ == "__main__":
    main()
