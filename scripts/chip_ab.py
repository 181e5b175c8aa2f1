"""A/B of two checkouts of the port on one card.

    python3 scripts/chip_ab.py <tree> <label>

Runs ``<tree>``'s own ``chip_smoke.py`` build, MXFP4 kernel phase and
quantized serve phase (llama3-8b, mxfp4 weights, fp8 KV) and prints one
line ``AB {json}``: the MXFP4 kernel's ms per shape at M 8 and M 256, one
layer at M 8 (the serve path's launches), and the serve's tokens/s, TTFT
p50, decode step and kernel launches.  Compare two trees only within one call, in
turns (A B B A), e.g. an untracked ``git archive`` of the parent beside
the working tree.
"""
import json
import os
import sys

root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
sys.path.insert(0, os.path.join(root, "src"))
os.chdir(root)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
cs.build_phase()
vmm = cs.kernel_mxfp4_phase(torch)
model = cs.build_llama(torch)
q = cs.serve_phase(torch, model, phase="serve_quantized",
                   weight_format="mxfp4", cache_dtype="fp8")
keep = ("tokens_per_s", "ttft_p50_s", "decode_step_ms_mean", "wall_s",
        "kernel_launches")
print("AB", json.dumps({
    "label": sys.argv[2], "vmm_layer_ms": vmm["ms"],
    "vmm_m8": {f'{r["K"]}x{r["N"]}': r["ms"] for r in vmm["timings"]
               if r["M"] == 8},
    "vmm_m256": {f'{r["K"]}x{r["N"]}': r["ms"] for r in vmm["timings"]
                 if r["M"] == 256},
    **{k: q[k] for k in keep}}), flush=True)
