"""Accuracy and time of a checkout's MXFP4 kernel at prefill M on one card.

    python3 scripts/mxfp4_accuracy.py <tree> <label>

Imports ``<tree>``'s own port, builds its ``mxfp4_vmm`` and, for the
wgmma schedule's long-K launches of llama3-8b and deepseek-v2-lite-16b,
holds the kernel's f32 output and the plain version's (``ref.py``: an f32
matmul of the dequantized weight) against an f64 product of the same bf16
x and weight, on three kinds of x: Gaussian, SwiGLU-like (silu(2a) * b, a
and b Gaussian: the input of ``w_down``) and Gaussian with 8 columns
scaled by 50.  Errors are max |out - f64| / max |f64| (``kernel_vs_plain``
is the measure ``chip_smoke.py`` holds to 1e-5).  Also times one bf16
launch on Gaussian x (the median of 30, L2 flushed before each, as
``chip_smoke.py`` times).  Prints one line ``ACC {json}`` with the card's
name and power limit.  The data comes from fixed seeds, so two trees see
the same inputs; compare them only within one call, in turns (A B B A),
e.g. an untracked ``git archive`` of the parent in a gitignored directory.
"""
import json
import os
import subprocess
import sys

root = os.path.abspath(sys.argv[1])
sys.path.insert(0, os.path.join(root, "src"))

import torch  # noqa: E402

from repro_torch.kernels.mxfp4_vmm import kernel  # noqa: E402
from repro_torch.kernels.mxfp4_vmm.ref import mxfp4_vmm_ref  # noqa: E402
from repro_torch.quant import formats  # noqa: E402

# (M, K, N): llama3-8b's w_down and w_gate, deepseek's w_down and wq
SHAPES = ((2048, 14336, 4096), (2048, 4096, 14336), (2048, 10944, 2048),
          (2048, 2048, 3072), (256, 14336, 4096))


def activations(kind, m, k, gen):
    def randn():
        return torch.randn((m, k), generator=gen, device="cuda")
    if kind == "gauss":
        return randn().bfloat16()
    if kind == "swiglu":
        a = randn() * 2
        return (torch.nn.functional.silu(a) * randn()).bfloat16()
    x = randn()
    x[:, :: k // 8] *= 50
    return x.bfloat16()


def time_ms(fn, flush, iters=30):
    times = []
    for _ in range(iters):
        flush.zero_()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[iters // 2]


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = []
    for m, k, n in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(m * 7 + k * 3 + n)
        w = (torch.randn((k, n), generator=gen, device="cuda") * 0.02).bfloat16()
        p = formats.quantize_mxfp4(w)
        w64 = formats.dequantize_mxfp4(p, torch.bfloat16).double()
        row = {"M": m, "K": k, "N": n}
        for kind in ("gauss", "swiglu", "outlier"):
            x = activations(kind, m, k, gen)
            r64 = x.double() @ w64
            top = r64.abs().max().item()
            out = kernel.mxfp4_vmm(x, p.codes, p.scales)
            plain = mxfp4_vmm_ref(x, p.codes, p.scales)
            row[kind] = {
                "kernel_vs_f64": (out.double() - r64).abs().max().item() / top,
                "plain_vs_f64": (plain.double() - r64).abs().max().item() / top,
                "kernel_vs_plain": ((out - plain).abs().max()
                                    / plain.abs().max()).item()}
            if kind == "gauss":
                row["ms"] = time_ms(lambda: kernel.mxfp4_vmm(
                    x, p.codes, p.scales, torch.bfloat16), flush)
        rows.append(row)
    print("ACC", json.dumps({"label": sys.argv[2], "card": card, "rows": rows}),
          flush=True)


if __name__ == "__main__":
    main()
