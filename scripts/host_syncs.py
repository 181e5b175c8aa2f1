"""Host waits and decode step time of the two serve engines on one card.

    python3 scripts/host_syncs.py <tree> <label>

Imports ``<tree>``'s own port, builds llama3-8b at full size (random bf16
weights from a seed) and serves 8 prompts of 1024 tokens with 33 new tokens
each (4 greedy, 4 sampled) through ``LLMEngine(backend="static")`` and
``LLMEngine(backend="continuous")`` (8 slots, page 16, chunk 256).  Prints
one line ``SYNC {json}`` with the card's name and power limit and:

* ``waits_per_step``: the host's waits for the device in one traced call
  (``cudaStreamSynchronize``, ``cudaDeviceSynchronize``, and host-to-device
  copies from pageable memory, which wait the same way) per decode step;
* ``step_ms``: the decode step of 5 untraced calls (static: the engine's
  ``tpot``; continuous: the median request ``tpot``);
* ``host_probe_ms``: before each call, the time of a fixed pure-Python
  loop, which shows how fast the host itself ran then (the host is shared
  and its speed drifts, so host-bound steps drift with it).

Compare two trees only within one call, in turns (A B B A), e.g. an
untracked copy of the other tree in a gitignored directory.
"""
import json
import os
import statistics
import subprocess
import sys
import time

root = os.path.abspath(sys.argv[1])
sys.path.insert(0, os.path.join(root, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.runtime.llm import LLMEngine  # noqa: E402
from repro_torch.runtime.sampling import SamplingParams  # noqa: E402

NEW, CALLS = 33, 5
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "Memcpy HtoD (Pageable -> Device)")


def host_probe() -> float:
    t, s = time.perf_counter(), 0
    for i in range(2_000_000):
        s += i
    return (time.perf_counter() - t) * 1e3


def step_ms(outs) -> float:
    return 1e3 * statistics.median(o.metrics["tpot"] for o in outs)


def waits(llm, prompts, sps) -> int:
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        llm.generate(prompts, sps)
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.key in WAITS)


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("llama3-8b")
    model = Model(cfg, device="cuda").init(seed=0)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, 1024) for _ in range(8)]
    sps = [SamplingParams(max_tokens=NEW) if i % 2 == 0 else
           SamplingParams(max_tokens=NEW, temperature=0.8, top_p=0.9,
                          top_k=40, seed=2000 + i) for i in range(8)]
    engines = {
        "static": LLMEngine(model, backend="static", device="cuda",
                            max_len=2048),
        "continuous": LLMEngine(model, backend="continuous", device="cuda",
                                num_slots=8, page_size=16, max_len=2048,
                                prefill_chunk=256)}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    out = {"label": sys.argv[2], "card": card}
    for name, llm in engines.items():
        llm.generate(prompts, sps)                   # warm-up
        steps, probes = [], []
        for _ in range(CALLS):
            probes.append(host_probe())
            steps.append(step_ms(llm.generate(prompts, sps)))
        out[name] = {"step_ms": steps, "host_probe_ms": probes}
    for name, llm in engines.items():               # traced calls last
        out[name]["waits_per_step"] = waits(llm, prompts, sps) / (NEW - 1)
    print("SYNC", json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
