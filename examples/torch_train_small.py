"""End-to-end training driver on the PyTorch port: a ~100M-parameter dense
LM for a few hundred steps with the full production loop — periodic
checkpoints, NaN rollback, straggler-tolerant data, and a mid-run injected
node failure that the loop recovers from.  ``examples/train_small.py`` on
``repro_torch``.

  python examples/torch_train_small.py [--steps 300] [--no-failure]  # card
  PYTHONPATH=src python examples/torch_train_small.py --device cpu \
      --steps 30

(CPU note: ~100M params is real work for a laptop CPU; pass --steps 30 for
a fast smoke run.)  One device; the same loop trains on a mesh of ranks
through ``repro_torch.launch.train --mesh`` under ``torchrun``.  A
training step runs no hand-written kernel (attention under autograd is the
plain blocked attention), so the config trains on the card as it is.
"""
import argparse
import logging
import os
import tempfile

from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models.common import ModelConfig
from repro_torch.models.model import Model
from repro_torch.train.loop import LoopConfig, run_training
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import init_train_state, make_train_step

# ~100M-parameter llama-style config (12L x 768 ~ GPT-2-small scale + SwiGLU)
CONFIG_100M = ModelConfig(
    name="lm-100m", family="dense", n_layers=12, d_model=768, n_heads=12,
    n_kv_heads=4, d_ff=2048, vocab_size=32000, rope_theta=10000.0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--no-failure", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_small"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args()

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    device = resolve_device(args.device)
    model = Model(CONFIG_100M, device=device)
    state = init_train_state(model, 0)
    n = model.param_count()
    print(f"model: {CONFIG_100M.name}, {n/1e6:.1f}M params")

    opt = AdamWConfig(lr=3e-4, warmup_steps=max(args.steps // 20, 1),
                      total_steps=args.steps)
    step_fn = make_train_step(model, opt)
    pipeline = SyntheticTokenPipeline(CONFIG_100M, global_batch=args.batch,
                                      seq_len=args.seq,
                                      straggler_timeout_s=5.0)

    failure = None
    if not args.no_failure:
        fired = {"done": False}

        def failure(step):
            # simulate one node failure at 60% of the run
            if step == int(args.steps * 0.6) and not fired["done"]:
                fired["done"] = True
                return True
            return False

    loop_cfg = LoopConfig(total_steps=args.steps,
                          ckpt_every=max(args.steps // 6, 2),
                          ckpt_dir=args.ckpt_dir, log_every=10)
    result = run_training(step_fn, state, pipeline, loop_cfg,
                          failure_fn=failure)

    print(f"done: {len(result.losses)} steps, loss "
          f"{result.losses[0]:.3f} -> {result.losses[-1]:.3f}, "
          f"rollbacks={result.rollbacks}, "
          f"straggler_fallbacks={result.straggler_fallbacks}")


if __name__ == "__main__":
    main()
