"""Training launcher of the port: one device, no mesh.

Runs a real (small-scale) training job through the fault-tolerant loop
(checkpoint / NaN rollback / resume) and the synthetic data pipeline:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch qwen3-14b --steps 100 --batch 8 --seq 128
  python -m repro_torch.launch.train --arch h2o-danube-1.8b --no-reduced \
      --steps 20 --batch 4 --seq 2048 --remat          # on the card

The reference's flags, plus ``--device`` (``cuda``, the default, or
``cpu``).  ``--reduced`` (the default) takes the family's tiny config; a
training step runs no hand-written kernel (attention under autograd is
the plain ``blocked_attention``), so it trains on the card too.  There is
no mesh, plan or sharding rules: parallel training is not ported yet
(ROADMAP Queue 1, 'Parallel training and the dry-run's meshes').  The
weights are random, from ``--seed``.
"""
from __future__ import annotations

import argparse
import logging
import os
import tempfile

from repro_torch.configs import get_config, reduced_config
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.train.loop import LoopConfig, run_training
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import init_train_state, make_train_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--no-reduced", dest="reduced", action="store_false")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    model = Model(cfg, device=resolve_device(args.device))

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps)
    step_fn = make_train_step(model, opt_cfg, remat=args.remat)
    state = init_train_state(model, args.seed)

    pipeline = SyntheticTokenPipeline(
        cfg, global_batch=args.batch, seq_len=args.seq, seed=args.seed)

    loop_cfg = LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                          ckpt_dir=args.ckpt_dir, log_every=10)

    result = run_training(step_fn, state, pipeline, loop_cfg)

    n = model.param_count()
    if result.losses:
        span = (f"first_loss={result.losses[0]:.4f} "
                f"last_loss={result.losses[-1]:.4f}")
    else:
        span = f"(resumed at step {result.resumed_from}: already complete)"
    print(f"arch={cfg.name} params={n/1e6:.1f}M steps={len(result.losses)} "
          f"{span} rollbacks={result.rollbacks}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
