"""Training launcher of the port: one device, or a mesh of ranks.

Runs a real (small-scale) training job through the fault-tolerant loop
(checkpoint / NaN rollback / resume) and the synthetic data pipeline:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch qwen3-14b --steps 100 --batch 8 --seq 128
  python -m repro_torch.launch.train --arch h2o-danube-1.8b --no-reduced \
      --steps 20 --batch 4 --seq 2048 --remat          # on the card

The reference's flags, plus ``--device`` (``cuda``, the default, or
``cpu``).  ``--reduced`` (the default) takes the family's tiny config; a
training step runs no hand-written kernel (attention under autograd is
the plain ``blocked_attention``), so it trains on the card too.  The
weights are random, from ``--seed``.

Under ``torchrun`` every rank trains its shard of the state, SPMD, with the
reference's train plan (``make_plan(shape_kind="train")``: DP + FSDP over
``(pod, data)``, Megatron TP with sequence parallelism over ``model``).
``--mesh DxM`` or ``PxDxM`` lays the ranks out (the default, as the
reference's ``make_small_mesh()``: every rank on ``data``); the
cross-pod gradient mean is int8-compressed exactly when the mesh has a
``pod`` axis of more than one pod.  The pipeline gives each rank its DP
shard of the batch; rank 0 prints and writes the checkpoints::

  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
      -m repro_torch.launch.train --device cpu --mesh 2x1x2 --steps 4

``--device cpu`` runs gloo ranks; on CUDA the ranks take NCCL, one card
each.
"""
from __future__ import annotations

import argparse
import contextlib
import logging
import os
import tempfile

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.parallel.plan import make_plan
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
    ap.add_argument("--mesh", default=None, metavar="DxM|PxDxM",
                    help="the ranks as a (data, model) or (pod, data, model) "
                         "mesh (run under torchrun; default with several "
                         "ranks: all of them on data)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    mesh = None
    if args.mesh is not None or int(os.environ.get("WORLD_SIZE", "1")) > 1:
        from repro_torch.launch.mesh import init_world, parse_mesh
        if "WORLD_SIZE" in os.environ:         # started by torchrun
            init_world(device)
            if device.type == "cuda":
                device = torch.device("cuda", torch.cuda.current_device())
        n = int(os.environ.get("WORLD_SIZE", "1"))
        mesh = parse_mesh(args.mesh or f"{n}x1", device)
    with contextlib.ExitStack() as stack:
        if mesh is not None:
            import torch.distributed as dist
            stack.callback(dist.destroy_process_group)
            if mesh.get_rank():         # every rank trains; rank 0 prints
                stack.enter_context(contextlib.redirect_stdout(
                    stack.enter_context(open(os.devnull, "w"))))
        return _train(args, device, mesh)


def _train(args, device, mesh) -> int:
    if mesh is None or mesh.get_rank() == 0:
        logging.basicConfig(level=logging.INFO,
                            format="%(asctime)s %(name)s %(message)s")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    model = Model(cfg, device=device)

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps)
    shard, n_shards = 0, 1
    if mesh is None:
        step_fn = make_train_step(model, opt_cfg, remat=args.remat)
        state = init_train_state(model, args.seed)
    else:
        plan = make_plan(cfg, mesh, global_batch=args.batch,
                         shape_kind="train")
        pods = (mesh.size(0) if mesh.mesh_dim_names[0] == "pod" else 1)
        compress = pods > 1
        state = init_train_state(model, args.seed, plan=plan,
                                 n_pods=pods if compress else 0)
        step_fn = make_train_step(model, opt_cfg, remat=args.remat,
                                  plan=plan, compress_pods=compress)
        shard = state.layout.groups.dp_index
        n_shards = state.layout.groups.dp_size

    pipeline = SyntheticTokenPipeline(
        cfg, global_batch=args.batch, seq_len=args.seq, seed=args.seed,
        shard=shard, n_shards=n_shards)

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
