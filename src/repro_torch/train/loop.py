"""Fault-tolerant training loop: the port of ``repro/train/loop.py``.

Periodic atomic checkpoints, loss-spike/NaN detection with
rollback-and-skip, straggler-tolerant data fetch (see ``data.pipeline``)
and restart from the newest committed checkpoint.  Failure injection
(``failure_fn``) lets tests exercise the recovery paths
deterministically.

The pipeline's numpy batches move to the device of the state's weights
here.  The step updates the state in place (the reference donates it to
its jitted step), so a rollback always restores from a checkpoint.
``LoopResult.timings`` keeps the host wall seconds of each step, save and
restore (beyond the reference's result).

A sharded state (``init_train_state(plan=)``) runs the same loop on every
rank, and every decision is made together: the resume step is rank 0's
reading of the directory, broadcast; an injected failure on any rank
restores on every rank; the NaN rollback reads the step's loss, which is
already the mean over the DP ranks; every rank takes part in a save's
gathers and rank 0 alone writes (an async save is rank 0's snapshot,
written by its thread, which rank 0 joins, then a barrier, before anyone
reads the directory).  The pipeline gives the rank's rows (its ``shard``
is the DP rank, ``n_shards`` the DP size).
"""
from __future__ import annotations

import dataclasses
import logging
import os
import tempfile
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.train_step import TrainState

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    async_ckpt: bool = False
    nan_rollback: bool = True
    max_rollbacks: int = 3
    log_every: int = 10


@dataclasses.dataclass
class LoopResult:
    state: Any
    losses: list
    rollbacks: int
    resumed_from: int
    straggler_fallbacks: int
    # host wall seconds of each step (batch to the device, the step, the
    # loss read back), each checkpoint save (an async save: its host copy)
    # and each restore
    timings: dict = dataclasses.field(default_factory=lambda: {
        "step_s": [], "save_s": [], "restore_s": []})


def batch_to(batch: dict, device: torch.device) -> dict:
    """A pipeline batch (numpy) as tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


def run_training(
    train_step: Callable,
    state: TrainState,
    pipeline: SyntheticTokenPipeline,
    loop_cfg: LoopConfig,
    *,
    shardings=None,
    failure_fn: Callable[[int], bool] | None = None,
) -> LoopResult:
    """Run (or resume) training to ``total_steps``.

    ``failure_fn(step) -> True`` injects a simulated node failure: the loop
    responds exactly as to a real one — restore last checkpoint, continue.
    ``shardings``: the restore's placement on the current mesh (a sharded
    state's own by default; ``checkpoint.restore_checkpoint``).
    """
    timings = {"step_s": [], "save_s": [], "restore_s": []}
    lay = state.layout
    world = lay.groups.comms["world"] if lay is not None else None
    pending_save = None

    def settle():
        """On a mesh: rank 0's async writer done, then every rank met."""
        if isinstance(pending_save, threading.Thread):
            pending_save.join()
        if world is not None:
            torch.distributed.barrier()

    def restore_latest(template):
        settle()
        t0 = time.perf_counter()
        if world is None:
            out = ckpt_lib.restore_latest(loop_cfg.ckpt_dir, template,
                                          shardings=shardings)
        else:
            steps = ckpt_lib.list_checkpoints(loop_cfg.ckpt_dir)
            step = int(world.broadcast_float(float(steps[-1]) if steps
                                             else -1.0))
            out = (None, -1) if step < 0 else (ckpt_lib.restore_checkpoint(
                loop_cfg.ckpt_dir, step, template, shardings=shardings), step)
        if out[0] is not None:
            timings["restore_s"].append(time.perf_counter() - t0)
        return out

    def failing(step: int) -> bool:
        hit = failure_fn is not None and failure_fn(step)
        if world is None:
            return hit
        flag = torch.tensor([1.0 if hit else 0.0])
        if world.backend == "nccl":
            flag = flag.cuda()
        return bool(world.all_reduce_op(flag, "max", kind="decision")[0] > 0)

    # ---- resume if a committed checkpoint exists
    restored, from_step = restore_latest(state)
    if restored is not None:
        state = restored
        log.info("resumed from step %d", from_step)
    start = int(state.step)
    device = next(iter(state.params.values())).device

    losses: list[float] = []
    rollbacks = 0
    step = start
    while step < loop_cfg.total_steps:
        if failing(step):
            # simulated node failure: abandon in-flight state, restore.
            log.warning("injected failure at step %d; restoring", step)
            restored, from_step = restore_latest(state)
            if restored is None:
                raise RuntimeError("failure before first checkpoint")
            state = restored
            step = int(state.step)
            rollbacks += 1
            if rollbacks > loop_cfg.max_rollbacks:
                raise RuntimeError("rollback budget exhausted")
            continue

        t0 = time.perf_counter()
        batch = batch_to(pipeline.get_batch(step), device)
        new_state, metrics = train_step(state, batch)
        loss = float(metrics["loss"])
        timings["step_s"].append(time.perf_counter() - t0)

        if loop_cfg.nan_rollback and not (loss == loss and abs(loss) < 1e9):
            log.warning("non-finite loss %.3g at step %d; rolling back",
                        loss, step)
            restored, from_step = restore_latest(state)
            if restored is None:
                raise RuntimeError("NaN before first checkpoint")
            state = restored
            step = int(state.step)
            rollbacks += 1
            if rollbacks > loop_cfg.max_rollbacks:
                raise RuntimeError("rollback budget exhausted")
            continue

        state = new_state
        losses.append(loss)
        step += 1

        if step % loop_cfg.ckpt_every == 0 or step == loop_cfg.total_steps:
            if isinstance(pending_save, threading.Thread):
                pending_save.join()
            t0 = time.perf_counter()
            pending_save = ckpt_lib.save_checkpoint(
                loop_cfg.ckpt_dir, step, state, async_save=loop_cfg.async_ckpt)
            timings["save_s"].append(time.perf_counter() - t0)
        if step % loop_cfg.log_every == 0:
            log.info("step %d loss %.4f", step, loss)

    settle()
    return LoopResult(state=state, losses=losses, rollbacks=rollbacks,
                      resumed_from=from_step,
                      straggler_fallbacks=pipeline.stats.straggler_fallbacks,
                      timings=timings)
