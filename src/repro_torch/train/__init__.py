"""Training substrate of the port: optimizer, train step (with remat),
atomic checkpointing, fault-tolerant loop (``repro/train``'s exports)."""
from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_opt_state, lr_schedule
from repro_torch.train.train_step import TrainState, init_train_state, make_train_step
from repro_torch.train.checkpoint import (
    save_checkpoint, restore_checkpoint, restore_latest, list_checkpoints)
from repro_torch.train.loop import LoopConfig, LoopResult, run_training
