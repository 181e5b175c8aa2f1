"""Synthetic data pipeline with host sharding, prefetch, and straggler
mitigation.

At 1000+ node scale the data tier is a major fault source: a slow or dead
reader host must not stall the whole step.  The pipeline therefore fetches
with a deadline; on timeout it substitutes the *last good batch* (bounded
reuse) and records the event — the standard straggler-mitigation policy
(bounded-staleness fallback).  Failure injection hooks make this testable.

Batches are deterministic functions of (seed, step, shard), so restarts
resume bit-identically from the checkpointed step — the data-side half of
the fault-tolerance contract.

A copy of the reference's ``repro/data/pipeline.py`` with ``ModelConfig``
from the port: batches stay numpy, and the training loop moves them to
the model's device.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Iterator

import numpy as np

from repro_torch.models.common import ModelConfig


@dataclasses.dataclass
class PipelineStats:
    fetched: int = 0
    straggler_fallbacks: int = 0
    max_reuse_run: int = 0


class SyntheticTokenPipeline:
    """Deterministic token batches for LM training.

    ``delay_fn(step) -> seconds`` injects synthetic straggler latency for
    tests/benchmarks.
    """

    def __init__(self, cfg: ModelConfig, *, global_batch: int, seq_len: int,
                 seed: int = 0, shard: int = 0, n_shards: int = 1,
                 straggler_timeout_s: float | None = None,
                 max_batch_reuse: int = 3,
                 delay_fn: Callable[[int], float] | None = None):
        assert global_batch % n_shards == 0
        self.cfg = cfg
        self.local_batch = global_batch // n_shards
        self.seq_len = seq_len
        self.seed = seed
        self.shard = shard
        self.timeout = straggler_timeout_s
        self.max_reuse = max_batch_reuse
        self.delay_fn = delay_fn
        self.stats = PipelineStats()
        self._last_good: dict | None = None
        self._reuse_run = 0

    # -- raw generation ------------------------------------------------------
    def _make_batch(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard]))
        cfg = self.cfg
        b, s = self.local_batch, self.seq_len
        if cfg.frontend == "audio":
            return {
                "features": rng.standard_normal((b, s, cfg.d_model),
                                                dtype=np.float32),
                "labels": rng.integers(0, cfg.vocab_size, (b, s),
                                       dtype=np.int32),
            }
        if cfg.frontend == "vision":
            ni = cfg.n_frontend_tokens
            return {
                "tokens": rng.integers(0, cfg.vocab_size, (b, s - ni),
                                       dtype=np.int32),
                "image_embeds": rng.standard_normal((b, ni, cfg.d_model),
                                                    dtype=np.float32),
            }
        return {"tokens": rng.integers(0, cfg.vocab_size, (b, s),
                                       dtype=np.int32)}

    def _fetch_with_deadline(self, step: int) -> dict | None:
        """Returns the batch, or None if the deadline was exceeded."""
        if self.delay_fn is None or self.timeout is None:
            if self.delay_fn is not None:
                time.sleep(self.delay_fn(step))
            return self._make_batch(step)
        result: list = [None]

        def work():
            time.sleep(self.delay_fn(step))
            result[0] = self._make_batch(step)

        t = threading.Thread(target=work, daemon=True)
        t.start()
        t.join(self.timeout)
        return result[0]

    # -- public --------------------------------------------------------------
    def get_batch(self, step: int) -> dict:
        batch = self._fetch_with_deadline(step)
        if batch is None:
            # straggler: bounded-staleness fallback to the last good batch
            self.stats.straggler_fallbacks += 1
            self._reuse_run += 1
            self.stats.max_reuse_run = max(self.stats.max_reuse_run,
                                           self._reuse_run)
            if self._last_good is None or self._reuse_run > self.max_reuse:
                # nothing to reuse (or reused too long): block for real
                batch = self._make_batch(step)
                self._reuse_run = 0
            else:
                return self._last_good
        else:
            self._reuse_run = 0
        self.stats.fetched += 1
        self._last_good = batch
        return batch

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.get_batch(step)
            step += 1
