"""The port's copy of the data pipeline (``repro_torch/data/pipeline.py``):
the reference's ``tests/test_data.py`` cases (determinism, host
sharding, straggler mitigation) on the port, and batches equal to the
reference pipeline's array for array, for token, audio and vision
configs."""
import dataclasses

import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.data.pipeline import SyntheticTokenPipeline as RefPipeline
from repro_torch.configs import get_config, reduced_config
from repro_torch.data import PipelineStats, SyntheticTokenPipeline


@pytest.fixture()
def cfg():
    return reduced_config(get_config("qwen3-14b"))


def test_batches_deterministic(cfg):
    p1 = SyntheticTokenPipeline(cfg, global_batch=4, seq_len=16, seed=7)
    p2 = SyntheticTokenPipeline(cfg, global_batch=4, seq_len=16, seed=7)
    for step in (0, 1, 5):
        np.testing.assert_array_equal(p1.get_batch(step)["tokens"],
                                      p2.get_batch(step)["tokens"])


def test_batches_differ_across_steps_and_shards(cfg):
    p = SyntheticTokenPipeline(cfg, global_batch=4, seq_len=16, seed=7)
    assert not np.array_equal(p.get_batch(0)["tokens"], p.get_batch(1)["tokens"])
    pa = SyntheticTokenPipeline(cfg, global_batch=8, seq_len=16, shard=0,
                                n_shards=2)
    pb = SyntheticTokenPipeline(cfg, global_batch=8, seq_len=16, shard=1,
                                n_shards=2)
    assert pa.local_batch == 4
    assert not np.array_equal(pa.get_batch(0)["tokens"],
                              pb.get_batch(0)["tokens"])


def test_straggler_fallback_reuses_last_batch(cfg):
    """A slow fetch beyond the timeout falls back to the last good batch
    instead of stalling the step (bounded reuse)."""
    slow_steps = {3, 4}
    p = SyntheticTokenPipeline(
        cfg, global_batch=4, seq_len=16, straggler_timeout_s=0.01,
        delay_fn=lambda s: 0.2 if s in slow_steps else 0.0)
    b2 = p.get_batch(2)
    b3 = p.get_batch(3)          # slow -> reuse of b2
    np.testing.assert_array_equal(b2["tokens"], b3["tokens"])
    assert p.stats.straggler_fallbacks >= 1
    b5 = p.get_batch(5)          # fast again -> fresh data
    assert not np.array_equal(b5["tokens"], b2["tokens"])


def test_straggler_reuse_budget_blocks_for_fresh_data(cfg):
    """After max_batch_reuse consecutive fallbacks the pipeline must stop
    reusing stale data and block for a real batch."""
    p = SyntheticTokenPipeline(
        cfg, global_batch=2, seq_len=8, straggler_timeout_s=0.01,
        max_batch_reuse=2, delay_fn=lambda s: 0.2 if s >= 1 else 0.0)
    b0 = p.get_batch(0)
    b1 = p.get_batch(1)          # reuse 1
    b2 = p.get_batch(2)          # reuse 2
    np.testing.assert_array_equal(b0["tokens"], b1["tokens"])
    np.testing.assert_array_equal(b0["tokens"], b2["tokens"])
    b3 = p.get_batch(3)          # budget exhausted -> blocking fresh fetch
    assert not np.array_equal(b3["tokens"], b0["tokens"])
    assert p.stats.max_reuse_run == 2 or p.stats.straggler_fallbacks >= 3
    assert isinstance(p.stats, PipelineStats)


@pytest.mark.parametrize("name", ["qwen3-14b", "hubert-xlarge",
                                  "internvl2-26b"])
def test_batches_equal_the_reference(name):
    """Token, audio (features + labels) and vision (tokens after the
    image positions + image embeddings) batches, shard by shard."""
    tcfg = reduced_config(get_config(name))
    rcfg = ref_reduced_config(ref_get_config(name))
    seq = 300 if tcfg.frontend == "vision" else 16   # 256 image positions
    for shard in (0, 1):
        got = SyntheticTokenPipeline(tcfg, global_batch=4, seq_len=seq,
                                     seed=3, shard=shard, n_shards=2)
        want = RefPipeline(rcfg, global_batch=4, seq_len=seq, seed=3,
                           shard=shard, n_shards=2)
        for step in (0, 4):
            g, w = got.get_batch(step), want.get_batch(step)
            assert g.keys() == w.keys()
            for key in w:
                assert g[key].dtype == w[key].dtype
                np.testing.assert_array_equal(g[key], w[key])
    assert dataclasses.asdict(PipelineStats()) == {
        "fetched": 0, "straggler_fallbacks": 0, "max_reuse_run": 0}
