"""The sampler's single-distribution API (``greedy``, ``token_key``,
``sample``, ``probs``) against the reference's ``repro/runtime/sampling.py``
on the same logits: ``greedy`` picks the same ids, ``probs`` agrees within
1e-6 (f32 softmax in two frameworks), ``token_key`` gives the reference's
key bits, and ``sample(token_key(seed, pos), logits)`` draws the
reference's token on every one of 1200 seeded draws over a mix of
temperatures, top-k, top-p and min-p (the port's Threefry gives the
reference's uniform bits; the Gumbel noise's two logs are each
framework's own, which no draw here is near enough a tie to notice)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.runtime import sampling as js
from repro_torch.runtime import sampling as ts

MIX = [dict(temperature=0.0), dict(temperature=0.7),
       dict(temperature=1.0, top_k=8), dict(temperature=0.9, top_p=0.8),
       dict(temperature=1.3, top_k=20, top_p=0.95, min_p=0.05),
       dict(temperature=1.0, min_p=0.1)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op thread pool would only spin on the
    cores the parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_greedy_and_probs_match_reference():
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((5, 7, 300))).astype(np.float32)
    got = ts.greedy(torch.from_numpy(logits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(js.greedy(jnp.asarray(logits))))
    for temp in (1.0, 0.5, 2.0, 0.0):
        p = ts.probs(torch.from_numpy(logits), temp).numpy()
        want = np.asarray(js.probs(jnp.asarray(logits), temp))
        np.testing.assert_allclose(p, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed,pos", [(0, 0), (7, 1), (2 ** 31 - 1, 65535),
                                      (123456, 2 ** 24 + 3)])
def test_token_key_bits_match_reference(seed, pos):
    want = np.asarray(js.token_key(seed, pos)).astype(np.int64)
    np.testing.assert_array_equal(ts.token_key(seed, pos).numpy(), want)


@pytest.mark.parametrize("block", range(4))
def test_sample_draws_the_reference_tokens(block):
    """300 draws a block (1200 in all): one seed and position each, logits
    of 64 to 512 entries, the params cycled through ``MIX``."""
    rng = np.random.default_rng(100 + block)
    mismatches = []
    for i in range(300):
        seed, pos = int(rng.integers(0, 2 ** 31)), int(rng.integers(0, 4096))
        v = int(rng.choice([64, 256, 512]))
        logits = (rng.standard_normal(v) * rng.uniform(0.5, 4)).astype(
            np.float32)
        kw = MIX[i % len(MIX)]
        want = int(js.sample(js.token_key(seed, pos), jnp.asarray(logits),
                             **kw))
        got = ts.sample(ts.token_key(seed, pos), torch.from_numpy(logits),
                        **kw)
        assert got.dtype == torch.int32 and got.shape == ()
        if int(got) != want:
            mismatches.append((seed, pos, kw, int(got), want))
    assert not mismatches, mismatches[:5]


def test_sample_batched_rows_share_one_key():
    """A (B, V) batch under one key: the reference's Gumbel draw over the
    whole (B, V) shape, row by row."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((6, 128)).astype(np.float32)
    key = (11, 5)
    want = np.asarray(js.sample(js.token_key(*key), jnp.asarray(logits),
                                temperature=0.8, top_k=16))
    got = ts.sample(ts.token_key(*key), torch.from_numpy(logits),
                    temperature=0.8, top_k=16)
    np.testing.assert_array_equal(got.numpy(), want)
