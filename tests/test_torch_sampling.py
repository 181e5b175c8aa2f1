"""The port's sampler against the JAX reference: Threefry keys and uniforms
bit-equal to ``jax.random``, and ``sample_slots`` choosing the same tokens
on identical logits for a greedy / top-k / top-p / min-p / penalty / bias
mix."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.runtime import sampling as js
from repro_torch.runtime import prng
from repro_torch.runtime import sampling as ts


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op thread pool would only spin on the
    cores the parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SEEDS = np.array([0, 1, 7, 4242, 123456789, 2 ** 31 - 1], np.int32)
POSITIONS = np.array([0, 1, 2, 63, 64, 1000, 65535, 2 ** 24 + 3], np.int32)


@pytest.mark.parametrize("seed", SEEDS.tolist())
def test_threefry_bit_equal_to_jax(seed):
    s = np.full(POSITIONS.shape, seed, np.int32)
    keys = jax.vmap(js.token_key)(jnp.asarray(s), jnp.asarray(POSITIONS))
    u = jax.vmap(lambda k: jax.random.uniform(k, ()))(keys)
    tk = prng.token_key(torch.from_numpy(s), torch.from_numpy(POSITIONS))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(keys).astype(np.int64))
    np.testing.assert_array_equal(prng.uniform(tk).numpy().view(np.uint32),
                                  np.asarray(u).view(np.uint32))
    root = jax.random.PRNGKey(int(seed))
    np.testing.assert_array_equal(
        prng.prng_key(torch.tensor(int(seed))).numpy(),
        np.asarray(root).astype(np.int64))


MIX = [
    js.SamplingParams(),                                          # greedy
    js.SamplingParams(temperature=0.9, top_k=8, seed=3),
    js.SamplingParams(temperature=1.1, top_p=0.8, seed=11),
    js.SamplingParams(temperature=0.7, min_p=0.05, seed=5),
    js.SamplingParams(temperature=1.0, top_k=40, top_p=0.9, seed=21,
                      repetition_penalty=1.3),
    js.SamplingParams(repetition_penalty=1.5, logit_bias={3: 5.0, 9: -2.0}),
    js.SamplingParams(temperature=1.3, seed=2 ** 31 - 1,
                      logit_bias=((17, 3.0),)),
    js.SamplingParams(temperature=0.5, top_k=64, seed=0),
]


def _port_params(sp: js.SamplingParams) -> ts.SamplingParams:
    return ts.SamplingParams(**{f: getattr(sp, f) for f in (
        "temperature", "top_k", "top_p", "min_p", "seed",
        "repetition_penalty", "logit_bias")})


@pytest.mark.parametrize("trial", range(4))
def test_sample_slots_matches_jax(trial):
    rng = np.random.default_rng(trial)
    b, v = len(MIX), 512
    logits = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    presence = rng.random((b, v)) < 0.05
    pos = rng.integers(0, 4096, b).astype(np.int32)
    jargs = [jnp.asarray(a) for a in js.stack_params(MIX)]
    jext = [jnp.asarray(a) for a in js.stack_extras(MIX)]
    jt, jl = js.sample_slots(jnp.asarray(logits), *jargs, jnp.asarray(pos),
                             rep_penalty=jext[0], bias_ids=jext[1],
                             bias_vals=jext[2], presence=jnp.asarray(presence))
    tmix = [_port_params(sp) for sp in MIX]
    targs = [torch.from_numpy(a) for a in ts.stack_params(tmix)]
    text = [torch.from_numpy(a) for a in ts.stack_extras(tmix)]
    tt, tl = ts.sample_slots(torch.from_numpy(logits), *targs,
                             torch.from_numpy(pos), rep_penalty=text[0],
                             bias_ids=text[1], bias_vals=text[2],
                             presence=torch.from_numpy(presence))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)


def test_apply_processors_matches_jax():
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((len(MIX), 64)).astype(np.float32)
    presence = rng.random(logits.shape) < 0.3
    jext = [jnp.asarray(a) for a in js.stack_extras(MIX)]
    text = [torch.from_numpy(a) for a in
            ts.stack_extras([_port_params(sp) for sp in MIX])]
    j = js.apply_processors(jnp.asarray(logits), *jext,
                            presence=jnp.asarray(presence))
    t = ts.apply_processors(torch.from_numpy(logits), *text,
                            presence=torch.from_numpy(presence))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_slot_sampling_tensors():
    slots = ts.SlotSampling(3, torch.device("cpu"))
    slots.set(1, ts.SamplingParams(temperature=0.5, top_k=4, seed=9,
                                   logit_bias={2: 1.0}))
    temp, topk, _, _, seed, rep, bias_ids, bias_vals = slots.arrays()
    assert temp.tolist() == [0.0, 0.5, 0.0] and topk.tolist() == [0, 4, 0]
    assert seed.tolist() == [0, 9, 0] and bias_ids[1, 0].item() == 2
    slots.clear(1)
    assert slots.arrays()[0].tolist() == [0.0, 0.0, 0.0]
    with pytest.raises(ValueError):
        ts.SamplingParams(top_p=0.0)
