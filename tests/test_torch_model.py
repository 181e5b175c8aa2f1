"""The port's model on bridged reference weights: the weight bridge round
trip is bit-identical, and chunked paged prefill followed by four paged
decode steps gives the reference's logits (within a bf16 tolerance) and
its argmax, for reduced llama3-8b, qwen3-14b (qk-norm) and qwen2.5-14b
(qkv bias).

Tolerance: both models run in bf16 with f32 internals on identical
weights.  XLA:CPU and PyTorch differ in exp/sin/cos/rsqrt and in matmul
summation order, so an intermediate occasionally rounds to the
neighbouring bf16 value; measured logit differences stay within a few
bf16 ulps of the logits' scale.  The bound is 4 bf16 ulps (2^-6) of the
largest logit magnitude."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (import order: models before kernels)
import jax
import jax.numpy as jnp
import ml_dtypes

from repro.configs import get_config, reduced_config
from repro.models.model import build_model
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.models.model import Model


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op thread pool would only spin on the
    cores the parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = ["llama3-8b", "qwen3-14b", "qwen2.5-14b"]


def _reference(name, seed=0):
    """Reduced reference model + numpy params with non-trivial biases and
    qk-norm weights (the reference initialises them to 0 and 1)."""
    cfg = reduced_config(get_config(name))
    model = build_model(cfg)
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    attn = params["stacks"][0][0]["attn"]
    for key in ("bq", "bk", "bv"):
        if key in attn:
            attn[key] = (rng.standard_normal(attn[key].shape) * 0.5).astype(
                ml_dtypes.bfloat16)
    for key in ("q_norm", "k_norm"):
        if key in attn:
            attn[key] = (1 + 0.3 * rng.standard_normal(attn[key].shape)
                         ).astype(np.float32)
    return cfg, model, params


@pytest.mark.parametrize("name", ARCHS)
def test_bridge_round_trip_bit_identical(name):
    cfg, _, params = _reference(name)
    model = params_from_jax(params, tconfigs.reduced_config(
        tconfigs.get_config(name)), device="cpu")
    back = params_to_numpy(model)
    flat_a, tree_a = jax.tree.flatten(params)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_port_config_registry_matches_reference():
    for name in ARCHS:
        assert tconfigs.get_config(name).__dict__ == get_config(name).__dict__
        assert (tconfigs.reduced_config(tconfigs.get_config(name)).__dict__
                == reduced_config(get_config(name)).__dict__)


@pytest.mark.parametrize("name", ARCHS)
def test_paged_prefill_then_decode_matches_reference(name):
    cfg, jmodel, params = _reference(name, seed=1)
    tmodel = params_from_jax(params, tconfigs.reduced_config(
        tconfigs.get_config(name)), device="cpu")
    jparams = jax.tree.map(jnp.asarray, params)
    B, C, page, nb = 3, 8, 4, 6
    P = 1 + B * nb
    rng = np.random.default_rng(2)
    table = rng.permutation(np.arange(1, P)).reshape(B, nb).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (B, C)).astype(np.int32)
    start = np.zeros(B, np.int32)
    valid = np.array([8, 5, 7], np.int32)
    jpools = jmodel.init_paged_cache(P, page)                  # bf16 pools
    tpools = tmodel.init_paged_cache(P, page)

    def check(jl, tl):
        a = np.asarray(jl.astype(jnp.float32))
        b = tl.float().numpy()
        tol = 2.0 ** -6 * np.abs(a).max()
        assert np.abs(a - b).max() <= tol, (np.abs(a - b).max(), tol)
        np.testing.assert_array_equal(b.argmax(-1), a.argmax(-1))
        return a.argmax(-1).astype(np.int32)

    jl, jpools = jmodel.prefill_chunk_paged(
        jparams, jnp.asarray(tokens), jpools, jnp.asarray(table),
        jnp.asarray(start), jnp.asarray(valid))
    tl = tmodel.prefill_chunk_paged(
        torch.from_numpy(tokens), tpools, torch.from_numpy(table),
        torch.from_numpy(start), torch.from_numpy(valid))
    tok, pos = check(jl, tl), valid.copy()
    for _ in range(4):
        jl, jpools = jmodel.decode_step_paged(
            jparams, jnp.asarray(tok), jpools, jnp.asarray(table),
            jnp.asarray(pos))
        tl = tmodel.decode_step_paged(torch.from_numpy(tok), tpools,
                                      torch.from_numpy(table),
                                      torch.from_numpy(pos))
        tok, pos = check(jl, tl), pos + 1


def test_unported_plans_and_options_raise():
    moe = tconfigs.reduced_config(tconfigs.get_config("llama3-8b"))
    with pytest.raises(NotImplementedError, match="MoE"):
        Model(dataclasses.replace(moe, moe=True), device="cpu")
    with pytest.raises(NotImplementedError, match="Stateful"):
        Model(dataclasses.replace(moe, family="ssm"), device="cpu")
    model = Model(moe, device="cpu").init(0)
    with pytest.raises(NotImplementedError, match="Stateful"):
        model.init_paged_cache(4, 4, ring_pages=2)
    pools = model.init_paged_cache(4, 4)
    tab = torch.zeros((1, 1), dtype=torch.int32)
    one = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="Stateful"):
        model.decode_step_paged(one, pools, tab, one, states=[{}])
    # the 2-D (speculative verify) form is ported: logits at every position
    assert model.decode_step_paged(tab, pools, tab, one).shape == (
        1, 1, moe.padded_vocab)
    # quantized pools: fp8 builds codes + scale leaves,
    # an unknown string still raises
    assert set(model.init_paged_cache(4, 4, dtype="fp8")[0]) == {
        "k", "v", "k_scale", "v_scale"}
    with pytest.raises(ValueError, match="cache_dtype"):
        model.init_paged_cache(4, 4, dtype="fp4")


def test_init_is_seeded_and_cuda_default_needs_a_card():
    cfg = tconfigs.reduced_config(tconfigs.get_config("qwen2.5-14b"))
    a = Model(cfg, device="cpu").init(3)
    b = Model(cfg, device="cpu").init(3)
    for (n, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), n
    assert a.layers[0].attn.bq.abs().sum() == 0          # zero biases
    assert float(a.layers[1].attn.wq.float().std()) == pytest.approx(
        1 / 8, rel=0.1)                                   # 1/sqrt(d_model)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Model(cfg)
