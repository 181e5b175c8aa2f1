"""Flash attention with a V narrower than Q/K: D 192 / Dv 128, deepseek-
v2-lite's MLA prefill (``hd`` 128 + ``rope_head_dim`` 64 of q.k, ``v_hd``
128).

The port's plain version and GQA op against the reference's kernel, run
in interpret mode as ``tests/test_kernels.py`` runs it, and its op, causal
and full, f32 and bf16 (tolerances of ``test_torch_flash_attention.py``:
f32 1e-5 absolute, bf16 a relative error below 0.02); the wrapper's
(D, Dv) pairs; which MLA paths hand their attention to the kernel on a
CUDA device (the static prefill and ``Model.forward``, not the paged chunk,
which starts at a query offset), checked on the CPU by standing in for
the kernel; and a narrow deepseek-shaped model at these head dims, whose
``Model.forward`` and static prefill logits (the plain path on the CPU)
match the reference's at ``test_torch_mla.py``'s tolerances (f32 1e-5
absolute, bf16 within 2^-6 of the largest |logit|).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (import order: models before kernels)
import jax
import jax.numpy as jnp
import ml_dtypes

from repro.configs import get_config
from repro.kernels.flash_attention.kernel import (
    flash_attention as jax_flash_kernel,
)
from repro.kernels.flash_attention.ops import (
    gqa_flash_attention as jax_gqa_flash,
)
from repro.models.model import build_model
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models import layers as tlayers

D, DV = 192, 128
DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op thread pool would only spin on the
    cores the parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a)


def _check(got: torch.Tensor, want, dtype: str) -> None:
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    else:
        rel = np.abs(g - w).max() / (np.abs(w).max() + 1e-6)
        assert rel < 0.02, rel


def _inputs(seed, lead_q, lead_kv, dtype):
    rng = np.random.default_rng(seed)
    npd = DTYPES[dtype][0]
    return (rng.standard_normal(lead_q + (D,)).astype(npd),
            rng.standard_normal(lead_kv + (D,)).astype(npd),
            rng.standard_normal(lead_kv + (DV,)).astype(npd))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ref_matches_reference_kernel_interpret(dtype, causal):
    """The plain version on the reference kernel's (BH, S, D) layout
    against the Pallas kernel in interpret mode: (8, 128, 192) q/k, v of
    width 128, 64-row blocks."""
    q, k, v = _inputs(5, (8, 128), (8, 128), dtype)
    got = flash_attention_ref(_torch(q), _torch(k), _torch(v), causal=causal)
    assert got.shape == (8, 128, DV) and got.dtype == DTYPES[dtype][1]
    want = jax_flash_kernel(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            block_q=64, block_k=64, causal=causal,
                            interpret=True)
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,s,h,kvh,causal", [
    (2, 128, 4, 4, True),          # MLA: the expanded heads, H = KVH
    (1, 100, 4, 2, False),         # GQA 2:1, unaligned S (oracle fallback)
])
def test_op_matches_reference_op(dtype, b, s, h, kvh, causal):
    q, k, v = _inputs(s + h, (b, s, h), (b, s, kvh), dtype)
    got = ops.gqa_flash_attention(_torch(q), _torch(k), _torch(v),
                                  causal=causal)
    assert got.shape == (b, s, h, DV)
    _check(got, jax_gqa_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal), dtype)


def test_head_dim_pairs():
    """Every D of ``HEAD_DIMS`` with Dv = D and MLA's (192, 128), in every
    variant; any other pair raises naming the supported pairs."""
    v = flash_kernel.variant
    assert (D, DV) in flash_kernel.HEAD_DIM_PAIRS
    assert v(torch.bfloat16, D, 1, DV) == "wgmma"
    assert v(torch.bfloat16, D, 16, DV) == "wgmma"
    assert v(torch.bfloat16, D, flash_kernel.MAX_REP + 8, DV) == "mma"
    assert v(torch.float32, D, 1, DV) == "fma"
    assert v(torch.bfloat16, 128, 4, 128) == v(torch.bfloat16, 128, 4)
    for d, dv in ((192, 192), (128, 64), (192, 64), (96, 128), (256, 128)):
        with pytest.raises(ValueError, match=r"supported: \(\(32, 32\)"):
            v(torch.bfloat16, d, 1, dv)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_kernel.flash_attention(torch.zeros(1, 4, 2, D),
                                     torch.zeros(1, 4, 2, D),
                                     torch.zeros(1, 4, 2, DV))


# ---------------------------------------------------------------------------
# the MLA paths that reach the kernel
# ---------------------------------------------------------------------------

NAME = "deepseek-v2-lite-16b"
# deepseek's head dims, narrow elsewhere: 2 layers (mla_dense + mla_moe)
NARROW = dict(name="deepseek-mla-heads", n_layers=2, d_model=256, n_heads=2,
              n_kv_heads=2, head_dim=128, rope_head_dim=64, v_head_dim=128,
              kv_lora_rank=64, d_ff=256, n_experts=4, n_experts_per_token=2,
              n_shared_experts=1, moe_d_ff=64, vocab_size=384,
              vocab_pad_multiple=128)


@pytest.fixture(scope="module")
def narrow():
    cfg = dataclasses.replace(get_config(NAME), **NARROW)
    tcfg = dataclasses.replace(tconfigs.get_config(NAME), **NARROW)
    ref = build_model(cfg)
    params = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(4)))
    return cfg, tcfg, ref, params


@pytest.fixture
def stand_in_kernel(monkeypatch):
    """``kernel_path`` true on the CPU and the kernel replaced by its plain
    op, recording each call's shapes: which paths would launch it."""
    calls = []

    def fake(q, k, v, *, causal=True, window=None):
        calls.append((tuple(q.shape), tuple(k.shape), tuple(v.shape),
                      q.dtype, k.dtype, v.dtype, causal))
        return ops.gqa_flash_attention(q, k, v, causal=causal,
                                       impl="reference")

    monkeypatch.setattr(tlayers, "kernel_path", lambda device: True)
    monkeypatch.setattr(tlayers, "flash_attention", fake)
    return calls


def test_static_prefill_and_forward_reach_the_kernel(narrow,
                                                      stand_in_kernel):
    """On a CUDA device ``mla_prefill`` and ``mla_forward`` hand their
    expanded attention to the kernel: q/k (B, S, H, 192), v (B, S, H,
    128), one dtype, causal; the paged prefill chunk (a query offset per
    row) does not.  With the plain op standing in, the logits equal the
    plain path's."""
    _, tcfg, _, params = narrow
    model = params_from_jax(params, tcfg, device="cpu").float()
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, 9)).astype(np.int64))
    logits = model(tokens)
    h = tcfg.n_heads
    assert stand_in_kernel == [((2, 9, h, D), (2, 9, h, D), (2, 9, h, DV),
                                torch.float32, torch.float32, torch.float32,
                                True)] * tcfg.n_layers
    stand_in_kernel.clear()
    cache = model.init_cache(2, 12, torch.float32)
    model.prefill(tokens, cache)
    assert len(stand_in_kernel) == tcfg.n_layers
    stand_in_kernel.clear()
    pools = model.init_paged_cache(8, 4, torch.float32)
    table = torch.arange(1, 7, dtype=torch.int32).reshape(2, 3)
    model.prefill_chunk_paged(tokens[:, :8], pools, table,
                              torch.zeros(2, dtype=torch.int32),
                              torch.full((2,), 8, dtype=torch.int32))
    assert stand_in_kernel == []
    ref_logits = params_from_jax(params, tcfg, device="cpu").float()(tokens)
    torch.testing.assert_close(logits, ref_logits, rtol=0, atol=1e-5)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_narrow_model_logits_match_reference(narrow, f32):
    """``Model.forward`` and the static prefill on the CPU (the plain path)
    at the kernel's head dims against the reference's."""
    cfg, tcfg, ref, params = narrow
    model = params_from_jax(params, tcfg, device="cpu")
    jparams = jax.tree.map(jnp.asarray, params)
    jd, td = jnp.bfloat16, torch.bfloat16
    if f32:
        model = model.float()
        jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
        jd, td = jnp.float32, torch.float32
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                               (2, 10)).astype(np.int32)
    before = dict(LAUNCHES)

    def close(j, t):
        a, b = np.asarray(jnp.asarray(j).astype(jnp.float32)), t.float().numpy()
        assert a.shape == b.shape
        tol = 1e-5 if f32 else 2.0 ** -6 * np.abs(a).max()
        assert np.abs(a - b).max() <= tol, (np.abs(a - b).max(), tol)

    close(ref.forward(jparams, {"tokens": jnp.asarray(tokens)}),
          model(torch.from_numpy(tokens)))
    jcache = ref.init_cache(2, 14, dtype=jd)
    tcache = model.init_cache(2, 14, td)
    jl, _ = ref.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcache)
    close(jl, model.prefill(torch.from_numpy(tokens), tcache))
    assert dict(LAUNCHES) == before              # no kernel on the CPU
