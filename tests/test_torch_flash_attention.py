"""Flash-attention forward: the port's plain version and its GQA op
(``impl="auto"`` on CPU tensors) against the reference's op, which runs its
Pallas kernel in interpret mode exactly as ``tests/test_kernels.py`` does,
and against the reference's ``blocked_attention``; plus the op's dispatch
rules.  One test holds the CUDA kernel against the plain version and runs
only where there is a card.

Inputs come from a seeded numpy generator.  Tolerances: f32 1e-5 absolute
(both sides sum in f32, in other orders); bf16 a relative error
(max |diff| / max |ref|) below 0.02, the reference's own test's bound — the
outputs round to bf16 and the reference op's oracle fallback for the
unaligned case computes in another order again.  The card test holds the
kernel tighter: per output row, to two bf16 ulps of its largest value."""
import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (import order: models before kernels)
import jax.numpy as jnp
import ml_dtypes

from repro.kernels.flash_attention.ops import (
    gqa_flash_attention as jax_gqa_flash,
)
from repro.models.common import blocked_attention as jax_blocked
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models.common import blocked_attention


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op thread pool would only spin on the
    cores the parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the shapes of tests/test_kernels.py::test_flash_attention_vs_blocked, and
# its unaligned case (Sq = Skv = 100 is no multiple of a 64-row block: the
# reference op falls back to its oracle there)
CASES = [
    # b, s, h, kvh, d, block_q, block_k, causal
    (2, 256, 4, 2, 64, 128, 128, True),
    (1, 512, 8, 8, 64, 256, 128, False),
    (2, 128, 4, 1, 32, 64, 64, True),       # MQA
    (1, 384, 2, 2, 128, 128, 128, True),    # odd block count
    (1, 100, 2, 2, 32, 64, 64, True),       # unaligned
]
DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16)}


def _inputs(seed, b, s, h, kvh, d, dtype):
    rng = np.random.default_rng(seed)
    npd = DTYPES[dtype][0]
    q = rng.standard_normal((b, s, h, d)).astype(npd)
    k = rng.standard_normal((b, s, kvh, d)).astype(npd)
    v = rng.standard_normal((b, s, kvh, d)).astype(npd)
    return q, k, v


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


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,s,h,kvh,d,bq,bk,causal", CASES)
def test_op_matches_reference_pallas_and_blocked(dtype, b, s, h, kvh, d, bq,
                                                 bk, causal):
    q, k, v = _inputs(s + h, b, s, h, kvh, d, dtype)
    got = ops.gqa_flash_attention(_torch(q), _torch(k), _torch(v),
                                  causal=causal)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (b, s, h, d)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    _check(got, jax_gqa_flash(jq, jk, jv, causal=causal, block_q=bq,
                              block_k=bk), dtype)
    _check(got, jax_blocked(jq, jk, jv, causal=causal), dtype)
    # the port's own blocked attention: the static prefill's CPU path
    _check(got, blocked_attention(_torch(q), _torch(k), _torch(v),
                                  causal=causal).float().numpy(), dtype)


def test_ref_on_flattened_heads():
    """``flash_attention_ref`` on the reference kernel's (BH, S, D) layout,
    with Sq != Skv (the causal mask is top-left aligned)."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((3, 20, 16)).astype(np.float32)
    k = rng.standard_normal((3, 28, 16)).astype(np.float32)
    v = rng.standard_normal((3, 28, 16)).astype(np.float32)
    from repro.kernels.flash_attention.ref import (
        flash_attention_ref as jax_ref,
    )
    for causal in (True, False):
        got = flash_attention_ref(_torch(q), _torch(k), _torch(v),
                                  causal=causal).numpy()
        want = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_op_dispatch_on_cpu():
    q, k, v = (_torch(a) for a in _inputs(1, 1, 12, 4, 2, 32, "float32"))
    before = dict(LAUNCHES)
    auto = ops.gqa_flash_attention(q, k, v)
    ref = ops.gqa_flash_attention(q, k, v, impl="reference")
    np.testing.assert_array_equal(auto.numpy(), ref.numpy())
    assert dict(LAUNCHES) == before                 # no kernel on CPU
    with pytest.raises(ValueError, match="CUDA"):
        ops.gqa_flash_attention(q, k, v, impl="fused")
    with pytest.raises(ValueError, match="impl"):
        ops.gqa_flash_attention(q, k, v, impl="nope")


def test_variant_choice():
    """The wrapper picks the kernel by dtype and head dim before the
    launch, and raises for what no kernel takes."""
    v = flash_kernel.variant
    assert v(torch.bfloat16, 128) == "wgmma"
    assert v(torch.bfloat16, 64) == "wgmma"
    assert v(torch.bfloat16, 32) == "mma"
    assert [v(torch.float32, d) for d in (32, 64, 128)] == ["fma"] * 3
    # GQA: an item packs up to MAX_REP query heads of one kv head
    assert v(torch.bfloat16, 128, 5) == "wgmma"
    assert v(torch.bfloat16, 64, flash_kernel.MAX_REP) == "wgmma"
    assert v(torch.bfloat16, 128, flash_kernel.MAX_REP + 1) == "mma"
    assert v(torch.float32, 128, 256) == "fma"
    with pytest.raises(ValueError, match="dtype"):
        v(torch.float16, 128)
    # D 80 / 96 (h2o-danube, phi3-mini) on D 128's shared-memory layout
    assert [v(torch.bfloat16, d, r) for d in (80, 96) for r in (1, 4)] \
        == ["wgmma"] * 4
    assert [v(torch.float32, d) for d in (80, 96)] == ["fma"] * 2
    for d in (16, 48, 256):
        with pytest.raises(ValueError, match="head dim"):
            v(torch.bfloat16, d)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kvh,d,bq,bk,causal", CASES + [
    (2, 1000, 32, 8, 128, 64, 64, True),     # llama3-8b heads, ragged S
    (1, 1024, 32, 8, 128, 128, 128, True),   # B 1, one prompt
    (2, 1000, 16, 4, 64, 64, 64, True),      # D 64, GQA 4:1, ragged
    (1, 777, 40, 8, 128, 64, 64, False),     # rep 5: 125-row items
    (2, 1000, 40, 8, 128, 64, 64, True)])    # ... causal, ragged
def test_cuda_kernel_matches_ref(b, s, h, kvh, d, bq, bk, causal):
    """The kernel against its plain version on the card (f32 within 1e-5;
    bf16 within two bf16 ulps, 2^-6, of each output row's largest value:
    the kernel rounds P to bf16 for the tensor cores, both sides round the
    output)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    for dtype in DTYPES:
        q, k, v = (_torch(a).cuda() for a in _inputs(s, b, s, h, kvh, d,
                                                     dtype))
        before = LAUNCHES["flash_attention"]
        out = ops.gqa_flash_attention(q, k, v, causal=causal)
        ref = ops.gqa_flash_attention(q, k, v, causal=causal,
                                      impl="reference")
        torch.cuda.synchronize()
        assert LAUNCHES["flash_attention"] == before + 1
        g, w = out.float().cpu().numpy(), ref.float().cpu().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
        else:   # per output row (one query in one head), its own scale
            rel = (np.abs(g - w).max(-1)
                   / np.maximum(np.abs(w).max(-1), 1e-6)).max()
            assert rel <= 2.0 ** -6, rel
