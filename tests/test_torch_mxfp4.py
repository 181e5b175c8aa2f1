"""The MXFP4 VMM: the port's plain version against the JAX reference's
oracle and its Pallas kernel (interpret mode), the op wrapper's dispatch
and bf16 activation cast, the CUDA wrapper's split of K, and — where there
is a card — the CUDA kernel against the plain version.

Tolerance: 1e-5 of the output's largest magnitude.  Both sides multiply
the same bf16 operands exactly in f32 and differ only in the order of
the f32 sums."""
import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (import order: models before kernels)
import jax.numpy as jnp
import ml_dtypes

from repro.kernels.mxfp4_vmm.kernel import mxfp4_vmm as pallas_vmm
from repro.kernels.mxfp4_vmm.ops import mxfp4_matmul as jax_matmul
from repro.kernels.mxfp4_vmm.ref import mxfp4_vmm_ref as jax_ref
from repro.quant import formats as jformats
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.mxfp4_vmm import kernel as vmm_kernel
from repro_torch.kernels.mxfp4_vmm.ops import mxfp4_matmul, mxfp4_tileable
from repro_torch.kernels.mxfp4_vmm.ref import mxfp4_vmm_ref
from repro_torch.quant import formats
from repro_torch.quant.linear import qdot

RTOL = 1e-5


def _rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30))


def _case(seed, m, k, n, x_dtype=ml_dtypes.bfloat16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(x_dtype)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    jp = jformats.quantize_mxfp4(jnp.asarray(w))
    codes, scales = np.array(jp.codes), np.array(jp.scales)   # writable
    return x, codes, scales


def _tx(x: np.ndarray) -> torch.Tensor:
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x)


# the shapes and tiles of tests/test_kernels.py::test_mxfp4_vmm_shapes
@pytest.mark.parametrize("b,k,n,bk,bn", [
    (1, 128, 256, 64, 128),
    (4, 512, 512, 512, 256),
    (8, 1024, 384, 256, 128),
    (16, 256, 1024, 128, 512),
    (3, 160, 128, 32, 64),
])
def test_ref_matches_jax_oracle_and_pallas(b, k, n, bk, bn):
    x, codes, scales = _case(b * 1000 + k + n, b, k, n)
    got = mxfp4_vmm_ref(_tx(x), torch.from_numpy(codes),
                        torch.from_numpy(scales))
    assert got.dtype == torch.float32 and got.shape == (b, n)
    jargs = (jnp.asarray(x), jnp.asarray(codes), jnp.asarray(scales))
    assert _rel_err(got, jax_ref(*jargs)) <= RTOL
    assert _rel_err(got, pallas_vmm(*jargs, block_n=bn, block_k=bk,
                                    interpret=True)) <= RTOL


@pytest.mark.parametrize("m,k,n", [(1, 96, 100), (5, 544, 8), (37, 64, 333)])
def test_ragged_shapes_match_jax(m, k, n):
    """M = 1, ragged M and N, K a multiple of 32 only: shapes the Pallas
    kernel does not tile (the reference's oracle fallback covers them)."""
    x, codes, scales = _case(m + k + n, m, k, n)
    got = mxfp4_matmul(_tx(x), formats.PackedMXFP4(
        torch.from_numpy(codes), torch.from_numpy(scales), (k, n)),
        out_dtype=torch.float32)
    want = jax_matmul(jnp.asarray(x), jformats.PackedMXFP4(
        jnp.asarray(codes), jnp.asarray(scales), (k, n)),
        out_dtype=jnp.float32)
    assert _rel_err(got, want) <= RTOL
    assert mxfp4_tileable(k, n)


def test_f32_activations_cast_to_bf16_like_the_reference():
    """f32 x is rounded to bf16 before the product and the result comes
    back in x's dtype (``qdot``: out_dtype = x.dtype), as in the
    reference; without the cast the result would differ at ~1e-3."""
    x, codes, scales = _case(9, 6, 256, 64, np.float32)
    jw = jformats.PackedMXFP4(jnp.asarray(codes), jnp.asarray(scales),
                              (256, 64))
    tw = formats.PackedMXFP4(torch.from_numpy(codes),
                             torch.from_numpy(scales), (256, 64))
    got = qdot(torch.from_numpy(x)[None], tw)
    want = np.asarray(jax_matmul(jnp.asarray(x)[None], jw,
                                 out_dtype=jnp.float32))
    assert got.dtype == torch.float32 and got.shape == (1, 6, 64)
    assert _rel_err(got, want) <= RTOL
    exact = x @ np.asarray(formats.dequantize_mxfp4(tw, torch.float32))
    assert _rel_err(got[0], exact) > 1e-4          # the cast did happen


def test_dispatch_on_cpu():
    x, codes, scales = _case(3, 4, 128, 64)
    w = formats.PackedMXFP4(torch.from_numpy(codes),
                            torch.from_numpy(scales), (128, 64))
    before = LAUNCHES[vmm_kernel.NAME]
    auto = mxfp4_matmul(_tx(x), w)
    ref = mxfp4_matmul(_tx(x), w, impl="reference")
    assert torch.equal(auto, ref) and auto.dtype == torch.bfloat16
    assert LAUNCHES[vmm_kernel.NAME] == before        # no kernel on CPU
    with pytest.raises(ValueError, match="CUDA"):
        mxfp4_matmul(_tx(x), w, impl="fused")
    with pytest.raises(ValueError):
        mxfp4_matmul(_tx(x), w, impl="nope")
    with pytest.raises(ValueError, match="CUDA"):
        vmm_kernel.mxfp4_vmm(_tx(x), w.codes, w.scales)


@pytest.mark.parametrize("fmt", ["mxfp8", "bfp", "nxfp4"])
def test_qdot_other_formats_dequantize_then_matmul(fmt):
    x = torch.randn(3, 64)
    w = torch.randn(64, 48) * 0.1
    p = formats.quantize(w, fmt)
    got = qdot(x, p)
    torch.testing.assert_close(got, x @ formats.dequantize(p, fmt,
                                                           torch.float32),
                               rtol=0, atol=0)
    assert torch.equal(qdot(x, w), x @ w)


@pytest.mark.parametrize("m,k,n", [(1, 4096, 4096), (8, 4096, 1024),
                                   (8, 14336, 4096), (256, 4096, 14336),
                                   (2048, 4096, 1024), (37, 544, 1000),
                                   (3, 32, 5)])
def test_split_k_covers_k_without_empty_splits(m, k, n):
    """The host-side schedule the CUDA wrapper hands the kernel: every
    32-row stage belongs to exactly one split, no split is empty, and a
    shape with stages to spare gets ``CTAS_PER_SM`` CTAs per SM of a
    132-SM card."""
    splits, per = vmm_kernel.split_k(m, k, n, 132)
    stages = k // 32
    assert splits >= 1 and per >= 1
    assert (splits - 1) * per < stages <= splits * per
    bm = 16 if m <= 16 else 32 if m <= 32 else 64
    tiles = -(-n // 128) * -(-m // bm)
    want = vmm_kernel.CTAS_PER_SM * 132
    if stages // vmm_kernel.MIN_STAGES_PER_SPLIT >= -(-want // tiles):
        assert tiles * splits >= want


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 4096, 1024), (8, 4096, 4096),
                                   (256, 1024, 14336), (37, 544, 1000)])
def test_cuda_kernel_matches_ref(m, k, n):
    """The hand-written kernel against its plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    w = torch.randn((k, n), generator=gen, device="cuda") * 0.02
    p = formats.quantize_mxfp4(w)
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    out = vmm_kernel.mxfp4_vmm(x, p.codes, p.scales)
    out16 = vmm_kernel.mxfp4_vmm(x, p.codes, p.scales, torch.bfloat16)
    ref = mxfp4_vmm_ref(x, p.codes, p.scales)
    torch.cuda.synchronize()
    assert ((out - ref).abs().max() / ref.abs().max()).item() <= RTOL
    assert torch.equal(out16, out.to(torch.bfloat16))     # one rounding
