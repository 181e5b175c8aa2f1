"""Dense-cache decode attention: the port's op (``impl="auto"`` on CPU
tensors: the plain ``decode_attention_ref``) against the reference's op,
which runs its Pallas kernel in interpret mode on these shapes exactly as
``tests/test_kernels.py`` does; garbage beyond ``cur_len`` must not leak
in; the op's dispatch rules.  One test holds the CUDA kernel against the
plain version and runs only where there is a card.

Inputs come from a seeded numpy generator.  Tolerances: f32 1e-5 absolute
(both sides sum in f32, in other orders); bf16 a relative error
(max |diff| / max |ref|) below 0.02, the reference's own test's bound,
against the reference; the card test holds the kernel to one bf16 ulp of
each output."""
import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (import order: models before kernels)
import jax.numpy as jnp
import ml_dtypes

from repro.kernels.decode_attention.ops import (
    gqa_decode_attention as jax_gqa_decode,
)
from repro.kernels.decode_attention.ref import (
    decode_attention_ref as jax_decode_ref,
)
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.decode_attention import ops
from repro_torch.models.common import decode_attention_ref


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op thread pool would only spin on the
    cores the parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the shapes of tests/test_kernels.py::test_decode_attention_shapes
CASES = [
    # b, h, kvh, d, s, block_s
    (1, 8, 8, 64, 256, 128),       # MHA
    (2, 8, 2, 64, 512, 256),       # GQA 4:1
    (4, 16, 2, 128, 384, 128),     # GQA 8:1, odd block count
    (2, 32, 8, 128, 1024, 512),    # llama-like
]
DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16)}


def _inputs(seed, b, h, kvh, d, s, dtype):
    rng = np.random.default_rng(seed)
    npd = DTYPES[dtype][0]
    q = rng.standard_normal((b, h, d)).astype(npd)
    k = rng.standard_normal((b, s, kvh, d)).astype(npd)
    v = rng.standard_normal((b, s, kvh, d)).astype(npd)
    cur = np.asarray([(s * (i + 1)) // (b + 1) + 1 for i in range(b)],
                     np.int32)
    return q, k, v, cur


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
@pytest.mark.parametrize("b,h,kvh,d,s,block_s", CASES)
def test_op_matches_reference_pallas_and_oracle(dtype, b, h, kvh, d, s,
                                                block_s):
    q, k, v, cur = _inputs(b + h + s, b, h, kvh, d, s, dtype)
    got = ops.gqa_decode_attention(*(_torch(a) for a in (q, k, v, cur)))
    assert got.dtype == DTYPES[dtype][1] and got.shape == (b, h, d)
    jargs = [jnp.asarray(a) for a in (q, k, v, cur)]
    _check(got, jax_gqa_decode(*jargs, block_s=block_s), dtype)
    _check(got, jax_decode_ref(*jargs), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ignores_invalid_tail(dtype):
    """Garbage beyond cur_len must not leak into the output (the case of
    tests/test_kernels.py::test_decode_attention_ignores_invalid_tail): the
    plain version's output is unchanged to the bit, and the reference's
    kernel agrees on the poisoned cache."""
    b, h, kvh, d, s = 2, 4, 2, 64, 256
    q, k, v, _ = _inputs(3, b, h, kvh, d, s, dtype)
    cur = np.asarray([64, 128], np.int32)
    k2, v2 = k.copy(), v.copy()
    k2[:, 200:] = 1e4
    v2[:, 200:] = -1e4
    clean = ops.gqa_decode_attention(*(_torch(a) for a in (q, k, v, cur)))
    dirty = ops.gqa_decode_attention(*(_torch(a) for a in (q, k2, v2, cur)))
    np.testing.assert_array_equal(clean.float().numpy(),
                                  dirty.float().numpy())
    want = jax_gqa_decode(*(jnp.asarray(a) for a in (q, k2, v2, cur)))
    _check(dirty, want, dtype)


def test_op_dispatch_on_cpu():
    q, k, v, cur = (_torch(a) for a in _inputs(6, 2, 8, 2, 32, 40,
                                                "float32"))
    before = dict(LAUNCHES)
    auto = ops.gqa_decode_attention(q, k, v, cur)
    ref = decode_attention_ref(q, k, v, cur)
    np.testing.assert_array_equal(auto.numpy(), ref.numpy())
    np.testing.assert_array_equal(
        ops.gqa_decode_attention(q, k, v, cur, impl="reference").numpy(),
        ref.numpy())
    assert dict(LAUNCHES) == before                 # no kernel on CPU
    with pytest.raises(ValueError, match="CUDA"):
        ops.gqa_decode_attention(q, k, v, cur, impl="fused")
    with pytest.raises(ValueError, match="impl"):
        ops.gqa_decode_attention(q, k, v, cur, impl="nope")


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kvh,d,s,block_s", CASES + [
    (8, 32, 8, 128, 2048, 512)])       # the static serve's cache
def test_cuda_kernel_matches_ref(b, h, kvh, d, s, block_s):
    """The kernel against its plain version on the card, with the cache
    past cur_len poisoned (f32 within 1e-5; bf16 within one bf16 ulp,
    2^-7 |ref|, of each output plus 1e-4: both sides sum in f32 and round
    once)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    for dtype in DTYPES:
        q, k, v, cur = _inputs(s, b, h, kvh, d, s, dtype)
        ref = decode_attention_ref(*(_torch(a) for a in (q, k, v, cur)))
        for row, n in enumerate(cur):
            k[row, n:] = 1e4
            v[row, n:] = -1e4
        before = LAUNCHES["decode_attention"]
        out = ops.gqa_decode_attention(*(_torch(a).cuda()
                                         for a in (q, k, v, cur)))
        torch.cuda.synchronize()
        assert LAUNCHES["decode_attention"] == before + 1
        g, w = out.float().cpu().numpy(), ref.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
        else:   # one bf16 ulp of each output, plus f32 sums' other order
            assert (np.abs(g - w) <= 2.0 ** -7 * np.abs(w) + 1e-4).all()
