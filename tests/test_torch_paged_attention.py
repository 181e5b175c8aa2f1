"""Paged decode attention: the port's plain version against the JAX
reference's oracle and its Pallas kernel (online accumulator, interpret
mode), plus the op wrapper's dispatch rules.  One test holds the CUDA
kernel against the plain version and runs only where there is a card.

Tolerance 1e-5 absolute in f32, not bitwise: on jax 0.9 even the Pallas
interpret paths differ from the JAX oracle by up to ~1e-6 (ROADMAP
Queue 3), and the port sums in another order again."""
import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (import order: models before kernels.ref)
import jax.numpy as jnp

from repro.kernels.decode_attention.paged_kernel import (
    paged_decode_attention as jax_paged_kernel,
)
from repro.kernels.decode_attention.ref import (
    paged_decode_attention_ref as jax_paged_ref,
)
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.decode_attention import ops
from repro_torch.kernels.decode_attention.ref import (
    gather_pages, paged_decode_attention_ref, paged_valid_mask,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op thread pool would only spin on the
    cores the parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 1e-5


def _case(seed, B, H, KVH, D, page, n_blocks, *, scratch_tail=False):
    """Random f32 pools (scratch page 0 poisoned), per-row permuted page
    tables, ragged mid-page positions.  With ``scratch_tail`` each row's
    table past its position points at the scratch page, as the engine's
    tables do."""
    rng = np.random.default_rng(seed)
    P = 1 + B * n_blocks
    ids = rng.permutation(np.arange(1, P))
    table = ids.reshape(B, n_blocks).astype(np.int32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = rng.standard_normal((P, page, KVH, D)).astype(np.float32)
    vp = rng.standard_normal((P, page, KVH, D)).astype(np.float32)
    kp[0], vp[0] = 1e4, -1e4
    pos = rng.integers(0, page * n_blocks, B).astype(np.int32)
    pos[0] = page + page // 2                      # mid-page
    if scratch_tail:
        live = np.arange(n_blocks)[None, :] <= (pos // page)[:, None]
        table = np.where(live, table, 0).astype(np.int32)
    return q, kp, vp, table, pos


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


CASES = [
    # seed, B, H, KVH, D, page, n_blocks, scratch_tail, window
    (0, 3, 8, 2, 32, 8, 5, True, None),      # GQA 4:1, dead tail pages
    (1, 2, 16, 2, 64, 16, 3, True, None),    # GQA 8:1
    (2, 1, 4, 4, 16, 4, 7, False, None),     # MHA, many small pages
    (3, 3, 8, 2, 32, 8, 5, True, 5),         # sliding window
    (4, 2, 8, 2, 32, 8, 6, False, 11),       # window across pages
]


@pytest.mark.parametrize("seed,B,H,KVH,D,page,nb,tail,window", CASES)
def test_ref_matches_jax_oracle_and_pallas_kernel(seed, B, H, KVH, D, page,
                                                  nb, tail, window):
    q, kp, vp, table, pos = _case(seed, B, H, KVH, D, page, nb,
                                  scratch_tail=tail)
    got = paged_decode_attention_ref(*_torch(q, kp, vp, table, pos),
                                     window=window).numpy()
    jargs = [jnp.asarray(a) for a in (q, kp, vp, table, pos)]
    oracle = np.asarray(jax_paged_ref(*jargs, window=window))
    pallas = np.asarray(jax_paged_kernel(*jargs, window=window,
                                         accum="online", interpret=True))
    np.testing.assert_allclose(got, oracle, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=ATOL)


def test_gather_and_mask():
    q, kp, vp, table, pos = _case(5, 2, 4, 2, 16, 4, 3)
    kt, tt, pt = _torch(kp, table, pos)
    g = gather_pages(kt, tt)
    assert g.shape == (2, 12, 2, 16)
    np.testing.assert_array_equal(g[1, 4:8].numpy(), kp[table[1, 1]])
    m = paged_valid_mask(tt, 4, pt, window=3).numpy()
    idx = np.arange(12)[None, :]
    np.testing.assert_array_equal(
        m, (idx <= pos[:, None]) & (idx > pos[:, None] - 3))


def test_op_dispatch_on_cpu():
    q, kp, vp, table, pos = _torch(*_case(6, 2, 8, 2, 32, 8, 4))
    before = LAUNCHES["paged_decode_attention"]
    auto = ops.paged_gqa_decode_attention(q, kp, vp, table, pos)
    ref = ops.paged_gqa_decode_attention(q, kp, vp, table, pos,
                                         impl="reference")
    np.testing.assert_array_equal(auto.numpy(), ref.numpy())
    assert LAUNCHES["paged_decode_attention"] == before   # no kernel on CPU
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_gqa_decode_attention(q, kp, vp, table, pos, impl="fused")
    with pytest.raises(ValueError):
        ops.paged_gqa_decode_attention(q, kp, vp, table, pos, impl="nope")
    with pytest.raises(NotImplementedError, match="Quantization"):
        ops.paged_gqa_decode_attention(q, kp, vp, table, pos,
                                       k_scales=kp[..., 0], v_scales=vp[..., 0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 7])
def test_cuda_kernel_matches_ref(dtype, window):
    """The hand-written kernel against its plain version on the card
    (f32 pools within 1e-5; bf16 pools within 2e-2 on the bf16 output)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dt = getattr(torch, dtype)
    q, kp, vp, table, pos = [t.cuda() for t in _torch(
        *_case(7, 4, 32, 8, 128, 16, 9, scratch_tail=True))]
    q, kp, vp = q.to(dt), kp.to(dt), vp.to(dt)
    out = ops.paged_gqa_decode_attention(q, kp, vp, table, pos, window=window)
    ref = paged_decode_attention_ref(q, kp, vp, table, pos, window=window)
    torch.cuda.synchronize()
    tol = 1e-5 if dt == torch.float32 else 2e-2
    assert (out.float() - ref.float()).abs().max().item() <= tol
