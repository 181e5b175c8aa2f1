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
from repro_torch.kernels.decode_attention import kernel as dense_kernel
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


def test_variant_choice():
    """bf16 q over a bf16 cache takes the tensor-core kernel, every other
    pairing of f32 and bf16 the CUDA-core one; anything else raises."""
    v = dense_kernel.variant
    bf, f32 = torch.bfloat16, torch.float32
    assert [v(bf, bf, d) for d in (64, 128)] == ["tensor_core"] * 2
    assert {v(f32, f32, 128), v(f32, bf, 128), v(bf, f32, 64),
            v(bf, bf, 256)} == {"cuda_core"}
    with pytest.raises(ValueError, match="q dtype"):
        v(torch.float16, bf, 128)
    with pytest.raises(ValueError, match="cache dtype"):
        v(bf, torch.float16, 128)
    with pytest.raises(ValueError, match="head dim"):
        v(bf, bf, 96)


@pytest.mark.parametrize("b,kvh,s,want", [
    (8, 8, 2048, 4),           # the static serve: one wave, 4 splits
    (8, 8, 4096, 4),
    (1, 8, 512, 8),            # legacy speculative: one split per tile
    (1, 8, 2048, 32),          # a wave (33) holds more than the tiles
    (1, 8, 100, 2),            # a ragged last tile
    (1, 8, 64, 1),
    (64, 8, 2048, 1),          # more (row, kv head) pairs than a wave holds
])
def test_split_count_tensor_core(b, kvh, s, want):
    """The tensor-core launch's split count: floor(2 x SMs / (B x KVH)) (one
    wave at two CTAs an SM), at most one per 64-token tile of the cache."""
    assert dense_kernel.split_count("tensor_core", b, kvh, s, 132) == want


def test_split_count_cuda_core_unchanged():
    """The CUDA-core kernel (f32 parity runs) keeps the first version's
    rule, so its sums keep their order."""
    for b, s in ((1, 512), (8, 2048), (8, 4096)):
        want = dense_kernel.num_splits(b, 8, -(-s // 32), 132)
        assert dense_kernel.split_count("cuda_core", b, 8, s, 132) == want


def _emulate_tensor_core(q, k, v, cur_len, n_split, hi_lo=True):
    """The tensor-core kernel's arithmetic in torch: per (row, kv head),
    splits of whole 64-token tiles, four warps each owning 16 tokens of a
    tile with its own f32 online softmax in the log2 domain (running max,
    P = 2^(s c - m), P.V with P as bf16 hi + lo, or one bf16 rounding when
    ``hi_lo`` is False), folded over warps, then over splits in order."""
    b, h, d = q.shape
    kvh = k.shape[2]
    rep = h // kvh
    c = 1.0 / np.sqrt(d) * np.log2(np.e)
    out = torch.empty((b, h, d), dtype=torch.float32)
    bf = torch.bfloat16
    for bi in range(b):
        n = int(cur_len[bi])
        n_tiles = -(-n // 64)
        for g in range(kvh):
            qg = q[bi, g * rep:(g + 1) * rep].float()
            parts = []
            for sp in range(n_split):
                j0, j1 = sp * n_tiles // n_split, (sp + 1) * n_tiles // n_split
                warps = []
                for w in range(4):
                    m = torch.full((rep,), -1e30)
                    l = torch.zeros(rep)
                    acc = torch.zeros(rep, d)
                    for j in range(j0, j1):
                        t0 = j * 64 + 16 * w
                        t1 = min(t0 + 16, n)
                        if t1 <= t0:
                            continue
                        kt = k[bi, t0:t1, g].float()
                        vt = v[bi, t0:t1, g].float()
                        sc = qg @ kt.T
                        m_new = torch.maximum(m, sc.max(-1).values * c)
                        corr = torch.exp2(m - m_new)
                        p = torch.exp2(sc * c - m_new[:, None])
                        l = l * corr + p.sum(-1)
                        hi = p.to(bf).float()
                        pv = hi @ vt
                        if hi_lo:
                            pv = pv + (p - hi).to(bf).float() @ vt
                        acc = acc * corr[:, None] + pv
                        m = m_new
                    warps.append((m, l, acc))
                mx = torch.stack([x[0] for x in warps]).max(0).values
                wt = [torch.exp2(x[0] - mx) for x in warps]
                parts.append((mx, sum(x[1] * t for x, t in zip(warps, wt)),
                              sum(x[2] * t[:, None] for x, t in zip(warps, wt))))
            mx = torch.stack([x[0] for x in parts]).max(0).values
            wt = [torch.exp2(x[0] - mx) for x in parts]
            l = sum(x[1] * t for x, t in zip(parts, wt))
            acc = sum(x[2] * t[:, None] for x, t in zip(parts, wt))
            out[bi, g * rep:(g + 1) * rep] = acc / l.clamp_min(1e-30)[:, None]
    return out.to(q.dtype)


@pytest.mark.parametrize("b,h,kvh,d,s,n_split", [
    (2, 32, 8, 128, 300, 2),       # llama3-8b heads, ragged tiles
    (1, 16, 2, 64, 200, 3),        # D 64, GQA 8:1, a split of one tile
])
def test_tensor_core_precision_path(b, h, kvh, d, s, n_split):
    """The tensor-core kernel's P.V path (P as bf16 hi + lo, f32
    accumulation, per-warp online softmax folded over warps and splits),
    emulated in torch, stays within the card check's limit of the plain
    version, 2^-7 |ref| + 1e-4 per element; it is an order of magnitude
    inside it, and a single bf16 rounding of P is not."""
    q, k, v, _ = (_torch(a) for a in _inputs(7 + d, b, h, kvh, d, s,
                                               "bfloat16"))
    cur = torch.tensor([s - 13 * i for i in range(b)], dtype=torch.int32)
    ref = decode_attention_ref(q, k, v, cur).float()
    f32 = decode_attention_ref(q.float(), k.float(), v.float(), cur)
    limit = 2.0 ** -7 * ref.abs() + 1e-4
    got = _emulate_tensor_core(q, k, v, cur, n_split).float()
    assert ((got - ref).abs() / limit).max() <= 1.0
    # before the output's bf16 rounding: hi + lo keeps P.V at f32 precision
    got32 = _emulate_tensor_core(q.float(), k.float(), v.float(), cur,
                                 n_split)
    one = _emulate_tensor_core(q.float(), k.float(), v.float(), cur,
                               n_split, hi_lo=False)
    err_hl = (got32 - f32).abs().max().item()
    err_one = (one - f32).abs().max().item()
    assert err_hl < 2e-6 < err_one, (err_hl, err_one)


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


@pytest.mark.cuda
@pytest.mark.parametrize("d,h,kvh", [(128, 32, 8), (64, 16, 4)])
def test_cuda_kernel_short_prefix(d, h, kvh):
    """B 1 with a short live prefix (the legacy speculative engine's 288 of
    a 512-token cache, so most splits hold no tile): the kernel is right,
    launches once a call, and leaves the per-device counters at zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    q, k, v, _ = _inputs(288, 1, h, kvh, d, 512, "bfloat16")
    cur = np.asarray([288], np.int32)
    ref = decode_attention_ref(*(_torch(a) for a in (q, k, v, cur)))
    k[:, 288:] = 1e4
    v[:, 288:] = -1e4
    qc, kc, vc, cc = (_torch(a).cuda() for a in (q, k, v, cur))
    w = ref.float().numpy()
    for _ in range(2):
        before = LAUNCHES["decode_attention"]
        out = dense_kernel.decode_attention(qc, kc, vc, cc)
        torch.cuda.synchronize()
        assert LAUNCHES["decode_attention"] == before + 1
        g = out.float().cpu().numpy()
        assert (np.abs(g - w) <= 2.0 ** -7 * np.abs(w) + 1e-4).all()
        assert int(dense_kernel._COUNTERS[qc.device.index].abs().sum()) == 0
