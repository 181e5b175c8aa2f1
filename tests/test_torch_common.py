"""The port's model substrate (``repro_torch.models.common``) against the
JAX reference on identical numpy inputs, in f32 on the CPU.

Tolerance 1e-5 absolute: both sides compute in f32, but XLA:CPU and
PyTorch use different exp/sin/cos/rsqrt implementations and summation
orders, so results agree to a few ulps rather than bitwise."""
import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (import order: models before kernels)
import jax.numpy as jnp

from repro.models import common as jc
from repro_torch.models import common as tc


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op thread pool would only spin on the
    cores the parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 1e-5


def _both(a: np.ndarray):
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def _close(j, t, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               rtol=0, atol=atol)


def test_rmsnorm():
    rng = np.random.default_rng(0)
    x, w = rng.standard_normal((3, 5, 64)), rng.standard_normal(64)
    (jx, tx), (jw, tw) = _both(x.astype(np.float32)), _both(w.astype(np.float32))
    _close(jc.rmsnorm(jx, jw, 1e-5), tc.rmsnorm(tx, tw, 1e-5))


@pytest.mark.parametrize("pos_shape", [(7,), (2, 7)])
def test_apply_rope(pos_shape):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 4096, pos_shape).astype(np.int32)
    (jx, tx), (jp, tp) = _both(x), _both(pos)
    _close(jc.apply_rope(jx, jp, 500000.0), tc.apply_rope(tx, tp, 500000.0))
    np.testing.assert_array_equal(
        tc.rope_freqs(16, 500000.0).numpy(),
        np.asarray(jc.rope_freqs(16, 500000.0)))


def test_swiglu():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    ws = [(rng.standard_normal(s) / 8).astype(np.float32)
          for s in ((64, 128), (64, 128), (128, 64))]
    jx, tx = _both(x)
    jw = [jnp.asarray(w) for w in ws]
    tw = [torch.from_numpy(w) for w in ws]
    _close(jc.swiglu(jx, *jw), tc.swiglu(tx, *tw))


@pytest.mark.parametrize("ragged,window,blocks", [
    (False, None, (512, 512)),
    (True, None, (512, 512)),
    (True, 5, (512, 512)),
    (True, None, (4, 8)),        # several q and kv blocks, padded tails
    (False, 3, (4, 8)),
])
def test_blocked_attention(ragged, window, blocks):
    rng = np.random.default_rng(3)
    b, sq, skv, h, kvh, d = 3, 11, 29, 4, 2, 16
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, kvh, d)).astype(np.float32)
    off = rng.integers(0, skv - sq, b).astype(np.int32) if ragged else 7
    jq, tq = _both(q)
    jk, tk = _both(k)
    jv, tv = _both(v)
    jo, to = _both(off) if ragged else (off, off)
    qb, kb = blocks
    j = jc.blocked_attention(jq, jk, jv, window=window, q_offset=jo,
                             q_block=qb, kv_block=kb)
    t = tc.blocked_attention(tq, tk, tv, window=window, q_offset=to,
                             q_block=qb, kv_block=kb)
    _close(j, t)


@pytest.mark.parametrize("masked", [False, True])
def test_decode_attention_ref(masked):
    rng = np.random.default_rng(4)
    b, s, h, kvh, d = 3, 20, 8, 2, 16
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = _both(q), _both(k), _both(v)
    if masked:
        valid = rng.random((b, s)) < 0.6
        valid[:, 0] = True
        jm, tm = _both(valid)
        j = jc.decode_attention_ref(jq, jk, jv, None, valid=jm)
        t = tc.decode_attention_ref(tq, tk, tv, None, valid=tm)
    else:
        ln = np.array([1, 9, 20], np.int32)
        jl, tl = _both(ln)
        j = jc.decode_attention_ref(jq, jk, jv, jl)
        t = tc.decode_attention_ref(tq, tk, tv, tl)
    _close(j, t)
