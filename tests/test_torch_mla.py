"""The port's MLA attention (``repro_torch/models/layers.py`` and the
``mla`` backend of ``attention_backends.py``) against the reference's on
the same weights and inputs, at the reduced deepseek-v2-lite-16b config
(4 heads, qk head 16 + 8 rope, v head 128, latent rank 32).

Covered: ``mla_forward``; ``mla_prefill`` then a chain of ``mla_decode``
over the dense cache (outputs and cache leaves); the three paged paths
(``mla_prefill_chunk_paged``, ``mla_decode_paged``,
``mla_decode_multi_paged``: outputs and pool leaves); the verify path
against C single-token decodes within the port; the fp8/int8 pool refusal;
the backend registration; and, for whole models of 2 layers (an
``mla_dense`` and an ``mla_moe`` segment) and 3 layers (the ``mla_moe``
segment stacks 2 reps), the weight bridge round trip and the paged and
static logits.

Tolerances: f32 outputs, cache and pool entries within 1e-5 of the
largest |value| of the reference's tensor (1e-5 absolute for logits);
XLA:CPU and PyTorch sum the latent products in other orders.  The verify
path against single-token decodes: 1e-6 (f32, the same einsums at other
shapes).  bf16 outputs within 4 bf16 ulps (2^-6) of the largest |value|,
as in ``test_torch_model.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (import order: models before kernels)
import jax
import jax.numpy as jnp

from repro.configs import get_config, reduced_config
from repro.models import attention_backends as jab
from repro.models import layers as jlayers
from repro.models.model import build_model
from repro_torch import configs as tconfigs
from repro_torch.bridge import _to_torch, params_from_jax, params_to_numpy
from repro_torch.models import attention_backends as tab
from repro_torch.models import layers as tlayers

F32_TOL = 1e-5
BF16_TOL = 2.0 ** -6
VERIFY_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op thread pool would only spin on the
    cores the parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NAME = "deepseek-v2-lite-16b"


def _configs(n_layers=None):
    cfg = reduced_config(get_config(NAME))
    tcfg = tconfigs.reduced_config(tconfigs.get_config(NAME))
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
        tcfg = dataclasses.replace(tcfg, n_layers=n_layers)
    return cfg, tcfg


def _layer(f32: bool, seed=0):
    """Reference MLA params and the port's ``MLA`` module with the same
    bits, a non-trivial ``kv_norm``; both in f32 when ``f32``."""
    cfg, tcfg = _configs()
    p = jax.tree.map(np.asarray, jlayers.init_mla(jax.random.PRNGKey(seed),
                                                  cfg))
    p["kv_norm"] = (1 + 0.3 * np.random.default_rng(seed).standard_normal(
        p["kv_norm"].shape)).astype(np.float32)
    mod = tlayers.MLA(tcfg, "cpu")
    with torch.no_grad():
        for name, t in mod.named_parameters():
            t.copy_(_to_torch(p[name]))
    jp = jax.tree.map(jnp.asarray, p)
    if f32:
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        mod = mod.float()
    return cfg, tcfg, jp, mod


def _dtypes(f32):
    return (jnp.float32, torch.float32) if f32 else (jnp.bfloat16,
                                                     torch.bfloat16)


def _x(shape, f32, seed=1):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jd, td = _dtypes(f32)
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _close(j, t, f32, tol=None):
    a = np.asarray(jnp.asarray(j).astype(jnp.float32))
    b = t.float().numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    tol = (tol or (F32_TOL if f32 else BF16_TOL)) * max(np.abs(a).max(), 1e-30)
    assert np.abs(a - b).max() <= tol, (np.abs(a - b).max(), tol)


F32 = pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])


@F32
def test_mla_forward_matches_reference(f32):
    cfg, tcfg, jp, mod = _layer(f32)
    jx, tx = _x((2, 11, cfg.d_model), f32)
    _close(jlayers.mla_forward(jp, jx, cfg), tlayers.mla_forward(mod, tx, tcfg),
           f32)


@F32
def test_mla_prefill_then_decode_matches_reference(f32):
    cfg, tcfg, jp, mod = _layer(f32, seed=2)
    jd, td = _dtypes(f32)
    b, s, max_len = 2, 7, 12
    jx, tx = _x((b, s, cfg.d_model), f32)
    jcache = jlayers.init_mla_cache(cfg, b, max_len, dtype=jd)
    tcache = tlayers.init_mla_cache(tcfg, b, max_len, td, device="cpu")
    jo, jcache = jlayers.mla_prefill(jp, jx, cfg, jcache)
    to = tlayers.mla_prefill(mod, tx, tcfg, tcache)
    _close(jo, to, f32)
    for step in range(3):
        cur = s + step
        jx1, tx1 = _x((b, cfg.d_model), f32, seed=10 + step)
        jo, jcache = jlayers.mla_decode(jp, jx1, cfg, jcache, cur)
        to = tlayers.mla_decode(mod, tx1, tcfg, tcache, cur,
                                positions=torch.full((b, 1), cur))
        _close(jo, to, f32)
    for key in ("c_kv", "k_rope"):
        _close(jcache[key], tcache[key], f32)
    np.testing.assert_array_equal(tcache["slot_pos"].numpy(),
                                  np.asarray(jcache["slot_pos"]))


def _paged_case(rng, b=3, nb=5, page=4):
    pages = 1 + b * nb
    table = rng.permutation(np.arange(1, pages)).reshape(b, nb).astype(np.int32)
    return pages, page, table


def _pools(cfg, tcfg, pages, page, f32):
    jd, td = _dtypes(f32)
    return (jab.init_mla_page_pool(cfg, pages, page, dtype=jd),
            tab.init_mla_page_pool(tcfg, pages, page, td, device="cpu"))


def _close_pools(jpool, tpool, f32):
    for key in ("c_kv", "k_rope"):
        _close(jpool[key], tpool[key], f32)


@F32
def test_paged_prefill_decode_and_verify_match_reference(f32):
    """A ragged prefill chunk (one padding row), two single-token decode
    steps at ragged positions, then a 3-token verify step: outputs and
    every pool leaf against the reference's."""
    cfg, tcfg, jp, mod = _layer(f32, seed=3)
    rng = np.random.default_rng(4)
    pages, page, table = _paged_case(rng)
    jpool, tpool = _pools(cfg, tcfg, pages, page, f32)
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    b, c = 3, 6
    start = np.array([0, 2, 0], np.int32)
    valid = np.array([6, 4, 0], np.int32)
    jx, tx = _x((b, c, cfg.d_model), f32)
    jo, jpool = jab.mla_prefill_chunk_paged(
        jp, jx, cfg, jpool, jt, jnp.asarray(start), jnp.asarray(valid))
    to = tab.mla_prefill_chunk_paged(mod, tx, tcfg, tpool, tt,
                                     torch.from_numpy(start),
                                     torch.from_numpy(valid))
    _close(jo[:2], to[:2], f32)               # row 2 is padding
    _close_pools(jpool, tpool, f32)
    pos = start + valid
    pos[2] = 0
    for step in range(2):
        jx1, tx1 = _x((b, cfg.d_model), f32, seed=20 + step)
        jo, jpool = jab.mla_decode_paged(jp, jx1, cfg, jpool, jt,
                                         jnp.asarray(pos))
        to = tab.mla_decode_paged(mod, tx1, tcfg, tpool, tt,
                                  torch.from_numpy(pos))
        _close(jo, to, f32)
        pos = pos + 1
    _close_pools(jpool, tpool, f32)
    vvalid = np.array([3, 2, 3], np.int32)
    jx, tx = _x((b, 3, cfg.d_model), f32, seed=30)
    jo, jpool = jab.mla_decode_multi_paged(
        jp, jx, cfg, jpool, jt, jnp.asarray(pos), jnp.asarray(vvalid))
    to = tab.mla_decode_multi_paged(mod, tx, tcfg, tpool, tt,
                                    torch.from_numpy(pos),
                                    torch.from_numpy(vvalid))
    _close(jo, to, f32)
    _close_pools(jpool, tpool, f32)


def test_verify_equals_single_token_decodes():
    """Within the port in f32: the C-token verify path gives each
    position the output of C chained single-token decodes (the greedy
    identity of speculation), within 1e-6, and writes the same pools."""
    cfg, tcfg, _, mod = _layer(True, seed=5)
    rng = np.random.default_rng(6)
    pages, page, table = _paged_case(rng)
    tt = torch.from_numpy(table)
    _, pa = _pools(cfg, tcfg, pages, page, True)
    chunk = torch.from_numpy(rng.standard_normal((3, 5, cfg.d_model)).astype(
        np.float32))
    tab.mla_prefill_chunk_paged(mod, chunk, tcfg, pa, tt,
                                torch.zeros(3, dtype=torch.int32),
                                torch.tensor([5, 3, 4], dtype=torch.int32))
    pb = {k: v.clone() for k, v in pa.items()}
    start = torch.tensor([5, 3, 4])
    x = torch.from_numpy(rng.standard_normal((3, 4, cfg.d_model)).astype(
        np.float32))
    multi = tab.mla_decode_multi_paged(mod, x, tcfg, pa, tt, start,
                                       torch.full((3,), 4))
    for j in range(4):
        one = tab.mla_decode_paged(mod, x[:, j], tcfg, pb, tt, start + j)
        _close(one, multi[:, j], True, tol=VERIFY_TOL)
    for key in pa:
        torch.testing.assert_close(pa[key], pb[key], rtol=0, atol=1e-6)


@pytest.mark.parametrize("cache", ["fp8", "int8"])
def test_quantized_latent_pool_raises(cache):
    cfg, tcfg = _configs()
    with pytest.raises(NotImplementedError, match="MLA"):
        jab.init_mla_page_pool(cfg, 4, 4, dtype=cache)
    with pytest.raises(NotImplementedError, match="MLA"):
        tab.init_mla_page_pool(tcfg, 4, 4, cache, device="cpu")


def test_config_and_plan_match_reference():
    """The port's deepseek-v2-lite-16b config, its reduced config and the
    segment plans (1 ``mla_dense`` + 26 ``mla_moe``) are the reference's."""
    full, tfull = get_config(NAME), tconfigs.get_config(NAME)
    assert tfull.__dict__ == full.__dict__
    assert tconfigs.reduced_config(tfull).__dict__ == \
        reduced_config(full).__dict__
    from repro.models.model import build_plan as jplan
    from repro_torch.models.model import build_plan as tplan
    for cfg, tcfg in ((full, tfull), _configs(3)):
        assert [(s.kinds, s.reps, s.window) for s in tplan(tcfg)] == \
            [(s.kinds, s.reps, s.window) for s in jplan(cfg)]
    assert [s.reps for s in tplan(tfull)] == [1, 26]


def test_mla_backend_registration_matches_reference():
    j, t = jab.get_backend("mla"), tab.get_backend("mla")
    for field in ("paged_leaf_keys", "mask_families", "paged_mask_families",
                  "paged_partition_spec"):
        assert getattr(t, field) == getattr(j, field), field
    for kind in ("mla_dense", "mla_moe"):
        assert tab.backend_for_kind(kind) is t
    assert t.supports_paged and t.decode_multi_paged is not None


# ---------------------------------------------------------------------------
# whole models: 2 layers (two segments) and 3 layers (a stacked segment)
# ---------------------------------------------------------------------------

LAYERS = pytest.mark.parametrize("n_layers", [2, 3])


def _model(n_layers, seed=0):
    cfg, tcfg = _configs(n_layers)
    ref = build_model(cfg)
    params = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(seed)))
    return cfg, tcfg, ref, params


@LAYERS
def test_bridge_round_trip_bit_identical(n_layers):
    _, tcfg, ref, params = _model(n_layers)
    model = params_from_jax(params, tcfg, device="cpu")
    assert [seg.reps for seg in model.plan] == [
        seg.reps for seg in ref.plan] == [1, n_layers - 1]
    back = params_to_numpy(model)
    flat_a, tree_a = jax.tree.flatten(params)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@LAYERS
def test_model_paged_and_static_logits_match_reference(n_layers):
    """f32: chunked paged prefill + 3 paged decode steps, and static
    prefill + 2 decode steps + ``forward``, logits within 1e-5."""
    cfg, tcfg, ref, params = _model(n_layers, seed=1)
    jparams = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.float32),
                           params)
    model = params_from_jax(params, tcfg, device="cpu").float()
    rng = np.random.default_rng(2)
    pages, page, table = _paged_case(rng, b=3, nb=6)
    tokens = rng.integers(0, cfg.vocab_size, (3, 8)).astype(np.int32)
    start = np.zeros(3, np.int32)
    valid = np.array([8, 5, 7], np.int32)
    jpools = ref.init_paged_cache(pages, page, dtype=jnp.float32)
    tpools = model.init_paged_cache(pages, page, torch.float32)

    def check(jl, tl):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=F32_TOL)
        return np.asarray(jl).argmax(-1).astype(np.int32)

    jl, jpools = ref.prefill_chunk_paged(
        jparams, jnp.asarray(tokens), jpools, jnp.asarray(table),
        jnp.asarray(start), jnp.asarray(valid))
    tok = check(jl, model.prefill_chunk_paged(
        torch.from_numpy(tokens), tpools, torch.from_numpy(table),
        torch.from_numpy(start), torch.from_numpy(valid)))
    pos = valid.copy()
    for _ in range(3):
        jl, jpools = ref.decode_step_paged(jparams, jnp.asarray(tok), jpools,
                                           jnp.asarray(table),
                                           jnp.asarray(pos))
        tok = check(jl, model.decode_step_paged(
            torch.from_numpy(tok), tpools, torch.from_numpy(table),
            torch.from_numpy(pos)))
        pos = pos + 1

    jcache = ref.init_cache(2, 12, dtype=jnp.float32)
    tcache = model.init_cache(2, 12, torch.float32)
    prompt = tokens[:2, :6]
    jl, jcache = ref.prefill(jparams, {"tokens": jnp.asarray(prompt)}, jcache)
    tok = check(jl, model.prefill(torch.from_numpy(prompt), tcache))
    for cur in (6, 7):
        jl, jcache = ref.decode_step(jparams, jnp.asarray(tok), jcache, cur)
        tok = check(jl, model.decode_step(torch.from_numpy(tok), tcache, cur))
    jf = ref.forward(jparams, {"tokens": jnp.asarray(tokens)})
    np.testing.assert_allclose(model(torch.from_numpy(tokens)).numpy(),
                               np.asarray(jf), rtol=0, atol=F32_TOL)


def test_last_writes_leave_the_pool_as_the_cpu_does():
    """Writes that collide (idle and padding rows on the scratch page) take
    the value of the last writer of their place, so the pool ends as the
    CPU's in-order scatter leaves it whatever order a device applies them
    in; writes to distinct places keep their own values."""
    rng = np.random.default_rng(7)
    phys = torch.tensor([3, 0, 0, 5, 0, 0, 4])
    off = torch.tensor([1, 0, 2, 0, 0, 2, 3])
    vals = torch.from_numpy(rng.standard_normal((7, 5)).astype(np.float32))
    src = tab.last_writes((phys, off), 4)
    np.testing.assert_array_equal(src.numpy(), [0, 4, 5, 3, 4, 5, 6])
    rp = torch.from_numpy(rng.integers(0, 3, 64))       # many collisions
    ro = torch.from_numpy(rng.integers(0, 4, 64))
    want = [max(j for j in range(64) if (rp[j], ro[j]) == (rp[i], ro[i]))
            for i in range(64)]
    np.testing.assert_array_equal(tab.last_writes((rp, ro), 4).numpy(), want)
    a = torch.zeros((8, 4, 5))
    b = torch.zeros((8, 4, 5))
    a.index_put_((phys, off), vals)         # the CPU applies them in order
    for order in (range(7), reversed(range(7))):
        for i in order:                      # any order of the deduped ones
            b[phys[i], off[i]] = vals[src[i]]
        np.testing.assert_array_equal(a.numpy(), b.numpy())
