"""The port's Mamba2 SSD mixer (``repro_torch/models/ssm.py``) and the
``ssm`` / ``hybrid`` blocks of ``Model`` against the reference on the CPU.

Mixer functions: ``_causal_conv`` (with and without ``valid``, rows of
``valid = 0`` included), ``_ssd_chunked`` (S not a multiple of the chunk,
with and without an incoming state), ``ssm_forward`` and
``ssm_decode_step``, softplus and the gated RMSNorm, and chunked prefill
against the decode chain.  Models: reduced mamba2-370m (2 layers) and the
reference's 3-layer hymba fixture (global, windowed, global), whose
weights come from the reference ``Model.init`` through
``bridge.params_from_jax``: ``Model.forward``, the static prefill and
decode (logits and caches), the paged chunk and decode steps with their
state pools, in f32 and bf16.  Inputs come from seeded numpy generators.

Tolerances: f32 within 1e-5 of the larger magnitude involved (XLA:CPU and
PyTorch sum in other orders), and within ``PAGED_F32_TOL`` on the paged
entries, whose f32 conv state rounds to a bf16 pool in both (the
reference's layout); bf16 within
``BF16_ULPS`` bf16 ulps of the output's largest magnitude (XLA fuses some
bf16 elementwise chains that PyTorch rounds op by op)."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (import order: models before kernels)
import jax
import jax.numpy as jnp
import ml_dtypes

from repro.configs import get_config, reduced_config
from repro.models import common as jcommon
from repro.models import ssm as jssm
from repro.models.model import build_model, build_plan as jbuild_plan
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.models import common as tcommon
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm
from repro_torch.models.model import Model, build_plan

MAMBA = "mamba2-370m"
HYMBA = "hymba-1.5b"
F32_TOL = 1e-5
# the paged entries of an f32 model: its conv state rows round to the bf16
# pool (the reference's layout), and an f32 difference of ~1e-6 upstream
# can move such a rounding by one bf16 ulp, which reaches the next steps'
# logits at ~1e-4 of their magnitude on the hymba fixture
PAGED_F32_TOL = 5e-4
BF16_ULPS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op thread pool would only spin on the
    cores the parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(name: str):
    """The reference's reduced config and the port's; hymba stretched to
    the reference's 3-layer fixture so that the middle layer is windowed
    (a 2-layer hymba is global at both layers)."""
    jcfg = reduced_config(get_config(name))
    tcfg = tconfigs.reduced_config(tconfigs.get_config(name))
    if name == HYMBA:
        jcfg = dataclasses.replace(jcfg, n_layers=3, global_attn_every=3)
        tcfg = dataclasses.replace(tcfg, n_layers=3, global_attn_every=3)
    return jcfg, tcfg


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _close(got, want, tol=F32_TOL, rel=True):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    scale = max(1.0, float(np.abs(want).max())) if rel else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _bf16_close(got, want, ulps=BF16_ULPS):
    """Within ``ulps`` bf16 ulps of the largest |want| (bf16 has 8
    significant bits: an ulp at magnitude m is 2^(floor(log2 m) - 7))."""
    want = np.asarray(want, np.float32)
    m = float(np.abs(want).max())
    ulp = 2.0 ** (np.floor(np.log2(max(m, 1e-30))) - 7)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=ulps * ulp)


def _mixer(cfg_j, seed: int, dtype: str):
    """Reference mixer weights (``init_ssm``) and the port's ``SSM`` module
    holding the same values, both in ``dtype``."""
    p = jssm.init_ssm(jax.random.PRNGKey(seed), cfg_j)
    tcfg = tcommon.ModelConfig(**dataclasses.asdict(cfg_j))
    mod = tssm.SSM(tcfg, "cpu")
    with torch.no_grad():
        for k, v in p.items():
            getattr(mod, k).copy_(_t(v))
    if dtype == "f32":
        p = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), p)
        mod = mod.float()
    return p, mod, tcfg


def _x(shape, seed, dtype, scale=0.5):
    a = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _hold(got, want, dtype):
    if dtype == "bf16":
        _bf16_close(_np(got), np.asarray(want, np.float32))
    else:
        _close(_np(got), want)


# ---------------------------------------------------------------------------
# the mixer's functions
# ---------------------------------------------------------------------------


def test_softplus_and_gated_rmsnorm_match_jax():
    """softplus the reference's way (``logaddexp(x, 0)``) over a range
    that crosses torch's threshold of 20 and the float extremes; the gated
    RMSNorm in f32 and bf16."""
    x = np.concatenate([np.linspace(-90, 90, 2001),
                        [0.0, 1e-30, -1e-30, 20.0, 20.5, 88.0]]
                       ).astype(np.float32)
    _close(_np(tssm.softplus(torch.from_numpy(x))),
           jax.nn.softplus(jnp.asarray(x)), tol=1e-6)
    for dtype in ("f32", "bf16"):
        jx, tx = _x((3, 5, 48), 1, dtype, 2.0)
        jz, tz = _x((3, 5, 48), 2, dtype, 2.0)
        w = np.random.default_rng(3).standard_normal(48).astype(np.float32)
        _hold(tcommon.gated_rmsnorm(tx, tz, torch.from_numpy(w)),
              jcommon.gated_rmsnorm(jx, jz, jnp.asarray(w)), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("valid", [None, "ragged", "zeros"])
def test_causal_conv_matches_reference(valid, dtype):
    """Output and carried state from a nonzero incoming state; ``valid``
    ends each row's state at its boundary (a row of 0 returns the incoming
    state, a row of S the tail)."""
    B, S, C, K = 4, 9, 24, 4
    rng = np.random.default_rng(7)
    jx, tx = _x((B, S, C), 4, dtype)
    w = (rng.standard_normal((K, C)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(C) * 0.1).astype(np.float32)
    st = (rng.standard_normal((B, K - 1, C)) * 0.5).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    v = {None: None, "ragged": np.array([0, 3, 9, 1], np.int32),
         "zeros": np.zeros(B, np.int32)}[valid]
    jout, jst = jssm._causal_conv(jx, jnp.asarray(w, jdt), jnp.asarray(b, jdt),
                                  jnp.asarray(st, jnp.bfloat16),
                                  valid=None if v is None else jnp.asarray(v))
    tout, tst = tssm._causal_conv(tx, torch.from_numpy(w).to(tdt),
                                  torch.from_numpy(b).to(tdt),
                                  torch.from_numpy(st).to(torch.bfloat16),
                                  valid=None if v is None
                                  else torch.from_numpy(v))
    assert tout.dtype == tdt and tst.dtype == tdt
    _hold(tout, jout, dtype)
    np.testing.assert_array_equal(_np(tst), np.asarray(jst, np.float32))
    if valid == "zeros":
        np.testing.assert_array_equal(_np(tst), np.asarray(
            jnp.asarray(st, jnp.bfloat16), np.float32))


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("S", [5, 16, 37])
def test_ssd_chunked_matches_reference(S, with_h0):
    """The chunked scan in f32 at S below, at and past the chunk (16; 37
    pads the last chunk), from a zero or a random incoming state; two
    groups over 8 heads."""
    cfg = dataclasses.replace(reduced_config(get_config(MAMBA)),
                              ssm_groups=2)
    B, H, P, G, N = 2, 8, 8, 2, 8
    rng = np.random.default_rng(S)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    b = rng.standard_normal((B, S, G, N)).astype(np.float32)
    c = rng.standard_normal((B, S, G, N)).astype(np.float32)
    dt = np.abs(rng.standard_normal((B, S, H))).astype(np.float32) * 0.3
    A = np.linspace(1.0, 16.0, H).astype(np.float32)
    h0 = (rng.standard_normal((B, H, P, N)).astype(np.float32)
          if with_h0 else None)
    jy, jh = jssm._ssd_chunked(*(jnp.asarray(a) for a in (x, b, c, dt, A)),
                               cfg, None if h0 is None else jnp.asarray(h0))
    tcfg = tcommon.ModelConfig(**dataclasses.asdict(cfg))
    ty, th = tssm._ssd_chunked(*(torch.from_numpy(a) for a in (x, b, c, dt,
                                                               A)),
                               tcfg, None if h0 is None
                               else torch.from_numpy(h0))
    assert np.isfinite(_np(ty)).all()
    _close(_np(ty), jy)
    _close(_np(th), jh)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["fresh", "state", "valid"])
def test_ssm_forward_matches_reference(mode, dtype):
    """The mixer over (B, S, D): from no state, from a carried state, and
    with per-row ``valid`` (dt 0 past it; the state at the boundary).
    Outputs at padded positions are garbage in both and not compared."""
    cfg, _ = _configs(MAMBA)
    p, mod, tcfg = _mixer(cfg, 3, dtype)
    B, S = 3, 21
    jx, tx = _x((B, S, cfg.d_model), 5, dtype)
    jst = tst = None
    v = None
    if mode != "fresh":
        rng = np.random.default_rng(9)
        conv = rng.standard_normal((B, cfg.conv_kernel - 1, cfg.d_inner
                                    + 2 * cfg.ssm_state)).astype(np.float32)
        h = (rng.standard_normal((B, cfg.n_ssm_heads, cfg.ssm_head_dim,
                                  cfg.ssm_state)) * 0.2).astype(np.float32)
        jst = {"conv": jnp.asarray(conv, jnp.bfloat16), "ssm": jnp.asarray(h)}
        tst = {"conv": torch.from_numpy(conv).to(torch.bfloat16),
               "ssm": torch.from_numpy(h)}
    if mode == "valid":
        v = np.array([21, 7, 0], np.int32)
    jout, jnew = jssm.ssm_forward(jx, p, cfg, jst, valid=None if v is None
                                  else jnp.asarray(v))
    tout, tnew = tssm.ssm_forward(tx, mod, tcfg, tst, valid=None if v is None
                                  else torch.from_numpy(v))
    rows = slice(None) if v is None else [0]     # row 0 is wholly valid
    _hold(tout[rows], np.asarray(jout, np.float32)[rows], dtype)
    if dtype == "f32":
        _close(_np(tnew["conv"]), jnew["conv"])
        _close(_np(tnew["ssm"]), jnew["ssm"])
    else:
        _bf16_close(_np(tnew["conv"]), np.asarray(jnew["conv"], np.float32))
        _close(_np(tnew["ssm"]), jnew["ssm"], tol=2.0 ** -6)
    if mode == "valid":          # a valid = 0 row keeps its state exactly
        np.testing.assert_array_equal(_np(tnew["ssm"][2]), _np(tst["ssm"][2]))
        np.testing.assert_array_equal(_np(tnew["conv"][2]),
                                      _np(tst["conv"][2]))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ssm_decode_step_matches_reference(dtype):
    """Eight recurrent steps from a random state (the conv window summed
    in f32, as the reference sums it): outputs and the carried state."""
    cfg, _ = _configs(HYMBA)
    p, mod, tcfg = _mixer(cfg, 4, dtype)
    B = 3
    rng = np.random.default_rng(11)
    conv = rng.standard_normal((B, cfg.conv_kernel - 1, cfg.d_inner
                                + 2 * cfg.ssm_state)).astype(np.float32)
    h = (rng.standard_normal((B, cfg.n_ssm_heads, cfg.ssm_head_dim,
                              cfg.ssm_state)) * 0.2).astype(np.float32)
    jst = {"conv": jnp.asarray(conv, jnp.bfloat16), "ssm": jnp.asarray(h)}
    tst = {"conv": torch.from_numpy(conv).to(torch.bfloat16),
           "ssm": torch.from_numpy(h)}
    for t in range(8):
        jx, tx = _x((B, cfg.d_model), 20 + t, dtype)
        jout, jst = jssm.ssm_decode_step(jx, p, cfg, jst)
        tout, tst = tssm.ssm_decode_step(tx, mod, tcfg, tst)
        _hold(tout, jout, dtype)
    _close(_np(tst["ssm"]), jst["ssm"], tol=F32_TOL if dtype == "f32"
           else 2.0 ** -6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_chunked_prefill_equals_decode_chain(dtype):
    """The reference's ``test_mamba2_chunked_equals_decode_chain`` on the
    port (S 24 over chunks of 16: a padded second chunk), at its
    tolerances for bf16 and 1e-4 in f32; and the port's chain against the
    reference's chain."""
    cfg, _ = _configs(MAMBA)
    p, mod, tcfg = _mixer(cfg, 0, dtype)
    B, S = 1, 24
    jx, tx = _x((B, S, cfg.d_model), 1, dtype, 0.3)
    y_seq, st_seq = tssm.ssm_forward(tx, mod, tcfg, None)
    st = tssm.init_ssm_state(tcfg, B, device="cpu")
    jst = jssm.init_ssm_state(cfg, B)
    ys = []
    for t in range(S):
        y, st = tssm.ssm_decode_step(tx[:, t], mod, tcfg, st)
        jy, jst = jssm.ssm_decode_step(jx[:, t], p, cfg, jst)
        _hold(y, jy, dtype)
        ys.append(y)
    y_dec = torch.stack(ys, 1)
    atol, rtol = (0.08, 0.1) if dtype == "bf16" else (1e-4, 0.0)
    np.testing.assert_allclose(_np(y_dec), _np(y_seq), atol=atol, rtol=rtol)
    np.testing.assert_allclose(_np(st["ssm"]), _np(st_seq["ssm"]),
                               atol=0.05 if dtype == "bf16" else 1e-4,
                               rtol=0.1 if dtype == "bf16" else 0.0)


def test_state_rows_gather_and_scatter():
    """``_gather_state_rows`` zeroes rows that start at 0;
    ``_scatter_state_rows`` writes real rows only, also when a padding row
    names a real row's slot or a slot no real row writes (no scratch row:
    the pools keep exactly one row a slot)."""
    pool = {"conv": torch.arange(4 * 2 * 3, dtype=torch.float32
                                 ).reshape(4, 2, 3).to(torch.bfloat16),
            "ssm": torch.arange(4 * 5, dtype=torch.float32).reshape(4, 5)}
    before = {k: v.clone() for k, v in pool.items()}
    slot_idx = torch.tensor([2, 0, 2, 3], dtype=torch.int32)
    start = torch.tensor([0, 5, 0, 0], dtype=torch.int32)
    valid = torch.tensor([3, 1, 0, 0], dtype=torch.int32)
    rows = tmodel._gather_state_rows(pool, slot_idx, start)
    assert not rows["ssm"][0].any() and not rows["conv"][2].any()
    torch.testing.assert_close(rows["ssm"][1], before["ssm"][0])
    new = {k: -1.0 - torch.arange(v.numel(), dtype=torch.float32
                                  ).reshape(v.shape) for k, v in rows.items()}
    tmodel._scatter_state_rows(pool, new, slot_idx, valid)
    for k in pool:
        torch.testing.assert_close(pool[k][2], new[k][0].to(pool[k].dtype))
        torch.testing.assert_close(pool[k][0], new[k][1].to(pool[k].dtype))
        torch.testing.assert_close(pool[k][1], before[k][1])
        torch.testing.assert_close(pool[k][3], before[k][3])
    ok = torch.tensor([True, False, True, False])
    upd = {k: torch.full_like(v, 7.0) for k, v in pool.items()}
    kept = {k: v.clone() for k, v in pool.items()}
    tmodel._commit_state_rows(pool, upd, ok)
    for k in pool:
        assert (pool[k][[0, 2]] == 7).all()
        torch.testing.assert_close(pool[k][[1, 3]], kept[k][[1, 3]])


# ---------------------------------------------------------------------------
# plans, parameters and the bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", [MAMBA, HYMBA])
def test_plans_and_parameters_match_reference(name):
    """The full configs' segment plans (mamba2: one ``ssm`` segment of 48;
    hymba: global at 0, 16 and 31, window 1024 elsewhere: 5 segments) and
    every parameter's shape and dtype against the reference's
    ``Model.init`` (traced, not run)."""
    jcfg = get_config(name)
    tcfg = tconfigs.get_config(name)
    assert [dataclasses.astuple(s) for s in build_plan(tcfg)] == \
        [dataclasses.astuple(s) for s in jbuild_plan(jcfg)]
    if name == HYMBA:
        assert [(s.reps, s.window) for s in build_plan(tcfg)] == \
            [(1, None), (15, 1024), (1, None), (14, 1024), (1, None)]
    shapes = jax.eval_shape(build_model(jcfg).init, jax.random.PRNGKey(0))
    meta = Model(tcfg, device="meta")
    locs = [(si, seg.reps > 1) for si, seg in enumerate(meta.plan)
            for _ in range(seg.reps)]
    for pname, prm in meta.named_parameters():
        parts = pname.split(".")
        if parts[0] == "layers":
            si, stacked = locs[int(parts[1])]
            node = shapes["stacks"][si][0]
            for key in parts[2:]:
                node = node[key]
            want = node.shape[1:] if stacked else node.shape
        else:
            node = shapes[pname]
            want = node.shape
        assert tuple(prm.shape) == tuple(want), pname
        assert str(prm.dtype).split(".")[-1] == str(node.dtype), pname
    assert meta.param_count() == sum(
        int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))


@pytest.mark.parametrize("name", [MAMBA, HYMBA])
def test_bridge_round_trip(name):
    """Reference weights into the port and back, bit for bit (f32 leaves
    as they are, bf16 leaves as raw bits), across hymba's three
    segments."""
    jcfg, tcfg = _configs(name)
    params = jax.tree.map(np.asarray,
                          build_model(jcfg).init(jax.random.PRNGKey(1)))
    back = params_to_numpy(params_from_jax(params, tcfg, device="cpu"))
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        b = flat_b[path]
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


# ---------------------------------------------------------------------------
# whole models: forward, static and paged entries
# ---------------------------------------------------------------------------


def _models(name: str, dtype: str):
    jcfg, tcfg = _configs(name)
    ref = build_model(jcfg)
    params = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    port = params_from_jax(params, tcfg, device="cpu")
    if dtype == "f32":
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
        port = port.float()
    return jcfg, ref, params, port


@pytest.fixture(scope="module", params=[(MAMBA, "f32"), (MAMBA, "bf16"),
                                        (HYMBA, "f32"), (HYMBA, "bf16")],
                ids=lambda p: f"{p[0].split('-')[0]}-{p[1]}")
def models(request):
    return (*_models(*request.param), request.param[1])


def _hold_logits(got, want, dtype):
    if dtype == "bf16":
        _bf16_close(_np(got), np.asarray(want, np.float32))
    else:
        _close(_np(got), want)


def test_forward_logits_match_reference(models):
    cfg, ref, params, port, dtype = models
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 37))
    _hold_logits(port.forward(torch.from_numpy(toks)),
                 ref.forward(params, {"tokens": jnp.asarray(toks,
                                                            jnp.int32)}),
                 dtype)


def _hold_states(tcache, jcache, plan, dtype):
    """Every layer's SSM state in the static caches against the
    reference's: the same dtypes (the prefill replaces the zero bf16 conv
    tail with one in the activation dtype, as the reference's functional
    cache does), f32 states within 1e-5 in an f32 model and 2^-6 in a
    bf16 one (its inputs are bf16-rounded), bf16 leaves within
    ``BF16_ULPS``."""
    li = 0
    for si, seg in enumerate(plan):
        for r in range(seg.reps):
            jc = jcache[si][0]
            tc = tcache[li]
            if seg.kinds == ("hybrid",):
                jc, tc = jc["ssm"], tc["ssm"]
            for key in ("conv", "ssm"):
                j = np.asarray(jc[key][r] if seg.reps > 1 else jc[key])
                t = tc[key]
                assert str(t.dtype).split(".")[-1] == str(j.dtype), key
                if t.dtype == torch.bfloat16:
                    _bf16_close(_np(t), j.astype(np.float32))
                else:
                    _close(_np(t), j, tol=F32_TOL if dtype == "f32"
                           else 2.0 ** -6)
            li += 1


def test_static_prefill_decode_match_reference(models):
    """Prompts of 19 tokens (past hymba's window of 8): the prefill's
    logits and state caches, then six decode steps' logits and the states
    after them (hymba's windowed layer wraps its 8-entry ring)."""
    cfg, ref, params, port, dtype = models
    B, S, max_len = 2, 19, 32
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                             (B, S)).astype(np.int32)
    cdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    jcache = ref.init_cache(B, max_len, dtype=cdt)
    tcache = port.init_cache(B, max_len, dtype=torch.float32
                             if dtype == "f32" else None)
    jl, jcache = ref.prefill(params, {"tokens": jnp.asarray(toks)}, jcache)
    tl = port.prefill(torch.from_numpy(toks), tcache)
    _hold_logits(tl, jl, dtype)
    _hold_states(tcache, jcache, port.plan, dtype)
    tok = np.asarray(jl, np.float32).argmax(-1).astype(np.int32)
    for pos in range(S, S + 6):
        jl, jcache = ref.decode_step(params, jnp.asarray(tok), jcache,
                                     jnp.int32(pos))
        tl = port.decode_step(torch.from_numpy(tok), tcache, pos)
        _hold_logits(tl, jl, dtype)
        tok = np.asarray(jl, np.float32).argmax(-1).astype(np.int32)
    _hold_states(tcache, jcache, port.plan, dtype)


def test_paged_chunk_and_decode_match_reference(models):
    """Two slots through ``prefill_chunk_paged`` (chunks of 8 at ragged
    valid counts; a padding row in every bucket naming slot 0) and four
    ``decode_step_paged`` steps in which one slot decodes and the other
    does not (``state_ok``): logits, state pools and KV pools against
    the reference's (f32 within ``PAGED_F32_TOL``)."""
    cfg, ref, params, port, dtype = models

    def hold(got, want, kind=dtype):
        if kind == "bf16":
            _bf16_close(_np(got), np.asarray(want, np.float32))
        else:
            _close(_np(got), want, tol=PAGED_F32_TOL)
    page, n_blocks, num_pages = 4, 8, 20
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    jpools = ref.init_paged_cache(num_pages, page, dtype=jdt)
    tpools = port.init_paged_cache(num_pages, page, dtype=tdt)
    jst = ref.init_state_pools(2)
    tst = port.init_state_pools(2)
    table = np.zeros((2, n_blocks), np.int32)
    table[0] = np.arange(1, 1 + n_blocks)
    table[1] = np.arange(1 + n_blocks, 1 + 2 * n_blocks)
    rng = np.random.default_rng(5)
    lens = (13, 6)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    C = 8
    for start in (0, 8):
        toks = np.zeros((4, C), np.int32)       # bucket of 4: two padding
        tab = np.zeros((4, n_blocks), np.int32)
        st = np.zeros(4, np.int32)
        va = np.zeros(4, np.int32)
        for i, p in enumerate(prompts):
            n = max(0, min(C, len(p) - start))
            toks[i, :n] = p[start:start + n]
            tab[i] = table[i] if n else 0
            st[i] = start if n else 0
            va[i] = n
        slots = np.array([0, 1, 0, 0], np.int32)
        jl, jpools, jst = ref.prefill_chunk_paged(
            params, jnp.asarray(toks), jpools, jnp.asarray(tab),
            jnp.asarray(st), jnp.asarray(va), states=jst,
            slot_idx=jnp.asarray(slots))
        tl = port.prefill_chunk_paged(
            torch.from_numpy(toks), tpools, torch.from_numpy(tab),
            torch.from_numpy(st), torch.from_numpy(va), states=tst,
            slot_idx=torch.from_numpy(slots))
        live = [i for i in range(4) if va[i]]
        hold(tl[live], np.asarray(jl, np.float32)[live])
    pos = np.array(lens, np.int32)
    tok = rng.integers(1, cfg.vocab_size, 2).astype(np.int32)
    for step in range(4):
        ok = np.array([True, step % 2 == 0])
        jl, jpools, jst = ref.decode_step_paged(
            params, jnp.asarray(tok), jpools, jnp.asarray(table),
            jnp.asarray(pos), states=jst, state_ok=jnp.asarray(ok))
        tl = port.decode_step_paged(
            torch.from_numpy(tok), tpools, torch.from_numpy(table),
            torch.from_numpy(pos), states=tst, state_ok=torch.from_numpy(ok))
        hold(tl[ok], np.asarray(jl, np.float32)[ok])
        tok = np.asarray(jl, np.float32).argmax(-1).astype(np.int32)
        pos = pos + ok
    li = 0
    for si, seg in enumerate(port.plan):
        for r in range(seg.reps):
            for key in ("conv", "ssm"):
                j = jst[si][0][key]
                j = j[r] if seg.reps > 1 else j
                t = tst[li][key]
                assert t.shape == j.shape and t.dtype == (
                    torch.float32 if key == "ssm" else torch.bfloat16)
                if key == "conv":
                    hold(t, j, "bf16")
                elif dtype == "f32":
                    hold(t, j)
                else:
                    _close(_np(t), j, tol=2.0 ** -6)
            if cfg.family == "hybrid":
                jp = jpools[si][0]
                for key in ("k", "v"):
                    j = jp[key][r] if seg.reps > 1 else jp[key]
                    hold(tpools[li][key], j)
            else:
                assert tpools[li] == {}
            li += 1


def test_stateful_entry_points_need_state_pools():
    """Paged calls on a stateful model without ``states=`` raise in the
    reference's words; the 2-D (speculative verify) form refuses state
    pools; ``_block_decode_multi_paged`` refuses both stateful kinds."""
    _, tcfg = _configs(HYMBA)
    port = Model(tcfg, device="cpu").init(0)
    pools = port.init_paged_cache(4, 4)
    tab = torch.zeros((1, 1), dtype=torch.int32)
    one = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="per-slot state pools"):
        port.decode_step_paged(one, pools, tab, one)
    with pytest.raises(NotImplementedError, match="per-slot state pools"):
        port.prefill_chunk_paged(tab, pools, tab, one, one)
    with pytest.raises(NotImplementedError, match="state pools"):
        port.decode_step_paged(tab, pools, tab, one,
                               states=port.init_state_pools(1))
    x = torch.zeros((1, 1, tcfg.d_model), dtype=torch.bfloat16)
    for blk in port.layers[:1]:
        with pytest.raises(NotImplementedError, match="stateful layouts"):
            tmodel._block_decode_multi_paged(blk, x, tcfg, None, pools[0],
                                             tab, one, one)
    m = Model(_configs(MAMBA)[1], device="cpu")
    assert m.init_paged_cache(4, 4) == [{}] * m.cfg.n_layers
    pools = m.init_state_pools(3)
    assert all(set(p) == {"conv", "ssm"} and p["ssm"].shape[0] == 3
               for p in pools)
