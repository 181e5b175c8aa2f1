"""The port's MoE layer (``repro_torch/models/moe.py``) against the
reference's (``repro/models/moe.py``) on the same weights and inputs, at
the reduced deepseek-v2-lite-16b config (4 experts, top-2, 2 shared
experts) and a 16-expert variant of it.

Covered: ``_routing`` (including a tie, which goes to the lower expert
index as ``jax.lax.top_k`` breaks it), ``moe_dense``, ``moe_capacity``
forced with a skewed router so that assignments are dropped (the kept set
is read back out of the reference's output and compared with the port's
``_dispatch``), ``_chunked`` (chunk budget cut to force chunks),
``moe_forward``'s ``impl="auto"`` rule and the shared experts.

Tolerances: f32 outputs within 1e-6 of the largest |output| (XLA:CPU and
PyTorch sum the expert products in other orders), routing weights within
1e-6, expert ids equal.  bf16 outputs within 2 bf16 ulps (2^-7) of the
largest |output|: the products round once to bf16 on both sides, and the
combine adds in the same order (measured: equal bit for bit at these
shapes).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (import order: models before kernels)
import jax
import jax.numpy as jnp

from repro.configs import get_config, reduced_config
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch.bridge import _to_torch
from repro_torch.models import moe as tmoe

F32_TOL = 1e-6
BF16_TOL = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op thread pool would only spin on the
    cores the parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(n_experts=None):
    cfg = reduced_config(get_config("deepseek-v2-lite-16b"))
    tcfg = tconfigs.reduced_config(tconfigs.get_config("deepseek-v2-lite-16b"))
    if n_experts is not None:
        cfg = dataclasses.replace(cfg, n_experts=n_experts)
        tcfg = dataclasses.replace(tcfg, n_experts=n_experts)
    return cfg, tcfg


def _layer(cfg, tcfg, seed=0, skew=None):
    """Reference MoE params (numpy) and the port's module holding the same
    bits; ``skew`` adds to expert 0's router column, so that inputs with a
    positive mean (``_x(shift=)``) crowd onto expert 0 and the capacity
    path must drop assignments."""
    p = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(seed), cfg))
    if skew is not None:
        p["router"] = p["router"].copy()
        p["router"][:, 0] += skew
    mod = tmoe.MoE(tcfg, "cpu")
    with torch.no_grad():
        for name, t in mod.named_parameters():
            node = p
            for key in name.split("."):
                node = node[key]
            t.copy_(_to_torch(node))
    return p, mod


def _cast(p, mod, f32: bool):
    if not f32:
        return jax.tree.map(jnp.asarray, p), mod
    return (jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.float32), p),
            mod.float())


def _x(shape, f32: bool, seed=1, shift=0.0):
    x = (np.random.default_rng(seed).standard_normal(shape)
         + shift).astype(np.float32)
    if f32:
        return jnp.asarray(x), torch.from_numpy(x)
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).bfloat16()


def _close(jy, ty, f32: bool):
    a = np.asarray(jnp.asarray(jy).astype(jnp.float32))
    b = ty.float().numpy()
    tol = (F32_TOL if f32 else BF16_TOL) * np.abs(a).max()
    assert np.abs(a - b).max() <= tol, (np.abs(a - b).max(), tol)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_routing_matches_reference(f32):
    cfg, tcfg = _configs(n_experts=16)
    p, mod = _layer(cfg, tcfg)
    jx, tx = _x((40, cfg.d_model), f32)
    jw, jids = jmoe._routing(jx, jnp.asarray(p["router"]), 6)
    tw, tids = tmoe._routing(tx, mod.router, 6)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                               atol=F32_TOL)


def test_routing_tie_goes_to_the_lower_expert():
    """Equal probabilities (duplicated router columns, and a row of zeros
    whose probabilities are all equal) pick the lower expert index
    first, on both sides."""
    cfg, tcfg = _configs(n_experts=8)
    rng = np.random.default_rng(3)
    router = rng.standard_normal((cfg.d_model, 8)).astype(np.float32)
    router[:, 5] = router[:, 2]
    router[:, 7] = router[:, 1]
    x = rng.standard_normal((12, cfg.d_model)).astype(np.float32)
    x[0] = 0.0
    for k in (1, 2, 3, 8):
        jw, jids = jmoe._routing(jnp.asarray(x), jnp.asarray(router), k)
        tw, tids = tmoe._routing(torch.from_numpy(x),
                                 torch.from_numpy(router), k)
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                                   atol=F32_TOL)
    _, ids = tmoe._routing(torch.from_numpy(x), torch.from_numpy(router), 8)
    np.testing.assert_array_equal(ids[0].numpy(), np.arange(8))
    for row in ids.numpy():      # a tied pair appears lower index first
        pos = {e: i for i, e in enumerate(row)}
        assert pos[2] < pos[5] and pos[1] < pos[7]


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_moe_dense_matches_reference(f32):
    cfg, tcfg = _configs()
    jp, mod = _cast(*_layer(cfg, tcfg), f32)
    jx, tx = _x((3, 7, cfg.d_model), f32)
    _close(jmoe.moe_dense(jx, jp, cfg), tmoe.moe_dense(tx, mod, tcfg), f32)


def _kept_from_output(y, w, ids, y_all):
    """Which of each token's k assignments the reference kept, read out of
    its capacity output: y[t] = sum over kept j of w[t, j] * y_all[t,
    ids[t, j]], with every subset of the k tried."""
    t, k = ids.shape
    subsets = np.array([[(s >> j) & 1 for j in range(k)]
                        for s in range(1 << k)], bool)
    kept = np.zeros((t, k), bool)
    for i in range(t):
        parts = w[i][:, None] * y_all[i, ids[i]]                # (k, D)
        err = [np.abs(y[i] - parts[m].sum(0)).max() for m in subsets]
        kept[i] = subsets[int(np.argmin(err))]
    return kept


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_moe_capacity_drops_the_reference_assignments(f32):
    """A router skewed toward expert 0 overflows its capacity and the
    outputs agree; in f32 the port keeps exactly the reference's
    assignments (read back out of the reference's output)."""
    cfg, tcfg = _configs()
    p, mod = _layer(cfg, tcfg, seed=2, skew=0.1)
    jp, mod = _cast(p, mod, f32)
    jx, tx = _x((2, 9, cfg.d_model), f32, seed=4, shift=1.0)
    jy = jmoe.moe_capacity(jx, jp, cfg)
    ty = tmoe.moe_capacity(tx, mod, tcfg)
    _close(jy, ty, f32)

    t, k, e = 18, cfg.n_experts_per_token, cfg.n_experts
    cap = max(int(np.ceil(t * k / e * 1.25)), 1)
    w, ids = tmoe._routing(tx.reshape(t, -1), mod.router, k)
    order, _, _, keep = tmoe._dispatch(ids, e, cap)
    port_kept = torch.zeros(t * k, dtype=torch.bool)
    port_kept[order] = keep
    port_kept = port_kept.view(t, k).numpy()
    assert (~port_kept).sum() >= 4, "the skew must force drops"
    assert (np.bincount(ids.numpy()[port_kept], minlength=e) <= cap).all()
    if not f32:     # bf16 rounding hides which subset the output sums
        return
    # every expert's output on every token, through the reference's dense
    # products
    pf = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.float32), p)
    xf = jnp.asarray(jx).astype(jnp.float32).reshape(t, -1)
    g = jnp.einsum("td,edf->tef", xf, pf["w_gate"])
    u = jnp.einsum("td,edf->tef", xf, pf["w_up"])
    y_all = np.asarray(jnp.einsum("tef,efd->ted", jax.nn.silu(g) * u,
                                  pf["w_down"]))
    ref_kept = _kept_from_output(
        np.asarray(jnp.asarray(jy).astype(jnp.float32)).reshape(t, -1),
        w.numpy(), ids.numpy(), y_all)
    np.testing.assert_array_equal(port_kept, ref_kept)


def test_dispatch_rank_and_drop_rule():
    """The drop policy on hand-made ids: per expert the earliest-sorted
    assignments (token-major) win, ids >= n_buckets are dropped."""
    ids = torch.tensor([[0, 1], [0, 2], [0, 1], [3, 0], [4, 2]])
    order, stok, cell, keep = tmoe._dispatch(ids, 4, 2)
    kept = torch.zeros(10, dtype=torch.bool)
    kept[order] = keep
    want = [[1, 1], [1, 1], [0, 1], [1, 0], [0, 1]]
    np.testing.assert_array_equal(kept.view(5, 2).numpy(), np.array(want, bool))
    np.testing.assert_array_equal(stok.numpy(),
                                  ids.reshape(-1).argsort(stable=True) // 2)
    assert sorted(cell[keep].tolist()) == [0, 1, 2, 3, 4, 5, 6]


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_chunked_matches_reference(f32, monkeypatch):
    """With the chunk budget cut to 8 tokens, (2, 12) tokens run as 3
    chunks of 4 positions on both sides (capacity per chunk)."""
    cfg, tcfg = _configs()
    jp, mod = _cast(*_layer(cfg, tcfg, seed=5, skew=0.1), f32)
    jx, tx = _x((2, 12, cfg.d_model), f32, seed=6, shift=1.0)
    monkeypatch.setattr(jmoe, "MOE_CHUNK_TOKENS", 8)
    monkeypatch.setattr(tmoe, "MOE_CHUNK_TOKENS", 8)
    seen = []

    def fn(xc):
        seen.append(tuple(xc.shape))
        return tmoe.moe_capacity(xc, mod, tcfg)

    jy = jmoe._chunked(lambda xc: jmoe.moe_capacity(xc, jp, cfg), jx)
    ty = tmoe._chunked(fn, tx)
    assert seen == [(2, 4, cfg.d_model)] * 3
    _close(jy, ty, f32)
    whole = tmoe.moe_capacity(tx, mod, tcfg)
    assert not torch.equal(ty, whole), "chunks must change the capacity"


@pytest.mark.parametrize("n_experts,impl", [(4, "dense"), (32, "capacity")])
@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_moe_forward_auto_and_shared_experts(n_experts, impl, f32,
                                             monkeypatch):
    """``impl="auto"`` takes the reference's path (dense at <= 16 experts,
    capacity above), and the shared experts are added on both sides."""
    cfg, tcfg = _configs(n_experts=n_experts)
    jp, mod = _cast(*_layer(cfg, tcfg, seed=7), f32)
    jx, tx = _x((2, 5, cfg.d_model), f32, seed=8)
    taken = []
    for name in ("moe_dense", "moe_capacity"):
        fn = getattr(tmoe, name)
        monkeypatch.setattr(tmoe, name, lambda *a, _f=fn, _n=name, **kw: (
            taken.append(_n), _f(*a, **kw))[1])
    jy = jmoe.moe_forward(jx, jp, cfg)
    ty = tmoe.moe_forward(tx, mod, tcfg)
    assert taken == [f"moe_{impl}"]
    _close(jy, ty, f32)
    assert cfg.n_shared_experts == 2 and hasattr(mod, "shared")
    routed = tmoe.moe_forward(tx, mod, dataclasses.replace(
        tcfg, n_shared_experts=0), impl=impl)
    assert not torch.equal(routed, ty)


@pytest.mark.parametrize("n_experts,shape,want", [
    (4, (2, 5), ("dense", 1)), (32, (2, 12), ("capacity", 3)),
    (32, (3, 7), ("capacity", 1))])
def test_moe_plan_is_what_moe_forward_runs(n_experts, shape, want,
                                           monkeypatch):
    """``moe_plan`` (which the collective-byte predictors read) names the
    strategy ``moe_forward`` runs and the number of dispatch chunks it
    makes, with the chunk budget cut to 8 tokens."""
    cfg, tcfg = _configs(n_experts=n_experts)
    _, mod = _cast(*_layer(cfg, tcfg, seed=7), True)
    _, tx = _x((*shape, cfg.d_model), True, seed=8)
    monkeypatch.setattr(tmoe, "MOE_CHUNK_TOKENS", 8)
    taken = []
    for name in ("moe_dense", "moe_capacity"):
        fn = getattr(tmoe, name)
        monkeypatch.setattr(tmoe, name, lambda *a, _f=fn, _n=name, **kw: (
            taken.append(_n), _f(*a, **kw))[1])
    tmoe.moe_forward(tx, mod, tcfg)
    assert tmoe.moe_plan(tcfg, *shape) == want
    assert taken == [f"moe_{want[0]}"] * want[1]


def test_moe_forward_refusals():
    cfg, tcfg = _configs()
    _, mod = _layer(cfg, tcfg)
    x = torch.zeros((1, 2, tcfg.d_model), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="expert-parallel context"):
        tmoe.moe_forward(x, mod, tcfg, impl="ep")
    with pytest.raises(ValueError, match="moe impl"):
        tmoe.moe_forward(x, mod, tcfg, impl="sparse")
