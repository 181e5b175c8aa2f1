"""The port's training substrate on the CPU against the reference's:
``lr_schedule``, ``global_norm`` and ``adamw_update`` on one numpy tree
(f32 and bf16 state), one ``make_train_step`` step from bridged weights
(the loss and every updated leaf, carried back through
``params_to_numpy``), and the reference's ``tests/test_train.py`` cases on
the port: the loss decreases, a resumed run equals a straight one bit for
bit, an injected failure recovers, a failure before the first checkpoint
raises, a torn checkpoint is never listed, bf16 accumulators; and the
tensor-parallel refusals.

Tolerances: the optimizer on one tree matches in f32 within 2e-6 of each
leaf (XLA and PyTorch round ``pow``, ``sqrt`` and the global norm's sum in
their own orders); bf16 parameters within one bf16 ulp.  The train step
in f32 (weights cast from the bridged bf16 ones on both sides): the loss
within 1e-5, each updated leaf within 1e-6 + 1e-5 of its magnitude; in
bf16 the loss within 1e-2 and each leaf within 2 bf16 ulps of its
magnitude (the update is ``lr`` times a ratio near +-1, so gradients that
differ by rounding move a weight by the same step).
"""
import os

import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (import order: models before kernels)
import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.data.pipeline import SyntheticTokenPipeline as RefPipeline
from repro.models.model import build_model
from repro.train import optimizer as ref_opt
from repro.train.train_step import TrainState as RefTrainState
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import get_config, reduced_config
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.models.model import Model
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import optimizer as opt
from repro_torch.train.loop import LoopConfig, batch_to, run_training
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import (
    TrainState, decay_mask, init_train_state, make_train_step,
)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op thread pool would only spin on the
    cores the parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.float32)).to(
        torch.bfloat16)


def _tree(seed: int):
    """A numpy tree: bf16 matrices (2-D and 3-D), f32 vectors, and
    gradients of their dtypes."""
    rng = np.random.default_rng(seed)
    shapes = {"w": ((16, 8), "bf16"), "experts": ((3, 8, 4), "bf16"),
              "norm": ((8,), "f32"), "bias": ((16,), "bf16")}
    params, grads = {}, {}
    for name, (shape, dt) in shapes.items():
        p = rng.standard_normal(shape).astype(np.float32)
        g = (rng.standard_normal(shape) * 0.3).astype(np.float32)
        if dt == "bf16":
            p = _bf16(p).float().numpy()
            g = _bf16(g).float().numpy()
        params[name] = (p, dt)
        grads[name] = (g, dt)
    return params, grads


def _ref_leaf(a, dt):
    return jnp.asarray(a).astype(jnp.bfloat16 if dt == "bf16" else
                                 jnp.float32)


def _port_leaf(a, dt):
    t = torch.from_numpy(a)
    return t.to(torch.bfloat16) if dt == "bf16" else t


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def test_lr_schedule_matches_reference():
    cfg_kw = dict(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    for s in (0, 1, 5, 9, 10, 11, 37, 99, 100, 140):
        want = _np(ref_opt.lr_schedule(ref_opt.AdamWConfig(**cfg_kw),
                                       jnp.asarray(s)))
        got = _np(opt.lr_schedule(AdamWConfig(**cfg_kw), torch.tensor(s)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(state_dtype):
    """Three updates of one tree: the global norm (clipping engaged: the
    norm exceeds grad_clip), the new parameters, m and v."""
    params, grads = _tree(0)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=1.0,
              weight_decay=0.1, state_dtype=state_dtype)
    rp = {k: _ref_leaf(*v) for k, v in params.items()}
    tp = {k: _port_leaf(*v) for k, v in params.items()}
    rs = ref_opt.init_opt_state(rp, state_dtype)
    ts = opt.init_opt_state(tp, state_dtype)
    for it in range(3):
        rg = {k: _ref_leaf(v[0] * (1 + it), v[1]) for k, v in grads.items()}
        tg = {k: _port_leaf(v[0] * (1 + it), v[1]) for k, v in grads.items()}
        np.testing.assert_allclose(_np(opt.global_norm(tg)),
                                   _np(ref_opt.global_norm(rg)), rtol=2e-6)
        rp, rs, rm = ref_opt.adamw_update(ref_opt.AdamWConfig(**kw), rp, rg,
                                          rs)
        tp, ts, tm = opt.adamw_update(AdamWConfig(**kw), tp, tg, ts)
        assert int(ts["step"]) == int(rs["step"]) == it + 1
        np.testing.assert_allclose(_np(tm["lr"]), _np(rm["lr"]), rtol=1e-6)
        for k, (_, dt) in params.items():
            assert tp[k].dtype == (torch.bfloat16 if dt == "bf16"
                                   else torch.float32)
            ulp = 2.0 ** -7 if dt == "bf16" else 2e-6
            want = _np(rp[k])
            np.testing.assert_allclose(_np(tp[k]), want,
                                       atol=1e-6, rtol=ulp)
            for acc in ("m", "v"):
                assert ts[acc][k].dtype == getattr(torch, state_dtype)
                tol = 2.0 ** -7 if state_dtype == "bfloat16" else 2e-6
                np.testing.assert_allclose(_np(ts[acc][k]),
                                           _np(rs[acc][k]), rtol=tol,
                                           atol=1e-12)


def _reference(arch="h2o-danube-1.8b", seed=0):
    rcfg = ref_reduced_config(ref_get_config(arch))
    rmodel = build_model(rcfg)
    params = rmodel.init(jax.random.PRNGKey(seed))
    return rcfg, rmodel, params


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_train_step_matches_reference(f32):
    """One AdamW step from bridged weights (reduced danube: every layer
    windowed, one stacked segment, so the reference decays its norms):
    the loss and every updated leaf."""
    rcfg, rmodel, params = _reference()
    cfg = reduced_config(get_config("h2o-danube-1.8b"))
    if f32:
        ref_params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    else:
        ref_params = params
    opt_kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    rstep = jax.jit(ref_make_train_step(rmodel, ref_opt.AdamWConfig(**opt_kw)))
    batch = RefPipeline(rcfg, global_batch=2, seq_len=16).get_batch(0)
    rstate, rmet = rstep(RefTrainState(ref_params,
                                       ref_opt.init_opt_state(ref_params)),
                         jax.tree.map(jnp.asarray, batch))

    model = params_from_jax(_np_tree(params), cfg, device="cpu")
    if f32:
        model.float()
    state = init_train_state(model)
    step = make_train_step(model, AdamWConfig(**opt_kw))
    state, met = step(state, batch_to(batch, CPU))
    assert int(state.step) == 1
    if f32:
        np.testing.assert_allclose(float(met["loss"]), float(rmet["loss"]),
                                   rtol=1e-5)
    else:
        assert abs(float(met["loss"]) - float(rmet["loss"])) < 1e-2
    got = model_leaves(model)
    want = model_leaves(params_from_jax(
        _np_tree(rstate.params), cfg, device="cpu",
        dtype=torch.float32 if f32 else None))
    assert got.keys() == want.keys()
    for name in want:
        g, w = got[name], want[name]
        scale = np.abs(w).max()
        err = np.abs(g - w)
        if f32:
            assert err.max() <= 1e-6 + 1e-5 * scale, name
            continue
        # bf16: a gradient near zero may take the other sign on one side,
        # which moves that weight by up to 2 lr the other way
        tol = 2 * 2.0 ** -7 * scale
        assert err.max() <= tol + 2 * opt_kw["lr"], name
        assert np.mean(err > tol) <= 0.01, name
    # the bridged port weights round-trip to the reference's layout
    back = params_to_numpy(model)
    assert len(jax.tree.leaves(back)) == len(jax.tree.leaves(rstate.params))


def model_leaves(model: Model) -> dict:
    return {n: p.detach().float().numpy() for n, p in
            model.named_parameters()}


def test_decay_mask_follows_the_reference_layout():
    """Norms and biases of a stacked segment decay (their reference leaf
    is (L, d)); a one-layer segment's and the final norm do not."""
    danube = Model(reduced_config(get_config("h2o-danube-1.8b")), "cpu")
    mask = decay_mask(danube)
    assert mask["layers.0.ln1"] and mask["layers.1.attn.wq"]
    assert not mask["final_norm"] and mask["embed"]
    ds = Model(reduced_config(get_config("deepseek-v2-lite-16b")), "cpu")
    mask = decay_mask(ds)        # mla_dense x 1, then mla_moe x 1
    assert not mask["layers.0.ln1"] and not mask["layers.1.attn.kv_norm"]
    assert mask["layers.1.moe.w_gate"]


# ---------------------------------------------------------------------------
# The reference's loop tests, on the port
# ---------------------------------------------------------------------------


@pytest.fixture()
def tiny():
    """Reduced danube with the reference's initial weights (bridged), so
    the loop sees the reference test's trajectory."""
    _, _, params = _reference()
    cfg = reduced_config(get_config("h2o-danube-1.8b"))
    model = params_from_jax(_np_tree(params), cfg, device="cpu")
    return cfg, model


def _pipeline(cfg, batch=4, seq=32):
    return SyntheticTokenPipeline(cfg, global_batch=batch, seq_len=seq)


def test_loss_decreases(tiny, tmp_path):
    cfg, model = tiny
    step_fn = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=2,
                                                 total_steps=40))
    res = run_training(step_fn, init_train_state(model), _pipeline(cfg),
                       LoopConfig(total_steps=30, ckpt_every=100,
                                  ckpt_dir=str(tmp_path)))
    first = np.mean(res.losses[:5])
    last = np.mean(res.losses[-5:])
    assert last < first - 0.05, (first, last)


def test_checkpoint_resume_bitexact(tiny, tmp_path):
    """20 straight steps == 10 steps + restart + 10 steps (same data)."""
    cfg, model = tiny
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    step_fn = make_train_step(model, opt_cfg)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}

    resA = run_training(step_fn, init_train_state(model), _pipeline(cfg),
                        LoopConfig(total_steps=20, ckpt_every=100,
                                   ckpt_dir=str(tmp_path / "a")))
    # a fresh model from the same weights, as a new process would build
    model_b = Model(cfg, "cpu")
    with torch.no_grad():
        for n, p in model_b.named_parameters():
            p.copy_(init[n])
    step_b = make_train_step(model_b, opt_cfg)
    run_training(step_b, init_train_state(model_b), _pipeline(cfg),
                 LoopConfig(total_steps=10, ckpt_every=10,
                            ckpt_dir=str(tmp_path / "b")))
    resB = run_training(step_b, init_train_state(model_b), _pipeline(cfg),
                        LoopConfig(total_steps=20, ckpt_every=10,
                                   ckpt_dir=str(tmp_path / "b")))
    assert resB.resumed_from == 10
    assert int(resB.state.step) == 20
    for name, a in resA.state.params.items():
        b = resB.state.params[name]
        assert a is not b
        assert torch.equal(a, b), name
    for acc in ("m", "v"):
        for name, a in resA.state.opt_state[acc].items():
            assert torch.equal(a, resB.state.opt_state[acc][name]), name


def test_checkpoint_roundtrip_bf16_words(tiny, tmp_path):
    """A checkpoint holds bf16 leaves as their raw 16-bit words, names
    the dtype in tree.json, and restores every leaf bit for bit, as a
    parameter where the template has one."""
    import json
    cfg, model = tiny
    state = init_train_state(model)
    ckpt_lib.save_checkpoint(str(tmp_path), 3, state)
    path = tmp_path / "step_00000003"
    meta = json.loads((path / "tree.json").read_text())["leaves"]
    assert meta["params/embed"]["dtype"] == "bfloat16"
    assert meta["opt_state/step"]["dtype"] == "int32"
    with np.load(path / "arrays.npz") as data:
        assert data["params/embed"].dtype == np.uint16
    back, step = ckpt_lib.restore_latest(str(tmp_path), state)
    assert step == 3
    for name, p in state.params.items():
        q = back.params[name]
        assert isinstance(q, torch.nn.Parameter) and q.requires_grad
        assert q.dtype == p.dtype and torch.equal(q, p), name
    for acc in ("m", "v"):
        for name, t in state.opt_state[acc].items():
            assert torch.equal(back.opt_state[acc][name], t), name
    assert back.err is None and int(back.step) == 0
    assert back.step.shape == () and back.step.dtype == torch.int32


def test_injected_failure_recovers(tiny, tmp_path):
    cfg, model = tiny
    step_fn = make_train_step(model, AdamWConfig(lr=1e-3, total_steps=30))
    fired = {"n": 0}

    def fail_once(step):
        if step == 15 and fired["n"] == 0:
            fired["n"] += 1
            return True
        return False

    res = run_training(step_fn, init_train_state(model), _pipeline(cfg),
                       LoopConfig(total_steps=20, ckpt_every=5,
                                  ckpt_dir=str(tmp_path)),
                       failure_fn=fail_once)
    assert res.rollbacks == 1
    assert int(res.state.step) == 20
    # steps 0-14, then 15-19 from the checkpoint of step 15
    assert len(res.losses) == 20


def test_failure_before_checkpoint_raises(tiny, tmp_path):
    cfg, model = tiny
    step_fn = make_train_step(model, AdamWConfig())
    with pytest.raises(RuntimeError):
        run_training(step_fn, init_train_state(model), _pipeline(cfg),
                     LoopConfig(total_steps=10, ckpt_every=50,
                                ckpt_dir=str(tmp_path)),
                     failure_fn=lambda s: s == 3)


def test_checkpoint_atomicity(tiny, tmp_path):
    """Interrupted (partial) checkpoint directories are never listed."""
    cfg, model = tiny
    state = init_train_state(model, seed=0)
    ckpt_lib.save_checkpoint(str(tmp_path), 5, state)
    # fake a torn write: tmp dir left behind
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert ckpt_lib.list_checkpoints(str(tmp_path)) == [5]


def _restore_leaves(ckpt_dir, step, template) -> dict:
    state = ckpt_lib.restore_checkpoint(str(ckpt_dir), step, template)
    return ckpt_lib._flatten_with_paths(state)


def test_async_save_joins(tiny, tmp_path):
    """An async run's checkpoints hold what a synchronous run's hold, leaf
    for leaf and bit for bit."""
    cfg, model = tiny
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt_cfg = AdamWConfig(lr=1e-3, total_steps=10)
    results = {}
    for mode in ("sync", "async"):
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(init[n])
        results[mode] = run_training(
            make_train_step(model, opt_cfg), init_train_state(model),
            _pipeline(cfg),
            LoopConfig(total_steps=6, ckpt_every=3, async_ckpt=mode == "async",
                       ckpt_dir=str(tmp_path / mode)))
    assert int(results["async"].state.step) == 6
    assert ckpt_lib.list_checkpoints(str(tmp_path / "async")) == [3, 6]
    template = results["sync"].state
    for step in (3, 6):
        want = _restore_leaves(tmp_path / "sync", step, template)
        got = _restore_leaves(tmp_path / "async", step, template)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert torch.equal(got[k], w), (step, k)


def test_async_save_is_a_snapshot(tiny, tmp_path, monkeypatch):
    """An async save holds the state as it was when the save was called,
    though the next step updates the weights and moments in place before
    the writer thread runs (held back here until that step is done); it
    equals a synchronous save of the same step bit for bit."""
    import threading
    cfg, model = tiny
    step_fn = make_train_step(model, AdamWConfig(lr=1e-3, total_steps=10))
    pipe = _pipeline(cfg)
    state, _ = step_fn(init_train_state(model), batch_to(pipe.get_batch(0),
                                                         "cpu"))
    ckpt_lib.save_checkpoint(str(tmp_path / "sync"), 1, state)
    release, savez = threading.Event(), np.savez

    def held_savez(*args, **kwargs):
        assert release.wait(60)
        return savez(*args, **kwargs)

    monkeypatch.setattr(np, "savez", held_savez)
    writer = ckpt_lib.save_checkpoint(str(tmp_path / "async"), 1, state,
                                      async_save=True)
    state, _ = step_fn(state, batch_to(pipe.get_batch(1), "cpu"))
    release.set()
    writer.join()
    monkeypatch.setattr(np, "savez", savez)
    assert ckpt_lib.list_checkpoints(str(tmp_path / "async")) == [1]
    want = _restore_leaves(tmp_path / "sync", 1, state)
    got = _restore_leaves(tmp_path / "async", 1, state)
    assert int(got["opt_state/step"]) == 1
    moved = 0
    for k, w in want.items():
        assert torch.equal(got[k], w), k
        moved += not torch.equal(got[k], ckpt_lib._flatten_with_paths(
            state)[k])
    assert moved > 0        # the step after the save did change the state


def test_init_train_state_seed_leaves_earlier_state(tiny):
    """Re-initialising from a seed gives the model new tensors: a state
    made before keeps its weights."""
    cfg, model = tiny
    a = init_train_state(model, seed=1)
    before = {n: p.detach().clone() for n, p in a.params.items()}
    b = init_train_state(model, seed=2)
    for n, p in a.params.items():
        assert torch.equal(p, before[n])
        assert p is not b.params[n]
    assert not all(torch.equal(a.params[n], b.params[n]) for n in a.params)


def test_bf16_opt_state_dtype(tiny):
    cfg, model = tiny
    state = init_train_state(model, seed=0, state_dtype="bfloat16")
    assert all(t.dtype == torch.bfloat16
               for t in state.opt_state["m"].values())
    params = {n: p.detach() for n, p in state.params.items()}
    g = {n: torch.ones_like(p, dtype=torch.float32)
         for n, p in params.items()}
    _, new_opt, _ = opt.adamw_update(AdamWConfig(state_dtype="bfloat16"),
                                     params, g, state.opt_state)
    assert all(t.dtype == torch.bfloat16 for t in new_opt["v"].values())


def test_tensor_parallel_features_raise(tiny, tmp_path):
    """The mesh features without ranks refuse in the launcher's words:
    compression needs a mesh with a pod axis, a residual needs a plan, a
    ``MeshShape`` (or a "DxM" spec wider than the world) has no ranks to
    train on, and a sharded restore needs a template made on the mesh."""
    cfg, model = tiny
    with pytest.raises(ValueError, match="compress_pods=True needs a mesh"):
        make_train_step(model, AdamWConfig(), compress_pods=True)
    with pytest.raises(ValueError, match="n_pods= .* needs a plan="):
        init_train_state(model, seed=0, n_pods=1)
    from repro_torch.launch.mesh import MeshShape
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
        make_train_step(model, AdamWConfig(), mesh=MeshShape((1, 4)))
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
        make_train_step(model, AdamWConfig(), mesh="2x2")
    state = init_train_state(model)
    ckpt_lib.save_checkpoint(str(tmp_path), 1, state)
    with pytest.raises(ValueError, match="init_train_state\\(plan=\\)"):
        ckpt_lib.restore_latest(str(tmp_path), state, shardings=object())
    assert isinstance(state, TrainState)


def test_train_launcher(tmp_path, capsys):
    """``python -m repro_torch.launch.train --device cpu``: trains,
    checkpoints, prints the reference's summary line; a second call on the
    same directory resumes at the end and says so."""
    from repro_torch.launch.train import main
    argv = ["--device", "cpu", "--arch", "h2o-danube-1.8b", "--steps", "4",
            "--batch", "2", "--seq", "16", "--ckpt-every", "2",
            "--ckpt-dir", str(tmp_path)]
    assert main(argv) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("arch=h2o-danube-1.8b-reduced params=")
    assert "steps=4 first_loss=" in line and line.endswith("rollbacks=0")
    assert ckpt_lib.list_checkpoints(str(tmp_path)) == [2, 4]
    assert main(argv + ["--remat"]) == 0
    assert "(resumed at step 4: already complete)" in capsys.readouterr().out
