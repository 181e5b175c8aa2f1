"""Parallel training on real ranks: four CPU processes joined by a gloo
group, laid out as (1, 4), (4, 1), (2, 2) and (2 pods, 1, 2) meshes.

The reference's ``tests/test_distributed.py`` training scenarios at
reduced size, in f32 on weights bridged from the reference's
``Model.init``.  qwen3 (GQA with qk-norm), llama3 (2 KV heads on a 4-way
axis: a stored shard holds half a head), deepseek (MLA + MoE) and mamba2
(the SSM) train three steps on each of the (1, 4), (4, 1) and (2, 2)
meshes against the reference's single-device ``jax.value_and_grad`` step
and ``adamw_update`` on the same global batches: the first loss within
1e-5 relative; every gradient leaf, gathered whole, within 1e-5 of the
leaf's largest magnitude, or where the port's own one-device step is
already farther from the reference (a gradient that cancels in f32:
``GRAD_WITNESS``) within 3 times that distance; the parameters after the
first step within the reference distributed test's own atol = rtol =
2e-2, and the losses of steps 2 and 3 within its 5e-3.  deepseek also trains on the capacity path
(``moe_impl="capacity"``) with a batch whose routing drops assignments
(its embedding and router share a direction; the drops are counted on the
reference's numbers), whose capacity is global: a rank offsets its slots
by the lower DP ranks' counts.  Every rank stores exactly the plan's shard
shape of each parameter and moment, and every step's collective bytes by
kind equal ``predict_step_bytes`` (remat too).  The other families
(qwen2.5's biases, phi3, danube's window, llama4-scout's top-1 MoE, hymba,
hubert, internvl2) train two steps on one mesh each, held to the
reference's single-device step the same way.

Cross-pod compression on two pods: three steps whose synced gradients and
carried residuals equal the reference's compression math (its eager
``compressed_mean`` over the pods as a ``vmap`` axis) bit for bit on the
ranks' in-pod gradients, and whose losses and parameters hold against the
reference's per-pod pipeline.  A checkpoint written on (2, 2) restores
bitwise onto (1, 4) and trains on; a one-device checkpoint restores onto
a mesh, and a mesh checkpoint off it, with the same arrays as a one-device
save of the state.  The loop on a mesh survives an injected failure on one
rank and a NaN on another and ends bitwise where a clean run ends.
``launch.train --mesh 2x1x2`` runs under ``torch.distributed.run``.

One spawn of four ranks runs every scenario (``_rank_main``); the parent
computes the references while the ranks run and the tests read both.
Each process group has a 60 s timeout and the spawn is joined with one."""
import dataclasses
import math
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import configs as tconfigs
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.launch.mesh import MeshShape, init_world, parse_mesh
from repro_torch.models.model import Model
from repro_torch.parallel import plan as tplan
from repro_torch.parallel.train import predict_step_bytes, state_bytes
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.loop import LoopConfig, run_training
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import init_train_state, make_train_step

WORLD = 4
JOIN_TIMEOUT_S = 300
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
B, S = 8, 32                   # the global batch: rows, positions
N_IMAGE = 4                    # internvl2's image positions of the 32
STEPS = 3
REQUIRED = {"qwen": "qwen3-14b", "llama": "llama3-8b",
            "deepseek": "deepseek-v2-lite-16b", "mamba": "mamba2-370m"}
MESHES = ("1x4", "4x1", "2x2")
OTHERS = {"qwen25": ("qwen2.5-14b", "1x4"), "phi3": ("phi3-mini-3.8b", "2x2"),
          "danube": ("h2o-danube-1.8b", "1x4"),
          "scout": ("llama4-scout-109b-a17b", "2x2"),
          "hymba": ("hymba-1.5b", "1x4"), "hubert": ("hubert-xlarge", "2x2"),
          "internvl": ("internvl2-26b", "1x4")}
LOSS_REL = 1e-5
GRAD_LEAF = 1e-5
# where f32 puts the port's own one-device step farther than GRAD_LEAF from
# the reference already (a sum that cancels: mamba2's and hymba's A_log,
# 1.5e-5 of its largest value; a top-1 router, whose gradient is zero in
# exact arithmetic, 1.4e5; MLA over the drops batch's near-equal tokens,
# 2.4e-5), the sharded step's gradient is held within GRAD_WITNESS times
# that distance (2.2 times at most, measured)
GRAD_WITNESS = 3.0
PARAM_TOL = 2e-2               # tests/test_distributed.py:71-74
LATER_LOSS_ABS = 5e-3          # tests/test_distributed.py:69


# ---------------------------------------------------------------------------
# shared helpers (parent and ranks)
# ---------------------------------------------------------------------------


def _model(job: dict, key: str, moe_impl: str = "auto") -> Model:
    """The port model of ``job[key]``: its config and f32 weights (built
    in f32 first: loading rounds into bf16 parameters otherwise)."""
    cfg, state = job[key]
    model = Model(cfg, device="cpu", moe_impl=moe_impl).float()
    model.load_state_dict(state)
    return model


def _batches(cfg, seed: int = 0) -> list[dict]:
    """``STEPS`` global batches of the family's inputs (numpy)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        if cfg.frontend == "audio":
            out.append({"features": rng.standard_normal(
                (B, S, cfg.d_model), dtype=np.float32),
                "labels": rng.integers(0, cfg.vocab_size, (B, S),
                                       dtype=np.int32)})
            continue
        s = S - N_IMAGE if cfg.frontend == "vision" else S
        b = {"tokens": rng.integers(0, cfg.vocab_size, (B, s),
                                    dtype=np.int32)}
        if cfg.frontend == "vision":
            b["image_embeds"] = rng.standard_normal(
                (B, N_IMAGE, cfg.d_model), dtype=np.float32)
        out.append(b)
    return out


def _torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _dtypes(state) -> dict:
    return {n: p.dtype for n, p in state.params.items()}


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _session(job, key, spec, *, moe_impl="auto", remat=False,
             pods=0, steps=STEPS) -> dict:
    """``steps`` sharded steps of ``job[key]`` on mesh ``spec``; the
    whole gradients and parameters after the first, the losses, every
    rank's stored shapes and bytes, and the second step's collective
    bytes with their prediction."""
    mesh = parse_mesh(spec, "cpu")
    model = _model(job, key, moe_impl)
    plan = tplan.make_plan(model.cfg, mesh, global_batch=B,
                           shape_kind="train")
    state = init_train_state(model, None, plan=plan, n_pods=pods)
    lay = state.layout
    step = make_train_step(model, AdamWConfig(lr=LR), plan=plan,
                           remat=remat, compress_pods=bool(pods),
                           keep_grads=True)
    out = {"losses": [], "pod": [],
           "shapes": {n: (tuple(p.shape), tuple(state.opt_state["m"][n].shape),
                          tuple(state.opt_state["v"][n].shape))
                      for n, p in state.params.items()},
           "bytes": sum(t.nbytes for tree in (state.params,
                                               state.opt_state["m"],
                                               state.opt_state["v"])
                        for t in tree.values()),
           "plan_bytes": state_bytes(lay, _dtypes(state), 4)}
    for i, b in enumerate(job["batches"][job[key][0].name][:steps]):
        local = lay.local_rows(_torch_batch(b))
        err_before = (None if not pods else
                      {n: lay.gather_pod_regions(n, e)
                       for n, e in state.err.items()})
        if i == 1:
            lay.groups.reset_counts()
        state, met = step(state, local)
        out["losses"].append(float(met["loss"]))
        if i == 1:
            counts = lay.groups.counts()
            out["counts"] = {k: v for k, v in counts.items()
                             if k.endswith("_bytes") and v
                             and not k.startswith("step:")}
            out["predicted"] = predict_step_bytes(lay, local, _dtypes(state),
                                                  remat=remat)
        if pods:
            out["pod"].append({
                "in_pod": {n: lay.gather_pod_regions(n, g)
                           for n, g in step.pod_grads.items()},
                "synced": {n: lay.gather_full(n, g)
                           for n, g in step.grads.items()},
                "err_before": err_before,
                "err_after": {n: lay.gather_pod_regions(n, e)
                              for n, e in state.err.items()}})
        if i == 0:
            out["grads"] = {n: lay.gather_full(n, g)
                            for n, g in step.grads.items()}
            out["params"] = {n: lay.gather_full(n, p.detach())
                             for n, p in state.params.items()}
    return out


def _checkpoints(job, tmp: str, rank: int) -> dict:
    """(2, 2) -> disk -> (1, 4), bitwise, and on; a one-device checkpoint
    onto (2, 2)."""
    out = {}
    batches = [_torch_batch(b) for b in job["batches"][job["qwen"][0].name]]
    mesh22 = parse_mesh("2x2", "cpu")
    model = _model(job, "qwen")
    plan22 = tplan.make_plan(model.cfg, mesh22, global_batch=B,
                             shape_kind="train")
    state = init_train_state(model, None, plan=plan22)
    step22 = make_train_step(model, AdamWConfig(lr=LR), plan=plan22)
    state, _ = step22(state, state.layout.local_rows(batches[0]))
    d = os.path.join(tmp, "ckpt_mesh")
    ckpt_lib.save_checkpoint(d, 1, state)
    saved = {n: state.layout.gather_full(n, p.detach())
             for n, p in state.params.items()}
    saved_m = {n: state.layout.gather_full(n, m)
               for n, m in state.opt_state["m"].items()}
    mesh14 = parse_mesh("1x4", "cpu")
    plan14 = tplan.make_plan(model.cfg, mesh14, global_batch=B,
                             shape_kind="train")
    template = init_train_state(_model(job, "qwen"), None, plan=plan14)
    restored, at = ckpt_lib.restore_latest(d, template,
                                           shardings=template.layout)
    lay = restored.layout
    out["restored_step"] = (at, int(restored.step))
    out["bitwise"] = all(
        torch.equal(lay.gather_full(n, p.detach()), saved[n])
        for n, p in restored.params.items()) and all(
        torch.equal(lay.gather_full(n, m), saved_m[n])
        for n, m in restored.opt_state["m"].items())
    step14 = make_train_step(model, AdamWConfig(lr=LR), plan=plan14)
    _, met14 = step14(restored, lay.local_rows(batches[1]))
    _, met22 = step22(state, state.layout.local_rows(batches[1]))
    out["next_loss"] = (float(met14["loss"]), float(met22["loss"]))
    if rank == 0:
        out["saved"] = saved
    # the parent's one-device checkpoint onto (2, 2)
    template = init_train_state(_model(job, "qwen"), None, plan=plan22)
    one, at = ckpt_lib.restore_latest(os.path.join(tmp, "ckpt_one"),
                                      template)
    whole = {n: one.layout.gather_full(n, p.detach())
             for n, p in one.params.items()}
    out["from_one"] = whole if rank == 0 else None
    out["from_one_step"] = (at, int(one.step))
    return out


def _loop(job, tmp: str, rank: int, name: str, inject: bool) -> dict:
    """The loop on a (2, 2) mesh: 8 steps, a checkpoint every 2 (async);
    with ``inject``, a failure on rank 1 at step 5 and a NaN weight on
    rank 2 at step 3, each once."""
    mesh = parse_mesh("2x2", "cpu")
    model = _model(job, "qwen")
    plan = tplan.make_plan(model.cfg, mesh, global_batch=B,
                           shape_kind="train")
    state = init_train_state(model, None, plan=plan)
    step = make_train_step(model, AdamWConfig(lr=LR), plan=plan)
    done = set()

    def poisoned(st, batch):
        if inject and rank == 2 and int(st.step) == 3 and "nan" not in done:
            done.add("nan")
            with torch.no_grad():
                st.params["final_norm"][0] = float("nan")
        return step(st, batch)

    def failure(s):
        if inject and rank == 1 and s == 5 and "fail" not in done:
            done.add("fail")
            return True
        return False

    lay = state.layout
    pipe = SyntheticTokenPipeline(model.cfg, global_batch=B, seq_len=16,
                                  seed=0, shard=lay.groups.dp_index,
                                  n_shards=lay.groups.dp_size)
    res = run_training(poisoned, state, pipe,
                       LoopConfig(total_steps=8, ckpt_every=2,
                                  ckpt_dir=os.path.join(tmp, name),
                                  async_ckpt=True, log_every=100),
                       failure_fn=failure)
    whole = {n: lay.gather_full(n, p.detach())
             for n, p in res.state.params.items()}
    return {"losses": res.losses, "rollbacks": res.rollbacks,
            "step": int(res.state.step),
            "params": whole if rank == 0 else None}


def _refusals(job) -> dict:
    """A serving plan refuses to execute; a step on another mesh's state
    refuses."""
    out = {}
    mesh = parse_mesh("1x4", "cpu")
    model = _model(job, "qwen")
    plan = tplan.make_plan(model.cfg, mesh, global_batch=B,
                           shape_kind="decode")
    try:
        make_train_step(model, AdamWConfig(), plan=plan)
        out["decode_plan"] = None
    except ValueError as e:
        out["decode_plan"] = str(e)
    return out


def _rank_main(rank: int, world: int, rdzv: str, job_path: str,
               out_dir: str) -> None:
    torch.set_num_threads(1)
    init_world("cpu", rank=rank, world_size=world, init_method=rdzv)
    job = torch.load(job_path, weights_only=False)
    out = {}
    t0 = time.perf_counter()
    for key in REQUIRED:
        for spec in MESHES:
            out[f"{key}:{spec}"] = _session(job, key, spec)
    for spec in ("1x4", "2x2"):
        out[f"capacity:{spec}"] = _session(job, "deepseek_drops", spec,
                                           moe_impl="capacity")
    out["remat:1x4"] = _session(job, "qwen", "1x4", remat=True, steps=2)
    out["remat:2x2:deepseek"] = _session(job, "deepseek", "2x2", remat=True,
                                         steps=2)
    for key, (_, spec) in OTHERS.items():
        out[f"{key}:{spec}"] = _session(job, key, spec, steps=2)
    from repro_torch.parallel import compression
    compression.CHUNK_ELEMS = 1000     # several chunks a leaf: same bits
    out["compress:2x1x2"] = _session(job, "qwen", "2x1x2", pods=2)
    out["checkpoints"] = _checkpoints(job, out_dir, rank)
    out["loop_clean"] = _loop(job, out_dir, rank, "loop_clean", False)
    out["loop_faults"] = _loop(job, out_dir, rank, "loop_faults", True)
    out["refusals"] = _refusals(job)
    out["seconds"] = time.perf_counter() - t0
    if rank:       # the big whole tensors once, from rank 0
        for v in out.values():
            if isinstance(v, dict):
                for k in ("grads", "params", "pod"):
                    v.pop(k, None)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent: weights, references, one spawn
# ---------------------------------------------------------------------------


def _bridge(arch: str, seed: int = 0, drops: bool = False):
    """(reference model, its f32 params, the port's (cfg, f32 state
    dict)) of a reduced config from the reference's init.  ``drops``:
    the embedding and the first expert's router column share a direction,
    so the routing crowds that expert past its capacity."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config, reduced_config
    from repro.models.model import Model as RefModel
    from repro_torch.bridge import params_from_jax
    jcfg = reduced_config(get_config(arch))
    tcfg = tconfigs.reduced_config(tconfigs.get_config(arch))
    ref = RefModel(jcfg, moe_impl="capacity" if drops else "auto")
    params = jax.tree.map(lambda a: np.array(a, np.float32),
                          ref.init(jax.random.PRNGKey(seed)))
    if drops:
        u = np.random.default_rng(7).standard_normal(jcfg.d_model)
        u = (u / np.linalg.norm(u)).astype(np.float32)
        params["embed"] = params["embed"] + 3.0 * u
        for stack in params["stacks"]:
            for kind in stack:
                if "moe" in kind:
                    r = kind["moe"]["router"]
                    r[..., :, 0] += 2.0 * u
    port = params_from_jax(params, tcfg, device="cpu", dtype=torch.float32)
    return ref, jax.tree.map(jnp.asarray, params), (tcfg, port.state_dict())


def _reference_steps(ref, params, batches, tcfg) -> dict:
    """The reference's single-device step on each of ``batches``: losses,
    the first step's gradients and updated parameters (bridged to port
    names, f32)."""
    import jax
    import jax.numpy as jnp
    from repro.train.optimizer import AdamWConfig as RefAdam
    from repro.train.optimizer import adamw_update, init_opt_state
    from repro_torch.bridge import params_from_jax

    cfg = RefAdam(lr=LR)
    vg = jax.jit(jax.value_and_grad(ref.loss))
    upd = jax.jit(lambda p, g, o: adamw_update(cfg, p, g, o))
    opt = init_opt_state(params)
    out = {"losses": []}
    for i, b in enumerate(batches):
        loss, grads = vg(params, {k: jnp.asarray(v) for k, v in b.items()})
        params, opt, _ = upd(params, grads, opt)
        out["losses"].append(float(loss))
        if i == 0:
            def named(tree):
                m = params_from_jax(jax.tree.map(np.asarray, tree), tcfg,
                                    device="cpu", dtype=torch.float32)
                return {n: p.detach().clone()
                        for n, p in m.named_parameters()}
            out["grads"], out["params"] = named(grads), named(params)
    return out


def _port_grads(job, key, moe_impl="auto") -> dict:
    """The port's one-device gradients of the first batch on the same
    weights (the witness of how far f32 puts the port from the
    reference)."""
    model = _model(job, key, moe_impl)
    state = init_train_state(model, None)
    step = make_train_step(model, AdamWConfig(lr=LR), keep_grads=True)
    step(state, _torch_batch(job["batches"][job[key][0].name][0]))
    return step.grads


def _drop_count(job) -> int:
    """Assignments the capacity path drops over the deepseek-drops batch
    on one device (the port's, which ``test_torch_moe.py`` holds to the
    reference's drop policy)."""
    from repro_torch.models import moe as tmoe
    dropped = []
    orig = tmoe._dispatch

    def counting(ids, n_buckets, cap, **kw):
        res = orig(ids, n_buckets, cap, **kw)
        dropped.append(int((~res[3]).sum()))
        return res
    tmoe._dispatch = counting
    try:
        model = _model(job, "deepseek_drops", "capacity")
        with torch.no_grad():
            model.loss(_torch_batch(
                job["batches"][job["deepseek_drops"][0].name][0]))
    finally:
        tmoe._dispatch = orig
    return sum(dropped)


def _torchrun_launcher(tmp) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "OMP_NUM_THREADS": "1"}
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         "--device", "cpu", "--mesh", "2x1x2", "--steps", "4", "--batch",
         "8", "--seq", "16", "--ckpt-every", "2", "--ckpt-dir",
         str(tmp / "launch_ckpt")],
        env=env, cwd=str(tmp), capture_output=True, text=True, timeout=180)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import repro.models  # noqa: F401  (import order: models before kernels)
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("tp_train")
    job, refs, bridged = {}, {}, {}
    for key, arch in REQUIRED.items():
        bridged[key] = _bridge(arch)
        job[key] = bridged[key][2]
    bridged["deepseek_drops"] = _bridge("deepseek-v2-lite-16b", drops=True)
    job["deepseek_drops"] = bridged["deepseek_drops"][2]
    job["deepseek_drops"] = (dataclasses.replace(
        job["deepseek_drops"][0], name="deepseek-drops"),
        job["deepseek_drops"][1])
    for key, (arch, _) in OTHERS.items():
        bridged[key] = _bridge(arch)
        job[key] = bridged[key][2]
    job["batches"] = {}
    for key in job:
        if key == "batches":
            continue
        cfg = job[key][0]
        job["batches"][cfg.name] = _batches(cfg, seed=len(job["batches"]))
    # the parent's one-device checkpoint (qwen3, one step on batch 0)
    model = _model(job, "qwen")
    one = init_train_state(model, None)
    one, _ = make_train_step(model, AdamWConfig(lr=LR))(
        one, _torch_batch(job["batches"][job["qwen"][0].name][0]))
    ckpt_lib.save_checkpoint(str(tmp / "ckpt_one"), 1, one)
    job_path = str(tmp / "job.pt")
    torch.save(job, job_path)
    t0 = time.perf_counter()
    ctx = mp.start_processes(
        _rank_main, args=(WORLD, f"file://{tmp}/rdzv", job_path, str(tmp)),
        nprocs=WORLD, join=False, start_method="spawn")
    try:
        for key in REQUIRED:
            ref, params, (tcfg, _) = bridged[key]
            refs[key] = _reference_steps(ref, params,
                                         job["batches"][tcfg.name], tcfg)
        ref, params, (tcfg, _) = bridged["deepseek_drops"]
        refs["capacity"] = _reference_steps(
            ref, params, job["batches"][job["deepseek_drops"][0].name],
            tcfg)
        refs["compress"] = _reference_compress(bridged["qwen"], job)
        for key in OTHERS:
            ref, params, (tcfg, _) = bridged[key]
            refs[key] = _reference_steps(ref, params,
                                         job["batches"][tcfg.name][:2], tcfg)
        for key in [*REQUIRED, *OTHERS]:
            refs[key]["one_device"] = _port_grads(job, key)
        refs["capacity"]["one_device"] = _port_grads(job, "deepseek_drops",
                                                     "capacity")
        refs["drops"] = _drop_count(job)
        refs["one"] = {n: p.detach().clone() for n, p in one.params.items()}
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"ranks still running after "
                                   f"{JOIN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    refs["spawn_s"] = time.perf_counter() - t0
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    refs["launcher"] = _torchrun_launcher(tmp)
    return ranks, refs, job, tmp


def _reference_compress(bridged, job) -> dict:
    """The reference's compressed path: each pod's gradient of its rows
    (``value_and_grad`` on the pod's half of the batch), the eager
    compressed mean over the pods, ``adamw_update``; three steps."""
    import jax
    import jax.numpy as jnp
    from repro.parallel import compression as jcomp
    from repro.train.optimizer import AdamWConfig as RefAdam
    from repro.train.optimizer import adamw_update, init_opt_state
    from repro_torch.bridge import params_from_jax

    ref, params, (tcfg, _) = bridged
    vg = jax.jit(jax.value_and_grad(ref.loss))
    opt = init_opt_state(params)
    err = jax.tree.map(lambda p: jnp.zeros((2,) + p.shape, jnp.float32),
                       params)
    mean = jax.vmap(lambda g, e: jcomp.tree_compressed_mean(g, e, "pod"),
                    axis_name="pod")
    losses = []
    for i, b in enumerate(job["batches"][tcfg.name]):
        outs = [vg(params, {k: jnp.asarray(v[p * B // 2:(p + 1) * B // 2])
                            for k, v in b.items()}) for p in range(2)]
        grads = jax.tree.map(lambda *g: jnp.stack(g), *[o[1] for o in outs])
        synced, err = mean(grads, err)
        synced = jax.tree.map(lambda g: g[0], synced)
        params, opt, _ = adamw_update(RefAdam(lr=LR), params, synced, opt)
        losses.append(float(np.mean([float(o[0]) for o in outs])))
        if i == 0:
            m = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                device="cpu", dtype=torch.float32)
            first = {n: p.detach().clone() for n, p in m.named_parameters()}
    return {"losses": losses, "params": first}


# ---------------------------------------------------------------------------
# the holds
# ---------------------------------------------------------------------------


def _grads_hold(got: dict, want: dict, one: dict) -> None:
    assert got.keys() == want.keys()
    bad = []
    for n, w in want.items():
        g = got[n]
        assert g.shape == w.shape, n
        err = float((g.double() - w.double()).abs().max())
        d1 = float((one[n].double() - w.double()).abs().max())
        limit = max(GRAD_LEAF * float(w.abs().max()), GRAD_WITNESS * d1)
        if err > limit:
            bad.append((n, err, limit, d1))
    assert not bad, bad


def _params_hold(got: dict, want: dict) -> None:
    for n, w in want.items():
        np.testing.assert_allclose(got[n].numpy(), w.numpy(),
                                   atol=PARAM_TOL, rtol=PARAM_TOL, err_msg=n)


def _loss_hold(got: list, want: list) -> None:
    assert got[0] == pytest.approx(want[0], rel=LOSS_REL)
    for g, w in zip(got[1:], want[1:]):
        assert abs(g - w) <= LATER_LOSS_ABS


@pytest.mark.parametrize("spec", MESHES)
@pytest.mark.parametrize("key", list(REQUIRED))
def test_sharded_step_matches_reference(runs, key, spec):
    """Losses, whole gradients and updated parameters against the
    reference's single-device step, the same losses on every rank."""
    ranks, refs, _, _ = runs
    r = ranks[0][f"{key}:{spec}"]
    for other in ranks[1:]:
        assert other[f"{key}:{spec}"]["losses"] == r["losses"]
    _loss_hold(r["losses"], refs[key]["losses"])
    _grads_hold(r["grads"], refs[key]["grads"], refs[key]["one_device"])
    _params_hold(r["params"], refs[key]["params"])


@pytest.mark.parametrize("spec", ["1x4", "2x2"])
def test_capacity_path_with_drops_matches_reference(runs, spec):
    """deepseek on ``moe_impl="capacity"``: the batch drops assignments
    (global capacity over the DP ranks), the step equals the reference's
    capacity step."""
    ranks, refs, _, _ = runs
    assert refs["drops"] > 0
    r = ranks[0][f"capacity:{spec}"]
    _loss_hold(r["losses"], refs["capacity"]["losses"])
    _grads_hold(r["grads"], refs["capacity"]["grads"],
                refs["capacity"]["one_device"])
    _params_hold(r["params"], refs["capacity"]["params"])


def test_each_rank_stores_the_plans_shards(runs):
    """Every rank holds exactly ``shard_shape`` of each parameter and of
    both moments, and the bytes ``state_bytes`` prices."""
    ranks, _, job, _ = runs
    for label in [f"{k}:{s}" for k in REQUIRED for s in MESHES] + [
            "compress:2x1x2", "capacity:2x2"]:
        key, spec = label.split(":")
        key = {"compress": "qwen", "capacity": "deepseek_drops"}.get(key, key)
        cfg = job[key][0]
        dims = tuple(int(x) for x in spec.split("x"))
        axes = ("pod", "data", "model") if len(dims) == 3 else (
            "data", "model")
        plan = tplan.make_plan(cfg, MeshShape(dims, axes), global_batch=B,
                               shape_kind="train")
        model = Model(cfg, device="meta")
        for r in ranks:
            got = r[label]
            for name, p in model.named_parameters():
                want = plan.shard_shape(name, tuple(p.shape))
                assert got["shapes"][name] == (want, want, want), (label, name)
            want_bytes = got["plan_bytes"]["params"] + got["plan_bytes"][
                "moments"]
            assert got["bytes"] == want_bytes, label


def test_collective_bytes_equal_the_prediction(runs):
    """Each scenario's second step, every rank: the bytes of each
    collective kind (weights gathered on use, gradients reduced, the
    sequence-parallel entries and exits both ways, the norm's and the
    cross-entropy's sums, the capacity counts; remat's reissued forward
    collectives apart) equal ``predict_step_bytes``."""
    ranks, _, _, _ = runs
    for label in ranks[0]:
        if not isinstance(ranks[0][label], dict) or \
                "predicted" not in ranks[0][label]:
            continue
        for r in ranks:
            assert r[label]["counts"] == r[label]["predicted"], label
    assert any(k.startswith("remat:")
               for k in ranks[0]["remat:1x4"]["counts"])
    assert "fwd:param_gather_bytes" in ranks[0]["qwen:4x1"]["counts"]


def test_remat_reissues_collectives_and_changes_nothing(runs):
    ranks, _, _, _ = runs
    a, b = ranks[0]["remat:1x4"], ranks[0]["qwen:1x4"]
    assert a["losses"] == b["losses"][:2]
    for n, g in b["grads"].items():
        assert torch.equal(a["grads"][n], g), n


@pytest.mark.parametrize("key", list(OTHERS))
def test_other_families_match_one_device(runs, key):
    """The families beyond the four, one mesh each, against the
    reference's single-device step, as the four are held."""
    ranks, refs, _, _ = runs
    spec = OTHERS[key][1]
    r = ranks[0][f"{key}:{spec}"]
    _loss_hold(r["losses"], refs[key]["losses"])
    _grads_hold(r["grads"], refs[key]["grads"], refs[key]["one_device"])
    _params_hold(r["params"], refs[key]["params"])


def test_compression_equals_reference_math_bitwise(runs):
    """Three steps on two pods: on the ranks' in-pod gradients and carried
    residuals, the reference's eager compressed mean gives the ranks'
    synced gradients and new residuals bit for bit."""
    import jax
    import jax.numpy as jnp
    from repro.parallel import compression as jcomp
    ranks, _, _, _ = runs
    mean = jax.vmap(lambda g, e: jcomp.compressed_mean(g, e, "pod"),
                    axis_name="pod")
    steps = ranks[0]["compress:2x1x2"]["pod"]
    assert len(steps) == STEPS
    for i, st in enumerate(steps):
        for name, g in st["in_pod"].items():
            m, e = mean(jnp.asarray(g.numpy()),
                        jnp.asarray(st["err_before"][name].numpy()))
            assert np.asarray(m[0]).tobytes() == \
                st["synced"][name].numpy().tobytes(), (i, name)
            assert np.asarray(m[1]).tobytes() == \
                st["synced"][name].numpy().tobytes(), (i, name)
            assert np.asarray(e).tobytes() == \
                st["err_after"][name].numpy().tobytes(), (i, name)
        if i:
            assert any(bool(e.any()) for e in st["err_before"].values())


def test_compressed_step_matches_reference_pipeline(runs):
    ranks, refs, _, _ = runs
    r = ranks[0]["compress:2x1x2"]
    _loss_hold(r["losses"], refs["compress"]["losses"])
    _params_hold(r["params"], refs["compress"]["params"])


def test_checkpoints_restore_across_meshes(runs):
    """(2, 2) -> (1, 4) bitwise, then a step on each agrees; a one-device
    checkpoint onto (2, 2) bitwise; the mesh checkpoint onto one device,
    with the arrays of a one-device save of that state."""
    ranks, refs, job, tmp = runs
    for r in ranks:
        c = r["checkpoints"]
        assert c["restored_step"] == (1, 1) and c["bitwise"]
        a, b = c["next_loss"]
        assert a == pytest.approx(b, rel=LOSS_REL)
        assert c["from_one_step"] == (1, 1)
    c = ranks[0]["checkpoints"]
    for n, w in refs["one"].items():
        assert torch.equal(c["from_one"][n], w), n
    model = _model(job, "qwen")
    template = init_train_state(model, None)
    back, at = ckpt_lib.restore_latest(str(tmp / "ckpt_mesh"), template)
    assert at == 1 and int(back.step) == 1
    for n, p in back.params.items():
        assert torch.equal(p.detach(), c["saved"][n]), n
    ckpt_lib.save_checkpoint(str(tmp / "ckpt_again"), 1, back)
    with np.load(tmp / "ckpt_mesh" / "step_00000001" / "arrays.npz") as a, \
            np.load(tmp / "ckpt_again" / "step_00000001" / "arrays.npz") as b:
        assert list(a.keys()) == list(b.keys())
        for k in a.keys():
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                b[k].tobytes(), k
    assert (tmp / "ckpt_mesh" / "step_00000001" / "tree.json").read_text() \
        == (tmp / "ckpt_again" / "step_00000001" / "tree.json").read_text()


def test_loop_recovers_on_every_rank(runs):
    """An injected failure on rank 1 and a NaN weight on rank 2: every
    rank rolls back twice, and the run ends where a clean run ends, bit
    for bit."""
    ranks, _, _, _ = runs
    for r in ranks:
        clean, faults = r["loop_clean"], r["loop_faults"]
        assert clean["rollbacks"] == 0 and faults["rollbacks"] == 2
        assert clean["step"] == faults["step"] == 8
        assert faults["losses"][-1] == clean["losses"][-1]
    c, f = ranks[0]["loop_clean"]["params"], ranks[0]["loop_faults"]["params"]
    for n, p in c.items():
        assert torch.equal(f[n], p), n


def test_serving_plan_refuses(runs):
    ranks, _, _, _ = runs
    for r in ranks:
        assert "serving plan" in r["refusals"]["decode_plan"]


def test_train_launcher_under_torchrun(runs):
    """``launch/train.py --mesh 2x1x2 --device cpu`` on four gloo ranks
    (compression on: two pods) returns 0; rank 0 alone prints the summary;
    the checkpoints are written once."""
    _, refs, _, tmp = runs
    r = refs["launcher"]
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("arch=")]
    assert len(lines) == 1 and "steps=4 first_loss=" in lines[0]
    assert ckpt_lib.list_checkpoints(str(tmp / "launch_ckpt")) == [2, 4]


def test_the_spawn_stays_short(runs):
    """The ranks' scenarios within their budget (the spawn is joined with
    ``JOIN_TIMEOUT_S``; the file runs in about a minute)."""
    ranks, refs, _, _ = runs
    assert max(r["seconds"] for r in ranks) < JOIN_TIMEOUT_S / 2
    assert math.isfinite(refs["spawn_s"])
