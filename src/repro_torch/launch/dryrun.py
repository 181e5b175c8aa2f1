"""One-device dry-run: count each (architecture x input shape) cell's step
at full size, and time it on the card.

The port of the one-device half of ``repro/launch/dryrun.py``.  For every
cell it builds ``Model(cfg, device="meta")`` and ``meta`` stand-ins for
the step's arguments (``launch/shapes.py``), runs the real step once
eagerly under the op counter (``core/op_cost.py``; each hand-written
kernel's wrapper reports its formula's work there in place of a launch),
and records:

  * ``argument_bytes``: the exact bytes of the step's arguments (weights,
    cache, optimizer state, batch), beside the H100's 80 GiB;
  * the counted FLOPs, op-level bytes and ``bound_bytes`` (arguments read
    once, writes once) and the roofline terms against the H100's data
    sheet (``core/roofline.py``).

A cell allocates nothing and takes seconds.  Records land in
``experiments/dryrun_torch/<arch>__<shape>__1xh100.json``.

``--single-pod`` / ``--multi-pod`` count one rank (rank 0) of the
reference's production mesh, 16x16 or 2x16x16 (``make_production_mesh``,
a ``MeshShape``), at full size on ``meta`` in one process: the cell's
``make_plan`` plan executed by its layout (the training step's, or the
static engine's ``ServeLayout``) over the rank's rows, every collective
counted as the rank would issue it (``hints.CountComm``: calls, operand
and wire bytes by kind), priced over NVLink as the collective term
(``core/roofline.py``; as if all 256 or 512 cards shared one NVLink
domain).  Records: ``experiments/dryrun_torch/<arch>__<shape>__16x16.json``
/ ``__2x16x16.json``; the reference's skips.

``--device cuda --batch N`` also times the cell on the card at N rows
(the count is taken at the same N): random weights and caches from a
seed, one warm-up step, the median wall time of a few more, the device's
busy time in one step (``torch.profiler``) and the peak memory, each
against ``bound_s``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--subprocess]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --list
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-370m \
      --shape decode_32k --single-pod          # one rank of 16x16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \\
      --shape decode_32k --device cuda --batch 4
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time
import traceback

import torch

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.core import hardware, roofline
from repro_torch.core.op_cost import count, storage_key, tensors
from repro_torch.launch import shapes as shp
from repro_torch.models.footprint import compute_footprint
from repro_torch.models.model import Model
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.runtime.sampling import greedy
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import init_train_state, make_train_step

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
MESH = "1xh100"
CHIP = hardware.H100
REPS = 2                      # timed steps after the warm-up (--device cuda)

# bf16 AdamW accumulators above this weight budget (400B-class cells).
_BF16_OPT_THRESHOLD_PARAMS = 5e10


def _model_flops(cfg, fp, shape: shp.ShapeSpec, batch: int | None = None
                 ) -> float:
    b, s = batch or shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return 6.0 * fp.active_params * b * s
    if shape.kind == "prefill":
        return 2.0 * fp.active_params * b * s
    return fp.decode_flops_per_token(b, s)


def _fill(tree, cfg, gen: torch.Generator) -> None:
    """Seeded random values in place for a cell's stand-ins off ``meta``:
    token ids and labels below the vocabulary, floats from N(0, 1);
    integer cache leaves (``slot_pos``) keep what ``init_cache`` wrote."""
    for t in tensors(tree):
        if t.is_floating_point():
            t.normal_(generator=gen)
    for key in ("tokens", "labels"):
        if isinstance(tree, dict) and key in tree:
            tree[key].random_(cfg.vocab_size, generator=gen)


def _lower_cell(cfg, shape: shp.ShapeSpec, device="meta",
                batch: int | None = None, seed: int = 0):
    """(step, args, inputs) of one cell: ``step(*args)`` runs it once and
    returns (output, what else it writes: the cache, whose recurrent state
    a step replaces where the KV entries are written in place); ``inputs``
    are the other tensors it reads (the model's parameters).
    Off ``meta`` the weights come from ``seed`` and the batch and cache
    are filled from it (``_fill``)."""
    fp = compute_footprint(cfg)
    b = batch or shape.global_batch
    meta = torch.device(device).type == "meta"
    gen = None if meta else torch.Generator(device=device).manual_seed(seed)

    if shape.kind == "train":
        opt_cfg = AdamWConfig(
            state_dtype=("bfloat16" if fp.total_params > _BF16_OPT_THRESHOLD_PARAMS
                         else "float32"))
        # as the reference: training uses the capacity MoE path
        model = Model(cfg, device=device, moe_impl="capacity")
        state = init_train_state(model, None if meta else seed,
                                 state_dtype=opt_cfg.state_dtype)
        step = make_train_step(model, opt_cfg, remat=True)
        batch_t = shp.batch_specs(cfg, shape, b, device)
        if not meta:
            _fill(batch_t, cfg, gen)

        def train(batch_t):    # parameters and moments update in place
            return step(state, batch_t)[1]["loss"], None
        return train, (batch_t,), (state.params, state.opt_state)

    model = Model(cfg, device=device)
    if not meta:
        model.init(seed)
    params = shp.param_specs(model)
    if shape.kind == "prefill":
        batch_t = shp.batch_specs(cfg, shape, b, device)
        if not meta:
            _fill(batch_t, cfg, gen)
        if not cfg.has_decode:
            @torch.no_grad()
            def forward(batch_t):
                return model.forward(batch_t), None
            return forward, (batch_t,), (params,)
        cache = model.init_cache(b, shape.seq_len)

        def prefill(batch_t, cache):
            return model.prefill(batch_t, cache), cache
        return prefill, (batch_t, cache), (params,)

    # decode / long_decode: the reference's serve_step_fn
    tokens, cache, cur_pos = shp.decode_specs(cfg, shape, model, b)
    if not meta:
        tokens.random_(cfg.vocab_size, generator=gen)
        _fill(cache, cfg, gen)

    def serve_step(tokens, cache, cur_pos):
        return greedy(model.decode_step(tokens, cache, cur_pos)), cache
    return serve_step, (tokens, cache, cur_pos), (params,)


def _lower_pod_cell(cfg, shape: shp.ShapeSpec, mesh):
    """(step, args, inputs, plan, groups) of rank 0 of ``mesh`` (a
    ``MeshShape``: no processes) at full size on ``meta``: the cell's plan
    (``make_plan``) executed by its layout, the training step's
    (``parallel/train.py``) or the static engine's (``parallel/serve.py``),
    over the rank's rows, with every collective counted, not issued
    (``CountComm``)."""
    from repro_torch.parallel.hints import serve_layout
    from repro_torch.parallel.plan import axis_size, make_plan
    from repro_torch.parallel.serve import ServeLayout
    fp = compute_footprint(cfg)
    plan = make_plan(cfg, mesh, global_batch=shape.global_batch,
                     shape_kind=shape.kind)
    dp = 1
    for a in plan.dp:
        dp *= axis_size(mesh, a)
    b = max(shape.global_batch // dp, 1)
    if shape.kind == "train":
        opt_cfg = AdamWConfig(
            state_dtype=("bfloat16" if fp.total_params > _BF16_OPT_THRESHOLD_PARAMS
                         else "float32"))
        model = Model(cfg, device="meta", moe_impl="capacity")
        state = init_train_state(model, None, plan=plan,
                                 state_dtype=opt_cfg.state_dtype)
        step = make_train_step(model, opt_cfg, remat=True, plan=plan)
        batch_t = shp.batch_specs(cfg, shape, b, "meta")

        def train(batch_t):
            return step(state, batch_t)[1]["loss"], None
        return (train, (batch_t,), (state.params, state.opt_state), plan,
                state.layout.groups)

    model = Model(cfg, device="meta")
    lay = ServeLayout(model, plan)
    if shape.kind == "prefill":
        batch_t = shp.batch_specs(cfg, shape, b, "meta")
        if not cfg.has_decode:
            @torch.no_grad()
            def forward(batch_t):
                with serve_layout(lay):
                    return model.forward(batch_t), None
            return forward, (batch_t,), (lay.params,), plan, lay.groups
        cache = lay.init_cache(model, b, shape.seq_len)

        def prefill(batch_t, cache):
            with serve_layout(lay):
                return model.prefill(batch_t, cache), cache
        return prefill, (batch_t, cache), (lay.params,), plan, lay.groups

    tokens = torch.empty((b,), dtype=torch.int32, device="meta")
    cache = lay.init_cache(model, b, shape.seq_len)

    def serve_step(tokens, cache, cur_pos):
        with serve_layout(lay):
            return greedy(model.decode_step(tokens, cache, cur_pos)), cache
    return (serve_step, (tokens, cache, shape.seq_len - 1), (lay.params,),
            plan, lay.groups)


def _collectives(groups) -> dict:
    """Kind -> {"count", "operand_bytes", "wire_bytes"} over every counted
    group of the rank (``CountComm.ops``)."""
    out: dict = {}
    for c in groups._unique():
        for kind, rec in getattr(c, "ops", {}).items():
            agg = out.setdefault(kind, {"count": 0, "operand_bytes": 0,
                                        "wire_bytes": 0})
            for k, v in rec.items():
                agg[k] += v
    return out


def run_pod_cell(arch: str, shape_name: str, multi_pod: bool, *,
                 out_dir: pathlib.Path | None = OUT_DIR) -> dict:
    """Count one rank of the reference's production mesh (16x16, or
    2x16x16 with ``multi_pod``) at full size on ``meta`` in this process;
    write the record under ``out_dir`` (None: do not)."""
    cfg = get_config(arch)
    shape = shp.SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    ok, reason = shp.cell_supported(cfg, shape)
    record: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                    "status": "skip", "reason": reason}
    if not ok:
        return record
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size()
    cell = f"{arch}__{shape_name}__{mesh_name}"
    fp = compute_footprint(cfg)
    t0 = time.time()
    step, args, inputs, plan, groups = _lower_pod_cell(cfg, shape, mesh)
    arg_bytes = argument_bytes(args, inputs)
    cost = count(step, *args, inputs=inputs)[1]
    seconds = time.time() - t0
    colls = _collectives(groups)
    report = roofline.analyze_counted(
        cost, name=cell, chip=CHIP, n_chips=n_chips,
        model_flops_total=_model_flops(cfg, fp, shape), collectives=colls)

    def axes(x):
        return list(x) if isinstance(x, tuple) else x
    record.update({
        "status": "ok",
        "device": "meta",
        "chip": dataclasses.asdict(CHIP),
        "batch": shape.global_batch,
        "seq_len": shape.seq_len,
        "count_s": round(seconds, 2),
        "chips": n_chips,
        "rank": 0,
        "plan": {"dp": list(plan.dp), "tp": axes(plan.tp),
                 "fsdp": list(plan.fsdp), "cache_seq": axes(plan.cache_seq),
                 "seq_parallel": plan.seq_parallel},
        "memory_analysis": {"argument_size_in_bytes": arg_bytes},
        "fits_hbm": arg_bytes <= CHIP.hbm_capacity,
        "flops_per_device": report.flops_per_device,
        "bytes_per_device": report.bytes_per_device,
        "bound_bytes_per_device": report.bound_bytes_per_device,
        "collective_bytes_per_device": report.collective_bytes_per_device,
        "collective_wire_bytes_per_device":
            report.collective_wire_bytes_per_device,
        "collectives": colls,
        "collective_link": ("NVLink at the H100's ici_link_bw, priced as if "
                            f"all {n_chips} cards shared one NVLink domain"),
        "compute_s": report.compute_s,
        "memory_s": report.memory_s,
        "op_memory_s": report.op_memory_s,
        "collective_s": report.collective_s,
        "dominant": report.dominant,
        "bound_s": report.bound_s,
        "model_flops_total": report.model_flops_total,
        "useful_flops_ratio": report.useful_flops_ratio,
        "unknown_trip_loops": cost.unknown_trip_loops,
        "aten_ops": cost.ops,
        "kernels": cost.kernels,
    })
    if out_dir is not None:
        out_dir = pathlib.Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{cell}.json").write_text(json.dumps(record, indent=1))
    return record


def argument_bytes(*trees) -> int:
    """Bytes of every tensor of ``trees``, each storage once."""
    seen = {}
    for t in tensors(trees):
        seen.setdefault(storage_key(t), t.untyped_storage().nbytes())
    return sum(seen.values())


def count_cell(cfg, shape: shp.ShapeSpec, batch: int | None = None,
               device="meta"):
    """Count one run of the cell's step (on ``meta``, or on the CPU's
    plain path at a small size): (Cost, argument bytes, seconds)."""
    t0 = time.time()
    step, args, inputs = _lower_cell(cfg, shape, device, batch)
    arg_bytes = argument_bytes(args, inputs)
    return count(step, *args, inputs=inputs)[1], arg_bytes, time.time() - t0


def _busy_ms(prof) -> float:
    """Device time of one profiled step: the summed durations of the
    device's activity (kernels, copies, memsets; one stream, so they do
    not overlap), leaving out the device-side copies of host ranges."""
    from torch.autograd import DeviceType

    events = list(prof.profiler.kineto_results.events())
    host = {e.name() for e in events if e.device_type() != DeviceType.CUDA}
    return sum(e.duration_ns() for e in events
               if e.device_type() == DeviceType.CUDA
               and e.name() not in host
               and not e.name().startswith("ProfilerStep")) / 1e6


def _output_ok(cfg, out: torch.Tensor) -> bool:
    """A step's output is sane: finite floats (a loss, logits), or token
    ids within the vocabulary."""
    if out.is_floating_point():
        return bool(torch.isfinite(out).all())
    return bool(((out >= 0) & (out < cfg.vocab_size)).all())


def time_cell(cfg, shape: shp.ShapeSpec, batch: int, device="cuda") -> dict:
    """Time one cell on the card at ``batch`` rows: one warm-up step, the
    median wall of ``REPS`` more (each ending in a synchronize), the busy
    time of one step under ``torch.profiler`` (``REPS`` + 2 steps in all),
    the peak memory, and whether the last step's output is sane."""
    torch.cuda.reset_peak_memory_stats(device)
    step, args, _ = _lower_cell(cfg, shape, device, batch)
    held = torch.cuda.memory_allocated(device)
    step(*args)
    torch.cuda.synchronize(device)
    walls = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        step(*args)
        torch.cuda.synchronize(device)
        walls.append((time.perf_counter() - t0) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = step(*args)[0]
        torch.cuda.synchronize(device)
    return {"device": torch.cuda.get_device_name(device), "batch": batch,
            "wall_ms": statistics.median(walls), "wall_ms_all": walls,
            "busy_ms": _busy_ms(prof), "held_gb": held / 1e9,
            "peak_gb": torch.cuda.max_memory_allocated(device) / 1e9,
            "output_ok": _output_ok(cfg, out)}


def run_cell(arch: str, shape_name: str, *, device: str = "meta",
             batch: int | None = None, out_dir: pathlib.Path | None = OUT_DIR) -> dict:
    """Count one cell on ``meta`` (at ``batch`` rows, the shape's global
    batch unless given) and, with ``device="cuda"``, time it there; write
    the record under ``out_dir`` (None: do not)."""
    cfg = get_config(arch)
    shape = shp.SHAPES[shape_name]
    ok, reason = shp.cell_supported(cfg, shape)
    record: dict = {"arch": arch, "shape": shape_name, "mesh": MESH,
                    "status": "skip", "reason": reason}
    if not ok:
        return record
    b = batch or shape.global_batch
    cell = f"{arch}__{shape_name}__{MESH}"
    if b != shape.global_batch or device != "meta":
        cell += f"__{torch.device(device).type}_b{b}"
    fp = compute_footprint(cfg)
    cost, arg_bytes, seconds = count_cell(cfg, shape, b)
    report = roofline.analyze_counted(
        cost, name=cell, chip=CHIP, n_chips=1,
        model_flops_total=_model_flops(cfg, fp, shape, b))
    record.update({
        "status": "ok",
        "device": "meta",
        "chip": dataclasses.asdict(CHIP),
        "batch": b,
        "seq_len": shape.seq_len,
        "count_s": round(seconds, 2),
        "chips": 1,
        "memory_analysis": {"argument_size_in_bytes": arg_bytes},
        "fits_hbm": arg_bytes <= CHIP.hbm_capacity,
        "flops_per_device": report.flops_per_device,
        "bytes_per_device": report.bytes_per_device,
        "bound_bytes_per_device": report.bound_bytes_per_device,
        "collective_bytes_per_device": 0.0,
        "collective_wire_bytes_per_device": 0.0,
        "collectives": {},
        "compute_s": report.compute_s,
        "memory_s": report.memory_s,
        "op_memory_s": report.op_memory_s,
        "collective_s": report.collective_s,
        "dominant": report.dominant,
        "bound_s": report.bound_s,
        "model_flops_total": report.model_flops_total,
        "useful_flops_ratio": report.useful_flops_ratio,
        "unknown_trip_loops": cost.unknown_trip_loops,
        "aten_ops": cost.ops,
        "kernels": cost.kernels,
    })
    if torch.device(device).type == "cuda":
        m = time_cell(cfg, shape, b, device)
        m["share_wall"] = report.bound_s * 1e3 / m["wall_ms"]
        m["share_busy"] = report.bound_s * 1e3 / m["busy_ms"]
        record["measured"] = m
    if out_dir is not None:
        out_dir = pathlib.Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{cell}.json").write_text(json.dumps(record, indent=1))
    return record


def _print_record(r: dict):
    if r["status"] == "skip":
        print(f"SKIP {r['arch']} x {r['shape']} [{r['mesh']}]: {r['reason']}")
        return
    print(f"OK   {r['arch']} x {r['shape']} [{r['mesh']}] "
          f"count={r['count_s']}s dominant={r['dominant']} "
          f"comp={r['compute_s']*1e3:.2f}ms mem={r['memory_s']*1e3:.2f}ms "
          f"coll={r['collective_s']*1e3:.2f}ms "
          f"useful={r['useful_flops_ratio'] and round(r['useful_flops_ratio'],3)}")
    args = r["memory_analysis"]["argument_size_in_bytes"]
    print(f"     memory/device: args={args/2**30:.2f}GiB "
          f"(H100 HBM {CHIP.hbm_capacity/2**30:.0f}GiB); "
          f"flops={r['flops_per_device']:.4g} "
          f"bound_bytes={r['bound_bytes_per_device']:.4g} "
          f"op_bytes={r['bytes_per_device']:.4g}")
    if "measured" in r:
        m = r["measured"]
        print(f"     on {m['device']} at B {m['batch']}: "
              f"wall={m['wall_ms']:.2f}ms busy={m['busy_ms']:.2f}ms "
              f"bound={r['bound_s']*1e3:.2f}ms share(wall)="
              f"{m['share_wall']:.3f} share(busy)={m['share_busy']:.3f} "
              f"peak={m['peak_gb']:.2f}GB")


def all_cells():
    for arch in ASSIGNED_ARCHS:
        for shape_name in shp.SHAPES:
            yield arch, shape_name


def _main_pods(args, ap) -> int:
    """``--single-pod`` / ``--multi-pod`` (both: each): count rank 0 of the
    production mesh, one cell or ``--all`` of them (the reference's
    skips)."""
    if args.device != "meta" or args.batch:
        ap.error("a pod mesh is counted on meta at the shape's batch "
                 "(no --device / --batch)")
    pods = [mp for mp, on in ((False, args.single_pod),
                              (True, args.multi_pod)) if on]
    out = pathlib.Path(args.out)
    if args.list or args.all:
        cells = [(a, s, mp) for a, s in all_cells() for mp in pods]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all / --list)")
        cells = [(args.arch, args.shape, mp) for mp in pods]
    if args.list:
        for arch, shape_name, mp in cells:
            ok, reason = shp.cell_supported(get_config(arch),
                                            shp.SHAPES[shape_name])
            print(f"{arch:28s} {shape_name:12s} "
                  f"{'2x16x16' if mp else '16x16':8s} "
                  f"{'RUN' if ok else 'SKIP: ' + reason}")
        return 0
    failures = []
    t0 = time.time()
    for arch, shape_name, mp in cells:
        if args.subprocess:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape_name, "--out", args.out,
                   "--multi-pod" if mp else "--single-pod"]
            if subprocess.run(cmd, env={**os.environ}).returncode != 0:
                failures.append((arch, shape_name, mp))
            continue
        try:
            _print_record(run_pod_cell(arch, shape_name, mp, out_dir=out))
        except Exception:
            traceback.print_exc()
            failures.append((arch, shape_name, mp))
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        return 1
    if len(cells) > 1:
        print(f"\nall cells green ({time.time() - t0:.1f} s)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(shp.SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--subprocess", action="store_true",
                    help="with --all: isolate each cell in a subprocess")
    ap.add_argument("--device", default="meta",
                    help="meta (count only) or cuda (count, then time)")
    ap.add_argument("--batch", type=int, default=None,
                    help="rows of the cell (default: the shape's global "
                         "batch); cut it where one card must")
    ap.add_argument("--out", default=str(OUT_DIR),
                    help="directory of the records")
    args = ap.parse_args(argv)
    if args.multi_pod or args.single_pod:
        return _main_pods(args, ap)
    kw = dict(device=args.device, batch=args.batch,
              out_dir=pathlib.Path(args.out))

    if args.list:
        for arch, shape_name in all_cells():
            cfg = get_config(arch)
            ok, reason = shp.cell_supported(cfg, shp.SHAPES[shape_name])
            print(f"{arch:28s} {shape_name:12s} {MESH:8s} "
                  f"{'RUN' if ok else 'SKIP: ' + reason}")
        return 0

    if args.all:
        failures = []
        t0 = time.time()
        for arch, shape_name in all_cells():
            if args.subprocess:
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape_name,
                       "--device", args.device, "--out", args.out]
                if args.batch:
                    cmd += ["--batch", str(args.batch)]
                rc = subprocess.run(cmd, env={**os.environ}).returncode
                if rc != 0:
                    failures.append((arch, shape_name))
            else:
                try:
                    _print_record(run_cell(arch, shape_name, **kw))
                except Exception:
                    traceback.print_exc()
                    failures.append((arch, shape_name))
        if failures:
            print(f"\n{len(failures)} FAILURES:")
            for f in failures:
                print("  ", f)
            return 1
        print(f"\nall cells green ({time.time() - t0:.1f} s)")
        return 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all / --list)")
    try:
        rec = run_cell(args.arch, args.shape, **kw)
    except Exception:
        traceback.print_exc()
        return 1
    _print_record(rec)
    return 0 if rec["status"] in ("ok", "skip") else 1


if __name__ == "__main__":
    sys.exit(main())
