"""The port's dry-run against the reference's, on the CPU.

* ``launch/shapes.py``: ``SHAPES``, ``cell_supported`` (verdict and
  reason) and the shapes and dtypes of ``batch_specs`` / ``decode_specs``
  equal ``repro/launch/shapes.py``'s for every (arch x shape) cell of the
  ten assigned configs (the cache layer by layer: the reference stacks a
  segment's layers on a leading axis).
* ``core/op_cost.py`` is exact on the loop programs of
  ``tests/test_hlo_cost.py`` (an eager loop runs every iteration, so there
  is no trip count to recover), and a loop over a stacked weight reads
  each layer's slice once.
* Each kernel's formula (``kernels/cost.py``) has a witness: the counted
  FLOPs of non-causal ``blocked_attention`` equal the flash formula's
  exactly; a ``meta`` call of each wrapper reports its formula's FLOPs and
  bytes and returns the output's shape; causal attention differs by
  design (the formula counts visible pairs, the plain path whole blocks)
  by exactly the masked pairs of the blocks it computes.
* Three reduced cells counted on the CPU's plain path against the
  reference's ``analyze_compiled`` of ``jax.jit(step).lower(...).compile()``
  on one CPU device: the FLOPs are equal but for two differences of
  method, each checked exactly: the reference's blocked attention
  recomputes every block's scores and P.V in its backward (its scan body
  is checkpointed), 2 B H S^2 (D + Dv) a layer, and its SSM decode runs
  the causal conv as an einsum (a dot: 2 B K C a layer) where the port
  multiplies and sums.  The arguments' bytes equal the reference's
  stand-ins' bytes exactly (but for its 4-byte ``cur_pos``).  Op-level bytes are each package's proxy and
  differ by method (XLA fuses elementwise chains; an eager op reads and
  writes each intermediate): they agree within a factor of 3.
* The CLI: ``python -m repro_torch.launch.dryrun`` on the full-size
  mamba2-370m ``decode_32k`` cell (within 5% of the committed reference
  record's FLOPs x 256 chips) and a skipped encoder cell.
* The pod meshes (``--single-pod`` / ``--multi-pod``): one rank of 16x16
  counted at full size on ``meta``: mamba2-370m ``decode_32k``'s FLOPs x
  256 within 10% of the one-device count, qwen3-14b ``decode_32k``'s
  counted collectives priced over NVLink, and the reference's skips.
"""
import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (import order: models before kernels)
import jax
import jax.numpy as jnp

from repro.configs import ASSIGNED_ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.core import roofline as ref_roofline
from repro.launch import shapes as ref_shapes
from repro.models.model import build_model
from repro.runtime.engine import serve_step_fn
from repro.train.optimizer import AdamWConfig as RefAdamWConfig
from repro.train.train_step import init_train_state as ref_init_train_state
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch.configs import ASSIGNED_ARCHS, get_config, reduced_config
from repro_torch.core import roofline
from repro_torch.core.op_cost import OpCounter, count
from repro_torch.kernels import cost
from repro_torch.kernels.decode_attention import kernel as dense_kernel
from repro_torch.kernels.decode_attention import paged_kernel
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.mxfp4_vmm import kernel as vmm_kernel
from repro_torch.launch import dryrun
from repro_torch.launch import shapes as shp
from repro_torch.models.common import blocked_attention
from repro_torch.models.model import Model

ROOT = Path(__file__).resolve().parents[1]
REF_RECORD = ROOT / "experiments" / "dryrun" / "mamba2-370m__decode_32k__16x16.json"
CELLS = [(a, s) for a in ASSIGNED_ARCHS for s in shp.SHAPES]


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------


def test_shapes_and_archs_equal_the_reference():
    assert ASSIGNED_ARCHS == list(REF_ARCHS)
    assert {k: dataclasses.astuple(v) for k, v in shp.SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in ref_shapes.SHAPES.items()}
    assert shp.VLM_IMAGE_TOKENS == ref_shapes.VLM_IMAGE_TOKENS
    for k, v in shp.SHAPES.items():
        assert v.step_kind == ref_shapes.SHAPES[k].step_kind


def _sd(x) -> tuple:
    """(shape, dtype name) of a stand-in of either package."""
    return tuple(x.shape), str(x.dtype).replace("torch.", "")


def _layers_of_ref_cache(cache, model: Model) -> list:
    """The reference's cache, one entry a layer in the port's order: a
    segment of ``reps`` layers stacks each leaf on a leading axis."""
    out = []
    for seg, seg_cache in zip(model.plan, cache):
        for r in range(seg.reps):
            for kc in seg_cache:
                out.append(jax.tree.map(
                    lambda x: jax.ShapeDtypeStruct(
                        x.shape[1:] if seg.reps > 1 else x.shape, x.dtype),
                    kc))
    return out


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [(k, *v) for k in sorted(tree) for v in _leaves(tree[k])]
    return [_sd(tree)]


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_cell_specs_equal_the_reference(arch, shape):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    spec, ref_spec = shp.SHAPES[shape], ref_shapes.SHAPES[shape]
    assert shp.cell_supported(cfg, spec) == ref_shapes.cell_supported(
        ref_cfg, ref_spec)
    if not shp.cell_supported(cfg, spec)[0]:
        return
    if spec.kind in ("train", "prefill"):
        got = shp.batch_specs(cfg, spec)
        want = ref_shapes.batch_specs(ref_cfg, ref_spec)
        assert {k: _sd(v) for k, v in got.items()} == {
            k: _sd(v) for k, v in want.items()}
        assert all(v.is_meta for v in got.values())
        return
    model = Model(cfg, device="meta")
    tokens, cache, cur_pos = shp.decode_specs(cfg, spec, model)
    r_tokens, r_cache, r_pos = ref_shapes.decode_specs(
        ref_cfg, ref_spec, build_model(ref_cfg))
    assert _sd(tokens) == _sd(r_tokens) and tokens.is_meta
    assert cur_pos == spec.seq_len - 1 and r_pos.shape == ()
    ref_layers = _layers_of_ref_cache(r_cache, model)
    assert len(ref_layers) == len(cache) == cfg.n_layers
    for got, want in zip(cache, ref_layers):
        assert _leaves(got) == _leaves(want)


# ---------------------------------------------------------------------------
# the op counter on loop programs (tests/test_hlo_cost.py's)
# ---------------------------------------------------------------------------


def test_loop_flops_are_exact():
    x, w = torch.randn(64, 128), torch.randn(128, 128)

    def loop(x, w):
        for _ in range(12):
            x = x @ w
        return x

    _, c = count(loop, x, w)
    assert c.flops == 2 * 64 * 128 * 128 * 12
    assert c.unknown_trip_loops == 0
    # each product reads x and w and writes its output: op-level bytes
    assert c.bytes == 12 * 4 * (2 * 64 * 128 + 128 * 128)


def test_nested_loop_flops_multiply():
    x, w = torch.randn(32, 64), torch.randn(7, 64, 64)

    def nested(x, ws):
        for i in range(7):
            for _ in range(5):
                x = x @ ws[i]
        return x

    _, c = count(nested, x, w)
    assert c.flops == 2 * 32 * 64 * 64 * 35


def test_stacked_weight_reads_each_layer_once():
    """A 16-layer loop over one stacked weight: each step reads its own
    layer's slice (a view, which moves nothing), never the whole stack;
    the least traffic reads the stack and x once and writes the output
    once."""
    x, ws = torch.randn(64, 128), torch.randn(16, 128, 128)

    def stacked(x, ws):
        for i in range(16):
            x = x @ ws[i]
        return x

    out, c = count(stacked, x, ws)
    assert c.flops == 2 * 64 * 128 * 128 * 16
    assert c.bytes == 16 * 4 * (2 * 64 * 128 + 128 * 128)
    assert c.bound_bytes == ws.nbytes + x.nbytes + out.nbytes


def test_indexed_write_counts_the_region():
    """A write into one slot of a cache reads and writes only the slot
    (the walker's dynamic-update-slice); the least traffic reads the
    cache and the update once and writes the slot once."""
    cache, new = torch.zeros(4, 100, 8), torch.ones(4, 8)

    def write(cache, new):
        cache[:, 5] = new
        idx = torch.tensor([7, 9])
        cache[:, idx] = new[:, None].expand(4, 2, 8)
        return cache.sum()

    out, c = count(write, cache, new)
    slot, two = 4 * 8 * 4, 4 * 2 * 8 * 4
    assert c.bound_bytes == cache.nbytes + new.nbytes + slot + two + 4
    assert c.bytes == (2 * slot                   # copy_ into the slot
                       + 2 * two + 2 * 8          # index_put_ + its index
                       + cache.nbytes + 4)        # the sum


# ---------------------------------------------------------------------------
# each kernel's formula and its witness
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,kvh,d", [(4, 2, 32), (4, 4, 64)])
def test_flash_formula_equals_plain_count_noncausal(h, kvh, d):
    """One block of non-causal ``blocked_attention`` computes every (query,
    key) pair: its counted FLOPs equal the flash formula's exactly."""
    g = torch.Generator().manual_seed(0)
    b, s = 2, 64
    q = torch.randn(b, s, h, d, generator=g)
    k, v = torch.randn(b, s, kvh, d, generator=g), torch.randn(
        b, s, kvh, d, generator=g)
    _, c = count(lambda: blocked_attention(q, k, v, causal=False))
    flops, _ = cost.flash_cost(b, s, s, h, kvh, False, 4, d)
    assert c.flops == flops


def test_causal_counts_differ_by_the_masked_pairs():
    """Causal: the formula counts the visible pairs, S (S + 1) / 2 a head;
    the plain path computes whole 512-blocks, the masked half of each
    diagonal block and the blocks past it too (``blocked_attention`` does
    not skip a block), so it counts S^2 pairs: 2 B H (D + Dv) (S^2 - S
    (S + 1) / 2) more, here 1.998x."""
    b, s, h, d = 1, 1024, 2, 16
    q = torch.randn(b, s, h, d)
    k, v = torch.randn(b, s, h, d), torch.randn(b, s, h, d)
    _, c = count(lambda: blocked_attention(q, k, v, causal=True))
    flops, _ = cost.flash_cost(b, s, s, h, h, True, 4, d)
    assert c.flops - flops == 2 * b * h * 2 * d * (s * s - s * (s + 1) // 2)
    assert c.flops / flops == pytest.approx(2 * s / (s + 1))


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _recorded(fn):
    with OpCounter() as oc:
        out = fn()
    return out, oc.cost


def test_meta_flash_reports_its_formula():
    b, s, h, kvh, d = 2, 300, 8, 2, 128
    out, c = _recorded(lambda: flash_kernel.flash_attention(
        _meta(b, s, h, d), _meta(b, s, kvh, d), _meta(b, s, kvh, d),
        causal=True, window=100))
    assert out.is_meta and tuple(out.shape) == (b, s, h, d)
    want = cost.flash_cost(b, s, s, h, kvh, True, 2, d, 100)
    assert c.kernels == {"flash_attention": {
        "launches": 1, "flops": want[0], "bytes": want[1]}}
    assert (c.flops, c.bytes) == want
    # MLA's pair: v narrower than q/k
    out, c = _recorded(lambda: flash_kernel.flash_attention(
        _meta(1, 64, 4, 192), _meta(1, 64, 4, 192), _meta(1, 64, 4, 128)))
    assert tuple(out.shape) == (1, 64, 4, 128)
    assert (c.flops, c.bytes) == cost.flash_cost(1, 64, 64, 4, 4, True, 2,
                                                 192, None, 128)


def test_meta_dense_decode_reports_its_formula():
    b, s, h, kvh, d = 4, 4096, 40, 8, 128
    out, c = _recorded(lambda: dense_kernel.decode_attention(
        _meta(b, h, d), _meta(b, s, kvh, d), _meta(b, s, kvh, d),
        _meta(b, dtype=torch.int32)))
    assert out.is_meta and tuple(out.shape) == (b, h, d)
    assert (c.flops, c.bytes) == cost.dense_cost(np.full(b, s), b, 2, h,
                                                 kvh, d)
    assert c.kernels["decode_attention"]["launches"] == 1


@pytest.mark.parametrize("scaled", [False, True])
def test_meta_paged_decode_reports_its_formula(scaled):
    """Online and exact (C 5): on meta the positions are unknown, so
    every block of the table counts as live."""
    b, h, kvh, d, page, nb = 3, 32, 8, 128, 16, 10
    pool_dt = torch.float8_e4m3fn if scaled else torch.bfloat16
    sc = (_meta(40, page, kvh, dtype=torch.float32),) * 2 if scaled else (
        None, None)
    args = (_meta(40, page, kvh, d, dtype=pool_dt),
            _meta(40, page, kvh, d, dtype=pool_dt),
            _meta(b, nb, dtype=torch.int32), _meta(b, dtype=torch.int32))
    out, c = _recorded(lambda: paged_kernel.paged_decode_attention(
        _meta(b, h, d), *args, k_scales=sc[0], v_scales=sc[1]))
    assert out.is_meta and tuple(out.shape) == (b, h, d)
    pos = np.full(b, nb * page - 1)
    isz, ssz = (1, 4) if scaled else (2, 0)
    assert (c.flops, c.bytes) == cost.paged_cost(pos, None, b, isz, 2, ssz,
                                                 geom=(h, kvh, d, page))
    name = "paged_decode_attention_scaled" if scaled else \
        "paged_decode_attention"
    assert list(c.kernels) == [name]
    out, c = _recorded(lambda: paged_kernel.paged_decode_multi_attention(
        _meta(b, 5, 8, d), *args, k_scales=sc[0], v_scales=sc[1]))
    assert tuple(out.shape) == (b, 5, 8, d)
    assert (c.flops, c.bytes) == cost.paged_cost(
        np.full(b, nb * page - 5), None, b, isz, 2, ssz, 5,
        geom=(8, kvh, d, page))
    assert list(c.kernels) == ["paged_decode_attention_exact"]


def test_meta_mxfp4_reports_its_formula():
    m, k, ns = 8, 4096, (4096, 1024, 1024)
    ws = [(_meta(k // 2, n, dtype=torch.uint8), _meta(k // 32, n,
                                                       dtype=torch.uint8))
          for n in ns]
    outs, c = _recorded(lambda: vmm_kernel.mxfp4_vmm_group(
        _meta(m, k), ws, torch.bfloat16))
    assert [tuple(o.shape) for o in outs] == [(m, n) for n in ns]
    assert all(o.dtype == torch.bfloat16 and o.is_meta for o in outs)
    assert (c.flops, c.bytes) == cost.vmm_cost(m, k, ns)
    assert c.kernels["mxfp4_vmm"]["launches"] == 1


def test_bounds_are_the_formulas_at_the_data_sheet_rates():
    """``*_bound`` is ``roofline`` of ``*_cost``: the larger of bytes over
    3.35 TB/s and operations over the type's peak, in ms."""
    flops, nbytes = cost.flash_cost(8, 1024, 1024, 32, 8, True, 2, 128)
    assert cost.flash_bound(8, 1024, 1024, 32, 8, True, 2, "bfloat16",
                            128) == (flops / 989e12 * 1e3, "operations")
    flops, nbytes = cost.dense_cost(np.full(8, 1088), 8, 2, 32, 8, 128)
    assert cost.dense_bound(np.full(8, 1088), 8, 2, "bfloat16", 32, 8,
                            128) == (nbytes / 3.35e12 * 1e3, "bytes")


# ---------------------------------------------------------------------------
# parity with the reference's count on reduced cells
# ---------------------------------------------------------------------------

REDUCED = (("qwen3-14b", "train_4k"), ("h2o-danube-1.8b", "prefill_32k"),
           ("mamba2-370m", "decode_32k"))
SEQ, BATCH = 256, 2          # one 512-block of blocked_attention


def _ref_step(cfg, shape):
    """The reference dry-run's step and stand-ins for one cell, no mesh."""
    if shape.kind == "train":
        model = build_model(cfg, moe_impl="capacity")
        step = ref_make_train_step(model, RefAdamWConfig(), remat=True)
        state = jax.eval_shape(lambda: ref_init_train_state(
            model, jax.random.PRNGKey(0)))
        return step, (state, ref_shapes.batch_specs(cfg, shape))
    model = build_model(cfg)
    params = ref_shapes.param_specs(model)
    if shape.kind == "prefill":
        cache = jax.eval_shape(lambda: model.init_cache(shape.global_batch,
                                                        shape.seq_len))
        return (lambda p, b, c: model.prefill(p, b, c),
                (params, ref_shapes.batch_specs(cfg, shape), cache))
    tokens, cache, pos = ref_shapes.decode_specs(cfg, shape, model)
    return serve_step_fn(model), (params, tokens, cache, pos)


@pytest.fixture(scope="module")
def reduced_counts():
    """Each reduced cell counted by both packages once: (reference report,
    the reference stand-ins' bytes, the port's Cost, the port's argument
    bytes)."""
    out = {}
    for arch, name in REDUCED:
        ref_cfg = ref_reduced_config(ref_get_config(arch))
        ref_shape = dataclasses.replace(ref_shapes.SHAPES[name], seq_len=SEQ,
                                        global_batch=BATCH)
        step, args = _ref_step(ref_cfg, ref_shape)
        report = ref_roofline.analyze_compiled(
            jax.jit(step).lower(*args).compile())
        ref_bytes = sum(math.prod(x.shape) * jnp.dtype(x.dtype).itemsize
                        for x in jax.tree.leaves(args))
        shape = dataclasses.replace(shp.SHAPES[name], seq_len=SEQ,
                                    global_batch=BATCH)
        c, arg_bytes, _ = dryrun.count_cell(
            reduced_config(get_config(arch)), shape, device="cpu")
        out[arch] = (report, ref_bytes, c, arg_bytes)
    return out


def _method_difference(arch) -> int:
    """The FLOPs the reference counts and the port does not, by method."""
    cfg = reduced_config(get_config(arch))
    if arch == "qwen3-14b":        # the checkpointed scan's recompute
        return cfg.n_layers * 2 * BATCH * cfg.n_heads * SEQ * SEQ * (
            cfg.hd + cfg.v_hd)
    if arch == "mamba2-370m":      # the conv einsum "bkc,kc->bc"
        conv_ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        return cfg.n_layers * 2 * BATCH * cfg.conv_kernel * conv_ch
    return 0


@pytest.mark.parametrize("arch,shape", REDUCED, ids=[a for a, _ in REDUCED])
def test_reduced_cell_matches_reference_count(reduced_counts, arch, shape):
    report, ref_bytes, c, arg_bytes = reduced_counts[arch]
    assert c.flops + _method_difference(arch) == report.flops_per_device
    # the reference's cur_pos is an int32 argument, the port's a Python int
    assert arg_bytes + (4 if shape == "decode_32k" else 0) == ref_bytes
    assert 1 / 3 < c.bytes / report.bytes_per_device < 3
    assert c.unknown_trip_loops == 0 and report.flops_per_device > 0


# ---------------------------------------------------------------------------
# the roofline report and the CLI
# ---------------------------------------------------------------------------


def test_analyze_counted_terms():
    c = dryrun.count_cell(get_config("mamba2-370m"),
                          shp.SHAPES["long_500k"])[0]
    r = roofline.analyze_counted(c, name="x", model_flops_total=1e9)
    assert r.chip == "h100_sxm" and r.n_chips == 1
    assert r.compute_s == c.flops / 989e12
    assert r.memory_s == c.bound_bytes / 3.35e12
    assert r.op_memory_s == c.bytes / 3.35e12
    assert r.collective_s == 0 and r.collective_detail == {}
    assert r.bound_s == max(r.compute_s, r.memory_s)
    assert r.dominant == "memory" and r.useful_flops_ratio == 1e9 / c.flops
    assert r.row()["bound_s"] == r.bound_s


def test_cli_counts_full_size_mamba2_decode(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-370m", "--shape", "decode_32k", "--out", str(tmp_path)],
        capture_output=True, text=True, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("OK") and "dominant=" in res.stdout
    rec = json.loads((tmp_path / "mamba2-370m__decode_32k__1xh100.json")
                     .read_text())
    ref = json.loads(REF_RECORD.read_text())
    want = ref["flops_per_device"] * ref["chips"]           # 9.755e10
    assert rec["flops_per_device"] == pytest.approx(want, rel=0.05)
    assert rec["device"] == "meta" and rec["chip"]["name"] == "h100_sxm"
    assert rec["model_flops_total"] == pytest.approx(ref["model_flops_total"])


def test_cli_skips_an_encoder_decode(tmp_path, capsys):
    assert dryrun.main(["--arch", "hubert-xlarge", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert out.startswith("SKIP") and "encoder-only" in out
    assert not list(tmp_path.iterdir())


def test_pod_meshes_raise_naming_tensor_parallelism(tmp_path):
    """The pod meshes count one rank; what they refuse is a device or a
    batch of their own (a 256-card cell is counted on ``meta`` at the
    shape's batch)."""
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "qwen3-14b", "--shape", "decode_32k",
                     "--single-pod", "--device", "cuda"])
    assert dryrun.main(["--arch", "hubert-xlarge", "--shape", "decode_32k",
                        "--multi-pod", "--out", str(tmp_path)]) == 0
    assert not list(tmp_path.iterdir())          # the reference's skip


# ---------------------------------------------------------------------------
# the pod meshes: one rank of 16x16 / 2x16x16 counted on meta
# ---------------------------------------------------------------------------


def test_pod_mamba2_decode_per_rank_flops():
    """mamba2-370m ``decode_32k`` on 16x16, one rank counted: 256 x its
    FLOPs within 10% of the port's one-device count of the cell (no rank
    repeats another's work: the B / C projection is a column block), and
    beside the reference's per-device record (``flops_per_device``
    3.81e8)."""
    one = dryrun.count_cell(get_config("mamba2-370m"),
                            shp.SHAPES["decode_32k"])[0].flops
    rec = dryrun.run_pod_cell("mamba2-370m", "decode_32k", False,
                              out_dir=None)
    ref = json.loads(REF_RECORD.read_text())
    print(f"mamba2-370m decode_32k 16x16 flops/device: port "
          f"{rec['flops_per_device']:.4g}, reference "
          f"{ref['flops_per_device']:.4g}")
    assert rec["chips"] == ref["chips"] == 256
    assert rec["plan"] == ref["plan"]
    assert rec["flops_per_device"] * 256 == pytest.approx(one, rel=0.10)
    assert rec["collective_s"] > 0 and rec["dominant"] == "memory"
    assert rec["model_flops_total"] == pytest.approx(ref["model_flops_total"])


def test_pod_qwen3_decode_prices_its_collectives(tmp_path):
    """qwen3-14b ``decode_32k`` on 16x16 (full tensor parallelism over
    all 256 cards, the KV cache split by sequence over them): a positive
    collective term from the counted collectives over NVLink, each kind's
    operand bytes beside its wire bytes, and the record on disk."""
    assert dryrun.main(["--arch", "qwen3-14b", "--shape", "decode_32k",
                        "--single-pod", "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "qwen3-14b__decode_32k__16x16.json")
                     .read_text())
    assert rec["plan"]["tp"] == ["data", "model"]
    assert rec["plan"]["cache_seq"] == ["data", "model"]
    assert rec["collective_s"] > 0
    colls = rec["collectives"]
    assert {"all-gather", "all-reduce"} <= set(colls)
    total = sum(c["operand_bytes"] for c in colls.values())
    assert rec["collective_bytes_per_device"] == total
    assert rec["collective_s"] == pytest.approx(total / 450e9)
    assert "NVLink" in rec["collective_link"]


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
def test_pod_skips_are_the_references(multi, capsys):
    """``--list`` on a pod mesh: every cell, the reference's verdicts."""
    flag = "--multi-pod" if multi else "--single-pod"
    assert dryrun.main(["--list", flag]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(ASSIGNED_ARCHS) * len(shp.SHAPES)
    mesh = "2x16x16" if multi else "16x16"
    for line, (arch, shape) in zip(lines, dryrun.all_cells()):
        ok, reason = ref_shapes.cell_supported(ref_get_config(arch),
                                               ref_shapes.SHAPES[shape])
        assert line.split()[:3] == [arch, shape, mesh]
        assert line.endswith("RUN") if ok else reason in line
