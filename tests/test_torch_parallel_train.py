"""The port's training plan and gradient compression against the JAX
reference, in one process with no process group (the ranks' runs are
``test_torch_tp_train.py``).

``make_plan``'s choices (dp, tp, fsdp, cache_seq, seq_parallel, ep,
shard_ssm) equal the reference's for every assigned config and shape on
the production meshes ((16, 16) and (2, 16, 16), as ``MeshShape``s beside
the reference's abstract meshes); each parameter's and moment's local
shard shape equals the reference's ``NamedSharding(...).shard_shape`` of
the stacked leaf (its layer axis dropped, through ``bridge.py``'s layer
locations), for every assigned config at full size on both production
meshes and for the reduced training families on the test meshes;
``_drop_uneven`` and the batch specs equal the reference's; a plan of a
serving kind refuses to run a training step, naming the static engine
that runs it; and ``int8_quantize`` / the compressed mean equal the
reference's functions bit for bit on the same numpy inputs, with the error
feedback carried over 20 steps on two and three pods (the reference's
pods as a ``vmap`` axis, run eagerly: under ``jit`` XLA rewrites its
divisions by the constants 127 and P as multiplies by the reciprocals)."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (import order: models before kernels)
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.configs import ASSIGNED_ARCHS, get_config, reduced_config
from repro.launch import shapes as jshapes
from repro.models.model import build_model
from repro.parallel import compression as jcomp
from repro.parallel import hints as jhints
from repro.parallel import plan as jplan
from repro.parallel.compat import make_abstract_mesh
from repro_torch import configs as tconfigs
from repro_torch.bridge import _layer_locations
from repro_torch.launch.mesh import (
    AXES, POD_AXES, MeshShape, make_production_mesh, mesh_shape, parse_mesh,
)
from repro_torch.models.model import Model
from repro_torch.parallel import compression as tcomp
from repro_torch.parallel import plan as tplan
from repro_torch.parallel.train import refuse_non_train

PRODUCTION = [((16, 16), AXES), ((2, 16, 16), POD_AXES)]
# the reduced training families and the meshes the ranks train them on
TRAIN_ARCHS = ["qwen3-14b", "llama3-8b", "deepseek-v2-lite-16b",
               "mamba2-370m", "qwen2.5-14b", "hymba-1.5b", "hubert-xlarge",
               "llama4-scout-109b-a17b"]
TEST_MESHES = [((1, 4), AXES), ((4, 1), AXES), ((2, 2), AXES),
               ((2, 1, 2), POD_AXES)]


def _spec(p) -> tuple:
    """A reference ``PartitionSpec`` (or None) as the port's tuple."""
    return tuple(p) if p is not None else None


def _entry(e):
    """A spec entry normalised: a one-axis tuple is that axis (as a
    ``PartitionSpec`` reads it)."""
    if isinstance(e, (list, tuple)):
        return e[0] if len(e) == 1 else tuple(e)
    return e


def _same_plan(jp, tp) -> None:
    assert tuple(jp.dp) == tuple(tp.dp)
    assert jp.tp == tp.tp
    assert tuple(jp.fsdp) == tuple(tp.fsdp)
    assert _entry(jp.cache_seq) == _entry(tp.cache_seq)
    assert (jp.seq_parallel, jp.ep, jp.shard_ssm) == (
        tp.seq_parallel, tp.ep, tp.shard_ssm)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_make_plan_matches_reference(arch):
    """Every shape kind on both production meshes; ``make_production_mesh``
    is the reference's mesh as a ``MeshShape``."""
    cfg, tcfg = get_config(arch), tconfigs.get_config(arch)
    for (shape, axes), multi in zip(PRODUCTION, (False, True)):
        mesh = make_production_mesh(multi_pod=multi)
        assert (mesh.shape, mesh.mesh_dim_names) == (shape, axes)
        jmesh = make_abstract_mesh(shape, axes)
        for name, sh in jshapes.SHAPES.items():
            jp = jplan.make_plan(cfg, jmesh, global_batch=sh.global_batch,
                                 shape_kind=sh.kind)
            tp = tplan.make_plan(tcfg, mesh, global_batch=sh.global_batch,
                                 shape_kind=sh.kind)
            _same_plan(jp, tp)
            assert tplan._full_tp_ok(tcfg, mesh) == jplan._full_tp_ok(cfg,
                                                                      jmesh)
            if sh.kind != "train":
                with pytest.raises(ValueError, match="serving plan"):
                    refuse_non_train(tp)
        # a given param_bytes decides FSDP as the reference's does
        jp = jplan.make_plan(cfg, jmesh, global_batch=512,
                             shape_kind="prefill", param_bytes=1e12)
        tp = tplan.make_plan(tcfg, mesh, global_batch=512,
                             shape_kind="prefill", param_bytes=1e12)
        _same_plan(jp, tp)


def _reference_leaves(jparams) -> dict:
    """{path tuple: abstract leaf} of the reference's parameter tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        out[tuple(jplan._path_names(path))] = leaf
    return out


def _port_to_reference(model: Model, name: str) -> tuple[tuple, bool]:
    """The reference's path of a port parameter, and whether its leaf
    carries a layer axis (``bridge._layer_locations``)."""
    parts = name.split(".")
    if parts[0] != "layers":
        return (name,), False
    si, ki, _, stacked = _layer_locations(model)[int(parts[1])]
    return ("stacks", f"[{si}]", f"[{ki}]", *parts[2:]), stacked


def check_shard_shapes(jcfg, tcfg, shape, axes, kind="train") -> int:
    """Every port parameter's (and, for train, moment's) shard shape
    against the reference's; returns the leaves checked."""
    jmesh = make_abstract_mesh(shape, axes)
    mesh = MeshShape(shape, axes)
    jp = jplan.make_plan(jcfg, jmesh, global_batch=256, shape_kind=kind)
    tp = tplan.make_plan(tcfg, mesh, global_batch=256, shape_kind=kind)
    ref = build_model(jcfg)
    jparams = jax.eval_shape(lambda: ref.init(jax.random.PRNGKey(0)))
    leaves = _reference_leaves(jparams)
    shard = {k: v for k, v in zip(
        leaves, jax.tree.leaves(jp.param_shardings(jparams),
                                is_leaf=lambda s: isinstance(
                                    s, NamedSharding)))}
    model = Model(tcfg, device="meta")
    n = 0
    specs = tp.param_shardings({k: p for k, p in model.named_parameters()})
    for name, p in model.named_parameters():
        path, stacked = _port_to_reference(model, name)
        leaf = leaves[path]
        want = shard[path].shard_shape(leaf.shape)
        want = tuple(want[1:]) if stacked else tuple(want)
        got = tplan.shard_shape(specs[name], tuple(p.shape), mesh)
        assert got == tp.shard_shape(name, tuple(p.shape))
        assert got == want, (name, got, want, shard[path].spec)
        n += 1
    return n


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
def test_full_size_shard_shapes_match_reference(multi):
    """Each assigned config at full size, train plan (params and moments
    share their specs): every leaf's local shape on the production mesh."""
    shape, axes = PRODUCTION[int(multi)]
    for arch in ASSIGNED_ARCHS:
        assert check_shard_shapes(get_config(arch), tconfigs.get_config(arch),
                                  shape, axes) > 0


@pytest.mark.parametrize("shape,axes", TEST_MESHES,
                         ids=["1x4", "4x1", "2x2", "2x1x2"])
def test_reduced_shard_shapes_match_reference(shape, axes):
    """The reduced training families on the meshes their ranks train on
    (a KV head cut in half at 4-way: qwen3's and llama3's 2 KV heads of
    16 columns are 8 columns a rank)."""
    for arch in TRAIN_ARCHS:
        check_shard_shapes(reduced_config(get_config(arch)),
                           tconfigs.reduced_config(tconfigs.get_config(arch)),
                           shape, axes)
    tp = tplan.make_plan(tconfigs.reduced_config(tconfigs.get_config(
        "qwen3-14b")), MeshShape(shape, axes), global_batch=8,
        shape_kind="train")
    if shape == (1, 4):
        assert tp.shard_shape("layers.0.attn.wk", (64, 32)) == (64, 8)


def test_drop_uneven_matches_reference():
    """25 heads over a 16-way axis, 64 over (2, 16), a dim of 1: each
    dropped where the reference drops it."""
    cases = [((25 * 128, 5120), (None, "model")),
             ((5120, 25 * 128), (("pod", "data"), "model")),
             ((64, 7), ("model", None)), ((1, 32), (("pod", "data"), None)),
             ((48, 64, 32), (None, "model", ("pod", "data")))]
    shape, axes = PRODUCTION[1]
    jmesh = make_abstract_mesh(shape, axes)
    mesh = MeshShape(shape, axes)
    for dims, spec in cases:
        want = jhints._drop_uneven(NamedSharding(jmesh, P(*spec)), dims)
        got = tplan._drop_uneven(spec, dims, mesh)
        assert got == tuple(_entry(e) for e in _spec(want.spec)) + (
            (None,) * (len(dims) - len(want.spec))), (dims, spec)


def test_batch_specs_and_rules_match_reference():
    cfg = get_config("qwen3-14b")
    for (shape, axes), multi in zip(PRODUCTION, (False, True)):
        jmesh = make_abstract_mesh(shape, axes)
        mesh = make_production_mesh(multi_pod=multi)
        for kind in ("train", "decode", "prefill", "long_decode"):
            gb = 1 if kind == "long_decode" else 256
            jp = jplan.make_plan(cfg, jmesh, global_batch=gb,
                                 shape_kind=kind)
            tp = tplan.make_plan(tconfigs.get_config("qwen3-14b"), mesh,
                                 global_batch=gb, shape_kind=kind)
            batch = {"tokens": np.zeros((gb, 16), np.int32),
                     "pos": np.zeros((), np.int32)}
            jb = jp.batch_shardings(batch)
            tb = tp.batch_shardings({k: v.shape for k, v in batch.items()})
            for k in batch:
                want = tuple(_entry(e) for e in jb[k].spec)
                got = tuple(_entry(e) for e in tb[k])
                assert got[:len(want)] == want
                assert all(e is None for e in got[len(want):])


def test_mesh_specs_and_refusals():
    """"DxM" / "PxDxM" parse; a mesh of more ranks than the world refuses
    in the launcher's words; the production mesh has no ranks."""
    assert mesh_shape("2x1x2") == (2, 1, 2) and mesh_shape((1, 4)) == (1, 4)
    for bad in ("2", "2x2x2x2", "axb"):
        with pytest.raises(ValueError, match="DxM or PxDxM"):
            mesh_shape(bad)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
        parse_mesh("2x1x2")
    assert make_production_mesh(multi_pod=True).size() == 512


def test_int8_quantize_matches_reference():
    """Codes and scale bit for bit: an all-zero tensor (scale 1), a
    tensor whose amax divides 127 inexactly, random scales."""
    rng = np.random.default_rng(0)
    cases = [np.zeros((16,), np.float32),
             np.array([0.3, -1.7, 2.2, 1e-9], np.float32)]
    cases += [(rng.standard_normal((33, 17)) * s).astype(np.float32)
              for s in (1e-6, 0.37, 250.0)]
    for g in cases:
        jq, js = jcomp.int8_quantize(jnp.asarray(g))
        tq, ts = tcomp.int8_quantize(torch.from_numpy(g))
        assert np.array_equal(np.asarray(jq), tq.numpy())
        assert np.asarray(js).tobytes() == ts.numpy().tobytes()
        jd = jcomp.int8_dequantize(jq, js)
        assert np.array_equal(np.asarray(jd),
                              tcomp.int8_dequantize(tq, ts).numpy())


@pytest.mark.parametrize("pods", [2, 3])
def test_compressed_mean_error_feedback_matches_reference(pods):
    """20 steps of the compressed mean with the residual carried, each
    pod's gradient drawn anew: the mean and every pod's residual bit for
    bit against the reference's ``compressed_mean`` (vmapped over the pod
    axis), and the mean of the sent values converging to the true mean
    (the reference's error-feedback property)."""
    rng = np.random.default_rng(pods)
    shape = (29, 41)
    err = np.zeros((pods,) + shape, np.float32)
    # eager, as the reference's functions are written: under jit XLA turns
    # the divisions by the constants 127 and P into multiplies by their
    # reciprocals, which round otherwise in a few percent of the scales
    ref = jax.vmap(lambda g, e: jcomp.compressed_mean(g, e, "pod"),
                   axis_name="pod")
    sent_total = np.zeros(shape, np.float64)
    true_total = np.zeros(shape, np.float64)
    for step in range(20):
        g = (rng.standard_normal((pods,) + shape)
             * rng.uniform(1e-4, 3.0, (pods, 1, 1))).astype(np.float32)
        want_mean, want_err = ref(jnp.asarray(g), jnp.asarray(err))
        codes, scales, new_err = [], [], []
        for p in range(pods):
            target = torch.from_numpy(g[p]) + torch.from_numpy(err[p])
            q, s = tcomp.int8_quantize(target)
            codes.append(q)
            scales.append(s)
            new_err.append((target - tcomp.int8_dequantize(q, s)).numpy())
        mean = tcomp.code_mean(torch.stack(scales), torch.stack(codes))
        assert np.asarray(want_mean[0]).tobytes() == mean.numpy().tobytes()
        for p in range(pods):
            assert np.asarray(want_err[p]).tobytes() == new_err[p].tobytes()
        err = np.stack(new_err)
        sent_total += mean.numpy()
        true_total += g.mean(axis=0)
    # the residual carries what int8 dropped: the running means agree
    np.testing.assert_allclose(sent_total, true_total,
                               atol=float(np.abs(err).max()) * 2 + 1e-6)


def test_init_error_state():
    err = tcomp.init_error_state({"a": torch.zeros(3, 4, dtype=torch.bfloat16),
                                  "b": (5,)})
    assert err["a"].dtype == torch.float32 and err["a"].shape == (3, 4)
    assert err["b"].shape == (5,) and not err["b"].any()
