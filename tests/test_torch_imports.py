"""The PyTorch port stands alone: no module of ``src/repro_torch``, not
``chip_smoke.py`` and not the port's examples (``examples/torch_*.py``)
imports ``jax`` or the JAX reference package ``repro``."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("torch_*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_files_exist():
    assert (ROOT / "chip_smoke.py").is_file()
    assert len(PORT_FILES) > 10


@pytest.mark.parametrize("module", [
    "runtime/speculative.py", "runtime/sampling.py", "runtime/prng.py",
    "kernels/decode_attention/ref.py", "kernels/decode_attention/ops.py",
    "kernels/decode_attention/paged_kernel.py"])
def test_speculative_slice_modules_are_checked(module):
    """The speculative slice's modules are among the files checked above."""
    assert ROOT / "src" / "repro_torch" / module in PORT_FILES


@pytest.mark.parametrize("module", [
    "sim/__init__.py", "sim/isa.py", "sim/compiler.py", "sim/engine.py",
    "sim/gpu_model.py", "sim/scaling.py", "core/provisioning.py",
    "core/sku.py", "configs/llama4_scout.py",
    "configs/llama4_maverick_400b_a17b.py"])
def test_simulator_and_llama4_modules_are_checked(module):
    """The simulator, the cost models and the llama4 configs are among the
    files checked above."""
    assert ROOT / "src" / "repro_torch" / module in PORT_FILES


@pytest.mark.parametrize("module", [
    "fleet/__init__.py", "fleet/router.py", "fleet/traffic.py",
    "fleet/simulator.py", "fleet/autoscaler.py", "launch/__init__.py",
    "launch/serve.py", "launch/fleet.py"])
def test_fleet_and_launch_modules_are_checked(module):
    """The fleet package and the launchers are among the files checked
    above."""
    assert ROOT / "src" / "repro_torch" / module in PORT_FILES


def test_launchers_import_without_jax():
    """A fresh interpreter in which jax and repro cannot be imported
    imports the launchers, the fleet package and the disaggregated
    engine."""
    import subprocess
    import sys
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
            "from repro_torch.launch.serve import main\n"
            "from repro_torch.launch.fleet import main as fleet_main\n"
            "import repro_torch.fleet\n"
            "from repro_torch.runtime.engine import DisaggServeEngine, KVHandoff\n"
            "from repro_torch.runtime.sampling import sample, token_key\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(ROOT / "src"),
                                         "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr


def test_speculative_entry_points_import_without_jax():
    """A fresh interpreter in which jax and repro cannot be imported still
    imports the port's speculative entry points, the simulator and the
    cost models."""
    import subprocess
    import sys
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
            "from repro_torch.runtime.speculative import SpeculativeEngine\n"
            "from repro_torch.runtime.llm import LLMEngine\n"
            "from repro_torch.kernels.decode_attention.paged_kernel import "
            "paged_decode_multi_attention\n"
            "import repro_torch.sim\n"
            "from repro_torch.sim.scaling import iso_tdp_comparison\n"
            "from repro_torch.core import provisioning, sku\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(ROOT / "src"),
                                         "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("module", [
    "train/__init__.py", "train/optimizer.py", "train/train_step.py",
    "train/checkpoint.py", "train/loop.py", "data/__init__.py",
    "data/pipeline.py", "launch/train.py", "configs/hubert_xlarge.py",
    "configs/internvl2_26b.py"])
def test_training_and_frontend_modules_are_checked(module):
    """The training substrate, the data pipeline, the training launcher
    and the frontend configs are among the files checked below."""
    assert ROOT / "src" / "repro_torch" / module in PORT_FILES


def test_training_entry_points_import_without_jax():
    """A fresh interpreter in which jax, repro and ml_dtypes cannot be
    imported (the card's machine has no ml_dtypes) imports the training
    substrate and launcher, and writes and restores a bf16 checkpoint."""
    import subprocess
    import sys
    import tempfile
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
            "sys.modules['ml_dtypes'] = None\n"
            "import torch\n"
            "from repro_torch.launch.train import main\n"
            "from repro_torch.data import SyntheticTokenPipeline\n"
            "from repro_torch.train import (AdamWConfig, init_train_state,\n"
            "    make_train_step, run_training, save_checkpoint,\n"
            "    restore_latest)\n"
            "from repro_torch.configs import get_config, reduced_config\n"
            "from repro_torch.models.model import Model\n"
            "m = Model(reduced_config(get_config('hubert-xlarge')), 'cpu')\n"
            "st = init_train_state(m, seed=0)\n"
            "save_checkpoint(sys.argv[1], 1, st)\n"
            "back, step = restore_latest(sys.argv[1], st)\n"
            "assert step == 1 and torch.equal(back.params['in_proj'],\n"
            "                                 st.params['in_proj'])\n")
    with tempfile.TemporaryDirectory() as d:
        res = subprocess.run([sys.executable, "-c", code, d],
                             capture_output=True, text=True,
                             env={"PYTHONPATH": str(ROOT / "src"),
                                  "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("module", [
    "launch/shapes.py", "launch/dryrun.py", "core/op_cost.py",
    "core/roofline.py", "kernels/cost.py"])
def test_dryrun_modules_are_checked(module):
    """The dry-run's modules are among the files checked below."""
    assert ROOT / "src" / "repro_torch" / module in PORT_FILES


def test_dryrun_imports_without_jax():
    """A fresh interpreter in which jax and repro cannot be imported
    imports the dry-run and counts a full-size cell on meta."""
    import subprocess
    import sys
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
            "from repro_torch.launch import dryrun, shapes\n"
            "from repro_torch.core import op_cost, roofline\n"
            "from repro_torch.kernels import cost\n"
            "rec = dryrun.run_cell('mamba2-370m', 'long_500k', out_dir=None)\n"
            "assert rec['status'] == 'ok' and rec['flops_per_device'] > 0\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(ROOT / "src"),
                                         "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_import(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


@pytest.mark.parametrize("module", [
    "launch/mesh.py", "parallel/__init__.py", "parallel/plan.py",
    "parallel/hints.py", "parallel/collective_matmul.py"])
def test_tensor_parallel_modules_are_checked(module):
    """The mesh launcher, the serve plan, the TP marks and the ring
    collective matmuls are among the files checked below."""
    assert ROOT / "src" / "repro_torch" / module in PORT_FILES


def test_tensor_parallel_entry_points_import_without_jax():
    """A fresh interpreter in which jax and repro cannot be imported
    imports the mesh helpers, the plan and the ring matmuls, and prices a
    4-way plan on a ``MeshShape``."""
    import subprocess
    import sys
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
            "from repro_torch.launch.mesh import MeshShape, parse_mesh, "
            "init_world\n"
            "from repro_torch.parallel.plan import make_paged_serve_plan\n"
            "from repro_torch.parallel.hints import manual_tp_axis, TPComm\n"
            "from repro_torch.parallel.collective_matmul import "
            "ring_allgather_matmul\n"
            "from repro_torch.configs import get_config\n"
            "from repro_torch.models.model import Model\n"
            "cfg = get_config('llama3-8b')\n"
            "plan = make_paged_serve_plan(cfg, MeshShape((1, 4)))\n"
            "assert plan.tp == 4 and plan.reduce == 'gather'\n"
            "assert plan.psum_bytes_per_step(Model(cfg, 'meta'), 8) > 0\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(ROOT / "src"),
                                         "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("module", [
    "parallel/train.py", "parallel/compression.py"])
def test_parallel_training_modules_are_checked(module):
    """The training plan's execution and the cross-pod compression are
    among the files checked above."""
    assert ROOT / "src" / "repro_torch" / module in PORT_FILES


def test_parallel_training_entry_points_import_without_jax():
    """A fresh interpreter in which jax and repro cannot be imported
    imports the training plan, its execution and the compression, plans a
    train cell on the production mesh, and compresses a tensor."""
    import subprocess
    import sys
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
            "import torch\n"
            "from repro_torch.launch.mesh import make_production_mesh\n"
            "from repro_torch.parallel.plan import make_plan, ParallelPlan\n"
            "from repro_torch.parallel.train import (TrainLayout,\n"
            "    global_norm, predict_step_bytes)\n"
            "from repro_torch.parallel import compression\n"
            "from repro_torch.configs import get_config\n"
            "plan = make_plan(get_config('qwen3-14b'),\n"
            "                 make_production_mesh(multi_pod=True),\n"
            "                 global_batch=256, shape_kind='train')\n"
            "assert plan.fsdp == ('pod', 'data') and plan.seq_parallel\n"
            "q, s = compression.int8_quantize(torch.ones(4))\n"
            "assert q.dtype == torch.int8 and abs(float(s) - 1 / 127) < 1e-9\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(ROOT / "src"),
                                         "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("name", ["quickstart", "serve_decode",
                                  "train_small", "design_space"])
def test_examples_are_checked(name):
    """The port's four examples are among the files checked above."""
    assert ROOT / "examples" / f"torch_{name}.py" in PORT_FILES
