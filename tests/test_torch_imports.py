"""The PyTorch port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or the JAX reference package ``repro``."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
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


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_import(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"
