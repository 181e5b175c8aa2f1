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


def test_speculative_entry_points_import_without_jax():
    """A fresh interpreter in which jax and repro cannot be imported still
    imports the port's speculative entry points."""
    import subprocess
    import sys
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
            "from repro_torch.runtime.speculative import SpeculativeEngine\n"
            "from repro_torch.runtime.llm import LLMEngine\n"
            "from repro_torch.kernels.decode_attention.paged_kernel import "
            "paged_decode_multi_attention\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(ROOT / "src"),
                                         "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_import(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"
