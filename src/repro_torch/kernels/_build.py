"""Build a kernel's CUDA sources into a shared library and load it.

``nvcc`` compiles the repo's own ``csrc/*.cu`` files at first use into
``<repo>/.torch_ext/<name>-<hash>/lib<name>.so`` (a plain C interface, no
PyTorch headers, so a build takes seconds), and ``ctypes`` loads the result.
The hash covers the sources and the flags, so an edited kernel rebuilds and
an unchanged one is reused.  A failed build raises with the compiler's
output; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / ".torch_ext"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found (looked at $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin); the CUDA kernels cannot build")


def library_path(name: str, sources: list[Path]) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}" / f"lib{name}.so"


def build(name: str, sources: list[Path]) -> ctypes.CDLL:
    """Compile ``sources`` (if not already built) and load the library.
    The compiler's report (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside the library as ``build.log``."""
    out = library_path(name, sources)
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        (out.parent / "build.log").write_text(
            " ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name} "
                               f"(rc {res.returncode}):\n{res.stderr}")
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))
