"""The port's examples (``examples/torch_*.py``) with ``--device cpu`` at
tiny flags, each as a user runs it (a fresh interpreter, all four at
once): every one exits 0 and prints its summary lines;
``torch_design_space.py`` prints what the reference's
``examples/design_space.py`` prints for the same arguments, and
``torch_quickstart.py``'s analytic sections (1: HBM-CO, 2: the RPU
deployment of Llama3-70B) and section 4's ``DeploymentSpec`` budget print
the lines the reference's quickstart builds from ``repro.core.hbmco``,
``repro.sim.scaling`` and ``repro.runtime.deployment`` (the reference's
script itself, whose JAX training and serving cost a minute, is not
run)."""
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120
# (example, its tiny flags, a line each run must print)
RUNS = {
    "quickstart": ([], "== DeploymentSpec: HBM-CO budget drives the real "
                       "engine =="),
    "serve_decode": (["--batch", "2", "--prompt-len", "8", "--new", "4",
                      "--speculative"], "[continuous] streamed deltas"),
    "train_small": (["--steps", "1", "--batch", "1", "--seq", "16",
                     "--no-failure"], "done: 1 steps"),
    "design_space": (["--arch", "llama3-8b", "--target-ms", "0.5",
                      "--tdp-w", "1000"], "frontier SKUs:"),
}


def _popen(args, cwd, env):
    return subprocess.Popen([sys.executable, *args], cwd=cwd, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def example_runs(tmp_path_factory):
    """Every port example and the reference's design-space example, run
    together: {name: (return code, stdout, stderr)}."""
    tmp = tmp_path_factory.mktemp("examples")
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}
    procs = {}
    for name, (flags, _) in RUNS.items():
        extra = (["--ckpt-dir", str(tmp / "ckpt")] if name == "train_small"
                 else [])
        procs[name] = _popen([os.path.join(REPO, "examples",
                                           f"torch_{name}.py"),
                              "--device", "cpu", *flags, *extra],
                             str(tmp), env)
    procs["reference_design_space"] = _popen(
        [os.path.join(REPO, "examples", "design_space.py"),
         *RUNS["design_space"][0]], str(tmp), env)
    out = {}
    try:
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=TIMEOUT_S)
            out[name] = (p.returncode, stdout, stderr)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        shutil.rmtree(tmp / "ckpt", ignore_errors=True)   # ~1.2 GB
    return out


@pytest.mark.parametrize("name", list(RUNS))
def test_example_runs_on_the_cpu(example_runs, name):
    rc, stdout, stderr = example_runs[name]
    assert rc == 0, stdout[-2000:] + stderr[-4000:]
    assert RUNS[name][1] in stdout


def test_design_space_prints_what_the_reference_prints(example_runs):
    rc, want, err = example_runs["reference_design_space"]
    assert rc == 0, err[-4000:]
    assert example_runs["design_space"][1] == want


def test_quickstart_analytic_lines_are_the_reference_s(example_runs):
    """Sections 1 and 2 line for line, and section 4's budget
    (``describe()``: the reduced qwen3's exact weight bytes on the
    reference's HBM-CO candidate), as the reference's quickstart builds
    them."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config, reduced_config
    from repro.core.hbmco import CANDIDATE_CO, HBM3E_LIKE
    from repro.models.model import build_model
    from repro.runtime.deployment import DeploymentSpec
    from repro.sim.scaling import iso_tdp_comparison, rpu_point
    p = rpu_point(get_config("llama3-70b"), 204, batch=1, seq_len=8192)
    r = iso_tdp_comparison(get_config("llama3-70b"), batch=1, seq_len=8192)
    analytic = [
        "== HBM-CO (paper §III) ==",
        "  " + HBM3E_LIKE.describe(),
        "  " + CANDIDATE_CO.describe(),
        f"  energy ratio: {HBM3E_LIKE.energy_pj_per_bit / CANDIDATE_CO.energy_pj_per_bit:.2f}x"
        f"  (paper: 2.4x)",
        "",
        "== RPU deployment for Llama3-70B (paper §VIII) ==",
        f"  204 CUs, SKU {p.sku.name}: {p.ms_per_token:.2f} ms/token "
        f"(paper: 0.4), {p.tdp_w:.0f} W",
        f"  ISO-TDP vs {r['n_gpus']}xH100: {r['speedup']:.1f}x lower latency"]
    rc, stdout, stderr = example_runs["quickstart"]
    assert rc == 0, stderr[-4000:]
    lines = stdout.splitlines()
    assert lines[:len(analytic)] == analytic
    model = build_model(reduced_config(get_config("qwen3-14b")))
    params = model.init(jax.random.PRNGKey(0))
    spec = DeploymentSpec(sku="rpu-cu", hbmco=CANDIDATE_CO,
                          weight_format="mxfp4", max_len=80,
                          cache_dtype=jnp.float32, max_slots=4)
    budget = spec.resolve(model, params).describe().splitlines()
    at = lines.index("== DeploymentSpec: HBM-CO budget drives the real "
                     "engine ==") + 1
    assert lines[at:at + len(budget)] == budget
