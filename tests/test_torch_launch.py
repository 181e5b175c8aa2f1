"""The port's serve launcher (``python -m repro_torch.launch.serve``) on
the CPU: every mode returns 0 and prints the reference launcher's summary
lines; tensor parallelism raises naming its ROADMAP item; a CUDA request
without a card raises.  Small sizes: the reduced qwen3-14b, 2-4 requests
of 12 tokens.  (The reference's own CLI is not run: its static path fails
under this jax, ROADMAP Queue 3; parity with the reference is held at the
``LLMEngine`` level in the other ``test_torch_*`` files.)"""
import pytest
import torch

from repro_torch.launch.serve import main

SMALL = ["--device", "cpu", "--batch", "2", "--prompt-len", "12",
         "--max-new", "4"]
CONT = ["--continuous", "--num-requests", "4", "--num-prompts", "2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op thread pool would only spin on the
    cores the parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("extra,lines", [
    ([], ["backend=static", "sample:"]),
    (CONT, ["tokens=", "prefill:", "ttft p50=", "finish reasons:",
            "sample:"]),
    (CONT + ["--spec-draft", "reduced", "--gamma", "2"],
     ["speculative: gamma=2 draft=reduced", "ttft p50="]),
    (["--speculative"], ["speculative: accepted/window=",
                         "backend=speculative"]),
    (CONT + ["--disaggregate", "1:1"],
     ["handoff: 4 chains", "prefix-shared tokens", "ttft p50="]),
    (CONT + ["--sampling-mix", "0.0:1.0,0.8:0.9:40", "--cache-dtype", "fp8"],
     ["sampling mix: 0.0:1.0,0.8:0.9:40", "tokens="]),
    (CONT + ["--sku", "h100", "--weight-format", "mxfp4"],
     ["tokens="]),
], ids=["static", "continuous", "spec-draft", "speculative", "disaggregate",
        "sampling-mix-fp8", "deployment-spec"])
def test_serve_modes_return_zero(capsys, extra, lines):
    assert main(SMALL + extra) == 0
    out = capsys.readouterr().out
    for line in lines:
        assert line in out, (line, out)


def test_fleet_modes_return_zero(capsys, tmp_path):
    assert main(["--fleet", "--requests", "80", "--rate", "60",
                 "--compare-routers"]) == 0
    out = capsys.readouterr().out
    assert "--- router=affinity" in out and "--- router=round-robin" in out
    assert main(["--fleet", "--plan", "--requests", "80"]) == 0
    assert "chosen:" in capsys.readouterr().out
    calib = tmp_path / "calibration"
    assert main(["--fleet", "--calibrate", "--device", "cpu", "--requests",
                 "10", "--rate", "40", "--calibration-dir", str(calib)]) == 0
    out = capsys.readouterr().out
    assert "throughput_ratio" in out
    assert [p.name for p in calib.iterdir()] == ["qwen3-14b-reduced--rpu-cu2"
                                                 ".json"]
    # simulate reads the table it wrote
    assert main(["--fleet", "--requests", "40", "--calibration-dir",
                 str(calib)]) == 0
    assert "using calibrated table" in capsys.readouterr().out


@pytest.mark.parametrize("extra", [["--mesh", "1x2"],
                                   ["--tp-reduce", "psum"]])
def test_tensor_parallelism_raises(extra):
    with pytest.raises(NotImplementedError, match="Tensor parallelism"):
        main(SMALL + CONT + extra)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is served")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--batch", "1", "--prompt-len", "4", "--max-new", "2"])
