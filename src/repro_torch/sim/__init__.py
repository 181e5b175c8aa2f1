"""RPU simulation framework (paper contribution C4).

  isa       — CISC-style phase/program representation
  compiler  — ModelConfig -> per-CU decode-step programs (paper §VI)
  engine    — event-driven decoupled-pipeline simulator (paper Fig 8)
  gpu_model — H100/H200 analytical baseline calibrated to §II measurements
  scaling   — strong scaling, ISO-TDP, energy & cost studies (Figs 11-13)

Copies of ``repro/sim/*`` with their imports redirected to the port's
``ModelConfig``, ``build_plan``, footprint and ``core`` modules; all
pure Python.
"""
from repro_torch.sim.isa import Phase, LayerProgram, Program
from repro_torch.sim.compiler import CompileOptions, compile_decode_step
from repro_torch.sim.engine import SimResult, simulate_program
