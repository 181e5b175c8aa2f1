"""PyTorch + CUDA port of the ``repro`` serving stack, for one NVIDIA H100.

The package mirrors ``repro``'s layout and names (``configs``, ``models``,
``kernels``, ``runtime``) so each module has an obvious counterpart, and it
imports neither ``jax`` nor ``repro``: what it needs from the reference's
framework-neutral modules is copied here.  The Pallas TPU kernels on the
ported path are hand-written Hopper kernels under ``kernels/*/csrc``, each
with a plain PyTorch version beside it.

Entry points (``Model``, ``ContinuousServeEngine``, ``ServeEngine``,
``LLMEngine``) run on ``device="cuda"`` unless the caller asks for
``device="cpu"``.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
