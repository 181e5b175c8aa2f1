"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version:

   decode_attention — paged single-token GQA flash-decode over dense or
                      fp8/int8 code pools (CUDA C++,
                      ``csrc/paged_decode.cu``), replacing the Pallas
                      ``repro/kernels/decode_attention/paged_kernel.py``
                      (its online accumulator); its exact accumulator,
                      multi-query, which carries the speculative verify
                      step (``csrc/paged_exact.cu``, replacing the same
                      file's ``_exact_kernel``); and the dense-cache
                      flash-decode of the static
                      engine (``csrc/dense_decode.cu``), replacing
                      ``repro/kernels/decode_attention/kernel.py``
   flash_attention  — GQA flash-attention forward of the static prefill
                      and prompt scoring (CUDA C++,
                      ``csrc/flash_attention.cu``), replacing
                      ``repro/kernels/flash_attention/kernel.py``
   mxfp4_vmm        — MXFP4 weight-streaming matmul, one launch for up
                      to three weights that read the same x (CUDA C++,
                      ``csrc/mxfp4_vmm.cu``), replacing the Pallas
                      ``repro/kernels/mxfp4_vmm/kernel.py``

Every wrapper adds one to ``LAUNCHES[<kernel name>]`` where it launches its
kernel and nowhere else (the paged decode kernel counts its launches on
code pools as ``paged_decode_attention_scaled``, the exact one as
``paged_decode_attention_exact``; the dense one counts as
``decode_attention``), so a run can show that its
path went through the kernel (``chip_smoke.py`` clears the counts before
each serve phase).  The paged decode kernels also add one to
``VARIANT_LAUNCHES["<kernel name>:<variant>"]`` ("tensor_core" or
"cuda_core"), and the MXFP4 kernel to ``VARIANT_LAUNCHES["mxfp4_vmm:<schedule>"]``
("decode" or "wgmma"), so a run can show which of a source's kernels
served it.
"""
from collections import Counter

LAUNCHES: Counter = Counter()
VARIANT_LAUNCHES: Counter = Counter()
