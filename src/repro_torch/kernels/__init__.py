"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version:

   decode_attention — paged single-token GQA flash-decode (CUDA C++,
                      ``csrc/paged_decode.cu``), replacing the Pallas
                      ``repro/kernels/decode_attention/paged_kernel.py``

Every wrapper adds one to ``LAUNCHES[<kernel name>]`` where it launches its
kernel and nowhere else, so a run can show that its path went through the
kernel (``chip_smoke.py`` clears the counts before the serve phase).
"""
from collections import Counter

LAUNCHES: Counter = Counter()
