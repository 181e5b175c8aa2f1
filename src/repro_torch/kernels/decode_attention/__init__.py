"""Paged GQA flash-decode: CUDA kernel (``paged_kernel``), plain version
(``ref``), dispatch (``ops``)."""
