"""GQA flash-decode: the paged CUDA kernels (``paged_kernel``: online and
exact accumulators, the exact one also multi-query) and the dense-cache
one (``kernel``), their plain versions (``ref``), dispatch (``ops``)."""
