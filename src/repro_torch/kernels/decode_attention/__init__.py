"""GQA flash-decode: the paged CUDA kernel (``paged_kernel``) and the
dense-cache one (``kernel``), their plain versions (``ref``), dispatch
(``ops``)."""
