"""Flash-attention forward: CUDA kernel (``kernel``), plain version
(``ref``), GQA dispatch (``ops``)."""
