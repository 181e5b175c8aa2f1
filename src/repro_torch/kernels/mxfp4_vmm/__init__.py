"""MXFP4 weight-streaming VMM: CUDA kernel (``kernel``), plain version
(``ref``), dispatch (``ops``)."""
