"""Quantized execution of the port: block-quantized weight formats
(``formats``), fp8/int8 paged-KV codes with per-token scales (``kv``), and
model quantization plus the quantized matmul ``qdot`` (``linear``)."""
