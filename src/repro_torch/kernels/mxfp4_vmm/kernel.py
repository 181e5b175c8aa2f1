"""MXFP4 weight-streaming VMM: the CUDA kernel's wrapper.

The Hopper counterpart of the Pallas kernel
``repro/kernels/mxfp4_vmm/kernel.py::mxfp4_vmm``.  The kernel itself is
``csrc/mxfp4_vmm.cu``: CTAs own 128-column output stripes (and a split of
K when the stripes alone would not fill the card), stream code bytes,
scales and x rows through a cp.async ring in shared memory, and decode the
codes straight into bf16 ``mma.sync`` fragments.  The source's header says
what bounds it and why it is built so.

The library is compiled from the repo's sources by ``nvcc`` at first use
(``kernels/_build.py``) and called through ``ctypes`` on PyTorch's current
stream.  This wrapper checks every tensor before the launch and raises on
a refused launch; it never falls back to the plain version (``ref.py``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels._build import build

NAME = "mxfp4_vmm"
SOURCE = Path(__file__).parent / "csrc" / "mxfp4_vmm.cu"
BLOCK_N = 128                     # kBN in the source
STAGE_K = 32                      # kKT in the source (one MX block)
MIN_STAGES_PER_SPLIT = 8
CTAS_PER_SM = 4


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build("mxfp4_vmm", [SOURCE])
    fn = lib.mxfp4_vmm
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.mxfp4_vmm_error_string.argtypes = [ctypes.c_int]
    lib.mxfp4_vmm_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _num_sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def split_k(m: int, k: int, n: int, sms: int) -> tuple[int, int]:
    """(splits, stages per split): split K when the output tiles alone
    would leave fewer than ``CTAS_PER_SM`` CTAs per SM (the decode-time
    kernel hides its load latency with warps, not with a deep per-warp
    pipeline), keeping at least ``MIN_STAGES_PER_SPLIT`` 32-row stages in
    each split.  The f32 partials are small and stay in L2 for the
    reduction."""
    bm = 16 if m <= 16 else 32 if m <= 32 else 64
    tiles = -(-n // BLOCK_N) * -(-m // bm)
    stages = k // STAGE_K
    want = max(1, min(-(-CTAS_PER_SM * sms // tiles),
                      stages // MIN_STAGES_PER_SPLIT))
    per = -(-stages // want)
    return -(-stages // per), per


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"{NAME}: {msg}")


def mxfp4_vmm(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x (M, K) bf16 @ dequant(codes (K/2, N) u8, scales (K/32, N) u8)
    -> (M, N) in ``out_dtype``: the f32 sums, or (bf16) those rounded once
    to nearest even.  K must be a multiple of 32; M and N are free."""
    _check(x.is_cuda, f"x must be a CUDA tensor, got {x.device}")
    dev = x.device
    for name, t in (("codes", codes), ("scales", scales)):
        _check(t.device == dev, f"{name} on {t.device}, x on {dev}")
        _check(t.dtype == torch.uint8, f"{name} dtype {t.dtype} (want uint8)")
    _check(x.dtype == torch.bfloat16, f"x dtype {x.dtype} (want bfloat16)")
    _check(out_dtype in (torch.float32, torch.bfloat16),
           f"out_dtype {out_dtype} (want float32 or bfloat16)")
    _check(x.ndim == 2 and codes.ndim == 2 and scales.ndim == 2,
           f"shapes x {tuple(x.shape)}, codes {tuple(codes.shape)}, "
           f"scales {tuple(scales.shape)}")
    m, k = x.shape
    n = codes.shape[1]
    _check(k % STAGE_K == 0 and k >= STAGE_K, f"K={k} is not a positive "
           f"multiple of {STAGE_K}")
    _check(m >= 1 and n >= 1, f"empty product M={m}, N={n}")
    _check(tuple(codes.shape) == (k // 2, n)
           and tuple(scales.shape) == (k // 32, n),
           f"codes {tuple(codes.shape)} / scales {tuple(scales.shape)} do "
           f"not pack a ({k}, {n}) weight")
    x = x.contiguous()
    codes, scales = codes.contiguous(), scales.contiguous()
    if x.data_ptr() % 16:             # the x rows stream as 16-byte copies
        x = x.clone()
    vec = int(n % 16 == 0 and codes.data_ptr() % 16 == 0
              and scales.data_ptr() % 16 == 0)
    splits, per = split_k(m, k, n, _num_sms(dev.index))
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=dev)
          if splits > 1 else out)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.mxfp4_vmm(x.data_ptr(), codes.data_ptr(), scales.data_ptr(),
                            out.data_ptr(), ws.data_ptr(), m, k, n, splits,
                            per, vec, int(out_dtype == torch.bfloat16),
                            stream)
    if err != 0:
        msg = lib.mxfp4_vmm_error_string(err).decode()
        raise RuntimeError(f"{NAME} launch failed: {msg} (cudaError {err})")
    LAUNCHES[NAME] += 1
    return out
