"""MXFP4 weight-streaming VMM: the CUDA kernel's wrapper.

The Hopper counterpart of the Pallas kernel
``repro/kernels/mxfp4_vmm/kernel.py::mxfp4_vmm``.  The kernel itself is
``csrc/mxfp4_vmm.cu``, two schedules chosen here by M (``schedule``):

  * ``"decode"`` (M <= ``DECODE_MAX_M``, byte-bound): ``mma.sync`` with the
    weights on the A side, code tiles streamed by TMA into an mbarrier ring
    and decoded in registers;
  * ``"wgmma"`` (larger M, operation-bound): a decoder warpgroup turns each
    code tile into a bf16 tile once per CTA, two consumer warpgroups run
    ``wgmma`` on it.

Both split the (output tile, K stage) units evenly over a fixed grid
(stream-K); the last CTA of a split tile folds its pieces in CTA order,
found through a per-device integer counter array that it leaves at zero,
so one launch computes the product and the bits do not depend on the
order in which CTAs run.  One launch serves up to three weights that read
the same x (``mxfp4_vmm_group``: q/k/v, gate/up), each output in its own
tensor.  The source's header says what bounds each schedule and why it is
built so.

The library is compiled from the repo's sources by ``nvcc`` at first use
(``kernels/_build.py``) and called through ``ctypes`` on PyTorch's current
stream.  Calls on one device share its counters and workspace, so launches
on two streams of one device at once are not supported (the port issues
every launch on the current stream).  This wrapper checks every tensor
before the launch and raises on a refused launch; it never falls back to
the plain version (``ref.py``).  Each launch adds one to
``kernels.LAUNCHES["mxfp4_vmm"]`` and to
``kernels.VARIANT_LAUNCHES["mxfp4_vmm:<schedule>"]``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path
from typing import Sequence

import torch

from repro_torch.kernels import LAUNCHES, VARIANT_LAUNCHES
from repro_torch.kernels._build import build

NAME = "mxfp4_vmm"
SOURCE = Path(__file__).parent / "csrc" / "mxfp4_vmm.cu"
BLOCK_N = 128                     # kBN in the source: columns of a tile
DECODE_MAX_M = 16                 # the crossover: larger M takes "wgmma"
DECODE_STAGE_K = 128              # dec::kStageK
DECODE_CTAS_PER_SM = 2
# least units (K stages) a CTA streams: fewer CTAs for small products, so
# that a tile has few pieces to fold
MIN_UNITS = {"decode": 8, "wgmma": 16}
WGMMA_BM = 256                    # wg::kBM
WGMMA_STAGE_K = 64                # wg::kStageK
MAX_GROUP = 3                     # kMaxSeg: weights in one launch
MX_BLOCK = 32
VARIANTS = {"decode": 0, "wgmma": 1}   # codes of the C entry point
_COUNTERS: dict[int, torch.Tensor] = {}
_WORKSPACE: dict[int, torch.Tensor] = {}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build("mxfp4_vmm", [SOURCE])
    fn = lib.mxfp4_vmm
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3 + [ptrs] * 3
                   + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    lib.mxfp4_vmm_error_string.argtypes = [ctypes.c_int]
    lib.mxfp4_vmm_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _num_sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@dataclasses.dataclass(frozen=True)
class Schedule:
    """One launch's work split, as the kernel computes it: ``tiles``
    output tiles (the column stripes of every weight in order, each cut
    into ``m_tiles`` row tiles of ``bm`` rows) of ``stages`` K stages of
    ``stage_k`` rows; the units (tile, stage), tile-major, are split into
    ``grid`` contiguous ranges, one per CTA."""
    variant: str
    bm: int
    stage_k: int
    stripes: tuple[int, ...]
    m_tiles: int
    stages: int
    grid: int

    @property
    def nt(self) -> int:
        """n8 row tiles of the decode schedule, 1 or 2 (0 for wgmma)."""
        return self.bm // 8 if self.variant == "decode" else 0

    @property
    def tiles(self) -> int:
        return sum(self.stripes) * self.m_tiles

    @property
    def units(self) -> int:
        return self.tiles * self.stages

    def cta_range(self, c: int) -> tuple[int, int]:
        """CTA c's units [lo, hi) (``unit_lo`` in the source)."""
        return c * self.units // self.grid, (c + 1) * self.units // self.grid

    def cta_of(self, u: int) -> int:
        """The CTA whose range holds unit u (``cta_of`` in the source)."""
        return ((u + 1) * self.grid - 1) // self.units

    def contributors(self, tile: int) -> range:
        """The CTAs that hold a piece of ``tile``, in fold order."""
        t_lo = tile * self.stages
        return range(self.cta_of(t_lo), self.cta_of(t_lo + self.stages - 1) + 1)

    def pieces(self, c: int) -> list[tuple[int, int, int, int]]:
        """CTA c's pieces (tile, first stage, end stage, workspace slot);
        slot -1: the whole tile, written without the workspace."""
        lo, hi = self.cta_range(c)
        out, u = [], lo
        while u < hi:
            tile = u // self.stages
            t_lo, t_hi = tile * self.stages, (tile + 1) * self.stages
            end = min(hi, t_hi)
            whole = lo <= t_lo and hi >= t_hi
            out.append((tile, u - t_lo, end - t_lo,
                        -1 if whole else int(lo < t_lo)))
            u = end
        return out

    @property
    def workspace_floats(self) -> int:
        return self.grid * 2 * self.bm * BLOCK_N


def schedule(m: int, k: int, ns: Sequence[int], sms: int,
             variant: str | None = None) -> Schedule:
    """The launch's schedule for x (m, k) and weights of ``ns`` columns on
    a card of ``sms`` SMs: "decode" up to ``DECODE_MAX_M`` rows (rows in 1
    or 2 tiles of 8; ``DECODE_CTAS_PER_SM`` CTAs an SM), "wgmma" above
    (256-row tiles, one CTA an SM).  The grid is the resident CTA count,
    or fewer where a CTA would stream fewer than ``MIN_UNITS`` units (at
    least one CTA).  ``variant`` overrides
    the choice by M (for measuring the crossover; "decode" takes at most
    16 rows)."""
    variant = variant or ("decode" if m <= DECODE_MAX_M else "wgmma")
    if variant not in VARIANTS or (variant == "decode" and m > 16):
        raise ValueError(f"{NAME}: schedule {variant!r} for M={m}")
    if variant == "decode":
        stage_k, per_sm = DECODE_STAGE_K, DECODE_CTAS_PER_SM
        bm = 8 if m <= 8 else 16
        m_tiles = 1
    else:
        stage_k, per_sm = WGMMA_STAGE_K, 1
        bm, m_tiles = WGMMA_BM, -(-m // WGMMA_BM)
    stripes = tuple(-(-n // BLOCK_N) for n in ns)
    stages = -(-k // stage_k)
    units = sum(stripes) * m_tiles * stages
    return Schedule(variant, bm, stage_k, stripes, m_tiles, stages,
                    max(1, min(per_sm * sms, units // MIN_UNITS[variant])))


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"{NAME}: {msg}")


def _scratch(dev: torch.device, sched: Schedule) -> tuple[int, int]:
    """The device's tile counters (zero, left at zero by every launch) and
    f32 workspace, grown to what ``sched`` needs."""
    cnt = _COUNTERS.get(dev.index)
    if cnt is None or cnt.numel() < sched.tiles:
        cnt = torch.zeros(max(sched.tiles, 4096), dtype=torch.int32,
                          device=dev)
        _COUNTERS[dev.index] = cnt
    ws = _WORKSPACE.get(dev.index)
    if ws is None or ws.numel() < sched.workspace_floats:
        ws = torch.empty(sched.workspace_floats, dtype=torch.float32,
                         device=dev)
        _WORKSPACE[dev.index] = ws
    return cnt.data_ptr(), ws.data_ptr()


def mxfp4_vmm_group(x: torch.Tensor,
                    weights: Sequence[tuple[torch.Tensor, torch.Tensor]],
                    out_dtype: torch.dtype = torch.float32,
                    variant: str | None = None) -> list[torch.Tensor]:
    """x (M, K) bf16 @ dequant(codes_i (K/2, N_i) u8, scales_i (K/32, N_i)
    u8) for each of 1..3 weights that share K, in one launch -> one (M,
    N_i) tensor each in ``out_dtype``: the f32 sums, or (bf16) those
    rounded once to nearest even.  K must be a multiple of 32; M and N_i
    are free.  ``variant``: the schedule, by M when None (``schedule``)."""
    _check(x.is_cuda, f"x must be a CUDA tensor, got {x.device}")
    dev = x.device
    _check(1 <= len(weights) <= MAX_GROUP,
           f"{len(weights)} weights in one launch (1..{MAX_GROUP})")
    _check(x.dtype == torch.bfloat16, f"x dtype {x.dtype} (want bfloat16)")
    _check(out_dtype in (torch.float32, torch.bfloat16),
           f"out_dtype {out_dtype} (want float32 or bfloat16)")
    _check(x.ndim == 2, f"x shape {tuple(x.shape)} (want (M, K))")
    m, k = x.shape
    _check(k % MX_BLOCK == 0 and k >= MX_BLOCK,
           f"K={k} is not a positive multiple of {MX_BLOCK}")
    _check(m >= 1, f"empty product M={m}")
    ns, packed = [], []
    for codes, scales in weights:
        for name, t in (("codes", codes), ("scales", scales)):
            _check(t.device == dev, f"{name} on {t.device}, x on {dev}")
            _check(t.dtype == torch.uint8, f"{name} dtype {t.dtype} "
                   "(want uint8)")
        n = codes.shape[-1]
        _check(codes.ndim == 2 and scales.ndim == 2 and n >= 1
               and tuple(codes.shape) == (k // 2, n)
               and tuple(scales.shape) == (k // 32, n),
               f"codes {tuple(codes.shape)} / scales {tuple(scales.shape)} "
               f"do not pack a ({k}, N) weight")
        ns.append(n)
        packed.append((codes.contiguous(), scales.contiguous()))
    x = x.contiguous()
    if x.data_ptr() % 16:             # x rows stream as 16-byte copies
        x = x.clone()
    sched = schedule(m, k, ns, _num_sms(dev.index), variant)
    outs = [torch.empty((m, n), dtype=out_dtype, device=dev) for n in ns]
    counters, ws = _scratch(dev, sched)
    g = len(ns)
    arr = ctypes.c_void_p * g
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.mxfp4_vmm(
            x.data_ptr(), m, k, g, arr(*(c.data_ptr() for c, _ in packed)),
            arr(*(s.data_ptr() for _, s in packed)),
            arr(*(o.data_ptr() for o in outs)), (ctypes.c_int * g)(*ns),
            int(out_dtype == torch.bfloat16), VARIANTS[sched.variant],
            sched.nt, sched.grid, ws, counters, stream)
    if err != 0:
        msg = lib.mxfp4_vmm_error_string(err).decode()
        raise RuntimeError(f"{NAME} launch failed: {msg} (cudaError {err})")
    LAUNCHES[NAME] += 1
    VARIANT_LAUNCHES[f"{NAME}:{sched.variant}"] += 1
    return outs


def mxfp4_vmm(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x (M, K) bf16 @ dequant(codes (K/2, N) u8, scales (K/32, N) u8)
    -> (M, N) in ``out_dtype``: ``mxfp4_vmm_group`` of one weight."""
    return mxfp4_vmm_group(x, [(codes, scales)], out_dtype)[0]
