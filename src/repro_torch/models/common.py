"""Shared model substrate: config, initializers, norms, RoPE, attention.

The PyTorch counterpart of ``repro/models/common.py``.  Weights keep the
reference's ``(d_in, d_out)`` layout (``x @ w``) and dtypes (bf16
projections, f32 norm weights), and every function keeps its numerics:
f32 internals for norms, RoPE angles and softmax state, cast back to the
activation dtype at the same points.

``blocked_attention`` is plain torch ops here, as it is plain ``lax`` in
the reference (it is not a Pallas kernel): the flash-style online softmax
over KV blocks, so chunked prefill never builds an (Sq x Skv) score matrix.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.quant.linear import qdot, qdot_group

# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"          # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 2
    head_dim: int = 0              # 0 -> d_model // n_heads
    d_ff: int = 512
    vocab_size: int = 512

    # attention options
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: int | None = None   # SWA window (tokens)
    global_attn_every: int = 0          # hybrid SWA/global interleave (0=never)
    rope_theta: float = 10000.0
    causal: bool = True                 # False => encoder-only

    # MLA (DeepSeek)
    mla: bool = False
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    v_head_dim: int = 0                 # 0 -> head_dim

    # MoE
    moe: bool = False
    n_experts: int = 0
    n_experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    moe_layer_period: int = 1           # 1 = every layer is MoE

    # SSM (Mamba2 SSD)
    ssm: bool = False
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_kernel: int = 4
    hybrid: bool = False                # Hymba: parallel attn + ssm heads

    # modality frontends (stubs; embeddings come via input_specs)
    frontend: str | None = None         # "audio" | "vision"
    n_frontend_tokens: int = 0          # e.g. image tokens prepended

    tie_embeddings: bool = False
    norm_eps: float = 1e-5

    # Vocab padding (Megatron-style): embedding/head tables are padded to a
    # multiple; padded logit columns are masked to -inf in the head.
    vocab_pad_multiple: int = 1

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab_size // m) * m

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def v_hd(self) -> int:
        return self.v_head_dim or self.hd


PARAM_DTYPE = torch.bfloat16
NORM_DTYPE = torch.float32

# ---------------------------------------------------------------------------
# Initializers (explicit generators: weights are a function of the seed)
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=PARAM_DTYPE) -> torch.Tensor:
    scale = 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=PARAM_DTYPE) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms & activations (fp32 internals)
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * w.float()
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """SwiGLU MLP; each weight may be packed (``quant.linear.qdot``; gate
    and up read x together through ``qdot_group``)."""
    g, u = qdot_group(x, (w_gate, w_up))
    return qdot(F.silu(g.float()).to(x.dtype) * u, w_down)


# ---------------------------------------------------------------------------
# RoPE (split-half convention, f32 angles)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim / 2,) f32 inverse frequencies, computed once per
    (head_dim, theta, device) on the CPU and kept: building ``theta`` as a
    tensor on a CUDA device copies it from host memory, which waits for
    every queued kernel, and RoPE runs twice per layer per step.  Callers
    must not write to the result."""
    return _rope_freqs(int(head_dim), float(theta),
                       torch.device("cpu" if device is None else device))


@functools.lru_cache(maxsize=None)
def _rope_freqs(head_dim: int, theta: float,
                device: torch.device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32), exps)
    return freqs.to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D) split-half convention; positions: (B, S) or (S,)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # (D/2,)
    ang = positions[..., None].float() * freqs             # (B, S, D/2)
    cos = torch.cos(ang)[..., None, :]                     # (B, S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Blocked (flash-style) attention — plain torch ops
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def _gqa_expand(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, KVH, D) -> (B, S, H, D) by repeating groups."""
    rep = n_heads // k.shape[2]
    if rep == 1:
        return k
    return torch.repeat_interleave(k, rep, dim=2)


def blocked_attention(
    q: torch.Tensor,             # (B, Sq, H, D)
    k: torch.Tensor,             # (B, Skv, KVH, D)
    v: torch.Tensor,             # (B, Skv, KVH, Dv)
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int | torch.Tensor = 0,
    q_block: int = 512,
    kv_block: int = 512,
    scale: float | None = None,
) -> torch.Tensor:
    """Online-softmax attention over KV blocks; never builds (Sq x Skv).

    ``q_offset`` is the absolute position of q[:, 0]: an int, or a ``(B,)``
    tensor for ragged continuation (chunked paged prefill, where every slot
    resumes at its own position).  fp32 softmax state; returns q.dtype.
    """
    b, sq, h, d = q.shape
    skv, dv = v.shape[1], v.shape[3]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    dev = q.device

    qb = min(q_block, sq)
    kb = min(kv_block, skv)
    sq_p = -(-sq // qb) * qb
    skv_p = -(-skv // kb) * kb
    if sq_p != sq:
        q = F.pad(q, (0, 0, 0, 0, 0, sq_p - sq))
    if skv_p != skv:
        k = F.pad(k, (0, 0, 0, 0, 0, skv_p - skv))
        v = F.pad(v, (0, 0, 0, 0, 0, skv_p - skv))

    kf = _gqa_expand(k, h).float()
    vf = _gqa_expand(v, h).float()
    qf = q.float()

    ar_q = torch.arange(sq_p, device=dev)
    if torch.is_tensor(q_offset) and q_offset.ndim == 1:
        q_pos = q_offset.to(dev, torch.int64)[:, None] + ar_q[None]  # (B, Sq)
    else:
        q_pos = (int(q_offset) + ar_q)[None]                          # (1, Sq)
    k_pos = torch.arange(skv_p, device=dev)
    kv_valid = k_pos < skv

    outs = []
    for q0 in range(0, sq_p, qb):
        q_blk = qf[:, q0:q0 + qb]                          # (B, qb, H, D)
        qp = q_pos[:, q0:q0 + qb]                          # (B|1, qb)
        m = torch.full((b, h, qb), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, qb), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, qb, dv), dtype=torch.float32, device=dev)
        for k0 in range(0, skv_p, kb):
            kp = k_pos[k0:k0 + kb]
            s = torch.einsum("bqhd,bkhd->bhqk", q_blk, kf[:, k0:k0 + kb]) * scale
            mask = kv_valid[k0:k0 + kb][None, None, :]     # (1, 1, kb)
            if causal:
                mask = mask & (kp[None, None, :] <= qp[:, :, None])
            if window is not None:
                mask = mask & (qp[:, :, None] - kp[None, None, :] < window)
            s = torch.where(mask[:, None], s, NEG_INF)     # (B, H, qb, kb)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p, vf[:, k0:k0 + kb])
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-30)
        outs.append(out.transpose(1, 2))                   # (B, qb, H, Dv)
    out = torch.cat(outs, dim=1)[:, :sq]
    return out.to(q.dtype)


def cache_update_at(cache_arr: torch.Tensor, new: torch.Tensor,
                    slot: int) -> torch.Tensor:
    """Write one token's entry at position ``slot`` along axis 1, in place,
    and return the cache.

    ``new``: (B, 1, ...) matching ``cache_arr`` (B, S, ...).  The reference
    writes through an elementwise select over the whole cache, which only
    GSPMD's sharded caches need; a preallocated torch cache takes the one
    indexed write."""
    cache_arr[:, slot] = new[:, 0].to(cache_arr.dtype)
    return cache_arr


def decode_attention_ref(
    q: torch.Tensor,             # (B, H, D) — one new token per sequence
    k_cache: torch.Tensor,       # (B, S, KVH, D)
    v_cache: torch.Tensor,       # (B, S, KVH, Dv)
    cur_len: torch.Tensor | None = None,   # (B,) — #valid positions
    *,
    valid: torch.Tensor | None = None,     # (S,) or (B, S) bool mask
    scale: float | None = None,
) -> torch.Tensor:
    """Single-token decode attention (the plain version of the decode
    kernels).  Pass either ``cur_len`` (prefix-valid cache) or an explicit
    ``valid`` mask."""
    b, h, d = q.shape
    kvh = k_cache.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    rep = h // kvh
    qf = q.float().reshape(b, kvh, rep, d)
    kf = k_cache.float()
    vf = v_cache.float()
    s = torch.einsum("bgrd,bsgd->bgrs", qf, kf) * scale
    if valid is None:
        valid = (torch.arange(k_cache.shape[1], device=q.device)[None, :]
                 < cur_len[:, None])
    if valid.ndim == 1:
        valid = valid[None, :]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrs,bsgd->bgrd", p, vf)
    return out.reshape(b, h, vf.shape[-1]).to(q.dtype)
