"""Mamba2 SSD (state-space duality) mixer: chunked prefill and the
recurrent decode step.

The PyTorch counterpart of ``repro/models/ssm.py`` (arXiv:2405.21060)::

    in_proj -> [z, x, B, C, dt]; depthwise causal conv over [x, B, C];
    SSD:  h_t = h_{t-1} * exp(dt_t * A) + dt_t * (B_t (x) x_t)
          y_t = C_t . h_t + D * x_t
    gated RMSNorm(y, z) -> out_proj.

Prefill expands the recurrence inside chunks of ``ssm_chunk`` positions
into a lower-triangular attention-like product and carries the state
across chunks; the reference's ``lax.scan`` over chunks is a Python loop
of ``S / Q`` steps here.  Decode is the exact one-token recurrence over
the carried state.  The reference computes all of it in plain ``jnp`` (no
Pallas kernel), so this module is plain torch on every device, under the
profiler range ``ssm_mixer``.

Each path keeps the reference's rounding: the prefill conv sums bf16
products in the activation dtype and adds the bias before the cast to f32,
the decode conv sums in f32; softplus is the reference's
``logaddexp(x, 0)``.  Parameters live in an ``nn.Module`` whose attribute
names are the reference pytree's keys, so the weight bridge copies them
by name.

On a training mesh (``parallel/train.py``) ``ssm_forward`` runs a rank's
heads: its config counts them, its weights hold their channels, and the
gated norm's sum of squares is all-reduced over the ranks
(``parallel.hints.split_comm``).  A serving mesh (``parallel/serve.py``)
splits the heads so in prefill and decode alike, ``out_proj``'s product is
the rank's f32 partial (``tp_row_dot``), and the B / C projection is a
column block gathered over the ranks (``col_gather``); off a mesh both
marks are the plain product.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import (
    NORM_DTYPE, PARAM_DTYPE, ModelConfig, dense_init, gated_rmsnorm, span,
)
from repro_torch.parallel.hints import col_gather, split_comm, tp_row_dot


class SSM(nn.Module):
    """The mixer's weights: the input projection as four matrices (w_z,
    w_x, w_bc, w_dt), the depthwise conv (bf16), the f32 ``A_log``, ``D``,
    ``dt_bias`` and gated-norm weight, and ``out_proj``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, di = cfg.d_model, cfg.d_inner
        h, n, g = cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_groups
        conv_dim = di + 2 * g * n

        def param(shape, dtype):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                                requires_grad=False)
        self.w_z = param((d, di), PARAM_DTYPE)
        self.w_x = param((d, di), PARAM_DTYPE)
        self.w_bc = param((d, 2 * g * n), PARAM_DTYPE)
        self.w_dt = param((d, h), PARAM_DTYPE)
        self.conv_w = param((cfg.conv_kernel, conv_dim), PARAM_DTYPE)
        self.conv_b = param((conv_dim,), PARAM_DTYPE)
        self.A_log = param((h,), NORM_DTYPE)
        self.D = param((h,), NORM_DTYPE)
        self.dt_bias = param((h,), NORM_DTYPE)
        self.norm_w = param((di,), NORM_DTYPE)
        self.out_proj = param((di, d), PARAM_DTYPE)


@torch.no_grad()
def init_ssm(p: SSM, gen: torch.Generator, cfg: ModelConfig) -> None:
    """Fill ``p`` in place with the reference's distributions (its values
    come through ``bridge.params_from_jax``)."""
    d, di = cfg.d_model, cfg.d_inner
    h, n, g = cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_groups
    p.w_z.copy_(dense_init(gen, d, di))
    p.w_x.copy_(dense_init(gen, d, di))
    p.w_bc.copy_(dense_init(gen, d, 2 * g * n))
    p.w_dt.copy_(dense_init(gen, d, h))
    p.conv_w.copy_(torch.randn(tuple(p.conv_w.shape), generator=gen,
                               device=gen.device) * 0.1)
    p.conv_b.zero_()
    p.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, h,
                                           device=p.A_log.device)))
    p.D.fill_(1.0)
    p.dt_bias.zero_()
    p.norm_w.fill_(1.0)
    p.out_proj.copy_(dense_init(gen, di, d))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0) = max(x, 0) +
    log1p(exp(-|x|))``."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _in_proj(x: torch.Tensor, p: SSM, cfg: ModelConfig):
    """The split input projections -> (z, x_in, b, c, dt)."""
    gn = cfg.ssm_groups * cfg.ssm_state
    # a serving rank computes a column block of B / C and gathers the rest
    bc = col_gather(x @ p.w_bc, "ssm_bc")
    return x @ p.w_z, x @ p.w_x, bc[..., :gn], bc[..., gn:], x @ p.w_dt


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None, valid=None):
    """Depthwise causal conv1d; x (B, S, C), w (K, C).  Returns (out,
    new_state), the state being the last K-1 inputs; with ``valid`` (B,)
    it ends at each row's valid boundary (``valid = 0`` returns the
    incoming state)."""
    k = w.shape[0]
    s = x.shape[1]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[-1]), dtype=x.dtype,
                            device=x.device)
    dt = torch.promote_types(state.dtype, x.dtype)
    xp = torch.cat([state.to(dt), x.to(dt)], dim=1)        # (B, S+K-1, C)
    wd = w.to(torch.promote_types(dt, w.dtype))
    out = 0
    for i in range(k):                 # the reference's Python sum, in order
        out = out + xp[:, i:i + s] * wd[i][None, None, :]
    out = F.silu((out + b[None, None, :]).float()).to(x.dtype)
    if k <= 1:
        return out, state
    if valid is None:
        return out, xp[:, -(k - 1):]
    idx = valid.long()[:, None] + torch.arange(k - 1, device=x.device)[None]
    new_state = torch.gather(
        xp, 1, idx[:, :, None].expand(-1, -1, xp.shape[-1]))
    return out, new_state


def _ssd_chunked(x, b, c, dt, A, cfg: ModelConfig, h0=None):
    """Chunked SSD scan.  x (B, S, H, P); b, c (B, S, G, N); dt (B, S, H);
    A (H,).  Returns (y (B, S, H, P) f32, h_final (B, H, P, N) f32)."""
    bsz, s, nh, hp = x.shape
    n = b.shape[3]
    q = min(cfg.ssm_chunk, s)
    pad = (-s) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    sp = s + pad
    nc = sp // q
    rep = nh // b.shape[2]             # heads share groups
    bh = torch.repeat_interleave(b, rep, dim=2)              # (B, S, H, N)
    ch = torch.repeat_interleave(c, rep, dim=2)
    xc = x.reshape(bsz, nc, q, nh, hp).float()
    bc_ = bh.reshape(bsz, nc, q, nh, n).float()
    cc = ch.reshape(bsz, nc, q, nh, n).float()
    dtc = dt.reshape(bsz, nc, q, nh).float()

    da = dtc * (-A)[None, None, None, :]                     # exponents <= 0
    cum = torch.cumsum(da, dim=2)                            # (B, nc, Q, H)
    # intra-chunk: y[i] = sum_{j<=i} C_i . B_j exp(cum_i - cum_j) dt_j x_j
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (B,nc,Q,Q,H)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    # mask before exp: a masked entry can be >> 0, and exp(+inf) * 0 = NaN
    seg = seg.masked_fill(~tri[None, None, :, :, None], float("-inf"))
    decay = torch.exp(seg)
    scores = torch.einsum("bnqhs,bnkhs->bnqkh", cc, bc_)
    att = scores * decay
    xdt = xc * dtc[..., None]                                # (B,nc,Q,H,P)
    y_intra = torch.einsum("bnqkh,bnkhp->bnqhp", att, xdt)

    # chunk-final states: sum_j exp(cum_Q - cum_j) dt_j B_j x_j^T
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)        # (B,nc,Q,H)
    hc = torch.einsum("bnqh,bnqhs,bnqhp->bnhps", decay_to_end, bc_, xdt)
    chunk_decay = torch.exp(cum[:, :, -1, :])                # (B, nc, H)

    h = (torch.zeros((bsz, nh, hp, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    h_enter = []
    for i in range(nc):                # the reference's scan over chunks
        h_enter.append(h)
        h = h * chunk_decay[:, i, :, None, None] + hc[:, i]
    h_enter = torch.stack(h_enter, dim=1)                    # (B,nc,H,P,N)
    y_inter = torch.einsum("bnqhs,bnqh,bnhps->bnqhp", cc, torch.exp(cum),
                           h_enter)
    y = (y_intra + y_inter).reshape(bsz, sp, nh, hp)[:, :s]
    return y, h


def ssm_forward(x: torch.Tensor, p: SSM, cfg: ModelConfig,
                state: dict | None = None, valid=None):
    """The mixer over (B, S, D).  Returns (out, new_state).  ``valid``
    (B,) masks each row's padded tail: there dt is 0 (an identity state
    update) and the conv state is taken at the valid boundary, so
    ``new_state`` is what an unpadded pass over the first ``valid`` tokens
    gives; outputs at padded positions are garbage."""
    with span("ssm_mixer"):
        bsz, s, _ = x.shape
        nh, hp = cfg.n_ssm_heads, cfg.ssm_head_dim
        n, g = cfg.ssm_state, cfg.ssm_groups
        z, xin, b, c, dt = _in_proj(x, p, cfg)
        conv_in = torch.cat([xin, b, c], dim=-1)
        conv_out, new_conv = _causal_conv(
            conv_in, p.conv_w, p.conv_b,
            None if state is None else state["conv"], valid=valid)
        di = nh * hp                   # a training rank's heads: its channels
        xh = conv_out[..., :di].reshape(bsz, s, nh, hp)
        bg = conv_out[..., di:di + g * n].reshape(bsz, s, g, n)
        cg = conv_out[..., di + g * n:].reshape(bsz, s, g, n)
        dt_sp = softplus(dt.float() + p.dt_bias[None, None, :])
        if valid is not None:
            ok = (torch.arange(s, device=x.device)[None, :]
                  < valid.long()[:, None])
            dt_sp = torch.where(ok[:, :, None], dt_sp, 0.0)
        a = torch.exp(p.A_log)
        y, h_final = _ssd_chunked(xh, bg, cg, dt_sp, a, cfg,
                                  None if state is None else state["ssm"])
        y = y + xh.float() * p.D[None, None, :, None]
        y = y.reshape(bsz, s, di).to(x.dtype)
        out = tp_row_dot(gated_rmsnorm(y, z, p.norm_w, cfg.norm_eps,
                                       comm=split_comm("ssm")), p.out_proj)
    return out, {"conv": new_conv, "ssm": h_final}


def ssm_decode_step(x: torch.Tensor, p: SSM, cfg: ModelConfig, state: dict):
    """One token a row: x (B, D); ``state`` carries conv + ssm.  Returns
    (out, new_state)."""
    with span("ssm_mixer"):
        bsz = x.shape[0]
        nh, hp = cfg.n_ssm_heads, cfg.ssm_head_dim
        n, g = cfg.ssm_state, cfg.ssm_groups
        z, xin, b, c, dt = _in_proj(x, p, cfg)
        conv_in = torch.cat([xin, b, c], dim=-1)             # (B, C)
        conv = state["conv"]
        wdt = torch.promote_types(conv.dtype, conv_in.dtype)
        window = torch.cat([conv.to(wdt), conv_in[:, None, :].to(wdt)],
                           dim=1)                            # (B, K, C)
        # the window's K taps summed in f32, then the bias, as the
        # reference's einsum "bkc,kc->bc" and add
        conv_out = ((window.float() * p.conv_w.float()).sum(1)
                    + p.conv_b.float())
        conv_out = F.silu(conv_out).to(x.dtype)
        di = nh * hp                   # a rank's heads: its channels
        xh = conv_out[:, :di].reshape(bsz, nh, hp).float()
        bg = torch.repeat_interleave(
            conv_out[:, di:di + g * n].reshape(bsz, g, n), nh // g,
            dim=1).float()
        cg = torch.repeat_interleave(
            conv_out[:, di + g * n:].reshape(bsz, g, n), nh // g,
            dim=1).float()
        dt_sp = softplus(dt.float() + p.dt_bias[None, :])   # (B, H)
        decay = torch.exp(-dt_sp * torch.exp(p.A_log)[None, :])
        # h' = h decay + dt (x (x) B)
        h_new = (state["ssm"] * decay[..., None, None]
                 + xh[..., None] * (dt_sp[..., None] * bg)[:, :, None, :])
        y = torch.matmul(h_new, cg[..., None])[..., 0]       # C . h'
        y = y + xh * p.D[None, :, None]
        y = y.reshape(bsz, di).to(x.dtype)
        out = tp_row_dot(gated_rmsnorm(y, z, p.norm_w, cfg.norm_eps,
                                       comm=split_comm("ssm")), p.out_proj)
    return out, {"conv": window[:, 1:], "ssm": h_new}


def init_ssm_state(cfg: ModelConfig, batch: int, *, device) -> dict:
    """Zero state of ``batch`` rows: the conv tail ``(B, K-1, H P + 2GN)``
    bf16 and the SSD state ``(B, H, P, N)`` f32 (H the config's heads: a
    serving rank's local config counts its own)."""
    conv_dim = (cfg.n_ssm_heads * cfg.ssm_head_dim
                + 2 * cfg.ssm_groups * cfg.ssm_state)
    return {"conv": torch.zeros((batch, cfg.conv_kernel - 1, conv_dim),
                                dtype=torch.bfloat16, device=device),
            "ssm": torch.zeros((batch, cfg.n_ssm_heads, cfg.ssm_head_dim,
                                cfg.ssm_state), dtype=torch.float32,
                               device=device)}
