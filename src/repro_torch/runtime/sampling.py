"""Request-level sampling for the serve path (fp32 internals).

The port of ``repro/runtime/sampling.py``: ``SamplingParams`` (the
per-request generation contract), the per-slot logit processors, the fused
per-slot sampler ``sample_slots``, the per-slot tensors the engine keeps
(``SlotSampling``), and speculative decoding's helpers: the per-slot
filtered distribution ``slot_dist``, its inverse-CDF draw ``slot_draw``
and the tagged uniforms ``spec_uniform`` of the continuous engine's
draft/verify window, and the single-distribution ``dist`` / ``draw`` of
the legacy speculative backend.  Per-slot
temperature / top-k / top-p / min-p / seed are ``(num_slots,)`` tensors, so
any mix of greedy and sampled requests shares one decode step.

Reproducibility invariant: each request draws the token at sequence index
``pos`` from its own ``fold_in(PRNGKey(seed), pos)`` stream
(``runtime/prng.py``, bit-equal to ``jax.random``).  The key is a function
of (seed, position) only — not the slot, not the step — so a
restart-style preemption re-emits the same sampled tokens, and the port's
streams match the reference's token for token.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.runtime import prng

# Static cap for the per-slot top-k threshold (one top-k of this width
# serves every per-slot k <= MAX_TOP_K as a data lookup).
MAX_TOP_K = 64

# Candidate-set width of the fused per-slot sampler: ONE top-k of this
# width supplies the greedy argmax, every per-slot top-k threshold, the
# top-p nucleus scan, and the draw candidates.  Sampling is truncated to
# the 128 most probable tokens (exact for any top-k <= MAX_TOP_K).
SLOT_CANDIDATES = 128

# Static per-slot budget for token-level logit biases.
MAX_LOGIT_BIAS = 8

# Budget of ``dist``'s top-p nucleus scan: cumulative mass over the
# descending top-``TOP_P_BUDGET`` prefix; a nucleus that spills past it
# keeps everything.
TOP_P_BUDGET = 512

# Speculative-decoding PRNG stream tags: every draw inside a draft/verify
# window folds one of these into ``token_key(seed, pos)``, where ``pos`` is
# the sequence index of the token being decided, so a preemption restart
# replays the same proposals, coin flips and correction draws.
TAG_PROPOSE, TAG_ACCEPT, TAG_CORRECT = 1, 2, 3


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request generation parameters.

    temperature  0.0 = greedy; > 0 scales logits before sampling.
    top_k        0 = disabled; else sample among the k highest logits
                 (engines cap k at their static ``max_top_k``).
    top_p        nucleus sampling: keep the smallest prefix of the sorted
                 distribution with cumulative mass >= top_p (1.0 = off).
    min_p        drop tokens below ``min_p * max_prob`` (0.0 = off).
    seed         PRNG stream id; token at position ``pos`` is drawn with
                 ``fold_in(PRNGKey(seed), pos)`` (see module docstring).
    stop_token_ids  generation finishes ("stop") when one is emitted.
    max_tokens   generation budget; finishes with reason "length".
                 None defers to the caller's ``max_new_tokens``.
    logprobs     return the chosen token's logprob under the final
                 (filtered, temperature-scaled) distribution.
    repetition_penalty  CTRL-style: logits of tokens already present in
                 the request's stream (prompt + generated) are divided by
                 the penalty when positive, multiplied when negative
                 (1.0 = off).  Applied before temperature.
    logit_bias   additive per-token logit offsets, as a ``{token_id:
                 bias}`` mapping or ``((token_id, bias), ...)`` pairs; at
                 most ``MAX_LOGIT_BIAS`` entries per request.
    prompt_logprobs  score the prompt too (the port's engine does not yet:
                 it raises for such requests).
    """
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0
    seed: int = 0
    stop_token_ids: tuple[int, ...] = ()
    max_tokens: int | None = None
    logprobs: bool = False
    repetition_penalty: float = 1.0
    logit_bias: tuple[tuple[int, float], ...] = ()
    prompt_logprobs: bool = False

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if not 0.0 <= self.min_p < 1.0:
            raise ValueError(f"min_p must be in [0, 1), got {self.min_p}")
        if not 0 <= self.seed < 2 ** 31:   # lives in int32 slot tensors
            raise ValueError(f"seed must be in [0, 2^31), got {self.seed}")
        if self.max_tokens is not None and self.max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {self.max_tokens}")
        if self.repetition_penalty <= 0.0:
            raise ValueError(f"repetition_penalty must be > 0, got "
                             f"{self.repetition_penalty}")
        object.__setattr__(self, "stop_token_ids",
                           tuple(int(t) for t in self.stop_token_ids))
        bias = self.logit_bias
        if isinstance(bias, dict):
            bias = tuple(bias.items())
        bias = tuple((int(t), float(v)) for t, v in bias)
        if len(bias) > MAX_LOGIT_BIAS:
            raise ValueError(f"logit_bias holds {len(bias)} entries; the "
                             f"static per-slot budget is {MAX_LOGIT_BIAS}")
        if any(t < 0 for t, _ in bias):
            raise ValueError("logit_bias token ids must be >= 0")
        object.__setattr__(self, "logit_bias", bias)

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0


GREEDY = SamplingParams()


def apply_processors(logits: torch.Tensor, rep_penalty=None, bias_ids=None,
                     bias_vals=None, presence=None) -> torch.Tensor:
    """Per-slot logit processors: logits (B, V) -> f32 (B, V) with additive
    ``logit_bias`` offsets and the CTRL-style repetition penalty applied
    (positive logits of tokens marked in ``presence`` divide by the
    penalty, negative multiply)."""
    lg = logits.float()
    if bias_ids is not None:
        rows = torch.arange(lg.shape[0], device=lg.device)[:, None]
        okb = bias_ids >= 0
        bias = torch.zeros_like(lg).index_put_(
            (rows.expand_as(bias_ids), torch.where(okb, bias_ids, 0).long()),
            torch.where(okb, bias_vals, 0.0), accumulate=True)
        lg = lg + bias
    if presence is not None:
        pen = rep_penalty[:, None]
        lg = torch.where(presence, torch.where(lg > 0, lg / pen, lg * pen), lg)
    return lg


def _topp_threshold(probs: torch.Tensor, top_p,
                    budget: int = TOP_P_BUDGET) -> torch.Tensor:
    """Smallest kept probability of the top-p nucleus, per row: an entry is
    in the nucleus iff the mass of strictly larger entries is < top_p.  The
    scan runs over the descending top-``budget`` prefix; a nucleus that
    spills past it keeps everything (threshold 0)."""
    v = probs.shape[-1]
    budget = min(budget, v)
    tops = torch.topk(probs, budget, dim=-1).values       # descending
    cum = torch.cumsum(tops, dim=-1)
    top_p = torch.as_tensor(top_p, dtype=probs.dtype, device=probs.device)
    keep = (cum - tops) < top_p[..., None]
    thresh = torch.where(keep, tops, torch.inf).amin(dim=-1)
    if budget == v:
        return thresh
    return torch.where(cum[..., -1] < top_p, 0.0, thresh)


def dist(logits: torch.Tensor, params: SamplingParams) -> torch.Tensor:
    """The full filtered distribution one request samples from: (..., V)
    probabilities.  Greedy requests get an exact one-hot at the argmax, so
    draft/target acceptance ratios are defined at temperature 0; a draft
    proposal must be drawn from this same distribution (``draw``)."""
    lg = logits.float()
    v = lg.shape[-1]
    if params.is_greedy:
        return torch.nn.functional.one_hot(lg.argmax(-1), v).float()
    lg = lg / params.temperature
    if params.top_k:
        kth = torch.topk(lg, min(params.top_k, v), dim=-1).values[..., -1:]
        lg = torch.where(lg < kth, -torch.inf, lg)
    p = torch.softmax(lg, dim=-1)
    if params.top_p < 1.0 or params.min_p > 0.0:
        keep = p >= _topp_threshold(p, params.top_p)[..., None]
        if params.min_p > 0.0:
            keep = keep & (p >= params.min_p * p.amax(-1, keepdim=True))
        p = torch.where(keep, p, 0.0)
        p = p / p.sum(-1, keepdim=True)
    return p


def draw(key: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """Token ids drawn from an explicit distribution (..., V) -> (...)
    int32 with one ``prng`` key: the Gumbel-max draw of
    ``jax.random.categorical`` over log(max(p, 1e-20))."""
    return prng.categorical(key, torch.log(torch.clamp_min(probs, 1e-20))
                            ).to(torch.int32)


def _stable_top(lg: torch.Tensor, k: int):
    """The top ``k`` values of each row, descending, and their indices,
    with equal values in index order (lower index first, as
    ``jax.lax.top_k``; ``torch.topk`` leaves the order of ties open)."""
    vals, idx = torch.sort(lg, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def slot_dist(lg: torch.Tensor, temperature, top_k, top_p, min_p, *,
              max_top_k: int = MAX_TOP_K) -> torch.Tensor:
    """The full per-slot filtered distribution ``sample_slots`` draws from.

    lg: (B, V) processed logits (``apply_processors`` applied);
    temperature/top_p/min_p (B,) f32, top_k (B,) int.  Returns (B, V)
    probabilities: greedy rows are exact one-hots at the argmax; sampled
    rows carry ``sample_slots``'s candidate-subspace distribution (per-slot
    top-k rank cut, top-p nucleus, min-p, renormalized over the
    ``SLOT_CANDIDATES`` subspace), scattered back to token ids.  The
    speculative window draws proposals from it and scores them with it."""
    b, v = lg.shape
    is_greedy = temperature <= 0.0
    kmax = min(int(max_top_k), v)
    budget = min(max(kmax, SLOT_CANDIDATES), v)
    tops, idxs = _stable_top(lg, budget)
    s = tops / torch.where(is_greedy, 1.0, temperature)[:, None]
    k = torch.clamp(top_k, 0, kmax)
    ranks = torch.arange(budget, device=lg.device)[None, :]
    keep = (k == 0)[:, None] | (ranks < k[:, None])
    z = torch.logsumexp(torch.where(keep, s, -torch.inf), dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - z), 0.0)
    cum = torch.cumsum(p, dim=-1)
    keep = keep & ((cum - p) < top_p[:, None])
    keep = keep & (p >= min_p[:, None] * p[:, :1])
    w = torch.where(keep, p, 0.0)
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-38)
    out = torch.zeros((b, v), dtype=torch.float32, device=lg.device)
    out.scatter_(1, idxs, w)
    one_hot = torch.nn.functional.one_hot(lg.argmax(-1), v).float()
    return torch.where(is_greedy[:, None], one_hot, out)


def slot_draw(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Invert per-slot uniforms through a distribution's CDF: probs (B, V),
    u (B,) in [0, 1) -> (B,) int32 token ids.  One-hot rows return their
    argmax for every u."""
    cum = torch.cumsum(probs, dim=-1)
    total = cum[:, -1]
    r = torch.sum(cum <= (u * total)[:, None], dim=-1)
    return torch.clamp_max(r, probs.shape[-1] - 1).to(torch.int32)


def spec_uniform(seed, pos, tag: int) -> torch.Tensor:
    """One uniform per (seed, pos) pair from the tagged speculative stream
    ``fold_in(token_key(seed, pos), tag)`` (``TAG_PROPOSE``/``ACCEPT``/
    ``CORRECT``); ``seed`` and ``pos`` broadcast against each other."""
    dev = next((t.device for t in (seed, pos) if torch.is_tensor(t)), None)
    seed, pos = torch.broadcast_tensors(torch.as_tensor(seed, device=dev),
                                        torch.as_tensor(pos, device=dev))
    key = prng.fold_in(prng.token_key(seed, pos),
                       torch.full_like(seed, tag, dtype=torch.int64))
    return prng.uniform(key)


def sample_slots(logits: torch.Tensor, temperature, top_k, top_p, min_p,
                 seed, pos, *, max_top_k: int = MAX_TOP_K,
                 rep_penalty=None, bias_ids=None, bias_vals=None,
                 presence=None):
    """Batched per-slot sampler.

    logits: (B, V).  temperature/top_p/min_p: (B,) f32; top_k/seed/pos:
    (B,) int (``pos`` broadcastable).  Slots with temperature <= 0 take the
    argmax; every other slot draws from its filtered, temperature-scaled
    distribution with one uniform from ``token_key(seed, pos)``, inverted
    through the filtered CDF over the ``SLOT_CANDIDATES`` subspace.

    Returns (tokens (B,) int32, logprobs (B,) f32) — the chosen token's
    logprob under the distribution it was drawn from (raw softmax for
    greedy slots)."""
    lg = apply_processors(logits, rep_penalty, bias_ids, bias_vals, presence)
    b, v = lg.shape
    dev = lg.device
    rows = torch.arange(b, device=dev)
    pos = torch.broadcast_to(torch.as_tensor(pos, device=dev), (b,))
    is_greedy = temperature <= 0.0
    kmax = min(int(max_top_k), v)
    budget = min(max(kmax, SLOT_CANDIDATES), v)
    tops = torch.topk(lg, budget, dim=-1).values           # (B, budget) desc
    s = tops / torch.where(is_greedy, 1.0, temperature)[:, None]
    # per-slot top-k is a rank cut in the descending subspace (k == 0
    # disables); top-p / min-p act on the post-top-k renormalized
    # distribution
    k = torch.clamp(top_k, 0, kmax)
    ranks = torch.arange(budget, device=dev)[None, :]
    keep = (k == 0)[:, None] | (ranks < k[:, None])
    z = torch.logsumexp(torch.where(keep, s, -torch.inf), dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - z), 0.0)
    cum = torch.cumsum(p, dim=-1)
    keep = keep & ((cum - p) < top_p[:, None])             # rank 0 always in
    keep = keep & (p >= min_p[:, None] * p[:, :1])
    w = torch.where(keep, p, 0.0)
    # inverse-CDF draw: one uniform per slot from its fold_in(seed, pos)
    wcum = torch.cumsum(w, dim=-1)
    total = wcum[:, -1]
    u = prng.uniform(prng.token_key(seed, pos))
    r = torch.sum(wcum <= (u * total)[:, None], dim=-1)
    r = torch.clamp_max(r, budget - 1)
    # recover the token id by matching the drawn rank's VALUE back into the
    # logits row; exact-equal logits collapse to the lowest index
    chosen = torch.gather(tops, 1, r[:, None])
    sampled = torch.argmax((lg == chosen).to(torch.uint8), dim=-1)
    tok = torch.where(is_greedy, torch.argmax(lg, dim=-1), sampled)
    lp_greedy = tops[:, 0] - torch.logsumexp(lg, dim=-1)
    lp_sampled = (torch.log(torch.clamp_min(w[rows, r], 1e-38))
                  - torch.log(total))
    return tok.to(torch.int32), torch.where(is_greedy, lp_greedy, lp_sampled)


def stack_params(ps, n: int | None = None):
    """Stack per-request ``SamplingParams`` into per-row numpy arrays:
    (temperature, top_k, top_p, min_p, seed) of shape (n,); rows past
    ``len(ps)`` are greedy padding."""
    n = len(ps) if n is None else n
    temp = np.zeros((n,), np.float32)
    topk = np.zeros((n,), np.int32)
    topp = np.ones((n,), np.float32)
    minp = np.zeros((n,), np.float32)
    seed = np.zeros((n,), np.int32)
    for i, sp in enumerate(ps):
        temp[i] = sp.temperature
        topk[i] = sp.top_k
        topp[i] = sp.top_p
        minp[i] = sp.min_p
        seed[i] = sp.seed
    return temp, topk, topp, minp, seed


def stack_extras(ps, n: int | None = None):
    """Stack the per-request logit processors into per-row numpy arrays:
    (rep_penalty (n,) f32, bias_ids (n, MAX_LOGIT_BIAS) i32, bias_vals
    (n, MAX_LOGIT_BIAS) f32).  Padding rows are exact no-ops."""
    n = len(ps) if n is None else n
    rep = np.ones((n,), np.float32)
    bias_ids = np.full((n, MAX_LOGIT_BIAS), -1, np.int32)
    bias_vals = np.zeros((n, MAX_LOGIT_BIAS), np.float32)
    for i, sp in enumerate(ps):
        rep[i] = sp.repetition_penalty
        for j, (t, val) in enumerate(sp.logit_bias):
            bias_ids[i, j] = t
            bias_vals[i, j] = val
    return rep, bias_ids, bias_vals


class SlotSampling:
    """Per-slot sampling tensors living alongside the page table.

    Set on admission, cleared on eviction/finish; freed slots fall back to
    greedy so their (scratch-routed) rows stay harmless.  ``arrays()`` hands
    the device copies to the decode step; they are re-uploaded only after a
    slot changed."""

    def __init__(self, num_slots: int, device: torch.device):
        (self.temperature, self.top_k, self.top_p, self.min_p,
         self.seed) = stack_params([], num_slots)
        (self.rep_penalty, self.bias_ids,
         self.bias_vals) = stack_extras([], num_slots)
        self.device = device
        self._device_arrays = None

    def set(self, slot: int, sp: SamplingParams) -> None:
        self.temperature[slot] = sp.temperature
        self.top_k[slot] = sp.top_k
        self.top_p[slot] = sp.top_p
        self.min_p[slot] = sp.min_p
        self.seed[slot] = sp.seed
        self.rep_penalty[slot] = sp.repetition_penalty
        self.bias_ids[slot] = -1
        self.bias_vals[slot] = 0.0
        for j, (t, val) in enumerate(sp.logit_bias):
            self.bias_ids[slot, j] = t
            self.bias_vals[slot, j] = val
        self._device_arrays = None

    def clear(self, slot: int) -> None:
        self.set(slot, GREEDY)

    def arrays(self):
        if self._device_arrays is None:
            self._device_arrays = tuple(
                torch.as_tensor(a, device=self.device) for a in (
                    self.temperature, self.top_k, self.top_p, self.min_p,
                    self.seed, self.rep_penalty, self.bias_ids,
                    self.bias_vals))
        return self._device_arrays
