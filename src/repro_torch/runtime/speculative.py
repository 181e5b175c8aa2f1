"""Speculative decoding: the draft/target window and the legacy engine.

The port of ``repro/runtime/speculative.py``.  A draft model proposes a
window of ``gamma`` tokens; the target scores them; token i is accepted
with probability min(1, p_t(x_i) / p_d(x_i)); at the first rejection the
correction is drawn from max(p_t - p_d, 0) normalized, and on a full
accept the bonus token from the target's distribution at the extra
position (the stochastic acceptance rule of Leviathan et al.).  Greedy
requests score exact one-hots on both sides, so greedy speculation emits
the target's own stream.

Two users:

  * ``SpeculativeConfig`` configures the continuous engine's
    scheduler-integrated speculation (``ContinuousServeEngine(
    speculative=...)``, ``LLMEngine(..., speculative=...)``): the draft's
    KV pages share the target's page-id space, and each window is gamma
    draft decode steps plus one multi-token verify step.
  * ``SpeculativeEngine`` is the legacy ``LLMEngine(backend=
    "speculative")``: batch 1 over the dense caches of the static path.
    Its window is a Python loop over ``Model.decode_step`` (the reference
    scans); on CUDA every draft and target step runs the dense decode
    kernel and both prompt prefills the flash-attention kernel.  The
    window's randomness follows the reference's keys (``prng.split``,
    ``fold_in``, ``categorical``), so streams match it token for token.

Rejected positions need no cache rollback: their entries sit past the new
position and are masked, then overwritten, by the next window.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.model import Model
from repro_torch.runtime import prng, sampling
from repro_torch.runtime.sampling import SamplingParams


def _check_rewindable(model: Model) -> None:
    if model.cfg.family in ("ssm", "hybrid"):
        raise ValueError("speculative decoding requires rewindable caches; "
                         f"{model.cfg.name} carries SSM state")


@dataclasses.dataclass(frozen=True)
class SpeculativeConfig:
    """Scheduler-integrated speculation for the continuous engine.

    draft_model: the proposer, a ``Model`` holding its own weights on the
    target's device and sharing its vocabulary.  Its KV pages come out of
    the same page-id space as the target's — a second set of pool leaves
    over identical page tables — so prefix sharing, copy-on-write,
    preemption and defrag act on both in lockstep.  ``None`` self-drafts
    with the target (acceptance is then ~gamma a window).

    gamma: draft lookahead per window; each window costs gamma draft steps
    + one backfill step + one multi-token verify step and emits
    1..gamma+1 tokens."""
    draft_model: Model | None = None
    gamma: int = 4

    def __post_init__(self):
        if self.gamma < 1:
            raise ValueError(f"gamma must be >= 1, got {self.gamma}")
        if self.draft_model is not None:
            _check_rewindable(self.draft_model)


@dataclasses.dataclass
class SpecStats:
    tokens: torch.Tensor              # (n,) generated tokens
    accepted_per_window: torch.Tensor
    # each window runs gamma + 1 draft decode steps (the backfill
    # included) and gamma + 1 target decode steps
    windows: int

    @property
    def mean_accepted(self) -> float:
        return float(self.accepted_per_window.mean())


def make_speculative_window(draft: Model, target: Model, *, gamma: int = 8,
                            temperature: float = 1.0,
                            sampling_params: SamplingParams | None = None):
    """The draft-propose / target-verify window (batch 1).

    window(last_token (1,), dcache, tcache, pos, key) -> (tokens (gamma+1,),
    n_emitted ()) — both on the model's device; entries past n_emitted are
    padding.  ``pos`` (an int) is the position of ``last_token``; the
    caches are written in place."""
    sp = (sampling_params if sampling_params is not None
          else SamplingParams(temperature=temperature))

    def window(last_token, dcache, tcache, pos: int, key):
        kd, kr = prng.split(key, 2)
        # the draft proposes gamma tokens, each drawn from the same filtered
        # distribution recorded as q
        tok, props, q_dist = last_token, [], []
        for j, k in enumerate(prng.split(kd, gamma)):
            logits = draft.decode_step(tok, dcache, pos + j)
            dist = sampling.dist(logits, sp)[0]                  # (V,)
            tok = sampling.draw(k, dist[None])
            props.append(tok)
            q_dist.append(dist)
        # backfill the draft cache for the last proposal (position pos +
        # gamma): on a full accept the next window's draft must see it
        draft.decode_step(tok, dcache, pos + gamma)
        prop = torch.cat(props)                                  # (gamma,)
        q_dist = torch.stack(q_dist)                             # (gamma, V)

        # the target scores every proposal plus the bonus position: input
        # i consumes token i - 1, so p_dist[i] is its distribution for
        # window position i
        t_inputs = torch.cat([last_token, prop])
        p_dist = torch.stack([
            sampling.dist(target.decode_step(t_inputs[i:i + 1], tcache,
                                             pos + i), sp)[0]
            for i in range(gamma + 1)])

        idx = torch.arange(gamma, device=prop.device)
        p_prop = p_dist[idx, prop.long()]
        q_prop = q_dist[idx, prop.long()]
        u = prng.uniform_shaped(kr, (gamma,))
        accept = u < torch.clamp_max(p_prop / torch.clamp_min(q_prop, 1e-20),
                                     1.0)
        rejected = ~accept
        n_acc = torch.where(rejected.any(),
                            rejected.to(torch.uint8).argmax(), gamma)
        # correction: the residual max(p - q, 0) at the first rejection; the
        # target's own bonus-position distribution on a full accept
        # (index_select with a 1-element tensor: indexing with a 0-d tensor
        # would bring it to the host and wait for the device)
        at = n_acc.view(1)
        q_pad = torch.cat([q_dist, torch.zeros_like(q_dist[:1])])
        p_at = p_dist.index_select(0, at)[0]
        resid = torch.clamp_min(p_at - q_pad.index_select(0, at)[0], 0.0)
        use_p = (n_acc == gamma) | ~(resid.sum() > 1e-20)
        corr = torch.where(use_p, p_at, resid)
        corrected = sampling.draw(prng.fold_in(kr, torch.ones_like(kr[0])),
                                  corr / corr.sum())
        tokens = torch.cat([torch.where(idx < n_acc, prop, 0),
                            torch.zeros_like(prop[:1])])
        tokens.index_copy_(0, at, corrected.view(1).to(tokens.dtype))
        return tokens, n_acc + 1

    return window


class SpeculativeEngine:
    """Draft/target speculative decoding over the dense caches (batch 1).
    ``LLMEngine(backend="speculative")`` holds one instance.
    ``cache_dtype``: the dense caches' dtype (bf16 by default, as the
    reference's)."""

    def __init__(self, draft: Model, target: Model, *, gamma: int = 8,
                 cache_dtype=None):
        _check_rewindable(draft)
        _check_rewindable(target)
        if draft.cfg.padded_vocab != target.cfg.padded_vocab:
            raise ValueError("draft and target must share a vocabulary: "
                             f"{draft.cfg.padded_vocab} vs "
                             f"{target.cfg.padded_vocab}")
        self.draft, self.target = draft, target
        self.device = target.device
        self.gamma = gamma
        self.cache_dtype = cache_dtype

    @torch.no_grad()
    def generate(self, prompt: torch.Tensor, *, max_new_tokens: int,
                 sampling_params: SamplingParams | None = None,
                 max_len: int | None = None, key=None) -> SpecStats:
        """Generate ``max_new_tokens`` tokens for a (1, S) prompt (one more
        may come back: callers cut to their budget).  ``key``: a ``prng``
        key; default ``PRNGKey(sampling_params.seed)``.  The emitted tokens
        come to the host once a window."""
        sp = sampling_params if sampling_params is not None \
            else SamplingParams(temperature=1.0)
        dev = self.device
        prompt = torch.as_tensor(prompt).to(dev)
        key = (prng.prng_key(torch.tensor(sp.seed)) if key is None
               else key).to(dev)
        s = prompt.shape[1]
        max_len = max_len or (s + max_new_tokens + self.gamma + 2)
        dcache = self.draft.init_cache(1, max_len, dtype=self.cache_dtype)
        tcache = self.target.init_cache(1, max_len, dtype=self.cache_dtype)
        self.draft.prefill(prompt, dcache)
        tlogits = self.target.prefill(prompt, tcache)

        key, k0 = prng.split(key)
        last = sampling.draw(k0, sampling.dist(tlogits, sp))    # (1,)
        pos = s
        window = make_speculative_window(self.draft, self.target,
                                         gamma=self.gamma, sampling_params=sp)
        out = [int(last[0])]
        accepted = []
        while len(out) < max_new_tokens + 1:
            key, kw = prng.split(key)
            tokens, n_emit = window(last, dcache, tcache, pos, kw)
            host = torch.cat([tokens, n_emit[None].to(tokens.dtype)]).cpu()
            n = int(host[-1])                                   # device sync
            out.extend(int(t) for t in host[:n])
            accepted.append(n - 1)
            last = tokens[n - 1:n]
            pos += n
        return SpecStats(
            tokens=torch.tensor(out[:max_new_tokens + 1], dtype=torch.int32),
            accepted_per_window=torch.tensor(accepted, dtype=torch.float32),
            windows=len(accepted))


def speculative_generate(draft: Model, target: Model, prompt: torch.Tensor,
                         *, max_new_tokens: int, gamma: int = 8,
                         temperature: float = 1.0,
                         sampling_params: SamplingParams | None = None,
                         max_len: int | None = None, key=None) -> SpecStats:
    """One-shot wrapper: a throwaway ``SpeculativeEngine``.  Callers doing
    repeated generation should hold an engine (or ``LLMEngine``)."""
    sp = (sampling_params if sampling_params is not None
          else SamplingParams(temperature=temperature))
    eng = SpeculativeEngine(draft, target, gamma=gamma)
    return eng.generate(prompt, max_new_tokens=max_new_tokens,
                        sampling_params=sp, max_len=max_len, key=key)
