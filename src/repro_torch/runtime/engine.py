"""Serving engines: static batch over a dense KV cache, and continuous
batching over a block-paged one.

``ServeEngine`` is the port of the reference's static-batch engine:
prefill and decode are separate entry points, the whole batch shares one
prompt length and one position, and the reference's one jitted
``lax.scan`` over decode steps is a Python loop of ``Model.decode_step``
and the per-row sampler here (same ``pos + 1`` sampling positions, same
presence rows).  On CUDA every prefill attention is the hand-written flash
kernel and every decode attention the dense decode kernel.

``ContinuousServeEngine`` is the port of the reference's continuous engine
for one device and full-KV layouts.  Requests arrive raggedly;
iteration-level batching admits each one into a freed decode slot the
moment both a slot and KV pages are available.  Admission runs **chunked
prefill straight into the page pools** (one fixed-size chunk per prefilling
request per iteration, batched across slots at ragged offsets, power-of-two
row buckets), interleaved with one decode step over every decoding slot, so
a long prompt never stalls the running batch.  Prefix caching shares a
matching prompt's leading pages read-only; copy-on-write, preemption and
defrag are host bookkeeping between steps (``kv_cache.py`` and
``scheduler.py`` are verbatim copies of the reference's).

Where the reference jits ``_step_impl``/``_chunk_impl`` and donates the
pools, here they are plain methods and the pools are updated in place.
On CUDA the decode attention of every layer is the hand-written paged
decode kernel; on the CPU it is its plain version.

Quantized serving: ``weight_format=`` ("mxfp4", "mxfp8", "bfp", "nxfp4")
serves a quantized view of the model (``quant.linear.quantize_params``;
the caller's model is left as it was), whose mxfp4 projections run the
hand-written MXFP4 VMM kernel on CUDA; ``cache_dtype="fp8"|"int8"``
builds code pools with per-token scale leaves, which the decode kernel
dequantizes in its page loop and which move with their pages through
copy-on-write and defrag like every other leaf.

Speculative decoding: ``speculative=SpeculativeConfig(gamma=...,
draft_model=...)`` runs draft/verify windows over the decoding slots.  The
draft keeps its own pool leaves over the target's page tables (a
self-draft too), so prefix sharing, copy-on-write, preemption and defrag
move both pool sets in lockstep.  A window is gamma single-token draft
steps (the paged decode kernel on CUDA) plus a backfill step, then one
multi-token verify step through ``Model.decode_step_paged``'s 2-D form
(the exact-accumulator kernel on CUDA), then the acceptance rule per slot;
the emitted tokens come to the host once a window.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): ``spec=`` (DeploymentSpec sizing, also of a draft),
``mesh=`` (tensor parallelism), ``phase != "colocated"`` (disaggregation,
also of draft pages),
sliding-window / stateful layouts, and prompt scoring
(``SamplingParams.prompt_logprobs``) in the continuous engine (the static
backend of ``LLMEngine`` scores prompts through ``Model.forward``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.model import Model, dense_cache_dtype
from repro_torch.quant import kv as kvq
from repro_torch.quant.linear import quantize_params
from repro_torch.runtime import sampling
from repro_torch.runtime.kv_cache import PagedKVCache
from repro_torch.runtime.sampling import SamplingParams
from repro_torch.runtime.scheduler import RUNNING, Request, Scheduler
from repro_torch.runtime.speculative import SpeculativeConfig, _check_rewindable


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP Queue 1, '{item}')")


@dataclasses.dataclass
class RequestOutput:
    """One structured progress/result record for a request.

    Streaming emits one per request per engine iteration that produced
    tokens (``new_token_ids`` is the delta — across a preemption-restart
    the re-derived tokens are NOT re-emitted); the final record has
    ``finished=True`` with a ``finish_reason`` of "stop" or "length".  The
    cumulative fields (``token_ids``, ``logprobs``) are populated on
    finished records only."""
    rid: int
    new_token_ids: list[int]
    token_ids: list[int]               # cumulative; finished records only
    finished: bool = False
    finish_reason: str | None = None
    logprobs: list[float] | None = None    # cumulative, iff requested
    prompt_logprobs: list[float] | None = None   # finished records, iff asked
    metrics: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class GenerationResult:
    tokens: torch.Tensor              # (B, n_new) int32
    logprobs: torch.Tensor | None     # (B, n_new) f32, iff any row asked
    steps: int
    prefill_s: float = 0.0            # prompt in -> first tokens drawn
    decode_s: float = 0.0             # the decode loop (n_new - 1 steps)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServeEngine:
    """Batched request serving for one model (static batch).

    ``prefill`` runs the prompt batch into a fresh dense cache of
    ``max_len`` positions; ``generate`` then decodes ``max_new_tokens - 1``
    steps at the shared position.  ``weight_format=`` serves a quantized
    view of the model (``quant.linear.quantize_params``; the caller's model
    is left as it was).  A quantized ``cache_dtype`` raises, as in the
    reference: the dense cache stays a plain dtype."""

    def __init__(self, model: Model, *, device: str | torch.device = "cuda",
                 max_len: int | None = None, spec=None,
                 sampling_params: SamplingParams | None = None,
                 cache_dtype=None, weight_format: str | None = None,
                 max_top_k: int = sampling.MAX_TOP_K):
        dev = resolve_device(device)
        wdev = next(model.parameters()).device
        if wdev.type != dev.type or dev.index not in (None, wdev.index):
            raise ValueError(f"model weights are on {wdev}, the engine was "
                             f"asked to run on {dev}")
        self.device = wdev
        if spec is not None:
            raise _unported("DeploymentSpec sizing (spec=)",
                            "DeploymentSpec")
        if max_len is None:
            raise ValueError("pass max_len=")
        cache_dtype = dense_cache_dtype(cache_dtype)     # refuses fp8/int8
        self.weight_format = weight_format
        if weight_format is not None:
            model = quantize_params(model, weight_format)
        self.model = model
        self.max_len = int(max_len)
        self.default_sampling = sampling_params or sampling.GREEDY
        self.max_top_k = int(max_top_k)
        self.cache_dtype = cache_dtype

    # -- phase 1: prefill ---------------------------------------------------
    def prefill(self, batch: dict):
        """Run the prompt; returns (first_token_logits, cache, prompt_len)."""
        return self._prefill(self._tokens(batch))

    def _prefill(self, tokens: torch.Tensor):
        cache = self.model.init_cache(tokens.shape[0], self.max_len,
                                      dtype=self.cache_dtype)
        logits = self.model.prefill(tokens, cache)
        return logits, cache, tokens.shape[1]

    def _tokens(self, batch: dict) -> torch.Tensor:
        """The (B, S) prompt tokens of ``batch`` on the engine's device."""
        if set(batch) != {"tokens"}:
            raise NotImplementedError(
                f"batch keys {sorted(batch)}: the port serves token "
                f"prompts only (modality frontends are not ported)")
        toks = batch["tokens"]
        if not torch.is_tensor(toks):
            toks = torch.as_tensor(np.asarray(toks))
        return toks.to(self.device)

    def _resolve_params(self, b: int, sampling_params) -> list[SamplingParams]:
        if sampling_params is None:
            sps = [self.default_sampling] * b
        elif isinstance(sampling_params, SamplingParams):
            sps = [sampling_params] * b
        else:
            sps = list(sampling_params)
            if len(sps) != b:
                raise ValueError(f"{len(sps)} SamplingParams for batch {b}")
        for sp in sps:
            if sp.top_k > self.max_top_k:
                raise ValueError(f"top_k={sp.top_k} exceeds the engine's "
                                 f"static max_top_k={self.max_top_k}")
        return sps

    # -- phase 2: decode loop -----------------------------------------------
    def generate(self, batch: dict, *, max_new_tokens: int,
                 sampling_params=None) -> GenerationResult:
        """prefill + decode ``max_new_tokens``; returns every generated
        token.  ``sampling_params``: one ``SamplingParams`` for the batch
        or a per-row list.  Stop-token truncation is the caller's concern
        (the loop has a fixed trip count); ``LLMEngine`` applies it."""
        tokens = self._tokens(batch)
        b, plen = tokens.shape
        if plen + max_new_tokens > self.max_len:
            raise ValueError(f"{plen}-token prompts + {max_new_tokens} new "
                             f"tokens exceed max_len={self.max_len}")
        sps = self._resolve_params(b, sampling_params)
        dev = self.device
        temp, topk, topp, minp, seed = (
            torch.as_tensor(a, device=dev)
            for a in sampling.stack_params(sps))
        rep, bias_ids, bias_vals = (
            torch.as_tensor(a, device=dev)
            for a in sampling.stack_extras(sps))
        # the loop hands the device nothing from host memory (every value
        # is a kernel argument or already on the device), so the host
        # enqueues ahead of the device and never waits for it
        true = torch.ones((), dtype=torch.bool, device=dev)
        # token-presence rows seed the repetition penalty with the prompt
        pres = torch.zeros((b, self.model.cfg.padded_vocab), dtype=torch.bool,
                           device=dev)
        rows = torch.arange(b, device=dev)
        pres.index_put_((rows[:, None], tokens.long()), true)
        kw = dict(max_top_k=self.max_top_k, rep_penalty=rep,
                  bias_ids=bias_ids, bias_vals=bias_vals, presence=pres)
        t0 = time.monotonic()
        logits, cache, plen = self._prefill(tokens)
        # the first new token sits at sequence index plen
        draw_pos = torch.full((b,), plen, dtype=torch.int32, device=dev)
        nxt, lp = sampling.sample_slots(logits, temp, topk, topp, minp, seed,
                                        draw_pos, **kw)
        _sync(dev)
        t1 = time.monotonic()
        toks, lps = [nxt], [lp]
        for pos in range(plen, plen + max_new_tokens - 1):
            # the incoming token joins the stream before the next draw —
            # the repetition penalty sees prompt + every generated token
            pres.index_put_((rows, nxt.long()), true)
            logits = self.model.decode_step(nxt, cache, pos)
            # the token being generated sits at sequence index pos + 1
            draw_pos.add_(1)
            nxt, lp = sampling.sample_slots(logits, temp, topk, topp, minp,
                                            seed, draw_pos, **kw)
            toks.append(nxt)
            lps.append(lp)
        all_toks = torch.stack(toks, dim=1)
        _sync(dev)
        return GenerationResult(
            tokens=all_toks,
            logprobs=(torch.stack(lps, dim=1)
                      if any(sp.logprobs for sp in sps) else None),
            steps=max_new_tokens, prefill_s=t1 - t0,
            decode_s=time.monotonic() - t1)


@dataclasses.dataclass
class ContinuousStats:
    """Outcome of one serving session (``run`` or ``stats``)."""
    results: dict                 # rid -> np.ndarray (n_new,) int32
    steps: int                    # decode iterations executed
    occupancy: float              # mean fraction of decoding slots per step
    wall: float                   # seconds since the session started
    preemptions: int
    chunks: int = 0               # prefill chunk rows executed
    prefill_calls: int = 0        # batched prefill-chunk model calls
    prefill_tokens: int = 0       # prompt tokens actually computed
    prompt_tokens: int = 0        # prompt tokens across all admissions
    prefix_hit_tokens: int = 0    # prompt tokens served from shared pages
    cow_events: int = 0
    # -- speculative decoding (all zero when speculation is off) --
    spec_windows: int = 0         # draft/verify windows across all requests
    spec_drafted: int = 0         # draft proposals made (gamma per window)
    spec_accepted: int = 0        # draft proposals accepted
    per_request: dict = dataclasses.field(default_factory=dict)
    # per_request[rid] = {"preemptions", "chunks", "shared_tokens", "ttft",
    #                     "tpot", "finish_time", "spec_windows",
    #                     "spec_accepted"}
    outputs: dict = dataclasses.field(default_factory=dict)
    # outputs[rid] = final RequestOutput (finish_reason, logprobs, timing)

    @property
    def total_tokens(self) -> int:
        return int(sum(t.shape[0] for t in self.results.values()))

    @property
    def accepted_per_window(self) -> float:
        """Mean draft proposals accepted per window (0..gamma); each window
        also emits one corrected or bonus token on top."""
        return self.spec_accepted / max(self.spec_windows, 1)

    @property
    def spec_wasted(self) -> int:
        """Draft tokens proposed but rejected: the speculation overhead."""
        return self.spec_drafted - self.spec_accepted

    def latency_quantiles(self, metric: str = "ttft") -> dict | None:
        """p50/p95/p99/mean of a per-request latency metric ("ttft" or
        "tpot"), or None; requests where it is unset are skipped."""
        ts = sorted(r[metric] for r in self.per_request.values()
                    if r.get(metric) is not None)
        if not ts:
            return None

        def pct(q: float) -> float:
            return ts[min(len(ts) - 1, int(len(ts) * q))]
        return {"p50": pct(0.50), "p95": pct(0.95), "p99": pct(0.99),
                "mean": sum(ts) / len(ts)}


class ContinuousServeEngine:
    """Iteration-level continuous batching over a block-paged KV cache.

    The decode step has a fixed slot batch; per-slot page tables and ragged
    positions route each slot's K/V stream through the physical page pools
    (``Model.decode_step_paged``), and the per-slot sampler draws each
    slot's next token in the same step.  Drive it incrementally
    (``add_request`` then ``step`` until ``has_unfinished()`` is False) or
    in batch via ``run(requests, on_output=...)``.  With ``speculative=``
    each step over the decoding slots is one draft/verify window instead.
    """

    def __init__(self, model: Model, *, device: str | torch.device = "cuda",
                 num_slots: int | None = None, page_size: int | None = None,
                 num_pages: int | None = None, max_len: int | None = None,
                 spec=None, sampling_params: SamplingParams | None = None,
                 cache_dtype=None, weight_format: str | None = None,
                 prefill_chunk: int | None = None,
                 enable_prefix_cache: bool = True,
                 max_top_k: int = sampling.MAX_TOP_K,
                 mesh=None, speculative: SpeculativeConfig | None = None,
                 phase: str = "colocated"):
        dev = resolve_device(device)
        wdev = next(model.parameters()).device
        if wdev.type != dev.type or dev.index not in (None, wdev.index):
            raise ValueError(f"model weights are on {wdev}, the engine was "
                             f"asked to run on {dev}")
        self.device = wdev
        if spec is not None:
            raise _unported("DeploymentSpec sizing (spec=)",
                            "DeploymentSpec")
        if mesh is not None:
            raise _unported("tensor-parallel serving (mesh=)",
                            "Tensor parallelism")
        kvq.validate_cache_dtype(cache_dtype)
        if phase != "colocated":
            raise _unported(f"phase={phase!r} (disaggregated serving)",
                            "Disaggregation")
        if any(seg.window is not None for seg in model.plan):
            raise _unported(f"{model.cfg.name}: sliding-window ring pages",
                            "Stateful layouts")
        missing = [k for k, v in (("num_slots", num_slots),
                                  ("page_size", page_size),
                                  ("num_pages", num_pages),
                                  ("max_len", max_len)) if v is None]
        if missing:
            raise ValueError(f"pass the explicit knobs {missing}")
        prefill_chunk = 64 if prefill_chunk is None else prefill_chunk
        if weight_format is not None:
            # a view: packed projections, the caller's other tensors
            model = quantize_params(model, weight_format)
        self.model = model
        self.num_slots = num_slots
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_len = max_len
        self.max_blocks = -(-max_len // page_size)
        if num_pages - 1 < self.max_blocks:   # page 0 is scratch
            raise ValueError(
                f"num_pages={num_pages} cannot back even one max-length "
                f"request ({self.max_blocks} blocks + scratch)")
        self.default_sampling = sampling_params or sampling.GREEDY
        self.max_top_k = int(max_top_k)
        self.cache_dtype = cache_dtype
        if int(prefill_chunk) < 1:
            raise ValueError(f"prefill_chunk={prefill_chunk} must be >= 1")
        self.prefill_chunk = int(prefill_chunk)
        self.enable_prefix_cache = enable_prefix_cache
        self.defrag_every = 0
        self._vocab = model.cfg.padded_vocab
        # -- speculative decoding: the draft keeps a second set of pool
        # leaves over the same page-id space (one allocator, one set of
        # page tables) --
        self.spec = speculative
        self._gamma = int(speculative.gamma) if speculative is not None else 0
        if speculative is not None:
            _check_rewindable(model)
            dm = speculative.draft_model
            if dm is None:
                # self-draft: the target's weights propose and verify; the
                # draft still writes its own pools, so its look-ahead never
                # clobbers the target's verified entries
                dm = model
            else:
                if dm.cfg.padded_vocab != model.cfg.padded_vocab:
                    raise ValueError(
                        "draft and target must share a vocabulary: "
                        f"{dm.cfg.padded_vocab} vs {model.cfg.padded_vocab}")
                ddev = next(dm.parameters()).device
                if ddev != self.device:
                    raise ValueError(f"draft weights are on {ddev}, the "
                                     f"target's on {self.device}")
                if weight_format is not None:
                    dm = quantize_params(dm, weight_format)
            self._draft_model = dm
        self._true = torch.ones((), dtype=torch.bool, device=self.device)
        self._sched: Scheduler | None = None

    # -- device pieces (the reference's jitted functions) -------------------
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _step_impl(self, tokens, pos, page_table, temp, topk, topp, minp,
                   seed, rep, bias_ids, bias_vals):
        logits = self.model.decode_step_paged(tokens, self._pools, page_table,
                                              pos)
        # the incoming token sits at index pos; the one being generated at
        # pos + 1 — its PRNG key is fold_in(seed, pos + 1)
        nxt, lp = sampling.sample_slots(logits, temp, topk, topp, minp, seed,
                                        pos + 1, max_top_k=self.max_top_k,
                                        rep_penalty=rep, bias_ids=bias_ids,
                                        bias_vals=bias_vals,
                                        presence=self._presence)
        # the sampled token joins its slot's presence row for the next
        # step's repetition penalty (rows of inactive slots accumulate
        # garbage harmlessly — admission re-uploads the host mirror)
        self._presence[torch.arange(nxt.shape[0], device=self.device),
                       nxt.long()] = True
        return nxt, lp

    def _chunk_impl(self, presence, tokens, page_table, start, valid, temp,
                    topk, topp, minp, seed, rep, bias_ids, bias_vals):
        logits = self.model.prefill_chunk_paged(tokens, self._pools,
                                                page_table, start, valid)
        # a request's first token is generated at index prompt_len ==
        # start + valid of its final chunk (other rows' draws are ignored)
        return sampling.sample_slots(logits, temp, topk, topp, minp, seed,
                                     start + valid, max_top_k=self.max_top_k,
                                     rep_penalty=rep, bias_ids=bias_ids,
                                     bias_vals=bias_vals, presence=presence)

    def _pool_leaves(self):
        """Every pool leaf of the target and, when speculating, the draft
        (scale leaves of quantized pools included)."""
        sets = [self._pools] + ([self._draft_pools] if self.spec else [])
        for pools in sets:
            for pool in pools:
                for leaf in pool.values():
                    yield kvq.raw_view(leaf)

    def _copy_page(self, dst: int, src: int) -> None:
        """pools[dst] = pools[src] on every leaf (copy-on-write)."""
        for raw in self._pool_leaves():
            raw[dst] = raw[src]

    def _permute_pools(self, gather: np.ndarray) -> None:
        """Apply a defrag page permutation: new_pool[i] = old_pool[g[i]]."""
        g = self._tensor(gather).long()
        for raw in self._pool_leaves():
            raw.copy_(raw.index_select(0, g))

    # -- speculative window (the reference's _spec_draft_impl /
    # _spec_verify_impl) -----------------------------------------------------
    def _spec_draft_impl(self, tokens, pos, page_table, temp, topk, topp,
                         minp, seed, rep, bias_ids, bias_vals):
        """One draft pass: gamma chained single-token decode steps through
        the draft pools, each drawing its proposal from the same processed
        and filtered distribution the target verifies against (recorded as
        q), from the request's TAG_PROPOSE stream at the proposal's own
        sequence index — a preemption restart replays identical windows.
        The trailing step backfills the draft pools for the last proposal
        (position pos + gamma): on a full accept the next window's draft
        must see the whole history.  Presence updates stay on a
        draft-local copy: proposals are not emissions until verified.

        Returns (prop (B, gamma) int32, q_dists (gamma, B, V) f32)."""
        g = self._gamma
        rows = torch.arange(tokens.shape[0], device=self.device)
        pres = self._presence.clone()
        tok, props, q_dists = tokens, [], []
        for j in range(g):
            pres.index_put_((rows, tok.long()), self._true)
            logits = self._draft_model.decode_step_paged(
                tok, self._draft_pools, page_table, pos + j)
            lg = sampling.apply_processors(logits, rep, bias_ids, bias_vals,
                                           pres)
            q = sampling.slot_dist(lg, temp, topk, topp, minp,
                                   max_top_k=self.max_top_k)
            u = sampling.spec_uniform(seed, pos + j + 1, sampling.TAG_PROPOSE)
            tok = sampling.slot_draw(q, u)
            props.append(tok)
            q_dists.append(q)
        self._draft_model.decode_step_paged(tok, self._draft_pools,
                                            page_table, pos + g)
        return torch.stack(props, dim=1), torch.stack(q_dists)

    def _spec_verify_impl(self, tokens, prop, q_dists, pos, page_table, temp,
                          topk, topp, minp, seed, rep, bias_ids, bias_vals):
        """One verify pass: the target scores [last emitted, prop_1..g] in
        one multi-token paged decode (``decode_step_paged``'s 2-D form),
        then the acceptance rule per slot: accept prop_j while u_j <
        min(1, p(prop_j) / q(prop_j)); at the first rejection draw from
        max(p - q, 0) normalized; on a full accept draw the bonus token
        from p at the extra position.  p and q both come from
        ``apply_processors`` + ``slot_dist`` with the running presence
        threaded position by position.  Greedy slots score exact one-hots
        on both sides: the emitted stream is the plain engine's.  Rejected
        positions need no KV rollback: their pool entries sit past the new
        position and are masked, then overwritten, by the next window.

        Returns (tokens (B, gamma+1), n_emit (B,), logprobs (B, gamma+1));
        entries past n_emit are padding.  The target's presence rows gain
        the emitted tokens."""
        g = self._gamma
        b = tokens.shape[0]
        dev = self.device
        rows = torch.arange(b, device=dev)
        t_in = torch.cat([tokens[:, None], prop], dim=1)        # (B, g+1)
        logits = self.model.decode_step_paged(
            t_in, self._pools, page_table, pos,
            torch.full((b,), g + 1, dtype=torch.int32, device=dev))
        pres = self._presence.clone()
        p_dists, glps = [], []
        for j in range(g + 1):
            # token j joins the stream before position j's draw
            pres.index_put_((rows, t_in[:, j].long()), self._true)
            lg = sampling.apply_processors(logits[:, j], rep, bias_ids,
                                           bias_vals, pres)
            p_dists.append(sampling.slot_dist(lg, temp, topk, topp, minp,
                                              max_top_k=self.max_top_k))
            glps.append(lg.amax(-1) - torch.logsumexp(lg, dim=-1))
        p_dists = torch.stack(p_dists)                          # (g+1, B, V)
        jdx = torch.arange(g, device=dev)
        cols = prop.T.long()                                    # (g, B)
        p_prop = p_dists[jdx[:, None], rows[None, :], cols]
        q_prop = q_dists[jdx[:, None], rows[None, :], cols]
        u = sampling.spec_uniform(seed[None, :], pos[None, :] + jdx[:, None] + 1,
                                  sampling.TAG_ACCEPT)
        accept = u < torch.clamp_max(p_prop / torch.clamp_min(q_prop, 1e-20),
                                     1.0)
        rejected = ~accept
        n_acc = torch.where(rejected.any(0),
                            rejected.to(torch.uint8).argmax(0), g)  # (B,)
        # correction (first rejection) / bonus (full accept) distribution
        q_pad = torch.cat([q_dists, torch.zeros_like(q_dists[:1])])
        p_at = p_dists[n_acc, rows]                             # (B, V)
        resid = torch.clamp_min(p_at - q_pad[n_acc, rows], 0.0)
        rs = resid.sum(-1, keepdim=True)
        corr = torch.where((n_acc[:, None] == g) | (rs <= 1e-20), p_at,
                           resid / torch.clamp_min(rs, 1e-20))
        uc = sampling.spec_uniform(seed, pos + n_acc + 1, sampling.TAG_CORRECT)
        corrected = sampling.slot_draw(corr, uc)
        jcols = torch.arange(g + 1, device=dev)[None, :]
        out = torch.where(jcols < n_acc[:, None],
                          torch.cat([prop, prop[:, :1]], dim=1), 0)
        out = torch.where(jcols == n_acc[:, None], corrected[:, None], out)
        # logprobs under the target's per-position distribution; greedy
        # rows report the max-logit logprob ``sample_slots`` would
        chosen = torch.gather(p_dists.transpose(0, 1), 2,
                              out[..., None].long())[..., 0]
        lp = torch.where((temp <= 0.0)[:, None], torch.stack(glps, dim=1),
                         torch.log(torch.clamp_min(chosen, 1e-38)))
        # presence gains the emitted tokens only; masked columns re-mark
        # the first emitted token (a harmless duplicate)
        scat = torch.where(jcols <= n_acc[:, None], out, out[:, :1])
        self._presence.index_put_((rows[:, None].expand_as(scat),
                                   scat.long()), self._true)
        return out, n_acc + 1, lp

    # -- serving state ------------------------------------------------------
    def reset(self) -> None:
        """Drop all serving state and start an empty session."""
        self.cache = PagedKVCache(num_slots=self.num_slots,
                                  num_pages=self.num_pages,
                                  page_size=self.page_size,
                                  max_blocks=self.max_blocks,
                                  enable_prefix_cache=self.enable_prefix_cache)
        self._sched = Scheduler(self.cache, on_release=self._on_release)
        self._slots = sampling.SlotSampling(self.num_slots, self.device)
        # token-presence rows (repetition penalty): host mirror + device copy
        self._presence_np = np.zeros((self.num_slots, self._vocab), np.bool_)
        self._presence = self._presence_copy()
        self._presence_dirty = False
        self._pools = self._draft_pools = None   # free the old pools first
        self._pools = self.model.init_paged_cache(
            self.num_pages, self.page_size, dtype=self.cache_dtype)
        if self.spec is not None:
            self._draft_pools = self._draft_model.init_paged_cache(
                self.num_pages, self.page_size, dtype=self.cache_dtype)
        self._t0 = time.monotonic()
        self._steps, self._occ_sum = 0, 0.0
        self._n_chunks, self._prefill_tokens = 0, 0
        self._prefill_calls = 0
        self._spec_windows, self._spec_drafted, self._spec_accepted = 0, 0, 0
        self._requests: list[Request] = []
        self.defrag_every = 0      # run-scoped; run() re-applies its arg

    def _presence_copy(self) -> torch.Tensor:
        """The device copy of the host presence mirror.  A copy on the CPU
        too: the decode step marks every row's sampled token in place,
        rows of slots still prefilling included (harmless garbage the next
        upload replaces), which must not reach the host mirror that
        prefill chunks read."""
        return torch.tensor(self._presence_np, device=self.device)

    def _on_release(self, slot: int) -> None:
        self._slots.clear(slot)
        self._presence_np[slot] = False
        self._presence_dirty = True

    def _now(self) -> float:
        return time.monotonic() - self._t0

    def has_unfinished(self) -> bool:
        return self._sched is not None and self._sched.has_work()

    def add_request(self, req: Request,
                    sampling_params: SamplingParams | None = None) -> None:
        """Submit one request; it enters the slot batch on a later
        ``step()`` once a slot and pages free up (honoring arrival_time)."""
        if self._sched is None:
            self.reset()
        if req.sampling is None:
            req.sampling = sampling_params or self.default_sampling
        if req.sampling.prompt_logprobs:
            raise _unported("prompt scoring (SamplingParams.prompt_logprobs)",
                            "Prompt scoring")
        if req.sampling.max_tokens is not None:
            req.max_new_tokens = min(req.max_new_tokens,
                                     req.sampling.max_tokens)
        if req.sampling.top_k > self.max_top_k:
            raise ValueError(f"request {req.rid}: top_k={req.sampling.top_k} "
                             f"exceeds the engine's static "
                             f"max_top_k={self.max_top_k}")
        # speculative windows write KV up to gamma positions past the last
        # emitted token, so a request needs that much page slack on top
        if (req.prompt_len + req.max_new_tokens + self._gamma
                > self.max_blocks * self.page_size):
            raise ValueError(
                f"request {req.rid}: prompt {req.prompt_len} + "
                f"{req.max_new_tokens} new tokens"
                + (f" + gamma {self._gamma}" if self._gamma else "")
                + f" exceeds max_len {self.max_blocks * self.page_size}")
        self._requests.append(req)
        self._sched.submit([req])

    # -- host loop ----------------------------------------------------------
    @staticmethod
    def _bucket(n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return b

    def _make_output(self, req: Request, new: list[int],
                     finished: bool) -> RequestOutput:
        metrics = {"ttft": req.ttft, "preemptions": req.preemptions,
                   "chunks": req.chunks, "shared_tokens": req.shared_tokens}
        if finished:
            metrics["finish_time"] = req.finish_time
            metrics["tpot"] = req.tpot
        if self.spec is not None:
            metrics["spec_windows"] = req.spec_windows
            metrics["spec_accepted"] = req.spec_accepted
        return RequestOutput(
            rid=req.rid, new_token_ids=list(new),
            token_ids=list(req.tokens) if finished else [],
            finished=finished,
            finish_reason=req.finish_reason if finished else None,
            logprobs=(list(req.logprobs)
                      if finished and req.sampling.logprobs else None),
            metrics=metrics)

    def _progress(self, req: Request, outs: list[RequestOutput]) -> None:
        """Apply finish reasons on-host and emit the unstreamed delta."""
        reason = req.check_finish()
        if reason is not None:
            req.finish_reason = reason
            self._sched.finish(req, self._now())
        if len(req.tokens) > req.emitted or reason is not None:
            new = req.tokens[req.emitted:]
            req.emitted = len(req.tokens)
            outs.append(self._make_output(req, new,
                                          finished=reason is not None))

    def _run_prefill_chunks(self, outs: list[RequestOutput]) -> None:
        """Advance every PREFILL request by one chunk (one batched call at
        ragged offsets).  Rows pad to a power-of-two bucket, and the page
        table view is sliced to the power-of-two cover of the blocks
        resident after this chunk, so a short prompt's chunk never gathers
        the full ``max_blocks`` view."""
        pre = self._sched.prefilling()
        c = self.prefill_chunk
        bucket = self._bucket(len(pre))
        need = max(-(-(r.pos + min(c, r.prompt_len - r.pos)) // self.page_size)
                   for r in pre)
        nb = min(self._bucket(need), self.max_blocks)
        tokens = np.zeros((bucket, c), np.int32)
        tables = np.zeros((bucket, nb), np.int32)      # pad rows -> scratch
        start = np.zeros((bucket,), np.int32)
        valid = np.zeros((bucket,), np.int32)
        table = self.cache.table()
        for i, r in enumerate(pre):
            n = min(c, r.prompt_len - r.pos)
            tokens[i, :n] = r.prompt[r.pos:r.pos + n]
            tables[i] = table[r.slot, :nb]
            start[i] = r.pos
            valid[i] = n
        samp = sampling.stack_params([r.sampling for r in pre], bucket)
        extras = sampling.stack_extras([r.sampling for r in pre], bucket)
        pres = np.zeros((bucket, self._vocab), np.bool_)
        for i, r in enumerate(pre):
            pres[i] = self._presence_np[r.slot]
        pres_t, tok_t, tab_t, start_t, valid_t = (
            self._tensor(a) for a in (pres, tokens, tables, start, valid))
        first, lp = self._chunk_impl(pres_t, tok_t, tab_t, start_t, valid_t,
                                     *(self._tensor(a) for a in samp + extras))
        if self.spec is not None:
            # the draft pools take the same chunk (logits dropped), so the
            # first draft window attends over the whole prompt
            self._draft_model.prefill_chunk_paged(tok_t, self._draft_pools,
                                                  tab_t, start_t, valid_t)
        self._prefill_calls += 1
        first = first.cpu().numpy()                    # device sync
        lp = lp.cpu().numpy()
        for i, r in enumerate(pre):
            r.chunks += 1
            self._n_chunks += 1
            self._prefill_tokens += int(valid[i])
            r.pos += int(valid[i])
            if r.pos == r.prompt_len:                  # prefill complete
                r.state = RUNNING
                r.tokens.append(int(first[i]))
                self._presence_np[r.slot, int(first[i])] = True
                self._presence_dirty = True
                if r.sampling.logprobs:
                    r.logprobs.append(float(lp[i]))
                if r.first_token_time is None:
                    # a restart re-emits the tokens the client already has
                    # (seeded streams), so a preempted request keeps its
                    # original TTFT
                    r.first_token_time = self._now()
                self.cache.index_prompt(r.slot, r.prompt)
                self._progress(r, outs)

    def step(self) -> list[RequestOutput]:
        """One scheduler iteration: admit arrived requests, advance every
        prefilling request by one chunk, run one decode step over the
        decoding slots.  Returns the ``RequestOutput`` deltas produced this
        iteration (may be empty).  Never sleeps."""
        if self._sched is None:
            return []
        sched = self._sched
        outs: list[RequestOutput] = []
        for r in sched.admit(self._now()):
            self._slots.set(r.slot, r.sampling)
            self._presence_np[r.slot] = False
            self._presence_np[r.slot][np.asarray(r.prompt)] = True
            self._presence_dirty = True
        # -- chunked prefill, interleaved with the decode iterations --
        if sched.prefilling():
            self._run_prefill_chunks(outs)
        if not sched.decoding():
            return outs
        # -- capacity + copy-on-write barrier for this step's KV writes; a
        # speculative window writes KV at pos..pos+gamma, so the whole
        # window's pages are backed (and un-shared) before it starts --
        g = self._gamma
        for req in sched.decoding():
            if sched.running.get(req.slot) is req:  # not yet preempted
                if sched.ensure_capacity(req, upto=req.pos + g if g else None):
                    for blk in range(req.pos // self.page_size,
                                     (req.pos + g) // self.page_size + 1):
                        moved = self.cache.cow(req.slot, blk)
                        if moved is not None:
                            self._copy_page(moved[1], moved[0])
        decoding = sched.decoding()
        if not decoding:
            return outs
        if self.defrag_every and (self._steps + 1) % self.defrag_every == 0:
            gather = self.cache.defrag()
            if gather is not None:
                self._permute_pools(gather)

        tokens = np.zeros((self.num_slots,), np.int32)
        pos = np.zeros((self.num_slots,), np.int32)
        # slots still prefilling (or free) must not touch live pages: their
        # rows are routed to the scratch page for this step
        step_table = np.zeros_like(self.cache.table())
        for req in decoding:
            tokens[req.slot] = req.tokens[-1]
            pos[req.slot] = req.pos
            step_table[req.slot] = self.cache.table()[req.slot]
        if self._presence_dirty:       # admissions/releases since last step
            self._presence = self._presence_copy()
            self._presence_dirty = False
        if self.spec is not None:
            return self._spec_window(decoding, tokens, pos, step_table, outs)
        nxt, lp = self._step_impl(self._tensor(tokens), self._tensor(pos),
                                  self._tensor(step_table),
                                  *self._slots.arrays())
        nxt = nxt.cpu().numpy()                        # device sync
        lp = lp.cpu().numpy()
        self._occ_sum += len(decoding) / self.num_slots
        self._steps += 1
        for req in decoding:
            if sched.running.get(req.slot) is not req:
                continue
            req.tokens.append(int(nxt[req.slot]))
            # mirror the in-step presence update (device already has it)
            self._presence_np[req.slot, int(nxt[req.slot])] = True
            if req.sampling.logprobs:
                req.logprobs.append(float(lp[req.slot]))
            req.pos += 1
            self._progress(req, outs)
        return outs

    def _spec_window(self, decoding, tokens, pos, step_table,
                     outs: list[RequestOutput]) -> list[RequestOutput]:
        """One draft/verify window over the decoding slots, emitting
        1..gamma+1 tokens per slot; the emitted tokens and their counts
        come to the host in one copy."""
        sched = self._sched
        tok_t, pos_t, tab_t = (self._tensor(a)
                               for a in (tokens, pos, step_table))
        sargs = self._slots.arrays()
        prop, q_dists = self._spec_draft_impl(tok_t, pos_t, tab_t, *sargs)
        out, n_emit, lp = self._spec_verify_impl(tok_t, prop, q_dists, pos_t,
                                                 tab_t, *sargs)
        host = torch.cat([out, n_emit[:, None].to(out.dtype)], dim=1)
        host = host.cpu().numpy()                       # device sync
        out, n_emit = host[:, :-1], host[:, -1]
        if any(r.sampling.logprobs for r in decoding):
            lp = lp.cpu().numpy()
        self._occ_sum += len(decoding) / self.num_slots
        self._steps += 1
        for req in decoding:
            if sched.running.get(req.slot) is not req:
                continue
            n = int(n_emit[req.slot])
            req.spec_windows += 1
            req.spec_accepted += n - 1
            self._spec_windows += 1
            self._spec_drafted += self._gamma
            self._spec_accepted += n - 1
            took = 0
            for j in range(n):
                t = int(out[req.slot, j])
                req.tokens.append(t)
                self._presence_np[req.slot, t] = True
                if req.sampling.logprobs:
                    req.logprobs.append(float(lp[req.slot, j]))
                took += 1
                # stop/length can land mid-window: the tail tokens are never
                # emitted, and the finished slot's presence row resets on
                # release, so the device copy stays consistent
                if req.check_finish() is not None:
                    break
            req.pos += took
            self._progress(req, outs)
        return outs

    def stats(self) -> ContinuousStats:
        """The current session's outcome: every request added since the
        last ``reset`` (``run`` returns this once they all finished)."""
        requests = self._requests
        results = {r.rid: np.asarray(r.tokens[:r.max_new_tokens], np.int32)
                   for r in requests}
        per_request = {r.rid: {"preemptions": r.preemptions,
                               "chunks": r.chunks,
                               "shared_tokens": r.shared_tokens,
                               "ttft": r.ttft,
                               "tpot": r.tpot,
                               "finish_time": r.finish_time,
                               "spec_windows": r.spec_windows,
                               "spec_accepted": r.spec_accepted}
                       for r in requests}
        outputs = {r.rid: self._make_output(r, [], finished=True)
                   for r in requests}
        return ContinuousStats(
            results=results, steps=self._steps,
            occupancy=self._occ_sum / max(self._steps, 1),
            wall=self._now(),
            preemptions=sum(r.preemptions for r in requests),
            chunks=self._n_chunks,
            prefill_calls=self._prefill_calls,
            prefill_tokens=self._prefill_tokens,
            prompt_tokens=self.cache.lookup_tokens,
            prefix_hit_tokens=self.cache.hit_tokens,
            cow_events=self.cache.cow_events,
            spec_windows=self._spec_windows,
            spec_drafted=self._spec_drafted,
            spec_accepted=self._spec_accepted,
            per_request=per_request,
            outputs=outputs)

    def run(self, requests: Iterable[Request], *, defrag_every: int = 0,
            on_output: Callable[[RequestOutput], None] | None = None
            ) -> ContinuousStats:
        """Serve ``requests`` to completion; honors ``arrival_time``.
        ``on_output`` streams every ``RequestOutput`` delta as it is
        produced."""
        if self._sched is not None and self._sched.has_work():
            raise RuntimeError(
                "run() would reset the engine while incrementally-submitted "
                "requests are unfinished; drive step() to completion first")
        self.reset()
        self.defrag_every = defrag_every
        for r in requests:
            self.add_request(r)
        sched = self._sched
        while sched.has_work():
            if not sched.running:
                nxt_t = sched.next_arrival()
                if nxt_t is None:
                    break
                time.sleep(max(nxt_t - self._now(), 0.0))
            for o in self.step():
                if on_output is not None:
                    on_output(o)
        return self.stats()
