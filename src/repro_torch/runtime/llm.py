"""``LLMEngine`` — the request-level generation front-end of the port.

    model = Model(get_config("llama3-8b")).init(seed=0)       # on the card
    llm = LLMEngine(model, backend="continuous", max_len=2048, num_slots=8)
    outs = llm.generate(prompts, SamplingParams(temperature=0.8, top_p=0.9,
                                                seed=7, max_tokens=64))

Quantized serving (MXFP4 projections through the MXFP4 VMM kernel, fp8 or
int8 paged KV with per-token scales; the caller's ``model`` is left as it
was)::

    llm = LLMEngine(model, backend="continuous", weight_format="mxfp4",
                    cache_dtype="fp8", max_len=2048, num_slots=8)

Static-batch serving over a dense KV cache (one prompt length per call;
on the card the flash-attention kernel runs every prefill layer and the
dense decode kernel every decode layer)::

    llm = LLMEngine(model, backend="static", max_len=2048)

Speculative decoding, two ways.  Scheduler-integrated in the continuous
engine (draft/verify windows over the paged pools; on the card the verify
step runs the exact-accumulator paged kernel)::

    llm = LLMEngine(model, backend="continuous", max_len=2048,
                    speculative=SpeculativeConfig(gamma=4))   # self-draft

and the legacy batch-1 backend over the dense caches, one prompt at a time
(``draft_model=None`` drafts with the target itself)::

    llm = LLMEngine(model, backend="speculative", draft_model=draft,
                    gamma=8, max_len=2048)

Disaggregated serving: the continuous backend split into a prefill-phase
and a decode-phase engine joined by a KV-page handoff (``runtime/engine.py``:
``DisaggServeEngine``); on one card both engines share it::

    llm = LLMEngine(model, backend="continuous", max_len=2048, num_slots=8,
                    disaggregate=True, prefill_slots=4)
    llm.generate(prompts, sps)
    s = llm.last_stats        # handoffs, handoff_pages, handoff_bytes, ...

Every backend can be sized from a hardware point instead of hand-tuned
knobs (``runtime/deployment.py``; explicit kwargs still win)::

    spec = DeploymentSpec(sku="h100", weight_format="mxfp4",
                          cache_dtype="fp8", max_len=4096)
    llm = LLMEngine(model, spec=spec)
    print(llm.deployment.describe())

Every request carries its own ``SamplingParams`` and gets back a structured
``RequestOutput`` (token ids, finish_reason, optional logprobs, timing
metrics).  All three backends are ported; the static and continuous ones
also score prompts (``SamplingParams.prompt_logprobs``: ``Model.forward``
on the static backend, the scored prefill chunk on the continuous one).
Models with SSM state (mamba2-370m, hymba-1.5b) serve through the
continuous and static backends; speculation of either kind refuses them,
as in the reference (recurrent state cannot rewind).
"""
from __future__ import annotations

from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.runtime import sampling
from repro_torch.runtime.engine import (
    ContinuousServeEngine, ContinuousStats, DisaggServeEngine, RequestOutput,
    ServeEngine,
)
from repro_torch.runtime.sampling import SamplingParams
from repro_torch.runtime.scheduler import Request
from repro_torch.runtime.speculative import SpeculativeEngine

BACKENDS = ("static", "continuous", "speculative")


def _truncate(tokens: list[int], sp: SamplingParams,
              budget: int) -> tuple[list[int], str]:
    """Apply stop-token / budget finish semantics to a pre-generated
    stream (the static loop and speculative windows have fixed trip
    counts; the host applies the finish reason afterwards)."""
    tokens = tokens[:budget]
    for j, t in enumerate(tokens):
        if t in sp.stop_token_ids:
            return tokens[:j + 1], "stop"
    return tokens, "length"


class LLMEngine:
    """One ``generate(prompts, sampling_params)`` API over continuous,
    static and speculative execution (the continuous backend's incremental
    ``add_request()`` / ``step()`` interface streams deltas)."""

    def __init__(self, model: Model, *, backend: str = "continuous",
                 device: str | torch.device = "cuda", spec=None,
                 max_len: int | None = None, num_slots: int | None = None,
                 page_size: int | None = None, num_pages: int | None = None,
                 prefill_chunk: int | None = None,
                 enable_prefix_cache: bool = True, cache_dtype=None,
                 weight_format: str | None = None,
                 max_top_k: int = sampling.MAX_TOP_K,
                 draft_model: Model | None = None, gamma: int = 8,
                 speculative=None,
                 default_sampling: SamplingParams | None = None, mesh=None,
                 disaggregate: bool = False, prefill_mesh=None,
                 decode_mesh=None, prefill_slots: int | None = None,
                 prefill_pages: int | None = None):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, "
                             f"got {backend!r}")
        if disaggregate and backend != "continuous":
            raise ValueError("disaggregate=True splits the continuous "
                             "backend into phase engines; other backends "
                             "have no prefill/decode split to make")
        if mesh is not None and backend != "continuous":
            raise ValueError("mesh= shards the continuous paged serve path "
                             "only")
        if spec is not None and spec.mesh is not None \
                and backend != "continuous":
            raise ValueError("spec.mesh shards the continuous backend only")
        if speculative is not None and backend != "continuous":
            raise ValueError(
                "speculative= configures scheduler-integrated speculation "
                "in the continuous engine; the legacy 'speculative' "
                "backend takes draft_model=/gamma= directly")
        if spec is None:
            # the hand-tuned knob defaults
            max_len = 256 if max_len is None else max_len
            num_slots = 8 if num_slots is None else num_slots
            page_size = 16 if page_size is None else page_size
            prefill_chunk = 64 if prefill_chunk is None else prefill_chunk
        elif max_len is None:
            max_len = spec.max_len
        self.model = model
        self.backend = backend
        self.max_len = max_len
        self.default_sampling = default_sampling or sampling.GREEDY
        self.last_stats: ContinuousStats | None = None
        if backend == "speculative":
            # with no draft the target drafts for itself: every window
            # accepts, and the output is the target-only stream
            if weight_format is not None:
                raise ValueError("weight_format= serves the continuous and "
                                 "static backends")
            dev = resolve_device(device)
            wdev = next(model.parameters()).device
            if wdev.type != dev.type or dev.index not in (None, wdev.index):
                raise ValueError(f"model weights are on {wdev}, the engine "
                                 f"was asked to run on {dev}")
            self.draft_model = draft_model or model
            self.gamma = gamma
            # a DeploymentSpec sizes this backend's max_len; the budget is
            # priced with the draft's weights and pool bytes, and kept for
            # inspection
            self._speculative_deployment = (
                spec.resolve(model, params=model, draft=self.draft_model,
                             draft_params=self.draft_model, gamma=gamma)
                if spec is not None else None)
            self._spec = SpeculativeEngine(self.draft_model, model,
                                           gamma=gamma,
                                           cache_dtype=cache_dtype)
            self._eng = None
            return
        if backend == "static":
            self._eng = ServeEngine(
                model, device=device, max_len=max_len, spec=spec,
                sampling_params=self.default_sampling,
                cache_dtype=cache_dtype, weight_format=weight_format,
                max_top_k=max_top_k)
            return
        if spec is None and num_pages is None:
            num_pages = 1 + 2 * num_slots * -(-max_len // page_size)
        if disaggregate:
            self._eng = DisaggServeEngine(
                model, device=device, num_slots=num_slots,
                page_size=page_size, num_pages=num_pages, max_len=max_len,
                spec=spec,
                prefill_mesh=prefill_mesh if prefill_mesh is not None
                else mesh,
                decode_mesh=decode_mesh if decode_mesh is not None else mesh,
                prefill_slots=prefill_slots, prefill_pages=prefill_pages,
                sampling_params=self.default_sampling,
                cache_dtype=cache_dtype, weight_format=weight_format,
                prefill_chunk=prefill_chunk,
                enable_prefix_cache=enable_prefix_cache,
                max_top_k=max_top_k, speculative=speculative)
            return
        self._eng = ContinuousServeEngine(
            model, device=device, num_slots=num_slots, page_size=page_size,
            num_pages=num_pages, max_len=max_len, spec=spec,
            sampling_params=self.default_sampling, cache_dtype=cache_dtype,
            weight_format=weight_format, prefill_chunk=prefill_chunk,
            enable_prefix_cache=enable_prefix_cache, max_top_k=max_top_k,
            mesh=mesh, speculative=speculative)

    @property
    def deployment(self):
        """The resolved ``DeploymentSpec`` budget (None without spec=)."""
        if self._eng is None:              # legacy speculative backend
            return self._speculative_deployment
        return self._eng.deployment

    def kv_token_bytes_per_device(self) -> int:
        """Pool bytes one cached token costs (continuous only)."""
        if self.backend != "continuous":
            raise ValueError("KV accounting needs backend='continuous'")
        return self._eng.kv_token_bytes_per_device()

    # -- request plumbing ---------------------------------------------------
    def _resolve(self, prompts, sampling_params, max_new_tokens):
        prompts = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
        n = len(prompts)
        if sampling_params is None:
            sps = [self.default_sampling] * n
        elif isinstance(sampling_params, SamplingParams):
            sps = [sampling_params] * n
        else:
            sps = list(sampling_params)
            if len(sps) != n:
                raise ValueError(f"{len(sps)} SamplingParams for "
                                 f"{n} prompts")
        budgets = []
        for p, sp in zip(prompts, sps):
            budget = sp.max_tokens if sp.max_tokens is not None \
                else max_new_tokens
            if budget is None:
                raise ValueError("set SamplingParams.max_tokens or pass "
                                 "max_new_tokens")
            # the continuous engine enforces its own (page-rounded)
            # capacity in add_request; static caches are exactly max_len
            if (self.backend != "continuous"
                    and p.shape[0] + budget > self.max_len):
                raise ValueError(f"max_tokens={budget} exceeds max_len="
                                 f"{self.max_len} for a {p.shape[0]}-token "
                                 f"prompt")
            budgets.append(int(budget))
        return prompts, sps, budgets

    def _continuous(self, what: str) -> None:
        if self.backend != "continuous":
            raise ValueError(f"{what} needs backend='continuous'")

    # -- incremental interface ----------------------------------------------
    def add_request(self, prompt, sampling_params: SamplingParams | None = None,
                    *, rid: int | None = None, max_new_tokens: int | None = None,
                    arrival_time: float = 0.0) -> int:
        """Submit one request; returns its rid.  Drive with ``step()`` until
        ``has_unfinished()`` is False (continuous backend)."""
        self._continuous("add_request()/step()")
        (prompt,), (sp,), (budget,) = self._resolve(
            [prompt], sampling_params, max_new_tokens)
        if rid is None:
            rid = getattr(self, "_next_rid", 0)
        # explicit low rids must never rewind the auto-rid counter into
        # collision with live requests
        self._next_rid = max(getattr(self, "_next_rid", 0), rid + 1)
        self._eng.add_request(Request(rid=rid, prompt=prompt,
                                      max_new_tokens=budget, sampling=sp,
                                      arrival_time=arrival_time))
        return rid

    def step(self) -> list[RequestOutput]:
        self._continuous("add_request()/step()")
        return self._eng.step()

    def reset(self) -> None:
        """Start a new session: drop every request, page and prefix entry."""
        self._continuous("reset()")
        self._eng.reset()

    def has_unfinished(self) -> bool:
        return self.backend == "continuous" and self._eng.has_unfinished()

    def stats(self) -> ContinuousStats:
        """Outcome of the current session (see ``ContinuousServeEngine``)."""
        self._continuous("stats()")
        return self._eng.stats()

    # -- one-shot interface -------------------------------------------------
    def generate(self, prompts: Iterable, sampling_params=None, *,
                 max_new_tokens: int | None = None,
                 arrival_times: Sequence[float] | None = None,
                 on_output: Callable[[RequestOutput], None] | None = None
                 ) -> list[RequestOutput]:
        """Generate for ``prompts`` (sequences of token ids); returns one
        final ``RequestOutput`` per prompt, in order.  ``sampling_params``:
        one ``SamplingParams`` or a per-prompt list; ``arrival_times``
        (continuous only) replays a ragged arrival trace; ``on_output``
        streams deltas (continuous) or final outputs (static)."""
        prompts, sps, budgets = self._resolve(prompts, sampling_params,
                                              max_new_tokens)
        if arrival_times is not None and self.backend != "continuous":
            raise ValueError("arrival_times needs backend='continuous'")
        if self.backend == "static":
            return self._generate_static(prompts, sps, budgets, on_output)
        if self.backend == "speculative":
            return self._generate_speculative(prompts, sps, budgets,
                                              on_output)
        reqs = [Request(rid=i, prompt=prompts[i], max_new_tokens=budgets[i],
                        sampling=sps[i],
                        arrival_time=(float(arrival_times[i])
                                      if arrival_times is not None else 0.0))
                for i in range(len(prompts))]
        stats = self._eng.run(reqs, on_output=on_output)
        self.last_stats = stats
        return [stats.outputs[i] for i in range(len(prompts))]

    def _generate_static(self, prompts, sps, budgets, on_output):
        lens = {p.shape[0] for p in prompts}
        if len(lens) != 1:
            raise ValueError(
                "backend='static' batches one prompt length per call "
                f"(got {sorted(lens)}); use backend='continuous' for "
                "ragged prompts")
        eng = self._eng
        batch = torch.as_tensor(np.stack(prompts), device=eng.device)
        res = eng.generate({"tokens": batch}, max_new_tokens=max(budgets),
                           sampling_params=sps)
        plps = None
        if any(sp.prompt_logprobs for sp in sps):
            # score the prompt with one forward: position k's log-softmax
            # row scores prompt token k+1 (raw model scores — the
            # generation-side processors don't apply to the prompt)
            logits = eng.model.forward(batch)
            ls = torch.log_softmax(logits.float(), dim=-1)
            plps = torch.gather(ls[:, :-1], -1,
                                batch[:, 1:, None].long())[..., 0].cpu()
        toks = res.tokens.cpu().numpy()
        lps_all = res.logprobs.cpu().numpy() if res.logprobs is not None \
            else None
        tpot = res.decode_s / max(res.steps - 1, 1)
        outs = []
        for i, sp in enumerate(sps):
            ids, reason = _truncate([int(t) for t in toks[i]], sp, budgets[i])
            out = RequestOutput(
                rid=i, new_token_ids=list(ids), token_ids=list(ids),
                finished=True, finish_reason=reason,
                logprobs=([float(v) for v in lps_all[i, :len(ids)]]
                          if sp.logprobs else None),
                prompt_logprobs=([float(v) for v in plps[i]]
                                 if sp.prompt_logprobs else None),
                metrics={"ttft": res.prefill_s, "tpot": tpot})
            outs.append(out)
            if on_output is not None:
                on_output(out)
        return outs

    def _generate_speculative(self, prompts, sps, budgets, on_output):
        for sp in sps:
            if sp.repetition_penalty != 1.0 or sp.logit_bias:
                raise ValueError(
                    "backend='speculative' does not support "
                    "repetition_penalty/logit_bias (the continuous "
                    "engine's speculative= mode does — its verify step "
                    "threads the running presence through p and q)")
            if sp.prompt_logprobs:
                raise ValueError(
                    "backend='speculative' does not score prompts; use "
                    "backend='static' or 'continuous' for prompt_logprobs")
        outs = []
        for i, (p, sp, budget) in enumerate(zip(prompts, sps, budgets)):
            stats = self._spec.generate(
                torch.as_tensor(p)[None], max_new_tokens=budget,
                sampling_params=sp)
            ids, reason = _truncate([int(t) for t in stats.tokens[:budget]],
                                    sp, budget)
            out = RequestOutput(
                rid=i, new_token_ids=list(ids), token_ids=list(ids),
                finished=True, finish_reason=reason, logprobs=None,
                metrics={"windows": stats.windows,
                         "accepted_per_window": stats.mean_accepted})
            outs.append(out)
            if on_output is not None:
                on_output(out)
        return outs
