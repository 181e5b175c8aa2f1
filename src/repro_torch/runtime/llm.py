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

Every request carries its own ``SamplingParams`` and gets back a structured
``RequestOutput`` (token ids, finish_reason, optional logprobs, timing
metrics).  Only the continuous backend is ported; ``"static"`` and
``"speculative"`` raise ``NotImplementedError`` naming their ROADMAP items.
"""
from __future__ import annotations

from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from repro_torch.models.model import Model
from repro_torch.runtime import sampling
from repro_torch.runtime.engine import (
    ContinuousServeEngine, ContinuousStats, RequestOutput,
)
from repro_torch.runtime.sampling import SamplingParams
from repro_torch.runtime.scheduler import Request

BACKENDS = ("static", "continuous", "speculative")
_UNPORTED_BACKENDS = {"static": "Static ServeEngine",
                      "speculative": "Speculative decoding"}


class LLMEngine:
    """One ``generate(prompts, sampling_params)`` API over continuous
    batching (the incremental ``add_request()`` / ``step()`` interface
    streams deltas)."""

    def __init__(self, model: Model, *, backend: str = "continuous",
                 device: str | torch.device = "cuda", spec=None,
                 max_len: int | None = None, num_slots: int | None = None,
                 page_size: int | None = None, num_pages: int | None = None,
                 prefill_chunk: int | None = None,
                 enable_prefix_cache: bool = True, cache_dtype=None,
                 weight_format: str | None = None,
                 max_top_k: int = sampling.MAX_TOP_K, speculative=None,
                 default_sampling: SamplingParams | None = None, mesh=None,
                 disaggregate: bool = False):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, "
                             f"got {backend!r}")
        if backend in _UNPORTED_BACKENDS:
            raise NotImplementedError(
                f"backend={backend!r} is not ported to PyTorch yet (ROADMAP "
                f"Queue 1, '{_UNPORTED_BACKENDS[backend]}')")
        if disaggregate:
            raise NotImplementedError(
                "disaggregate=True is not ported to PyTorch yet (ROADMAP "
                "Queue 1, 'Disaggregation')")
        max_len = 256 if max_len is None else max_len
        num_slots = 8 if num_slots is None else num_slots
        page_size = 16 if page_size is None else page_size
        prefill_chunk = 64 if prefill_chunk is None else prefill_chunk
        if num_pages is None:
            num_pages = 1 + 2 * num_slots * -(-max_len // page_size)
        self.model = model
        self.default_sampling = default_sampling or sampling.GREEDY
        self.last_stats: ContinuousStats | None = None
        self._eng = ContinuousServeEngine(
            model, device=device, num_slots=num_slots, page_size=page_size,
            num_pages=num_pages, max_len=max_len, spec=spec,
            sampling_params=self.default_sampling, cache_dtype=cache_dtype,
            weight_format=weight_format, prefill_chunk=prefill_chunk,
            enable_prefix_cache=enable_prefix_cache, max_top_k=max_top_k,
            mesh=mesh, speculative=speculative)

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
        for sp in sps:
            budget = sp.max_tokens if sp.max_tokens is not None \
                else max_new_tokens
            if budget is None:
                raise ValueError("set SamplingParams.max_tokens or pass "
                                 "max_new_tokens")
            budgets.append(int(budget))
        return prompts, sps, budgets

    # -- incremental interface ----------------------------------------------
    def add_request(self, prompt, sampling_params: SamplingParams | None = None,
                    *, rid: int | None = None, max_new_tokens: int | None = None,
                    arrival_time: float = 0.0) -> int:
        """Submit one request; returns its rid.  Drive with ``step()`` until
        ``has_unfinished()`` is False."""
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
        return self._eng.step()

    def reset(self) -> None:
        """Start a new session: drop every request, page and prefix entry."""
        self._eng.reset()

    def has_unfinished(self) -> bool:
        return self._eng.has_unfinished()

    def stats(self) -> ContinuousStats:
        """Outcome of the current session (see ``ContinuousServeEngine``)."""
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
        replays a ragged arrival trace; ``on_output`` streams deltas."""
        prompts, sps, budgets = self._resolve(prompts, sampling_params,
                                              max_new_tokens)
        reqs = [Request(rid=i, prompt=prompts[i], max_new_tokens=budgets[i],
                        sampling=sps[i],
                        arrival_time=(float(arrival_times[i])
                                      if arrival_times is not None else 0.0))
                for i in range(len(prompts))]
        stats = self._eng.run(reqs, on_output=on_output)
        self.last_stats = stats
        return [stats.outputs[i] for i in range(len(prompts))]
