"""Serving engines: static batch over a dense KV cache, and continuous
batching over a block-paged one.

``ServeEngine`` is the port of the reference's static-batch engine:
prefill and decode are separate entry points, the whole batch shares one
prompt length and one position, and the reference's one jitted
``lax.scan`` over decode steps is a Python loop of ``Model.decode_step``
and the per-row sampler here (same ``pos + 1`` sampling positions, same
presence rows).  On CUDA every prefill attention is the hand-written flash
kernel and every decode attention the dense decode kernel.

On a mesh (``mesh=`` / ``plan=``) the static engine runs ``make_plan``'s
decode, prefill and long_decode plans (``parallel/serve.py``): each rank
stores its shards of the weights and of the dense caches (context
parallel, the sequence split), MoE runs expert-parallel, and every rank
returns the whole batch's tokens.

``ContinuousServeEngine`` is the port of the reference's continuous engine
for one device, over full-KV and sliding-window (ring-page) layouts.
Requests arrive raggedly;
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

Sizing: ``spec=DeploymentSpec(...)`` (``runtime/deployment.py``) derives
the pool and slot knobs of both engines from a hardware point's memory
budget and bandwidth roofline (the draft's weights and pool bytes priced
in under ``speculative=``); explicit kwargs override single values, and
the resolved budget is kept on ``self.deployment``.  The continuous
engine's ``max_decode_slots`` (the spec's bandwidth-knee admission hint)
caps how many requests hold a slot at once.

Prompt scoring: a request with ``SamplingParams.prompt_logprobs`` admits
through ``Model.prefill_chunk_scored_paged``, which keeps every chunk
position's logits on the device until each row's prompt-token scores are
taken; the first token comes from the same head call as an unscored
admission's.

Sliding-window layers (``runtime/state_cache.py``): a model whose
segments carry a window keeps their pages in a ``RingPageSpace`` of its
own, sized by ``ring_pages_needed`` so that backing a chunk never fails;
each prefilling slot's ring grows to its chunk's frontier before the table
snapshot, and the pages wholly behind the window return to the ring
allocator after every chunk and decode step, so a slot holds O(window)
pages however long it runs.  With no full-KV segment the prefix cache is
off.  As in the reference, a ring layout refuses ``speculative=`` and a
disaggregated ``phase`` (ring pages cannot rewind or hand off).

SSM state (mamba2, hymba): ``reset`` builds one state row a slot in
every stateful layer (``Model.init_state_pools``); each prefill chunk
names its rows' slots (a row that starts at position 0, an admission or a
preemption restart, reads a zero state inside the step), and each decode
step commits only the slots that decode in it (``state_ok``).  With
full-KV layers too (hymba) a prefix hit shares pages for capacity but
the prompt is recomputed (``recompute_shared``), as the state must be
rebuilt.  A state-carrying model refuses a quantized ``cache_dtype``,
``mesh=``, ``speculative=`` and a disaggregated ``phase``, in the
reference's words.

Disaggregated serving (``DisaggServeEngine``, ``LLMEngine(disaggregate=
True)``): a prefill-phase and a decode-phase ``ContinuousServeEngine``
(``phase="prefill"`` / ``"decode"``, each sized by its own
``DeploymentSpec.resolve(phase=)``) joined by a ``KVHandoff``.  A prefill
engine parks each finished chain in ``HANDOFF``; the handoff admits it on
the decode side (a decode-side prefix hit skips the matching pages),
gathers the other pages' rows of every pool leaf (scale leaves of fp8/int8
pools, the draft's pools under ``speculative=``) into one host buffer and
scatters them into the decode pools: device -> host -> device, one copy
each way a chain.  On one card both engines share the device and its
current stream.  A decode-side preemption drains back to the prefill
engine, which recomputes the chain and hands it off again.  Stateful
layouts refuse a phase split in the reference's words.

Disaggregation across meshes: each phase engine may run on a mesh, one
mesh for both (every rank runs both engines on its shards) or two disjoint
slices of one (``parallel.plan.split_mesh``), each with its own TP degree.
On slices a rank builds its own phase's local model and pools only; the
other phase's engine on that rank is a mirror (``member`` False: no model,
no pools) that books the same schedule from the results the phase's first
rank broadcasts after every device call (``PhaseLink``, over the gloo
group of both slices), so every decision that crosses the groups (the
chains handed off each step, the decode side's admissions, preemptions
drained back, the clock) is the same on every serving rank.  The handoff
then moves pages between the groups: each prefill rank sends each decode
rank of its data row the KV heads their two shards share (GQA codes and
scales split by head, MLA's latents whole), staged through the host over
that group (``KVHandoff``).

Tensor-parallel serving (``mesh=``, a ``DeviceMesh`` with dims ``("data",
"model")`` from ``launch/mesh.py``, or a "DxM" spec, given or a
``DeploymentSpec``'s, that the engine builds into one): SPMD,
one process per rank, every rank running this same host loop.  The rank
builds its local model (``PagedServePlan.local_model``: its heads, its
d_ff slice, the closing weights whole in "gather" mode or row-sharded in
"psum" mode; quantized after slicing) and its own pools at local KV heads
(one replicated head under ``kv_repl``); each step runs inside
``parallel.hints.manual_tp_axis``, whose marks close every column/row pair
with one all-gather or all-reduce over the mesh's ``model`` group.  Logits
come back whole on every rank, so every rank samples the same tokens.
Ranks must agree on every scheduling decision: the one clock reading the
scheduler acts on (admission, and through ``admit_time`` the choice of a
preemption victim) is group rank 0's, broadcast at every step.  A
separate speculative draft gets its own plan; stateful layouts refuse
``mesh=`` in the reference's words.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Callable, Iterable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import device_mesh
from repro_torch.models.model import Model, dense_cache_dtype
from repro_torch.parallel.hints import (
    TPComm, manual_tp_axis, serve_layout, vocab_gather,
)
from repro_torch.quant import kv as kvq
from repro_torch.quant.linear import packed_leaves, quantize_params
from repro_torch.runtime import sampling
from repro_torch.runtime.kv_cache import PagedKVCache
from repro_torch.runtime.sampling import SamplingParams
from repro_torch.runtime.scheduler import HANDOFF, RUNNING, Request, Scheduler
from repro_torch.runtime.speculative import SpeculativeConfig, _check_rewindable
from repro_torch.runtime.state_cache import (
    RingPageSpace, model_cache_layout, ring_pages_needed,
)


def _rank_plan(cfg, mesh, tp_reduce: str, comm: TPComm | None = None,
               member: bool = True):
    """The serve plan of ``cfg`` on ``mesh`` and this rank's collectives
    over its ``model`` group (``comm`` when the caller has them; None on a
    rank outside the mesh)."""
    from repro_torch.parallel.plan import make_paged_serve_plan
    plan = make_paged_serve_plan(cfg, mesh, reduce=tp_reduce)
    if not member:
        return plan, None
    return plan, comm or TPComm(mesh.get_group(plan.axis))


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
    reference: the dense cache stays a plain dtype.  ``spec=`` (a
    ``DeploymentSpec``) supplies ``max_len``, ``cache_dtype`` and
    ``weight_format`` where they are not passed.

    A batch is the reference's dict: ``{"tokens"}``, a vision model's
    ``{"tokens", "image_embeds"}`` (the image positions come first and
    count in the prompt length and the cache) or an audio model's
    ``{"features"}`` (prefill only: an encoder has no decode step).

    On a mesh (``mesh=``: a ``DeviceMesh`` over the initialised world, or
    a "DxM" spec to build one; or ``plan=``, a serving ``ParallelPlan`` of
    one): SPMD, every rank calls ``generate`` with the same batch.
    ``make_plan(cfg, mesh, shape_kind=)`` chooses the plan (``shape_kind``
    "decode", "prefill" or "long_decode"; for a batch the mesh's DP axes
    split: ``plan=`` gives another), and
    ``parallel.serve.ServeLayout`` executes it: the rank keeps its shards
    of the weights (sliced from ``model``, which the caller may then free;
    ``self.model`` is its ``meta`` skeleton) and of every cache, and
    ``generate`` returns the whole batch's tokens and log-probs on every
    rank."""

    def __init__(self, model: Model, *, device: str | torch.device = "cuda",
                 max_len: int | None = None, spec=None,
                 sampling_params: SamplingParams | None = None,
                 cache_dtype=None, weight_format: str | None = None,
                 max_top_k: int = sampling.MAX_TOP_K, mesh=None, plan=None,
                 shape_kind: str = "decode"):
        dev = resolve_device(device)
        wdev = next(model.parameters()).device
        if wdev.type != dev.type or dev.index not in (None, wdev.index):
            raise ValueError(f"model weights are on {wdev}, the engine was "
                             f"asked to run on {dev}")
        self.device = wdev
        self.deployment = None
        if spec is not None:        # DeploymentSpec (runtime.deployment)
            dep = spec.resolve(model, params=model, device=wdev)
            self.deployment = dep
            max_len = dep.max_len if max_len is None else max_len
            cache_dtype = dep.cache_dtype if cache_dtype is None \
                else cache_dtype
            weight_format = spec.weight_format if weight_format is None \
                else weight_format
        if max_len is None:
            raise ValueError("pass max_len= or a DeploymentSpec via spec=")
        cache_dtype = dense_cache_dtype(cache_dtype)     # refuses fp8/int8
        self.weight_format = weight_format
        self.layout = None
        if mesh is not None or plan is not None:
            self.layout = _serve_layout(model, mesh, plan, shape_kind,
                                        weight_format)
            skeleton = Model(model.cfg, device="meta",
                             moe_impl=model.moe_impl)
            skeleton.device = wdev
            model = skeleton
        elif weight_format is not None:
            model = quantize_params(model, weight_format)
        self.model = model
        self.max_len = int(max_len)
        self.default_sampling = sampling_params or sampling.GREEDY
        self.max_top_k = int(max_top_k)
        self.cache_dtype = cache_dtype

    # -- phase 1: prefill ---------------------------------------------------
    def prefill(self, batch: dict):
        """Run the prompt; returns (first_token_logits, cache, prompt_len),
        the prompt length counting a vision batch's image positions."""
        return self._prefill(self._inputs(batch))

    def _prefill(self, inputs: dict):
        first = inputs["features" if "features" in inputs else "tokens"]
        if self.layout is None:
            cache = self.model.init_cache(first.shape[0], self.max_len,
                                          dtype=self.cache_dtype)
        else:
            cache = self.layout.init_cache(self.model, first.shape[0],
                                           self.max_len, self.cache_dtype)
        with self._region():
            logits = self.model.prefill(inputs, cache)
        return logits, cache, _prompt_len(inputs)

    def _region(self):
        """The serving layout's scope (nothing off a mesh)."""
        if self.layout is None:
            return contextlib.nullcontext()
        return serve_layout(self.layout)

    def forward(self, batch) -> torch.Tensor:
        """``Model.forward``'s (B, S, V) logits of ``batch`` (a token
        tensor: prompt scoring); on a mesh each rank runs its rows, and
        every rank gets every row's logits."""
        lay = self.layout
        if lay is not None:
            batch = lay.local_rows({"tokens": batch})["tokens"]
        with torch.no_grad(), self._region():
            logits = vocab_gather(self.model.forward(batch))
        return logits if lay is None else lay.gather_rows(logits)

    def _inputs(self, batch: dict) -> dict:
        """``batch``'s arrays as tensors on the engine's device."""
        if set(batch) not in ({"tokens"}, {"tokens", "image_embeds"},
                              {"features"}):
            raise ValueError(f"batch keys {sorted(batch)}: expected tokens, "
                             f"tokens + image_embeds, or features")
        out = {}
        for key, a in batch.items():
            t = a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
            out[key] = t.to(self.device)
        return out

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
        inputs = self._inputs(batch)
        tokens = inputs.get("tokens")
        b = inputs["features" if tokens is None else "tokens"].shape[0]
        plen = _prompt_len(inputs)
        if plen + max_new_tokens > self.max_len:
            raise ValueError(f"{plen}-token prompts + {max_new_tokens} new "
                             f"tokens exceed max_len={self.max_len}")
        sps = self._resolve_params(b, sampling_params)
        lay = self.layout
        if lay is not None:              # the rank's rows of the batch
            inputs = lay.local_rows(inputs)
            tokens = inputs.get("tokens")
            n, i = lay.batch_comm.size, lay.batch_comm.rank
            b //= n
            sps = sps[i * b:(i + 1) * b]
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
        if tokens is not None:
            pres.index_put_((rows[:, None], tokens.long()), true)
        kw = dict(max_top_k=self.max_top_k, rep_penalty=rep,
                  bias_ids=bias_ids, bias_vals=bias_vals, presence=pres)
        t0 = time.monotonic()
        logits, cache, plen = self._prefill(inputs)
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
            with self._region():
                logits = self.model.decode_step(nxt, cache, pos)
            # the token being generated sits at sequence index pos + 1
            draw_pos.add_(1)
            nxt, lp = sampling.sample_slots(logits, temp, topk, topp, minp,
                                            seed, draw_pos, **kw)
            toks.append(nxt)
            lps.append(lp)
        all_toks = torch.stack(toks, dim=1)
        all_lps = torch.stack(lps, dim=1)
        if lay is not None:              # every row, on every rank
            all_toks, all_lps = (lay.gather_rows(all_toks),
                                 lay.gather_rows(all_lps))
            sps = self._resolve_params(all_toks.shape[0], sampling_params)
        _sync(dev)
        return GenerationResult(
            tokens=all_toks,
            logprobs=(all_lps if any(sp.logprobs for sp in sps) else None),
            steps=max_new_tokens, prefill_s=t1 - t0,
            decode_s=time.monotonic() - t1)


def _serve_layout(model, mesh, plan, shape_kind: str, weight_format):
    """The ``ServeLayout`` of ``model`` on ``mesh`` (``make_plan``'s plan of
    ``shape_kind`` for a batch the mesh's DP axes split), or of ``plan``."""
    from repro_torch.parallel.plan import axis_size, make_plan
    from repro_torch.parallel.serve import ServeLayout
    if plan is None:
        mesh = device_mesh(mesh, model.device)
        if shape_kind not in ("decode", "prefill", "long_decode"):
            raise ValueError(f"shape_kind={shape_kind!r}: a serving plan is "
                             f"'decode', 'prefill' or 'long_decode'")
        names = tuple(mesh.mesh_dim_names)
        global_batch = math.prod(axis_size(mesh, a) for a in names
                                 if a in ("pod", "data"))
        plan = make_plan(model.cfg, mesh, global_batch=global_batch,
                         shape_kind=shape_kind)
    if next(packed_leaves(model), None) is not None:
        raise ValueError("a mesh engine takes the unquantized model; "
                         "weight_format= packs each rank's regions")
    return ServeLayout(model, plan, weight_format=weight_format)


def _prompt_len(inputs: dict) -> int:
    """Positions of a static prompt: its tokens after a vision batch's
    image embeddings, or an audio batch's frames."""
    if "features" in inputs:
        return inputs["features"].shape[1]
    n = inputs["tokens"].shape[1]
    if "image_embeds" in inputs:
        n += inputs["image_embeds"].shape[1]
    return n


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
    # -- disaggregated serving (all zero on a colocated engine) --
    handoffs: int = 0             # chains transferred prefill -> decode
    handoff_pages: int = 0        # pages physically moved
    handoff_bytes: int = 0        # pool bytes moved (all leaves, both sets)
    handoff_shared_tokens: int = 0  # transfer skipped via decode-side prefix
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
    def prefix_hit_rate(self) -> float:
        return self.prefix_hit_tokens / max(self.prompt_tokens, 1)

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

    def ttft_quantiles(self) -> tuple[float, float, float] | None:
        """(p50, p99, mean) time-to-first-token in seconds, or None."""
        q = self.latency_quantiles("ttft")
        if q is None:
            return None
        return q["p50"], q["p99"], q["mean"]


class ContinuousServeEngine:
    """Iteration-level continuous batching over a block-paged KV cache.

    The decode step has a fixed slot batch; per-slot page tables and ragged
    positions route each slot's K/V stream through the physical page pools
    (``Model.decode_step_paged``), and the per-slot sampler draws each
    slot's next token in the same step.  Drive it incrementally
    (``add_request`` then ``step`` until ``has_unfinished()`` is False) or
    in batch via ``run(requests, on_output=...)``.  With ``speculative=``
    each step over the decoding slots is one draft/verify window instead.

    Sizing: pass a ``DeploymentSpec`` via ``spec=`` and the pool and slot
    knobs (``num_pages``, ``num_slots``, ``page_size``, ``max_len``,
    ``prefill_chunk``, ``cache_dtype``, ``weight_format`` and the
    scheduler's ``max_decode_slots``) derive from its hardware point;
    explicit kwargs override single values.  The resolved budget is kept
    on ``self.deployment``.

    ``phase``: "colocated" (the default) serves whole requests; "prefill"
    and "decode" are the two halves of a ``DisaggServeEngine``, which
    drives them (their ``run()`` refuses): a prefill engine parks each
    finished chain in ``HANDOFF``, a decode engine admits only through the
    handoff seam (``admit_handoff`` ... ``release_handoff``).  A phase
    engine on a mesh slice this rank is not in (``member`` False) is that
    phase's mirror: it keeps the schedule, and the tokens come from the
    phase's ranks (``PhaseLink``).
    """

    def __init__(self, model: Model, *, device: str | torch.device = "cuda",
                 num_slots: int | None = None, page_size: int | None = None,
                 num_pages: int | None = None, max_len: int | None = None,
                 spec=None, sampling_params: SamplingParams | None = None,
                 cache_dtype=None, weight_format: str | None = None,
                 prefill_chunk: int | None = None,
                 enable_prefix_cache: bool = True,
                 max_top_k: int = sampling.MAX_TOP_K,
                 mesh=None, tp_reduce: str = "auto",
                 max_decode_slots: int | None = None,
                 speculative: SpeculativeConfig | None = None,
                 phase: str = "colocated"):
        if model.cfg.frontend is not None:
            raise NotImplementedError(
                "continuous batching serves token frontends only")
        if phase not in ("colocated", "prefill", "decode"):
            raise ValueError(f"phase={phase!r}: expected 'colocated', "
                             f"'prefill', or 'decode'")
        self.phase = phase
        dev = resolve_device(device)
        wdev = next(model.parameters()).device
        if wdev.type != dev.type or dev.index not in (None, wdev.index):
            raise ValueError(f"model weights are on {wdev}, the engine was "
                             f"asked to run on {dev}")
        self.device = wdev
        # -- stateful cache layouts (runtime.state_cache): SSM/hybrid state
        # pools and ring-page reclamation for sliding-window layers; the
        # reference's refusals --
        lay = model_cache_layout(model.plan)
        self._layout = lay
        if lay.stateful:
            arch = model.cfg.name
            if speculative is not None:
                raise NotImplementedError(
                    f"speculative decoding is unsupported for {arch!r}: "
                    f"draft/verify rewinds token-indexed KV pages, but "
                    f"recurrent SSM state and reclaimed ring pages cannot "
                    f"rewind (recorded follow-on)")
            if phase != "colocated":
                raise NotImplementedError(
                    f"disaggregated serving is unsupported for {arch!r}: "
                    f"the KV handoff moves page chains only — recurrent "
                    f"state and ring residency need their own transfer "
                    f"(recorded follow-on)")
        if lay.has_state:
            if kvq.is_quantized_cache_dtype(cache_dtype):
                raise NotImplementedError(
                    f"cache_dtype={cache_dtype!r} is unsupported for the "
                    f"state-carrying arch {model.cfg.name!r}: SSM state "
                    f"pools stay bf16/f32 — quantized state is a recorded "
                    f"follow-on")
        mesh = mesh if mesh is not None else getattr(spec, "mesh", None)
        if mesh is not None:
            if lay.has_state:
                raise NotImplementedError(
                    f"tensor-parallel serving of the state-carrying arch "
                    f"{model.cfg.name!r} needs sharded state pools "
                    f"(recorded follow-on); run it single-device")
            # a "DxM" spec becomes this engine's DeviceMesh over the
            # initialised world
            mesh = device_mesh(mesh, wdev)
        # -- DeploymentSpec resolution: pool/slot knobs derived from the
        # hardware point; explicit kwargs override individual values --
        self.deployment = None
        if spec is not None:
            rkw = {}
            if speculative is not None:
                # the draft's weights join the capacity split, and every
                # logical page carries both pool sets' bytes (a self-draft
                # or a truncated draft is priced as a second set of
                # weights, as the reference prices it)
                draft = speculative.draft_model or model
                rkw = dict(draft=draft, draft_params=draft,
                           gamma=speculative.gamma)
            dep = spec.resolve(model, params=model, mesh=mesh, phase=phase,
                               device=wdev, **rkw)
            self.deployment = dep
            mesh = dep.mesh
            if tp_reduce == "auto":
                tp_reduce = dep.tp_reduce
            num_slots = dep.num_slots if num_slots is None else num_slots
            page_size = dep.page_size if page_size is None else page_size
            num_pages = dep.num_pages if num_pages is None else num_pages
            max_len = dep.max_len if max_len is None else max_len
            prefill_chunk = dep.prefill_chunk if prefill_chunk is None \
                else prefill_chunk
            cache_dtype = dep.cache_dtype if cache_dtype is None \
                else cache_dtype
            weight_format = spec.weight_format if weight_format is None \
                else weight_format
            max_decode_slots = dep.max_decode_slots \
                if max_decode_slots is None else max_decode_slots
        missing = [k for k, v in (("num_slots", num_slots),
                                  ("page_size", page_size),
                                  ("num_pages", num_pages),
                                  ("max_len", max_len)) if v is None]
        if missing:
            raise ValueError(
                f"pass a DeploymentSpec via spec= or the explicit knobs "
                f"{missing}")
        prefill_chunk = 64 if prefill_chunk is None else prefill_chunk
        # -- tensor parallelism: this rank's local model and TP group; the
        # pricing reads the full config (a meta model: no storage).  A
        # rank outside the mesh (a phase slice of split_mesh it is not in)
        # is no member: it builds no model and no pools, and only mirrors
        # the phase's schedule for a DisaggServeEngine --
        self.mesh = mesh
        self.member = mesh is None or mesh.get_coordinate() is not None
        if not self.member and phase == "colocated":
            raise ValueError("this rank is not in the engine's mesh: a "
                             "colocated engine serves on its own ranks")
        self.serve_plan = None
        self._tp: TPComm | None = None
        self._link: PhaseLink | None = None     # set by DisaggServeEngine
        self._stamp = 0.0       # the clock after the last device call
        self._price_model = model
        if mesh is not None:
            self._price_model = Model(model.cfg, device="meta",
                                      moe_impl=model.moe_impl)
            if self.member:
                self.serve_plan, self._tp = _rank_plan(model.cfg, mesh,
                                                       tp_reduce)
                model = self.serve_plan.local_model(model)
            else:
                self.serve_plan = _rank_plan(model.cfg, mesh, tp_reduce,
                                             member=False)[0]
                model = self._price_model
        if weight_format is not None and self.member:
            # a view: packed projections, the caller's other tensors
            model = quantize_params(model, weight_format)
        self.model = model
        self.num_slots = num_slots
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_len = max_len
        self.max_decode_slots = max_decode_slots
        self.max_blocks = -(-max_len // page_size)
        if num_pages - 1 < self.max_blocks:   # page 0 is scratch
            raise ValueError(
                f"num_pages={num_pages} cannot back even one max-length "
                f"request ({self.max_blocks} blocks + scratch)")
        self.default_sampling = sampling_params or sampling.GREEDY
        self.max_top_k = int(max_top_k)
        kvq.validate_cache_dtype(cache_dtype)
        self.cache_dtype = cache_dtype
        self.weight_format = weight_format
        if int(prefill_chunk) < 1:
            raise ValueError(f"prefill_chunk={prefill_chunk} must be >= 1")
        self.prefill_chunk = int(prefill_chunk)
        # no full-KV segment: no shareable, CoW-protected chains, so the
        # prefix index must never hand out ring "hits"
        self.enable_prefix_cache = enable_prefix_cache and lay.has_full
        self.defrag_every = 0
        self._vocab = model.cfg.padded_vocab
        self.ring_pages = 0
        if lay.has_ring:
            # every slot at its transient (mid-prefill-chunk) residency peak
            # at once: ensure() can never fail
            self.ring_pages = ring_pages_needed(
                num_slots=num_slots, window=lay.ring_window,
                page_size=page_size, max_blocks=self.max_blocks,
                prefill_chunk=self.prefill_chunk)
        # -- speculative decoding: the draft keeps a second set of pool
        # leaves over the same page-id space (one allocator, one set of
        # page tables) --
        self.spec = speculative
        self._gamma = int(speculative.gamma) if speculative is not None else 0
        self._draft_plan = self.serve_plan
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
                if mesh is not None:
                    # a separate draft shards by a plan of its own
                    self._draft_plan, _ = _rank_plan(
                        dm.cfg, mesh, tp_reduce, self._tp,
                        member=self.member)
                    dm = (self._draft_plan.local_model(dm) if self.member
                          else Model(dm.cfg, device="meta"))
                if weight_format is not None and self.member:
                    dm = quantize_params(dm, weight_format)
            self._draft_model = dm
        self._true = torch.ones((), dtype=torch.bool, device=self.device)
        self._sched: Scheduler | None = None
        self._pools = self._draft_pools = self._states = None

    # -- device pieces (the reference's jitted functions) -------------------
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _step_impl(self, tokens, pos, page_table, ring_table, state_ok, temp,
                   topk, topp, minp, seed, rep, bias_ids, bias_vals):
        logits = self.model.decode_step_paged(tokens, self._pools, page_table,
                                              pos, states=self._states,
                                              ring_table=ring_table,
                                              state_ok=state_ok)
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

    def _chunk_impl(self, presence, tokens, page_table, ring_table, slot_idx,
                    start, valid, temp, topk, topp, minp, seed, rep, bias_ids,
                    bias_vals):
        logits = self.model.prefill_chunk_paged(tokens, self._pools,
                                                page_table, start, valid,
                                                states=self._states,
                                                ring_table=ring_table,
                                                slot_idx=slot_idx)
        # a request's first token is generated at index prompt_len ==
        # start + valid of its final chunk (other rows' draws are ignored)
        return sampling.sample_slots(logits, temp, topk, topp, minp, seed,
                                     start + valid, max_top_k=self.max_top_k,
                                     rep_penalty=rep, bias_ids=bias_ids,
                                     bias_vals=bias_vals, presence=presence)

    def _chunk_scored_impl(self, presence, tokens, page_table, ring_table,
                           slot_idx, start, valid, tgt, temp, topk, topp,
                           minp, seed, rep, bias_ids, bias_vals):
        """The prompt-logprobs variant of ``_chunk_impl``: the chunk's full
        (B, C, V) logits also score the next prompt token at every chunk
        position (``tgt[i, j] = prompt[start + j + 1]``, host-built), on the
        device; only the (B, C) scores leave it.  The first-token draw
        still goes through the last-position head logits, so a scored
        admission samples the same first token."""
        last_logits, full = self.model.prefill_chunk_scored_paged(
            tokens, self._pools, page_table, start, valid,
            states=self._states, ring_table=ring_table, slot_idx=slot_idx)
        first, lp = sampling.sample_slots(
            last_logits, temp, topk, topp, minp, seed, start + valid,
            max_top_k=self.max_top_k, rep_penalty=rep, bias_ids=bias_ids,
            bias_vals=bias_vals, presence=presence)
        lf = full.float()
        del full
        plp = (torch.gather(lf, -1, tgt[..., None].long())[..., 0]
               - torch.logsumexp(lf, dim=-1))
        return first, lp, plp

    def _pool_leaves(self):
        """Every full-space pool leaf of the target and, when speculating,
        the draft (scale leaves of quantized pools included).  Ring pools
        live in their own page-id space, where pages are never shared,
        copied on write or defragmented."""
        for _, raw in self._split_pool_leaves():
            yield raw

    def _split_pool_leaves(self):
        """``_pool_leaves`` with the dim each leaf shards on a mesh (its
        backend's ``paged_partition_spec``: GQA's KV-head dim 2 of codes
        and scales; None for MLA's latent leaves, whole on every rank)."""
        from repro_torch.models.attention_backends import backend_for_kind
        ring = self.cache.ring is not None
        sets = [(self.model, self._pools)] + (
            [(self._draft_model, self._draft_pools)] if self.spec else [])
        for model, pools in sets:
            kinds = [kind for seg in model.plan for _ in range(seg.reps)
                     for kind in seg.kinds]
            for kind, win, pool in zip(kinds, model.windows, pools):
                if ring and win is not None:
                    continue
                part = backend_for_kind(kind).paged_partition_spec or {}
                for key, leaf in pool.items():
                    yield part.get(key), kvq.raw_view(leaf)

    def _copy_page(self, dst: int, src: int) -> None:
        """pools[dst] = pools[src] on every leaf (copy-on-write)."""
        for raw in self._pool_leaves():
            raw[dst] = raw[src]

    def _permute_pools(self, gather: np.ndarray) -> None:
        """Apply a defrag page permutation: new_pool[i] = old_pool[g[i]]."""
        g = self._tensor(gather).long()
        for raw in self._pool_leaves():
            raw.copy_(raw.index_select(0, g))

    def _page_rows(self, ids: list[int]) -> tuple[torch.Tensor, list]:
        """The page ids as an index tensor, and every pool leaf the handoff
        moves (``_pool_leaves``: the target's, then the draft's)."""
        return (self._tensor(np.asarray(ids, np.int64)),
                list(self._pool_leaves()))

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
        lay = self._layout
        ring = None
        if lay.has_ring:
            ring = RingPageSpace(num_slots=self.num_slots,
                                 num_pages=self.ring_pages,
                                 page_size=self.page_size,
                                 max_blocks=self.max_blocks,
                                 window=lay.ring_window)
        self.cache = PagedKVCache(num_slots=self.num_slots,
                                  num_pages=self.num_pages,
                                  page_size=self.page_size,
                                  max_blocks=self.max_blocks,
                                  enable_prefix_cache=self.enable_prefix_cache,
                                  has_full=lay.has_full, ring=ring,
                                  recompute_shared=(lay.has_state
                                                    and lay.has_full))
        self._sched = Scheduler(self.cache, on_release=self._on_release,
                                max_running=self.max_decode_slots)
        self._slots = sampling.SlotSampling(self.num_slots, self.device)
        # token-presence rows (repetition penalty): host mirror + device copy
        self._presence_np = np.zeros((self.num_slots, self._vocab), np.bool_)
        self._presence_dirty = True
        # free the old pools first
        self._presence = self._pools = self._draft_pools = None
        self._states = None
        self._t0 = time.monotonic()
        self._steps, self._occ_sum = 0, 0.0
        self._n_chunks, self._prefill_tokens = 0, 0
        self._prefill_calls = 0
        self._spec_windows, self._spec_drafted, self._spec_accepted = 0, 0, 0
        self._requests: list[Request] = []
        self.defrag_every = 0      # run-scoped; run() re-applies its arg
        if not self.member:
            return                 # a mirror holds no device state
        self._presence = self._presence_copy()
        self._presence_dirty = False
        self._pools = self.model.init_paged_cache(
            self.num_pages, self.page_size, dtype=self.cache_dtype,
            ring_pages=self.ring_pages if lay.has_ring else None)
        # per-slot SSM state rows: a restarted or newly admitted slot's
        # rows are zeroed inside its first chunk (start == 0), so nothing
        # here resets them between tenants
        self._states = (self.model.init_state_pools(self.num_slots)
                        if lay.has_state else None)
        if self.spec is not None:
            self._draft_pools = self._draft_model.init_paged_cache(
                self.num_pages, self.page_size, dtype=self.cache_dtype)

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

    def _sched_now(self) -> float:
        """The clock reading the scheduler acts on: this process's, or on a
        mesh group rank 0's, broadcast, so that every rank admits (and so
        preempts and defrags) on the same step."""
        now = self._now()
        if self._link is not None:
            return self._link.clock(now)
        return now if self._tp is None else self._tp.broadcast_float(now)

    def _shared(self, *arrays):
        """The host results of this step's device call.  A disaggregated
        engine on rank groups runs every phase's schedule on every serving
        rank (``PhaseLink``): the phase group's first rank broadcasts its
        results and its clock reading after the call (``_stamp``), and
        every rank, the phase's own and the mirrors, books the same tokens
        at the same times."""
        if self._link is None:
            if not self.member:
                raise RuntimeError("this rank is not in the engine's mesh: "
                                   "a DisaggServeEngine drives it")
            return arrays
        *arrays, self._stamp = self._link.share(
            self.phase, (*arrays, self._stamp) if self.member else None)
        return arrays

    def _tp_region(self):
        """The tensor-parallel region the model runs in (none off-mesh)."""
        if self._tp is None:
            return contextlib.nullcontext()
        return manual_tp_axis(self._tp, self.serve_plan.reduce)

    def has_unfinished(self) -> bool:
        return self._sched is not None and self._sched.has_work()

    def kv_token_bytes_per_device(self) -> int:
        """Pool bytes one cached token costs on the device, measured from
        the pool dtype (fp8/int8 pools: codes + scale leaves); on a mesh a
        rank's share (sharded leaves over tp, widened by kv_repl)."""
        from repro_torch.parallel.plan import paged_kv_token_bytes
        plan = self.serve_plan
        return paged_kv_token_bytes(
            self._price_model, tp=plan.tp if plan else 1,
            kv_repl=plan.kv_repl if plan else 1,
            cache_dtype=self.cache_dtype or torch.bfloat16)

    def add_request(self, req: Request,
                    sampling_params: SamplingParams | None = None) -> None:
        """Submit one request; it enters the slot batch on a later
        ``step()`` once a slot and pages free up (honoring arrival_time)."""
        if self.phase == "decode":
            raise RuntimeError(
                "a decode-phase engine only accepts requests through the "
                "KV handoff; submit to the prefill engine (or the "
                "DisaggServeEngine front)")
        if self._sched is None:
            self.reset()
        if req.sampling is None:
            req.sampling = sampling_params or self.default_sampling
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

    # -- disaggregated handoff seam (prefill phase <-> decode phase) --------
    def handoff_ready(self) -> list[Request]:
        """Requests whose chains are complete and parked for transfer
        (prefill-phase engines only; rid order)."""
        return self._sched.handoff_ready()

    def admit_handoff(self, req: Request, now: float) -> int | None:
        """Decode-phase admission of a transferred request: binds a slot
        and allocates or shares its page chain (HANDOFF -> RUNNING).
        Returns the shared-token count (a decode-side prefix hit shrinks
        the transfer), or None when no slot or pages are free: the chain
        stays parked on the prefill side."""
        return self._sched.admit_handoff(req, now)

    def extract_pages(self, ids: list[int]) -> tuple[torch.Tensor, int]:
        """Gather the rows of pool pages ``ids`` of every leaf into one host
        buffer: (len(ids), bytes of a page over all leaves) uint8, the
        leaves' bytes side by side in ``_pool_leaves`` order (scale leaves
        and the draft's pools included).  One device-to-host copy.
        Returns (staged, the exact payload byte count)."""
        idx, leaves = self._page_rows(ids)
        n = len(ids)
        rows = [raw.index_select(0, idx).reshape(n, -1).view(torch.uint8)
                for raw in leaves]
        staged = torch.cat(rows, dim=1).cpu()           # device sync
        return staged, staged.numel()

    def install_pages(self, staged: torch.Tensor, ids: list[int]) -> None:
        """Scatter ``extract_pages``'s host buffer into this engine's pool
        pages ``ids`` (one host-to-device copy).  The caller guarantees
        that ``staged`` came from an engine of the same pool geometry
        (``KVHandoff`` checks) and an id list of the same length."""
        idx, leaves = self._page_rows(ids)
        data = staged.to(self.device)
        off = 0
        for raw in leaves:
            width = raw[0].numel() * raw.element_size()
            rows = data[:, off:off + width].contiguous().view(raw.dtype)
            raw.index_copy_(0, idx, rows.reshape((len(ids),)
                                                 + tuple(raw.shape[1:])))
            off += width
        if off != data.shape[1]:
            raise ValueError(f"staged pages hold {data.shape[1]} bytes a "
                             f"page, this engine's leaves {off}")

    def finish_handoff(self, req: Request) -> None:
        """Complete decode-side adoption once the page bytes landed: slot
        sampling state, the presence row (prompt + the tokens already
        emitted, what a colocated engine holds at this point) and the
        decode-side prefix index (transferred chains keep their hashes, so
        they are shareable and copy-on-write protected like local ones)."""
        slot = req.slot
        self._slots.set(slot, req.sampling)
        self._presence_np[slot] = False
        self._presence_np[slot][np.asarray(req.prompt)] = True
        for t in req.tokens:
            self._presence_np[slot, t] = True
        self._presence_dirty = True
        self.cache.index_prompt(slot, req.prompt)

    def release_handoff(self, slot: int) -> None:
        """Free a transferred chain's prefill-side slot (pages shared into
        the prefix index keep their references)."""
        self._sched.release_handoff(slot)

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
            prompt_logprobs=(list(req.prompt_logprobs)
                             if finished and req.sampling.prompt_logprobs
                             else None),
            metrics=metrics)

    def _progress(self, req: Request, outs: list[RequestOutput]) -> None:
        """Apply finish reasons on-host and emit the unstreamed delta."""
        reason = req.check_finish()
        if reason is not None:
            req.finish_reason = reason
            self._sched.finish(req, self._stamp)
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
        valid = [min(self.prefill_chunk, r.prompt_len - r.pos) for r in pre]
        if self.cache.ring is not None:
            # ring pages back lazily (admission sizes the full space only):
            # grow each slot's ring to this chunk's frontier before the
            # table snapshot; ring_pages_needed sizing makes it infallible
            for r, n in zip(pre, valid):
                if not self.cache.ensure(r.slot, r.pos + n - 1):
                    raise RuntimeError(
                        "ring page pool exhausted during prefill: the "
                        "engine sizes it by ring_pages_needed(), so this "
                        "is an allocator invariant violation")
        first = lp = plp = None
        if self.member:
            first, lp, plp = self._prefill_call(pre, valid)
            self._stamp = self._now()
        first, lp, plp = self._shared(first, lp, plp)
        self._prefill_calls += 1
        for i, r in enumerate(pre):
            r.chunks += 1
            self._n_chunks += 1
            self._prefill_tokens += int(valid[i])
            if plp is not None and r.sampling.prompt_logprobs:
                # position start+j scores prompt[start+j+1]; the final
                # chunk's last position predicts the first generated token,
                # which is not a prompt logprob: drop it
                n = int(valid[i])
                keep = n - 1 if r.pos + n == r.prompt_len else n
                r.prompt_logprobs.extend(float(x) for x in plp[i, :keep])
            r.pos += int(valid[i])
            # the window slid past whole blocks during this chunk: return
            # their ring pages now, between calls
            self.cache.reclaim(r.slot, r.pos)
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
                    r.first_token_time = self._stamp
                self.cache.index_prompt(r.slot, r.prompt)
                self._progress(r, outs)
                if self.phase == "prefill" and r.state == RUNNING:
                    # disaggregated: park the finished chain for transfer;
                    # the slot and its pages stay held until the decode
                    # engine adopts it
                    r.state = HANDOFF

    def _prefill_call(self, pre: list[Request], valid: list[int]):
        """The device part of one batched prefill chunk: ``valid[i]``
        tokens of ``pre[i]``'s prompt from its position.  Returns the
        first-token draws, their log-probs and, when a row asked for them,
        the chunk positions' prompt scores, on the host."""
        c = self.prefill_chunk
        bucket = self._bucket(len(pre))
        need = max(-(-(r.pos + n) // self.page_size)
                   for r, n in zip(pre, valid))
        nb = min(self._bucket(need), self.max_blocks)
        tokens = np.zeros((bucket, c), np.int32)
        tables = np.zeros((bucket, nb), np.int32)      # pad rows -> scratch
        start = np.zeros((bucket,), np.int32)
        valid_a = np.zeros((bucket,), np.int32)
        table = self.cache.table()
        rtab = self.cache.ring_table()
        rtables = None if rtab is None else np.zeros((bucket, nb), np.int32)
        # each bucket row's slot (state rows); padding rows write nothing
        slots_ix = np.zeros((bucket,), np.int32)
        for i, (r, n) in enumerate(zip(pre, valid)):
            tokens[i, :n] = r.prompt[r.pos:r.pos + n]
            tables[i] = table[r.slot, :nb]
            if rtables is not None:
                rtables[i] = rtab[r.slot, :nb]
            slots_ix[i] = r.slot
            start[i] = r.pos
            valid_a[i] = n
        samp = sampling.stack_params([r.sampling for r in pre], bucket)
        extras = sampling.stack_extras([r.sampling for r in pre], bucket)
        pres = np.zeros((bucket, self._vocab), np.bool_)
        for i, r in enumerate(pre):
            pres[i] = self._presence_np[r.slot]
        pres_t, tok_t, tab_t, start_t, valid_t = (
            self._tensor(a) for a in (pres, tokens, tables, start, valid_a))
        rtab_t = None if rtables is None else self._tensor(rtables)
        slots_t = (self._tensor(slots_ix) if self._states is not None
                   else None)
        pargs = [self._tensor(a) for a in samp + extras]
        plp = None
        if any(r.sampling.prompt_logprobs for r in pre):
            # tgt[i, j] = the prompt token position start+j predicts (0-pad
            # past the prompt: those scores are dropped by the caller)
            tgt = np.zeros((bucket, c), np.int32)
            for i, (r, n) in enumerate(zip(pre, valid)):
                nxt = r.prompt[r.pos + 1:r.pos + n + 1]
                tgt[i, :len(nxt)] = nxt
            first, lp, plp = self._chunk_scored_impl(
                pres_t, tok_t, tab_t, rtab_t, slots_t, start_t, valid_t,
                self._tensor(tgt), *pargs)
            plp = plp.cpu().numpy()
        else:
            first, lp = self._chunk_impl(pres_t, tok_t, tab_t, rtab_t,
                                         slots_t, start_t, valid_t, *pargs)
        if self.spec is not None:
            # the draft pools take the same chunk (logits dropped), so the
            # first draft window attends over the whole prompt
            self._draft_model.prefill_chunk_paged(tok_t, self._draft_pools,
                                                  tab_t, start_t, valid_t)
        first = first.cpu().numpy()                    # device sync
        return first, lp.cpu().numpy(), plp

    def step(self) -> list[RequestOutput]:
        """One scheduler iteration: admit arrived requests, advance every
        prefilling request by one chunk, run one decode step over the
        decoding slots.  Returns the ``RequestOutput`` deltas produced this
        iteration (may be empty).  Never sleeps."""
        if self._sched is None:
            return []
        with self._tp_region():
            return self._step()

    def _step(self) -> list[RequestOutput]:
        sched = self._sched
        outs: list[RequestOutput] = []
        if self.phase != "decode":
            # a decode-phase engine admits only through admit_handoff();
            # its preemption victims drain back to the prefill engine
            for r in sched.admit(self._sched_now()):
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
                        if moved is not None and self.member:
                            self._copy_page(moved[1], moved[0])
        decoding = sched.decoding()
        if not decoding:
            return outs
        if self.defrag_every and (self._steps + 1) % self.defrag_every == 0:
            gather = self.cache.defrag()
            if gather is not None and self.member:
                self._permute_pools(gather)

        tokens = np.zeros((self.num_slots,), np.int32)
        pos = np.zeros((self.num_slots,), np.int32)
        # slots still prefilling (or free) must not touch live pages: their
        # rows are routed to the scratch page for this step
        step_table = np.zeros_like(self.cache.table())
        rtab = self.cache.ring_table()
        ring_step = None if rtab is None else np.zeros_like(rtab)
        # state rows commit only for slots that decode this step: the
        # others may be mid-prefill in this same iteration
        state_ok = (np.zeros((self.num_slots,), np.bool_)
                    if self._states is not None else None)
        for req in decoding:
            tokens[req.slot] = req.tokens[-1]
            pos[req.slot] = req.pos
            step_table[req.slot] = self.cache.table()[req.slot]
            if ring_step is not None:
                ring_step[req.slot] = rtab[req.slot]
            if state_ok is not None:
                state_ok[req.slot] = True
        if self._presence_dirty and self.member:
            # admissions/releases since the last step
            self._presence = self._presence_copy()
            self._presence_dirty = False
        if self.spec is not None:
            return self._spec_window(decoding, tokens, pos, step_table, outs)
        nxt = lp = None
        if self.member:
            nxt, lp = self._step_impl(
                self._tensor(tokens), self._tensor(pos),
                self._tensor(step_table),
                None if ring_step is None else self._tensor(ring_step),
                None if state_ok is None else self._tensor(state_ok),
                *self._slots.arrays())
            nxt = nxt.cpu().numpy()                    # device sync
            lp = lp.cpu().numpy()
            self._stamp = self._now()
        nxt, lp = self._shared(nxt, lp)
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
            self.cache.reclaim(req.slot, req.pos)
            self._progress(req, outs)
        return outs

    def _spec_window(self, decoding, tokens, pos, step_table,
                     outs: list[RequestOutput]) -> list[RequestOutput]:
        """One draft/verify window over the decoding slots, emitting
        1..gamma+1 tokens per slot; the emitted tokens and their counts
        come to the host in one copy."""
        sched = self._sched
        out = n_emit = lp = None
        if self.member:
            tok_t, pos_t, tab_t = (self._tensor(a)
                                   for a in (tokens, pos, step_table))
            sargs = self._slots.arrays()
            prop, q_dists = self._spec_draft_impl(tok_t, pos_t, tab_t,
                                                  *sargs)
            out, n_emit, lp = self._spec_verify_impl(tok_t, prop, q_dists,
                                                     pos_t, tab_t, *sargs)
            host = torch.cat([out, n_emit[:, None].to(out.dtype)], dim=1)
            host = host.cpu().numpy()                   # device sync
            out, n_emit = host[:, :-1], host[:, -1]
            lp = (lp.cpu().numpy()
                  if any(r.sampling.logprobs for r in decoding) else None)
            self._stamp = self._now()
        out, n_emit, lp = self._shared(out, n_emit, lp)
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
        if self.phase != "colocated":
            raise RuntimeError(
                "phase-split engines are driven by DisaggServeEngine.run(), "
                "not directly")
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


class PhaseLink:
    """How the two phase engines of a ``DisaggServeEngine`` on disjoint
    rank groups (``parallel.plan.split_mesh``'s slices) stay one engine.

    Every serving rank runs both phases' host schedules: its own phase's
    engine computes, the other phase's engine is a mirror
    (``ContinuousServeEngine.member`` False) that holds no model and no
    pools.  Each device call's host results (the sampled tokens, their
    log-probs, prompt scores, and the clock reading after the call) are
    broadcast from the phase group's first rank over ``group``
    (``phase_group``: gloo, the ranks of both slices), and every rank books
    them alike, so every decision that crosses the groups is the same on
    both sides: the chains ready for handoff each step, the decode side's
    admission of each (a slot, a page chain, a prefix hit) or its deferral,
    the request state a chain carries (prompt, emitted tokens, TTFT stamp,
    sampling parameters, all on the shared ``Request``), decode-side
    preemptions draining back to the prefill queue, and the scheduler's
    clock (the prefill group's first rank's, ``clock``).  The same group
    carries the handoff's page bytes (``KVHandoff``)."""

    def __init__(self, group, prefill_mesh, decode_mesh):
        from repro_torch.parallel.plan import mesh_ranks
        self.group = group
        self.src = {"prefill": mesh_ranks(prefill_mesh)[0],
                    "decode": mesh_ranks(decode_mesh)[0]}
        self.broadcasts = 0

    def share(self, phase: str, payload):
        """``phase``'s first rank's ``payload`` (any picklable value) on
        every rank of the group."""
        box = [payload]
        dist.broadcast_object_list(box, src=self.src[phase], group=self.group)
        self.broadcasts += 1
        return box[0]

    def clock(self, now: float) -> float:
        """The scheduler's clock: the prefill group's first rank's
        reading."""
        return self.share("prefill", now)

    def total(self, value: int) -> int:
        """The sum of every rank's ``value``."""
        t = torch.tensor([value], dtype=torch.int64)
        dist.all_reduce(t, group=self.group)
        return int(t.item())


def _model_rows(mesh) -> list[list[int]]:
    """A ``DeviceMesh``'s world ranks as rows along its ``model`` dim: one
    row a position of the other dims, in order."""
    names = tuple(mesh.mesh_dim_names)
    t = mesh.mesh.movedim(names.index("model"), -1)
    return t.reshape(-1, t.shape[-1]).tolist()


def _part_shape(n: int, axis, lo: int, hi: int, raw) -> list[int]:
    """The shape of ``n`` pages of a pool leaf's part: heads ``[lo, hi)``
    of dim ``axis``, or the whole leaf when ``axis`` is None."""
    shape = [n, *raw.shape[1:]]
    if axis is not None:
        shape[axis] = hi - lo
    return shape


class KVHandoff:
    """KV-page transfer channel between a prefill-phase and a decode-phase
    engine.

    ``transfer`` moves one finished chain: admit on the decode side (a slot
    and fresh or shared pages in its allocator's id space), gather the
    non-shared source pages to a host buffer, scatter them into the decode
    pools (every pool leaf: quantized-KV scale leaves and speculative draft
    pools travel with the chain), then release the prefill slot.
    Decode-side prefix hits skip the matched leading pages: the same
    chained hashes index both sides, so a transferred chain lands in the
    decode prefix index and later requests with the same prefix transfer
    only their tail.  The byte count is exact.

    Staging goes through the host (device -> host -> device), as in the
    reference; a device-to-device copy and transfer/decode overlap are
    later work (ROADMAP).  Both sides in one process (no mesh, or one mesh
    for both phases): each rank copies its own shard of every leaf.

    Across rank groups (``link``, a ``PhaseLink``): prefill rank ``r`` of
    ``tp_p`` holds the KV heads ``[r H/tp_p, (r+1) H/tp_p)`` of each
    GQA leaf (codes and scales; dim 2, ``paged_partition_spec``) and
    decode rank ``s`` of ``tp_d`` needs ``[s H/tp_d, (s+1) H/tp_d)``; over
    the link's gloo group each prefill rank sends every decode rank of its
    data row one host buffer holding, for the chain's pages, the heads of
    every leaf where their two ranges overlap, and a leaf that replicates
    (MLA's latents) whole from prefill rank ``s % tp_p`` to decode rank
    ``s``.  ``bytes_moved`` is then this rank's share: the bytes it sent
    (a prefill rank) or received (a decode rank); the decode ranks' shares
    of one data row add up to the one-device count, a replicated leaf
    counting once for each decode rank.  The two plans must replicate KV
    heads alike (``kv_repl``), as the reference requires.
    """

    def __init__(self, src: ContinuousServeEngine,
                 dst: ContinuousServeEngine, link: PhaseLink | None = None):
        for attr in ("page_size", "max_blocks", "cache_dtype"):
            a, b = getattr(src, attr), getattr(dst, attr)
            if a != b:
                raise ValueError(
                    f"handoff geometry mismatch: {attr}={a!r} on the "
                    f"prefill side vs {b!r} on the decode side")
        if (src.spec is None) != (dst.spec is None):
            raise ValueError(
                "speculative decoding must be on for both sides of a "
                "handoff (draft pools travel with the chain) or neither")
        for a, b in ((src.serve_plan, dst.serve_plan),
                     (src._draft_plan, dst._draft_plan)):
            src_repl = a.kv_repl if a else 1
            dst_repl = b.kv_repl if b else 1
            if src_repl != dst_repl:
                raise ValueError(
                    f"handoff across kv_repl {src_repl} vs {dst_repl} "
                    f"meshes needs a head-regrouping repack (recorded "
                    f"follow-on)")
        self.src = src
        self.dst = dst
        self.link = link
        self.reset_counters()

    def reset_counters(self) -> None:
        self.transfers = 0
        self.pages_moved = 0
        self.bytes_moved = 0
        self.shared_tokens = 0
        self.deferrals = 0
        self.seconds = 0.0            # host wall of the page copies
        self._routes = None           # the pools may be new: re-route

    def transfer(self, req: Request, now: float) -> bool:
        """Move ``req``'s chain into the decode engine; False when the
        decode side has no capacity yet (the chain stays parked)."""
        src, dst = self.src, self.dst
        src_slot = req.slot
        src_chain = src.cache.chain(src_slot, req.prompt_len)
        shared = dst.admit_handoff(req, now)
        if shared is None:
            self.deferrals += 1
            return False
        dst_chain = dst.cache.chain(req.slot, req.prompt_len)
        skip = shared // src.page_size   # matched prefix pages: no copy
        ids_src, ids_dst = src_chain[skip:], dst_chain[skip:]
        self.shared_tokens += shared
        if ids_src:
            t0 = time.perf_counter()
            if self.link is None:
                staged, nbytes = src.extract_pages(ids_src)
                dst.install_pages(staged, ids_dst)
            else:
                nbytes = self._exchange(ids_src, ids_dst)
            self.seconds += time.perf_counter() - t0
            self.pages_moved += len(ids_src)
            self.bytes_moved += nbytes
        dst.finish_handoff(req)
        src.release_handoff(src_slot)
        self.transfers += 1
        return True

    def _exchange(self, ids_src: list[int], ids_dst: list[int]) -> int:
        """This rank's part of moving pages ``ids_src`` (prefill side) into
        ``ids_dst`` (decode side) across the groups: a prefill rank sends
        one host buffer to each decode peer, a decode rank receives one
        from each prefill peer and scatters it.  Returns the bytes this
        rank sent or received."""
        send = self.src.member
        eng = self.src if send else self.dst
        idx = eng._tensor(np.asarray(ids_src if send else ids_dst, np.int64))
        n = len(idx)
        posted, nbytes = [], 0
        for peer, parts in self._peer_parts(eng):
            if send:
                rows = [raw.index_select(0, idx).narrow(axis, lo, hi - lo)
                        if axis is not None else raw.index_select(0, idx)
                        for axis, lo, hi, raw in parts]
                buf = torch.cat([r.contiguous().reshape(n, -1).view(
                    torch.uint8) for r in rows], dim=1).cpu()
                posted.append((dist.isend(buf, peer, group=self.link.group),
                               buf, parts))
            else:
                width = sum(math.prod(_part_shape(n, *part)[1:])
                            * part[3].element_size() for part in parts)
                buf = torch.empty((n, width), dtype=torch.uint8)
                posted.append((dist.irecv(buf, peer, group=self.link.group),
                               buf, parts))
            nbytes += buf.numel()
        for work, buf, parts in posted:
            work.wait()
            if send:
                continue
            data, off = buf.to(eng.device), 0
            for axis, lo, hi, raw in parts:
                at = [idx] + [slice(None)] * (raw.ndim - 1)
                if axis is not None:
                    at[axis] = slice(lo, hi)
                shape = _part_shape(n, axis, lo, hi, raw)
                width = math.prod(shape[1:]) * raw.element_size()
                raw[tuple(at)] = data[:, off:off + width].contiguous().view(
                    raw.dtype).reshape(shape)
                off += width
        return nbytes

    def _peer_parts(self, eng: ContinuousServeEngine) -> list:
        """[(peer world rank, [(split dim or None, lo, hi, leaf)])]: what
        this rank of ``eng``'s group moves with each rank of the other
        group in its data row, each leaf's local head range ``[lo, hi)``
        (the whole leaf when it replicates).  Fixed for the engines' pools:
        made at the first transfer."""
        if self._routes is not None:
            return self._routes
        send = eng is self.src
        rows_me, rows_peer = (_model_rows(self.src.mesh),
                              _model_rows(self.dst.mesh))
        if not send:
            rows_me, rows_peer = rows_peer, rows_me
        if len(rows_me) != len(rows_peer):
            raise ValueError("the phase slices must share every mesh dim "
                             "but 'model' (split_mesh's slices do)")
        me = dist.get_rank()
        row = next(i for i, r in enumerate(rows_me) if me in r)
        pos, n_me = rows_me[row].index(me), len(rows_me[row])
        n_peer = len(rows_peer[row])
        tp_p = n_me if send else n_peer
        routes = []
        for q, peer in enumerate(rows_peer[row]):
            parts = []
            for axis, raw in eng._split_pool_leaves():
                if axis is None:
                    # a replicated leaf: decode rank s takes it whole from
                    # prefill rank s % tp_p
                    p_pos, d_pos = (pos, q) if send else (q, pos)
                    if d_pos % tp_p == p_pos:
                        parts.append((None, 0, 0, raw))
                    continue
                h = raw.shape[axis]
                heads = h * n_me
                if heads % n_peer:
                    raise ValueError(f"{heads} KV heads do not split over "
                                     f"{n_peer} ranks of the other phase")
                hq = heads // n_peer
                lo, hi = max(pos * h, q * hq), min((pos + 1) * h, (q + 1) * hq)
                if lo < hi:
                    parts.append((axis, lo - pos * h, hi - pos * h, raw))
            if parts:
                routes.append((peer, parts))
        self._routes = routes
        return routes


class DisaggServeEngine:
    """Disaggregated serving: a prefill-phase and a decode-phase
    ``ContinuousServeEngine`` joined by a :class:`KVHandoff`.

    Prompts are chunk-prefilled on the prefill engine (its own pool
    budget), then the finished page chain moves through the handoff into
    the decode engine, which runs pure decode steps: no prefill chunk
    shares a decode iteration, so TPOT stays flat under prompt bursts (the
    paper's compute-bound / bandwidth-bound phase split made structural).
    Greedy outputs equal a colocated engine's token for token: seeded
    per-request sampling streams are keyed by absolute position, the
    transferred bytes are exact, and a decode-side preemption drains back
    to the prefill engine for a seeded re-prefill restart.  On one card
    both engines share the device and its current stream.

    Meshes: ``prefill_mesh`` and ``decode_mesh`` (``DeviceMesh``es, or
    "DxM" specs) may be one mesh, whose ranks then run both phases on
    their shards, or two disjoint slices of one (``parallel.plan.
    split_mesh``), each phase with its own TP degree.  On slices every
    rank of either builds only its own phase's model and pools and mirrors
    the other phase's schedule (``PhaseLink``); the handoff regroups KV
    head shards between the groups (``KVHandoff``); and ``run()`` /
    ``stats()`` give every serving rank the same merged
    ``ContinuousStats`` (``handoff_bytes``: the decode ranks' received
    bytes, summed over one data row; ``self.handoff`` keeps this rank's
    own share).  A rank in neither slice serves nothing: ``run()``
    returns None and ``step()`` nothing, and no collective waits for it.

    The same incremental surface as ``ContinuousServeEngine``
    (``add_request()`` / ``step()`` / ``run()`` / ``stats()``), with one
    merged ``ContinuousStats`` (the handoff counters filled in).
    """

    def __init__(self, model: Model, *, device: str | torch.device = "cuda",
                 spec=None, prefill_mesh=None, decode_mesh=None,
                 num_slots: int | None = None, page_size: int | None = None,
                 num_pages: int | None = None, max_len: int | None = None,
                 prefill_slots: int | None = None,
                 prefill_pages: int | None = None,
                 prefill_chunk: int | None = None,
                 sampling_params: SamplingParams | None = None,
                 cache_dtype=None, weight_format: str | None = None,
                 enable_prefix_cache: bool = True,
                 max_top_k: int = sampling.MAX_TOP_K,
                 tp_reduce: str = "auto",
                 max_decode_slots: int | None = None,
                 speculative: SpeculativeConfig | None = None):
        common = dict(device=device, spec=spec, page_size=page_size,
                      max_len=max_len, sampling_params=sampling_params,
                      cache_dtype=cache_dtype, weight_format=weight_format,
                      enable_prefix_cache=enable_prefix_cache,
                      max_top_k=max_top_k, tp_reduce=tp_reduce,
                      speculative=speculative)
        # each phase resolves its own deployment budget (phase=): the
        # prefill side may size fewer slots and pages than decode, as long
        # as the pool geometry matches (KVHandoff checks)
        self.prefill = ContinuousServeEngine(
            model, phase="prefill", mesh=prefill_mesh,
            num_slots=prefill_slots if prefill_slots is not None
            else num_slots,
            num_pages=prefill_pages if prefill_pages is not None
            else num_pages,
            prefill_chunk=prefill_chunk, **common)
        self.decode = ContinuousServeEngine(
            model, phase="decode", mesh=decode_mesh, num_slots=num_slots,
            num_pages=num_pages, max_decode_slots=max_decode_slots, **common)
        self.link = _phase_link(self.prefill.mesh, self.decode.mesh)
        self.serving = self.prefill.member or self.decode.member
        self.prefill._link = self.decode._link = self.link
        self.handoff = KVHandoff(self.prefill, self.decode, link=self.link)
        self.model = model
        self.device = self.decode.device
        self.default_sampling = self.decode.default_sampling
        self._requests: list[Request] = []

    # the decode side is the steady-state resident (the LLM front's
    # introspection points: budget, slots, plan, per-token pool bytes)
    @property
    def deployment(self):
        return self.decode.deployment

    @property
    def serve_plan(self):
        return self.decode.serve_plan

    @property
    def num_slots(self) -> int:
        return self.decode.num_slots

    def kv_token_bytes_per_device(self) -> int:
        return self.decode.kv_token_bytes_per_device()

    def reset(self) -> None:
        self.prefill.reset()
        self.decode.reset()
        if self.link is not None and self.serving:
            self.link.share("prefill", None)   # every rank starts here
        # one clock across both phases: TTFT stamps on the prefill side
        # and finish stamps on the decode side share an origin
        self.prefill._t0 = self.decode._t0 = time.monotonic()
        self.handoff.reset_counters()
        self._requests = []

    def has_unfinished(self) -> bool:
        return self.serving and (self.prefill.has_unfinished()
                                 or self.decode.has_unfinished())

    def add_request(self, req: Request,
                    sampling_params: SamplingParams | None = None) -> None:
        if self.prefill._sched is None or self.decode._sched is None:
            self.reset()
        self.prefill.add_request(req, sampling_params)
        self._requests.append(req)

    def step(self) -> list[RequestOutput]:
        """One disaggregated iteration: prefill chunks, then chain
        transfers (in rid order, stopping at decode backpressure), then
        one decode step, then the decode side's preemption victims drained
        back to the prefill queue."""
        if not self.serving:
            return []
        outs = self.prefill.step()
        now = self.prefill._sched_now()
        for r in self.prefill.handoff_ready():
            if not self.handoff.transfer(r, now):
                break               # decode side full; chain stays parked
        outs += self.decode.step()
        for r in self.decode._sched.drain_preempted():
            # a decode-side eviction restarts on the prefill engine: the
            # chain is recomputed there and handed off again; seeded
            # streams and the emitted watermark make the restart invisible
            self.prefill._sched.requeue(r)
        return outs

    def stats(self) -> ContinuousStats | None:
        """The current session's outcome across both engines: decode steps
        and speculation from the decode side, prefill work and prefix hits
        from the prefill side, the handoff's counters (on rank groups the
        same on every serving rank; None on a rank in neither group)."""
        if not self.serving:
            return None
        requests = self._requests
        pf, dc, ho = self.prefill, self.decode, self.handoff
        wall, handoff_bytes = pf._now(), ho.bytes_moved
        if self.link is not None:
            wall = self.link.share("prefill", wall)
            # the decode side's received bytes, of one data row
            row0 = dist.get_rank() in _model_rows(dc.mesh)[0]
            handoff_bytes = self.link.total(ho.bytes_moved if row0 else 0)
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
        outputs = {r.rid: dc._make_output(r, [], finished=True)
                   for r in requests}
        return ContinuousStats(
            results=results, steps=dc._steps,
            occupancy=dc._occ_sum / max(dc._steps, 1),
            wall=wall,
            preemptions=sum(r.preemptions for r in requests),
            chunks=pf._n_chunks,
            prefill_calls=pf._prefill_calls,
            prefill_tokens=pf._prefill_tokens,
            prompt_tokens=pf.cache.lookup_tokens,
            prefix_hit_tokens=pf.cache.hit_tokens,
            cow_events=pf.cache.cow_events + dc.cache.cow_events,
            spec_windows=dc._spec_windows,
            spec_drafted=dc._spec_drafted,
            spec_accepted=dc._spec_accepted,
            handoffs=ho.transfers,
            handoff_pages=ho.pages_moved,
            handoff_bytes=handoff_bytes,
            handoff_shared_tokens=ho.shared_tokens,
            per_request=per_request,
            outputs=outputs)

    def run(self, requests: Iterable[Request], *, defrag_every: int = 0,
            on_output: Callable[[RequestOutput], None] | None = None
            ) -> ContinuousStats | None:
        """Serve ``requests`` to completion across both engines; the
        contract of ``ContinuousServeEngine.run``.  None, serving nothing,
        on a rank in neither phase group."""
        if not self.serving:
            return None
        if self.has_unfinished():
            raise RuntimeError(
                "run() would reset the engines while incrementally-"
                "submitted requests are unfinished; drive step() to "
                "completion first")
        self.reset()
        self.decode.defrag_every = defrag_every
        for r in requests:
            self.add_request(r)
        pe, de = self.prefill._sched, self.decode._sched
        while pe.has_work() or de.has_work():
            if not pe.running and not de.running:
                nxt_t = pe.next_arrival()
                if nxt_t is None:
                    break
                time.sleep(max(nxt_t - self.prefill._now(), 0.0))
            for o in self.step():
                if on_output is not None:
                    on_output(o)
        return self.stats()


def _phase_link(prefill_mesh, decode_mesh) -> PhaseLink | None:
    """The ``PhaseLink`` of phase engines on ``prefill_mesh`` and
    ``decode_mesh``: None without meshes or on one mesh for both phases
    (every rank runs both engines on its shards); over their
    ``phase_group`` when they are disjoint slices."""
    from repro_torch.parallel.plan import mesh_ranks, phase_group
    if prefill_mesh is None and decode_mesh is None:
        return None
    if prefill_mesh is None or decode_mesh is None:
        raise ValueError("pass both prefill_mesh= and decode_mesh= (one "
                         "mesh, or split_mesh's two slices) or neither")
    a, b = mesh_ranks(prefill_mesh), mesh_ranks(decode_mesh)
    if (tuple(prefill_mesh.mesh.shape) == tuple(decode_mesh.mesh.shape)
            and a == b):
        return None
    if set(a) & set(b):
        raise ValueError(f"the prefill mesh's ranks {a} and the decode "
                         f"mesh's {b} overlap: pass one mesh for both "
                         f"phases or two disjoint slices (split_mesh)")
    group = phase_group(prefill_mesh, decode_mesh)
    if prefill_mesh.get_coordinate() is None \
            and decode_mesh.get_coordinate() is None:
        return None                    # a rank in neither group
    return PhaseLink(group, prefill_mesh, decode_mesh)
