"""``DeploymentSpec``: one hardware-aware deployment API.

The port of ``repro/runtime/deployment.py``.  A serving deployment is
determined by a *hardware point* (memory capacity, memory bandwidth,
energy/bit: a device SKU and/or an HBM-CO stack) plus the model's byte
footprint.  ``resolve()`` turns a spec into the engine's configuration:

  **memory budget** (per device)
      capacity  =  weights  +  workspace  +  KV pool
      - weights: the model's parameters at their served bytes (packed
        codes + scales for the quantizable projections under
        ``weight_format``, native bytes for the rest), or the footprint
        estimate when no weights are given;
      - workspace: a fraction reserved for activations, logits and
        allocator metadata;
      - KV pool: whatever capacity remains sizes ``num_pages``.

  **bandwidth model** (memory roofline: decode is bandwidth-bound)
      step_seconds(b) = (weight stream + b x KV-context stream) / BW
      The knee ``b* ~ weight_bytes / kv_context_bytes`` bounds
      ``num_slots`` and becomes the scheduler's ``max_decode_slots``.

Every front end consumes the same object::

    spec = DeploymentSpec(sku="h100", weight_format="mxfp4",
                          cache_dtype="fp8", max_len=4096)
    llm = LLMEngine(model, spec=spec)       # pools sized from the spec
    print(llm.deployment.describe())

Pricing a model needs no weights: ``spec.resolve(Model(cfg,
device="meta"))`` prices from the footprint estimate, and passing that
meta model as ``params=`` prices its parameters exactly, without storage.

The arithmetic is the reference's, number for number, including its
constants (``core/hardware.py``: the H100 is a nominal 80 GiB, decoding at
the paper's measured 32% of its 3.35 TB/s).  Differences: dtypes are torch
dtypes (bf16 by default) or the strings ``"fp8"``/``"int8"``; the port
holds weights in the ``Model`` itself, so ``params=`` and ``draft_params=``
take a ``Model`` (or its quantized view).  ``mesh`` is ``"DxM"``, ``(D, M)``
or a ``launch.mesh.MeshShape`` (dims and sizes only: pricing makes no
process group; ``resolve(device=)`` names the tensor type that decides
``tp_reduce="auto"``), or a ``DeviceMesh`` (an engine serving the spec
builds one over its ranks and passes it in); the per-device budget then
counts the serve plan's ``tp`` and ``kv_repl`` as the reference's does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.core import hardware
from repro_torch.core.hbmco import CANDIDATE_CO, HBMCOConfig, hbmco_by_name
from repro_torch.models.footprint import compute_footprint
from repro_torch.quant import formats
from repro_torch.quant import kv as kvq


class DeploymentError(ValueError):
    """The spec's hardware point cannot back the requested deployment."""


@dataclasses.dataclass(frozen=True)
class DeviceBudget:
    """The per-device hardware point a spec resolves against."""

    name: str
    capacity_bytes: float          # usable HBM per device
    decode_bw: float               # bytes/s sustained during decode
    energy_pj_per_bit: float | None = None   # memory-stream energy, if known


# Named compute SKUs (``core.hardware``).  "rpu-cu" is one RPU compute
# unit: 2 HBM-CO chiplets on dual 256 GB/s shorelines (paper §IV).
CHIP_SKUS = {
    "tpu-v5e": hardware.TPU_V5E,
    "tpu_v5e": hardware.TPU_V5E,
    "h100": hardware.H100,
    "h200": hardware.H200,
}


@dataclasses.dataclass(frozen=True)
class DeploymentSpec:
    """One hardware-aware deployment configuration.

    sku            "rpu-cu", a name from ``CHIP_SKUS``, or a ``ChipSpec``.
    hbmco          HBM-CO stack (config or name, ``hbmco_by_name``).  When
                   set, the memory system is ``stacks_per_device`` such
                   stacks; required for ``sku="rpu-cu"`` (defaults to the
                   paper's 768 MB candidate).  When None, the SKU's native
                   HBM numbers apply (GPU decode bandwidth derated by the
                   paper's measured utilization).
    mesh           tensor-parallel mesh ("DxM", (D, M), a DeviceMesh or a
                   MeshShape); None = one device.
    tp_reduce      how the serve plan closes a column pair ("auto",
                   "gather", "psum").
    weight_format  ``quant.formats`` name ("mxfp4", ...) for the weight
                   budget; None = native parameter dtype.
    cache_dtype    KV-pool dtype: a torch dtype, "fp8" or "int8" (None =
                   bf16).
    max_len        per-request token capacity (prompt + generated).
    page_size      KV page tokens.
    prefill_chunk  admission chunk tokens (None = derived from the SKU's
                   FLOPs knee: the chunk where compute time crosses the
                   weight-stream time, page-rounded and clamped to
                   [page_size, min(512, max_len)]).
    max_slots      upper bound on the derived slot count.
    overcommit     slots may cover ``overcommit x`` the pool's worst-case
                   token capacity (preemption is the backstop).
    mean_context   expected live context per slot for the bandwidth model
                   (None = ``max_len // 2``).
    workspace_fraction  capacity reserved for activations + allocator
                   metadata before the KV pool is sized.
    """

    sku: str | hardware.ChipSpec = "rpu-cu"
    hbmco: str | HBMCOConfig | None = None
    mesh: Any = None
    tp_reduce: str = "auto"
    weight_format: str | None = None
    cache_dtype: Any = None
    max_len: int = 256
    page_size: int = 16
    prefill_chunk: int | None = None
    max_slots: int = 32
    overcommit: float = 1.0
    mean_context: int | None = None
    workspace_fraction: float = 0.05
    stacks_per_device: int = 2

    def __post_init__(self):
        if self.max_len < 1 or self.page_size < 1:
            raise ValueError("max_len and page_size must be >= 1")
        if self.max_slots < 1:
            raise ValueError(f"max_slots={self.max_slots} must be >= 1")
        if self.overcommit <= 0.0:
            raise ValueError(f"overcommit={self.overcommit} must be > 0")
        if not 0.0 <= self.workspace_fraction < 1.0:
            raise ValueError("workspace_fraction must be in [0, 1)")
        if self.weight_format is not None \
                and self.weight_format not in formats.FORMAT_NAMES:
            raise ValueError(f"unknown weight_format {self.weight_format!r}; "
                             f"known: {sorted(formats.FORMAT_NAMES)}")
        kvq.validate_cache_dtype(self.cache_dtype)   # "fp8"/"int8" strings

    # ---------------- hardware point ----------------
    def device_budget(self) -> DeviceBudget:
        """Resolve (sku, hbmco) into per-device capacity/BW/energy."""
        hbm = self.hbmco
        if isinstance(hbm, str):
            hbm = hbmco_by_name(hbm)
        if isinstance(self.sku, str) and self.sku == "rpu-cu":
            hbm = hbm or CANDIDATE_CO
            rpu = hardware.RPU_DEFAULT
            n = self.stacks_per_device
            return DeviceBudget(
                name=f"rpu-cu[{n}x{hbm.name}]",
                capacity_bytes=n * hbm.capacity_bytes,
                decode_bw=min(rpu.cu_mem_bw, n * hbm.bandwidth_gbs * 1e9),
                energy_pj_per_bit=hbm.energy_pj_per_bit)
        chip = self.sku if isinstance(self.sku, hardware.ChipSpec) \
            else CHIP_SKUS.get(self.sku)
        if chip is None:
            raise ValueError(f"unknown sku {self.sku!r}; known: 'rpu-cu', "
                             f"{sorted(set(CHIP_SKUS) - {'tpu_v5e'})}")
        if hbm is not None:        # HBM-CO retrofit of a named chip
            n = self.stacks_per_device
            return DeviceBudget(
                name=f"{chip.name}[{n}x{hbm.name}]",
                capacity_bytes=n * hbm.capacity_bytes,
                decode_bw=min(chip.hbm_bw, n * hbm.bandwidth_gbs * 1e9),
                energy_pj_per_bit=hbm.energy_pj_per_bit)
        bw = chip.hbm_bw
        if isinstance(chip, hardware.GPUSpec):
            bw *= chip.decode_bw_utilization     # paper §II: 32% on H100
        return DeviceBudget(name=chip.name, capacity_bytes=chip.hbm_capacity,
                            decode_bw=bw)

    def _device_compute(self) -> tuple[float, float]:
        """(effective prefill FLOP/s, weight-stream bytes/s) per device:
        the compute roofline prefill chunks run against.  The decode
        bandwidth derate does not apply here (a prefill chunk streams the
        weights once at full sequential bandwidth).  RPU CUs provision
        compute at ``ops_per_byte`` x their memory bandwidth."""
        hbm = self.hbmco
        if isinstance(hbm, str):
            hbm = hbmco_by_name(hbm)
        if isinstance(self.sku, str) and self.sku == "rpu-cu":
            hbm = hbm or CANDIDATE_CO
            rpu = hardware.RPU_DEFAULT
            bw = min(rpu.cu_mem_bw,
                     self.stacks_per_device * hbm.bandwidth_gbs * 1e9)
            return rpu.cu_tops, bw
        chip = self.sku if isinstance(self.sku, hardware.ChipSpec) \
            else CHIP_SKUS[self.sku]
        bw = chip.hbm_bw
        if hbm is not None:
            bw = min(chip.hbm_bw,
                     self.stacks_per_device * hbm.bandwidth_gbs * 1e9)
        eff = getattr(chip, "compute_efficiency", 0.7)
        return chip.peak_flops_bf16 * eff, bw

    def _resolve_mesh(self, override=None, device="cuda"):
        """The mesh to price: ``override`` or the spec's.  A "DxM" string
        or (D, M) pair prices as a ``MeshShape`` of ``device``'s type
        (whose "auto" reduction that type decides); no process group is
        made.  The engine serving the spec builds its ``DeviceMesh``
        itself and passes it here."""
        from repro_torch.launch.mesh import MeshShape, mesh_dims
        mesh = override if override is not None else self.mesh
        if mesh is None or hasattr(mesh, "mesh_dim_names"):
            return mesh
        return MeshShape(mesh_dims(mesh),
                         device_type=torch.device(device).type)

    # ---------------- resolution ----------------
    def resolve(self, model, params=None, mesh=None, *, draft=None,
                draft_params=None, gamma: int = 8,
                spec_accept_rate: float = 0.7,
                phase: str = "colocated",
                device="cuda") -> "ResolvedDeployment":
        """Turn the spec into runtime numbers for ``model`` (a ``Model``;
        only its ``cfg`` and ``plan`` are read, so a ``meta``-device model
        prices without storage).

        ``params`` (the ``Model`` whose weights will be served) makes the
        weight budget exact; without it the footprint estimate is used.

        ``phase`` prices one side of a disaggregated split: "prefill"
        budgets slots for chunked prompt compute (``step_seconds`` is the
        batched chunk iteration and the ceiling counts prompt tokens/s),
        "decode" and "colocated" the bandwidth-roofline point.

        ``draft`` prices a speculative deployment: the draft's weights
        join the capacity budget (a self-draft or a truncated draft that
        shares the target's tensors is priced as a second set of
        weights, as the reference prices it), every logical KV page
        carries both models' pool bytes, and the bandwidth model becomes
        per window: gamma draft steps plus one verify step.
        ``spec_accept_rate`` is the modeled per-token acceptance alpha; a
        window emits ``alpha(1-alpha^gamma)/(1-alpha) + 1`` expected
        tokens.

        ``device`` is where the deployment would serve: a "DxM" mesh is
        priced as that device type's (``tp_reduce="auto"`` is "gather" on
        the CPU, "psum" on CUDA)."""
        from repro_torch.parallel.plan import make_paged_serve_plan, \
            paged_kv_token_bytes, paged_kv_token_bytes_split
        from repro_torch.runtime.state_cache import model_cache_layout, \
            ring_pages_needed, state_bytes_per_slot

        if phase not in ("colocated", "prefill", "decode"):
            raise ValueError(f"phase={phase!r}: expected 'colocated', "
                             f"'prefill', or 'decode'")
        cfg = model.cfg
        lay = model_cache_layout(model.plan)
        dlay = model_cache_layout(draft.plan) if draft is not None else None
        if draft is not None and (lay.stateful or dlay.stateful):
            role, c = ("model", cfg) if lay.stateful else ("draft", draft.cfg)
            raise DeploymentError(
                f"speculative decoding is unsupported for the "
                f"stateful-cache {role} {c.name!r}: draft/verify rewinds "
                f"token-indexed KV pages on rejection, but recurrent SSM "
                f"state and reclaimed ring pages cannot rewind. Serve "
                f"this architecture without a draft.")
        if lay.has_state and kvq.is_quantized_cache_dtype(self.cache_dtype):
            raise DeploymentError(
                f"cache_dtype={self.cache_dtype!r} is unsupported for the "
                f"state-carrying model {cfg.name!r}: SSM state pools stay "
                f"bf16 (conv tail) / f32 (SSD state). Use cache_dtype=None "
                f"(bf16) or torch.float32 for this architecture.")
        if lay.stateful and phase != "colocated":
            raise DeploymentError(
                f"phase={phase!r} is unsupported for the stateful-cache "
                f"model {cfg.name!r}: the disaggregated KV handoff moves "
                f"full-space page chains only. Use phase='colocated'.")
        if kvq.is_quantized_cache_dtype(self.cache_dtype):
            for role, c in [("model", cfg)] + \
                    ([("draft", draft.cfg)] if draft is not None else []):
                if getattr(c, "mla", False):
                    raise DeploymentError(
                        f"cache_dtype={self.cache_dtype!r} is unsupported "
                        f"for the MLA {role} {c.name!r}: quantized KV "
                        f"({'/'.join(sorted(kvq.KV_FORMATS))}) exists only "
                        f"for GQA page pools. Use cache_dtype=None (bf16) "
                        f"or torch.float32 for this architecture.")
        mesh = self._resolve_mesh(mesh, device)
        plan = None
        tp = kv_repl = 1
        if mesh is not None:
            plan = make_paged_serve_plan(cfg, mesh, reduce=self.tp_reduce)
            tp, kv_repl = plan.tp, plan.kv_repl
        dev = self.device_budget()
        fp = compute_footprint(cfg)
        wbits = (formats.bits_per_element(self.weight_format)
                 if self.weight_format else None)
        per = (wbits / 8.0) if wbits else 2.0              # bf16 default

        # -- weights, per device --
        if params is not None:
            weight_bytes = self._weight_bytes_exact(params, plan)
        else:
            # no params: every weight counted replicated (the reference's
            # conservative estimate: overstating weights only shrinks the
            # pool)
            weight_bytes = fp.total_params * per

        # -- speculative draft: weights + per-page pool bytes --
        cache_dtype = self.cache_dtype if self.cache_dtype is not None \
            else torch.bfloat16
        draft_weight_bytes = 0.0
        draft_kv_token = 0
        dfp = dplan = None
        dtp = dkv_repl = 1
        if draft is not None:
            dfp = compute_footprint(draft.cfg)
            if mesh is not None:
                dplan = make_paged_serve_plan(draft.cfg, mesh,
                                              reduce=self.tp_reduce)
                dtp, dkv_repl = dplan.tp, dplan.kv_repl
            if draft_params is not None:
                draft_weight_bytes = self._weight_bytes_exact(draft_params,
                                                              dplan)
            else:
                draft_weight_bytes = dfp.total_params * per
            draft_kv_token = paged_kv_token_bytes(
                draft, tp=dtp, kv_repl=dkv_repl, cache_dtype=cache_dtype)
            weight_bytes += draft_weight_bytes

        # -- workspace + KV budget --
        workspace = self.workspace_fraction * dev.capacity_bytes
        kv_budget = dev.capacity_bytes - weight_bytes - workspace
        # measured from a tiny pool at this dtype: quantized pools price
        # codes + scale leaves; with a draft every logical page costs both
        # pool sets
        kv_full, kv_ring = paged_kv_token_bytes_split(
            model, tp=tp, kv_repl=kv_repl, cache_dtype=cache_dtype)
        kv_full += draft_kv_token      # draft pages live in the full space
        kv_token = kv_full + kv_ring
        max_blocks = -(-self.max_len // self.page_size)

        # -- bandwidth-model inputs --
        per_w = (wbits / 8.0) if wbits else 2.0
        active_bytes = fp.active_params * per_w / tp
        ctx = self.mean_context if self.mean_context is not None \
            else max(self.max_len // 2, 1)

        # -- compute roofline: prefill chunk from the SKU's FLOPs knee --
        # C* = F_eff x bytes/weight / (2 x BW), page-rounded, clamped to
        # [page_size, min(512, max_len)]; an explicit prefill_chunk wins
        flops_eff, stream_bw = self._device_compute()
        chunk_knee = flops_eff * per_w / (2.0 * stream_bw)
        chunk_derived = self.prefill_chunk is None
        if chunk_derived:
            prefill_chunk = round(chunk_knee / self.page_size) \
                * self.page_size
            prefill_chunk = max(self.page_size,
                                min(prefill_chunk, 512, self.max_len))
        else:
            prefill_chunk = self.prefill_chunk

        # -- capacity -> slots/pages --
        if not lay.stateful:
            page_bytes = kv_token * self.page_size
            if kv_budget < page_bytes * max_blocks:
                raise DeploymentError(
                    f"{dev.name}: {_fmt_bytes(dev.capacity_bytes)} capacity "
                    f"leaves {_fmt_bytes(max(kv_budget, 0))} for KV after "
                    f"{_fmt_bytes(weight_bytes)} weights + "
                    f"{_fmt_bytes(workspace)} workspace — cannot back one "
                    f"max_len={self.max_len} request "
                    f"({max_blocks} pages x {_fmt_bytes(page_bytes)}); pick "
                    "a larger-capacity SKU, quantize "
                    "(weight_format/cache_dtype), or lower max_len")
            budget_pages = int(kv_budget // page_bytes)
            budget_tokens = budget_pages * self.page_size
            kv_ctx = max(kv_token * ctx, 1.0)
            knee = max(1, round(active_bytes / kv_ctx))
            slots_cap = max(1, int(budget_tokens * self.overcommit
                                   // self.max_len))
            num_slots = max(1, min(knee, slots_cap, self.max_slots))
            max_decode_slots = max(1, min(knee, self.max_slots))
            # never more pages than a fully occupied slot set plus
            # prefix-cache slack
            num_pages = 1 + min(budget_pages, 4 * num_slots * max_blocks)
            num_ring_pages = 0
            state_b = 0
        else:
            # a slot's worst case holds max_blocks full pages + the ring's
            # transient bound + its state entry
            state_b = state_bytes_per_slot(cfg) if lay.has_state else 0
            ring_w = lay.ring_window or 0
            ring_cap = min(max_blocks,
                           -(-(ring_w + prefill_chunk) // self.page_size)
                           + 1) if lay.has_ring else 0
            slot_resident = (kv_full * self.page_size * max_blocks
                             + kv_ring * self.page_size * ring_cap
                             + state_b)
            if kv_budget < slot_resident:
                raise DeploymentError(
                    f"{dev.name}: {_fmt_bytes(dev.capacity_bytes)} capacity "
                    f"leaves {_fmt_bytes(max(kv_budget, 0))} for the cache "
                    f"after {_fmt_bytes(weight_bytes)} weights + "
                    f"{_fmt_bytes(workspace)} workspace — cannot back one "
                    f"max_len={self.max_len} slot of {cfg.name!r} "
                    f"({_fmt_bytes(slot_resident)} resident: full pages + "
                    f"ring window + state); pick a larger-capacity SKU, "
                    "quantize the weights, or lower max_len")
            kv_ctx = max(kv_full * ctx + kv_ring * min(ctx, ring_w)
                         + state_b, 1.0)
            knee = max(1, round(active_bytes / kv_ctx))
            slots_cap = max(1, int(kv_budget * self.overcommit
                                   // slot_resident))
            num_slots = max(1, min(knee, slots_cap, self.max_slots))
            max_decode_slots = max(1, min(knee, self.max_slots))
            num_ring_pages = ring_pages_needed(
                num_slots=num_slots, window=ring_w,
                page_size=self.page_size, max_blocks=max_blocks,
                prefill_chunk=prefill_chunk) if lay.has_ring else 0
            ring_pool = max(num_ring_pages - 1, 0) * kv_ring \
                * self.page_size
            rem = kv_budget - num_slots * state_b - ring_pool
            if lay.has_full:
                fpage = kv_full * self.page_size
                budget_pages = int(max(rem, 0.0) // fpage)
                if budget_pages < max_blocks:
                    raise DeploymentError(
                        f"{dev.name}: state pools "
                        f"({num_slots} x {_fmt_bytes(state_b)}) + ring "
                        f"space ({_fmt_bytes(ring_pool)}) leave "
                        f"{_fmt_bytes(max(rem, 0.0))} for full-context KV "
                        f"— cannot back one max_len={self.max_len} "
                        f"request of {cfg.name!r}; pick a larger-capacity "
                        "SKU or lower max_len")
                budget_tokens = budget_pages * self.page_size
                num_pages = 1 + min(budget_pages,
                                    4 * num_slots * max_blocks)
            else:
                budget_pages = 0
                budget_tokens = slots_cap * self.max_len
                num_pages = 1 + max_blocks

        step_s = (active_bytes + num_slots * kv_ctx) / dev.decode_bw
        ceiling = num_slots / step_s
        if phase == "prefill":
            # enough concurrent chunks to cover the weight stream (+1 for
            # admission overlap); the iteration is the max of batched
            # chunk compute and one weight stream; prompt tokens/s
            num_slots = max(1, min(slots_cap, self.max_slots,
                                   int(math.ceil(chunk_knee / prefill_chunk))
                                   + 1))
            num_pages = 1 + min(budget_pages, 4 * num_slots * max_blocks)
            tokens = num_slots * prefill_chunk
            compute_s = 2.0 * fp.active_params * tokens / (flops_eff * tp)
            step_s = max(compute_s, active_bytes / stream_bw)
            ceiling = tokens / step_s
        j_per_tok = None
        if dev.energy_pj_per_bit is not None:
            stream = (active_bytes + num_slots * kv_ctx) * tp
            j_per_tok = stream * 8.0 * dev.energy_pj_per_bit * 1e-12 \
                / num_slots

        # -- speculative window model --
        spec_kwargs = {}
        if draft is not None:
            g = int(gamma)
            a = min(max(float(spec_accept_rate), 0.0), 1.0)
            draft_active = dfp.active_params * per / dtp
            draft_kv_ctx = max(draft_kv_token * ctx, 1.0)
            draft_step_s = (draft_active + num_slots * draft_kv_ctx) \
                / dev.decode_bw
            window_s = g * draft_step_s + step_s
            expected = float(g) if a >= 1.0 \
                else a * (1.0 - a ** g) / (1.0 - a)
            spec_kwargs = dict(
                draft_weight_bytes_per_device=draft_weight_bytes,
                draft_kv_token_bytes=draft_kv_token,
                spec_gamma=g, spec_accept_rate=a,
                spec_expected_accepted=expected,
                spec_window_seconds=window_s,
                spec_tokens_per_s_ceiling=(num_slots * (expected + 1.0)
                                           / window_s))

        return ResolvedDeployment(
            **spec_kwargs,
            spec=self, device=dev, mesh=mesh, tp=tp, kv_repl=kv_repl,
            tp_reduce=self.tp_reduce, cache_dtype=cache_dtype,
            weight_bytes_per_device=weight_bytes,
            workspace_bytes=workspace,
            kv_budget_bytes=kv_budget,
            kv_token_bytes=kv_token,
            ring_token_bytes=kv_ring,
            ring_window=lay.ring_window,
            num_ring_pages=num_ring_pages,
            state_bytes_per_slot=state_b,
            budget_tokens=budget_tokens,
            max_len=self.max_len, page_size=self.page_size,
            prefill_chunk=prefill_chunk,
            num_pages=num_pages, num_slots=num_slots,
            max_decode_slots=max_decode_slots,
            mean_context=ctx,
            step_seconds=step_s,
            tokens_per_s_ceiling=ceiling,
            modeled_j_per_token=j_per_tok,
            phase=phase,
            chunk_knee_tokens=chunk_knee,
            prefill_chunk_derived=chunk_derived,
            prefill_flops=flops_eff,
            stream_bw=stream_bw)

    def _weight_bytes_exact(self, params, plan=None) -> float:
        """Per-device weight bytes as the engine will allocate them
        (``quant.linear.serve_leaf_bytes``: packed bytes for quantizable
        projections under ``weight_format``, native bytes for the rest).
        On a mesh (``plan``) a leaf the plan shards counts ``kv_repl / tp``
        of its bytes (wk, wv and their biases) or ``1 / tp`` (the rest),
        as the reference's budget does."""
        from repro_torch.quant.linear import serve_leaf_bytes
        total = 0.0
        for name, ndim, b in serve_leaf_bytes(params, self.weight_format):
            if plan is not None and plan.tp > 1 and \
                    plan.param_shard_dim(name, ndim) is not None:
                repl = plan.kv_repl if name.split(".")[-1] in (
                    "wk", "wv", "bk", "bv") else 1
                b = b * repl / plan.tp
            total += b
        return total


@dataclasses.dataclass(frozen=True)
class ResolvedDeployment:
    """A ``DeploymentSpec`` resolved against one model: the engine
    configuration plus the modeled roofline a measured run is set
    against."""

    spec: DeploymentSpec
    device: DeviceBudget
    mesh: Any
    tp: int
    kv_repl: int
    tp_reduce: str
    cache_dtype: Any
    # memory budget (per device)
    weight_bytes_per_device: float
    workspace_bytes: float
    kv_budget_bytes: float
    kv_token_bytes: int
    budget_tokens: int
    # engine configuration
    max_len: int
    page_size: int
    prefill_chunk: int
    num_pages: int
    num_slots: int
    max_decode_slots: int
    # bandwidth model
    mean_context: int
    step_seconds: float
    tokens_per_s_ceiling: float
    modeled_j_per_token: float | None = None
    # speculative decoding (resolve(draft=...); None when not speculative)
    draft_weight_bytes_per_device: float | None = None
    draft_kv_token_bytes: int | None = None
    spec_gamma: int | None = None
    spec_accept_rate: float | None = None
    spec_expected_accepted: float | None = None   # per window, modeled
    spec_window_seconds: float | None = None      # gamma drafts + 1 verify
    spec_tokens_per_s_ceiling: float | None = None
    # phase-split deployments (resolve(phase=...))
    phase: str = "colocated"
    chunk_knee_tokens: float | None = None   # FLOPs-knee chunk, unclamped
    prefill_chunk_derived: bool = False      # chunk came from the knee
    prefill_flops: float | None = None       # effective FLOP/s per device
    stream_bw: float | None = None           # full weight-stream bytes/s
    # stateful cache layouts (runtime/state_cache.py); zero/None for the
    # all-full-KV layout
    ring_token_bytes: int = 0       # bytes/token in sliding-window layers
    ring_window: int | None = None
    num_ring_pages: int = 0         # ring space incl. scratch (0 = none)
    state_bytes_per_slot: int = 0   # SSM state pool bytes per slot

    @property
    def pool_bytes_per_device(self) -> int:
        """Exactly the bytes the engine's pools allocate: full-space pages
        (scratch excluded) + ring-space pages + state pools."""
        full_tok = self.kv_token_bytes - self.ring_token_bytes
        return ((self.num_pages - 1) * full_tok * self.page_size
                + max(self.num_ring_pages - 1, 0) * self.ring_token_bytes
                * self.page_size
                + self.num_slots * self.state_bytes_per_slot)

    def describe(self) -> str:
        d = self.device
        lines = [
            f"deployment: {d.name}"
            + (f" [{self.phase}]" if self.phase != "colocated" else "")
            + (f" x tp={self.tp}" + (f" (kv_repl={self.kv_repl})"
                                     if self.kv_repl > 1 else "")
               if self.tp > 1 else ""),
            f"  capacity  {_fmt_bytes(d.capacity_bytes):>10}/device = "
            f"{_fmt_bytes(self.weight_bytes_per_device)} weights + "
            f"{_fmt_bytes(self.workspace_bytes)} workspace + "
            f"{_fmt_bytes(self.kv_budget_bytes)} KV budget",
            f"  KV pool   {self.num_pages} pages x {self.page_size} tok x "
            f"{_fmt_bytes(self.kv_token_bytes)}/tok = "
            f"{_fmt_bytes(self.pool_bytes_per_device)}/device",
            *([f"  stateful  ring {max(self.num_ring_pages - 1, 0)} pages "
               f"x {_fmt_bytes(self.ring_token_bytes * self.page_size)} "
               f"(window {self.ring_window}) + state "
               f"{_fmt_bytes(self.state_bytes_per_slot)}/slot x "
               f"{self.num_slots}"]
              if self.num_ring_pages or self.state_bytes_per_slot else []),
            f"  slots     {self.num_slots} "
            f"(admission hint {self.max_decode_slots}; "
            f"{self.budget_tokens} budget tokens, max_len {self.max_len})",
            f"  roofline  {_fmt_bytes(d.decode_bw)}/s -> "
            f"{self.tokens_per_s_ceiling:.1f} tok/s ceiling at "
            f"ctx {self.mean_context} "
            f"({self.step_seconds * 1e3:.2f} ms/step)",
        ]
        if self.prefill_chunk_derived and self.chunk_knee_tokens is not None:
            lines.append(
                f"  chunk     {self.prefill_chunk} tok from the FLOPs knee "
                f"({self.prefill_flops / 1e12:.1f} TFLOP/s x "
                f"{self.spec.weight_format or 'bf16'} weights / "
                f"2 x {_fmt_bytes(self.stream_bw)}/s = "
                f"{self.chunk_knee_tokens:.0f} tok, page-rounded)")
        else:
            lines.append(f"  chunk     {self.prefill_chunk} tok (explicit)")
        if self.modeled_j_per_token is not None:
            lines.append(f"  energy    "
                         f"{self.modeled_j_per_token * 1e3:.3f} mJ/token "
                         f"({d.energy_pj_per_bit:.2f} pJ/bit memory)")
        if self.spec_gamma is not None:
            lines.append(
                f"  spec      gamma={self.spec_gamma} "
                f"(+{_fmt_bytes(self.draft_weight_bytes_per_device)} draft "
                f"weights, +{_fmt_bytes(self.draft_kv_token_bytes)}/tok "
                f"draft KV) -> {self.spec_expected_accepted:.2f} accepted "
                f"per window at alpha={self.spec_accept_rate:.2f}, "
                f"{self.spec_tokens_per_s_ceiling:.1f} tok/s ceiling "
                f"({self.spec_window_seconds * 1e3:.2f} ms/window)")
        return "\n".join(lines)

    def as_dict(self) -> dict:
        """JSON-friendly summary."""
        return {
            "device": self.device.name,
            "capacity_bytes": self.device.capacity_bytes,
            "decode_bw": self.device.decode_bw,
            "tp": self.tp, "kv_repl": self.kv_repl,
            "weight_bytes_per_device": self.weight_bytes_per_device,
            "workspace_bytes": self.workspace_bytes,
            "kv_budget_bytes": self.kv_budget_bytes,
            "kv_token_bytes": self.kv_token_bytes,
            "budget_tokens": self.budget_tokens,
            "num_pages": self.num_pages, "num_slots": self.num_slots,
            "max_decode_slots": self.max_decode_slots,
            "page_size": self.page_size, "max_len": self.max_len,
            "prefill_chunk": self.prefill_chunk,
            "tokens_per_s_ceiling": self.tokens_per_s_ceiling,
            "step_seconds": self.step_seconds,
            "modeled_j_per_token": self.modeled_j_per_token,
            "spec_gamma": self.spec_gamma,
            "spec_accept_rate": self.spec_accept_rate,
            "spec_expected_accepted": self.spec_expected_accepted,
            "spec_window_seconds": self.spec_window_seconds,
            "spec_tokens_per_s_ceiling": self.spec_tokens_per_s_ceiling,
            "phase": self.phase,
            "chunk_knee_tokens": self.chunk_knee_tokens,
            "prefill_chunk_derived": self.prefill_chunk_derived,
            "ring_token_bytes": self.ring_token_bytes,
            "ring_window": self.ring_window,
            "num_ring_pages": self.num_ring_pages,
            "state_bytes_per_slot": self.state_bytes_per_slot,
        }


def _fmt_bytes(b: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024.0:
            return f"{b:.1f}{unit}"
        b /= 1024.0
    return f"{b:.1f}PB"
