"""Seeded fleet workload generators: arrivals, lengths, tenants.

A fleet trace is a list of :class:`FleetRequest` — arrival time, tenant,
prompt/shared-prefix/output lengths — plus the metadata needed to
re-materialize the exact token streams.  Everything is driven by a
``numpy`` Generator seeded from one integer, so a (kind, seed, knobs)
tuple names a reproducible workload for benchmarks and tests.

Arrival processes
-----------------
- ``poisson``: homogeneous Poisson at ``rate`` req/s (exponential gaps).
- ``diurnal``: nonhomogeneous Poisson with a sinusoidal rate profile
  (``peak_to_trough`` ratio over ``period_s``), sampled by thinning
  against the peak rate.
- ``mmpp``: 2-state Markov-modulated Poisson process — dwell times are
  exponential, the high state fires ``burst_ratio`` times faster than
  the low state.  This is the "bursty" workload: long quiet stretches
  punctuated by arrival storms, the adversarial case for admission
  control and preemption.

Tenants and shared prefixes
---------------------------
Requests are tagged with a tenant drawn from a Zipf-like categorical
mix.  Every tenant owns a deterministic shared prefix (its "system
prompt") of ``prefix_len`` tokens; a request's prompt is that prefix
followed by unique tokens.  Routers that concentrate a tenant's traffic
on one replica turn the prefix into KV-cache hits — the workload the
prefix-affinity router is measured on.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.runtime.kv_cache import _chain_key

ARRIVAL_KINDS = ("poisson", "diurnal", "mmpp")


@dataclasses.dataclass(frozen=True)
class FleetRequest:
    """One request in a fleet trace (lengths in tokens, times in s)."""
    rid: int
    arrival: float
    tenant: int
    prompt_len: int        # total prompt tokens, including the prefix
    prefix_len: int        # leading tokens shared with the whole tenant
    output_len: int        # tokens to generate


@dataclasses.dataclass(frozen=True)
class LengthMix:
    """Clipped-lognormal prompt/output length distributions."""
    prompt_mean: float = 96.0      # mean of the clipped distribution, approx
    prompt_sigma: float = 0.5      # lognormal shape (log-space std)
    prompt_min: int = 8
    prompt_max: int = 192
    output_mean: float = 24.0
    output_sigma: float = 0.5
    output_min: int = 2
    output_max: int = 64

    def sample(self, rng: np.random.Generator, mean: float, sigma: float,
               lo: int, hi: int, n: int) -> np.ndarray:
        mu = math.log(mean) - 0.5 * sigma ** 2   # lognormal with that mean
        v = rng.lognormal(mu, sigma, size=n)
        return np.clip(np.round(v), lo, hi).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class TenantMix:
    """Zipf-weighted tenants, each owning a shared ``prefix_len`` prompt."""
    n_tenants: int = 8
    zipf_s: float = 1.0            # 0 = uniform, larger = more skewed
    prefix_len: int = 48           # shared leading tokens per tenant

    def weights(self) -> np.ndarray:
        w = 1.0 / np.arange(1, self.n_tenants + 1) ** self.zipf_s
        return w / w.sum()


# ---------------------------------------------------------------------------
# arrival processes
# ---------------------------------------------------------------------------


def poisson_arrivals(rng: np.random.Generator, n: int,
                     rate: float) -> np.ndarray:
    """n homogeneous-Poisson arrival times at ``rate`` req/s."""
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def diurnal_arrivals(rng: np.random.Generator, n: int, mean_rate: float, *,
                     peak_to_trough: float = 4.0,
                     period_s: float = 60.0) -> np.ndarray:
    """Nonhomogeneous Poisson with a sinusoidal day/night profile.

    rate(t) = mean_rate * (1 + beta * sin(2 pi t / period)) where beta is
    set so peak/trough == ``peak_to_trough``.  Sampled by thinning against
    the peak rate, so the output is an exact draw from the process.
    """
    p = float(peak_to_trough)
    beta = (p - 1.0) / (p + 1.0)
    lam_max = mean_rate * (1.0 + beta)
    out = np.empty(n)
    t, i = 0.0, 0
    while i < n:
        t += rng.exponential(1.0 / lam_max)
        lam = mean_rate * (1.0 + beta * math.sin(2 * math.pi * t / period_s))
        if rng.random() * lam_max <= lam:
            out[i] = t
            i += 1
    return out


def mmpp_arrivals(rng: np.random.Generator, n: int, mean_rate: float, *,
                  burst_ratio: float = 8.0, burst_fraction: float = 0.2,
                  mean_dwell_s: float = 2.0) -> np.ndarray:
    """2-state MMPP: quiet vs burst, exponential dwell in each state.

    ``burst_fraction`` of wall time is spent in the burst state, whose
    rate is ``burst_ratio`` x the quiet rate; rates are normalized so the
    long-run mean is ``mean_rate``.
    """
    f, r = float(burst_fraction), float(burst_ratio)
    quiet = mean_rate / ((1.0 - f) + f * r)
    rates = (quiet, quiet * r)
    dwells = (mean_dwell_s * (1.0 - f) * 2.0, mean_dwell_s * f * 2.0)
    out = np.empty(n)
    t, i, state = 0.0, 0, 0
    next_switch = rng.exponential(dwells[0])
    while i < n:
        gap = rng.exponential(1.0 / rates[state])
        if t + gap >= next_switch:
            t = next_switch
            state ^= 1
            next_switch = t + rng.exponential(dwells[state])
            continue
        t += gap
        out[i] = t
        i += 1
    return out


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Trace:
    """A materializable fleet workload."""
    requests: list[FleetRequest]
    kind: str
    seed: int
    vocab: int
    lengths: LengthMix
    tenants: TenantMix
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.requests[-1].arrival if self.requests else 0.0

    @property
    def total_output_tokens(self) -> int:
        return sum(r.output_len for r in self.requests)

    def mean_rate(self) -> float:
        return len(self.requests) / max(self.duration, 1e-9)


def make_trace(n: int, seed: int, *, kind: str = "poisson",
               rate: float = 32.0, vocab: int = 2048,
               lengths: LengthMix | None = None,
               tenants: TenantMix | None = None, **arrival_kw) -> Trace:
    """Generate ``n`` requests with ``kind`` arrivals (seeded, exact)."""
    if kind not in ARRIVAL_KINDS:
        raise ValueError(f"unknown arrival kind {kind!r}; "
                         f"know {ARRIVAL_KINDS}")
    lengths = lengths or LengthMix()
    tenants = tenants or TenantMix()
    rng = np.random.default_rng(seed)
    if kind == "poisson":
        arr = poisson_arrivals(rng, n, rate)
    elif kind == "diurnal":
        arr = diurnal_arrivals(rng, n, rate, **arrival_kw)
    else:
        arr = mmpp_arrivals(rng, n, rate, **arrival_kw)
    tid = rng.choice(tenants.n_tenants, size=n, p=tenants.weights())
    plen = lengths.sample(rng, lengths.prompt_mean, lengths.prompt_sigma,
                          lengths.prompt_min, lengths.prompt_max, n)
    olen = lengths.sample(rng, lengths.output_mean, lengths.output_sigma,
                          lengths.output_min, lengths.output_max, n)
    # the shared prefix must leave at least one unique trailing token
    plen = np.maximum(plen, tenants.prefix_len + 1)
    reqs = [FleetRequest(rid=i, arrival=float(arr[i]), tenant=int(tid[i]),
                         prompt_len=int(plen[i]),
                         prefix_len=int(tenants.prefix_len),
                         output_len=int(olen[i]))
            for i in range(n)]
    return Trace(requests=reqs, kind=kind, seed=seed, vocab=vocab,
                 lengths=lengths, tenants=tenants, meta=dict(arrival_kw))


def tenant_prefix_tokens(trace: Trace, tenant: int) -> np.ndarray:
    """The tenant's deterministic shared prefix (its "system prompt")."""
    rng = np.random.default_rng((trace.seed, 0x7e4a, tenant))
    return rng.integers(0, trace.vocab, size=trace.tenants.prefix_len,
                        dtype=np.int64).astype(np.int32)


def materialize_prompt(trace: Trace, req: FleetRequest) -> np.ndarray:
    """Token ids for one request: tenant prefix + unique tail (seeded)."""
    prefix = tenant_prefix_tokens(trace, req.tenant)[:req.prefix_len]
    rng = np.random.default_rng((trace.seed, 0x51ab, req.rid))
    tail = rng.integers(0, trace.vocab, size=req.prompt_len - req.prefix_len,
                        dtype=np.int64).astype(np.int32)
    return np.concatenate([prefix, tail])


def prefix_chain(tokens: np.ndarray, page_size: int) -> tuple[bytes, ...]:
    """Chained block hashes of a prompt, one per *full* block.

    The same position-dependent chain the paged KV cache indexes shared
    prefixes by (``runtime.kv_cache._chain_key``), over at most
    ``len(tokens) - 1`` tokens — the cache never shares the final prompt
    token (its K/V depends on the first sampled position).
    """
    shareable = (max(len(tokens) - 1, 0)) // page_size
    chain, prev = [], b""
    for b in range(shareable):
        prev = _chain_key(prev, tokens[b * page_size:(b + 1) * page_size])
        chain.append(prev)
    return tuple(chain)


def tenant_chains(trace: Trace, page_size: int) -> dict[int, tuple[bytes, ...]]:
    """Per-tenant block-hash chains of the shared prefixes (cheap: one
    chain per tenant, not per request)."""
    out = {}
    for t in range(trace.tenants.n_tenants):
        toks = tenant_prefix_tokens(trace, t)
        # full blocks of the prefix only — the tail diverges per request
        n_blocks = trace.tenants.prefix_len // page_size
        chain, prev = [], b""
        for b in range(n_blocks):
            prev = _chain_key(prev, toks[b * page_size:(b + 1) * page_size])
            chain.append(prev)
        out[t] = tuple(chain)
    return out
