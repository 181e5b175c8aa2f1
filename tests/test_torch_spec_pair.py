"""The truncated-draft pair of ``runtime/spec_pair.py`` against the measured
half of the reference's ``benchmarks/spec_decode.py`` on the CPU.

The target's weights come from the reference's ``Model.init`` (f32) through
the bridge; ``build_pair`` damps them in place and must give the reference
``build_pair``'s damped weights bit for bit, with a draft that shares the
target's tensors.  The continuous engine then serves the same greedy
requests plain and with the draft (``speculative=``): the streams, the
windows and the accepted counts equal the reference engines', greedy
speculation equals plain decoding, and acceptance stays high."""
import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (import order: models before kernels)
import jax
import jax.numpy as jnp

from benchmarks.spec_decode import bench_config as ref_bench_config
from benchmarks.spec_decode import build_pair as ref_build_pair
from repro.models.model import build_model
from repro.runtime.llm import LLMEngine as RefLLM
from repro.runtime.sampling import SamplingParams as RefSP
from repro.runtime.speculative import SpeculativeConfig as RefSpecConfig
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.runtime.llm import LLMEngine
from repro_torch.runtime.sampling import SamplingParams
from repro_torch.runtime.spec_pair import bench_config, build_pair
from repro_torch.runtime.speculative import SpeculativeConfig

N_LAYERS, DRAFT_LAYERS, DAMP, SEED, GAMMA = 4, 2, 0.005, 0, 3
PROMPT, NEW, PAGE = 16, 12, 40


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op thread pool would only spin on the
    cores the parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    cfg = ref_bench_config(N_LAYERS)
    assert bench_config(N_LAYERS).__dict__ == cfg.__dict__
    init = build_model(cfg).init(jax.random.PRNGKey(SEED))
    ref = ref_build_pair(N_LAYERS, DRAFT_LAYERS, DAMP, SEED)
    # the reference casts bf16 leaves to f32 before damping; so does this
    port = params_from_jax(jax.tree.map(np.asarray, init),
                           bench_config(N_LAYERS), device="cpu").float()
    target, draft = build_pair(port, DRAFT_LAYERS, DAMP)
    return ref, target, draft


def test_damped_weights_equal_reference_and_draft_shares_them(pair):
    (_, params, _, _), target, draft = pair
    got = params_to_numpy(target)
    want = jax.tree.map(np.asarray, params)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert draft.cfg.n_layers == DRAFT_LAYERS
    assert draft.embed is target.embed and draft.head is target.head
    assert draft.final_norm is target.final_norm
    for d, t in zip(draft.layers, target.layers):
        assert d is t
    assert all(p.device.type == "cpu" for p in draft.parameters())


def test_streams_windows_and_acceptance_match_reference(pair):
    (rmodel, rparams, rdraft, rdparams), target, draft = pair
    rng = np.random.default_rng(SEED)
    prompts = list(rng.integers(0, 2048, (4, PROMPT)).astype(np.int32))
    max_len = PROMPT + NEW + GAMMA
    geom = dict(backend="continuous", num_slots=2, page_size=PAGE,
                num_pages=1 + 2 * 2 * -(-max_len // PAGE), max_len=max_len,
                prefill_chunk=PROMPT)
    runs = {}
    for name, sc, rsc in (
            ("plain", None, None),
            ("spec", SpeculativeConfig(draft_model=draft, gamma=GAMMA),
             RefSpecConfig(draft_model=rdraft, draft_params=rdparams,
                           gamma=GAMMA))):
        ref = RefLLM(rmodel, rparams, cache_dtype=jnp.float32,
                     speculative=rsc, **geom)
        want = ref.generate(prompts, RefSP(max_tokens=NEW))
        llm = LLMEngine(target, device="cpu", cache_dtype=torch.float32,
                        speculative=sc, **geom)
        got = llm.generate(prompts, SamplingParams(max_tokens=NEW))
        assert [o.token_ids for o in got] == [o.token_ids for o in want]
        gs, ws = llm.last_stats, ref.last_stats
        assert (gs.steps, gs.spec_windows, gs.spec_drafted,
                gs.spec_accepted) == (ws.steps, ws.spec_windows,
                                      ws.spec_drafted, ws.spec_accepted)
        for rid in range(len(prompts)):
            for key in ("spec_windows", "spec_accepted"):
                assert gs.per_request[rid][key] == ws.per_request[rid][key]
        runs[name] = (got, gs)
    (plain, _), (spec, stats) = runs["plain"], runs["spec"]
    assert [o.token_ids for o in spec] == [o.token_ids for o in plain]
    # the damped deep blocks barely move the hidden state
    assert stats.spec_accepted / stats.spec_drafted > 0.8
