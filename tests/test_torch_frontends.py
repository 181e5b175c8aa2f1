"""The modality frontends on the CPU against the reference: the two
configs (hubert-xlarge, internvl2-26b) resolve with the reference's
fields and footprints; reduced hubert's ``forward``, ``loss`` and
``prefill`` (an audio encoder: ``in_proj`` of frame features, bidirectional
attention); reduced internvl2's forward and loss with image embeddings
ahead of the text, and its static generation through ``ServeEngine``; and
the refusals in the reference's words (continuous batching, the decode
step of an encoder).

Weights come from the reference ``Model.init`` through
``bridge.params_from_jax``; features, image embeddings and tokens from a
numpy seed.  Tolerances: in f32 (weights cast on both sides) logits and
losses within 1e-5 and token streams identical, greedy and sampled; in
bf16 logits within 4 bf16 ulps (2^-6) of the largest magnitude, as in
test_torch_static.py, the loss within 1e-2.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (import order: models before kernels)
import jax
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.configs import get_config, list_configs, reduced_config
from repro.models.footprint import compute_footprint as ref_footprint
from repro.models.model import build_model
from repro.runtime.engine import ContinuousServeEngine as RefContinuous
from repro.runtime.engine import ServeEngine as RefServeEngine
from repro.runtime.sampling import SamplingParams as RefSP
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.models.footprint import compute_footprint
from repro_torch.models.model import Model
from repro_torch.runtime.engine import ContinuousServeEngine, ServeEngine
from repro_torch.runtime.llm import LLMEngine
from repro_torch.runtime.sampling import SamplingParams


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FRONTENDS = ["hubert-xlarge", "internvl2-26b"]
N_IMAGE = 8            # image embeddings of a reduced vision batch


def test_every_reference_config_resolves():
    """All 14 of the reference's names (and module names) resolve, the two
    frontend configs field for field."""
    for name in list_configs():
        t = tconfigs.get_config(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(get_config(name))
        assert tconfigs.get_config(ref_configs._ARCH_MODULES[name]) is t
        assert (dataclasses.asdict(tconfigs.reduced_config(t))
                == dataclasses.asdict(reduced_config(get_config(name))))
    assert tconfigs.get_config("hubert-xlarge").frontend == "audio"
    assert tconfigs.get_config("internvl2-26b").n_frontend_tokens == 256


@pytest.mark.parametrize("name,billions", [("internvl2-26b", 20.0),
                                           ("hubert-xlarge", 1.26)])
def test_footprint_totals_match_reference(name, billions):
    """``models/footprint.py`` totals equal the reference's exactly; the
    meta-device model's own count lands near the published size (the
    reference's ``test_param_counts_match_published`` bound)."""
    got = compute_footprint(tconfigs.get_config(name))
    want = ref_footprint(get_config(name))
    assert got.total_params == want.total_params
    assert got.active_params == want.active_params
    n = Model(tconfigs.get_config(name), device="meta").param_count()
    assert n / 1e9 == pytest.approx(billions, rel=0.30)


def _reference(name, seed=0):
    cfg = reduced_config(get_config(name))
    model = build_model(cfg)
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(seed)))
    return cfg, model, params


def _f32(params):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.float32), params)


def _batch(cfg, seed, b=2, s=16):
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        return {"features": rng.standard_normal((b, s, cfg.d_model),
                                                dtype=np.float32),
                "labels": rng.integers(0, cfg.vocab_size, (b, s),
                                       dtype=np.int32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32),
            "image_embeds": rng.standard_normal((b, N_IMAGE, cfg.d_model),
                                                dtype=np.float32)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _check(jl, tl, f32):
    a = np.asarray(jnp.asarray(jl).astype(jnp.float32))
    b = tl.detach().float().numpy()
    assert a.shape == b.shape
    if f32:
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
    else:
        tol = 2.0 ** -6 * np.abs(a).max()
        assert np.abs(a - b).max() <= tol, (np.abs(a - b).max(), tol)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", FRONTENDS)
def test_forward_and_loss_match_reference(name, f32):
    """``forward`` (B, S [+ images], V) logits and ``loss`` from the same
    batch dict."""
    cfg, ref, params = _reference(name)
    port = params_from_jax(params, tconfigs.reduced_config(
        tconfigs.get_config(name)), device="cpu")
    jp = _f32(params) if f32 else params
    if f32:
        port.float()
    batch = _batch(cfg, 1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with torch.no_grad():
        got = port.forward(_torch(batch))
        got_loss = float(port.loss(_torch(batch)))
    _check(ref.forward(jp, jb), got, f32)
    s = 16 + (N_IMAGE if cfg.frontend == "vision" else 0)
    assert got.shape == (2, s, cfg.padded_vocab)
    want_loss = float(ref.loss(jp, jb))
    assert abs(got_loss - want_loss) <= (1e-5 if f32 else 1e-2)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_hubert_prefill_matches_reference(f32):
    """hubert's prefill (bidirectional over the frames) fills the cache and
    gives the last frame's logits, as the reference's; the engine counts
    the frames as the prompt."""
    cfg, ref, params = _reference("hubert-xlarge")
    assert not cfg.causal
    port = params_from_jax(params, tconfigs.reduced_config(
        tconfigs.get_config("hubert-xlarge")), device="cpu")
    jp = _f32(params) if f32 else params
    if f32:
        port.float()
    feats = _batch(cfg, 2)["features"]
    dt = jnp.float32 if f32 else jnp.bfloat16
    jlog, _ = ref.prefill(jp, {"features": jnp.asarray(feats)},
                          ref.init_cache(2, 16, dtype=dt))
    tcache = port.init_cache(2, 16, dtype=torch.float32 if f32 else None)
    tlog = port.prefill({"features": torch.from_numpy(feats)}, tcache)
    _check(jlog, tlog, f32)
    eng = ServeEngine(port, device="cpu", max_len=16,
                      cache_dtype=torch.float32 if f32 else None)
    logits, _, plen = eng.prefill({"features": feats})
    assert plen == 16
    _check(jlog, logits, f32)


def test_internvl2_static_generation_matches_reference():
    """``ServeEngine.generate`` over tokens + image embeddings: the image
    positions come first and count in the prompt length; greedy and
    sampled rows equal the reference's ``ServeEngine`` in f32."""
    cfg, ref, params = _reference("internvl2-26b")
    port = params_from_jax(params, tconfigs.reduced_config(
        tconfigs.get_config("internvl2-26b")), device="cpu").float()
    batch = _batch(cfg, 3, b=3, s=10)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    sps = [dict(), dict(temperature=0.8, top_k=16, seed=3, logprobs=True),
           dict(temperature=1.0, seed=9, repetition_penalty=1.3)]
    max_len = N_IMAGE + 10 + 8
    reng = RefServeEngine(ref, _f32(params), max_len=max_len,
                          donate_cache=False, cache_dtype=jnp.float32)
    _, _, rplen = reng.prefill(jb)
    want = reng.generate(jb, max_new_tokens=8,
                         sampling_params=[RefSP(**kw) for kw in sps])
    eng = ServeEngine(port, device="cpu", max_len=max_len,
                      cache_dtype=torch.float32)
    _, _, plen = eng.prefill(batch)
    assert plen == rplen == N_IMAGE + 10
    got = eng.generate(batch, max_new_tokens=8,
                       sampling_params=[SamplingParams(**kw) for kw in sps])
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.logprobs.numpy(), np.asarray(want.logprobs),
                               rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="exceed max_len"):
        eng.generate(batch, max_new_tokens=9)


def test_frontend_refusals_in_the_reference_words():
    """Continuous batching refuses a frontend model (the reference's
    words, also behind ``LLMEngine``); an encoder has no decode step; the
    paged entries serve tokens only."""
    for name in FRONTENDS:
        cfg, ref, params = _reference(name)
        port = params_from_jax(params, tconfigs.reduced_config(
            tconfigs.get_config(name)), device="cpu")
        with pytest.raises(NotImplementedError) as want:
            RefContinuous(ref, params, num_slots=2, page_size=4,
                          num_pages=9, max_len=16)
        with pytest.raises(NotImplementedError) as got:
            ContinuousServeEngine(port, device="cpu", num_slots=2,
                                  page_size=4, num_pages=9, max_len=16)
        assert str(got.value) == str(want.value) == \
            "continuous batching serves token frontends only"
        with pytest.raises(NotImplementedError, match="token frontends"):
            LLMEngine(port, backend="continuous", device="cpu", max_len=16,
                      num_slots=2, page_size=4, num_pages=9)
        with pytest.raises(NotImplementedError, match="tokens only"):
            port.prefill_chunk_paged(torch.zeros((1, 4), dtype=torch.int32),
                                     [], torch.zeros((1, 1), dtype=torch.int32),
                                     torch.zeros(1, dtype=torch.int32),
                                     torch.ones(1, dtype=torch.int32))
    cfg, ref, params = _reference("hubert-xlarge")
    port = params_from_jax(params, tconfigs.reduced_config(
        tconfigs.get_config("hubert-xlarge")), device="cpu")
    with pytest.raises(AssertionError) as want:
        ref.decode_step(params, jnp.zeros((1,), jnp.int32),
                        ref.init_cache(1, 8), 0)
    for call in (lambda: port.decode_step(torch.zeros(1, dtype=torch.int32),
                                          port.init_cache(1, 8), 0),
                 lambda: port.decode_step_paged(
                     torch.zeros(1, dtype=torch.int32), [],
                     torch.zeros((1, 1), dtype=torch.int32),
                     torch.zeros(1, dtype=torch.int32))):
        with pytest.raises(NotImplementedError) as got:
            call()
        assert str(got.value) == str(want.value) == \
            "encoder-only models have no decode step"


def test_audio_bridge_round_trip():
    """An audio model holds ``in_proj`` and ``head`` and no embedding; the
    bridge carries them both ways."""
    cfg, ref, params = _reference("hubert-xlarge")
    port = params_from_jax(params, tconfigs.reduced_config(
        tconfigs.get_config("hubert-xlarge")), device="cpu")
    names = dict(port.named_parameters())
    assert "in_proj" in names and "head" in names and "embed" not in names
    back = params_to_numpy(port)
    for key in ("in_proj", "head", "final_norm"):
        np.testing.assert_array_equal(back[key].view(np.uint8),
                                      params[key].view(np.uint8))
    assert len(jax.tree.leaves(back)) == len(jax.tree.leaves(params))


def test_serve_launcher_vision_static(capsys):
    """``python -m repro_torch.launch.serve --arch internvl2-26b``: the
    static vision path (tokens behind image embeddings through
    ``ServeEngine``) returns 0; continuous refuses, in the reference's
    words."""
    from repro_torch.launch.serve import main
    assert main(["--device", "cpu", "--arch", "internvl2-26b", "--batch",
                 "2", "--prompt-len", "8", "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert "backend=static(vision) batch=2 new_tokens=4" in out
    with pytest.raises(NotImplementedError, match="token frontends only"):
        main(["--device", "cpu", "--arch", "internvl2-26b", "--continuous",
              "--batch", "2", "--prompt-len", "8", "--max-new", "4"])
