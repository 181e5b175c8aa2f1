"""``Model.loss`` and every gradient leaf of the port against
``jax.value_and_grad`` of the reference's loss, on the reduced configs.
This file holds the dense GQA family (llama3 8b/70b/405b, qwen3 with
qk-norm, qwen2.5 with qkv bias, phi3 with full MHA, danube with its
sliding window); ``test_torch_grads_moe.py`` the MLA and MoE configs and
``test_torch_grads_other.py`` the stateful and frontend ones, through
``check_grads`` here (a file runs on one test worker: three files keep
each one short).

The reference's gradient pytree is carried into a second port model by
``bridge.params_from_jax`` and compared with the port's ``.grad`` leaf by
leaf by relative norm.  Tolerances:
- f32 internals (the bf16 weights cast to f32 on both sides): the loss
  within 1e-5 relative, each leaf within 1e-4 of its norm (measured:
  below 2e-5; the two frameworks sum in other orders);
- bf16 (the models as built): the loss within 1e-2, each leaf within 6e-2
  of its norm (measured: below 2.4e-2; XLA and PyTorch round the bf16
  activations at different points, each layer deep);
- every leaf also within 1e-6 of the whole gradient's norm: with top-1
  routing (llama4) the router's gradient is zero in exact arithmetic (its
  normalised weight is p / p = 1), so both sides hold rounding noise of
  ~1e-8 there.
``remat=True`` (each layer recomputed in the backward pass) gives the
same loss and gradients bit for bit on the CPU.
"""
import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (import order: models before kernels)
import jax
import jax.numpy as jnp

from repro.configs import get_config, reduced_config
from repro.models.model import build_model
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax

DENSE = ["llama3-8b", "llama3-70b", "llama3-405b", "qwen3-14b",
         "qwen2.5-14b", "phi3-mini-3.8b", "h2o-danube-1.8b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed=0, b=2, s=16, n_image=4):
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        return {"features": rng.standard_normal((b, s, cfg.d_model),
                                                dtype=np.float32),
                "labels": rng.integers(0, cfg.vocab_size, (b, s),
                                       dtype=np.int32)}
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)}
    if cfg.frontend == "vision":
        out["image_embeds"] = rng.standard_normal((b, n_image, cfg.d_model),
                                                  dtype=np.float32)
    return out


def _norm(t: torch.Tensor) -> float:
    return float(t.double().norm())


def check_grads(name: str, f32: bool) -> None:
    cfg = reduced_config(get_config(name))
    ref = build_model(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    jp = (jax.tree.map(lambda a: a.astype(jnp.float32), params) if f32
          else params)
    batch = _batch(cfg)
    loss_w, grads_w = jax.jit(jax.value_and_grad(ref.loss))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})

    tcfg = tconfigs.reduced_config(tconfigs.get_config(name))
    port = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                           device="cpu")
    if f32:
        port.float()
    port.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = {}
    for remat in (False, True):
        port.zero_grad(set_to_none=True)
        loss = port.loss(tb, remat=remat)
        loss.backward()
        got[remat] = (float(loss), {n: p.grad.clone() for n, p in
                                    port.named_parameters()})
    assert got[True][0] == got[False][0]
    for n, g in got[False][1].items():
        assert torch.equal(g, got[True][1][n]), n

    loss_g, grads_g = got[False]
    if f32:
        assert loss_g == pytest.approx(float(loss_w), rel=1e-5)
    else:
        assert abs(loss_g - float(loss_w)) <= 1e-2
    want = dict(params_from_jax(jax.tree.map(np.asarray, grads_w), tcfg,
                                device="cpu",
                                dtype=torch.float32 if f32 else None
                                ).named_parameters())
    assert want.keys() == grads_g.keys()
    total = np.sqrt(sum(_norm(w) ** 2 for w in want.values()))
    rtol = 1e-4 if f32 else 6e-2
    for n, w in want.items():
        g = grads_g[n]
        assert g.dtype == w.dtype and g.shape == w.shape, n
        err = _norm(g.double() - w.double())
        assert err <= rtol * _norm(w) + 1e-6 * total, (n, err, _norm(w))


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", DENSE)
def test_grads_match_reference(name, f32):
    check_grads(name, f32)
