"""``Model.loss`` and every gradient leaf against ``jax.value_and_grad``
of the reference: the stateful configs (mamba2-370m: the chunked SSD
mixer; hymba-1.5b: attention and SSM heads side by side, global and
windowed segments) and the frontends (hubert-xlarge: ``in_proj`` of frame
features, bidirectional, loss against labels; internvl2-26b: image
embeddings ahead of the text, the loss over the text positions).  The
comparison and its tolerances are ``test_torch_grads.check_grads``'s."""
import pytest

from tests.test_torch_grads import _one_torch_thread, check_grads  # noqa: F401

OTHER = ["mamba2-370m", "hymba-1.5b", "hubert-xlarge", "internvl2-26b"]


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", OTHER)
def test_grads_match_reference(name, f32):
    check_grads(name, f32)
