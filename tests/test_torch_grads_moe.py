"""``Model.loss`` and every gradient leaf against ``jax.value_and_grad``
of the reference: the MLA + MoE (deepseek-v2-lite-16b: a dense first
layer, shared experts) and GQA + MoE configs (llama4-scout, every layer
top-1 MoE; llama4-maverick, dense and MoE layers alternating in one
two-kind segment).  The comparison and its tolerances are
``test_torch_grads.check_grads``'s."""
import pytest

from tests.test_torch_grads import _one_torch_thread, check_grads  # noqa: F401

MOE = ["deepseek-v2-lite-16b", "llama4-scout-109b-a17b",
       "llama4-maverick-400b-a17b"]


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", MOE)
def test_grads_match_reference(name, f32):
    check_grads(name, f32)
