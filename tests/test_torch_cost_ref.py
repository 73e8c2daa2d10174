"""The port's count of work (``roofline/cost.py``) held against the JAX
package's (``repro.roofline.hlo_cost`` on its compiled program), the dense
and MoE families: a decode step and a prefill chunk (baseline and HQP: INT8
weights and KV) and a train step of the smoke configs. The INT8 products
agree exactly; the bf16 ones differ only by the terms
``_torch_cost_common.named_terms`` computes from the shapes and names
(qwen3 and phi3.5-moe: the prefill's logits of every position, remat).
The CPU count equals the meta device's."""
import pytest

from _torch_cost_common import CELLS, check_against_reference

pytest.importorskip("torch")


@pytest.fixture(autouse=True)
def one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("variant,kind", CELLS)
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "phi3.5-moe-42b-a6.6b"])
def test_count_matches_reference(arch, variant, kind):
    check_against_reference(arch, variant, kind)
