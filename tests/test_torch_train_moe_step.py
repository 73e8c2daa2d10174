"""One AdamW step of ``make_train_step`` on phi3.5-moe (the MoE family:
attention and expert layers), with the launcher's capacity-factor drops, at
1 and at 2 microbatches, held against the JAX package's ``make_train_step``
on its smoke config, same weights and batch (2 x 32). Tolerances in
``_torch_train_common``."""
import pytest

torch = pytest.importorskip("torch")

from _torch_train_common import check_step, make, one_thread  # noqa: E402,F401,E501

ARCH = "phi3.5-moe-42b-a6.6b"


@pytest.fixture(scope="module")
def family():
    return make(ARCH)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(family, microbatches):
    check_step(family, microbatches)
