"""One AdamW step of ``make_train_step`` on xlstm-1.3b (the xLSTM family: an
mLSTM and an sLSTM block, no experts), with the launcher's capacity-factor
drops, at 1 and at 2 microbatches, held against the JAX package's
``make_train_step`` on its smoke config, same weights and batch (2 x 32).
Tolerances in ``_torch_train_common``."""
import pytest

torch = pytest.importorskip("torch")

from _torch_train_common import check_step, make, one_thread  # noqa: E402,F401,E501

ARCH = "xlstm-1.3b"


@pytest.fixture(scope="module")
def family():
    return make(ARCH)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(family, microbatches):
    check_step(family, microbatches)
