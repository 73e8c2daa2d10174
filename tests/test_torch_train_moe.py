"""Training phi3.5-moe (the MoE family: attention and expert layers) on the
CPU, held against the JAX package on its smoke config, same weights and
batch (2 x 32): ``lm.loss_fn(with_aux=True)`` and its gradient with the
capacity factor's drops (the launcher's ``moe_no_drop=False``) and without
them (``default_ctx()``), and the loss without the auxiliary losses. The
train step is in ``test_torch_train_moe_step.py``; tolerances in
``_torch_train_common``."""
import pytest

torch = pytest.importorskip("torch")

from _torch_train_common import (check_loss, check_no_aux,  # noqa: E402,F401
                                 make, one_thread)

ARCH = "phi3.5-moe-42b-a6.6b"


@pytest.fixture(scope="module")
def family():
    return make(ARCH)


@pytest.mark.parametrize("no_drop", [False, True], ids=["drops", "no_drop"])
def test_loss_aux_and_gradient_match_reference(family, no_drop):
    check_loss(family, no_drop)


def test_without_aux_the_loss_is_the_fisher_passes(family):
    check_no_aux(family)
