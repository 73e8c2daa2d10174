"""What the xLSTM test files share: the xlstm-1.3b smoke config and its
deeper variants at narrow widths (``DEEP``: period 2 with 2 groups;
``PERIOD8``: the published xLSTM[7:1] pattern, 8 layers), both packages'
seed-0 params (``make``), and the tolerances. The tree helpers and the
one-thread fixture are the hybrid files' (``_torch_hybrid_common``).

Tolerances. The decode route (the reference's chunk-1 form, which the
port steps op for op) within one bf16 step: rtol = atol = 2^-7 on a
block's output, 3e-2 on the logits (LOGIT_ATOL), the greedy token equal
wherever the reference's top-2 gap exceeds twice that. The prefill and
train routes against the reference's chunkwise form within the rule the
reference holds its own chunkwise form to against its stepped decode
(``tests/test_system.py``'s ``_assert_logits_close`` on a model without
experts: at most 0.2 % of the values off by more than 0.15 + 0.15 |want|,
the median difference under 0.05). A test file imports the fixtures it
uses (``one_thread``) so that pytest finds them in its namespace."""
import dataclasses

import jax
import numpy as np
from _torch_hybrid_common import (assert_same_params, f32,  # noqa: F401
                                  np_tree, one_thread)

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.sharding.ctx import default_ctx
from repro_torch import configs
from repro_torch.configs.base import XLSTMConfig
from repro_torch.configs.xlstm_1_3b import _pattern
from repro_torch.weights import from_jax_params

ARCH = "xlstm-1.3b"
DEEP = dict(n_layers=4, block_pattern=("mlstm", "slstm") * 2)
PERIOD8 = dict(n_layers=8, block_pattern=_pattern(8, 8),
               xlstm=XLSTMConfig(slstm_every=8, chunk=32))
STEP = dict(rtol=2 ** -7, atol=2 ** -7)
LOGIT_ATOL = 3e-2


def _jover(over):
    """``over`` for the JAX package's config (its own ``XLSTMConfig``)."""
    if "xlstm" not in over:
        return over
    return dict(over, xlstm=jconfigs.XLSTMConfig(
        **dataclasses.asdict(over["xlstm"])))


def make(**over):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH),
                               **_jover(over))
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), **over)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    return dict(jcfg=jcfg, cfg=cfg, ctx=default_ctx(), jp=jp,
                tp=from_jax_params(np_tree(jp), device="cpu"))


def assert_close_system(got, want):
    """``tests/test_system.py``'s ``_assert_logits_close`` without experts:
    at most 0.2 % of the values off by more than 0.15 + 0.15 |want|, and
    the median difference under 0.05."""
    diff = np.abs(got - want)
    assert np.mean(diff > 0.15 + 0.15 * np.abs(want)) <= 0.002, diff.max()
    assert float(np.median(diff)) < 0.05, float(np.median(diff))


def assert_greedy(got, want, what=""):
    """Greedy tokens equal wherever the reference's top-2 gap exceeds
    twice LOGIT_ATOL."""
    top2 = np.sort(want, axis=-1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > 2 * LOGIT_ATOL
    np.testing.assert_array_equal(got.argmax(-1)[decided],
                                  want.argmax(-1)[decided], err_msg=what)
