"""ROADMAP C13: which params AdamW's weight decay applies to, held against
the JAX package's ``adamw_update`` on each trained family's smoke params.

The reference decays a param of two or more dimensions in its stacked
layout, so a layer's norm gains and biases (2-D there, 1-D in the port's
per-layer tree) decay too. One AdamW step on the seed-0 smoke params at lr
0.1, weight decay 0.1 (a 1 % decay, above a bf16 ulp's 0.39 %): with zero
gradients the step is the decay alone and equal bit for bit; with random
gradients every param within one bf16 ulp (``test_torch_train.py``'s
AdamW bound: the bias corrections' ``b ** step`` are two frameworks' f32
``pow``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _torch_train_common import (bf16_ulp, flat_port, flat_ref,  # noqa: E402,F401,E501
                                 one_thread)

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

LR = WEIGHT_DECAY = 0.1


@pytest.mark.parametrize("grads", ["zero", "random"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "phi3.5-moe-42b-a6.6b",
                                  "jamba-1.5-large-398b", "xlstm-1.3b"])
def test_c13_weight_decay_follows_the_stacked_layout(arch, grads):
    jp = jlm.init_params(jax.random.PRNGKey(0),
                         jconfigs.get_smoke_config(arch))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.RandomState(3)
    jg = jax.tree.map(
        lambda p: (jnp.zeros(p.shape, jnp.float32) if grads == "zero" else
                   jnp.asarray(rng.randn(*p.shape).astype(np.float32))),
        jp)
    tg = from_jax_params(jax.tree.map(np.asarray, jg), device="cpu")
    cfg = opt.AdamWConfig(lr=LR, weight_decay=WEIGHT_DECAY)
    jcfg = jopt.AdamWConfig(lr=LR, weight_decay=WEIGHT_DECAY)
    tp2, _ = opt.adamw_update(tp, tg, opt.adamw_init(tp, cfg), cfg)
    jp2, _ = jopt.adamw_update(jp, jg, jopt.adamw_init(jp, jcfg),
                               jcfg)                           # eagerly
    got, want, before = flat_port(tp2), flat_ref(jp2), flat_port(tp)
    assert sorted(got) == sorted(want)
    # a layer's 1-D leaves, 2-D once stacked, that are not all zero
    per_layer_1d = [k for k in got if k.startswith("blocks/")
                    and got[k].ndim == 2 and before[k].any()]
    assert per_layer_1d
    for k in got:
        if grads == "zero":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert np.all(np.abs(got[k] - want[k])
                          <= bf16_ulp(want[k])), k
    if grads == "zero":                # they did decay
        for k in per_layer_1d:
            assert not np.array_equal(got[k], before[k]), k
