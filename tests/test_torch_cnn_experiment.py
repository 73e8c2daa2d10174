"""The port's CNN experiment on the CPU, held against the JAX package's
``repro_exp.cnn_experiment`` at small widths with the same weights and
numpy data: a training run (one momentum-SGD step after another, the
cosine learning rate, the batch order) and the Fisher pass
(``test_torch_cnn_compress.py`` holds ``compress``,
``test_torch_cnn_table.py`` the whole experiment through ``main``).

Tolerances and exact equalities:
  * training: the port in f32 against the reference in f64 (its f32
    training-mode gradients are ~1 % off at batch 8); two steps at lr 0.2
    and 0.1 move each param by lr·v: params and stats within rtol 1e-4,
    atol 1e-5;
  * Fisher: squared f32 gradients whose convs sum in other orders: each
    leaf within rtol 1e-3 and 1e-6 of its largest entry.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_cnn_common import flat, nets, one_thread  # noqa: E402,F401
from repro.data.synthetic import SyntheticImages as JImages  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.repro_exp import cnn_experiment as jexp  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.data.synthetic import SyntheticImages  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.repro_exp import cnn_experiment as exp  # noqa: E402


def test_training_run_equals_reference(nets, monkeypatch):
    """Two steps of each package's ``train_cnn`` from the same weights on
    the same data: the batch order (seed 1), the cosine learning rate (0.2
    then 0.1), the momentum and the BN statistics. The reference runs in
    f64: training-mode BN at batch 8 is ill-conditioned, and its own f32
    gradient of ``bn_stem``'s bias sits ~1 % from its f64 one, where the
    port's f32 one agrees with both packages' f64 to ~1e-4."""
    n = nets["resnet18"]
    monkeypatch.setattr(cnn, "cnn_init", lambda cfg, gen, device: tree.map_(
        torch.clone, n["tv"]))
    data, jdata = SyntheticImages(24, seed=0), JImages(24, seed=0)
    jdata.images = jdata.images.astype(np.float64)
    with jax.enable_x64(True):
        monkeypatch.setattr(jcnn, "cnn_init", lambda key, cfg: jax.tree.map(
            lambda t: jnp.asarray(t, jnp.float64), n["jv"]))
        jv = jax.tree.map(np.asarray, jexp.train_cnn(
            n["jcfg"], jdata, steps=2, batch_size=8, log=lambda s: None))
    tv = exp.train_cnn(n["cfg"], data, steps=2, batch_size=8,
                       log=lambda s: None, device="cpu")
    ft, fj = flat(tv), flat(jv)
    assert sorted(ft) == sorted(fj)
    for path, want in fj.items():
        np.testing.assert_allclose(ft[path], want, rtol=1e-4, atol=1e-5,
                                   err_msg=str(path))
    moved = max(np.abs(ft[p] - flat(n["tv"])[p]).max() for p in ft)
    assert moved > 1e-3
    for steps in (2, 7, 400):
        for i in range(steps):
            want = np.float32(0.2 * 0.5 * (1 + np.cos(np.pi * i / steps)))
            assert exp.cosine_lr(0.2, i, steps) == float(want)


def test_fisher_equals_reference(nets):
    n = nets["resnet18"]
    jsq = jexp.fisher_for(n["jcfg"], n["jv"], JImages(16, seed=200),
                          batch_size=8)
    fj, ft = flat(jsq), flat(n["tsq"])
    assert sorted(ft) == sorted(fj)
    for path, want in fj.items():
        np.testing.assert_allclose(ft[path], want, rtol=1e-3,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=str(path))
