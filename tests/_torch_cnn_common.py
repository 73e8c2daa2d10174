"""What the CNN track's test files share: the archs and the width they run
at, one intra-op thread, tree helpers for either package's leaves, and the
``nets`` fixture (the port's seed-0 variables and the JAX package's copy of
them, 8 images, and one Fisher diagonal, the port's, in both).

A test file imports the fixtures it uses (``nets``, ``one_thread``) so that
pytest finds them in its namespace."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs import get_cnn_config as jget_cnn_config
from repro_torch.configs import get_cnn_config
from repro_torch.data.synthetic import SyntheticImages
from repro_torch.models import cnn
from repro_torch.repro_exp import cnn_experiment as exp

ARCHS = ("resnet18", "mobilenetv3s")
WIDTH = 0.25


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while the file runs (the suite's workers would
    oversubscribe the cores otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t)


def flat(tree, prefix=()):
    """{path: numpy array} of a nested dict of either package's leaves."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, prefix + (k,)))
        return out
    return {prefix: np_(tree)}


def assert_trees(t, j, exact=False, **tol):
    ft, fj = flat(t), flat(j)
    assert sorted(ft) == sorted(fj)
    for path in fj:
        assert ft[path].shape == fj[path].shape, path
        if exact:
            np.testing.assert_array_equal(ft[path], fj[path], err_msg=str(path))
        else:
            np.testing.assert_allclose(ft[path], fj[path], err_msg=str(path),
                                       **tol)


def to_jax(tree):
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


def cfgs(arch, width=WIDTH):
    """The arch's config at ``width`` in the port and in the JAX package."""
    return (dataclasses.replace(get_cnn_config(arch), width_mult=width),
            dataclasses.replace(jget_cnn_config(arch), width_mult=width))


@pytest.fixture(scope="module")
def nets():
    """Per arch: both configs, the port's variables (seed 0) and the JAX
    package's copy of them, 8 images, and one Fisher diagonal (the port's,
    ``fisher_for`` on 16 calibration images) in both."""
    out = {}
    for arch in ARCHS:
        cfg, jcfg = cfgs(arch)
        tv = cnn.cnn_init(cfg, torch.Generator().manual_seed(0), device="cpu")
        tsq = exp.fisher_for(cfg, tv, SyntheticImages(16, seed=200),
                             batch_size=8)
        out[arch] = dict(cfg=cfg, jcfg=jcfg, tv=tv, jv=to_jax(tv),
                         x=SyntheticImages(8, seed=5).images,
                         tsq=tsq, jsq=to_jax(tsq))
    return out
