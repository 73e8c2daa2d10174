"""The port's ``compress(track="fake")`` on the CNNs, held against the
JAX package's with the same weights and one Fisher diagonal (the port's)
in both: Algorithm 1's decisions, the manifest and the fake-quantized
params of a pruned artifact and of a PTQ-only one.

Tolerances and exact equalities: Algorithm 1's decisions and the manifest
(but for the steps' seconds) are exact; the fake-quantized params within
one quantization step (ROADMAP C1).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cnn_common import flat, nets, one_thread  # noqa: E402,F401
from repro.compress import compress as jcompress  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core import sensitivity as jsens  # noqa: E402
from repro_torch.compress.artifact import compress  # noqa: E402
from repro_torch.core import pipeline as pipe  # noqa: E402
from repro_torch.core import sensitivity as sens  # noqa: E402


def _conv_fraction(variables):
    """A deterministic accuracy stand-in, exact in both packages: the
    fraction of conv-weight entries not masked."""
    ws = [v for v in flat(variables["params"]).values() if v.ndim == 4]
    return sum(np.count_nonzero(w) for w in ws) / sum(w.size for w in ws)


@pytest.mark.parametrize("arch,pruned", [("resnet18", True),
                                         ("resnet18", False)])
def test_compress_fake_manifest_equals_reference(nets, arch, pruned):
    """``compress(track="fake")`` with one Fisher, the specs, ``a_baseline``
    and one deterministic eval_fn: Algorithm 1's decisions (the history's
    n_drop, accuracies and accept/reject) and the whole manifest equal to
    the reference's but for the steps' seconds, the baseline not evaluated
    again; the params' shapes equal and their values within one step. A
    PTQ-only artifact too; one of sq_grads and eval_fn alone is refused."""
    n = nets[arch]
    calls = []

    def eval_fn(variables):
        calls.append(1)
        return 0.9 * _conv_fraction(variables)

    hqp = dict(delta_ax=0.05, step_frac=0.02, max_steps=60, track="fake")
    jkw = dict(sq_grads=n["jsq"], eval_fn=eval_fn, a_baseline=0.9,
               specs=jsens.cnn_prune_groups(n["jcfg"], n["jv"])) \
        if pruned else {}
    tkw = dict(sq_grads=n["tsq"], eval_fn=eval_fn, a_baseline=0.9,
               specs=sens.cnn_prune_groups(n["cfg"], n["tv"])) \
        if pruned else {}
    quiet = lambda s: None  # noqa: E731
    jart = jcompress(n["jv"], n["jcfg"], hqp=jpipe.HQPConfig(**hqp),
                     log=quiet, **jkw)
    n_ref = len(calls)
    tart = compress(n["tv"], n["cfg"], hqp=pipe.HQPConfig(**hqp), log=quiet,
                    **tkw)
    jm, tm = jart.manifest.asdict(), tart.manifest.asdict()
    assert len(calls) - n_ref == n_ref == len(tm["history"])
    for h in jm["history"] + tm["history"]:
        h.pop("seconds")
    assert tm == jm
    assert tm["pruned"] == pruned and tm["track"] == "fake"
    if pruned:
        assert 0 < tm["n_drop"] < tm["total_units"]
        assert not tm["history"][-1]["accepted"]
    fj, ft = flat(jart.params), flat(tart.params)
    assert sorted(ft) == sorted(fj)
    for path, want in fj.items():
        assert ft[path].shape == want.shape, path
        step = np.abs(want).max() / 127
        assert np.all(np.abs(ft[path] - want) <= step * 1.0001), path
    with pytest.raises(ValueError, match="must be given together"):
        compress(n["tv"], n["cfg"], sq_grads=n["tsq"])
