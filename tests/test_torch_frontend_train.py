"""Training of the frontend configs (phi-3-vision-4.2b, musicgen-medium)
held against the JAX package on their smoke configs: one AdamW step of
``make_train_step`` at 1 and 2 microbatches, seeded random embeddings cut
by rows with the tokens (``_torch_train_common.check_step``: the metrics,
the first moments leaf by leaf, every param within 2·lr + one bf16 ulp),
and the train launcher's loss lines against the reference launcher's on
the same seed-0 weights, its batches carrying zero embeddings."""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_frontend_common import (ARCHS, embeds, make, np_tree,  # noqa: E402,F401
                                    one_thread)
from _torch_train_common import (LOSS_RTOL, bf16_ulp, check_step,  # noqa: E402
                                 flat_port, flat_ref)
from repro import configs as jconfigs  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    d = make(request.param)
    d["tokens"] = np.random.RandomState(11).randint(
        0, d["cfg"].vocab_size, (2, 32))
    d["embeds"] = embeds(d["cfg"], 2, 12)
    return d


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(family, microbatches):
    check_step(family, microbatches)


def _losses(text: str) -> dict:
    return {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"\[train\] step (\d+) loss=([0-9.]+)", text)}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_matches_reference(arch, capsys, monkeypatch):
    """``launch/train.py --smoke`` for 3 steps with an evaluation after
    each, on the reference's seed-0 weights (the port's own seed-0
    weights are other numbers): the first step's loss equals the
    reference launcher's within LOSS_RTOL, and every param it returns
    lies within 2·lr a step + one bf16 ulp of the reference's (Adam's
    step moves a weight by about ±lr whatever its gradient's size, so a
    sign the frameworks' roundings flip moves it by up to 2·lr)."""
    steps, lr = 3, 3e-3
    argv = ["--arch", arch, "--smoke", "--steps", str(steps), "--batch",
            "4", "--seq", "16", "--eval-every", "1", "--lr", str(lr)]
    want_p = flat_ref(jtrain.main(argv))
    want = _losses(capsys.readouterr().out)
    jparams = np_tree(jlm.init_params(jax.random.PRNGKey(0),
                                      jconfigs.get_smoke_config(arch)))
    monkeypatch.setattr(lm, "init_params", lambda cfg, seed=0, device=None:
                        from_jax_params(jparams, device=device))
    got_p = flat_port(train.main(argv + ["--device", "cpu"]))
    out = capsys.readouterr().out
    assert out.count("next-token-acc=") == steps
    got = _losses(out)
    assert sorted(got) == sorted(want) == [0, steps - 1]
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
    assert sorted(got_p) == sorted(want_p)
    for k, b in want_p.items():
        a = got_p[k]
        ulp = bf16_ulp(np.maximum(np.abs(a), np.abs(b)))
        assert np.all(np.abs(a - b) <= 2 * lr * steps + ulp), k
