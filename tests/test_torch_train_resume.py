"""The train launcher on the MoE, hybrid and xLSTM families on the CPU
(``python -m repro_torch.launch.train --arch <each> --smoke --device cpu
--ckpt-dir D``), with f32 and with INT8 moments: a run of 2 steps
checkpoints its params and moments (3-D expert leaves, f32 router leaves,
Mamba's ``a_log``, ``d_skip`` and conv leaves, the mLSTM and sLSTM
leaves) in the JAX layout; a second run to 4 resumes from it; both runs
equal, bit for bit, the train step replayed in process over the
launcher's batches (a resumed run reshuffles from its start step, as the
reference's launcher does), and the checkpoints hold those bits."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs, tree  # noqa: E402
from repro_torch.data.synthetic import SyntheticTokens  # noqa: E402
from repro_torch.launch import checkpoint as ckpt  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

FAMILIES = ("phi3.5-moe-42b-a6.6b", "jamba-1.5-large-398b", "xlstm-1.3b")
BATCH, SEQ, LR = 4, 32, 3e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs (``test_torch_sampling``
    says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _main(arch, ckpt_dir, steps, state_dtype):
    return train.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--steps", str(steps), "--batch", str(BATCH),
                       "--seq", str(SEQ), "--lr", str(LR),
                       "--ckpt-dir", str(ckpt_dir), "--ckpt-every", "2",
                       "--eval-every", "0", "--state-dtype", state_dtype])


def _same(a, b):
    la, lb = tree.leaves(a), tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("state_dtype", ["f32", "int8"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_the_launcher_resumes_bit_for_bit(arch, state_dtype, tmp_path,
                                          capsys):
    cfg = configs.get_smoke_config(arch)
    ocfg = opt.AdamWConfig(lr=LR, state_dtype=state_dtype)
    step = make_train_step(cfg, ocfg, moe_no_drop=False)
    data = SyntheticTokens(cfg.vocab_size, SEQ + 1, 4096, seed=0)

    def replay(params, state, start, stop):
        it = data.batches(BATCH, seed=start, epochs=10_000)
        for _ in range(start, stop):
            batch = {"tokens": torch.as_tensor(next(it)["tokens"],
                                               dtype=torch.long)}
            params, state, m = step(params, state, batch)
            assert np.isfinite(float(m["loss"]))
        return params, state

    def like():
        p = lm.init_params(cfg, seed=0, device="cpu")
        return p, opt.adamw_init(p, ocfg)

    p2_cli = _main(arch, tmp_path, 2, state_dtype)
    (p2, o2), meta = ckpt.restore(str(tmp_path), like())
    assert meta["step"] == 2 and meta["arch"] == arch
    _same(p2, p2_cli)
    _same((p2, o2), replay(*like(), 0, 2))
    p4_cli = _main(arch, tmp_path, 4, state_dtype)
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "step_000000004" in out
    (p4, o4), meta = ckpt.restore(str(tmp_path), like())
    assert meta["step"] == 4
    _same(p4, p4_cli)
    _same((p4, o4), replay(p2, o2, 2, 4))
    if state_dtype == "int8":
        m = o4["m"]["blocks"][0]
        assert all(leaf.dtype == torch.int8 for key, leaf in
                   _leaves_with_keys(m) if key == "q")


def _leaves_with_keys(node, key=None):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves_with_keys(v, k)
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _leaves_with_keys(v, key)
    else:
        yield key, node
