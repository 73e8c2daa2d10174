"""The continuous-batching engine serving an MoE model on the CPU (the
plain versions of the kernels): the phi3.5-moe smoke artifact that the
port's launcher builds (Fisher, Algorithm 1 with the expert family,
compaction, per-expert INT8 PTQ) equals serial decode bit for bit,
contiguous and paged; greedy speculative serving (the artifact drafts, its
bf16 parent verifies) equals serial decode of the parent; and the serve
launcher verifies itself on the MoE arch. Batch invariance of the expert
dispatch is what makes these hold: a token routes and computes the same
bits whatever shares its dispatch."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.compress import QuantizedLinear  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import Engine, Request, SchedulerConfig  # noqa: E402
from repro_torch.serving import serial_decode  # noqa: E402

ARCH = "phi3.5-moe-42b-a6.6b"
MAX_SEQ = 64


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs (``test_torch_sampling``
    says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """The smoke config, its seed-0 bf16 params, and the launcher's HQP
    artifact of them (three conditional steps)."""
    cfg = configs.get_smoke_config(ARCH)
    parent = lm.init_params(cfg, seed=0, device="cpu")
    art = serve.build_artifact(parent, cfg, prune_steps=3,
                               log=lambda s: None)
    return cfg, parent, art


def _prompts(cfg, lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, n).tolist() for n in lens]


def test_artifact_quantizes_every_expert(setup):
    cfg, _, art = setup
    assert art.manifest.pruned and len(art.manifest.history) == 3
    assert set(art.manifest.theta_by_family) == {
        f"L{i}/{kind}" for i in range(cfg.n_layers)
        for kind in ("kv_heads", "experts")}
    for blk in art.params["blocks"]:
        for name in ("gate", "up", "down"):
            q = blk["moe"][name]
            assert isinstance(q, QuantizedLinear) and q.w_q.ndim == 3
        assert blk["moe"]["router"]["w"].dtype == torch.float32


@pytest.mark.parametrize("page_size", [None, 16], ids=["contiguous", "paged"])
def test_engine_equals_serial_decode(setup, page_size):
    """Staggered arrivals, a prefill chunk (5) that divides no prompt, 4
    decode steps a host sync, INT8 KV: every request token-identical to
    serial decode of the artifact."""
    cfg, _, art = setup
    prompts = _prompts(cfg, [13, 7, 30, 21], seed=2)
    eng = Engine(art.params, cfg, n_slots=3, max_seq=MAX_SEQ,
                 sched=SchedulerConfig(prefill_chunk=5, decode_steps=4),
                 quantized_kv=True, device="cpu", page_size=page_size)
    res = eng.run([Request(prompt=p, max_new_tokens=10) for p in prompts],
                  arrival_ticks=[0, 2, 6, 9])
    assert eng.stats["decode_ticks"] > 0 and eng.stats["prefill_ticks"] > 4
    for i, p in enumerate(prompts):
        assert res[i].tokens == serial_decode(
            art.params, cfg, p, 10, max_seq=MAX_SEQ, quantized_kv=True,
            device="cpu"), i
    if eng.paged:
        eng.alloc.check()


def test_greedy_speculative_equals_serial_decode(setup):
    """The INT8 artifact drafts k = 4 tokens over its INT8 KV, the bf16
    parent verifies them: every request equals serial decode of the
    parent."""
    cfg, parent, art = setup
    prompts = _prompts(cfg, [11, 6, 19], seed=4)
    eng = Engine(parent, cfg, n_slots=2, max_seq=MAX_SEQ,
                 sched=SchedulerConfig(prefill_chunk=5, decode_steps=4),
                 device="cpu", draft_params=art.params, spec_k=4)
    res = eng.run([Request(prompt=p, max_new_tokens=9) for p in prompts],
                  arrival_ticks=[0, 1, 3])
    for i, p in enumerate(prompts):
        assert res[i].tokens == serial_decode(parent, cfg, p, 9,
                                              max_seq=MAX_SEQ,
                                              device="cpu"), i
    assert eng.stats["drafted_tokens"] > 0


@pytest.mark.parametrize("page_size", [None, "16"], ids=["contiguous",
                                                         "paged"])
def test_serve_cli_verifies_the_moe_arch(capsys, page_size):
    """``serve --arch phi3.5-moe-42b-a6.6b --smoke --engine --hqp``: the
    manifest's expert families, and engine == serial decode."""
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--engine",
            "--hqp", "--prune-steps", "3", "--tokens", "6", "--prompt-len",
            "9", "--max-seq", "32", "--verify"]
    serve.main(argv + (["--page-size", page_size] if page_size else []))
    out = capsys.readouterr().out
    assert f"artifact({ARCH}-smoke/int8)" in out
    assert "token-identical to serial decode" in out
