"""The port's continuous-batching engine on the CPU (plain versions of the
kernels): the identity contracts it keeps inside itself, bit for bit, and
its tokens against the JAX package's engine on the same requests."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.compress import compress  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import SchedulerConfig as JSchedulerConfig  # noqa: E402
from repro.sharding.ctx import default_ctx  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.compress import quantize_lm_params  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402
from repro_torch.serving import SchedulerConfig, serial_decode  # noqa: E402
from repro_torch.serving import state_pool as sp  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

ARCH = "qwen3-0.6b"


@pytest.fixture(scope="module")
def setup():
    cfg = configs.get_smoke_config(ARCH)
    params = lm.init_params(cfg, seed=0, device="cpu")
    return cfg, {"fp": (params, False),
                 "hqp": (quantize_lm_params(params), True)}


def _prompts(cfg, lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, n).tolist() for n in lens]


@pytest.mark.parametrize("kind", ["fp", "hqp"])
def test_engine_equals_serial_decode(setup, kind):
    """Staggered arrivals, a prefill chunk (5) that divides no prompt, 4
    decode steps per host sync, windows crossing several 16-buckets:
    every output is token-identical to serial decode."""
    cfg, models = setup
    params, qkv = models[kind]
    prompts = _prompts(cfg, [13, 7, 30, 21], seed=2)
    eng = Engine(params, cfg, n_slots=3, max_seq=64,
                 sched=SchedulerConfig(prefill_chunk=5, decode_steps=4),
                 quantized_kv=qkv, device="cpu")
    res = eng.run([Request(prompt=p, max_new_tokens=12) for p in prompts],
                  arrival_ticks=[0, 2, 6, 9])
    assert eng.stats["decode_ticks"] > 0 and eng.stats["prefill_ticks"] > 4
    assert eng.stats["device_steps"] == 4 * eng.stats["decode_ticks"]
    for i, p in enumerate(prompts):
        want = serial_decode(params, cfg, p, 12, max_seq=64,
                             quantized_kv=qkv, device="cpu")
        assert res[i].tokens == want, i
        assert res[i].finish_reason == "length"


def test_engine_stops_at_eos_and_reuses_the_slot(setup):
    cfg, models = setup
    params, _ = models["fp"]
    prompts = _prompts(cfg, [8, 9], seed=1)
    first = serial_decode(params, cfg, prompts[0], 1, max_seq=32,
                          device="cpu")[0]
    eng = Engine(params, cfg, n_slots=1, max_seq=32, device="cpu")
    res = eng.run([Request(prompt=prompts[0], max_new_tokens=10,
                           eos_id=first),
                   Request(prompt=prompts[1], max_new_tokens=3)])
    assert res[0].tokens == [first] and res[0].finish_reason == "eos"
    assert len(res[1].tokens) == 3 and res[1].finish_reason == "length"


@pytest.mark.parametrize("quantized_kv", [False, True])
def test_chunked_prefill_bitwise_equals_whole_prompt(setup, quantized_kv):
    """A prompt prefilled in chunks of 5 through one slot of a pool, each
    chunk against its bucketed window, gives the logits of a whole-prompt
    prefill of the same prefix, bit for bit, at every chunk end."""
    cfg, models = setup
    params, _ = models["hqp" if quantized_kv else "fp"]
    prompt = torch.tensor(_prompts(cfg, [23], seed=4)[0])
    pool = sp.init_pool(cfg, 2, 48, params=params, quantized_kv=quantized_kv,
                        device="cpu")
    for lo in range(0, 23, 5):
        hi = min(23, lo + 5)
        window = -(-hi // 16) * 16
        chunked, new = lm.decode_step(params, cfg, sp.gather_slot(pool, 1, lo),
                                      prompt[None, lo:hi], window=window,
                                      route="prefill")
        sp.scatter_slot(pool, 1, new)
        whole_state = lm.init_decode_state(cfg, 1, 48, params=params,
                                           quantized_kv=quantized_kv,
                                           device="cpu")
        whole, _ = lm.decode_step(params, cfg, whole_state,
                                  prompt[None, :hi], route="prefill")
        assert torch.equal(chunked, whole), (lo, hi)
    assert int(pool["pos"][1]) == 23 and int(pool["pos"][0]) == 0


def _reference_logits(jp, jcfg, ctx, prompt, tokens):
    """The JAX package's serial logits for the token after prompt+tokens."""
    step = jax.jit(lambda p, st, t: jlm.decode_step(p, jcfg, st, t, ctx))
    st = jlm.init_decode_state(jcfg, 1, 48, ctx, params=jp)
    logits, st = step(jp, st, np.asarray([prompt], np.int32))
    for tok in tokens:
        logits, st = step(jp, st, np.asarray([[tok]], np.int32))
    return np.asarray(logits[0, -1])[:jcfg.vocab_size]


@pytest.mark.parametrize("kind", ["fp", "ptq"])
def test_engine_tokens_equal_the_reference_engine(kind):
    """The port's engine and the JAX package's engine, same weights, same
    requests: the same tokens. The logits are bf16 values and the reference
    can hold an exact tie (the PTQ model does, at the first token of the
    5-token prompt), whose break follows bits no other framework
    reproduces. So where the two first differ, the reference must hold an
    exact tie there: its logit for the port's token equals its best. Only
    then is the rest of that request not compared."""
    jcfg = jconfigs.get_smoke_config(ARCH)
    cfg = configs.get_smoke_config(ARCH)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    ctx = default_ctx()
    if kind == "ptq":
        jp = compress(jp, jcfg, log=lambda s: None).params
        ctx = dataclasses.replace(ctx, quantized_kv=True)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    prompts = _prompts(cfg, [9, 14, 5], seed=3)
    sched = dict(prefill_chunk=4, decode_steps=4)
    jres = JEngine(jp, jcfg, ctx=ctx, n_slots=2, max_seq=48,
                   sched=JSchedulerConfig(**sched)).run(
        [JRequest(prompt=p, max_new_tokens=8) for p in prompts])
    tres = Engine(tp, cfg, n_slots=2, max_seq=48,
                  sched=SchedulerConfig(**sched),
                  quantized_kv=ctx.quantized_kv, device="cpu").run(
        [Request(prompt=p, max_new_tokens=8) for p in prompts])
    compared = 0
    for i, prompt in enumerate(prompts):
        got, want = tres[i].tokens, jres[i].tokens
        n = next((t for t in range(len(want)) if got[t] != want[t]),
                 len(want))
        compared += n
        if n < len(want):
            ref = _reference_logits(jp, jcfg, ctx, prompt, want[:n])
            assert ref.argmax() == want[n]
            assert ref[got[n]] == ref.max(), (i, n)      # an exact tie
    assert compared >= 16


def test_entry_points_default_to_the_card(setup, monkeypatch):
    """device=None means CUDA; without it the entry points raise instead of
    quietly running on the CPU."""
    cfg, models = setup
    params, _ = models["fp"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(params, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serial_decode(params, cfg, [1, 2, 3], 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        from_jax_params({"w": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="params lie on"):
        Engine(params, cfg, device="meta")


def test_serve_cli_engine_verifies_on_cpu(capsys):
    stats = serve.main(["--smoke", "--device", "cpu", "--engine", "--hqp",
                        "--tokens", "6", "--prompt-len", "9",
                        "--max-seq", "32"])
    out = capsys.readouterr().out
    assert stats["n_requests"] == 4
    assert "token-identical to serial decode" in out
    # --hqp runs the whole pipeline, 3 conditional prune steps by default
    assert "over 3 conditional steps" in out
    serve.main(["--smoke", "--device", "cpu", "--hqp", "--prune-steps", "2",
                "--tokens", "4", "--prompt-len", "9", "--max-seq", "32"])
    assert "over 2 conditional steps" in capsys.readouterr().out
