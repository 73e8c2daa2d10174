"""ROADMAP C16: the JAX package's decode compiled against the same decode
under ``jax.disable_jit``, and the port's decode against both, on the CPU.

For the two frontend smoke configs, with seed-0 weights, a (2, 11) prompt
from ``RandomState(7)`` and embeddings from seed 8 (the input of
``tests/test_torch_frontend.py::test_prefill_with_embeds_then_decode``):
the largest |logit difference| between the port and each form of the
reference over a prefill and 8 decode steps fed the reference's tokens,
in bf16 and INT8 PTQ params and bf16 and INT8 KV; then, with INT8 PTQ
params and INT8 KV, the largest step between the compiled and the eager
reference's KV codes after the prefill, layer by layer (qwen3-0.6b's
smoke config too).

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/c16_reference_jit_gap.py
"""
import dataclasses
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from _torch_frontend_common import (ARCHS, batches, embeds, make,  # noqa: E402
                                    np_tree)

from repro import configs as jconfigs  # noqa: E402
from repro.compress.quantize import quantize_lm_params as jquantize  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.sharding.ctx import default_ctx  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

N_STEPS = 8


def eager(fn):
    """``fn`` run under ``jax.disable_jit``."""
    def run(*args):
        with jax.disable_jit():
            return fn(*args)
    return run


# the reference's decode step as its tests' eager blocks run it, and as
# its launcher runs it
FORMS = {"eager": eager, "compiled": jax.jit}


def logit_gaps(model, int8: bool, quantized_kv: bool) -> dict:
    """{form: the port's largest |logit difference| from that form}."""
    cfg, jcfg, jp = model["cfg"], model["jcfg"], model["jp"]
    if int8:
        jp = jquantize(jp)
    tp = from_jax_params(np_tree(jp), device="cpu")
    ctx = dataclasses.replace(model["ctx"], quantized_kv=quantized_kv)
    prompt = np.random.RandomState(7).randint(0, cfg.vocab_size, (2, 11))
    jb, tb = batches(prompt, embeds(cfg, 2, 8))
    real = slice(0, cfg.vocab_size)
    out = {}
    for form, wrap in FORMS.items():
        jstep = wrap(lambda p, st, tok, *emb: jlm.decode_step(
            p, jcfg, st, tok, ctx, *emb))
        tst = lm.init_decode_state(cfg, 2, 48, params=tp,
                                   quantized_kv=quantized_kv, device="cpu")
        tl, tst = lm.decode_step(tp, cfg, tst, tb["tokens"], route="prefill",
                                 embeds=tb["embeds"])
        jst = jlm.init_decode_state(jcfg, 2, 48, ctx, params=jp)
        jl, jst = jstep(jp, jst, jb["tokens"], jb["embeds"])
        worst = 0.0
        for step in range(N_STEPS + 1):
            if step:
                jl, jst = jstep(jp, jst, jtok)
                tl, tst = lm.decode_step(tp, cfg, tst, ttok, route="decode")
            a, b = np.asarray(jl[:, -1])[:, real], tl[:, 0].numpy()[:, real]
            worst = max(worst, float(np.abs(a - b).max()))
            nxt = a.argmax(-1)[:, None]
            jtok, ttok = jnp.asarray(nxt, jnp.int32), torch.from_numpy(nxt)
        out[form] = worst
    return out


def kv_code_steps(arch: str) -> dict:
    """{cache leaf: the largest code step, compiled against eager, by
    layer} after a prefill with INT8 PTQ params and INT8 KV."""
    if arch in ARCHS:
        model = make(arch)
        jcfg, jp, ctx = model["jcfg"], model["jp"], model["ctx"]
        prompt = np.random.RandomState(7).randint(0, jcfg.vocab_size, (2, 11))
        jb, _ = batches(prompt, embeds(model["cfg"], 2, 8))
        extra = (jb["embeds"],)
    else:
        jcfg, ctx = jconfigs.get_smoke_config(arch), default_ctx()
        jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
        prompt = np.random.RandomState(7).randint(0, jcfg.vocab_size, (2, 11))
        jb, extra = {"tokens": jnp.asarray(prompt, jnp.int32)}, ()
    jp = jquantize(jp)
    ctx = dataclasses.replace(ctx, quantized_kv=True)
    caches = {}
    for form, wrap in FORMS.items():
        jstep = wrap(lambda p, st, tok, *emb: jlm.decode_step(
            p, jcfg, st, tok, ctx, *emb))
        st = jlm.init_decode_state(jcfg, 2, 48, ctx, params=jp)
        _, st = jstep(jp, st, jb["tokens"], *extra)
        caches[form] = jax.tree_util.tree_leaves_with_path(st["caches"])
    out = {}
    for (path, a), (_, b) in zip(caches["eager"], caches["compiled"]):
        if a.dtype == jnp.int8:
            d = np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))
            out[jax.tree_util.keystr(path)] = [int(x.max()) for x in d]
    return out


def main() -> None:
    torch.set_num_threads(1)
    for arch in ARCHS:
        model = make(arch)
        for int8 in (False, True):
            for quantized_kv in (False, True):
                gaps = logit_gaps(model, int8, quantized_kv)
                print(f"{arch} {'ptq' if int8 else 'bf16'} params, "
                      f"{'int8' if quantized_kv else 'bf16'} KV: the port's "
                      f"max |logit diff| from the reference "
                      + ", ".join(f"{f} {g!r}" for f, g in gaps.items()))
    for arch in ARCHS + ("qwen3-0.6b",):
        print(f"{arch} INT8 KV codes after the prefill, compiled vs eager, "
              f"largest step by layer: {kv_code_steps(arch)}")


if __name__ == "__main__":
    main()
