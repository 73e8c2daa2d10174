"""The port's architecture registry against the JAX package's, and the
three other dense configs (granite-3-8b, stablelm-1.6b, command-r-35b)
through the port's model on their smoke configs, same weights (carried
across by ``from_jax_params``), at the qwen3 slice's tolerances
(``test_torch_model.py``): the train-route hidden states within a bf16
ulp a layer, the decode-step logits within LOGIT_ATOL, and the greedy
token wherever the reference's top-2 gap exceeds twice that."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.sharding.ctx import default_ctx  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

DENSE = ("granite-3-8b", "stablelm-1.6b", "command-r-35b")
NEW = DENSE + ("phi3.5-moe-42b-a6.6b", "arctic-480b",
               "jamba-1.5-large-398b", "xlstm-1.3b", "phi-3-vision-4.2b",
               "musicgen-medium")
HIDDEN = dict(rtol=2 ** -7, atol=6.25e-2)
LOGIT_ATOL = 2e-2
N_STEPS = 8


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs (``test_torch_sampling``
    says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("smoke", [False, True], ids=["config", "smoke"])
@pytest.mark.parametrize("arch", NEW + ("qwen3-0.6b",))
def test_config_equals_reference_field_for_field(arch, smoke):
    """Every field of the port's config (its ``moe``, ``ssm``, ``xlstm``
    and ``frontend`` blocks included) holds the reference's value, and the
    properties the model reads and the parameter count agree; the one
    field the port has no copy of is ``attn_chunk_q``, which no code of
    the reference reads."""
    get_t, get_j = ((configs.get_smoke_config, jconfigs.get_smoke_config)
                    if smoke else (configs.get_config, jconfigs.get_config))
    t, j = get_t(arch), get_j(arch)
    for f in dataclasses.fields(t):
        tv, jv = getattr(t, f.name), getattr(j, f.name)
        if f.name in ("moe", "ssm", "xlstm", "frontend"):
            assert (tv is None) == (jv is None)
            if tv is not None:
                assert dataclasses.asdict(tv) == dataclasses.asdict(jv)
        else:
            assert tv == jv, f.name
    assert t.resolved_head_dim == j.resolved_head_dim
    assert t.pattern == j.pattern
    assert [t.is_moe_layer(i) for i in range(t.n_layers)] == [
        j.is_moe_layer(i) for i in range(j.n_layers)]
    assert t.param_count() == j.param_count()
    assert t.param_count(active_only=True) == j.param_count(active_only=True)
    missing = ({f.name for f in dataclasses.fields(j)}
               - {f.name for f in dataclasses.fields(t)})
    assert missing == {"attn_chunk_q"}
    assert t.n_frontend == (j.frontend.n_embeds
                            if j.frontend.kind != "none" else 0)


def test_registry_holds_the_ported_archs():
    """The registry is the reference's: its ten LM archs, each from the
    module of the same name; an unknown name still raises."""
    assert set(configs.ARCH_MODULES) == set(NEW) | {"qwen3-0.6b"}
    assert configs.ARCH_MODULES == jconfigs.ARCH_MODULES
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("musicgen-large")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("arch", DENSE)
def test_dense_arch_matches_reference(arch):
    """The train-route forward, then a prompt prefill and N_STEPS greedy
    decode steps fed the reference's tokens."""
    jcfg, cfg = jconfigs.get_smoke_config(arch), configs.get_smoke_config(arch)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    assert ("unembed" in tp) == (not cfg.tie_embeddings)
    ctx = default_ctx()
    rng = np.random.RandomState(3)
    toks = rng.randint(0, cfg.vocab_size, (2, 16))
    hj, _ = jax.jit(lambda p, t: jlm.forward(p, jcfg, {"tokens": t}))(
        jp, jnp.asarray(toks))
    ht = lm.forward(tp, cfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_f32(ht), _f32(hj), **HIDDEN)

    jstep = jax.jit(lambda p, st, t: jlm.decode_step(p, jcfg, st, t, ctx))
    prompt = rng.randint(0, cfg.vocab_size, (2, 11))
    jst = jlm.init_decode_state(jcfg, 2, 32, ctx, params=jp)
    tst = lm.init_decode_state(cfg, 2, 32, params=tp, device="cpu")
    jtok, ttok = jnp.asarray(prompt, jnp.int32), torch.from_numpy(prompt)
    real = slice(0, cfg.vocab_size)
    for step in range(N_STEPS + 1):
        jl, jst = jstep(jp, jst, jtok)
        tl, tst = lm.decode_step(tp, cfg, tst, ttok,
                                 route="prefill" if step == 0 else "decode")
        a, b = np.asarray(jl[:, -1])[:, real], tl[:, 0].numpy()[:, real]
        np.testing.assert_allclose(b, a, rtol=0, atol=LOGIT_ATOL,
                                   err_msg=f"step {step}")
        top2 = np.sort(a, axis=-1)[:, -2:]
        decided = top2[:, 1] - top2[:, 0] > 2 * LOGIT_ATOL
        np.testing.assert_array_equal(b.argmax(-1)[decided],
                                      a.argmax(-1)[decided])
        nxt = a.argmax(-1)[:, None]
        jtok, ttok = jnp.asarray(nxt, jnp.int32), torch.from_numpy(nxt)
