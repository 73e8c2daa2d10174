"""Fault C12 on the CPU: HQP may cut every kv head of an attention layer
(and every expert of an MoE layer, and every Mamba column). ROADMAP C12's
input (the smoke config's seed-0 model, a Fisher pass on the launcher's
calibration batch, an eval that accepts every step, ``step_frac=0.5``,
``max_steps=2``, channel granularity) does it on qwen3, phi3.5-moe, jamba
and arctic. The reference's PTQ raises on it (C5). The port's artifact
builds: a layer with no head, or with no expert, adds zeros, as its masked
layer does; the compacted model computes what the masked one does, bit for
bit; the artifact's KV caches hold 0 bytes; the engine serves it equal to
serial decode, contiguous and paged. The attend ops refuse 0 kv heads by
name."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.compress import compress as jcompress  # noqa: E402
from repro.core.pipeline import HQPConfig as JHQPConfig  # noqa: E402
from repro_torch import configs, tree  # noqa: E402
from repro_torch.compress.artifact import compress  # noqa: E402
from repro_torch.core import sensitivity as sens  # noqa: E402
from repro_torch.core.pipeline import HQPConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import Engine, Request, SchedulerConfig  # noqa: E402
from repro_torch.serving import serial_decode  # noqa: E402
from repro_torch.weights import stack_blocks  # noqa: E402

ARCHS = ("qwen3-0.6b", "phi3.5-moe-42b-a6.6b", "jamba-1.5-large-398b",
         "arctic-480b")
C12 = dict(step_frac=0.5, max_steps=2, weight_granularity="channel")
MAX_SEQ = 64


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs (``test_torch_sampling``
    says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def c12(request):
    """ROADMAP C12's input and the port's artifact of it."""
    cfg = configs.get_smoke_config(request.param)
    params = lm.init_params(cfg, seed=0, device="cpu")
    batch = serve._calib_batch(cfg, 2, 32, device="cpu")
    sq = sens.fisher_diag(sens.loss_grad_fn(
        lambda p, b: lm.loss_fn(p, cfg, b)), params, [batch])[0]
    art = compress(params, cfg, sq, lambda p: 1.0, HQPConfig(**C12),
                   log=lambda s: None)
    return dict(arch=request.param, cfg=cfg, params=params, sq=sq,
                batch=batch, art=art)


def _to_jax(t):
    """A port tree in the JAX layout, as JAX arrays of the same dtypes."""
    def leaf(x):
        a = jnp.asarray(x.detach().float().numpy())
        return a.astype(jnp.bfloat16) if x.dtype == torch.bfloat16 else a
    return jax.tree.map(leaf, stack_blocks(t))


def test_the_reference_raises(c12):
    """The reference's compress on the same weights and Fisher diagonal
    accepts both steps, cuts every unit, and its PTQ raises on the empty
    leaves (ROADMAP C5)."""
    jcfg = jconfigs.get_smoke_config(c12["arch"])
    with pytest.raises(ValueError, match="zero-size"):
        jcompress(_to_jax(c12["params"]), jcfg, _to_jax(c12["sq"]),
                  lambda p: 1.0, JHQPConfig(**C12), log=lambda s: None)


def test_every_unit_is_cut_and_the_compacted_equals_the_masked(c12):
    """θ 100 % in every family; every attention layer compacts to no head
    (``wq`` (d, 0), ``wo`` (0, d)), every MoE layer to no expert (router
    (d, 0)); the compacted model's hidden states equal the masked one's,
    bit for bit, and so do the INT8 artifact's against the masked model
    quantized (``compress`` without a prune)."""
    cfg, art = c12["cfg"], c12["art"]
    assert set(art.manifest.theta_by_family.values()) == {1.0}
    for blk in art.prune.params_compact["blocks"]:
        if "attn" in blk:
            assert blk["attn"]["wq"]["w"].shape == (cfg.d_model, 0)
            assert blk["attn"]["wo"]["w"].shape == (0, cfg.d_model)
        if "moe" in blk:
            assert blk["moe"]["router"]["w"].shape == (cfg.d_model, 0)
    hm = lm.forward(art.prune.params_sparse, cfg, c12["batch"])
    hc = lm.forward(art.prune.params_compact, cfg, c12["batch"])
    assert torch.isfinite(hc.float()).all()
    assert torch.equal(hc, hm)
    masked_q = compress(art.prune.params_sparse, cfg, log=lambda s: None)
    assert torch.equal(lm.forward(art.params, cfg, c12["batch"]),
                       lm.forward(masked_q.params, cfg, c12["batch"]))


@pytest.mark.parametrize("page_size", [None, 16], ids=["contiguous", "paged"])
def test_the_artifact_serves_equal_to_serial_decode(c12, page_size):
    """Engine == serial decode on the artifact, staggered, a prefill chunk
    of 4; the KV state of a layer with no head holds 0 bytes."""
    cfg, art = c12["cfg"], c12["art"]
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist() for n in (5, 9, 3)]
    want = [serial_decode(art.params, cfg, p, 6, max_seq=MAX_SEQ,
                          device="cpu") for p in prompts]
    eng = Engine(art.params, cfg, n_slots=2, max_seq=MAX_SEQ,
                 sched=SchedulerConfig(prefill_chunk=4), device="cpu",
                 page_size=page_size)
    res = eng.run([Request(prompt=p, max_new_tokens=6) for p in prompts],
                  arrival_ticks=[0, 0, 3])
    assert [res[i].tokens for i in range(3)] == want
    assert eng.stats["kv_bytes"] == 0
    st = lm.init_decode_state(cfg, 2, MAX_SEQ, params=art.params,
                              device="cpu")
    for kind, cache in zip(cfg.pattern, st["caches"]):
        if kind == "attn":
            assert sum(t.numel() for t in tree.leaves(cache)) == 0


def test_a_layer_with_no_head_adds_zeros_on_every_route(c12):
    """The attention layer of the artifact returns bf16 zeros of (B, S, d)
    on the train, prefill and decode routes, contiguous and paged, and
    writes no K/V."""
    cfg, art = c12["cfg"], c12["art"]
    i = cfg.pattern.index("attn")
    p = art.params["blocks"][i]["attn"]
    x = torch.randn(2, 3, cfg.d_model).to(torch.bfloat16)
    pos = torch.arange(3)[None].expand(2, 3)
    hd = cfg.resolved_head_dim
    outs = [A.attention_forward(p, cfg, x, pos, route=A.TRAIN)]
    cache = A.init_kv_cache(2, 16, 0, hd, True, "cpu")
    outs.append(A.attention_forward(p, cfg, x, pos, cache, 0,
                                    route=A.PREFILL))
    outs.append(A.attention_forward(p, cfg, x[:, :1], pos[:, :1], cache, 3,
                                    route=A.DECODE))
    arena = A.init_kv_cache(4, 8, 0, hd, False, "cpu")
    pages = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    outs.append(A.attention_forward(p, cfg, x, pos, arena, 0,
                                    route=A.PREFILL, pages=pages))
    for o in outs:
        assert o.dtype == torch.bfloat16 and o.shape[-1] == cfg.d_model
        assert not o.any()


def _zero_head_inputs():
    q = torch.randn(2, 4, 0, 16).to(torch.bfloat16)
    k = torch.zeros(2, 8, 0, 16, dtype=torch.bfloat16)
    cache = {"k": k, "v": k.clone()}
    arena = {"k": torch.zeros(4, 4, 0, 16, dtype=torch.bfloat16),
             "v": torch.zeros(4, 4, 0, 16, dtype=torch.bfloat16)}
    pages = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    return q, k, cache, arena, pages


@pytest.mark.parametrize("op", ["flash_attention", "prefill_attention",
                                "decode_attention", "paged_prefill_attention",
                                "paged_decode_attention"])
def test_the_attend_ops_refuse_zero_kv_heads_by_name(op):
    """B3-B7 and their plain versions: an attend over 0 kv heads raises a
    ``ValueError`` naming the cause, before the head grouping divides by
    zero or a grid launches empty."""
    q, k, cache, arena, pages = _zero_head_inputs()
    calls = {
        "flash_attention": lambda: ops.flash_attention(q, k, k),
        "prefill_attention": lambda: ops.prefill_attention(q, cache, 0),
        "decode_attention": lambda: ops.decode_attention(q[:, :1], cache, 3),
        "paged_prefill_attention": lambda: ops.prefill_attention(
            q, arena, 0, pages=pages),
        "paged_decode_attention": lambda: ops.decode_attention(
            q[:, :1], arena, 3, pages=pages)}
    with pytest.raises(ValueError, match="0 kv heads"):
        calls[op]()
