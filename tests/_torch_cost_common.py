"""What the cost-model test files share: the smoke cells (a decode step and
a prefill chunk against a 64-position cache, a train step), the port's
count of one on any device (``roofline/cost.py``), and the terms by which
the JAX package's count (``repro.roofline.hlo_cost`` on its compiled
program) differs from the port's, each computed from the shapes and named.

The terms, all bf16 products (the INT8 ones agree exactly):
  unembed_rest    prefill: the reference's ``decode_step`` computes every
                  position's logits, the port's the last one's;
  mamba_readout   y = h·C and, at one position, the causal conv: einsums in
                  the reference, elementwise products summed in the port;
                  on the train route the readout and its C gradient;
  mlstm_chunk     serving: the reference runs the mLSTM chunkwise (chunk
                  c = min(chunk, S)), the port steps it a position at a
                  time (q·k, the gated score's product with v and the C
                  update elementwise); a product of contraction 1 is a
                  multiply, which XLA does not count either;
  zero_carry      train: the reference's scans take the gradient of their
                  zero initial carry (the mLSTM's C, the sLSTM's h) at the
                  first step; the port's autograd skips a constant;
  remat           train: the reference rematerializes the scanned blocks
                  (``ctx.remat``), recomputing their forward, less each
                  group's last dense product, whose output the backward
                  does not read (XLA drops it); the port does not remat.
"""
import dataclasses

import torch

from repro_torch import configs
from repro_torch.compress.quantize import quantize_lm_params
from repro_torch.models import lm
from repro_torch.roofline import cost
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.train_step import make_train_step

B, CACHE, CHUNK, TRAIN_S = 2, 64, 16, 32
KINDS = ("decode", "prefill", "train")
CELLS = [(v, k) for v in ("baseline", "hqp") for k in KINDS
         if not (v == "hqp" and k == "train")]


def deep(arch: str, n_layers: int):
    """The smoke config at ``n_layers`` (its pattern repeated)."""
    cfg = configs.get_smoke_config(arch)
    reps = n_layers // len(cfg.pattern)
    return dataclasses.replace(
        cfg, n_layers=n_layers,
        block_pattern=cfg.block_pattern * reps if cfg.block_pattern else ())


def _to(tree, dev):
    from repro_torch.compress.qtypes import QuantizedLinear
    if isinstance(tree, QuantizedLinear):
        return QuantizedLinear(_to(tree.w_q, dev), _to(tree.scale, dev),
                               tree.bits)
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    if dev == "meta":
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    return tree


def port_count(cfg, variant: str, kind: str, device: str,
               train_s: int = TRAIN_S) -> cost.Cost:
    """The port's count of one smoke cell on ``device`` (the CPU: real
    values, every loop step; meta: shapes only, loops collapsed)."""
    params = lm.init_params(cfg, device="cpu")
    if variant == "hqp":
        params = quantize_lm_params(params)
    params = _to(params, device)
    with cost.record() as c:
        if kind == "train":
            step = make_train_step(cfg, AdamWConfig(), moe_no_drop=False)
            opt = adamw_init(params, AdamWConfig())
            tokens = torch.zeros((B, train_s), dtype=torch.int32,
                                 device=device)
            step(params, opt, {"tokens": tokens})
        else:
            state = lm.init_decode_state(cfg, B, CACHE, device=device,
                                         quantized_kv=variant == "hqp")
            s = 1 if kind == "decode" else CHUNK
            lm.decode_step(params, cfg, state,
                           torch.zeros((B, s), dtype=torch.int32,
                                       device=device))
    return c


def port_forward_flops(cfg) -> int:
    """The port's count of the train route's forward loss, no gradient."""
    params = lm.init_params(cfg, device="cpu")
    with torch.no_grad(), cost.record() as c:
        lm.loss_fn(params, cfg, {"tokens": torch.zeros(
            (B, TRAIN_S), dtype=torch.int32)}, with_aux=True,
            moe_no_drop=False)
    return c.flops


def named_terms(cfg, kind: str) -> dict:
    """{name: the reference's bf16 flops less the port's} of a smoke cell
    (see the module's docstring)."""
    d, v_pad = cfg.d_model, lm.padded_vocab(cfg)
    kinds = cfg.pattern
    n_mamba, n_mlstm, n_slstm = (kinds.count(k)
                                 for k in ("mamba", "mlstm", "slstm"))
    s = {"decode": 1, "prefill": CHUNK, "train": TRAIN_S}[kind]
    terms = {}
    if kind == "prefill":
        terms["unembed_rest"] = 2 * B * (s - 1) * d * v_pad
    if n_mamba:
        d_in, n = cfg.ssm.expand * d, cfg.ssm.d_state
        readout = 2 * B * s * d_in * n
        if kind == "train":
            terms["mamba_readout"] = 2 * readout * n_mamba
        else:
            conv = 2 * B * d_in * cfg.ssm.d_conv if s == 1 else 0
            terms["mamba_readout"] = (readout + conv) * n_mamba
    if n_mlstm:
        d_in = int(cfg.xlstm.proj_factor_mlstm * d)
        h = cfg.n_heads
        hd = d_in // h
        c = min(cfg.xlstm.chunk, s)
        if kind == "train":
            sh = d // cfg.n_heads
            terms["zero_carry"] = (2 * B * h * hd * hd * c * n_mlstm
                                   + 2 * B * cfg.n_heads * sh * 4 * sh
                                   * n_slstm)
        else:
            chunked = (2 * B * h * s * c * hd
                       + 2 * B * h * hd * hd * s) if c > 1 else 0
            terms["mlstm_chunk"] = (2 * B * h * s * c * hd + chunked) * n_mlstm
    if kind == "train":
        terms["remat"] = remat_term(cfg)
    return terms


def remat_term(cfg) -> int:
    """The forward of the reference's scanned blocks (the port's forward
    less the unembed, plus the reference's own extra forward products: the
    Mamba readout; less the mLSTM's carry update of a one-chunk scan,
    which XLA drops), less each group's last dense product (a dense MLP's
    down projection or an sLSTM's; an MoE layer's experts are read by its
    combine's backward and stay)."""
    d, v_pad = cfg.d_model, lm.padded_vocab(cfg)
    s = TRAIN_S
    blocks = port_forward_flops(cfg) - 2 * B * (s - 1) * d * v_pad
    kinds = cfg.pattern
    if "mamba" in kinds:
        blocks += (2 * B * s * cfg.ssm.expand * d * cfg.ssm.d_state
                   * kinds.count("mamba"))
    if "mlstm" in kinds and s <= cfg.xlstm.chunk:
        d_in = int(cfg.xlstm.proj_factor_mlstm * d)
        hd = d_in // cfg.n_heads
        blocks -= 2 * B * cfg.n_heads * hd * hd * s * kinds.count("mlstm")
    period = lm.pattern_period(cfg)
    groups = cfg.n_layers // period
    last, is_moe = lm.layer_specs(cfg)[period - 1]
    if last == "slstm":
        d_up = int(cfg.xlstm.proj_factor_slstm * d)
        blocks -= 2 * B * s * d_up * d * groups
    elif last in ("attn", "mamba") and not is_moe:
        blocks -= 2 * B * s * cfg.d_ff * d * groups
    return blocks


def ref_count(arch: str, variant: str, kind: str):
    """``repro.roofline.hlo_cost.analyze`` of the reference's jitted cell:
    ``decode_step`` (INT8 KV and ``quantize_lm_params`` under hqp) or the
    train step as its dry run builds it (remat, the capacity factor's
    drops)."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.compress.quantize import quantize_lm_params as jquantize
    from repro.models import lm as jlm
    from repro.roofline import hlo_cost
    from repro.sharding.ctx import default_ctx
    from repro.train.optimizer import AdamWConfig as JAdamW
    from repro.train.optimizer import adamw_init as jadamw_init
    from repro.train.train_step import make_train_step as jmake_train_step
    cfg = jconfigs.get_smoke_config(arch)
    ctx = dataclasses.replace(default_ctx(), quantized_kv=variant == "hqp",
                              remat=kind == "train",
                              moe_no_drop=kind != "train")
    params = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0),
                                                    cfg))
    if variant == "hqp":
        params = jax.eval_shape(jquantize, params)
    if kind == "train":
        ocfg = JAdamW()
        opt = jax.eval_shape(lambda p: jadamw_init(p, ocfg), params)
        batch = {"tokens": jax.ShapeDtypeStruct((B, TRAIN_S), jnp.int32)}
        lowered = jax.jit(jmake_train_step(cfg, ctx, ocfg)).lower(
            params, opt, batch)
    else:
        state = jax.eval_shape(
            lambda: jlm.init_decode_state(cfg, B, CACHE, ctx))
        s = 1 if kind == "decode" else CHUNK
        lowered = jax.jit(
            lambda p, st, t: jlm.decode_step(p, cfg, st, t, ctx)).lower(
            params, state, jax.ShapeDtypeStruct((B, s), jnp.int32))
    return hlo_cost.analyze(lowered.compile().as_text())


def check_against_reference(arch: str, variant: str, kind: str) -> None:
    """The port's flops and INT8 flops equal the reference's, less the
    named terms; its CPU count equals its meta count."""
    cfg = configs.get_smoke_config(arch)
    got = port_count(cfg, variant, kind, "cpu")
    assert got.counts() == port_count(cfg, variant, kind, "meta").counts()
    want = ref_count(arch, variant, kind)
    terms = named_terms(cfg, kind)
    assert got.int8_dot_flops == want.int8_dot_flops, (got.counts(), terms)
    assert got.flops + sum(terms.values()) == want.flops, (
        arch, variant, kind, got.flops, want.flops, terms)
