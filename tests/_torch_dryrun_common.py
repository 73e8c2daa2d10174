"""What the dry-run test files share: one cell of the port's dry run on
the meta device (``repro_torch.launch.dryrun.run_cell``) held against the
JAX package's dry run, which is not imported here (it sets ``XLA_FLAGS``
when imported): the skip rule (``shape_applicable``), the record's
``roofline`` keys, ``model_flops`` by the reference's formula, and
``argument_bytes`` equal to the byte sum of the reference's
``jax.eval_shape`` trees (params, optimizer state, decode state, inputs)."""
import dataclasses
import functools
import math

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.compress.quantize import quantize_lm_params as jquantize
from repro.models import lm as jlm
from repro.sharding.ctx import default_ctx
from repro.train.optimizer import AdamWConfig as JAdamW
from repro.train.optimizer import adamw_init as jadamw_init
from repro_torch.launch import dryrun

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
# the keys of the reference's ``rec["roofline"]`` (src/repro/launch/dryrun.py)
REF_ROOFLINE_KEYS = (
    "chips", "hlo_flops_per_device", "hlo_int8_flops_per_device",
    "hlo_bytes_per_device", "collective_bytes_per_device",
    "collective_breakdown", "collective_counts", "t_compute", "t_memory",
    "t_collective", "dominant", "step_time_lower_bound_s", "model_flops",
    "useful_flops_ratio", "roofline_fraction")
REF_MEMORY_KEYS = ("argument_bytes", "output_bytes", "temp_bytes",
                   "generated_code_bytes")


def _nbytes(tree) -> int:
    return sum(math.prod(x.shape) * np.dtype(x.dtype).itemsize
               for x in jax.tree.leaves(tree))


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str, quantized: bool):
    cfg = jconfigs.get_config(arch)
    params = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0),
                                                    cfg))
    return jax.eval_shape(jquantize, params) if quantized else params


def ref_argument_bytes(arch: str, shape_name: str, variant: str) -> int:
    """The bytes of the reference's arguments of this cell, from its
    ``jax.eval_shape`` trees, as its dry run builds them."""
    cfg = jconfigs.get_config(arch)
    shape = jconfigs.get_shape(shape_name)
    params = _ref_params(arch, variant.startswith(("hqp", "int8w")))
    b, s = shape.global_batch, shape.seq_len
    n_fr = cfg.frontend.n_embeds if cfg.frontend.kind != "none" else 0
    total = _nbytes(params) + b * (s - n_fr if shape.kind != "decode"
                                   else 1) * 4
    if n_fr and shape.kind != "decode":
        total += b * n_fr * cfg.d_model * 2
    if shape.kind == "train":
        ocfg = JAdamW(state_dtype="int8" if cfg.param_count() > 5e10
                      else "f32")
        return total + _nbytes(jax.eval_shape(
            lambda p: jadamw_init(p, ocfg), params))
    ctx = dataclasses.replace(default_ctx(), quantized_kv=variant.startswith(
        ("hqp", "int8kv")))
    return total + _nbytes(jax.eval_shape(
        lambda: jlm.init_decode_state(cfg, b, s, ctx)))


def check_cell(arch: str, shape_name: str, variant: str) -> dict:
    rec = dryrun.run_cell(arch, shape_name, "1x1", variant, device="cpu",
                          save=False)
    jcfg = jconfigs.get_config(arch)
    jshape = jconfigs.get_shape(shape_name)
    ok, why = jconfigs.shape_applicable(jcfg, jshape)
    if not ok:
        assert rec["status"] == "skipped" and rec["reason"] == why, rec
        return rec
    assert rec["status"] == "ok", rec.get("traceback", rec)
    r, mem = rec["roofline"], rec["memory"]
    assert set(REF_ROOFLINE_KEYS) <= set(r)
    assert set(REF_MEMORY_KEYS) <= set(mem) and "fits_one_card" in mem
    tokens = jshape.global_batch * (jshape.seq_len
                                    if jshape.kind != "decode" else 1)
    factor = 6 if jshape.kind == "train" else 2
    assert r["model_flops"] == factor * jcfg.param_count(
        active_only=True) * tokens
    assert mem["argument_bytes"] == ref_argument_bytes(arch, shape_name,
                                                       variant)
    assert r["chips"] == 1 and r["collective_bytes_per_device"] == 0
    assert r["hlo_flops_per_device"] > 0 and r["hlo_bytes_per_device"] > 0
    assert r["step_time_lower_bound_s"] == max(
        r["t_compute"], r["t_memory"], r["t_collective"])
    assert r["dominant"] in ("t_compute", "t_memory")
    assert mem["fits_one_card"] == (
        mem["argument_bytes"] + mem["temp_bytes"] <= 80e9)
    return rec


def cells(archs):
    """(arch, shape, variant): every shape at baseline, and hqp at
    decode_32k."""
    return ([(a, s, "baseline") for a in archs for s in SHAPES]
            + [(a, "decode_32k", "hqp") for a in archs])


@pytest.fixture(autouse=True)
def one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

