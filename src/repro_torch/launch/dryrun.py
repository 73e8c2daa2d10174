"""Dry run: every (arch x shape) cell traced on the meta device, priced on
one H100 (the JAX package's ``launch/dryrun.py``).

Each cell builds its params, optimizer state and decode state on the meta
device (shapes and dtypes, no memory), runs the port's train step, prefill
or decode step under ``roofline.cost.record`` and writes what it counted:
the reference's record, with ``memory`` (``argument_bytes`` exact from the
meta tensors, ``temp_bytes`` the recorder's peak of live outputs,
``fits_one_card`` against ``H100_SXM.hbm_bytes``) and ``roofline`` (the
three terms on ``H100_SXM``, the dominant one, the lower bound of a step,
``model_flops`` by the reference's formula). No kernel launches: a meta
tensor takes each op's plain version, shapes only, and each kernel's op
records its work at its boundary.

The 1x1 mesh is the card the plan is for (``--device``; the card unless
``--device cpu`` is asked for). On the production meshes (16x16, 2x16x16)
``argument_bytes`` is per device, from ``sharding.rules``' placements; the
per-device flops and the collective terms are null until sharded
execution is ported (ROADMAP A14 (rest)), and the record says so.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all --device cpu
Writes one JSON per cell to experiments/dryrun_torch/."""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
import traceback
from typing import Any, Optional

import torch

from repro_torch import configs
from repro_torch.compress.qtypes import QuantizedLinear
from repro_torch.compress.quantize import quantize_lm_params
from repro_torch.configs import (LM_SHAPES, get_config, get_shape,
                                 shape_applicable)
from repro_torch.launch.mesh import make_host_mesh, mesh_by_name
from repro_torch.models import lm
from repro_torch.roofline import cost
from repro_torch.roofline.hardware import H100_SXM
from repro_torch.sharding import rules
from repro_torch.sharding.ctx import make_ctx
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.train_step import make_train_step

OUT_DIR = (pathlib.Path(__file__).resolve().parents[3] / "experiments"
           / "dryrun_torch")
META = torch.device("meta")
POS_BYTES = 4       # a decode state's position: an int32 scalar, as the
                    # JAX package holds it (the port keeps a Python int)
VARIANTS = ("baseline", "hqp", "int8w", "int8kv")


# ------------------------------------------------------------------ trees
def _map(fn, tree: Any) -> Any:
    if isinstance(tree, QuantizedLinear):
        return QuantizedLinear(fn(tree.w_q), fn(tree.scale), tree.bits)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def tree_bytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size()
               for _, t in rules.named_leaves(tree)
               if isinstance(t, torch.Tensor))


def abstract_params(cfg, quantized: bool = False) -> dict:
    """``lm.init_params(cfg)`` as meta tensors, with ``quantized`` through
    ``quantize_lm_params``. The initializer draws one period of the layer
    pattern from a CPU ``torch.Generator`` under a fake-tensor mode
    (nothing is allocated); every leaf becomes a meta tensor of its shape
    and dtype, and layer i takes the shapes of layer i mod period."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    period = lm.pattern_period(cfg)
    one = dataclasses.replace(cfg, n_layers=period,
                              block_pattern=cfg.block_pattern[:period])
    with FakeTensorMode():
        params = lm.init_params(one, device="cpu")
    meta = lambda tree: _map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                                   device=META), tree)
    params = meta(params)
    params["blocks"] = [meta(params["blocks"][i % period])
                        for i in range(cfg.n_layers)]
    return quantize_lm_params(params) if quantized else params


def input_specs(cfg, shape, quantized_kv: bool = False,
                device=META) -> dict:
    """Meta stand-ins for every model input of this cell (the reference's
    ``input_specs``):

    train   -> {"batch": {"tokens", ["embeds"]}}
    prefill -> {"state", "tokens", ["embeds"]}
    decode  -> {"state", "tokens" (B, 1)}: one new token against a cache
               of seq_len."""
    b, s = shape.global_batch, shape.seq_len
    n_fr = cfg.n_frontend
    tok = lambda n: torch.empty((b, n), dtype=torch.int32, device=device)
    embeds = torch.empty((b, n_fr, cfg.d_model), dtype=torch.bfloat16,
                         device=device)
    if shape.kind == "train":
        batch = {"tokens": tok(s - n_fr)}
        if n_fr:
            batch["embeds"] = embeds
        return {"batch": batch}
    state = lm.init_decode_state(cfg, b, s, quantized_kv=quantized_kv,
                                 device=device)
    if shape.kind == "prefill":
        out = {"state": state, "tokens": tok(s - n_fr)}
        if n_fr:
            out["embeds"] = embeds
        return out
    return {"state": state, "tokens": tok(1)}


def state_bytes(state: dict) -> int:
    return tree_bytes(state["caches"]) + POS_BYTES


def _device_arguments(cfg, shape, ctx, params, opt, ins) -> int:
    """Bytes one device of ``ctx.mesh`` holds of the cell's arguments,
    placed by ``sharding.rules``."""
    total = rules.device_bytes(params, rules.param_specs(params, ctx), ctx)
    b_spec = rules.batch_specs(cfg, ctx)
    if shape.kind == "train":
        o_specs = rules.opt_state_specs(params, opt, ctx)
        total += rules.device_bytes(opt["m"], o_specs["m"], ctx)
        total += rules.device_bytes(opt["v"], o_specs["v"], ctx)
        total += tree_bytes(opt["step"])
        return total + rules.device_bytes(ins["batch"], b_spec, ctx)
    s_specs = rules.decode_state_specs(cfg, ins["state"], ctx)
    total += rules.device_bytes(ins["state"]["caches"], s_specs, ctx,
                                prefix="caches/") + POS_BYTES
    return total + rules.device_bytes(
        {k: ins[k] for k in ("tokens", "embeds") if k in ins}, b_spec, ctx)


# ------------------------------------------------------------------ one cell
def _step(cfg, shape, ctx, params, opt_cfg):
    """(the cell's step on the meta device, its arguments)."""
    if shape.kind == "train":
        opt = adamw_init(params, opt_cfg)
        ins = input_specs(cfg, shape)
        step = make_train_step(cfg, opt_cfg, moe_no_drop=ctx.moe_no_drop)
        return (lambda: step(params, opt, ins["batch"])), opt, ins
    ins = input_specs(cfg, shape, ctx.quantized_kv)
    return (lambda: lm.decode_step(params, cfg, ins["state"], ins["tokens"],
                                   embeds=ins.get("embeds"))), None, ins


def run_cell(arch: str, shape_name: str, mesh_name: str = "1x1",
             variant: str = "baseline", device=None,
             save: bool = True) -> dict:
    """Trace one cell on the meta device and price it; writes its record
    with ``save``. ``device`` is the 1x1 mesh's: None is the card."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    cell_id = f"{arch}__{shape_name}__{mesh_name}__{variant}"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "variant": variant, "cell": cell_id}
    if variant.split("_")[0] not in VARIANTS and "puredp" not in variant:
        raise ValueError(f"unknown variant {variant!r}; known: {VARIANTS}")
    ok, why = shape_applicable(cfg, shape)
    quantized = variant.startswith(("hqp", "int8w"))
    if ok and quantized and shape.kind == "train":
        ok, why = False, ("an INT8 (hqp/int8w) tree is served, not trained: "
                          "its linears take no gradient")
    if not ok:
        rec.update(status="skipped", reason=why)
        return _finish(rec, save)

    t0 = time.time()
    try:
        mesh = mesh_by_name(mesh_name, device)
        rec["device"] = str(mesh.devices[0]) if mesh.devices else None
        pure_dp = ("puredp" in variant
                   and shape.global_batch % mesh.size == 0)
        ctx = make_ctx(mesh, batch_sharded=shape.global_batch >= 16,
                       quantized_kv=variant.startswith(("hqp", "int8kv")),
                       remat=(shape.kind == "train"),
                       moe_no_drop=(shape.kind != "train"),
                       pure_dp=pure_dp)
        params = abstract_params(cfg, quantized)
        opt_cfg = AdamWConfig(
            state_dtype="int8" if cfg.param_count() > 5e10 else "f32")
        run, opt, ins = _step(cfg, shape, ctx, params, opt_cfg)
        args = tree_bytes(params) + (
            tree_bytes(opt) + tree_bytes(ins["batch"])
            if shape.kind == "train" else
            state_bytes(ins["state"]) + tree_bytes(
                {k: ins[k] for k in ("tokens", "embeds") if k in ins}))
        rec["status"] = "ok"
        n_active = cfg.param_count(active_only=True)
        tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                       else 1)
        model_flops = (6 if shape.kind == "train" else 2) * n_active * tokens
        if mesh.size > 1:
            per_dev = _device_arguments(cfg, shape, ctx, params, opt, ins)
            rec["memory"] = {
                "argument_bytes": per_dev, "output_bytes": None,
                "temp_bytes": None, "generated_code_bytes": None,
                "fits_one_card": per_dev <= H100_SXM.hbm_bytes}
            rec["roofline"] = _null_roofline(mesh.size, model_flops)
            rec["elapsed_s"] = round(time.time() - t0, 1)
            return _finish(rec, save)
        with cost.record() as c:
            out = run()
            out_bytes = tree_bytes(out)
        rec["trace_s"] = round(time.time() - t0, 1)
        rec["memory"] = {
            "argument_bytes": args, "output_bytes": out_bytes,
            "temp_bytes": c.peak_live_bytes, "generated_code_bytes": None,
            "fits_one_card": args + c.peak_live_bytes <= H100_SXM.hbm_bytes}
        rec["roofline"] = _roofline(c, model_flops)
        rec["op_counts"] = dict(sorted(c.ops.items()))
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["elapsed_s"] = round(time.time() - t0, 1)
    return _finish(rec, save)


def _roofline(c: cost.Cost, model_flops: int) -> dict:
    terms = cost.roofline_terms(c, H100_SXM)
    bound = terms["step_time_lower_bound_s"]
    return {
        "chips": 1,
        "hlo_flops_per_device": c.flops,
        "hlo_int8_flops_per_device": c.int8_dot_flops,
        "hlo_bytes_per_device": c.bytes,
        "collective_bytes_per_device": c.collective_bytes,
        "collective_breakdown": {},
        "collective_counts": {},
        **{k: terms[k] for k in ("t_compute", "t_memory", "t_collective")},
        "dominant": terms["dominant"],
        "step_time_lower_bound_s": bound,
        "model_flops": model_flops,
        "useful_flops_ratio": model_flops / c.flops if c.flops else 0,
        "roofline_fraction": (terms["t_compute"] / max(bound, 1e-30)
                              * model_flops / c.flops if c.flops else 0.0),
    }


def _null_roofline(chips: int, model_flops: int) -> dict:
    rec = {k: None for k in (
        "hlo_flops_per_device", "hlo_int8_flops_per_device",
        "hlo_bytes_per_device", "collective_bytes_per_device",
        "collective_breakdown", "collective_counts", "t_compute",
        "t_memory", "t_collective", "dominant", "step_time_lower_bound_s",
        "useful_flops_ratio", "roofline_fraction")}
    rec.update(chips=chips, model_flops=model_flops, null_reason=(
        "per-device work and collectives need sharded execution, which the "
        "port does not have yet (ROADMAP A14 (rest)); argument_bytes is "
        "per device from sharding.rules' placements"))
    return rec


def _finish(rec: dict, save: bool) -> dict:
    if save:
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        path = OUT_DIR / (rec["cell"].replace("/", "_") + ".json")
        path.write_text(json.dumps(rec, indent=1, default=str))
    status = rec.get("status")
    extra = ""
    if status == "ok" and rec["roofline"]["dominant"] is not None:
        r = rec["roofline"]
        extra = (f" dom={r['dominant']} comp={r['t_compute']:.3e}s "
                 f"mem={r['t_memory']:.3e}s "
                 f"fits={rec['memory']['fits_one_card']}")
    elif status == "ok":
        extra = (f" argument_bytes/device={rec['memory']['argument_bytes']}"
                 f" fits={rec['memory']['fits_one_card']}")
    elif status == "error":
        extra = " " + rec.get("error", "")[:200]
    print(f"[dryrun] {rec['cell']}: {status}{extra}", flush=True)
    return rec


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="1x1",
                    choices=("1x1", "16x16", "2x16x16"))
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--device", default=None,
                    help="the 1x1 mesh's device: the card by default, "
                         "'cpu' by name")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    if args.mesh == "1x1":
        make_host_mesh(args.device)     # no card and none named: raise
    archs = configs.list_archs() if args.arch == "all" else [args.arch]
    shapes = ([s.name for s in LM_SHAPES] if args.shape == "all"
              else [args.shape])
    for arch in archs:
        for shape in shapes:
            cell = f"{arch}__{shape}__{args.mesh}__{args.variant}"
            path = OUT_DIR / (cell.replace("/", "_") + ".json")
            if args.skip_existing and path.exists():
                rec = json.loads(path.read_text())
                if rec.get("status") in ("ok", "skipped"):
                    print(f"[dryrun] {cell}: cached ({rec['status']})",
                          flush=True)
                    continue
            run_cell(arch, shape, args.mesh, args.variant, args.device)


if __name__ == "__main__":
    main()

