"""The port's placement plan (``sharding/``, ``launch/mesh.py``,
``launch/elastic.py``) held against the JAX package's, spec for spec: every
param leaf of every registry arch at its full config (bf16 and INT8 trees),
the optimizer state (f32 and INT8 moments), the batch and the decode state
at the four dry-run shapes, on the 1x1, 16x16 and 2x16x16 meshes, with and
without ``pure_dp``. The port keeps ``blocks`` per layer: its leaf at
``blocks/<layer>/...`` takes the reference's spec of ``blocks/<layer mod
period>/...`` with the leading group axis dropped."""
import random

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.compress.quantize import quantize_lm_params as jquantize
from repro.launch import elastic as jelastic
from repro.models import lm as jlm
from repro.sharding import rules as jrules
from repro.sharding.ctx import RunContext as JRunContext
from repro.train.optimizer import AdamWConfig as JAdamW
from repro.train.optimizer import adamw_init as jadamw_init
from repro_torch import configs, tree
from repro_torch.launch import checkpoint as ckpt
from repro_torch.launch import dryrun, elastic
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     mesh_by_name)
from repro_torch.models import lm
from repro_torch.sharding import rules
from repro_torch.sharding.ctx import default_ctx, make_ctx
from repro_torch.train.optimizer import AdamWConfig, adamw_init

torch.set_num_threads(1)

MESHES = ("1x1", "16x16", "2x16x16")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


class FakeMesh:
    """The reference's shape-only stand-in for a production mesh."""

    def __init__(self, names, sizes):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))
        self.size = int(np.prod(sizes))


def _ctxs(mesh_name, **kw):
    mesh = mesh_by_name(mesh_name, "cpu")
    jmesh = FakeMesh(mesh.axis_names, mesh.sizes)
    data_axes = tuple(a for a in mesh.axis_names if a != "model")
    return (make_ctx(mesh, **kw),
            JRunContext(mesh=jmesh, data_axes=data_axes, **kw))


def _jpaths(specs):
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {jrules.path_str(path): tuple(spec) for path, spec in flat}


def _ref_key(path: str, period: int) -> str:
    """The reference's path of the port's leaf: layer l at period position
    l mod period."""
    parts = path.split("/")
    if parts[0] == "blocks":
        parts[1] = str(int(parts[1]) % period)
    return "/".join(parts)


def _same_specs(port: dict, ref: dict, period: int, stacked):
    """Every port leaf's spec equals the reference's, the group axis
    dropped where ``stacked(path)``."""
    assert port, "no leaves"
    for path, spec in port.items():
        want = ref[_ref_key(path, period)]
        assert spec == (want[1:] if stacked(path) else want), (path, spec,
                                                              want)


def _block(path):
    return path.startswith("blocks/")


@pytest.fixture(scope="module", params=configs.list_archs())
def arch_trees(request):
    """(arch, cfg, the reference's abstract bf16 and INT8 params, the
    port's on the meta device)."""
    arch = request.param
    jcfg = jconfigs.get_config(arch)
    jp = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0), jcfg))
    jq = jax.eval_shape(jquantize, jp)
    cfg = configs.get_config(arch)
    p = dryrun.abstract_params(cfg)
    q = dryrun.abstract_params(cfg, quantized=True)
    opts = {dt: (adamw_init(p, AdamWConfig(state_dtype=dt)),
                 jax.eval_shape(lambda t: jadamw_init(
                     t, JAdamW(state_dtype=dt)), jp))
            for dt in ("f32", "int8")}
    states = {}
    for shape_name in SHAPES:
        shape = configs.get_shape(shape_name)
        b, s = shape.global_batch, shape.seq_len
        states[shape_name] = (
            lm.init_decode_state(cfg, b, s, device="meta"),
            jax.eval_shape(lambda: jlm.init_decode_state(jcfg, b, s)))
    return arch, cfg, jcfg, (jp, jq), (p, q), opts, states


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("pure_dp", [False, True])
def test_param_and_opt_specs_match_reference(arch_trees, mesh_name, pure_dp):
    arch, cfg, jcfg, (jp, jq), (p, q), opts, _ = arch_trees
    period = lm.pattern_period(cfg)
    ctx, jctx = _ctxs(mesh_name, pure_dp=pure_dp)
    for port_tree, ref_tree in ((p, jp), (q, jq)):
        _same_specs(rules.param_specs(port_tree, ctx),
                    _jpaths(jrules.param_specs(ref_tree, jctx)), period,
                    _block)
        # shapes too: the group axis is the only difference
        ref_shapes = {jrules.path_str(k): v.shape for k, v in
                      jax.tree_util.tree_flatten_with_path(ref_tree)[0]}
        for path, leaf in rules.named_leaves(port_tree):
            want = ref_shapes[_ref_key(path, period)]
            assert tuple(leaf.shape) == (want[1:] if _block(path) else want)
    for opt, jopt in opts.values():
        got = rules.opt_state_specs(p, opt, ctx)
        want = _jpaths(jrules.opt_state_specs(jp, jopt, jctx))
        assert got["step"] == want["step"] == ()
        for part in ("m", "v"):
            _same_specs(got[part], {k[len(part) + 1:]: v for k, v in
                                    want.items() if k.startswith(part + "/")},
                        period, _block)
    assert rules.batch_specs(cfg, ctx) == {
        k: tuple(v) for k, v in jrules.batch_specs(jcfg, jctx).items()}


# the reference keeps an mLSTM / sLSTM state as a tuple, the port as a dict
_STATE_KEYS = {"C": "0", "n": "1", "m": "2"}
_SLSTM_KEYS = {"h": "0", "c": "1", "n": "2", "m": "3"}


@pytest.mark.parametrize("mesh_name", MESHES)
def test_decode_state_specs_match_reference(arch_trees, mesh_name):
    arch, cfg, jcfg, _, _, _, states = arch_trees
    period = lm.pattern_period(cfg)
    for shape_name in SHAPES:
        b = configs.get_shape(shape_name).global_batch
        ctx, jctx = _ctxs(mesh_name, batch_sharded=b >= 16)
        state, jstate = states[shape_name]
        got = rules.decode_state_specs(cfg, state, ctx)
        want = _jpaths(jrules.decode_state_specs(jcfg, jstate, jctx))
        assert got.pop("pos") == want.pop("pos") == ()
        seen = set()
        for path, spec in got.items():
            _, layer, key = path.split("/")
            kind = cfg.pattern[int(layer)]
            key = {"mlstm": _STATE_KEYS, "slstm": _SLSTM_KEYS}.get(
                kind, {}).get(key, key)
            ref = f"caches/{int(layer) % period}/{key}"
            seen.add(ref)
            assert spec == want[ref][1:], (shape_name, path, spec)
        assert seen == set(want)


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard
    axes = ("data", "model")
    assert rules.to_placements((None, "data", "model"), axes) == (
        Shard(1), Shard(2))
    assert rules.to_placements((("data", "model"), None), axes) == (
        Shard(0), Shard(0))
    assert rules.to_placements((None, None), axes) == (Replicate(),
                                                       Replicate())
    assert rules.to_placements(("model", ("pod", "data")),
                               ("pod", "data", "model")) == (
        Shard(1), Shard(1), Shard(0))
    with pytest.raises(ValueError, match="used twice"):
        rules.to_placements(("data", "data"), axes)
    with pytest.raises(ValueError, match="not in mesh"):
        rules.to_placements(("pod",), axes)
    # the specs the rules give place on their mesh
    ctx = make_ctx(make_production_mesh(multi_pod=True))
    p = dryrun.abstract_params(configs.get_config("qwen3-0.6b"))
    for spec in rules.param_specs(p, ctx).values():
        assert len(rules.to_placements(spec, ctx.mesh.axis_names)) == 3


def test_meshes_and_contexts():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).axis_names == (
        "pod", "data", "model")
    host = make_host_mesh("cpu")
    assert host.size == 1 and host.devices == (torch.device("cpu"),)
    assert default_ctx().mesh.size == 1 and default_ctx().tp_size == 1
    ctx = make_ctx(make_production_mesh(multi_pod=True))
    assert ctx.data_axes == ("pod", "data") and ctx.dp_size == 32
    assert ctx.batch_spec() == (("pod", "data"),)
    with pytest.raises(ValueError, match="unknown mesh"):
        mesh_by_name("8x8")


def test_elastic_policies_match_reference():
    rng = random.Random(0)
    for _ in range(100):
        n = rng.randint(1, 600)
        mp = rng.choice([1, 2, 4, 8, 16])
        gb = rng.choice([1, 8, 32, 96, 128, 256, 1000])
        tokens = rng.choice([1, 512, 4096, 65536])
        seq = rng.choice([128, 4096, 32768])
        try:
            want = jelastic.replan(list(range(n)), mp, gb, tokens, seq)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                elastic.replan(list(range(n)), mp, gb, tokens, seq)
            continue
        got = elastic.replan(list(range(n)), mp, gb, tokens, seq)
        assert (got.mesh_shape, got.axis_names, got.num_microbatches,
                got.dropped_devices) == (want.mesh_shape, want.axis_names,
                                         want.num_microbatches,
                                         want.dropped_devices)
        assert elastic.choose_mesh_shape(n, mp, gb) == \
            jelastic.choose_mesh_shape(n, mp, gb)
    mine, ref = elastic.StragglerPolicy(1.3, 3), jelastic.StragglerPolicy(
        1.3, 3)
    for _ in range(200):
        times = {d: rng.choice([1.0, 1.1, 1.5, 2.0, 0.9]) for d in range(8)}
        assert mine.observe(times) == ref.observe(times)


def test_rebuild_restores_on_one_device(tmp_path):
    cfg = configs.get_smoke_config("qwen3-0.6b")
    params = lm.init_params(cfg, seed=3, device="cpu")
    ocfg = AdamWConfig()
    opt = adamw_init(params, ocfg)
    opt = {**opt, "m": tree.map_(lambda t: t + 0.25, opt["m"])}
    ckpt.save(str(tmp_path), 7, (params, opt))
    plan = elastic.replan(["cpu"], 1, 4, 64, 32)
    assert plan.mesh_shape == (1, 1)
    like_p = dryrun.abstract_params(cfg)
    like_o = adamw_init(like_p, ocfg)
    mesh, ctx, p2, o2, meta = elastic.rebuild(plan, ["cpu"], like_p, like_o,
                                              str(tmp_path))
    assert meta["step"] == 7 and mesh.devices == (torch.device("cpu"),)
    assert ctx.dp_size == ctx.tp_size == 1
    for a, b in zip(tree.leaves((params, opt)), tree.leaves((p2, o2))):
        assert a.dtype == b.dtype and b.device.type == "cpu"
        assert torch.equal(a, b)
    big = elastic.ElasticPlan((2, 1), ("data", "model"), 1, [])
    with pytest.raises(NotImplementedError, match="sharded execution"):
        elastic.rebuild(big, ["cpu", "cpu"], like_p, like_o, str(tmp_path))
