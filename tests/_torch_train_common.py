"""What the family training test files share: the three trained families'
smoke configs (phi3.5-moe, jamba, xlstm-1.3b), both packages' seed-0
params, the launcher's calibration batch (2 x 32: both the Mamba and the
mLSTM chunk are 32, and the reference's chunkwise forms raise at other
lengths, ROADMAP C9, C10), the reference's run context with and without
the capacity factor's drops, tree flattening into the JAX layout, and the
tolerances.

Tolerances, each from the family's own test helper:
  * the loss within LOSS_RTOL relative (``test_torch_train.py``: the
    forward's bf16 roundings differ at the ulp level);
  * each auxiliary loss within S_FRAC relative (``_torch_moe_common``: a
    token a hair from the next expert may take another one and move one
    count of N·k);
  * the gradients pooled over every leaf: a value is off when it lies
    more than GRAD_FRAC of its leaf's largest |want| from the reference's
    (``test_torch_train.py``'s moment bound), and at most MOE_OFF of them
    may be off for a config with experts (``_torch_moe_common``,
    ``_torch_hybrid_common``: routing is discrete, and a flipped token
    moves its row's gradient wholesale), XLSTM_OFF without
    (``_torch_xlstm_common``'s rule between the reference's own forms);
  * and every leaf on its own within LEAF_REL of its norm (L2), so that a
    small leaf (the router's, 0.25 % of phi3.5-moe's values) cannot be
    wrong inside the pooled share (the bf16 forwards' noise on a small
    leaf stays under it; a missing aux term on the router does not);
  * a train step's params within 2·lr + one bf16 ulp at the larger of the
    two (Adam's first step moves a weight by about ±lr, and each side
    rounds its new weight at its own magnitude; ``test_torch_train.py``),
    at most FAR_ULP of them (its share) or MOE_OFF with experts more than
    one ulp apart.

A test file imports the fixtures it uses (``one_thread``) so that pytest
finds them in its namespace."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_moe_common import MOE_OFF, S_FRAC

from repro import configs as jconfigs
from repro.launch.serve import _calib_batch as j_calib_batch
from repro.models import lm as jlm
from repro.sharding.ctx import default_ctx
from repro.sharding.rules import path_str
from repro_torch import configs
from repro_torch.weights import from_jax_params, stack_blocks

FAMILIES = ("phi3.5-moe-42b-a6.6b", "jamba-1.5-large-398b", "xlstm-1.3b")
LOSS_RTOL = 1e-3
AUX_RTOL = S_FRAC
GRAD_FRAC = 2e-2
XLSTM_OFF = 2e-3
FAR_ULP = 1e-2
LEAF_REL = 5e-2
LEAF_FLOOR = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while a file runs (``test_torch_sampling``
    says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make(arch: str) -> dict:
    jcfg, cfg = jconfigs.get_smoke_config(arch), configs.get_smoke_config(arch)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tokens = np.array(j_calib_batch(jcfg, 2, 32)["tokens"])
    return dict(jcfg=jcfg, cfg=cfg, jp=jp,
                tp=from_jax_params(jax.tree.map(np.asarray, jp),
                                   device="cpu"),
                tokens=tokens)


def ctx(no_drop: bool):
    """The reference's run context: ``default_ctx()`` (no drops) or the
    launcher's ``moe_no_drop=False``."""
    return dataclasses.replace(default_ctx(), moe_no_drop=no_drop)


def has_experts(cfg) -> bool:
    return cfg.moe is not None and cfg.moe.n_experts > 0


def flat_port(t) -> dict:
    """A port tree's leaves in the JAX layout (``blocks`` stacked), keyed
    by path, as f32 numpy."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            out["/".join(path)] = node.detach().float().numpy()
    walk(stack_blocks(t), ())
    return out


def flat_ref(t) -> dict:
    return {path_str(p): np.asarray(jnp.asarray(leaf).astype(jnp.float32))
            for p, leaf in jax.tree_util.tree_flatten_with_path(t)[0]}


def off_share(got: dict, want: dict) -> float:
    """The share of all values more than GRAD_FRAC of their leaf's largest
    |want| away from it."""
    assert sorted(got) == sorted(want)
    off = n = 0
    for k in want:
        a, b = got[k], want[k]
        assert a.shape == b.shape, k
        off += int(np.sum(np.abs(a - b) > GRAD_FRAC * np.abs(b).max()))
        n += b.size
    return off / n


def leaf_errors(got: dict, want: dict) -> dict:
    """Each leaf's ||got - want|| over ||want|| (L2), the denominator at
    least LEAF_FLOOR of the largest leaf's norm: a leaf whose gradient is
    exactly 0 by an invariance (the mLSTM's input-gate bias: a shift of
    every input gate scales C and n alike) holds only rounding noise."""
    floor = LEAF_FLOOR * max(np.linalg.norm(b) for b in want.values())
    return {k: float(np.linalg.norm(got[k] - want[k])
                     / max(np.linalg.norm(want[k]), floor)) for k in want}


def check_leaves(got: dict, want: dict, cfg) -> None:
    """The pooled off share within ``allowed_off`` and every leaf on its
    own within LEAF_REL."""
    share = off_share(got, want)
    assert share <= allowed_off(cfg), share
    errs = leaf_errors(got, want)
    worst = max(errs, key=errs.get)
    print(f"{cfg.name}: values off {share:.5f}, worst leaf {worst} "
          f"{errs[worst]:.4f}")
    bad = {k: v for k, v in errs.items() if not v <= LEAF_REL}
    assert not bad, bad


def allowed_off(cfg) -> float:
    return MOE_OFF if has_experts(cfg) else XLSTM_OFF


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (8 significant bits; f32's spacing x 2^16)."""
    return np.spacing(np.abs(x).astype(np.float32)) * 65536.0


# ------------------------------------------------------------------ checks
def batches(family: dict):
    """The family's batch for the reference and for the port: its
    ``tokens``, and its ``embeds`` (a frontend config's) when it has
    them."""
    jb = {"tokens": jnp.asarray(family["tokens"], jnp.int32)}
    tb = {"tokens": torch.as_tensor(family["tokens"])}
    if "embeds" in family:
        jb["embeds"] = jnp.asarray(family["embeds"], jnp.bfloat16)
        tb["embeds"] = torch.from_numpy(family["embeds"].copy()).to(
            torch.bfloat16)
    return jb, tb


def check_loss(family: dict, no_drop: bool) -> None:
    """``lm.loss_fn(with_aux=True)`` and its gradient against the JAX
    package's on the family's smoke config: the loss (the auxiliary losses
    added), each auxiliary loss (summed over the MoE layers; none without
    experts), the gradient of every leaf."""
    from repro_torch.core.sensitivity import value_and_grad
    from repro_torch.models import lm
    jcfg, cfg = family["jcfg"], family["cfg"]
    jctx = ctx(no_drop)
    jb, tb = batches(family)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, jcfg, b, jctx, with_aux=True),
        has_aux=True))(family["jp"], jb)
    (tl, taux), tg = value_and_grad(
        lambda p, b: lm.loss_fn(p, cfg, b, with_aux=True,
                                moe_no_drop=no_drop), has_aux=True)(
        family["tp"], tb)
    assert tl.dtype == torch.float32 and tl.ndim == 0
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    assert sorted(taux) == sorted(jaux)
    assert bool(taux) == has_experts(cfg)
    for k in taux:
        assert taux[k].dtype == torch.float32 and float(taux[k]) > 0
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=AUX_RTOL, err_msg=k)
    check_leaves(flat_port(tg), flat_ref(jg), cfg)


def check_no_aux(family: dict) -> None:
    """``with_aux=False`` (the Fisher pass, the evaluations) returns the
    cross-entropy alone, as before the auxiliary losses existed;
    ``with_aux=True`` at inference capacity is it plus the auxiliary
    losses, and ``forward`` gives the same hidden states either way."""
    from repro_torch.models import lm
    cfg = family["cfg"]
    batch = {"tokens": torch.as_tensor(family["tokens"])}
    ce = lm.loss_fn(family["tp"], cfg, batch)
    assert isinstance(ce, torch.Tensor) and ce.ndim == 0
    loss, aux = lm.loss_fn(family["tp"], cfg, batch, with_aux=True)
    want = ce
    for v in aux.values():
        want = want + v
    assert torch.equal(loss, want)
    h, _ = lm.forward(family["tp"], cfg, batch, with_aux=True)
    assert torch.equal(h, lm.forward(family["tp"], cfg, batch))


def check_step(family: dict, microbatches: int, lr: float = 1e-3) -> None:
    """One AdamW step of ``make_train_step`` with the launcher's drops
    against the JAX package's ``make_train_step`` under the same context:
    the metrics (``aux/*`` the last microbatch's), the first moments (0.1
    x the clipped gradient: the gradient rule) and every param within
    2·lr + one bf16 ulp (at the larger of the two), at most FAR_ULP of
    them (``test_torch_train.py``'s share for the dense model), or MOE_OFF
    with experts, more than one ulp apart."""
    from repro.train import optimizer as jopt
    from repro.train.train_step import make_train_step as jmake_train_step
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step
    cfg, jcfg = family["cfg"], family["jcfg"]
    ocfg, jocfg = opt.AdamWConfig(lr=lr), jopt.AdamWConfig(lr=lr)
    step = make_train_step(cfg, ocfg, microbatches, moe_no_drop=False)
    jstep = jax.jit(jmake_train_step(jcfg, ctx(False), jocfg, microbatches))
    jb, tb = batches(family)
    tp, ts, m = step(family["tp"], opt.adamw_init(family["tp"], ocfg), tb)
    jp, js, jm = jstep(family["jp"], jopt.adamw_init(family["jp"], jocfg),
                       jb)
    assert sorted(m) == sorted(jm)
    assert ("aux/load_balance" in m) == has_experts(cfg)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    for k in m:
        if k != "loss":
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=AUX_RTOL, err_msg=k)
    assert int(ts["step"]) == int(js["step"]) == 1
    check_leaves(flat_port(ts["m"]), flat_ref(js["m"]), cfg)
    got, want = flat_port(tp), flat_ref(jp)
    assert sorted(got) == sorted(want)
    far = n = 0
    for k in got:
        a, b = got[k], want[k]
        # each side rounds its new weight to bf16 at its own magnitude
        ulp = bf16_ulp(np.maximum(np.abs(a), np.abs(b)))
        assert np.all(np.abs(a - b) <= 2 * lr + ulp), k
        far += int(np.sum(np.abs(a - b) > ulp))
        n += a.size
    assert far <= max(FAR_ULP, allowed_off(cfg)) * n, (far, n)
