"""ResNet-18 and MobileNetV3-Small, the paper's two test architectures, as
plain functions on a param tree.

The tree is the JAX package's: ``{"params", "stats"}``, weights HWIO
(depthwise ``(k, k, 1, C)``), BatchNorm's running statistics in the separate
``stats`` subtree, returned anew by a training forward. Every width is read
from the params, never from the config, so HQP's structural pruning is
parameter surgery on paths such as ``("params", "s0b0", "conv1")``: masking
zeroes channels, compaction removes them, and the model code never changes.
Its ``GroupSpec`` axes (3 = a conv's output channels, 2 = its input
channels) mean what they mean in the JAX package.

Images come in NHWC, as the data makes them; inside, activations are NCHW,
the layout of ``F.conv2d``, and each weight is permuted HWIO -> OIHW at its
call. The activation taps (``actq``) see NCHW tensors: their ranges,
histograms and fake quantization do not depend on the layout.

``SAME`` padding is the JAX package's (``lax.conv_general_dilated``): at
stride 2 it pads ``lo = total // 2`` before and ``hi = total - lo`` after,
(0, 1) at k = 3 and (1, 2) at k = 5 on an even input, which
``F.conv2d(padding=...)`` cannot express; ``conv`` pads explicitly there.
BatchNorm's training statistics are the reference's: the biased batch
variance normalizes and enters the running update, ``new = 0.9·old +
0.1·batch``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device, tree
from repro_torch.weights import to_device

BN_MOM = 0.9
BN_EPS = 1e-5


# ------------------------------------------------------------------ prims
def conv_init(gen: torch.Generator, k: int, c_in: int, c_out: int,
              depthwise: bool = False) -> torch.Tensor:
    fan = k * k * (1 if depthwise else c_in)
    shape = (k, k, 1 if depthwise else c_in, c_out)
    return torch.randn(shape, generator=gen) * (2.0 / fan) ** 0.5


def same_padding(size: int, k: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of one spatial dim under ``SAME``: the output
    is ceil(size / stride), the odd pixel of the total goes after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
         groups: int = 1) -> torch.Tensor:
    """``SAME`` convolution of x (N, C, H, W) with an HWIO weight (a
    depthwise one (k, k, 1, C) with ``groups=C``)."""
    k = w.shape[0]
    (ht, hb), (wl, wr) = (same_padding(x.shape[2], k, stride),
                          same_padding(x.shape[3], k, stride))
    if x.shape[1] == 0 or w.shape[3] == 0:
        # a family pruned to no channel (θ = 100 %): XLA's empty conv, which
        # F.conv2d refuses
        return x.new_zeros((x.shape[0], w.shape[3], -(-x.shape[2] // stride),
                            -(-x.shape[3] // stride)))
    w = w.permute(3, 2, 0, 1)
    if ht == hb and wl == wr:
        return F.conv2d(x, w, stride=stride, padding=(ht, wl), groups=groups)
    return F.conv2d(F.pad(x, (wl, wr, ht, hb)), w, stride=stride,
                    groups=groups)


def bn_init(c: int):
    return ({"scale": torch.ones(c), "bias": torch.zeros(c)},
            {"mean": torch.zeros(c), "var": torch.ones(c)})


def bn_apply(p, stats, x: torch.Tensor, train: bool):
    """BatchNorm over the channel dim of x (N, C, H, W). Training normalizes
    by the batch's mean and biased variance (gradients flow through both)
    and returns the running statistics updated by them, detached; eval uses
    and returns ``stats``."""
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), correction=0)
        new_stats = {
            "mean": BN_MOM * stats["mean"] + (1 - BN_MOM) * mean.detach(),
            "var": BN_MOM * stats["var"] + (1 - BN_MOM) * var.detach()}
    else:
        mean, var = stats["mean"], stats["var"]
        new_stats = stats
    c = (1, -1, 1, 1)
    y = ((x - mean.view(c)) * torch.rsqrt(var + BN_EPS).view(c)
         * p["scale"].view(c) + p["bias"].view(c))
    return y, new_stats


def hswish(x: torch.Tensor) -> torch.Tensor:
    return x * F.relu6(x + 3.0) / 6.0


def hsigmoid(x: torch.Tensor) -> torch.Tensor:
    return F.relu6(x + 3.0) / 6.0


def _no_tap(name, x):
    return x


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


# ====================================================================
# ResNet-18
# ====================================================================
RESNET_STAGES = ((2, 64, 1), (2, 128, 2), (2, 256, 2), (2, 512, 2))


def _basic_block_init(gen, c_in, c_out, stride):
    p: Dict[str, Any] = {}
    st: Dict[str, Any] = {}
    p["conv1"] = conv_init(gen, 3, c_in, c_out)
    p["bn1"], st["bn1"] = bn_init(c_out)
    p["conv2"] = conv_init(gen, 3, c_out, c_out)
    p["bn2"], st["bn2"] = bn_init(c_out)
    if stride != 1 or c_in != c_out:
        p["down"] = conv_init(gen, 1, c_in, c_out)
        p["bn_down"], st["bn_down"] = bn_init(c_out)
    return p, st


def resnet18_init(cfg, gen: torch.Generator) -> dict:
    wm = cfg.width_mult
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    c = int(64 * wm)
    params["stem"] = conv_init(gen, 3, 3, c)
    params["bn_stem"], stats["bn_stem"] = bn_init(c)
    for si, (n_blocks, width, stride) in enumerate(RESNET_STAGES):
        c_out = int(width * wm)
        for bi in range(n_blocks):
            p, st = _basic_block_init(gen, c, c_out, stride if bi == 0 else 1)
            params[f"s{si}b{bi}"] = p
            stats[f"s{si}b{bi}"] = st
            c = c_out
    params["fc"] = {"w": torch.randn((c, cfg.n_classes), generator=gen)
                    * c ** -0.5,
                    "b": torch.zeros(cfg.n_classes)}
    return {"params": params, "stats": stats}


def _basic_block_apply(p, st, x, stride, train, actq=None, name=""):
    tap = actq.tap if actq is not None else _no_tap
    new_st = {}
    h = conv(x, p["conv1"], stride)
    h, new_st["bn1"] = bn_apply(p["bn1"], st["bn1"], h, train)
    h = tap(f"{name}/act1", F.relu(h))
    h = conv(h, p["conv2"], 1)
    h, new_st["bn2"] = bn_apply(p["bn2"], st["bn2"], h, train)
    if "down" in p:
        x = conv(x, p["down"], stride)
        x, new_st["bn_down"] = bn_apply(p["bn_down"], st["bn_down"], x, train)
    return tap(f"{name}/out", F.relu(h + x)), new_st


def resnet18_apply(variables: dict, x: torch.Tensor, train: bool = False,
                   actq=None):
    """Logits (N, n_classes) of images x (N, H, W, 3), and the new stats."""
    tap = actq.tap if actq is not None else _no_tap
    p, st = variables["params"], variables["stats"]
    new_st: Dict[str, Any] = {}
    h = conv(_nchw(tap("input", x)), p["stem"], 1)
    h, new_st["bn_stem"] = bn_apply(p["bn_stem"], st["bn_stem"], h, train)
    h = tap("stem", F.relu(h))
    for si, (n_blocks, _, stride) in enumerate(RESNET_STAGES):
        for bi in range(n_blocks):
            name = f"s{si}b{bi}"
            h, new_st[name] = _basic_block_apply(
                p[name], st[name], h, stride if bi == 0 else 1, train,
                actq, name)
    h = h.mean(dim=(2, 3))
    logits = h @ p["fc"]["w"] + p["fc"]["b"]
    return logits, new_st


# ====================================================================
# MobileNetV3-Small (strides adapted to 32px input)
# ====================================================================
# (kernel, expansion, out, SE, hswish?, stride)
MBV3S_BLOCKS: List[Tuple[int, int, int, bool, bool, int]] = [
    (3, 16, 16, True, False, 1),
    (3, 72, 24, False, False, 2),
    (3, 88, 24, False, False, 1),
    (5, 96, 40, True, True, 2),
    (5, 240, 40, True, True, 1),
    (5, 240, 40, True, True, 1),
    (5, 120, 48, True, True, 1),
    (5, 144, 48, True, True, 1),
    (5, 288, 96, True, True, 2),
    (5, 576, 96, True, True, 1),
    (5, 576, 96, True, True, 1),
]


def se_width(exp: int) -> int:
    return max(8, exp // 4)


def _bneck_init(gen, c_in, k, exp, out, se):
    p: Dict[str, Any] = {}
    st: Dict[str, Any] = {}
    p["expand"] = conv_init(gen, 1, c_in, exp)
    p["bn_e"], st["bn_e"] = bn_init(exp)
    p["dw"] = conv_init(gen, k, exp, exp, depthwise=True)
    p["bn_d"], st["bn_d"] = bn_init(exp)
    if se:
        c_se = se_width(exp)
        p["se_down"] = {"w": conv_init(gen, 1, exp, c_se),
                        "b": torch.zeros(c_se)}
        p["se_up"] = {"w": conv_init(gen, 1, c_se, exp),
                      "b": torch.zeros(exp)}
    p["project"] = conv_init(gen, 1, exp, out)
    p["bn_p"], st["bn_p"] = bn_init(out)
    return p, st


def mobilenetv3s_init(cfg, gen: torch.Generator) -> dict:
    wm = cfg.width_mult
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    c = int(16 * wm)
    params["stem"] = conv_init(gen, 3, 3, c)
    params["bn_stem"], stats["bn_stem"] = bn_init(c)
    for i, (k, exp, out, se, hs, stride) in enumerate(MBV3S_BLOCKS):
        p, st = _bneck_init(gen, c, k, int(exp * wm), int(out * wm), se)
        params[f"b{i}"] = p
        stats[f"b{i}"] = st
        c = int(out * wm)
    c_head = int(576 * wm)
    params["head"] = conv_init(gen, 1, c, c_head)
    params["bn_head"], stats["bn_head"] = bn_init(c_head)
    params["fc"] = {"w": torch.randn((c_head, cfg.n_classes), generator=gen)
                    * c_head ** -0.5,
                    "b": torch.zeros(cfg.n_classes)}
    return {"params": params, "stats": stats}


def _bneck_apply(p, st, x, k, se, hs, stride, train, actq=None, name=""):
    tap = actq.tap if actq is not None else _no_tap
    act = hswish if hs else F.relu
    new_st = {}
    exp = p["expand"].shape[-1]
    h = conv(x, p["expand"], 1)
    h, new_st["bn_e"] = bn_apply(p["bn_e"], st["bn_e"], h, train)
    h = tap(f"{name}/e", act(h))
    h = conv(h, p["dw"], stride, groups=exp)
    h, new_st["bn_d"] = bn_apply(p["bn_d"], st["bn_d"], h, train)
    h = tap(f"{name}/d", act(h))
    if se:
        # the reference's 1x1 convs on the pooled (N, 1, 1, C) map, as
        # products on (N, C)
        pooled = h.mean(dim=(2, 3))
        a = F.relu(pooled @ p["se_down"]["w"][0, 0] + p["se_down"]["b"])
        a = hsigmoid(a @ p["se_up"]["w"][0, 0] + p["se_up"]["b"])
        h = h * a[:, :, None, None]
    h = conv(h, p["project"], 1)
    h, new_st["bn_p"] = bn_apply(p["bn_p"], st["bn_p"], h, train)
    if stride == 1 and x.shape[1] == h.shape[1]:
        h = h + x
    return tap(f"{name}/out", h), new_st


def mobilenetv3s_apply(variables: dict, x: torch.Tensor, train: bool = False,
                       actq=None):
    """Logits (N, n_classes) of images x (N, H, W, 3), and the new stats."""
    tap = actq.tap if actq is not None else _no_tap
    p, st = variables["params"], variables["stats"]
    new_st: Dict[str, Any] = {}
    h = conv(_nchw(tap("input", x)), p["stem"], 1)
    h, new_st["bn_stem"] = bn_apply(p["bn_stem"], st["bn_stem"], h, train)
    h = tap("stem", hswish(h))
    for i, (k, exp, out, se, hs, stride) in enumerate(MBV3S_BLOCKS):
        name = f"b{i}"
        h, new_st[name] = _bneck_apply(p[name], st[name], h, k, se, hs,
                                       stride, train, actq, name)
    h = conv(h, p["head"], 1)
    h, new_st["bn_head"] = bn_apply(p["bn_head"], st["bn_head"], h, train)
    h = tap("head", hswish(h))
    h = h.mean(dim=(2, 3))
    logits = h @ p["fc"]["w"] + p["fc"]["b"]
    return logits, new_st


# ------------------------------------------------------------------ facade
def cnn_init(cfg, generator: torch.Generator, device=None) -> dict:
    """Variables of ``cfg``'s CNN, drawn on the CPU from ``generator`` (so a
    seed gives the same weights whatever the device), on ``device``
    (default the card, as ``resolve_device`` says). The JAX package draws
    from ``jax.random``: the same distributions, other values."""
    init = resnet18_init if cfg.arch == "resnet18" else mobilenetv3s_init
    return to_device(init(cfg, generator), resolve_device(device))


def cnn_apply(cfg, variables, x, train: bool = False, actq=None):
    fn = resnet18_apply if cfg.arch == "resnet18" else mobilenetv3s_apply
    return fn(variables, x, train, actq)


# ------------------------------------------------------------------ cost
class _Cost:
    """The eval forward's cost from shapes, op by op (``forward_cost``)."""

    def __init__(self, n: int):
        self.n = n
        self.flops = 0
        self.act_bytes = 0

    def conv(self, h: int, w: Tuple, stride: int = 1) -> int:
        """A SAME conv of an h x h map with HWIO weight ``w``, then its BN:
        the conv's multiply-adds over valid taps, BN's 4 per element and 1
        per channel; its output written and read once. The output size."""
        k, group_in, c_out = w[0], w[2], w[3]
        lo, _ = same_padding(h, k, stride)
        out = -(-h // stride)
        taps = sum(1 for o in range(out) for t in range(k)
                   if 0 <= o * stride + t - lo < h)
        self.flops += 2 * self.n * taps * taps * group_in * c_out
        elems = self.n * out * out * c_out
        self.flops += 4 * elems + c_out
        self.act_bytes += 2 * 4 * elems
        return out

    def elementwise(self, elems: int, flops_each: int = 1) -> None:
        self.flops += flops_each * elems

    def fc(self, c_in: int, c_out: int) -> None:
        self.flops += 2 * self.n * c_in * c_out + self.n * c_out
        self.act_bytes += 2 * 4 * self.n * c_out


def forward_cost(cfg, variables: dict, batch: int,
                 image_size: int) -> Dict[str, int]:
    """FLOPs and bytes of one eval forward of ``batch`` images, counted
    from the param shapes (so a compacted tree counts its own widths).

    FLOPs count as XLA's cost analysis counts the JAX package's forward:
    2 per multiply-add of every conv and product over the kernel taps that
    fall inside the image (SAME padding's zeros are not counted); BatchNorm
    4 per element (subtract, two multiplies, add) and 1 per channel (var +
    eps; the rsqrt is a transcendental); ReLU, a residual add, a bias add,
    the SE scale and a mean 1 per element (of the mean's input); hswish 4,
    hsigmoid 3. XLA's fusion also recomputes the elementwise chain that
    makes an identity residual's input (BN, activation, earlier residual
    adds since the last conv) inside the add's fusion, and counts it again:
    ``chain`` is that chain's FLOPs per element.

    Bytes are this model's own: every param and stat read once, the images
    read once, and each conv's, product's and SE's output written once and
    read once by its consumer, with the BN, activation and residual add
    taken as fused into the op that makes their input (a residual's other
    operand read once more)."""
    p = variables["params"]
    shape = lambda t: tuple(t.shape)
    c = _Cost(batch)
    h = c.conv(image_size, shape(p["stem"]))
    e = batch * h * h * p["stem"].shape[3]
    if cfg.arch == "resnet18":
        c.elementwise(e)                                          # relu
        chain = 4 + 1
        for si, (n_blocks, _, stride) in enumerate(RESNET_STAGES):
            for bi in range(n_blocks):
                b = p[f"s{si}b{bi}"]
                s = stride if bi == 0 else 1
                h2 = c.conv(h, shape(b["conv1"]), s)
                c.elementwise(batch * h2 * h2 * b["conv1"].shape[3])  # relu
                c.conv(h2, shape(b["conv2"]))
                e2 = batch * h2 * h2 * b["conv2"].shape[3]
                if "down" in b:
                    c.conv(h, shape(b["down"]), s)
                    chain = 4 + 2 + 4
                else:
                    c.elementwise(e, chain)                       # recomputed
                    chain = 4 + 2 + chain
                c.elementwise(e2, 2)                              # add, relu
                c.act_bytes += 4 * e2                             # residual
                h, e = h2, e2
        c_last = p["fc"]["w"].shape[0]
    else:
        c.elementwise(e, 4)                                       # hswish
        chain = 4 + 4
        for i, (k, _, _, se, hs, stride) in enumerate(MBV3S_BLOCKS):
            b = p[f"b{i}"]
            act = 4 if hs else 1
            exp = b["expand"].shape[3]
            c.conv(h, shape(b["expand"]))
            c.elementwise(batch * h * h * exp, act)
            h2 = c.conv(h, shape(b["dw"]), stride)
            e_exp = batch * h2 * h2 * exp
            c.elementwise(e_exp, act)
            if se:
                c_se = b["se_down"]["w"].shape[3]
                c.elementwise(e_exp)                              # mean
                c.fc(exp, c_se)
                c.elementwise(batch * c_se)                       # relu
                c.fc(c_se, exp)
                c.elementwise(batch * exp, 3)                     # hsigmoid
                c.elementwise(e_exp)                              # scale
            c.conv(h2, shape(b["project"]))
            c_out = b["project"].shape[3]
            e2 = batch * h2 * h2 * c_out
            if stride == 1 and b["expand"].shape[2] == c_out:
                c.elementwise(e, chain)                           # recomputed
                c.elementwise(e2)                                 # residual
                c.act_bytes += 4 * e2
                chain = 4 + 1 + chain
            else:
                chain = 4
            h, e = h2, e2
        c.conv(h, shape(p["head"]))
        c_last = p["head"].shape[3]
        e = batch * h * h * c_last
        c.elementwise(e, 4)                                       # hswish
    c.elementwise(e)                                              # mean
    c.fc(c_last, p["fc"]["w"].shape[1])
    weights = sum(t.numel() * t.element_size()
                  for t in tree.leaves(variables))
    return {"flops": c.flops,
            "bytes": weights + 4 * batch * image_size * image_size * 3
            + c.act_bytes}
