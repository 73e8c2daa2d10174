"""Model configuration: the port's own copy of the fields the serving path
reads from the JAX package's ``ModelConfig``."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    experts_per_token: int = 2
    moe_every: int = 1          # a layer is MoE iff (layer_idx % moe_every == moe_offset)
    moe_offset: int = 0
    dense_residual: bool = False  # arctic: dense MLP in parallel with MoE
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0            # 0 -> ceil(d_model/16)
    chunk: int = 256            # the reference's scan chunk; the port's
                                # recurrence steps every length, no chunk


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 8        # one sLSTM block per this many blocks (xLSTM[7:1])
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 1.333
    chunk: int = 256            # the train route's mLSTM chunk (a shorter
                                # last chunk); serving steps every length


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """A modality frontend's stub, as the JAX package's: the caller passes
    precomputed embeddings (``batch["embeds"]``, (B, n_embeds, d_model)),
    which a (d_model, d_model) linear maps before they are prepended to
    the token stream."""
    kind: str = "none"          # none | clip_patches | encodec_frames
    n_embeds: int = 0           # patches / frames prepended to the tokens
    embed_dim: int = 0          # equals d_model


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    use_bias: bool = False
    norm_eps: float = 1e-5
    # layer pattern: which block type at each layer. "attn" (attention +
    # MLP/MoE), "mamba" (Mamba mixer + MLP/MoE), "mlstm", "slstm" (an
    # xLSTM block, no FFN)
    block_pattern: Tuple[str, ...] = ()   # () -> all "attn"
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    frontend: FrontendConfig = FrontendConfig()
    attn_chunk_kv: int = 1024   # KV chunk of the train route's CPU flash
    subquadratic: bool = False  # True for ssm/hybrid: long_500k is runnable
    max_seq_len: int = 32_768

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def pattern(self) -> Tuple[str, ...]:
        if self.block_pattern:
            if len(self.block_pattern) != self.n_layers:
                raise ValueError("block_pattern length != n_layers")
            return self.block_pattern
        return ("attn",) * self.n_layers

    @property
    def n_frontend(self) -> int:
        """Positions the frontend prepends to the token stream (0 without
        one)."""
        return self.frontend.n_embeds if self.frontend.kind != "none" else 0

    def is_moe_layer(self, idx: int) -> bool:
        m = self.moe
        if m is None or m.n_experts == 0:
            return False
        return idx % m.moe_every == m.moe_offset

    def param_count(self, active_only: bool = False) -> int:
        """The JAX package's parameter count (its roofline's N), formula
        for formula: an estimate from the config, not a count of a tree's
        leaves (the xLSTM terms are approximate there too, and the
        frontend linear is not counted)."""
        d, hd = self.d_model, self.resolved_head_dim
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for i, kind in enumerate(self.pattern):
            if kind == "attn":
                total += d * (self.n_heads * hd)                 # q
                total += 2 * d * (self.n_kv_heads * hd)          # k, v
                total += (self.n_heads * hd) * d                 # o
                total += 2 * d                                   # norms
            elif kind == "mamba":
                s = self.ssm or SSMConfig()
                d_in = s.expand * d
                dt_rank = s.dt_rank or -(-d // 16)
                total += d * 2 * d_in + d_in * s.d_conv
                total += d_in * (dt_rank + 2 * s.d_state) + dt_rank * d_in
                total += d_in * s.d_state + d_in                 # A_log, D
                total += d_in * d + d                            # out proj + norm
            elif kind in ("mlstm", "slstm"):
                x = self.xlstm or XLSTMConfig()
                pf = (x.proj_factor_mlstm if kind == "mlstm"
                      else x.proj_factor_slstm)
                d_in = int(pf * d)
                if kind == "mlstm":
                    total += (d * 2 * d_in
                              + 3 * d_in * d_in // max(self.n_heads, 1))
                    total += d_in * d + 2 * d
                else:
                    total += (4 * d * d_in
                              + 4 * d_in * d_in // max(self.n_heads, 1))
                    total += d_in * d + 2 * d
            # FFN / MoE (attn and mamba blocks carry one)
            if kind in ("attn", "mamba") and self.d_ff > 0:
                ffn = 3 * d * self.d_ff                          # gate, up, down
                if self.is_moe_layer(i):
                    m = self.moe
                    n_live = m.experts_per_token if active_only else m.n_experts
                    total += ffn * n_live + d * m.n_experts      # router
                    if m.dense_residual:
                        total += ffn
                else:
                    total += ffn
        return int(total)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


# the dry run's cells, as the JAX package's
LM_SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)


def get_shape(name: str) -> ShapeConfig:
    for s in LM_SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}; known: "
                   f"{[s.name for s in LM_SHAPES]}")


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch, shape) cell is runnable. long_500k needs sub-quadratic."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("pure full-attention arch: O(S^2) at 524k — skipped "
                       "per brief")
    return True, ""


# ---- CNN configs (the paper's own experiment) ----
@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    arch: str                   # resnet18 | mobilenetv3s
    n_classes: int = 10
    width_mult: float = 1.0
    image_size: int = 32
    stem_channels: int = 16
