"""Configuration dataclasses (port of repro/config/base.py).

`ModelConfig` keeps the reference's fields and defaults one for one, so
the two packages' configs compare field by field.  The family
sub-configs are carried field for field; the port serves the dense, the
pure-SSM (Mamba2), the hybrid (Hymba) and the MoE families, with GQA or
MLA attention.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_routed: int
    n_shared: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    n_dense_layers: int = 0
    d_ff_dense: int = 0


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256
    n_groups: int = 1


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description. `family` selects the block type."""

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0               # 0 => d_model // n_heads

    # attention: "xla" runs the plain torch attention (the port of the
    # reference's XLA path), "pallas" the hand-written flash kernel
    attn_backend: str = "xla"
    kv_dtype: str = "model"
    weight_dtype: str = "model"
    qk_norm: bool = False
    qkv_bias: bool = False
    o_bias: bool = False
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0
    attn_window: int = 0
    global_attn_layers: Tuple[int, ...] = ()

    mlp_bias: bool = False
    gated_mlp: bool = True
    act: str = "silu"

    norm: str = "rmsnorm"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    max_seq_len: int = 1 << 20
    pos_emb: str = "rope"

    frontend_dim: int = 0
    frontend_len: int = 0

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    frontend: Optional[str] = None

    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.d_head == 0 and self.n_heads > 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.n_heads and self.n_kv_heads and \
                self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.name}: n_heads={self.n_heads} not "
                             f"divisible by n_kv_heads={self.n_kv_heads}")

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def spd_applicable(self) -> bool:
        """SPD needs a second sync point (the MLP or MoE combine) to defer
        the attention partial sum to.  Pure-SSM blocks have one sync
        point."""
        return not self.attn_free

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context without a dense KV cache?"""
        if self.family == "ssm":
            return True
        return self.family == "hybrid" and self.attn_window > 0

    def param_count(self) -> int:
        """Analytic parameter count (the reference's formula): dense GQA
        or MLA, pure SSM, hybrid and MoE."""
        d, L, V = self.d_model, self.n_layers, self.vocab_size
        emb = V * d * (1 if self.tie_embeddings else 2)
        mlp_mats = 3 if self.gated_mlp else 2
        if self.family == "ssm":
            s = self.ssm
            d_in = s.expand * d
            gn = 2 * s.n_groups * s.d_state
            per_layer = (d * (2 * d_in + gn + d_in // s.head_dim)
                         + s.d_conv * (d_in + gn) + d_in * d + d_in)
            return emb + L * per_layer
        kvd = self.n_kv_heads * self.d_head
        qd = self.n_heads * self.d_head
        per_layer = d * (qd + 2 * kvd) + qd * d
        if self.mla is not None:
            m, h = self.mla, self.n_heads
            q_dim = h * (m.qk_nope_head_dim + m.qk_rope_head_dim)
            per_layer = (d * q_dim if m.q_lora_rank == 0 else
                         d * m.q_lora_rank + m.q_lora_rank * q_dim)
            per_layer += (d * (m.kv_lora_rank + m.qk_rope_head_dim)
                          + m.kv_lora_rank * h * (m.qk_nope_head_dim
                                                  + m.v_head_dim)
                          + h * m.v_head_dim * d)
        if self.family == "hybrid" and self.ssm is not None:
            s = self.ssm
            gn = 2 * s.n_groups * s.d_state
            per_layer += d * (qd + gn + qd // s.head_dim) + s.d_conv * (qd + gn)
        if self.moe is None:
            return emb + L * (per_layer + mlp_mats * d * self.d_ff)
        mo = self.moe
        moe_layers = L - mo.n_dense_layers
        per_moe = ((mo.n_routed + mo.n_shared) * mlp_mats * d * mo.d_ff_expert
                   + d * mo.n_routed)
        per_dense = mlp_mats * d * (mo.d_ff_dense or self.d_ff)
        return (emb + L * per_layer + moe_layers * per_moe
                + mo.n_dense_layers * per_dense)

    def active_param_count(self) -> int:
        """Parameters a token runs through (MoE: the top-k routed and the
        shared experts only)."""
        if self.moe is None:
            return self.param_count()
        mo = self.moe
        expert = (3 if self.gated_mlp else 2) * self.d_model * mo.d_ff_expert
        inactive = ((self.n_layers - mo.n_dense_layers)
                    * (mo.n_routed - mo.top_k) * expert)
        return self.param_count() - inactive


@dataclass(frozen=True)
class ShapeConfig:
    """A (seq_len, global_batch, kind) workload cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# reduced shapes for smoke tests
SMOKE_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 64, 4, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 128, 2, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 128, 4, "decode"),
    "long_500k": ShapeConfig("long_500k", 512, 1, "decode"),
}


@dataclass(frozen=True)
class MeshConfig:
    """A device mesh's shape and axis names."""

    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def tp(self) -> int:
        return self.shape[self.axes.index("model")] if "model" in self.axes else 1

    @property
    def dp(self) -> int:
        n = 1
        for ax, s in zip(self.axes, self.shape):
            if ax in ("data", "pod"):
                n *= s
        return n


SINGLE_POD = MeshConfig((16, 16), ("data", "model"))
MULTI_POD = MeshConfig((2, 16, 16), ("pod", "data", "model"))


# Quantization levels a kept sync point (or the logits all-gather) may run at.
SYNC_LEVELS = ("exact", "quant8", "quant4")

# user-facing per-block modes (SPDPlanConfig.from_modes): the cross product
# of {keep, drop} x SYNC_LEVELS
BLOCK_MODES = ("exact", "quant8", "quant4",
               "drop", "drop+quant8", "drop+quant4")


@dataclass(frozen=True)
class CommPolicy:
    """Per-block precision of the syncs an SPD plan keeps, plus the level
    of the final logits all-gather."""

    block_modes: Tuple[str, ...]
    logits_mode: str = "exact"

    def __post_init__(self):
        for m in tuple(self.block_modes) + (self.logits_mode,):
            if m not in SYNC_LEVELS:
                raise ValueError(f"bad sync level {m!r} "
                                 f"(expected one of {SYNC_LEVELS})")

    @property
    def n_quantized(self) -> int:
        return sum(m != "exact" for m in self.block_modes)

    @staticmethod
    def exact(n_layers: int) -> "CommPolicy":
        return CommPolicy(tuple(["exact"] * n_layers))

    @staticmethod
    def uniform(n_layers: int, mode: str,
                logits: str = "exact") -> "CommPolicy":
        return CommPolicy(tuple([mode] * n_layers), logits_mode=logits)


@dataclass(frozen=True)
class SPDPlanConfig:
    """Which blocks drop their attention-output sync point (True = SPD
    block), and optionally the CommPolicy of the syncs that remain."""

    drop_mask: Tuple[bool, ...]
    comm: Optional[CommPolicy] = None

    def __post_init__(self):
        if (self.comm is not None
                and len(self.comm.block_modes) != len(self.drop_mask)):
            raise ValueError(
                f"comm policy covers {len(self.comm.block_modes)} blocks, "
                f"plan has {len(self.drop_mask)}")

    @property
    def n_dropped(self) -> int:
        return sum(self.drop_mask)

    @property
    def fraction(self) -> float:
        return self.n_dropped / max(len(self.drop_mask), 1)

    @property
    def qmodes(self) -> Optional[Tuple[str, ...]]:
        """Per-layer kept-sync levels, or None for all-exact."""
        return None if self.comm is None else self.comm.block_modes

    @property
    def logits_mode(self) -> str:
        return "exact" if self.comm is None else self.comm.logits_mode

    def block_mode(self, i: int) -> Optional[str]:
        return None if self.comm is None else self.comm.block_modes[i]

    def with_comm(self, comm: Optional[CommPolicy]) -> "SPDPlanConfig":
        return SPDPlanConfig(self.drop_mask, comm)

    @staticmethod
    def from_modes(modes, logits: str = "exact") -> "SPDPlanConfig":
        """A plan and policy from per-block BLOCK_MODES: "drop[+quantN]"
        drops the attention sync and runs the MLP sync at that level; a
        plain level keeps both syncs at it."""
        drop, levels = [], []
        for m in modes:
            if m not in BLOCK_MODES:
                raise ValueError(f"bad block mode {m!r} "
                                 f"(expected one of {BLOCK_MODES})")
            drop.append(m.startswith("drop"))
            levels.append(m.split("+", 1)[1] if "+" in m
                          else "exact" if drop[-1] else m)
        return SPDPlanConfig(tuple(drop),
                             CommPolicy(tuple(levels), logits_mode=logits))

    def modes(self):
        """Inverse of from_modes: the per-block mode list."""
        out = []
        for d, m in zip(self.drop_mask,
                        self.qmodes or ("exact",) * len(self.drop_mask)):
            if d:
                out.append("drop" if m == "exact" else f"drop+{m}")
            else:
                out.append(m)
        return out

    @staticmethod
    def none(n_layers: int) -> "SPDPlanConfig":
        return SPDPlanConfig(tuple([False] * n_layers))

    @staticmethod
    def full(n_layers: int) -> "SPDPlanConfig":
        return SPDPlanConfig(tuple([True] * n_layers))

    @staticmethod
    def first_k(n_layers: int, k: int) -> "SPDPlanConfig":
        return SPDPlanConfig(tuple([i < k for i in range(n_layers)]))

    @staticmethod
    def from_ranking(ranking, n_spd: int, n_layers: int) -> "SPDPlanConfig":
        """Drop the first n_spd blocks of `ranking` (ascending
        sensitivity)."""
        drop = [False] * n_layers
        for idx in list(ranking)[:n_spd]:
            drop[int(idx)] = True
        return SPDPlanConfig(tuple(drop))


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
