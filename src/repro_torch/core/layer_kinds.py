"""Layer-kind descriptors (port of repro/core/layer_kinds.py).

Segments of consecutive layers with the same (kind, drop flag, sync
level) stack their parameters on one layer axis."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from repro_torch.config.base import ModelConfig


@dataclass(frozen=True)
class LayerKind:
    mixer: str           # gqa | mla | ssm | hybrid
    ffn: str             # mlp | moe | none
    window: int = 0      # sliding attention window; 0 = full causal
    d_ff: int = 0        # per-layer MLP width


def layer_kinds(cfg: ModelConfig) -> Tuple[LayerKind, ...]:
    """The reference's layer kinds: MoE FFNs after `n_dense_layers`, MLA
    mixers where the config has an MLA block, hybrid mixers on the
    hybrid family, `attn_window` on every layer but
    `global_attn_layers`."""
    kinds = []
    for i in range(cfg.n_layers):
        if cfg.family == "ssm":
            kinds.append(LayerKind(mixer="ssm", ffn="none"))
            continue
        mixer = "gqa" if cfg.mla is None else "mla"
        if cfg.family == "hybrid":
            mixer = "hybrid"
        window = cfg.attn_window
        if window and i in cfg.global_attn_layers:
            window = 0
        if cfg.moe is not None and i >= cfg.moe.n_dense_layers:
            kinds.append(LayerKind(mixer=mixer, ffn="moe", window=window))
            continue
        d_ff = cfg.d_ff
        if cfg.moe is not None and cfg.moe.d_ff_dense:
            d_ff = cfg.moe.d_ff_dense
        kinds.append(LayerKind(mixer=mixer, ffn="mlp", window=window,
                               d_ff=d_ff))
    return tuple(kinds)


def plan_segments(cfg: ModelConfig, drop_mask: Tuple[bool, ...],
                  qmodes: Tuple[str, ...] = None):
    """Runs of consecutive layers sharing (kind, dropped, sync level):
    [(start, length, kind, dropped)]."""
    kinds = layer_kinds(cfg)
    if len(drop_mask) != cfg.n_layers:
        raise ValueError(f"drop mask covers {len(drop_mask)} layers, "
                         f"model has {cfg.n_layers}")
    if qmodes is not None and len(qmodes) != cfg.n_layers:
        raise ValueError(f"qmodes cover {len(qmodes)} layers, "
                         f"model has {cfg.n_layers}")
    segs = []
    start = 0
    for i in range(1, cfg.n_layers + 1):
        if (i == cfg.n_layers or kinds[i] != kinds[start]
                or drop_mask[i] != drop_mask[start]
                or (qmodes is not None and qmodes[i] != qmodes[start])):
            segs.append((start, i - start, kinds[start], drop_mask[start]))
            start = i
    return segs
