"""Layer-kind descriptors (port of repro/core/layer_kinds.py).

Segments of consecutive layers with the same (kind, drop flag, sync
level) stack their parameters on one layer axis."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from repro_torch.config.base import ModelConfig


@dataclass(frozen=True)
class LayerKind:
    mixer: str           # gqa | ssm (the mixers the port serves)
    ffn: str             # mlp | none
    window: int = 0      # always 0 here: sliding windows are not ported
    d_ff: int = 0


def layer_kinds(cfg: ModelConfig) -> Tuple[LayerKind, ...]:
    if cfg.family == "ssm":
        return tuple(LayerKind(mixer="ssm", ffn="none")
                     for _ in range(cfg.n_layers))
    if cfg.family != "dense" or cfg.mla is not None or cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
            "(dense GQA and pure SSM only)")
    if cfg.attn_window:
        raise NotImplementedError(f"{cfg.name}: sliding-window attention "
                                  "is not ported yet")
    return tuple(LayerKind(mixer="gqa", ffn="mlp", d_ff=cfg.d_ff)
                 for _ in range(cfg.n_layers))


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
