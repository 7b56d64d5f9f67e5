"""Parameter splitting onto the shard axis (port of the parameter half
of repro/core/simtp.py)."""
from __future__ import annotations

from repro_torch.config.base import ModelConfig, SPDPlanConfig
from repro_torch.core import model as M
from repro_torch.parallel.layout import REPLICATED, split_leaf
from repro_torch.tree import tree_map


def _split_with_offset(tree, specs, tp, offset):
    return tree_map(lambda w, a: split_leaf(
        w, a if a == REPLICATED else a + offset, tp), tree, specs)


def split_stacked(stacked: dict, cfg: ModelConfig, plan: SPDPlanConfig,
                  tp: int) -> dict:
    """Stacked/padded tree -> every leaf with a leading (tp, ...) axis
    (segment leaves carry their layer axis at dim 1)."""
    specs = M.stacked_specs(cfg, plan)
    out = {}
    for k, v in stacked.items():
        if k == "segs":
            out["segs"] = [_split_with_offset(sv, ss, tp, offset=1)
                           for sv, ss in zip(v, specs["segs"])]
        else:
            out[k] = _split_with_offset(v, specs[k], tp, offset=0)
    return out


def prepare_params(canonical: dict, cfg: ModelConfig, plan: SPDPlanConfig,
                   tp: int) -> dict:
    """canonical -> padded -> stacked -> split."""
    padded = M.pad_model(canonical, cfg, tp)
    return split_stacked(M.stack_segments(padded, cfg, plan), cfg, plan, tp)
