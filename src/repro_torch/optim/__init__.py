from repro_torch.optim.adamw import (adamw_init, adamw_update, apply_updates,
                                     clip_by_global_norm, global_norm)
from repro_torch.optim.schedule import make_schedule

__all__ = ["adamw_init", "adamw_update", "apply_updates", "global_norm",
           "clip_by_global_norm", "make_schedule"]
