from repro_torch.checkpoint.ckpt import (CheckpointManager,
                                         CheckpointShapeError,
                                         load_checkpoint, save_checkpoint)

__all__ = ["CheckpointManager", "CheckpointShapeError", "load_checkpoint",
           "save_checkpoint"]
