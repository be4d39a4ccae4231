from .checkpoint import (CheckpointManager, barrier, latest_step,
                         load_checkpoint, save_checkpoint)

__all__ = ["CheckpointManager", "barrier", "save_checkpoint",
           "load_checkpoint", "latest_step"]
