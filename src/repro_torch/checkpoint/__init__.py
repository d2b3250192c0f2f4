from repro_torch.checkpoint.ckpt import (latest_step, restore_checkpoint,
                                         restore_latest, save_checkpoint)

__all__ = ["latest_step", "restore_checkpoint", "restore_latest",
           "save_checkpoint"]
