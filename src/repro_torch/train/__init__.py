from repro_torch.train.compression import init_error_feedback
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.train_step import (cross_entropy_loss,
                                          init_train_state, make_loss_fn,
                                          make_train_step)
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cross_entropy_loss",
           "init_train_state", "make_loss_fn", "make_train_step", "Trainer",
           "TrainerConfig", "init_error_feedback"]
