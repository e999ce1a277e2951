from .checkpoint import AsyncCheckpointer, load_checkpoint, save_checkpoint
from .loop import (
    Trainer, condition_input, cross_entropy_loss, make_eval_step, make_train_step, topk_correct,
)
from .optim import SGDState, sgd_init, sgd_update, weight_decay_mask
from .schedules import lr_schedule

__all__ = [
    "AsyncCheckpointer", "SGDState", "Trainer", "condition_input", "cross_entropy_loss",
    "load_checkpoint", "lr_schedule", "make_eval_step", "make_train_step", "save_checkpoint",
    "sgd_init", "sgd_update", "topk_correct", "weight_decay_mask",
]
