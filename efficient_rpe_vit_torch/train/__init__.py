from .training import (
    TrainState,
    create_lr_scheduler,
    create_optimizer,
    create_train_state,
    cross_entropy_loss,
    make_eval_step,
    make_micro_loss,
    make_train_step,
)

__all__ = [
    "TrainState",
    "create_lr_scheduler",
    "create_optimizer",
    "create_train_state",
    "cross_entropy_loss",
    "make_eval_step",
    "make_micro_loss",
    "make_train_step",
]
