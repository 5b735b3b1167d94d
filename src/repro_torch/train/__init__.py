from .data import DataConfig, SyntheticDataset
from .optimizer import (
    AdafactorState,
    AdamWState,
    adafactor_init,
    adafactor_update,
    adamw_init,
    adamw_update,
    lr_schedule,
    make_optimizer,
)
from .train_step import (
    TrainState,
    cross_entropy,
    init_train_state,
    make_eval_step,
    make_loss_fn,
    make_train_step,
    train_state_specs,
)

__all__ = [k for k in dir() if not k.startswith("_")]
