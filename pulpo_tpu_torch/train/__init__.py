from pulpo_tpu_torch.train.step import (
    Adam,
    TrainState,
    compute_losses,
    create_train_state,
    make_eval_step,
    make_train_step,
)

__all__ = ["Adam", "TrainState", "compute_losses", "create_train_state",
           "make_eval_step", "make_train_step"]
