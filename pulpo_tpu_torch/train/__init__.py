"""Training: the step (`step.py`), the Trainer loop (`loop.py`), its
checkpoints and metrics, re-exported as the JAX package's
`pulpo_tpu.train` does.

`Trainer` is imported on first use (a module `__getattr__`): `loop.py`
imports `parallel/dp.py`, which imports `step.py` through this package,
so an import at the top would be a cycle when `dp.py` is imported first."""

from pulpo_tpu_torch.train.step import (
    Adam,
    TrainState,
    compute_losses,
    create_train_state,
    make_eval_step,
    make_train_step,
)

__all__ = ["Adam", "TrainState", "compute_losses", "create_train_state",
           "make_eval_step", "make_train_step", "Trainer"]


def __getattr__(name: str):
    if name == "Trainer":
        from pulpo_tpu_torch.train.loop import Trainer

        return Trainer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
