from cobevt_tpu_torch.train.optim import (
    cosine_warmup_schedule,
    make_optimizer,
    onecycle_schedule,
)
from cobevt_tpu_torch.train.state import (
    TrainState,
    compute_twin,
    create_train_state,
)
from cobevt_tpu_torch.train.step import (
    global_norm,
    make_eval_step,
    make_train_step,
)

__all__ = ["TrainState", "compute_twin", "cosine_warmup_schedule",
           "create_train_state",
           "global_norm", "make_eval_step", "make_optimizer",
           "make_train_step", "onecycle_schedule"]
