from cobevt_tpu_torch.train.optim import (
    cosine_warmup_schedule,
    make_optimizer,
)
from cobevt_tpu_torch.train.state import TrainState, create_train_state
from cobevt_tpu_torch.train.step import (
    global_norm,
    make_eval_step,
    make_train_step,
)

__all__ = ["TrainState", "cosine_warmup_schedule", "create_train_state",
           "global_norm", "make_eval_step", "make_optimizer",
           "make_train_step"]
