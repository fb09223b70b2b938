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
    full_state_dict,
    global_norm,
    make_eval_step,
    make_train_step,
    place_state,
)

__all__ = ["TrainState", "compute_twin", "cosine_warmup_schedule",
           "create_train_state", "full_state_dict",
           "global_norm", "make_eval_step", "make_optimizer",
           "make_train_step", "onecycle_schedule", "place_state"]
