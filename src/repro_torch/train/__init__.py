"""Train-step factory and the train state."""
from repro_torch.train.steps import (
    TrainState, init_train_state, make_decode_step, make_prefill_step,
    make_train_step,
)

__all__ = ["TrainState", "init_train_state", "make_train_step",
           "make_prefill_step", "make_decode_step"]
