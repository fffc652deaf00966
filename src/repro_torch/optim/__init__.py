from .optimizers import (
    Optimizer,
    adam,
    momentum,
    opt_state_bytes_per_param,
    sgd,
)
