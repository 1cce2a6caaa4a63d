"""The train step (PyTorch port of the reference ``train``)."""
from repro_torch.train.train_step import (  # noqa: F401
    TrainHParams, TrainState, init_train_state, make_train_step,
)
