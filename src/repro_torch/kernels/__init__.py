"""Hand-written Hopper kernels of the port (CUDA C++ for sm_90a).

Each kernel package holds the wrapper the model calls, its plain
PyTorch versions (the CPU path and the on-card yardstick) and a launch
counter; ``build`` compiles ``csrc/*.cu`` with nvcc at first use.
"""
import threading

import torch

_LAUNCH_LOCK = threading.Lock()


def refuse_grad(name: str, *tensors) -> None:
    """Raise where autograd would record a kernel's call: the kernels
    return tensors without a ``grad_fn``, so a launch under grad mode
    with an input that requires grad would leave every weight behind it
    without a gradient, silently.  Training runs the plain versions
    (``models/lm.py:LM.train_loss``); no backward kernel exists."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad and grad mode is on; the "
            f"kernel has no backward (training runs the plain version)")


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` under a lock: replicas of an
    engine serve from threads of one process (``ReplicatedSUT``), and
    an unlocked ``+= 1`` from two threads can lose a count."""
    with _LAUNCH_LOCK:
        wrapper.launches += 1
