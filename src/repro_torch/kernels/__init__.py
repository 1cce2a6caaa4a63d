"""Hand-written Hopper kernels of the port (CUDA C++ for sm_90a).

Each kernel package holds the wrapper the model calls, its plain
PyTorch versions (the CPU path and the on-card yardstick) and a launch
counter; ``build`` compiles ``csrc/*.cu`` with nvcc at first use.
Tensors on a ``PLAIN_DEVICES`` device (the CPU, and ``meta``, on which
the dry-run counts a program without running it) take the plain
version; CUDA tensors launch the kernel; any other device raises.  Each
wrapper reports its call's work (``work``) to an active counter on
every route.
"""
import threading

import torch

_LAUNCH_LOCK = threading.Lock()

# the device types whose tensors take a kernel's plain version
PLAIN_DEVICES = ("cpu", "meta")


def plain_route(t: torch.Tensor) -> bool:
    """Whether a call on ``t`` takes the plain version (``t`` lies on a
    ``PLAIN_DEVICES`` device)."""
    return t.device.type in PLAIN_DEVICES


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
