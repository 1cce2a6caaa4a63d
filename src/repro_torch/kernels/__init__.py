"""Hand-written Hopper kernels of the port (CUDA C++ for sm_90a).

Each kernel package holds the wrapper the model calls, its plain
PyTorch versions (the CPU path and the on-card yardstick) and a launch
counter; ``build`` compiles ``csrc/*.cu`` with nvcc at first use.
"""
import threading

_LAUNCH_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` under a lock: replicas of an
    engine serve from threads of one process (``ReplicatedSUT``), and
    an unlocked ``+= 1`` from two threads can lose a count."""
    with _LAUNCH_LOCK:
        wrapper.launches += 1
