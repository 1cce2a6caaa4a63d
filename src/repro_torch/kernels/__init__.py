"""Hand-written Hopper kernels of the port (CUDA C++ for sm_90a).

Each kernel package holds the wrapper the model calls, its plain
PyTorch versions (the CPU path and the on-card yardstick) and a launch
counter; ``build`` compiles ``csrc/*.cu`` with nvcc at first use.
"""
