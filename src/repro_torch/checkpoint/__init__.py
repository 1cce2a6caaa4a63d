"""Atomic checkpoints and the recovery supervisor (PyTorch port of the
reference ``checkpoint``)."""
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
from repro_torch.checkpoint.supervisor import (  # noqa: F401
    RecoveryReport, SimulatedFailure, StragglerMonitor, run_with_recovery,
)
