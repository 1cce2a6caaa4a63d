"""The MLPerf Power methodology (PyTorch port of ``src/repro/core``;
the modules are copies whose only edits are imports)."""
# The paper's primary contribution: the MLPerf Power measurement
# methodology — virtual instruments, loadgen scenarios, Director/SUT
# protocol, standardized logging, energy summarization, compliance.
from repro_torch.core.power_model import (  # noqa: F401
    RooflineTimes, StepWork, SystemPowerModel, TinyPowerModel, roofline,
)
from repro_torch.core.analyzer import (  # noqa: F401
    AnalyzerSpec, IOManager, NodeTelemetry, SwitchEstimator,
    TelemetrySpec, VirtualAnalyzer,
)
from repro_torch.core.loadgen import (  # noqa: F401
    Clock, LoadgenResult, QuerySampleLibrary, ServerMetrics,
    loops_for_min_duration, nan_percentile, poisson_arrivals,
    run_multi_stream, run_offline, run_server, run_server_queue,
    run_single_stream,
)
from repro_torch.core.director import Director, NTPSync, PTDSession  # noqa: F401
from repro_torch.core.mlperf_log import (  # noqa: F401
    LogEvent, MLPerfLogger, find_window,
)
from repro_torch.core.summarizer import (  # noqa: F401
    EnergySummary, energy_to_train, summarize,
)
from repro_torch.core.compliance import (  # noqa: F401
    ReviewReport, SystemDescription, review,
)
from repro_torch.core import efficiency  # noqa: F401
