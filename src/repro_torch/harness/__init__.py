"""``repro_torch.harness`` — the public measurement API (PyTorch port
of ``src/repro/harness``; ``ShardedSUT`` waits for ROADMAP §A.8).

One measurement protocol, uniformly applied (the paper's core
contribution): wrap any system behind the ``SUT`` protocol, pick a
``Scenario``, and

    result = PowerRun(sut, scenario).run()

runs loadgen + Director protocol (driving the SUT's multi-channel
``MeterStack`` — per-domain instruments, per-channel ranging, one
shared timeline) + summarizer + compliance review (including the
cross-domain wall-vs-rails invariants) and returns a
``SubmissionResult``: metrics, total Joules, per-domain energy and
efficiency, the review report, an ``efficiency.Submission`` for trend
analyses, and per-request energy (total and per domain) when the SUT
keeps request records.

    from repro_torch.harness import (CallableSUT, PowerRun, SingleStream,
                               MultiStream, Offline, Server)

    sut = CallableSUT(issue=lambda s: 0.01, power=42.0)
    res = PowerRun(sut, SingleStream()).run()
    assert res.passed
    print(res.render())
    print(res.per_domain_energy_j)       # {"wall": ...} per channel

Migration note: the scalar ``SUT.power_source(outcome)`` surface is
deprecated.  Adapters now declare ``domains(outcome) ->
list[repro_torch.power.PowerDomain]`` (or override ``meter_stack``); a SUT
that only provides ``power_source`` is wrapped into a single-domain
wall-only stack with a ``DeprecationWarning``.
"""
from repro_torch.harness.sut import (  # noqa: F401
    SUT, BaseSUT, CallableSUT, ContinuousBatchingSUT, DisaggregatedSUT,
    MeasuredTrace, ReplicatedSUT, ServeEngineSUT, TinySUT, constant_power,
    measured_domains, measured_sysdesc,
    rail_domains, throughput_watts, throughput_work,
)
from repro_torch.harness.scenarios import (  # noqa: F401
    SCENARIOS, MultiStream, Offline, Scenario, ScenarioOutcome, Server,
    SingleStream, TraceServer,
)
from repro_torch.harness.power_run import (  # noqa: F401
    PowerRun, SubmissionResult, analyzer_for_scale,
)
from repro_torch.core.loadgen import ShedPolicy  # noqa: F401
from repro_torch.power import (  # noqa: F401
    MeterStack, PowerDomain, PSUModel, build_stack,
)
