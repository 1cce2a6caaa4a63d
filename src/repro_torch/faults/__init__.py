"""``repro_torch.faults`` — deterministic fault injection + retry policy.

The robustness layer: typed fault specs (meter sample dropout, range
overload/clipping, NTP-skew spikes, replica crash/hang, queue overload
bursts) bundled into a seeded ``FaultPlan``, a ``FaultInjector`` that
applies the metering faults inside ``MeterStack.measure``, and the
``RetryPolicy`` (bounded exponential backoff) shared by every graceful-
degradation path — meter interval re-measurement, fleet re-dispatch
after a replica crash, and ``PowerRun``'s invalid-run re-execution.

    from repro_torch.faults import FaultPlan, MeterDropout, RetryPolicy

    plan = FaultPlan([MeterDropout("wall", 10.0, 8.0)], seed=7)
    r = PowerRun(sut, scenario, fault_plan=plan,
                 meter_retry=RetryPolicy()).run()
    print(r.channel_health["wall"].describe())

Injected faults either get absorbed by the layer they target (and show
up in health/metrics counters) or the compliance review rejects the
run with the invariant named — never a plausible-but-wrong number.

Copied from the reference ``src/repro/faults``; only its imports differ.
The faults act on the meter stack's sampling of a channel (the
NVML-measured accelerator trace included) and on the loadgen's and the
fleet's schedules, never on the card or on NVML itself.
"""
from repro_torch.faults.inject import ChannelHealth, FaultInjector  # noqa: F401
from repro_torch.faults.plan import (  # noqa: F401
    ClockSkew, FaultPlan, MeterDropout, QueueOverload, RangeOverload,
    ReplicaCrash, ReplicaHang, RetryPolicy,
)
