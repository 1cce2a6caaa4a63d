"""``repro_torch.power`` — multi-channel power-domain metering.

The measurement side of the harness redesigned around *domains and
meters* (SPEC PTDaemon's multi-channel model): a ``PowerDomain`` names
a measurement boundary (``accelerator``, ``dram``, ``host``, ``wall``,
``pdu``, ``pin``) with its own true waveform, a ``Meter`` binds a
domain to an instrument channel, a ``PSUModel`` links the DC rails to
the wall through a loss curve, and a ``MeterStack`` is driven by the
Director/PTD session as one unit — shared NTP-corrected timeline,
per-channel two-pass ranging, per-domain traces and energies.

SUT adapters declare their domains; ``PowerRun`` builds and drives the
stack and reports per-domain energy:

    from repro_torch.power import PowerDomain, MeterStack, Meter, PSUModel

    rails = [PowerDomain("accelerator", acc_src),
             PowerDomain("dram", dram_src),
             PowerDomain("host", host_src)]
    psu = PSUModel(rated_watts=400.0, efficiency=0.94)
    wall = PowerDomain("wall", psu.wall_source([r.source for r in rails]),
                       boundary=True)
    stack = build_stack(rails + [wall], sysdesc, psu=psu)

Copied from the reference ``src/repro/power/__init__.py``; only its imports
differ.
"""
from repro_torch.power.domains import (  # noqa: F401
    ACCELERATOR, DRAM, HOST, KINDS, PDU, PIN, RAIL_KINDS, WALL,
    PowerDomain, PowerSource, wall_domain,
)
from repro_torch.power.psu import GOLD_CURVE, PSUModel  # noqa: F401
from repro_torch.power.stack import (  # noqa: F401
    Meter, MeterStack, PIN_CHANNEL, build_stack, single_source_stack,
    telemetry_channel,
)
