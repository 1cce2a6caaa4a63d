"""Power domains: named measurement boundaries (§III-A, §IV-B/C).

The paper's core methodological claim is that comparable energy
numbers require an explicit *measurement boundary*: an AC wall
analyzer behind the PSU for edge/datacenter submissions, out-of-band
node telemetry aggregated at the PDU for multi-node fleets, and a
pin-demarcated DC capture for tiny devices.  A ``PowerDomain`` names
one such boundary and carries the true power waveform inside it:

- ``accelerator`` — a chip's DC rail (compute + ICI dynamic + static);
  tensor-parallel systems expose one channel per shard
  (``accelerator/0`` ... ``accelerator/K-1``).
- ``dram``        — the HBM/DRAM rail.
- ``host``        — host CPU/fans/NIC plus interconnect switches.
- ``wall``        — the AC side of the PSU; *derives* from the DC
  rails through the PSU loss curve (``repro_torch.power.psu.PSUModel``) and
  is what an external SPEC-class analyzer actually sees.
- ``pdu``         — rack-level aggregation of several nodes' wall
  feeds (the paper's fallback when per-node metering is infeasible).
- ``pin``         — the tiny scale's pin-demarcated DC supply channel.

``boundary=True`` marks the domain whose energy *is* the submission's
total (wall for a single node, pdu for a fleet, pin for tiny); the
other domains are the per-component breakdown inside that boundary and
must never be double-counted into the total.

Copied from the reference ``src/repro/power/domains.py``; only its imports
differ.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

PowerSource = Callable[[np.ndarray], np.ndarray]

# canonical domain kinds
ACCELERATOR = "accelerator"
DRAM = "dram"
HOST = "host"
WALL = "wall"
PDU = "pdu"
PIN = "pin"

KINDS = (ACCELERATOR, DRAM, HOST, WALL, PDU, PIN)

# DC-side component rails (what the PSU converts into wall power)
RAIL_KINDS = (ACCELERATOR, DRAM, HOST)


@dataclasses.dataclass
class PowerDomain:
    """One named measurement boundary.

    ``source(t_s) -> watts`` is the true waveform inside the boundary
    (the physics the instrument samples).  Derived domains — a PDU
    aggregating already-measured wall feeds — leave ``source`` unset
    and name the channels they combine in ``derived_from``; the stack
    computes them from the *measured* samples of those channels, which
    is exactly what a PDU's summing register does.

    ``kind`` is the canonical boundary type; it defaults to the name
    so ``PowerDomain("wall", src)`` just works, while sharded/fleet
    channels disambiguate (``name="accelerator/0"``,
    ``kind="accelerator"``; ``name="r1/wall"``, ``kind="wall"``,
    ``group="r1"``).  ``group`` scopes the compliance invariants: the
    wall of group ``g`` is checked against the rails of group ``g``.
    """

    name: str
    source: Optional[PowerSource] = None
    kind: str = ""
    group: str = ""
    boundary: bool = False
    derived_from: tuple = ()
    # derived channels: combine([w_ch0, w_ch1, ...]) -> watts; sum by
    # default (PDU semantics)
    combine: Optional[Callable] = None

    def __post_init__(self):
        if not self.kind:
            self.kind = self.name
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown domain kind {self.kind!r} (name={self.name!r}); "
                f"expected one of {KINDS}")
        if self.source is None and not self.derived_from:
            raise ValueError(
                f"domain {self.name!r} needs a source or derived_from")

    @property
    def derived(self) -> bool:
        return bool(self.derived_from)

    def metadata(self) -> dict:
        """The per-sample log metadata the summarizer/compliance read."""
        return {"kind": self.kind, "group": self.group,
                "boundary": self.boundary}


def wall_domain(source: PowerSource, *, boundary: bool = True,
                group: str = "") -> PowerDomain:
    """The single-channel compatibility boundary: one scalar source
    measured at the wall (what the pre-MeterStack API modelled)."""
    name = f"{group}/{WALL}" if group else WALL
    return PowerDomain(name, source, kind=WALL, group=group,
                       boundary=boundary)
