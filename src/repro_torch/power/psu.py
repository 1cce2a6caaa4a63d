"""PSU model: DC rails -> AC wall through a load-dependent loss curve.

The wall boundary is not a component you can sum from datasheets — it
is the DC draw *plus conversion loss*, and the loss depends on load
(80 PLUS-style efficiency curves sag at the extremes).  The model
keeps the seed behaviour as its default: a flat ``efficiency`` equal
to the old ``SystemSpec.psu_efficiency`` reproduces every pre-domain
wall number exactly; pass ``curve`` points for the realistic sagging
shape (``benchmarks/power_breakdown.py`` uses one).

Copied from the reference ``src/repro/power/psu.py``; only its imports
differ.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# A typical 80 PLUS Gold-ish shape: (load fraction, efficiency).
GOLD_CURVE = ((0.05, 0.80), (0.10, 0.86), (0.20, 0.90), (0.50, 0.92),
              (1.00, 0.89))


@dataclasses.dataclass(frozen=True)
class PSUModel:
    """AC->DC conversion: ``wall = dc / eta(dc / rated)``.

    ``rated_watts`` anchors the load fraction for the curve; with an
    empty ``curve`` the efficiency is the flat ``efficiency`` and the
    model is bit-compatible with the scalar ``psu_efficiency`` the
    power model used before domains existed.
    """

    rated_watts: float
    efficiency: float = 0.94
    curve: tuple = ()                 # ((load_frac, eta), ...) sorted

    def eta(self, dc_watts):
        """Efficiency at a DC load (scalar or array)."""
        if not self.curve:
            if np.isscalar(dc_watts):
                return self.efficiency
            return np.full_like(np.asarray(dc_watts, float),
                                self.efficiency)
        load = np.asarray(dc_watts, float) / max(self.rated_watts, 1e-9)
        fracs = np.asarray([p[0] for p in self.curve])
        etas = np.asarray([p[1] for p in self.curve])
        out = np.interp(load, fracs, etas)
        return float(out) if np.isscalar(dc_watts) else out

    def wall_watts(self, dc_watts):
        return np.asarray(dc_watts, float) / self.eta(dc_watts)

    def loss_watts(self, dc_watts):
        return self.wall_watts(dc_watts) - np.asarray(dc_watts, float)

    def wall_source(self, rail_sources):
        """True wall waveform from the DC rail waveforms: the source a
        wall analyzer samples.  ``rail_sources``: list of
        ``source(t) -> watts``."""

        def wall(t):
            t = np.asarray(t, float)
            dc = np.zeros_like(t)
            for src in rail_sources:
                dc = dc + np.asarray(src(t), float)
            return self.wall_watts(dc)

        return wall
