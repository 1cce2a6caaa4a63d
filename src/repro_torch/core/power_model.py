"""Analytical power model: roofline quantities -> watts over time.

This is the "sensor" behind the virtual analyzers and node telemetry
(DESIGN.md §2).  Given a workload's per-step compute/memory/collective
work (from ``compiled.cost_analysis()`` + HLO collective parsing, or
from analytic model FLOPs), it produces a full-system power trace:

  P(t) = [ chips * (idle + e_flop*FLOPs/t_step * u_c(t)
                   + e_hbm*bytes/t_step * u_m(t)
                   + e_ici*coll_bytes/t_step * u_x(t))
           + hosts + switches ] / psu_efficiency

with phase-dependent utilization u(t) so traces show the paper's
workload phases (init / execution / teardown) and duty cycles.  The
tiny scale uses the MAC-level MCU model with sleep between inferences.

Copied from the reference ``src/repro/core/power_model.py``; only its imports
differ.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np

from repro_torch.hw import ChipSpec, SystemSpec, TinyDeviceSpec, TINY_MCU


@dataclasses.dataclass(frozen=True)
class StepWork:
    """Per-chip work per executed step (one train step / one inference)."""

    flops: float
    hbm_bytes: float
    ici_bytes: float = 0.0
    flops_int8: float = 0.0       # portion executed on the int8 path

    def scaled(self, k: float) -> "StepWork":
        return StepWork(self.flops * k, self.hbm_bytes * k,
                        self.ici_bytes * k, self.flops_int8 * k)


@dataclasses.dataclass(frozen=True)
class RooflineTimes:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def step_s(self) -> float:
        """Bounding-term step-time estimate (no overlap assumed)."""
        return max(self.compute_s, self.memory_s, self.collective_s, 1e-12)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)


def roofline(work: StepWork, chip: ChipSpec) -> RooflineTimes:
    bf16 = work.flops - work.flops_int8
    t_c = bf16 / chip.peak_flops_bf16
    if work.flops_int8:
        t_c += work.flops_int8 / chip.peak_flops_int8
    return RooflineTimes(
        compute_s=t_c,
        memory_s=work.hbm_bytes / chip.hbm_bandwidth,
        collective_s=(work.ici_bytes / chip.ici_bandwidth
                      if chip.ici_bandwidth else 0.0),
    )


class SystemPowerModel:
    """Datacenter / edge scale: chips + hosts + switches."""

    def __init__(self, system: SystemSpec, n_chips: int):
        self.system = system
        self.chip = system.chip
        self.n_chips = n_chips

    def step_time(self, work: StepWork) -> float:
        return roofline(work, self.chip).step_s

    def dynamic_chip_watts(self, work: StepWork,
                           step_s: Optional[float] = None) -> float:
        """Average dynamic power of one chip executing ``work``."""
        t = step_s or self.step_time(work)
        e = ((work.flops - work.flops_int8) * self.chip.e_flop_bf16
             + work.flops_int8 * self.chip.e_flop_int8
             + work.hbm_bytes * self.chip.e_hbm_byte
             + work.ici_bytes * self.chip.e_ici_byte)
        return e / t

    def rail_watts(self, work: Optional[StepWork],
                   step_s: Optional[float] = None,
                   host_active: bool = True) -> dict[str, float]:
        """DC-side power per domain rail (pre-PSU): the per-component
        breakdown behind the wall boundary.

        - ``accelerator``: chip static + compute/ICI dynamic power,
        - ``dram``: the HBM rail (bytes moved x J/byte),
        - ``host``: host CPUs/fans/NICs plus interconnect switches.

        ``sum(rail_watts(...).values()) / psu_efficiency`` equals
        ``system_watts(...)`` exactly — the wall is the rails through
        the PSU, never an independent fourth component.
        """
        s = self.system
        acc_w = self.n_chips * self.chip.idle_watts
        dram_w = 0.0
        if work is not None:
            t = step_s or self.step_time(work)
            e_core = ((work.flops - work.flops_int8) * self.chip.e_flop_bf16
                      + work.flops_int8 * self.chip.e_flop_int8
                      + work.ici_bytes * self.chip.e_ici_byte)
            acc_w += self.n_chips * e_core / t
            dram_w = self.n_chips * work.hbm_bytes * self.chip.e_hbm_byte / t
        hosts = s.n_hosts(self.n_chips)
        host_w = hosts * (s.host_active_watts if host_active and work
                          else s.host_idle_watts)
        host_w += s.n_switches(self.n_chips) * s.switch_watts
        return {"accelerator": acc_w, "dram": dram_w, "host": host_w}

    def psu(self):
        """The PSU loss model linking these rails to the wall domain
        (flat efficiency — bit-compatible with ``system_watts``)."""
        from repro_torch.power.psu import PSUModel

        s = self.system
        rated = (self.n_chips * self.chip.peak_watts
                 + s.n_hosts(self.n_chips) * s.host_active_watts
                 + s.n_switches(self.n_chips) * s.switch_watts)
        return PSUModel(rated_watts=rated, efficiency=s.psu_efficiency)

    def system_watts(self, work: Optional[StepWork],
                     step_s: Optional[float] = None,
                     host_active: bool = True) -> float:
        """Full-system average power during execution (or idle): the
        wall boundary (sum of the DC rails through the PSU)."""
        rails = self.rail_watts(work, step_s, host_active)
        return sum(rails.values()) / self.system.psu_efficiency

    # ------------------------------------------------------------------
    def trace(self, work: StepWork, *, duration_s: float,
              init_s: float = 0.0, teardown_s: float = 0.0,
              jitter: float = 0.02, dt_s: float = 0.1,
              dt: Optional[float] = None,
              seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """Power trace (t, watts) with init/execute/teardown phases."""
        if dt is not None:               # deprecated unsuffixed alias
            warnings.warn(
                "trace(dt=...) is deprecated; the step is seconds — "
                "pass dt_s=", DeprecationWarning, stacklevel=2)
            dt_s = dt
        rng = np.random.default_rng(seed)
        total_s = init_s + duration_s + teardown_s
        t = np.arange(0.0, total_s, dt_s)
        p_idle = self.system_watts(None)
        p_exec = self.system_watts(work)
        p = np.where((t >= init_s) & (t < init_s + duration_s),
                     p_exec, p_idle)
        # data-loading/init draws host-active power
        p = np.where(t < init_s, p_idle * 1.05, p)
        p = p * (1 + jitter * rng.standard_normal(len(t)))
        return t, p

    def energy_per_step(self, work: StepWork) -> float:
        t = self.step_time(work)
        return self.system_watts(work) * t


class TinyPowerModel:
    """MCU scale: duty-cycled energy per inference (pin-demarcated)."""

    def __init__(self, device: TinyDeviceSpec = TINY_MCU):
        self.device = device

    def inference_time(self, macs: float) -> float:
        return self.device.inference_time(macs)

    def inference_energy(self, macs: float, sram_bytes: float) -> float:
        return self.device.inference_energy(macs, sram_bytes)

    def waveform(self, macs: float, sram_bytes: float, *,
                 n_inferences: int, period_s: float,
                 sample_hz: float = 10_000.0,
                 seed: int = 0) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Current waveform with pin edges.

        Returns (t, amps, pin) — pin goes high during each inference,
        exactly the I/O-manager capture the tiny methodology specifies.
        """
        rng = np.random.default_rng(seed)
        d = self.device
        t_inf = self.inference_time(macs)
        total = n_inferences * period_s
        t = np.arange(0.0, total, 1.0 / sample_hz)
        watts = np.full(len(t), d.sleep_watts)
        pin = np.zeros(len(t), dtype=np.int8)
        p_active = self.inference_energy(macs, sram_bytes) / max(t_inf, 1e-9)
        for i in range(n_inferences):
            a = i * period_s
            sel = (t >= a) & (t < a + t_inf)
            watts[sel] = p_active
            pin[sel] = 1
        watts = watts * (1 + 0.01 * rng.standard_normal(len(t)))
        amps = watts / d.supply_volts
        return t, amps, pin

    def duty_cycle(self, macs: float, period_s: float) -> float:
        return min(1.0, self.inference_time(macs) / period_s)
