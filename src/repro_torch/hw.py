"""Hardware models: chip specs and energy coefficients (PyTorch port).

The non-TPU part of the reference ``src/repro/hw.py``: ``ChipSpec``,
the edge SoC and its ``SystemSpec``, and the MLPerf-Tiny MCU.  All
power/energy figures are the reference's documented engineering
estimates.  They feed the analytical power model in
``repro_torch.core``.  The reference's TPU chips and datacenter
systems stay behind; an H100 spec with a measured power source is
ROADMAP §A.4.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """A single accelerator chip (the roofline + energy model of it)."""

    name: str
    peak_flops_bf16: float      # FLOP/s
    peak_flops_int8: float      # OP/s
    hbm_bandwidth: float        # B/s
    hbm_capacity: float         # bytes
    ici_bandwidth: float        # B/s per link
    ici_links: int              # links per chip (torus degree)
    idle_watts: float           # static power, chip powered but idle
    peak_watts: float           # chip power at full utilization
    # Dynamic energy coefficients (derived; see DESIGN.md).
    e_flop_bf16: float          # J per bf16 FLOP at the compute units
    e_flop_int8: float          # J per int8 OP
    e_hbm_byte: float           # J per HBM byte moved
    e_ici_byte: float           # J per ICI byte moved

    def roofline_times(self, flops: float, hbm_bytes: float,
                       ici_bytes: float) -> tuple[float, float, float]:
        """Per-chip (compute_s, memory_s, collective_s) roofline terms."""
        return (
            flops / self.peak_flops_bf16,
            hbm_bytes / self.hbm_bandwidth,
            ici_bytes / self.ici_bandwidth,
        )


# Edge-class SoC (tens of watts): think Orin/edge-TPU class device.
EDGE_SOC = ChipSpec(
    name="edge-soc",
    peak_flops_bf16=8e12,
    peak_flops_int8=32e12,
    hbm_bandwidth=100e9,
    hbm_capacity=8 * 2**30,
    ici_bandwidth=0.0,
    ici_links=0,
    idle_watts=3.0,
    peak_watts=15.0,
    e_flop_bf16=1.2e-12,
    e_flop_int8=0.3e-12,
    e_hbm_byte=60e-12,
    e_ici_byte=0.0,
)


@dataclasses.dataclass(frozen=True)
class TinyDeviceSpec:
    """Microcontroller-class device for the MLPerf-Tiny scale.

    Modeled at the MAC level (there is no HBM / ICI at this scale);
    energy = macs * e_mac + bytes * e_sram + static * duration, with a
    duty cycle: the device sleeps between inference frames.
    """

    name: str = "tiny-mcu"
    clock_hz: float = 120e6
    macs_per_cycle: float = 1.0           # single-issue MCU w/ DSP MAC
    e_mac: float = 5e-12                  # J per MAC (int8, incl. fetch)
    e_sram_byte: float = 0.5e-12          # J per SRAM byte
    active_watts_floor: float = 3e-3      # core active power floor
    sleep_watts: float = 50e-6            # deep-sleep (µW regime)
    supply_volts: float = 3.0

    def inference_time(self, macs: float) -> float:
        return macs / (self.clock_hz * self.macs_per_cycle)

    def inference_energy(self, macs: float, sram_bytes: float) -> float:
        t = self.inference_time(macs)
        return macs * self.e_mac + sram_bytes * self.e_sram_byte + \
            self.active_watts_floor * t


TINY_MCU = TinyDeviceSpec()


@dataclasses.dataclass(frozen=True)
class SystemSpec:
    """Full-system composition: chips + host + switch overheads.

    MLPerf Power's Myth #1: component isolation is not full-system power.
    The host/switch terms implement the "full system power" scope of
    Fig. 3 of the paper.
    """

    chip: ChipSpec
    chips_per_host: int = 8
    host_idle_watts: float = 350.0        # CPU, DRAM, fans, NIC per host
    host_active_watts: float = 500.0      # host under data-loading load
    switch_watts: float = 500.0           # per ICI/DC switch
    chips_per_switch: int = 64
    psu_efficiency: float = 0.94          # AC->DC conversion loss

    def n_hosts(self, n_chips: int) -> int:
        return max(1, -(-n_chips // self.chips_per_host))

    def n_switches(self, n_chips: int) -> int:
        if n_chips <= self.chips_per_switch:
            return 0 if n_chips <= 8 else 1
        return -(-n_chips // self.chips_per_switch)

    def idle_system_watts(self, n_chips: int) -> float:
        w = (n_chips * self.chip.idle_watts
             + self.n_hosts(n_chips) * self.host_idle_watts
             + self.n_switches(n_chips) * self.switch_watts)
        return w / self.psu_efficiency


EDGE_SYSTEM = SystemSpec(chip=EDGE_SOC, chips_per_host=1,
                         host_idle_watts=5.0, host_active_watts=8.0,
                         switch_watts=0.0, psu_efficiency=0.90)

CHIPS = {c.name: c for c in (EDGE_SOC,)}
SYSTEMS = {"edge": EDGE_SYSTEM}
