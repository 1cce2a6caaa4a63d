"""Hardware models: chip specs and energy coefficients (PyTorch port).

The non-TPU part of the reference ``src/repro/hw.py`` (``ChipSpec``,
the edge SoC and its ``SystemSpec``, the MLPerf-Tiny MCU) and the
port's own target, the NVIDIA H100 SXM and its datacenter
``SystemSpec``, with the A100 and H200 around it: the port's
counterpart of the reference's TPU generations (v4, v5e, v5p) in Fig.
10b.  The edge and MCU power/energy figures are the reference's
documented engineering estimates; the NVIDIA parts' peaks are NVIDIA's
data sheets, their idle draw and energy coefficients are estimates (see
``H100_SXM``).  They feed the analytical power model in
``repro_torch.core``.  On the H100 the accelerator rail is measured
instead (``repro_torch.power.nvml``), and the spec's constants model
only what is not measured (the host rail, the PSU) and the roofline.
The reference's TPU chips and systems stay behind.
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


# NVIDIA H100 SXM5 80 GB, the port's target.  Peaks are the data sheet's
# dense rates (989 TFLOP/s bf16, 1,979 TOP/s int8, 3.35 TB/s HBM3,
# 80 GB, NVLink 4: 18 links of 50 GB/s = 900 GB/s, 700 W board power).
# Idle draw and energy coefficients are estimates, in the reference's
# manner:
#   idle    ~ 75 W board power, powered and idle (chip_smoke.py phase 15
#             prints the card's measured idle draw beside it)
#   e_flop  = (peak_watts - idle_watts) / peak_flops  ~ 0.63 pJ/FLOP
#   e_int8  = half of e_flop
#   e_hbm   ~ 3.9 pJ/bit HBM3                          ~ 31  pJ/B
#   e_ici   ~ 5 pJ/bit NVLink SerDes                    ~ 40  pJ/B
H100_SXM = ChipSpec(
    name="h100-sxm",
    peak_flops_bf16=989e12,
    peak_flops_int8=1979e12,
    hbm_bandwidth=3.35e12,
    hbm_capacity=80e9,
    ici_bandwidth=50e9,
    ici_links=18,
    idle_watts=75.0,
    peak_watts=700.0,
    e_flop_bf16=0.63e-12,
    e_flop_int8=0.32e-12,
    e_hbm_byte=31e-12,
    e_ici_byte=40e-12,
)


# NVIDIA A100 SXM4 80 GB, the generation before the H100 (Fig. 10b's
# hardware-isolated comparison).  Data sheet: 312 TFLOP/s bf16 dense,
# 624 TOP/s int8, 2.039 TB/s HBM2e, 80 GB, NVLink 3: 12 links of 50 GB/s
# = 600 GB/s, 400 W board power.  Estimates, in H100_SXM's manner:
#   idle    ~ 50 W board power, powered and idle (estimate)
#   e_flop  = (peak_watts - idle_watts) / peak_flops  ~ 1.12 pJ/FLOP
#   e_int8  = half of e_flop
#   e_hbm   ~ 4.5 pJ/bit HBM2e                         ~ 36  pJ/B
#   e_ici   ~ 5 pJ/bit NVLink SerDes                    ~ 40  pJ/B
A100_SXM = ChipSpec(
    name="a100-sxm",
    peak_flops_bf16=312e12,
    peak_flops_int8=624e12,
    hbm_bandwidth=2.039e12,
    hbm_capacity=80e9,
    ici_bandwidth=50e9,
    ici_links=12,
    idle_watts=50.0,
    peak_watts=400.0,
    e_flop_bf16=1.12e-12,
    e_flop_int8=0.56e-12,
    e_hbm_byte=36e-12,
    e_ici_byte=40e-12,
)


# NVIDIA H200 SXM 141 GB, the H100's die with HBM3e (Fig. 10b).  Data
# sheet: 989 TFLOP/s bf16 dense, 1,979 TOP/s int8, 4.8 TB/s HBM3e,
# 141 GB, NVLink 4: 18 links of 50 GB/s, 700 W board power.  Estimates,
# in H100_SXM's manner:
#   idle    ~ 75 W board power, powered and idle (estimate; the H100's)
#   e_flop  = (peak_watts - idle_watts) / peak_flops  ~ 0.63 pJ/FLOP
#   e_int8  = half of e_flop
#   e_hbm   ~ 3.5 pJ/bit HBM3e                         ~ 28  pJ/B
#   e_ici   ~ 5 pJ/bit NVLink SerDes                    ~ 40  pJ/B
H200_SXM = ChipSpec(
    name="h200-sxm",
    peak_flops_bf16=989e12,
    peak_flops_int8=1979e12,
    hbm_bandwidth=4.8e12,
    hbm_capacity=141e9,
    ici_bandwidth=50e9,
    ici_links=18,
    idle_watts=75.0,
    peak_watts=700.0,
    e_flop_bf16=0.63e-12,
    e_flop_int8=0.32e-12,
    e_hbm_byte=28e-12,
    e_ici_byte=40e-12,
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

# Eight H100s a host; host, switch and PSU figures are the reference's
# datacenter defaults (estimates), which model the host rail and the
# wall of a measured H100 run.
DATACENTER_H100 = SystemSpec(chip=H100_SXM)
# the NVIDIA generations around it (Fig. 10b), eight cards a host as in
# NVIDIA's HGX boards; modeled from data sheets only
DATACENTER_A100 = SystemSpec(chip=A100_SXM)
DATACENTER_H200 = SystemSpec(chip=H200_SXM)

CHIPS = {c.name: c for c in (H100_SXM, A100_SXM, H200_SXM, EDGE_SOC)}
SYSTEMS = {"datacenter-h100": DATACENTER_H100,
           "datacenter-a100": DATACENTER_A100,
           "datacenter-h200": DATACENTER_H200, "edge": EDGE_SYSTEM}
