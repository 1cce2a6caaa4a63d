"""Fig. 2: power consumption range across MLPerf categories (µW -> MW),
port of ``benchmarks/power_range.py``.

The paper's headline span: tiny systems at µW average power
(duty-cycled mW peaks), edge at watts, datacenter inference at kW, and
training pods at hundreds of kW -- the datacenter rows from the
dry-run's records modeled on the H100 system (``common.SYSTEM``).

  PYTHONPATH=src python -m repro_torch.benchmarks.power_range
"""
from __future__ import annotations

from repro_torch.benchmarks.common import cell_energy, csv_row, load_cell
from repro_torch.configs import get_config
from repro_torch.core.power_model import (StepWork, SystemPowerModel,
                                          TinyPowerModel)
from repro_torch.hw import EDGE_SYSTEM
from repro_torch.models import tiny as tiny_mod


def run() -> list[dict]:
    rows = []
    # --- tiny: duty-cycled keyword spotting
    tm = TinyPowerModel()
    cfg = get_config("tiny-kws")
    macs, sram = tiny_mod.macs(cfg), tiny_mod.sram_bytes(cfg)
    period = 1.0                               # 1 inference/s detector
    e = tm.inference_energy(macs, sram)
    avg_w = e / period + tm.device.sleep_watts
    rows.append({"category": "tiny (avg, duty-cycled)", "watts": avg_w,
                 "note": f"{e * 1e3:.3f} mJ/inf @ {period}s period"})
    rows.append({"category": "tiny (active peak)",
                 "watts": e / tm.inference_time(macs), "note": "during inf"})
    # --- edge: single SoC running edge-vit offline
    edge = SystemPowerModel(EDGE_SYSTEM, 1)
    ecfg = get_config("edge-vit")
    n = ecfg.param_count()
    w = StepWork(flops=2.0 * n * 197, hbm_bytes=2.0 * n)   # 1 img batch
    rows.append({"category": "edge (ViT-S inference)",
                 "watts": edge.system_watts(w), "note": "single SoC"})
    # --- datacenter inference (the pod's 256 chips serving)
    rec = load_cell("yi-9b", "decode_32k", "pod")
    if rec:
        ce = cell_energy(rec)
        rows.append({"category": "datacenter inference (256 chips)",
                     "watts": ce["watts"], "note": rec["arch"]})
    # --- datacenter training single pod + multipod
    for mesh, label in (("pod", "training pod (256 chips)"),
                        ("multipod", "training 2 pods (512 chips)")):
        rec = load_cell("deepseek-v3-671b", "train_4k", mesh) or \
            load_cell("yi-9b", "train_4k", mesh)
        if rec:
            ce = cell_energy(rec)
            rows.append({"category": label, "watts": ce["watts"],
                         "note": rec["arch"]})
    # --- extrapolated flagship scale (paper: ~10 MW training est.)
    if rows and rec:
        per_chip = rows[-1]["watts"] / 512
        rows.append({"category": "extrapolated 32k-chip training",
                     "watts": per_chip * 32768, "note": "paper's MW regime"})
    return rows


def csv() -> list[str]:
    return [csv_row(f"fig2_power_range[{r['category']}]", 0.0,
                    f"watts={r['watts']:.6g}") for r in run()]


if __name__ == "__main__":
    for r in run():
        print(f"{r['category']:<38} {r['watts']:>14.6g} W   {r['note']}")
