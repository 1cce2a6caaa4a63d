"""Fig. 5: time-to-train and energy-to-train vs accelerator count
(port of ``benchmarks/scaling_energy.py``).

The paper's core scaling result: with more chips, absolute
time-to-train falls with diminishing returns (collective share grows,
per-chip utilization falls) while energy-to-train RISES (more
accelerator-hours + interconnect/switch energy).

Data points come from scaling dry-runs (``experiments/scaling_torch/
*.json`` at the repository root, written by ``--compile``): the same
pipeline as the production dry-run (``launch/specs.py``'s per-device
program counted on ``meta``, ``launch/roofline.py``'s report, the depth
calibration of ``launch/calibrate.py``) at data-parallel widths of
64, 256 and 512 chips, modeled on the H100 system (``common.SYSTEM``).

  PYTHONPATH=src python -m repro_torch.benchmarks.scaling_energy --compile
"""
from __future__ import annotations

import json
import os

from repro_torch.benchmarks import common
from repro_torch.benchmarks.common import csv_row, work_from_cell
from repro_torch.core.power_model import SystemPowerModel, roofline

SCALE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                         "experiments", "scaling_torch")
ARCH = "qwen3-1.7b"
TOKEN_BUDGET = 50e9                     # tokens to "train" the model
MESHES = [(4, 16), (16, 16), (32, 16)]  # 64/256/512 chips


def compile_points():
    """Count the scaling cells (on ``meta``: no device needed)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.calibrate import calibrated_costs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.roofline import analyze, apply_calibration
    from repro_torch.launch.specs import build_cell, count_cell

    os.makedirs(SCALE_DIR, exist_ok=True)
    cfg = get_config(ARCH)
    shape = SHAPES["train_4k"]
    for dp, tp in MESHES:
        n = dp * tp
        path = os.path.join(SCALE_DIR, f"{ARCH}__{n}.json")
        if os.path.exists(path):
            print(f"cached {n}")
            continue
        axes = (("data", "model") if n <= 256 else ("pod", "data", "model"))
        shp = (dp, tp) if n <= 256 else (2, dp // 2, tp)
        mesh = make_mesh(shp, axes)
        cell = build_cell(cfg, shape, mesh)
        counts, _ = count_cell(cell)
        rep = analyze(cell, counts, mesh_name=f"{n}chips")
        rep = apply_calibration(rep, calibrated_costs(cfg, shape, mesh))
        with open(path, "w") as f:
            json.dump(rep.to_json(), f, indent=1)
        print(f"counted {n} chips: bottleneck={rep.bottleneck}")


def run() -> list[dict]:
    from repro_torch.configs import SHAPES

    system = common.SYSTEM
    shape = SHAPES["train_4k"]
    tokens_per_step = shape.global_batch * shape.seq_len
    steps = TOKEN_BUDGET / tokens_per_step
    rows = []
    if not os.path.isdir(SCALE_DIR):
        return rows
    for fn in sorted(os.listdir(SCALE_DIR),
                     key=lambda x: int(x.split("__")[1].split(".")[0])):
        with open(os.path.join(SCALE_DIR, fn)) as f:
            rec = json.load(f)
        n = rec["n_devices"]
        model = SystemPowerModel(system, n)
        work = work_from_cell(rec)
        rt = roofline(work, system.chip)
        step_s = rt.step_s
        watts = model.system_watts(work, step_s)
        rows.append({
            "n_chips": n,
            "step_s": step_s,
            "time_to_train_h": steps * step_s / 3600.0,
            "energy_to_train_kwh": steps * watts * step_s / 3.6e6,
            "avg_watts": watts,
            "collective_share": rt.collective_s / max(step_s, 1e-12),
            "chip_hours": n * steps * step_s / 3600.0,
            "bottleneck": rt.bottleneck,
        })
    return rows


def csv() -> list[str]:
    return [csv_row(
        f"fig5_scaling[{r['n_chips']}chips]", r["step_s"] * 1e6,
        f"ttt_h={r['time_to_train_h']:.4g};"
        f"energy_kwh={r['energy_to_train_kwh']:.5g};"
        f"coll_share={r['collective_share']:.3f}") for r in run()]


if __name__ == "__main__":
    import sys
    if "--compile" in sys.argv:
        compile_points()
    for r in run():
        print(r)
