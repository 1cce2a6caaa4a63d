"""Figs. 9-10: software- vs hardware-isolated efficiency improvements
(PyTorch port of ``benchmarks/sw_hw_optimizations.py``).

(a) Software (Fig. 9/10a): identical "hardware" (the H100 datacenter
    system, same mesh), successive software versions = the port's own
    perf iterations (dry-run tags base -> opt*, written by
    ``python -m repro_torch.launch.hillclimb``); efficiency delta
    distribution.
(b) Hardware (Fig. 10b): constant software stack (the same counted
    workload), successive NVIDIA datacenter generations A100 -> H100 ->
    H200, the port's counterpart of the reference's TPU v4 -> v5e ->
    v5p.  Every generation is modeled from its data sheet
    (``repro_torch.hw``), none measured.
"""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.common import (all_cells, csv_row, load_cell,
                                           work_from_cell)
from repro_torch.configs import SHAPES
from repro_torch.core.efficiency import Submission, software_isolated_deltas
from repro_torch.core.power_model import SystemPowerModel, roofline
from repro_torch.hw import SYSTEMS

HW_GENS = ["datacenter-a100", "datacenter-h100", "datacenter-h200"]
SW_SYSTEM = "datacenter-h100"                  # the software half's system
PERF_TAGS = ["", "opt1", "opt2", "opt3"]       # dry-run variant tags


def _submission(rec, system_key: str, version: str,
                software_id: str) -> Submission:
    system = SYSTEMS[system_key]
    work = work_from_cell(rec)
    model = SystemPowerModel(system, rec["n_devices"])
    rt = roofline(work, system.chip)
    sps = SHAPES[rec["shape"]].global_batch / rt.step_s
    return Submission(
        version=version, workload=f"{rec['arch']}/{rec['shape']}",
        scale="datacenter", system_id=system_key, software_id=software_id,
        samples_per_second=sps,
        avg_watts=model.system_watts(work, rt.step_s))


def _tagged_submissions() -> list[Submission]:
    """Every pod cell of every tag in ``PERF_TAGS``, on ``SW_SYSTEM``."""
    subs = []
    for i, tag in enumerate(PERF_TAGS):
        for rec in all_cells(tag):
            if rec["mesh"] != "pod":
                continue
            subs.append(_submission(rec, SW_SYSTEM, f"v{i}",
                                    software_id=tag or "base"))
    return subs


def run_software() -> list[dict]:
    return software_isolated_deltas(_tagged_submissions())


def run_hardware() -> list[dict]:
    rows = []
    for arch, shape in (("yi-9b", "train_4k"), ("qwen3-1.7b", "prefill_32k")):
        rec = load_cell(arch, shape, "pod")
        if rec is None:
            continue
        effs = {}
        for gen in HW_GENS:
            s = _submission(rec, gen, gen, "fixed-stack")
            effs[gen] = s.samples_per_joule
        base = effs[HW_GENS[0]]
        rows.append({"workload": f"{arch}/{shape}",
                     **{g: effs[g] / base for g in HW_GENS}})
    return rows


def csv() -> list[str]:
    out = []
    sw = run_software()
    if sw:
        deltas = [d["delta_pct"] for d in sw]
        out.append(csv_row(
            "fig9_sw_isolated", 0.0,
            f"n={len(deltas)};median_pct={np.median(deltas):.2f};"
            f"frac_positive={np.mean(np.asarray(deltas) > 0):.2f}"))
    for r in run_hardware():
        out.append(csv_row(
            f"fig10b_hw_isolated[{r['workload']}]", 0.0,
            ";".join(f"{g.split('-')[1]}={r[g]:.3f}" for g in HW_GENS)))
    return out


if __name__ == "__main__":
    print("software-isolated deltas:", run_software())
    print("hardware-isolated (modeled from data sheets):", run_hardware())
