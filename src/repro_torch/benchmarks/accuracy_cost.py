"""Fig. 7: distribution of the efficiency drop when raising the
accuracy target 99% -> 99.9% (old fp16 deployments vs new fp8 ones),
port of ``benchmarks/accuracy_cost.py``, from the dry-run's prefill
records modeled on the H100 system (``common.SYSTEM``).

  PYTHONPATH=src python -m repro_torch.benchmarks.accuracy_cost
"""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.common import csv_row, load_cell
from repro_torch.benchmarks.quantization_efficiency import (TARGET_999_NEW,
                                                            TARGET_999_OLD,
                                                            _eff)
from repro_torch.configs import ASSIGNED_ARCHS


def run() -> list[dict]:
    rows = []
    for arch in ASSIGNED_ARCHS:
        rec = load_cell(arch, "prefill_32k", "pod")
        if rec is None:
            continue
        base = _eff(rec, "int8")
        for label, prec in (("fp16(old)", TARGET_999_OLD),
                            ("fp8(new)", TARGET_999_NEW)):
            rows.append({
                "arch": arch, "deployment": label,
                "delta_pct": 100.0 * (_eff(rec, prec) / base - 1.0),
            })
    return rows


def summary() -> dict:
    rows = run()
    old = [r["delta_pct"] for r in rows if r["deployment"] == "fp16(old)"]
    new = [r["delta_pct"] for r in rows if r["deployment"] == "fp8(new)"]
    out = {}
    if old:
        out["mean_drop_fp16_pct"] = float(np.mean(old))
    if new:
        out["mean_drop_fp8_pct"] = float(np.mean(new))
    return out


def csv() -> list[str]:
    out = [csv_row(f"fig7_acc_cost[{r['arch']}|{r['deployment']}]", 0.0,
                   f"delta_pct={r['delta_pct']:.2f}") for r in run()]
    s = summary()
    if s:
        out.append(csv_row("fig7_acc_cost[mean]", 0.0,
                           ";".join(f"{k}={v:.2f}" for k, v in s.items())))
    return out


if __name__ == "__main__":
    for r in run():
        print(r)
    print(summary())
