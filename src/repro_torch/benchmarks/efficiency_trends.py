"""Figs. 1 & 4: performance and normalized-efficiency trends across
benchmark versions (PyTorch port of ``benchmarks/efficiency_trends.py``)
-- versions here are the port's own optimization history (baseline ->
the hillclimb's iterations, ``launch.hillclimb``), per hillclimbed
workload, modeled on the H100 datacenter system."""
from __future__ import annotations

from repro_torch.benchmarks.common import csv_row
from repro_torch.benchmarks.sw_hw_optimizations import _tagged_submissions
from repro_torch.core.efficiency import normalized_trend


def run() -> dict[str, list]:
    # keep only workloads with >1 version (the hillclimbed cells)
    trend = normalized_trend(_tagged_submissions())
    return {wl: pts for wl, pts in trend.items() if len(pts) > 1}


def csv() -> list[str]:
    out = []
    for wl, pts in run().items():
        series = ";".join(f"{v}={x:.3f}" for v, x in pts)
        out.append(csv_row(f"fig4_trend[{wl}]", 0.0, series))
    return out


if __name__ == "__main__":
    for wl, pts in run().items():
        print(wl, pts)
