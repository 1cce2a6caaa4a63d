"""§Roofline: the full baseline table from the dry-run's records (port of
``benchmarks/roofline_table.py``): three terms, dominant bottleneck,
MODEL_FLOPS ratio, per-device GiB, on the H100 (the records' terms are
``launch/roofline.py``'s).

  PYTHONPATH=src python -m repro_torch.benchmarks.roofline_table
"""
from __future__ import annotations

from repro_torch.benchmarks.common import all_cells, csv_row


def run() -> list[dict]:
    rows = []
    for rec in all_cells(""):
        rows.append({
            "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
            "compute_s": rec["compute_s"], "memory_s": rec["memory_s"],
            "collective_s": rec["collective_s"],
            "bottleneck": rec["bottleneck"],
            "mf_ratio": rec["model_flops_ratio"],
            "gib_per_dev": (rec["arg_bytes"] + rec["temp_bytes"]) / 2**30,
            "fits_hbm": rec["fits_hbm"],
        })
    return rows


def csv() -> list[str]:
    return [csv_row(
        f"roofline[{r['arch']}|{r['shape']}|{r['mesh']}]",
        max(r["compute_s"], r["memory_s"], r["collective_s"]) * 1e6,
        f"bneck={r['bottleneck']};mf={r['mf_ratio']:.3f};"
        f"gib={r['gib_per_dev']:.2f};fits={r['fits_hbm']}")
        for r in run()]


if __name__ == "__main__":
    for r in run():
        print(r)
