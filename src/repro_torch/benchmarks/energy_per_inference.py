"""Fig. 6: energy per inference across workloads (mJ -> hundreds of J),
port of ``benchmarks/energy_per_inference.py``.

Per assigned architecture: J/sample for the offline prefill cell and
J/token for decode, from the dry-run's records modeled on the H100
system (``common.SYSTEM``), plus the tiny workload on the modeled MCU
-- the paper's 5-orders-of-magnitude span between tiny CV and
datacenter LLMs.

  PYTHONPATH=src python -m repro_torch.benchmarks.energy_per_inference
"""
from __future__ import annotations

from repro_torch.benchmarks.common import (cell_energy, csv_row, load_cell,
                                           samples_per_step)
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.core.power_model import TinyPowerModel
from repro_torch.models import tiny as tiny_mod


def run() -> list[dict]:
    rows = []
    tm = TinyPowerModel()
    cfg = get_config("tiny-kws")
    e = tm.inference_energy(tiny_mod.macs(cfg), tiny_mod.sram_bytes(cfg))
    rows.append({"workload": "tiny-kws", "kind": "tiny-inference",
                 "j_per_sample": e, "n_chips": 1})
    for arch in ASSIGNED_ARCHS:
        rec = load_cell(arch, "prefill_32k", "pod")
        if rec:
            ce = cell_energy(rec)
            rows.append({"workload": arch, "kind": "prefill(32k)/sample",
                         "j_per_sample": ce["energy_j"]
                         / samples_per_step(rec),
                         "n_chips": ce["n_chips"]})
        rec = load_cell(arch, "decode_32k", "pod") or \
            load_cell(arch, "long_500k", "pod")
        if rec:
            ce = cell_energy(rec)
            rows.append({"workload": arch, "kind": "decode/token",
                         "j_per_sample": ce["energy_j"]
                         / samples_per_step(rec),
                         "n_chips": ce["n_chips"]})
    return rows


def csv() -> list[str]:
    return [csv_row(f"fig6_energy_per_inf[{r['workload']}|{r['kind']}]",
                    0.0, f"j_per_sample={r['j_per_sample']:.6g}")
            for r in run()]


if __name__ == "__main__":
    for r in run():
        print(f"{r['workload']:<20} {r['kind']:<22} "
              f"{r['j_per_sample']:>12.6g} J")
