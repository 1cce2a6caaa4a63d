"""Shared helpers of the port's benchmarks (from the reference's
``benchmarks/common.py``): loading the dry-run's cell records and
turning them into energy.

The paper-figure benchmarks read the records the port's dry-run writes
(``python -m repro_torch.launch.dryrun``: ``experiments/dryrun_torch/
*.json`` at the repository root) and model each cell's step on
``SYSTEM``, the H100 datacenter system (``hw.DATACENTER_H100``), unless
a caller passes another.  A cell without a record is left out of a
benchmark's rows, as in the reference.
"""
from __future__ import annotations

import glob
import json
import os

from repro_torch.core.power_model import StepWork, SystemPowerModel, roofline
from repro_torch.hw import DATACENTER_H100, SystemSpec

DRYRUN_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "experiments", "dryrun_torch")

# the system every reader models a cell's step on
SYSTEM: SystemSpec = DATACENTER_H100


def load_cell(arch: str, shape: str, mesh: str = "pod",
              tag: str = "") -> dict | None:
    suffix = f"__{tag}" if tag else ""
    p = os.path.join(DRYRUN_DIR, f"{arch}__{shape}__{mesh}{suffix}.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def all_cells(tag: str = "") -> list[dict]:
    out = []
    for p in sorted(glob.glob(os.path.join(DRYRUN_DIR, "*.json"))):
        name = os.path.basename(p)[:-5]
        parts = name.split("__")
        want_tag = parts[3] if len(parts) > 3 else ""
        if want_tag != tag:
            continue
        with open(p) as f:
            out.append(json.load(f))
    return out


def work_from_cell(rec: dict, int8: bool = False) -> StepWork:
    """Per-chip StepWork from a dry-run record.  ``int8``: model the
    quantized deployment (half the matmul bytes, int8 tensor-core
    path)."""
    flops = rec["flops"]
    hbm = rec["hbm_bytes"]
    if int8:
        return StepWork(flops=flops, hbm_bytes=hbm / 2,
                        ici_bytes=rec["coll_bytes"] / 2, flops_int8=flops)
    return StepWork(flops=flops, hbm_bytes=hbm,
                    ici_bytes=rec["coll_bytes"])


def cell_energy(rec: dict, system: SystemSpec | None = None,
                int8: bool = False) -> dict:
    """Seconds + Joules for one executed step of a dry-run cell on
    ``system`` (default ``SYSTEM``)."""
    system = system or SYSTEM
    n = rec["n_devices"]
    model = SystemPowerModel(system, n)
    work = work_from_cell(rec, int8)
    rt = roofline(work, system.chip)
    step_s = rt.step_s
    watts = model.system_watts(work, step_s)
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "n_chips": n, "step_s": step_s, "watts": watts,
        "energy_j": watts * step_s, "bottleneck": rt.bottleneck,
        "compute_s": rt.compute_s, "memory_s": rt.memory_s,
        "collective_s": rt.collective_s,
    }


def samples_per_step(rec: dict) -> float:
    """One 'sample' = one sequence (train/prefill) or one token (decode)."""
    from repro_torch.configs import SHAPES

    return float(SHAPES[rec["shape"]].global_batch)


def csv_row(name: str, us_per_call: float, derived: str) -> str:
    return f"{name},{us_per_call:.3f},{derived}"


def interleaved_best_of(run_fns: dict, n_reps: int = 4) -> dict:
    """Best-of-``n_reps`` PowerRun per point, repetitions interleaved
    round-robin across the points.

    Sub-second measured runs are scheduler-noise-dominated on shared
    boxes, and the noise is *temporally correlated* (slow phases last
    seconds).  Interleaving lets every point sample the same machine
    conditions, so best-rep *ratios* between points are honest; the
    fastest repetition per point is the least-perturbed one
    (hyperfine-min style).  The CI perf gate and the k-sweep speedups
    compare these numbers.

    ``run_fns``: {point_name: zero-arg closure returning a
    ``SubmissionResult``}; returns {point_name: best result}.
    """
    best: dict = {}
    for _ in range(n_reps):
        for name, run_once in run_fns.items():
            r = run_once()
            if name not in best or (r.outcome.server.tokens_per_s
                                    > best[name].outcome.server
                                    .tokens_per_s):
                best[name] = r
    return best
