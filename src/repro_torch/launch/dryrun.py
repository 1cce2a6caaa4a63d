"""Multi-pod dry-run: count every (arch x shape x mesh) cell on ``meta``
(PyTorch port of ``launch/dryrun.py``).

For each cell we build the program one device of the production mesh
runs (``launch/specs.py``) from ``meta`` tensors (no allocation), count
it (``launch/opcount.py``: FLOPs, bytes accessed, peak temp bytes), take
the bytes each device holds from the partition specs and the collective
bytes from the plan's records, and write the roofline report
(``launch/roofline.py``, against ``hw.H100_SXM``).  On the pod mesh the
count is cross-checked against the depth calibration
(``launch/calibrate.py``); the two must agree.  Results are cached as
JSON under ``experiments/dryrun_torch/`` at the repository root, so
reruns are incremental; a failing cell leaves its traceback in
``<cell>.json.err`` and the run exits 1.  Runs on the CPU; needs no GPU.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --jobs 8      # all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
      --shape train_4k --mesh multipod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --list
  PYTHONPATH=src python -m repro_torch.launch.dryrun --table
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES, get_config,
                                 shape_applicable)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import CellReport, analyze, render_table
from repro_torch.launch.specs import build_cell, count_cell, zip_leaves

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "experiments", "dryrun_torch")

MESHES = {"pod": dict(multi_pod=False), "multipod": dict(multi_pod=True)}

# relative agreement the depth calibration must reach with the count
CALIBRATION_TOL = 1e-9


def cell_path(arch: str, shape: str, mesh: str, tag: str = "") -> str:
    suffix = f"__{tag}" if tag else ""
    return os.path.join(
        RESULTS_DIR, f"{arch}__{shape}__{mesh}{suffix}.json")


def cells(archs=None, shapes=None, meshes=None) -> list[tuple]:
    """(arch, shape, mesh) of every applicable cell, in the reference's
    order: arch, then shape, then mesh."""
    out = []
    for arch in archs or ASSIGNED_ARCHS:
        cfg = get_config(arch)
        for sname in shapes or list(SHAPES):
            if not shape_applicable(cfg, SHAPES[sname]):
                continue
            for mname in meshes or list(MESHES):
                out.append((arch, sname, mname))
    return out


def _output_bytes(out, args) -> tuple[int, int]:
    """(bytes of the step's output tensors, bytes of those written in
    place over an argument's storage)."""
    held = {t.untyped_storage()._cdata for t, _ in zip_leaves(args, args)}
    total = alias = 0
    for t, _ in zip_leaves(out, out):
        n = t.numel() * t.element_size()
        total += n
        alias += n if t.untyped_storage()._cdata in held else 0
    return total, alias


def run_cell(arch: str, shape_name: str, mesh_name: str, *,
             tag: str = "", overrides: dict | None = None,
             hp_overrides: dict | None = None,
             verbose: bool = True, calibrate: bool = True) -> dict:
    """Count one cell on ``meta``; returns its record (the
    ``CellReport`` fields, the raw count, the calibration where asked,
    timings, ``ok``).  Raises if the calibration disagrees with the
    count by more than ``CALIBRATION_TOL``."""
    from repro_torch.launch.calibrate import calibrated_costs
    from repro_torch.launch.roofline import apply_calibration
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.train_step import TrainHParams

    cfg = get_config(arch, **(overrides or {}))
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(**MESHES[mesh_name])
    hp = None
    if hp_overrides:
        hp = TrainHParams(adamw=AdamWConfig(**hp_overrides))
    t0 = time.monotonic()
    cell = build_cell(cfg, shape, mesh, hp=hp)
    t_build = time.monotonic() - t0
    counts, out = count_cell(cell)
    t_count = time.monotonic() - t0 - t_build
    if verbose:
        print(f"  count: flops={counts.flops:.4g} bytes={counts.bytes:.4g} "
              f"peak={counts.peak_bytes:.4g} (args {counts.arg_bytes:.4g})",
              flush=True)
    report = analyze(cell, counts, mesh_name=mesh_name,
                     **dict(zip(("out_bytes", "alias_bytes"),
                                _output_bytes(out, cell.args))))
    del out
    raw = {"raw_flops": report.flops, "raw_hbm_bytes": report.hbm_bytes,
           "raw_coll_bytes": report.coll_bytes}
    rec_extra = {}
    if calibrate:
        cal = calibrated_costs(cfg, shape, mesh, hp=hp, verbose=verbose)
        for key, got in (("flops", cal.flops), ("hbm_bytes", cal.hbm_bytes),
                         ("coll_bytes", cal.coll_bytes)):
            want = raw[f"raw_{key}"]
            if abs(got - want) > CALIBRATION_TOL * max(abs(want), 1.0):
                raise AssertionError(
                    f"{arch} {shape_name} {mesh_name}: calibrated {key} "
                    f"{got!r} != counted {want!r}")
        report = apply_calibration(report, cal)
        rec_extra["calibration"] = cal.to_json()
    rec = report.to_json()
    rec.update(raw)
    rec.update(rec_extra)
    rec.update({"tag": tag, "build_s": round(t_build, 2),
                "count_s": round(t_count, 2),
                "total_s": round(time.monotonic() - t0, 2), "ok": True})
    return rec


# a cell's rough cost, for handing the longest to workers first
_COST = {"train_4k": 4, "prefill_32k": 2, "decode_32k": 1, "long_500k": 1}
_HEAVY = ("jamba-v0.1-52b", "deepseek-v3-671b", "qwen3-moe-30b-a3b")


def _run_one(arch, shape, mesh, tag, calibrate):
    try:
        return run_cell(arch, shape, mesh, tag=tag, verbose=False,
                        calibrate=calibrate), None
    except Exception:  # noqa: BLE001 — the parent records it
        return None, traceback.format_exc()


def worker_pool(jobs: int):
    """A pool of ``jobs`` spawned worker processes (spawned: the caller
    may hold a CUDA context); use it as a context manager."""
    import concurrent.futures
    import multiprocessing
    return concurrent.futures.ProcessPoolExecutor(
        jobs, mp_context=multiprocessing.get_context("spawn"))


def submit_cells(pool, cell_list, *, tag: str = "",
                 calibrate=lambda mesh: mesh == "pod") -> dict:
    """{cell: future of ``_run_one``} for ``cell_list`` on ``pool``, the
    costliest cells first; each future gives (record, None) or (None,
    traceback)."""
    order = sorted(cell_list, key=lambda c: -(_COST[c[1]]
                                              * (3 if c[0] in _HEAVY else 1)))
    return {c: pool.submit(_run_one, *c, tag, calibrate(c[2]))
            for c in order}


def count_cells(cell_list, *, jobs: int = 1, tag: str = "",
                calibrate=lambda mesh: mesh == "pod") -> dict:
    """{(arch, shape, mesh): (record, None) or (None, traceback)} of
    ``run_cell`` over ``cell_list``, in ``jobs`` worker processes.
    ``calibrate(mesh name)`` says which cells to cross-check."""
    if jobs <= 1:
        return {c: _run_one(*c, tag, calibrate(c[2])) for c in cell_list}
    with worker_pool(jobs) as pool:
        futs = submit_cells(pool, cell_list, tag=tag, calibrate=calibrate)
        return {c: futs[c].result() for c in cell_list}


def load_reports(cell_list, tag: str = "") -> list[CellReport]:
    """The cached reports of ``cell_list`` that exist."""
    fields = {f.name for f in dataclasses.fields(CellReport)}
    reports = []
    for arch, sname, mname in cell_list:
        p = cell_path(arch, sname, mname, tag)
        if os.path.exists(p):
            with open(p) as f:
                d = json.load(f)
            reports.append(CellReport.from_json(
                {k: v for k, v in d.items() if k in fields}))
    return reports


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="*", default=None)
    ap.add_argument("--shape", nargs="*", default=None)
    ap.add_argument("--mesh", nargs="*", default=None)
    ap.add_argument("--tag", default="", help="variant tag (perf iters)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--table", action="store_true",
                    help="render the roofline table from cached results")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells counted at once, one process each")
    args = ap.parse_args(argv)

    todo = cells(args.arch, args.shape, args.mesh)
    if args.list:
        for c in todo:
            print(*c)
        print(f"total {len(todo)} cells")
        return
    if args.table:
        print(render_table(load_reports(todo, args.tag)))
        return

    os.makedirs(RESULTS_DIR, exist_ok=True)
    failures = []
    run = []
    for i, (arch, sname, mname) in enumerate(todo):
        if os.path.exists(cell_path(arch, sname, mname, args.tag)) \
                and not args.force:
            print(f"[{i + 1}/{len(todo)}] cached {arch} {sname} {mname}")
        else:
            run.append((arch, sname, mname))
    # the roofline table is single-pod: multipod cells need the count
    # and the memory, not the calibration's cross-check
    done = count_cells(run, jobs=args.jobs, tag=args.tag)
    for arch, sname, mname in run:
        rec, err = done[(arch, sname, mname)]
        p = cell_path(arch, sname, mname, args.tag)
        print(f"{arch} {sname} {mname}", flush=True)
        if rec is None:
            failures.append((arch, sname, mname, err.strip().splitlines()[-1]))
            with open(p + ".err", "w") as f:
                f.write(err)
            print(f"  FAIL {failures[-1][-1]}", flush=True)
            continue
        with open(p, "w") as f:
            json.dump(rec, f, indent=1)
        if os.path.exists(p + ".err"):
            os.remove(p + ".err")
        print(f"  OK build={rec['build_s']}s count={rec['count_s']}s "
              f"bottleneck={rec['bottleneck']} "
              f"live={(rec['arg_bytes'] + rec['temp_bytes']) / 2**30:.2f}"
              f" GiB/dev fits={rec['fits_hbm']}", flush=True)
    if failures:
        print(f"\n{len(failures)} failures:")
        for f_ in failures:
            print("  ", *f_)
        raise SystemExit(1)
    print("\nAll dry-run cells counted successfully.")


if __name__ == "__main__":
    main()
