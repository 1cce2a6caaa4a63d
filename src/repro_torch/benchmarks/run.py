"""One function per paper table/figure (PyTorch port of
``benchmarks/run.py``).  Prints ``name,us_per_call,derived`` CSV rows
aggregated from every benchmark module of the port.

  python -m repro_torch.benchmarks.run [--device cuda]           full sweep
  python -m repro_torch.benchmarks.run --smoke [--device cuda]   reduced

Modules whose ``csv`` accepts a ``smoke`` keyword scale themselves
down under ``--smoke``; those whose ``csv`` takes a ``device`` get
``--device`` (default ``cuda``, which raises without a GPU); the
analytic ones run at full size on the CPU either way.  The readers of
the dry-run's cells (Figs. 2, 4-10, the roofline table) read the
records ``python -m repro_torch.launch.dryrun`` and
``python -m repro_torch.launch.hillclimb`` wrote; a module that raises
gives one ERROR row, and any ERROR row exits 1.
"""
from __future__ import annotations

import argparse
import importlib
import inspect
import sys
import time
import traceback

# (row name, module under repro_torch.benchmarks or a module object),
# in the reference's order with the reference's names; each is imported
# when its turn comes, so that an import error is that module's ERROR row
MODULES = [
    ("fig2_power_range", "power_range"),
    ("fig4_efficiency_trends", "efficiency_trends"),
    ("fig5_scaling_energy", "scaling_energy"),
    ("fig6_energy_per_inference", "energy_per_inference"),
    ("fig7_accuracy_cost", "accuracy_cost"),
    ("fig8_quantization", "quantization_efficiency"),
    ("fig9_10_sw_hw", "sw_hw_optimizations"),
    ("roofline_table", "roofline_table"),
    ("measured_tiny_edge", "tiny_edge_measured"),
    ("serving_throughput", "serving_throughput"),
    ("scale_sweep", "scale_sweep"),
    ("speculative_efficiency", "speculative_efficiency"),
    ("power_breakdown", "power_breakdown"),
    ("resilience", "resilience"),
    ("prefix_cache", "prefix_cache"),
    ("slo_sweep", "slo_sweep"),
    ("fleet_sweep", "fleet_sweep"),
]


def _module(mod):
    if isinstance(mod, str):
        return importlib.import_module(f"repro_torch.benchmarks.{mod}")
    return mod


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="reduced sizes for the CI gate")
    ap.add_argument("--device", default="cuda",
                    help="passed to each module whose csv takes it")
    args = ap.parse_args(argv)

    print("name,us_per_call,derived")
    n_rows = 0
    n_error = 0
    timings = []
    for name, mod_name in MODULES:
        t0 = time.perf_counter()
        try:
            mod = _module(mod_name)
            params = inspect.signature(mod.csv).parameters
            kw = {}
            if args.smoke and "smoke" in params:
                kw["smoke"] = True
            if "device" in params:
                kw["device"] = args.device
            rows = list(mod.csv(**kw))
        except Exception as e:  # noqa: BLE001 — report all benches
            # which exception class fired goes into the derived column
            # (CSV stays 3 columns); the traceback goes to stderr
            rows = [f"{name},0.0,ERROR:{type(e).__name__}"]
            traceback.print_exc(file=sys.stderr)
        timings.append((name, time.perf_counter() - t0))
        for row in rows:
            print(row)
            n_rows += 1
            # a module may also *emit* ERROR rows instead of raising;
            # both forms must fail the gate, not just the exceptions
            if row.split(",", 2)[-1].startswith("ERROR"):
                n_error += 1
    # per-module wall time: how the sweep budget is actually spent
    # (comment rows, so CSV parsers skip them)
    for name, dt in timings:
        print(f"# elapsed: {name} {dt:.1f}s")
    total_s = sum(dt for _, dt in timings)
    print(f"# summary: {n_rows} rows, {n_error} ERROR, {total_s:.1f}s")
    if n_error:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
