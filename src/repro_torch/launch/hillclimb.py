"""Perf hillclimbing: hypothesis -> change -> re-count -> record
(PyTorch port of ``launch/hillclimb.py``).

Five cells, with the reference's archs, shapes, tags, overrides and
hypotheses:
  A  deepseek-v3-671b / train_4k  -- worst roofline fraction and most
     collective-bound (the paper's Fig. 5 energy-at-scale pathology).
  B  yi-9b / prefill_32k          -- the paper's largest result category
     (datacenter inference); memory-bound.
  C  qwen3-moe-30b-a3b / train_4k -- EP-dispatch-heavy modern MoE (the
     generative-AI workload class of Figs. 4 and 6).
  J, X                            -- two recorded fixes (jamba's remat
     granularity, deepseek's prefill weights).

Each iteration is one config-knob change counted on ``meta`` by
``launch.dryrun.run_cell`` (with the depth calibration unless the
iteration says otherwise); records land beside the dry-run's cells in
``experiments/dryrun_torch/`` with the iteration's tag, and ``main``
prints the before/after table.  The roofline terms are the H100 SXM's
(``hw.H100_SXM``).

Where the port's program differs from the reference's, the hypothesis
says what the port's count will show: the port counts a prefill's
attention by the hand-written flash kernel's work formula
(``kernels/work.py``: visible pairs only, no score tensor in HBM), so
the attention knobs change only the train cells, whose attention runs
the plain version under autograd.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb [--cell A B C X]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

from repro_torch.configs import get_config

PORT_PREFILL = (" The port counts prefill attention by the flash kernel's "
                "work formula (visible pairs, no score tensor), so its "
                "count stays the base's.")

CELLS = {
    "A": {
        "arch": "deepseek-v3-671b", "shape": "train_4k",
        "iters": [
            ("opt1",
             "H1: optimizer m/v dominate per-chip argument bytes "
             "(27 GiB); int8-m + bf16-sqrt-v cuts opt state 8B->3B/param "
             "=> args ~-40%; layer internals untouched (opt update is "
             "outside the scan, so the uncalibrated compile measures it "
             "exactly)",
             dict(hp=dict(quant_moments=True), calibrate=False)),
            ("opt2",
             "H2: remat=nothing re-gathers every FSDP shard and redoes "
             "every SP reshard in the bwd pass; saving dot outputs "
             "(dots policy) should cut all-gather bytes ~1/3 for more "
             "temp memory. The port's plan keeps the all-gathers and "
             "drops the recomputed forward's activation all-reduces "
             "(launch/specs.py:collective_records), and its count drops "
             "the recomputed 2-D products.",
             dict(hp=dict(quant_moments=True),
                  cfg=dict(remat_policy="dots"))),
        ],
        # (a capacity_factor iteration is quantified on cell C opt3;
        # the same knob applies here and compounds)
    },
    "B": {
        "arch": "yi-9b", "shape": "prefill_32k",
        "iters": [
            ("opt1",
             "H1: memory term is dominated by full-S^2 f32 score traffic "
             "(~9.3e12 B/dev vs 3.3e9 floor); causal block-skipping "
             "halves score elements (and attention flops) => memory "
             "~-35%, compute ~-25%." + PORT_PREFILL,
             dict(cfg=dict(causal_skip=True))),
            ("opt2",
             "H2: the remaining score traffic is f32; bf16 score/prob "
             "tensors (f32 row stats) halve the bytes again => memory "
             "~-25% further." + PORT_PREFILL,
             dict(cfg=dict(causal_skip=True, attn_bf16_scores=True))),
            ("opt3",
             "H3: q-chunk 1024->4096 re-reads KV 4x less; but KV re-reads "
             "are <2% of score bytes, so predict <5% (expected REFUTE, "
             "recorded per methodology)." + PORT_PREFILL,
             dict(cfg=dict(causal_skip=True, attn_bf16_scores=True,
                           attn_chunk=4096))),
        ],
    },
    "C": {
        "arch": "qwen3-moe-30b-a3b", "shape": "train_4k",
        "iters": [
            ("opt1",
             "H1: scores at 4k seq are the largest memory stream here "
             "too; causal skip => memory -30%. The port's train "
             "attention visits 10 of 16 (q chunk, KV chunk) blocks at "
             "S 4,096 and chunk 1,024.",
             dict(cfg=dict(causal_skip=True))),
            ("opt2",
             "H2: + bf16 scores => memory -20% further; collective "
             "unchanged",
             dict(cfg=dict(causal_skip=True, attn_bf16_scores=True))),
            ("opt3",
             "H3: all-to-all is 2.7e11 B/dev at capacity 1.25; capacity "
             "1.0 cuts dispatch+expert-GEMM padding 20% => collective "
             "-15%, compute -5%",
             dict(cfg=dict(causal_skip=True, attn_bf16_scores=True),
                  capacity=1.0)),
        ],
    },
    # extra recorded fix: jamba's remat checkpoints the whole 8-layer
    # superblock, keeping 7 Mamba layers' f32 scan tensors live at once;
    # per-sublayer checkpointing frees them.  Only the memory analysis
    # is meaningful here (roofline terms unchanged by remat granularity
    # at equal policy).
    "J": {
        "arch": "jamba-v0.1-52b", "shape": "train_4k",
        "iters": [
            ("opt1",
             "FIX: superblock-granularity remat holds every sublayer's "
             "f32 SSM tensors simultaneously; per-sublayer checkpoints "
             "should cut temp memory several-fold",
             dict(cfg=dict(sublayer_remat=True), calibrate=False,
                  memory_only=True)),
        ],
    },
    # extra recorded fix (not one of the three hillclimbs): deepseek
    # prefill does not fit per-chip HBM with replicated-over-data weights;
    # ZeRO-3 prefill gathering shards them.
    "X": {
        "arch": "deepseek-v3-671b", "shape": "prefill_32k",
        "iters": [
            ("opt1",
             "FIX: prefill weights replicated across the data axis "
             "=> 250 GiB/dev; prefill_fsdp shards them (gather/layer) "
             "=> fits-per-chip restored at small collective cost",
             dict(cfg=dict(prefill_fsdp=True), calibrate=False)),
        ],
    },
}


def build_overrides(spec: dict, arch: str) -> tuple[dict, dict]:
    """(config overrides, AdamW overrides) of one iteration's spec."""
    cfg_over = dict(spec.get("cfg", {}))
    if "capacity" in spec:
        base = get_config(arch)
        cfg_over["moe"] = dataclasses.replace(
            base.moe, capacity_factor=spec["capacity"])
    hp_over = spec.get("hp", {})
    return cfg_over, hp_over


def _rebase_uncalibrated(rec: dict, base: dict) -> dict:
    """For calibrate=False variants: costs = base calibrated + raw delta,
    the roofline terms on ``hw.H100_SXM``."""
    from repro_torch.hw import H100_SXM as chip

    for field, raw in (("flops", "raw_flops"),
                       ("hbm_bytes", "raw_hbm_bytes"),
                       ("coll_bytes", "raw_coll_bytes")):
        delta = rec[raw] - base.get(raw, rec[raw])
        rec[field] = max(base[field] + delta, 0.0)
    rec["compute_s"] = rec["flops"] / chip.peak_flops_bf16
    rec["memory_s"] = rec["hbm_bytes"] / chip.hbm_bandwidth
    rec["collective_s"] = rec["coll_bytes"] / chip.ici_bandwidth
    terms = {"compute": rec["compute_s"], "memory": rec["memory_s"],
             "collective": rec["collective_s"]}
    rec["bottleneck"] = max(terms, key=terms.get)
    rec["step_s"] = max(terms.values())
    rec["notes"] = (rec.get("notes", "") + " rebased-uncalibrated").strip()
    return rec


def iterations(cell_ids=None) -> list[tuple[str, str]]:
    """(cell id, tag) of every iteration of ``cell_ids`` (default: all
    five cells), in order."""
    return [(c, tag) for c in (cell_ids or CELLS)
            for tag, _, _ in CELLS[c]["iters"]]


def count_iteration(cell_id: str, tag: str, mesh: str = "pod",
                    calibrate=None) -> dict:
    """The raw record of one iteration of ``CELLS[cell_id]``
    (``launch.dryrun.run_cell`` with its overrides); ``calibrate``
    defaults to the iteration's own setting."""
    from repro_torch.launch.dryrun import run_cell

    spec = CELLS[cell_id]
    over = next(o for t, _, o in spec["iters"] if t == tag)
    cfg_over, hp_over = build_overrides(over, spec["arch"])
    if calibrate is None:
        calibrate = over.get("calibrate", True)
    return run_cell(spec["arch"], spec["shape"], mesh, tag=tag,
                    overrides=cfg_over, hp_overrides=hp_over,
                    verbose=False, calibrate=calibrate)


def finish_iteration(cell_id: str, tag: str, rec: dict,
                     base: dict | None) -> dict:
    """``rec`` read against the cell's ``base`` record as the iteration
    says (roofline terms carried over for a memory-only iteration,
    rebased for an uncalibrated one), with its hypothesis."""
    hypothesis, over = next((h, o) for t, h, o in CELLS[cell_id]["iters"]
                            if t == tag)
    if over.get("memory_only") and base:
        # remat-granularity change: roofline terms carry over from
        # baseline; only memory analysis differs
        for k in ("flops", "hbm_bytes", "coll_bytes", "compute_s",
                  "memory_s", "collective_s", "bottleneck", "step_s"):
            rec[k] = base[k]
        rec["notes"] = "memory-only iteration"
    elif not over.get("calibrate", True) and base:
        # change lives outside the layers: calibrated cost = baseline
        # calibrated + raw delta (exact)
        rec = _rebase_uncalibrated(rec, base)
    rec["hypothesis"] = hypothesis
    return rec


def print_delta(prev: dict, rec: dict) -> None:
    """The reference's before/after lines: each roofline term, the bytes
    a device holds, the bottleneck and the step."""
    for key, label in (("compute_s", "compute"), ("memory_s", "memory"),
                       ("collective_s", "collective")):
        b, a = prev[key], rec[key]
        d = 100 * (a / b - 1) if b else 0.0
        print(f"  {label:>10}: {b:.3f}s -> {a:.3f}s ({d:+.1f}%)")
    gb_b = (prev["arg_bytes"] + prev["temp_bytes"]) / 2**30
    gb_a = (rec["arg_bytes"] + rec["temp_bytes"]) / 2**30
    print(f"  {'mem/dev':>10}: {gb_b:.1f} -> {gb_a:.1f} GiB; "
          f"bneck {prev['bottleneck']} -> {rec['bottleneck']}; "
          f"step {prev['step_s']:.3f} -> {rec['step_s']:.3f}s")


def main(argv=None):
    from repro_torch.launch.dryrun import RESULTS_DIR, cell_path, run_cell

    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", nargs="*", default=["A", "B", "C", "X"])
    ap.add_argument("--mesh", default="pod")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(RESULTS_DIR, exist_ok=True)
    for cell_id in args.cell:
        spec = CELLS[cell_id]
        arch, shape = spec["arch"], spec["shape"]
        base_p = cell_path(arch, shape, args.mesh)
        if not os.path.exists(base_p) or args.force:
            # the baseline the iterations are read against, counted as
            # the dry-run counts it
            base = run_cell(arch, shape, args.mesh, verbose=False,
                            calibrate=args.mesh == "pod")
            with open(base_p, "w") as f:
                json.dump(base, f, indent=1)
        with open(base_p) as f:
            base = json.load(f)
        print(f"\n=== cell {cell_id}: {arch} / {shape} ===")
        print(f"baseline: c={base['compute_s']:.3f}s "
              f"m={base['memory_s']:.3f}s x={base['collective_s']:.3f}s "
              f"bneck={base['bottleneck']} args+temp="
              f"{(base['arg_bytes'] + base['temp_bytes']) / 2**30:.1f}GiB")
        prev = base
        for tag, hypothesis, _ in spec["iters"]:
            print(f"\n--- {tag}: {hypothesis}")
            p = cell_path(arch, shape, args.mesh, tag)
            if os.path.exists(p) and not args.force:
                with open(p) as f:
                    rec = json.load(f)
                print("  (cached)")
            else:
                rec = finish_iteration(cell_id, tag, count_iteration(
                    cell_id, tag, args.mesh), base)
                with open(p, "w") as f:
                    json.dump(rec, f, indent=1)
            print_delta(prev, rec)
            prev = rec


if __name__ == "__main__":
    main()
