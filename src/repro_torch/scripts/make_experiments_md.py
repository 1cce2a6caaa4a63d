"""Render the §Dry-run, §Roofline and §Perf tables of an EXPERIMENTS.md
from the port's dry-run records (PyTorch port of
``scripts/make_experiments_md.py``).

  PYTHONPATH=src python -m repro_torch.scripts.make_experiments_md \\
      EXPERIMENTS.md [--records experiments/dryrun_torch]

The narrative sections are written in the file by hand; this script
replaces the data blocks between the ``<!-- AUTOGEN:dryrun -->``,
``roofline`` and ``perf`` markers with tables of the records that
``launch.dryrun`` (baseline cells) and ``launch.hillclimb`` (tagged
iterations of its ``CELLS``) write under ``experiments/dryrun_torch/``.
The file must exist (a missing one raises, as the reference's ``open``
does).  The port's records carry no ``lower_s``/``compile_s``: the
tables read them with the reference's ``r.get(..., 0)``, so one record
renders the same row in both scripts.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re

from repro_torch.launch.dryrun import RESULTS_DIR

ORDER = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}


def load(tag: str = "", records: str = RESULTS_DIR) -> list[dict]:
    """The records under ``records`` whose tag is ``tag`` ("": the
    baseline cells), sorted by arch, shape and mesh."""
    out = []
    for p in sorted(glob.glob(os.path.join(records, "*.json"))):
        parts = os.path.basename(p)[:-5].split("__")
        t = parts[3] if len(parts) > 3 else ""
        if t != tag:
            continue
        with open(p) as f:
            out.append(json.load(f))
    out.sort(key=lambda r: (r["arch"], ORDER.get(r["shape"], 9), r["mesh"]))
    return out


def dryrun_table(recs) -> str:
    lines = ["| arch | shape | mesh | chips | lower+compile s | "
             "args GiB/dev | temp GiB/dev | fits 16GiB | collective ops |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        counts = r["coll_breakdown"].get("raw_counts") or \
            r["coll_breakdown"].get("counts") or {}
        cstr = " ".join(f"{k.replace('all-', 'a')}:{v}"
                        for k, v in sorted(counts.items()))
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r['n_devices']} | {r.get('lower_s', 0)}+{r.get('compile_s', 0)} | "
            f"{r['arg_bytes'] / 2**30:.2f} | {r['temp_bytes'] / 2**30:.2f} | "
            f"{'yes' if r['fits_hbm'] else '**NO**'} | {cstr} |")
    return "\n".join(lines)


def roofline_table(recs) -> str:
    lines = ["| arch | shape | flops/dev | HLO bytes/dev | coll B/dev | "
             "t_comp s | t_mem s | t_coll s | bottleneck | "
             "MODEL/HLO | mem floor s |",
             "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r["mesh"] != "pod":
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['flops']:.2e} | "
            f"{r['hbm_bytes']:.2e} | {r['coll_bytes']:.2e} | "
            f"{r['compute_s']:.3f} | {r['memory_s']:.3f} | "
            f"{r['collective_s']:.3f} | **{r['bottleneck']}** | "
            f"{r['model_flops_ratio']:.3f} | "
            f"{r.get('memory_floor_s', 0):.4f} |")
    return "\n".join(lines)


def _read(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def perf_tables(records: str = RESULTS_DIR) -> str:
    """One table per cell of ``launch.hillclimb.CELLS`` whose baseline
    record and at least one iteration's record exist under
    ``records``."""
    from repro_torch.launch.hillclimb import CELLS
    blocks = []
    for cell_id, spec in CELLS.items():
        arch, shape = spec["arch"], spec["shape"]
        base_p = os.path.join(records, f"{arch}__{shape}__pod.json")
        if not os.path.exists(base_p):
            continue
        rows = [("baseline", _read(base_p), "paper-faithful "
                 "baseline (scan+remat, full-S^2 masked attention, f32 "
                 "scores, one-hot cache update, fp32 AdamW moments)")]
        for tag, hyp, _ in spec["iters"]:
            p = os.path.join(records, f"{arch}__{shape}__pod__{tag}.json")
            if os.path.exists(p):
                rows.append((tag, _read(p), hyp))
        if len(rows) < 2:
            continue
        lines = [f"#### Cell {cell_id}: {arch} / {shape} (pod, 256 chips)",
                 "",
                 "| iter | t_comp s | t_mem s | t_coll s | step s | "
                 "bottleneck | mem GiB/dev | Δ dominant |",
                 "|---|---|---|---|---|---|---|---|"]
        prev_dom = None
        for tag, r, hyp in rows:
            dom = max(r["compute_s"], r["memory_s"], r["collective_s"])
            delta = ""
            if prev_dom is not None:
                delta = f"{100 * (dom / prev_dom - 1):+.1f}%"
            prev_dom = dom
            gib = (r["arg_bytes"] + r["temp_bytes"]) / 2**30
            lines.append(
                f"| {tag} | {r['compute_s']:.3f} | {r['memory_s']:.3f} | "
                f"{r['collective_s']:.3f} | {r['step_s']:.3f} | "
                f"{r['bottleneck']} | {gib:.1f} | {delta} |")
        lines.append("")
        for tag, r, hyp in rows[1:]:
            lines.append(f"- **{tag}** — {hyp}")
        blocks.append("\n".join(lines))
    return "\n\n".join(blocks)


def inject(md: str, marker: str, content: str) -> str:
    """``md`` with the text between the ``marker`` AUTOGEN comments
    replaced by ``content`` (idempotent)."""
    pat = re.compile(
        rf"(<!-- AUTOGEN:{marker} -->).*?(<!-- /AUTOGEN:{marker} -->)",
        re.S)
    return pat.sub(lambda m: f"{m.group(1)}\n{content}\n{m.group(2)}", md)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("path", help="the EXPERIMENTS.md to update in place")
    ap.add_argument("--records", default=RESULTS_DIR,
                    help="the dry-run records' directory")
    args = ap.parse_args(argv)
    recs = load(records=args.records)
    with open(args.path) as f:
        md = f.read()
    md = inject(md, "dryrun", dryrun_table(recs))
    md = inject(md, "roofline", roofline_table(recs))
    md = inject(md, "perf", perf_tables(args.records))
    with open(args.path, "w") as f:
        f.write(md)
    print(f"{args.path} updated with {len(recs)} baseline cells")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
