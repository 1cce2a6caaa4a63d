"""CLI: ``python -m repro_torch.analysis``, the port's gate.

Exit codes: 0 clean (or all findings baselined), 1 gate failure
(new finding, or a baselined finding vanished without a refresh),
2 usage error.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.analysis.findings import (RULES, gate, load_baseline,
                                           save_baseline)
from repro_torch.analysis.runner import run_all

DEFAULT_BASELINE = "src/repro_torch/analysis/baseline.json"
REFRESH_CMD = ("python -m repro_torch.analysis --update-baseline  "
               "# then edit the justification strings")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="The port's static checks: CUDA launch contracts "
                    "(KRN), device-body purity (PUR), unit consistency "
                    "(UNT).")
    ap.add_argument("--root", default=None,
                    help="repo root (default: auto-detect from CWD)")
    ap.add_argument("--rules", nargs="+", metavar="RULE",
                    help="rule prefixes to run, e.g. KRN UNT002 "
                         f"(known: {' '.join(sorted(RULES))})")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline path (default: {DEFAULT_BASELINE} "
                         "under the root)")
    ap.add_argument("--fail-on-new", action="store_true",
                    help="exit 1 on findings not in the baseline, or "
                         "on baselined findings that vanished")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from the current run "
                         "(justifications carried over; new entries "
                         "marked unreviewed)")
    ap.add_argument("--out", default=None,
                    help="also write the findings as JSON (nightly "
                         "artifact)")
    args = ap.parse_args(argv)

    root = args.root or _find_root()
    if root is None:
        print("error: not inside the repo (no src/repro_torch found); "
              "pass --root", file=sys.stderr)
        return 2
    for prefix in args.rules or ():
        if not any(r.startswith(prefix) for r in RULES):
            print(f"error: unknown rule prefix {prefix!r} "
                  f"(known: {' '.join(sorted(RULES))})",
                  file=sys.stderr)
            return 2

    findings = run_all(root, rules=tuple(args.rules or ()))

    baseline_path = args.baseline or os.path.join(root,
                                                  DEFAULT_BASELINE)
    baseline = load_baseline(baseline_path)

    if args.out:
        with open(args.out, "w") as f:
            json.dump({"findings": [x.to_json() for x in findings],
                       "baseline": sorted(baseline)}, f, indent=2)
            f.write("\n")

    if args.update_baseline:
        save_baseline(baseline_path, findings, previous=baseline)
        print(f"baseline written: {os.path.relpath(baseline_path)} "
              f"({len(findings)} finding(s))")
        return 0

    new, stale = gate(findings, baseline)
    old_count = len(findings) - len(new)

    for f in findings:
        marker = "" if f.fingerprint not in baseline else " [baselined]"
        print(f.format() + marker)
    if findings:
        print()
    print(f"{len(findings)} finding(s): {len(new)} new, "
          f"{old_count} baselined; {len(stale)} stale baseline "
          f"entr{'y' if len(stale) == 1 else 'ies'}")

    if not args.fail_on_new:
        return 0
    failed = False
    if new:
        failed = True
        print(f"\nFAIL: {len(new)} finding(s) not in the baseline. "
              f"Fix them, suppress inline with a reviewed "
              f"'# repro_torch: noqa[RULE]', or baseline with a "
              f"justification:\n  {REFRESH_CMD}", file=sys.stderr)
    if stale:
        failed = True
        print(f"\nFAIL: {len(stale)} baselined finding(s) no longer "
              f"fire — fixed findings must leave the baseline in the "
              f"same change (stale entries rot into lies). Refresh:\n"
              f"  {REFRESH_CMD}", file=sys.stderr)
        for fp in stale:
            print(f"  stale: {fp}", file=sys.stderr)
    return 1 if failed else 0


def _find_root():
    d = os.getcwd()
    while True:
        if os.path.isdir(os.path.join(d, "src", "repro_torch")):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            return None
        d = parent


if __name__ == "__main__":
    sys.exit(main())
