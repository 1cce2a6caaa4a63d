"""Shared diagnostic model: findings, inline suppression, baseline.

The copy of ``repro.analysis.findings`` for the port.  Every pass emits
``Finding`` records; the runner filters them through inline
``# repro_torch: noqa[RULE]`` comments (the marker names the package
whose rule it silences) and the committed baseline
(``src/repro_torch/analysis/baseline.json``), with the perf gate's
ratchet mechanics: new findings fail ``--fail-on-new``, and so does a
baselined finding that silently disappears — a fixed finding must be
removed from the baseline in the same change (``--update-baseline``),
or the baseline rots into a list of lies.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Optional

SEVERITIES = ("error", "warning")

# rule id -> one-line description (the README table is generated from
# the same ids; keep them in sync)
RULES = {
    "KRN000": "kernel package exports no CONTRACTS, or a contract "
              "build raised",
    "KRN001": "an output or scratch tile that no CTA writes (gap)",
    "KRN002": "two CTAs of one launch write the same tile (race)",
    "KRN003": "a tile past a buffer's end that the kernel does not "
              "mask, or a case the wrapper's plan refuses",
    "KRN004": "buffer dtypes inconsistent across a declared dtype group",
    "KRN005": "shared memory, threads or grid over the device's budget, "
              "or threads other than the launch bound",
    "KRN006": "a scratch tile read before any earlier launch wrote it, "
              "or written and never read",
    "PUR001": "host read inside a device body",
    "PUR002": "Python if/while/assert on a tensor in a device body",
    "PUR003": "mutable shared instance as a dataclass field default",
    "PUR004": "random draw without an explicit generator=",
    "PUR005": "Python side effect in a device body that a CUDA-graph "
              "replay would skip",
    "UNT001": "incompatible units combined (+/-/comparison)",
    "UNT002": "assignment target suffix disagrees with expression unit",
    "UNT003": "keyword argument unit disagrees with parameter suffix",
    "UNT004": "return unit disagrees with the function name suffix",
}

_NOQA_RE = re.compile(
    r"#\s*repro_torch:\s*noqa(?:\[([A-Z0-9,\s]+)\])?")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic: rule id, severity, location, message, fix hint.

    ``obj`` is the enclosing object (``module:function`` or the
    contract name) — it anchors the baseline fingerprint so findings
    survive unrelated line-number churn.
    """

    rule: str
    severity: str
    path: str                     # repo-relative, forward slashes
    line: int
    message: str
    hint: str = ""
    obj: str = ""

    def __post_init__(self):
        assert self.rule in RULES, f"unknown rule id {self.rule!r}"
        assert self.severity in SEVERITIES, self.severity

    @property
    def fingerprint(self) -> str:
        """Line-insensitive identity used for baseline matching."""
        msg = re.sub(r"\s+", " ", self.message.strip())
        return f"{self.rule}|{self.path}|{self.obj}|{msg}"

    def format(self) -> str:
        out = (f"{self.path}:{self.line}: {self.rule} "
               f"[{self.severity}] {self.message}")
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["fingerprint"] = self.fingerprint
        return d


def relpath(path: str, root: str) -> str:
    return os.path.relpath(os.path.abspath(path),
                           os.path.abspath(root)).replace(os.sep, "/")


# --- inline suppression --------------------------------------------------

def file_suppressions(src: str) -> dict[int, Optional[frozenset]]:
    """Parse ``# repro_torch: noqa[...]`` comments: {line: rules | None}.

    ``None`` means the bare form — every rule on that line is
    suppressed.  Rule lists are comma-separated ids.
    """
    out: dict[int, Optional[frozenset]] = {}
    for i, text in enumerate(src.splitlines(), start=1):
        m = _NOQA_RE.search(text)
        if not m:
            continue
        if m.group(1) is None:
            out[i] = None
        else:
            out[i] = frozenset(
                r.strip() for r in m.group(1).split(",") if r.strip())
    return out


def is_suppressed(finding: Finding,
                  suppressions: dict[int, Optional[frozenset]]) -> bool:
    rules = suppressions.get(finding.line, False)
    if rules is False:
        return False
    return rules is None or finding.rule in rules


# --- baseline (the ratchet) ---------------------------------------------

UNREVIEWED = ("unreviewed — replace with a justification or fix the "
              "finding")


def load_baseline(path: str) -> dict[str, dict]:
    """{fingerprint: {rule, path, justification}} or {} when absent."""
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        data = json.load(f)
    return dict(data.get("findings", {}))


def save_baseline(path: str, findings: list[Finding],
                  previous: Optional[dict[str, dict]] = None) -> dict:
    """Write the baseline for ``findings``; justifications carried over
    from ``previous`` where the fingerprint survives, ``UNREVIEWED``
    for new entries (edit the JSON to justify before committing)."""
    previous = previous or {}
    entries = {}
    for f in sorted(findings, key=lambda f: f.fingerprint):
        old = previous.get(f.fingerprint, {})
        entries[f.fingerprint] = {
            "rule": f.rule,
            "path": f.path,
            "justification": old.get("justification", UNREVIEWED),
        }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        json.dump({"version": 1, "findings": entries}, fh, indent=2,
                  sort_keys=True)
        fh.write("\n")
    return entries


def gate(findings: list[Finding], baseline: dict[str, dict]
         ) -> tuple[list[Finding], list[str]]:
    """Ratchet comparison: returns ``(new_findings, stale_prints)``.

    ``new_findings`` are findings whose fingerprint is not baselined;
    ``stale_prints`` are baselined fingerprints that no longer fire —
    either the finding was fixed (delete the entry) or the analyzer
    stopped seeing it (investigate); both require a baseline refresh.
    """
    seen = {f.fingerprint for f in findings}
    new = [f for f in findings if f.fingerprint not in baseline]
    stale = sorted(fp for fp in baseline if fp not in seen)
    return new, stale
