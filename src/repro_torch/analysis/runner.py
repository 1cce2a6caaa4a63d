"""Drives the three passes and applies inline suppressions.

The copy of ``repro.analysis.runner`` for the port.  ``run_all`` is the
single entry point the CLI, the gate and the tests share: launch
contracts (KRN) + device-body purity (PUR) + units (UNT), filtered
through ``# repro_torch: noqa[...]`` comments, sorted by location,
deduplicated by fingerprint.
"""
from __future__ import annotations

import os
from typing import Optional

from repro_torch.analysis import kernels, purity, units
from repro_torch.analysis.findings import (Finding, file_suppressions,
                                     is_suppressed)


def _filter_suppressed(findings: list[Finding],
                       root: str) -> list[Finding]:
    cache: dict[str, dict] = {}
    out = []
    for f in findings:
        supp = cache.get(f.path)
        if supp is None:
            full = os.path.join(root, f.path)
            try:
                supp = file_suppressions(open(full).read())
            except OSError:
                supp = {}
            cache[f.path] = supp
        if not is_suppressed(f, supp):
            out.append(f)
    return out


def run_all(root: str, rules: Optional[tuple] = None,
            packages: Optional[tuple] = None) -> list[Finding]:
    """All passes over the tree at ``root``.

    ``rules`` filters by prefix ("KRN", "PUR001", ...); passes whose
    rules are entirely filtered out are skipped outright (the kernel
    pass imports every kernel package, and torch with them).
    """
    def wanted(rule_family: str) -> bool:
        if not rules:
            return True
        return any(rule_family.startswith(r[:3]) for r in rules)

    findings: list[Finding] = []
    if wanted("KRN"):
        findings.extend(kernels.run(root, packages))
    if wanted("PUR"):
        findings.extend(purity.run(root))
    if wanted("UNT"):
        findings.extend(units.run(root))
    if rules:
        findings = [f for f in findings
                    if any(f.rule.startswith(r) for r in rules)]
    findings = _filter_suppressed(findings, root)
    seen = set()
    unique = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        if f.fingerprint in seen:
            continue
        seen.add(f.fingerprint)
        unique.append(f)
    return unique
