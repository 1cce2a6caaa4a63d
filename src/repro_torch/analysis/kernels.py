"""Pass 1 — CUDA launch-contract checker (KRN rules).

The port's counterpart of ``repro.analysis.kernels``.  Imports each
kernel package's ``ops`` module, reads its ``CONTRACTS``
(``repro_torch.analysis.contracts.KernelContract``), and for every
declared case enumerates every CTA of every launch in plain Python (no
device, no build) to prove:

- KRN001  every tile of every output and scratch buffer is written by
          some CTA (an under-covering grid leaves stale rows behind);
- KRN002  no two CTAs of one launch write the same tile (every grid
          axis runs concurrently on a GPU: a revisit is a race);
- KRN003  no tile crosses a buffer's end unless the kernel masks its
          ragged tail, no CTA writes only past the end, and the
          wrapper's ``plan`` takes the case;
- KRN004  dtype consistency across each declared buffer group;
- KRN005  shared memory within 48 KB without opting in and 232,448
          bytes with it, threads within 1,024 and equal to the launch
          bound, grid axes within the device's limits;
- KRN006  a launch reads only scratch tiles an earlier launch of the
          same call wrote, and every scratch tile written is read (a
          merge that misses a split, or split counts that disagree
          between the two launches).
"""
from __future__ import annotations

import importlib
import inspect
import itertools
from typing import Optional

from repro_torch.analysis.contracts import (MAX_CTAS, MAX_GRID,
                                            MAX_THREADS, SMEM_DEFAULT_BYTES,
                                            SMEM_OPT_IN_BYTES, KernelContract,
                                            KernelInstance, PlanRefused)
from repro_torch.analysis.findings import Finding, relpath

KERNEL_PACKAGES = (
    "repro_torch.kernels.decode_attention",
    "repro_torch.kernels.paged_decode_attention",
    "repro_torch.kernels.flash_attention",
    "repro_torch.kernels.verify_attention",
    "repro_torch.kernels.paged_verify_attention",
    "repro_torch.kernels.int8_matmul",
    "repro_torch.kernels.linear_scan",
)


def _loc(contract: KernelContract, root: str) -> tuple[str, int]:
    """file:line of the contract's build function (the declaration)."""
    try:
        path = inspect.getsourcefile(contract.build)
        _, line = inspect.getsourcelines(contract.build)
        return relpath(path, root), line
    except (TypeError, OSError):
        return contract.name, 1


def _where(tile_index, buf) -> str:
    """'inside', 'crosses' (a partial last tile) or 'past' the end."""
    state = "inside"
    for i, d, t in zip(tile_index, buf.shape, buf.tile):
        if i < 0 or i * t >= d:
            return "past"
        if (i + 1) * t > d:
            state = "crosses"
    return state


def check_instance(contract: KernelContract, case: dict,
                   inst: KernelInstance, path: str, line: int
                   ) -> list[Finding]:
    out: list[Finding] = []
    obj = contract.name

    def finding(rule, message, hint, severity="error"):
        out.append(Finding(rule, severity, path, line,
                           f"{contract.name}{case}: {message}", hint,
                           obj=obj))

    bufs = {b.name: b for b in inst.buffers}

    # --- KRN005: the launch's budgets ---------------------------------
    for n, ln in enumerate(inst.launches):
        tag = f"launch {n} ({ln.kernel})"
        smem = ln.smem_bytes()
        limit = SMEM_OPT_IN_BYTES if ln.opt_in else SMEM_DEFAULT_BYTES
        if smem > limit:
            finding("KRN005",
                    f"{tag}: {smem} bytes of shared memory over the "
                    f"{limit}-byte budget "
                    f"({'with' if ln.opt_in else 'without'} opt-in)",
                    "opt in through cudaFuncSetAttribute("
                    "cudaFuncAttributeMaxDynamicSharedMemorySize) above "
                    "48 KB, or shrink the tiles or the ring")
        if not 1 <= ln.threads <= MAX_THREADS:
            finding("KRN005",
                    f"{tag}: {ln.threads} threads a CTA, outside 1.."
                    f"{MAX_THREADS}",
                    "a CTA holds at most 1,024 threads")
        if ln.launch_bound is not None and ln.threads != ln.launch_bound:
            finding("KRN005",
                    f"{tag}: {ln.threads} threads against "
                    f"__launch_bounds__({ln.launch_bound})",
                    "launch exactly the bound the kernel was compiled "
                    "for: more fails to launch, fewer leaves work "
                    "undone")
        for axis, (g, cap) in enumerate(zip(ln.grid, MAX_GRID)):
            if not 1 <= int(g) <= cap:
                finding("KRN005",
                        f"{tag}: grid axis {'xyz'[axis]} = {g}, outside "
                        f"1..{cap}",
                        "a grid axis past the device's limit fails to "
                        "launch; fold it into x")

    # --- KRN004: dtype groups -----------------------------------------
    for group in contract.dtype_groups:
        dtypes: dict = {}
        for name in group:
            if name not in bufs:
                continue          # a group may name a route's scratch
            dtypes.setdefault(bufs[name].dtype, []).append(name)
        if len(dtypes) > 1:
            finding("KRN004",
                    f"buffers {group} must share a dtype but have "
                    f"{ {d: n for d, n in dtypes.items()} }",
                    "cast at the wrapper boundary")

    # --- CTA enumeration: coverage, races, tails, scratch flow --------
    n_ctas = sum(int(g0) * int(g1) * int(g2)
                 for g0, g1, g2 in (ln.grid for ln in inst.launches))
    if n_ctas > MAX_CTAS:
        finding("KRN001",
                f"{n_ctas} CTAs, beyond the enumeration cap {MAX_CTAS}",
                "declare a smaller representative case; coverage is "
                "shape-generic", severity="warning")
        return out
    if any(f.rule == "KRN005" and "grid axis" in f.message for f in out):
        return out                # a grid that cannot launch
    written: dict[str, set] = {b.name: set() for b in inst.buffers
                               if b.role != "input"}
    read: dict[str, set] = {b.name: set() for b in inst.buffers
                            if b.role == "scratch"}
    for n, ln in enumerate(inst.launches):
        tag = f"launch {n} ({ln.kernel})"
        owner: dict = {}                  # (buffer, tile) -> first CTA
        reported: set = set()
        scratch_before = {k: set(v) for k, v in written.items()
                          if bufs[k].role == "scratch"}
        for cta in ln.ctas():
            ok_in: set = set()
            past: list = []
            for name, idx in (ln.writes(*cta) if ln.writes else ()):
                idx = tuple(int(i) for i in idx)
                buf = bufs.get(name)
                if buf is None or buf.role == "input":
                    finding("KRN001",
                            f"{tag}: CTA {cta} writes {name!r}, which is "
                            f"not a declared output or scratch buffer",
                            "declare every buffer a launch writes")
                    return out
                where = _where(idx, buf)
                if where == "past":
                    past.append((name, idx))
                    continue
                if where == "crosses" and not buf.masked:
                    if (name, "tail") not in reported:
                        reported.add((name, "tail"))
                        finding("KRN003",
                                f"{tag}: CTA {cta} writes tile {idx} of "
                                f"{name!r} {buf.shape}, which crosses its "
                                f"end, and {name!r} is not masked",
                                "mask the ragged tail in the kernel and "
                                "declare the buffer masked, or size the "
                                "grid to whole tiles")
                ok_in.add(name)
                first = owner.setdefault((name, idx), cta)
                if first != cta and (name, "race") not in reported:
                    reported.add((name, "race"))
                    finding("KRN002",
                            f"{tag}: tile {idx} of {name!r} written by "
                            f"two CTAs ({first} and {cta})",
                            "every grid axis runs concurrently: give each "
                            "CTA its own tiles, and walk a revisit inside "
                            "one CTA (declare it in loops)")
                written[name].add(idx)
            for name, idx in past:
                buf = bufs[name]
                if (not buf.masked or name not in ok_in) and \
                        (name, "past") not in reported:
                    reported.add((name, "past"))
                    finding("KRN003",
                            f"{tag}: CTA {cta} writes tile {idx} of "
                            f"{name!r} {buf.shape}, past its end (tiles "
                            f"{buf.n_tiles()})",
                            "the grid overshoots the buffer: check the "
                            "ceil-div of the grid against the tile")
            for name, idx in (ln.reads(*cta) if ln.reads else ()):
                idx = tuple(int(i) for i in idx)
                buf = bufs.get(name)
                if buf is None or buf.role != "scratch":
                    finding("KRN006",
                            f"{tag}: CTA {cta} reads {name!r}, which is "
                            f"not a declared scratch buffer",
                            "declare the scratch the launches share")
                    return out
                if idx not in scratch_before.get(name, ()):
                    if (name, "unwritten") not in reported:
                        reported.add((name, "unwritten"))
                        finding("KRN006",
                                f"{tag}: CTA {cta} reads tile {idx} of "
                                f"{name!r} {buf.shape}, which no earlier "
                                f"launch of the call wrote",
                                "the reading launch and the writing one "
                                "must agree on the split count and layout")
                    continue
                read[name].add(idx)

    for buf in inst.buffers:
        if buf.role == "input":
            continue
        expected = buf.n_tiles()
        total = 1
        for e in expected:
            total *= e
        got = written[buf.name]
        if len(got) < total:
            gap = _first_gap(expected, got)
            finding("KRN001",
                    f"{buf.role} {buf.name!r} {buf.shape}: "
                    f"{total - len(got)} of {total} tiles never written "
                    f"(first gap: tile {gap})",
                    "the grid must tile the whole buffer; an "
                    "under-covering grid leaves stale rows that corrupt "
                    "results silently")
        if buf.role == "scratch":
            unread = got - read[buf.name]
            if unread:
                finding("KRN006",
                        f"scratch {buf.name!r}: {len(unread)} tile(s) "
                        f"written and never read (first: "
                        f"{min(unread)})",
                        "a merge that skips a split drops its keys; the "
                        "merge must read every partial the split wrote")
    return out


def _first_gap(n_tiles: tuple, got: set) -> tuple:
    for idx in itertools.product(*(range(n) for n in n_tiles)):
        if idx not in got:
            return idx
    return ()


def check_contract(contract: KernelContract, root: str) -> list[Finding]:
    path, line = _loc(contract, root)
    out: list[Finding] = []
    for case in contract.cases:
        try:
            inst = contract.build(dict(case))
        except PlanRefused as e:
            out.append(Finding(
                "KRN003", "error", path, line,
                f"{contract.name}{case}: the wrapper's plan refuses the "
                f"case: {e}",
                "declare only cases the wrapper takes", obj=contract.name))
            continue
        except Exception as e:                       # noqa: BLE001
            out.append(Finding(
                "KRN000", "error", path, line,
                f"{contract.name}{case}: contract build raised "
                f"{type(e).__name__}: {e}",
                "the contract must instantiate for every declared case",
                obj=contract.name))
            continue
        out.extend(check_instance(contract, dict(case), inst, path, line))
    return out


def check_package(module_name: str, root: str) -> list[Finding]:
    """Import ``<package>.ops`` and check its ``CONTRACTS``."""
    mod = importlib.import_module(module_name + ".ops")
    contracts = getattr(mod, "CONTRACTS", None)
    if not contracts:
        return [Finding(
            "KRN000", "error", relpath(mod.__file__, root), 1,
            f"{module_name}.ops exports no CONTRACTS",
            "declare a KernelContract per wrapper so the coverage, race "
            "and budget proofs cover this kernel", obj=module_name)]
    out: list[Finding] = []
    for contract in contracts:
        out.extend(check_contract(contract, root))
    return out


def run(root: str, packages: Optional[tuple] = None) -> list[Finding]:
    out: list[Finding] = []
    for pkg in packages or KERNEL_PACKAGES:
        out.extend(check_package(pkg, root))
    return out
