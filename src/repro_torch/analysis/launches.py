"""Hold launch contracts to what the card records (``chip_smoke.py``
phase 29).

The static pass (``repro_torch.analysis.kernels``) proves the contracts
consistent; this module proves them true of the built kernels: each
kernel record of a ``torch.profiler`` trace (its grid, block, shared
memory and registers, as CUPTI reports them) and each ``ptxas -v``
entry of the kernel's build (registers, spill stores, static shared
memory) against the contract's ``Launch``.  Nothing here needs a card:
the tests feed it recorded text.
"""
from __future__ import annotations

import json
import re
import shutil
import subprocess
from typing import Callable, Optional

from repro_torch.analysis.contracts import (MAX_REGISTERS,
                                            REGISTERS_PER_SM, Launch)

_QUALIFIER = re.compile(r"[A-Za-z_]\w*::")
_REGS = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def normalize(name: str) -> str:
    """A demangled kernel name as ``Launch.signature`` spells it: no
    return type, no parameter list, no namespaces, no spaces
    (``void repro::x::k<2, 128, repro::C<T> >(...)`` -> ``k<2,128,C<T>>``).
    """
    s = name.replace("(anonymous namespace)::", "").replace(
        "{anonymous}::", "").strip()
    if s.startswith("void "):
        s = s[5:]
    s = s.split("(", 1)[0]
    s = re.sub(r"\s+", "", s)
    return _QUALIFIER.sub("", s)


def demangle(names: list[str]) -> list[str]:
    """Itanium names through ``c++filt`` (binutils, beside the host
    compiler ``nvcc`` drives)."""
    tool = shutil.which("c++filt")
    if tool is None:
        raise RuntimeError("c++filt not found: ptxas's kernel names "
                           "cannot be matched to the contracts")
    out = subprocess.run([tool], input="\n".join(names), text=True,
                         capture_output=True, check=True).stdout
    got = out.splitlines()
    if len(got) != len(names):
        raise RuntimeError("c++filt returned a different number of names")
    return got


def parse_ptxas(log: str, demangler: Callable = demangle) -> dict:
    """``nvcc -Xptxas -v`` output -> {normalized kernel name:
    {"registers", "spill_stores", "spill_loads", "smem", "mangled"}}, one
    entry per ``__global__`` function compiled."""
    entries: dict[str, dict] = {}
    current, props = None, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln and "'" in ln:
            current = ln.split("'")[1]
            entries[current] = {"registers": None, "spill_stores": 0,
                                "spill_loads": 0, "smem": 0}
        elif "Function properties for" in ln:
            props = ln.rsplit("Function properties for", 1)[1].strip()
        elif (m := _SPILL.search(ln)) and props in entries:
            entries[props]["spill_stores"] = int(m.group(1))
            entries[props]["spill_loads"] = int(m.group(2))
        elif (m := _REGS.search(ln)) and current in entries:
            entries[current]["registers"] = int(m.group(1))
            s = _SMEM.search(ln)
            entries[current]["smem"] = int(s.group(1)) if s else 0
    mangled = list(entries)
    names = demangler(mangled) if mangled else []
    return {normalize(n): dict(entries[m], mangled=m)
            for n, m in zip(names, mangled)}


def kernel_records(trace) -> list[dict]:
    """The kernel records of a ``torch.profiler`` chrome trace (a path or
    the loaded JSON), in start order: {"name", "grid", "block",
    "registers", "smem", "args"}; a field the trace lacks is ``None``."""
    if isinstance(trace, str):
        with open(trace) as f:
            trace = json.load(f)
    events = trace.get("traceEvents", trace) if isinstance(
        trace, dict) else trace
    out = []
    for ev in events:
        if ev.get("cat") != "kernel":
            continue
        a = ev.get("args", {})
        out.append({"name": ev.get("name", ""),
                    "ts": ev.get("ts", 0),
                    "grid": tuple(a["grid"]) if "grid" in a else None,
                    "block": tuple(a["block"]) if "block" in a else None,
                    "registers": a.get("registers per thread"),
                    "smem": a.get("shared memory"),
                    "args": a})
    out.sort(key=lambda r: r["ts"])
    return out


def hold(launch: Launch, record: Optional[dict],
         ptxas: Optional[dict]) -> tuple[dict, list[str]]:
    """One contract launch against the card's record of it and its
    ptxas entry.  Returns (the numbers, the mismatches).  Shared memory
    in the trace is static + dynamic; ptxas gives the static part and
    the spills; registers come from the trace where it has them, else
    from ptxas (``sources`` says which)."""
    bad: list[str] = []
    row = {"kernel": launch.signature, "grid": launch.grid,
           "threads": launch.threads, "static_smem": launch.static_smem,
           "dynamic_smem": launch.dynamic_smem, "sources": {}}
    if record is None:
        return row, [f"{launch.signature}: no kernel record in the trace"]
    got = normalize(record["name"])
    if got != launch.signature:
        bad.append(f"name {got!r} != contract {launch.signature!r}")
    for key, want in (("grid", tuple(launch.grid)),
                      ("block", (launch.threads, 1, 1))):
        if record[key] is None:
            row["sources"][key] = "missing"
            bad.append(f"{launch.signature}: the trace has no {key}")
        elif tuple(record[key]) != want:
            bad.append(f"{launch.signature}: {key} {tuple(record[key])} "
                       f"!= contract {want}")
    if record["smem"] is not None:
        row["sources"]["smem"] = "trace"
        row["trace_smem"] = record["smem"]
        if record["smem"] != launch.smem_bytes():
            bad.append(f"{launch.signature}: shared memory "
                       f"{record['smem']} != contract "
                       f"{launch.static_smem} + {launch.dynamic_smem}")
    regs = record["registers"]
    row["sources"]["registers"] = "trace"
    if ptxas is None:
        bad.append(f"{launch.signature}: no ptxas entry")
    else:
        row.update(ptxas_registers=ptxas["registers"],
                   spill_stores=ptxas["spill_stores"],
                   spill_loads=ptxas["spill_loads"],
                   ptxas_smem=ptxas["smem"])
        if record["smem"] is None:
            row["sources"]["smem"] = "ptxas (static only)"
        if ptxas["smem"] != launch.static_smem:
            bad.append(f"{launch.signature}: ptxas static shared memory "
                       f"{ptxas['smem']} != contract {launch.static_smem}")
        if ptxas["spill_stores"] != launch.spill_bytes:
            bad.append(f"{launch.signature}: ptxas spill stores "
                       f"{ptxas['spill_stores']} != contract "
                       f"{launch.spill_bytes}")
        if regs is None:
            regs = ptxas["registers"]
            row["sources"]["registers"] = "ptxas"
        elif ptxas["registers"] is not None and regs != ptxas["registers"]:
            bad.append(f"{launch.signature}: {regs} registers in the "
                       f"trace, {ptxas['registers']} in ptxas")
    row["registers"] = regs
    if regs is None:
        bad.append(f"{launch.signature}: no register count")
    elif regs > MAX_REGISTERS or regs * launch.threads > REGISTERS_PER_SM:
        bad.append(f"{launch.signature}: {regs} registers x "
                   f"{launch.threads} threads over {MAX_REGISTERS} a "
                   f"thread or {REGISTERS_PER_SM} a CTA")
    return row, bad


def match(launches: tuple, records: list[dict]) -> list:
    """The records of ``launches`` in order: each record whose
    normalized name has a contract launch's kernel name as its base
    (other kernels of the call, a dtype cast or a copy, are dropped).
    ``None`` pads a record that is missing."""
    bases = {ln.kernel for ln in launches}
    mine = [r for r in records
            if normalize(r["name"]).split("<", 1)[0] in bases]
    return mine + [None] * (len(launches) - len(mine))
