"""The port's ``scripts/make_experiments_md.py`` against the reference's
script, on the same dry-run records.

Records: three cells counted by the port's dry-run (``run_cell``,
uncalibrated, a few seconds) and, for hillclimb cells A and C, a
baseline and tagged iterations made from them with seeded numbers.  The
reference script is loaded by path with ``importlib`` and pointed at the
same directory (its ``DRY``), and its ``perf_tables`` at the port's
``CELLS`` (the port words some hypotheses differently).
"""
import importlib.util
import json
import os

import numpy as np
import pytest

from repro_torch.scripts import make_experiments_md as port

ROOT = os.path.join(os.path.dirname(__file__), "..")

MD = """# Experiments

Narrative text stays.

<!-- AUTOGEN:dryrun -->
old dry-run
<!-- /AUTOGEN:dryrun -->

## Roofline

<!-- AUTOGEN:roofline -->
<!-- /AUTOGEN:roofline -->

## Perf

<!-- AUTOGEN:perf -->
stale
<!-- /AUTOGEN:perf -->
Tail.
"""


def _reference_script():
    spec = importlib.util.spec_from_file_location(
        "_ref_make_experiments_md",
        os.path.join(ROOT, "scripts", "make_experiments_md.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.hillclimb import CELLS
    d = tmp_path_factory.mktemp("dryrun_torch")
    rng = np.random.default_rng(0)

    def write(rec, tag=""):
        name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}"
        with open(os.path.join(d, name + (f"__{tag}" if tag else "")
                               + ".json"), "w") as f:
            json.dump(dict(rec, tag=tag), f)

    real = [run_cell("qwen3-1.7b", s, m, verbose=False, calibrate=False)
            for s, m in (("decode_32k", "pod"), ("decode_32k", "multipod"),
                         ("prefill_32k", "pod"))]
    for rec in real:
        write(rec)
    # hillclimb cells: the baseline and its iterations, numbers drawn
    for cell in ("A", "C"):
        spec = CELLS[cell]
        base = dict(real[0], arch=spec["arch"], shape=spec["shape"])
        write(base)
        tags = [t for t, _, _ in spec["iters"]]
        for tag in tags[:-1]:       # the last iteration is missing
            rec = dict(base)
            for k in ("compute_s", "memory_s", "collective_s", "step_s",
                      "arg_bytes", "temp_bytes"):
                rec[k] = float(base[k]) * float(rng.uniform(0.5, 1.5))
            write(rec, tag)
    return str(d)


def test_tables_equal_the_reference_scripts(records, monkeypatch):
    import repro.launch.hillclimb as ref_hill
    from repro_torch.launch.hillclimb import CELLS
    ref = _reference_script()
    monkeypatch.setattr(ref, "DRY", records)
    monkeypatch.setattr(ref_hill, "CELLS", CELLS)
    recs = port.load(records=records)
    assert recs == ref.load()
    assert len(recs) == 5 and port.load("opt1", records) == ref.load("opt1")
    assert port.dryrun_table(recs) == ref.dryrun_table(recs)
    assert port.roofline_table(recs) == ref.roofline_table(recs)
    perf = port.perf_tables(records)
    assert perf == ref.perf_tables()
    assert "#### Cell A" in perf and "#### Cell C" in perf
    assert "#### Cell B" not in perf
    # the port's records have no lower_s/compile_s: 0+0 in both
    assert "| 0+0 |" in port.dryrun_table(recs)


def test_main_fills_every_block_and_inject_is_idempotent(records, tmp_path):
    path = tmp_path / "EXPERIMENTS.md"
    path.write_text(MD)
    assert port.main([str(path), "--records", records]) == 0
    once = path.read_text()
    assert "old dry-run" not in once and "stale" not in once
    assert once.startswith("# Experiments\n\nNarrative text stays.")
    assert once.endswith("Tail.\n")
    recs = port.load(records=records)
    for marker, body in (("dryrun", port.dryrun_table(recs)),
                         ("roofline", port.roofline_table(recs)),
                         ("perf", port.perf_tables(records))):
        assert (f"<!-- AUTOGEN:{marker} -->\n{body}\n"
                f"<!-- /AUTOGEN:{marker} -->") in once
    # one dry-run row per baseline record
    block = once.split("<!-- AUTOGEN:dryrun -->")[1].split("<!-- /")[0]
    assert block.count("\n| ") == 1 + len(recs)    # header and rows
    assert block.count("| qwen3-1.7b | decode_32k |") == 2
    assert port.main([str(path), "--records", records]) == 0
    assert path.read_text() == once
    for marker in ("dryrun", "roofline", "perf"):
        body = {"dryrun": port.dryrun_table(recs),
                "roofline": port.roofline_table(recs),
                "perf": port.perf_tables(records)}[marker]
        assert port.inject(once, marker, body) == once


def test_missing_file_raises(records, tmp_path):
    with pytest.raises(FileNotFoundError):
        port.main([str(tmp_path / "EXPERIMENTS.md"), "--records", records])
