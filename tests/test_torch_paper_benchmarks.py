"""The port's paper-figure benchmarks against the reference's, on the CPU.

The same dry-run cell records (a seeded set covering every cell of the
grid, plus one record the port's ``launch.dryrun.run_cell`` wrote),
in a temporary directory both packages' ``DRYRUN_DIR`` (and
``SCALE_DIR``) point at, go through both packages' ``roofline_table``,
``energy_per_inference`` (Fig. 6), ``power_range`` (Fig. 2),
``quantization_efficiency.run`` (Fig. 8), ``accuracy_cost`` (Fig. 7) and
``scaling_energy.run`` (Fig. 5).  The port's system (``common.SYSTEM``,
the H100 datacenter system) is replaced by one equal to the
reference's ``DATACENTER_V5E`` field for field, and the rows must agree
within 1e-12 relative.  The tiny model's int8 measurement, a real run
on either side, is held elsewhere (``test_torch_tiny.py``) and stubbed
alike here.  ``power_breakdown.run(smoke=True)`` gives the reference's
per-domain watts and energy under that system, and every review
ACCEPTs.  ``sw_hw_optimizations`` (Figs. 9-10) and
``efficiency_trends`` (Fig. 4) read seeded tagged records of every
hillclimb iteration beside those cells; with the port's generations
(A100, H100, H200) replaced by systems equal to the reference's v4,
v5e and v5p, their rows equal the reference's within 1e-12.
"""
import dataclasses
import glob
import json
import math
import shutil

import numpy as np
import pytest

import benchmarks.accuracy_cost as j_acc
import benchmarks.common as j_common
import benchmarks.efficiency_trends as j_trend
import benchmarks.energy_per_inference as j_epi
import benchmarks.power_breakdown as j_pb
import benchmarks.power_range as j_pr
import benchmarks.quantization_efficiency as j_quant
import benchmarks.roofline_table as j_roof
import benchmarks.scaling_energy as j_scale
import benchmarks.sw_hw_optimizations as j_sw
from repro import hw as jhw
from repro_torch import hw as thw
from repro_torch.benchmarks import accuracy_cost as t_acc
from repro_torch.benchmarks import common as t_common
from repro_torch.benchmarks import efficiency_trends as t_trend
from repro_torch.benchmarks import energy_per_inference as t_epi
from repro_torch.benchmarks import power_breakdown as t_pb
from repro_torch.benchmarks import power_range as t_pr
from repro_torch.benchmarks import quantization_efficiency as t_quant
from repro_torch.benchmarks import roofline_table as t_roof
from repro_torch.benchmarks import scaling_energy as t_scale
from repro_torch.benchmarks import sw_hw_optimizations as t_sw
from repro_torch.configs import SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch import hillclimb as t_hill
from repro_torch.launch.roofline import CellReport

TINY = {"arch": "tiny-kws(real)", "int8_argmax_agreement": 0.99,
        "int8_rel_err": 0.01}


def _v5e_system():
    """The port's ``SystemSpec`` with the reference's ``DATACENTER_V5E``
    values, field for field."""
    ref = jhw.DATACENTER_V5E
    chip = thw.ChipSpec(**dataclasses.asdict(ref.chip))
    rest = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)
            if f.name != "chip"}
    return thw.SystemSpec(chip=chip, **rest)


def _record(rng, arch, shape, mesh, n_devices):
    """A seeded record in the dry-run's format (``CellReport`` fields)."""
    flops, hbm, coll = (float(10 ** rng.uniform(lo, hi)) for lo, hi in
                        ((9, 15), (8, 13), (5, 12)))
    terms = {"compute": flops / 989e12, "memory": hbm / 3.35e12,
             "collective": coll / 50e9}
    return CellReport(
        arch=arch, shape=shape, mesh=mesh, n_devices=n_devices,
        flops=flops, hbm_bytes=hbm, coll_bytes=coll, coll_breakdown={},
        compute_s=terms["compute"], memory_s=terms["memory"],
        collective_s=terms["collective"],
        bottleneck=max(terms, key=terms.get),
        model_flops=flops * n_devices * 0.5, model_flops_ratio=0.5,
        arg_bytes=int(rng.integers(1 << 28, 1 << 36)),
        temp_bytes=int(rng.integers(1 << 20, 1 << 34)),
        fits_hbm=bool(rng.integers(0, 2)), step_s=max(terms.values()),
    ).to_json()


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """Every dry-run cell's record (one of them the port's own), and the
    scaling points; returns (dryrun dir, scaling dir)."""
    root = tmp_path_factory.mktemp("cells")
    cells_dir, scale_dir = root / "dryrun", root / "scaling"
    cells_dir.mkdir()
    scale_dir.mkdir()
    rng = np.random.default_rng(0)
    for arch, shape, mesh in dryrun.cells():
        n = 256 if mesh == "pod" else 512
        rec = _record(rng, arch, shape, mesh, n)
        with open(cells_dir / f"{arch}__{shape}__{mesh}.json", "w") as f:
            json.dump(rec, f)
    rec = dryrun.run_cell("qwen3-1.7b", "decode_32k", "pod", verbose=False,
                          calibrate=False)
    with open(cells_dir / "qwen3-1.7b__decode_32k__pod.json", "w") as f:
        json.dump(rec, f)
    for n in (64, 256, 512):
        with open(scale_dir / f"qwen3-1.7b__{n}.json", "w") as f:
            json.dump(_record(rng, "qwen3-1.7b", "train_4k", f"{n}chips", n),
                      f)
    return str(cells_dir), str(scale_dir)


@pytest.fixture
def both(records, monkeypatch):
    cells_dir, scale_dir = records
    for mod in (j_common, t_common):
        monkeypatch.setattr(mod, "DRYRUN_DIR", cells_dir)
    for mod in (j_scale, t_scale):
        monkeypatch.setattr(mod, "SCALE_DIR", scale_dir)
    monkeypatch.setattr(t_common, "SYSTEM", _v5e_system())
    monkeypatch.setattr(j_quant, "tiny_accuracy_measurement",
                        lambda: dict(TINY))
    monkeypatch.setattr(t_quant, "tiny_accuracy_measurement",
                        lambda device="cuda": dict(TINY))


def _same(got, want, path="rows"):
    """Equal structure; floats within 1e-12 relative."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert math.isclose(got, want, rel_tol=1e-12, abs_tol=0.0), \
            (path, got, want)
    else:
        assert got == want, (path, got, want)


def test_the_v5e_system_is_the_reference_field_for_field():
    ref, port = jhw.DATACENTER_V5E, _v5e_system()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert t_common.SYSTEM is thw.DATACENTER_H100


@pytest.mark.parametrize("name,port,ref", [
    ("roofline_table", t_roof.run, j_roof.run),
    ("energy_per_inference", t_epi.run, j_epi.run),
    ("power_range", t_pr.run, j_pr.run),
    ("quantization_efficiency", t_quant.run, j_quant.run),
    ("accuracy_cost", t_acc.run, j_acc.run),
    ("accuracy_cost.summary", t_acc.summary, j_acc.summary),
    ("scaling_energy", t_scale.run, j_scale.run),
])
def test_reader_rows_equal_the_reference(both, name, port, ref):
    want = ref()
    assert want, name
    _same(port(), want)


def test_readers_csv_rows_equal_the_reference(both):
    for port, ref in ((t_roof.csv, j_roof.csv), (t_epi.csv, j_epi.csv),
                      (t_pr.csv, j_pr.csv), (t_acc.csv, j_acc.csv),
                      (t_scale.csv, j_scale.csv)):
        assert port() == ref()
    assert t_quant.csv("cpu") == j_quant.csv()


def test_readers_skip_missing_cells_as_the_reference(tmp_path,
                                                     monkeypatch):
    for mod in (j_common, t_common):
        monkeypatch.setattr(mod, "DRYRUN_DIR", str(tmp_path))
    for mod in (j_scale, t_scale):
        monkeypatch.setattr(mod, "SCALE_DIR", str(tmp_path / "none"))
    assert t_roof.run() == j_roof.run() == []
    assert t_acc.run() == j_acc.run() == []
    assert t_scale.run() == j_scale.run() == []
    _same(t_epi.run(), j_epi.run())
    assert len(t_epi.run()) == 1                    # the tiny row alone


def test_the_h100_system_models_the_port_s_own_record(records,
                                                      monkeypatch):
    """Without the substitution the readers model the cells on the H100
    system: the port's own decode record gives a finite J/token, and
    more chips of a faster part than the v5e's."""
    monkeypatch.setattr(t_common, "DRYRUN_DIR", records[0])
    rec = t_common.load_cell("qwen3-1.7b", "decode_32k", "pod")
    assert rec["ok"] and rec["n_devices"] == 256
    ce = t_common.cell_energy(rec)
    assert ce["energy_j"] > 0 and math.isfinite(ce["energy_j"])
    assert ce["step_s"] == pytest.approx(
        max(rec["compute_s"], rec["memory_s"], rec["collective_s"]),
        rel=1e-12)
    assert t_common.samples_per_step(rec) == SHAPES["decode_32k"].global_batch


def test_power_breakdown_equals_the_reference_and_accepts(monkeypatch):
    monkeypatch.setattr(t_common, "SYSTEM", _v5e_system())
    want, got = j_pb.run(smoke=True), t_pb.run(smoke=True)
    assert list(got) == list(want) == ["tiny", "edge", "tp1", "tp4", "r2"]
    for point in want:
        g, w = got[point], want[point]
        assert g.passed and w.passed, point
        _same(g.per_domain_watts, w.per_domain_watts, point)
        _same(g.summary.energy_j, w.summary.energy_j, point)
        _same(g.samples_per_joule, w.samples_per_joule, point)
        assert t_pb._row(point, g) == j_pb._row(point, w)


# -- Figs. 4 and 9-10: the readers of the hillclimb's tagged cells ---------
# the port's generations and the reference's they stand for in the test
GEN_AS_REF = {"datacenter-a100": "datacenter-v4",
              "datacenter-h100": "datacenter-v5e",
              "datacenter-h200": "datacenter-v5p"}


def _ref_system(key):
    """The port's ``SystemSpec`` equal to the reference's ``key`` field
    for field."""
    ref = jhw.SYSTEMS[key]
    chip = thw.ChipSpec(**dataclasses.asdict(ref.chip))
    rest = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)
            if f.name != "chip"}
    return thw.SystemSpec(chip=chip, **rest)


@pytest.fixture(scope="module")
def tagged_dir(records, tmp_path_factory):
    """The seeded cells plus seeded tagged records (opt1-opt3) of every
    hillclimb iteration's pod cell, in a directory of their own."""
    root = tmp_path_factory.mktemp("tagged")
    for p in sorted(glob.glob(records[0] + "/*.json")):
        shutil.copy(p, root)
    rng = np.random.default_rng(1)
    for cell_id, tag in t_hill.iterations():
        spec = t_hill.CELLS[cell_id]
        rec = _record(rng, spec["arch"], spec["shape"], "pod", 256)
        with open(root / f"{spec['arch']}__{spec['shape']}__pod__{tag}.json",
                  "w") as f:
            json.dump(rec, f)
    return str(root)


@pytest.fixture
def gens(tagged_dir, monkeypatch):
    for mod in (j_common, t_common):
        monkeypatch.setattr(mod, "DRYRUN_DIR", tagged_dir)
    monkeypatch.setattr(t_sw, "SYSTEMS", {
        port: _ref_system(ref) for port, ref in GEN_AS_REF.items()})


def _as_ref(x):
    """The port's rows with its generation names as the reference's."""
    if isinstance(x, dict):
        return {GEN_AS_REF.get(k, k): _as_ref(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_as_ref(v) for v in x]
    if isinstance(x, str):
        for port, ref in GEN_AS_REF.items():
            x = x.replace(port, ref).replace(
                port.split("-")[1] + "=", ref.split("-")[1] + "=")
        return x
    return x


def test_the_generations_stand_for_the_reference_s_in_order():
    assert t_sw.HW_GENS == list(GEN_AS_REF)
    assert j_sw.HW_GENS == list(GEN_AS_REF.values())
    assert t_sw.PERF_TAGS == j_sw.PERF_TAGS
    assert t_sw.SW_SYSTEM == "datacenter-h100"
    for key in t_sw.HW_GENS:
        assert key in thw.SYSTEMS
    assert [thw.SYSTEMS[k].chip.peak_flops_bf16 for k in t_sw.HW_GENS] \
        == [312e12, 989e12, 989e12]


@pytest.mark.parametrize("name,port,ref", [
    ("run_software", t_sw.run_software, j_sw.run_software),
    ("run_hardware", t_sw.run_hardware, j_sw.run_hardware),
    ("sw_hw csv", t_sw.csv, j_sw.csv),
    ("efficiency_trends.run", t_trend.run, j_trend.run),
    ("efficiency_trends csv", t_trend.csv, j_trend.csv),
])
def test_sw_hw_and_trend_rows_equal_the_reference(gens, name, port, ref):
    """Seeded tagged records under the generations patched to the
    reference's v4/v5e/v5p: every row within 1e-12 (names mapped)."""
    want = ref()
    assert want, name
    _same(_as_ref(port()), want)


def test_sw_hw_rows_on_the_port_s_own_generations(tagged_dir, monkeypatch):
    """Unpatched, the hardware half models the A100, H100 and H200 data
    sheets: each row normalised to the A100, the H200 at least the
    H100 (same peak, more memory bandwidth)."""
    monkeypatch.setattr(t_common, "DRYRUN_DIR", tagged_dir)
    rows = t_sw.run_hardware()
    assert [r["workload"] for r in rows] == ["yi-9b/train_4k",
                                             "qwen3-1.7b/prefill_32k"]
    for r in rows:
        assert r["datacenter-a100"] == 1.0
        assert r["datacenter-h200"] >= r["datacenter-h100"] > 0
    assert t_sw.csv()[1].split(",", 2)[2].startswith("a100=1.000;h100=")
