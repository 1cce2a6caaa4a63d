"""The port's static checks (``repro_torch.analysis``) against the
reference's (``repro.analysis``), on the CPU.

Each test of ``tests/test_analysis.py`` has its counterpart here.  The
KRN fixtures are small synthetic CUDA launch contracts, each mutated to
raise the rule it targets: a dropped split, a grid off by one CTA, a
duplicate tile, shared memory over 48 KB without opting in, a merge
reading a partial no launch wrote.  The live contracts of all seven
kernel packages take their route and split layout from the wrapper's
``plan`` at every case, and their output buffers have the reference
contract's output shape (without the reference wrapper's padding).
The PUR fixtures are torch snippets that mirror the reference's JAX
snippets, each run through both packages' passes with the same rule
ids; the UNT snippets are the reference's own, through both
``units.run``.  The C launch code's constants that ``geometry`` mirrors
are read back out of the CUDA sources, and the chip-side checker
(``analysis.launches``) runs on recorded ptxas output and a synthetic
trace.
"""
import ast
import dataclasses
import importlib
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

from repro.analysis import purity as ref_pur
from repro.analysis import units as ref_unt
from repro_torch.analysis import kernels as krn
from repro_torch.analysis import launches
from repro_torch.analysis import purity as pur
from repro_torch.analysis import units as unt
from repro_torch.analysis.contracts import (Buffer, KernelContract,
                                            KernelInstance, Launch,
                                            PlanRefused)
from repro_torch.analysis.findings import (RULES, UNREVIEWED, Finding,
                                           file_suppressions, gate,
                                           is_suppressed, load_baseline,
                                           save_baseline)
from repro_torch.analysis.runner import run_all
from repro_torch.kernels import geometry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
BASELINE = os.path.join(ROOT, "src", "repro_torch", "analysis",
                        "baseline.json")


def _rules(findings):
    return sorted(f.rule for f in findings)


def _contract(build, **kw):
    kw.setdefault("cases", ({},))
    return KernelContract(name="fixture", build=build, **kw)


def _write_tree(tmp_path, name, body):
    p = tmp_path / name
    p.write_text(textwrap.dedent(body))
    return str(p)


# --- Pass 1: launch contracts (KRN) ---------------------------------------

def _out(shape=(4, 8), tile=(1, 8), masked=False, name="o",
         role="output", dtype="float32"):
    return Buffer(name, shape, dtype, role, tile, masked)


def _launch(grid, writes, threads=128, bound=128, **kw):
    return Launch(kernel="k", template=(),
                  grid=tuple(grid) + (1,) * (3 - len(grid)),
                  threads=threads, launch_bound=bound, writes=writes, **kw)


def _one(launch, *buffers):
    return lambda case: KernelInstance("r", (launch,), buffers)


def _split_merge(split_grid=4, merge_splits=4, n_split=4, sets=3):
    """A split route: grid (sets, split_grid) writes partial tile (set,
    split); the merge (sets, 1) reads ``merge_splits`` partials of its
    set and writes output row ``set``."""
    split = Launch("split", (), (sets, split_grid, 1), 128, 128,
                   writes=lambda x, y, z: (("part", (x, y, 0)),))
    merge = Launch("merge", (), (sets, 1, 1), 64, None,
                   dynamic_smem=8 * n_split,
                   writes=lambda x, y, z: (("o", (x, 0)),),
                   reads=lambda x, y, z: [("part", (x, s, 0))
                                          for s in range(merge_splits)])
    bufs = (_out((sets, 64), (1, 64)),
            _out((sets, n_split, 64), (1, 1, 64), name="part",
                 role="scratch"))
    return lambda case: KernelInstance("split", (split, merge), bufs)


class TestKernelRules:
    def test_gap_krn001(self):
        # a grid one CTA short of the 4 output rows: the last never written
        build = _one(_launch((3,), lambda x, y, z: (("o", (x, 0)),)),
                     _out())
        out = krn.check_contract(_contract(build), ROOT)
        assert _rules(out) == ["KRN001"]
        f = out[0]
        assert "1 of 4 tiles never written" in f.message
        assert "(3, 0)" in f.message             # the first gap, named
        assert f.path.endswith("tests/test_torch_analysis.py")
        assert f.line > 0 and "tile the whole" in f.hint

    @pytest.mark.parametrize("grid,writes", [
        # two grid axes onto one row: a race, whatever the axis
        ((2, 2), lambda x, y, z: (("o", (x, 0)),)),
        # one CTA index mapped twice by a wrong index map
        ((4, 1), lambda x, y, z: (("o", (min(x, 2), 0)),)),
    ])
    def test_duplicate_tile_krn002(self, grid, writes):
        shape = (2, 8) if grid == (2, 2) else (3, 8)
        build = _one(_launch(grid, writes), _out(shape))
        out = krn.check_contract(_contract(build), ROOT)
        assert _rules(out) == ["KRN002"]
        assert "written by two CTAs" in out[0].message

    def test_revisit_inside_one_cta_is_legal(self):
        # the reference's "arbitrary" axis: here a CTA walks its row's
        # tiles in a loop it names, so no two CTAs share a tile
        build = _one(_launch((2,), lambda x, y, z: [("o", (x, j))
                                                    for j in range(4)],
                             loops=("the row's 4 tiles, in order",)),
                     _out((2, 8), (1, 2)))
        assert krn.check_contract(_contract(build), ROOT) == []

    @pytest.mark.parametrize("masked,grid,rule", [
        (False, (4,), ["KRN003"]),     # a ragged last tile, not masked
        (True, (4,), []),              # the kernel masks it: legal
        (True, (5,), ["KRN003"]),      # a grid one CTA past the end
    ])
    def test_ragged_tail_krn003(self, masked, grid, rule):
        # 100 rows in tiles of 32: ceil-div gives 4 CTAs
        build = _one(_launch(grid, lambda x, y, z: (("o", (x, 0)),)),
                     _out((100, 8), (32, 8), masked=masked))
        out = krn.check_contract(_contract(build), ROOT)
        assert _rules(out) == rule
        if rule:
            assert "mask" in out[0].hint or "ceil-div" in out[0].hint

    def test_plan_refusal_krn003(self):
        def build(case):
            raise PlanRefused("decode_attention: D = 80 not in (64, 96, 128)")
        out = krn.check_contract(_contract(build), ROOT)
        assert _rules(out) == ["KRN003"]
        assert "plan refuses" in out[0].message and "D = 80" in out[0].message

    def test_dtype_group_krn004(self):
        bufs = (Buffer("x", (8, 8), "int8", "input"),
                Buffer("w", (8, 8), "bfloat16", "input"), _out((8, 8), (8, 8)))
        build = _one(_launch((1,), lambda x, y, z: (("o", (0, 0)),)), *bufs)
        out = krn.check_contract(
            _contract(build, dtype_groups=(("x", "w"),)), ROOT)
        assert _rules(out) == ["KRN004"]

    @pytest.mark.parametrize("kw,words", [
        # 64 KB of dynamic shared memory without opting in
        (dict(dynamic_smem=64 * 1024), "without opt-in"),
        # 48 KB + 1 of static arrays
        (dict(static_smem=48 * 1024 + 1), "without opt-in"),
        # opted in, but past the SM's 227 KB
        (dict(dynamic_smem=232_449, opt_in=True), "with opt-in"),
        # threads other than __launch_bounds__
        (dict(threads=256), "__launch_bounds__(128)"),
        # over 1,024 threads
        (dict(threads=2048, bound=None), "outside 1..1024"),
    ])
    def test_budget_krn005(self, kw, words):
        kw = {"threads": 128, "bound": 128, **kw}
        build = _one(_launch((4,), lambda x, y, z: (("o", (x, 0)),), **kw),
                     _out())
        out = krn.check_contract(_contract(build), ROOT)
        assert _rules(out) == ["KRN005"]
        assert words in out[0].message

    def test_opt_in_under_budget_is_legal(self):
        build = _one(_launch((4,), lambda x, y, z: (("o", (x, 0)),),
                             dynamic_smem=198_792, opt_in=True), _out())
        assert krn.check_contract(_contract(build), ROOT) == []

    def test_grid_axis_past_the_device_limit_krn005(self):
        build = _one(_launch((1, 70_000, 1), lambda x, y, z: ()),
                     _out((1, 8), (1, 8)))
        out = krn.check_contract(_contract(build), ROOT)
        assert "KRN005" in _rules(out)
        assert "grid axis y = 70000" in " ".join(f.message for f in out)

    def test_build_failure_krn000(self):
        def build(case):
            raise RuntimeError("shape arithmetic broke")
        out = krn.check_contract(_contract(build), ROOT)
        assert _rules(out) == ["KRN000"]
        assert "shape arithmetic broke" in out[0].message

    def test_split_and_merge_agree(self):
        out = krn.check_contract(_contract(_split_merge()), ROOT)
        assert out == []

    @pytest.mark.parametrize("kw,rules,words", [
        # the merge misses the last split: its partials are never read
        (dict(merge_splits=3), ["KRN006"], "written and never read"),
        # the merge reads one split more than the split grid wrote
        (dict(merge_splits=5, n_split=5), ["KRN001", "KRN006"],
         "no earlier launch of the call wrote"),
        # a dropped split: the split grid one short of the layout
        (dict(split_grid=3), ["KRN001", "KRN006"], "never written"),
    ])
    def test_split_partials_krn006(self, kw, rules, words):
        out = krn.check_contract(_contract(_split_merge(**kw)), ROOT)
        assert sorted(set(_rules(out))) == rules
        assert any(words in f.message for f in out)
        assert "KRN006" in _rules(out)

    def test_merge_before_split_krn006(self):
        inst = _split_merge()({})
        swapped = dataclasses.replace(inst, launches=inst.launches[::-1])
        out = krn.check_contract(_contract(lambda case: swapped), ROOT)
        assert "KRN006" in _rules(out)
        assert any("no earlier launch" in f.message for f in out)

    def test_live_contracts_are_clean(self):
        # all seven kernel packages: contracts exist and prove out
        assert len(krn.KERNEL_PACKAGES) == 7
        assert krn.run(ROOT) == []

    def test_missing_contracts_krn000(self, tmp_path, monkeypatch):
        pkg = tmp_path / "nokern"
        pkg.mkdir()
        (pkg / "__init__.py").write_text("")
        (pkg / "ops.py").write_text("X = 1\n")
        monkeypatch.syspath_prepend(str(tmp_path))
        out = krn.check_package("nokern", str(tmp_path))
        assert _rules(out) == ["KRN000"]
        assert "exports no CONTRACTS" in out[0].message


# the reference's contracts, by the port's package name, and the axes on
# which the reference wrapper pads the output (the port pads nothing)
_REF = {
    "decode_attention": ("decode_attention", "decode_attention", {}),
    "paged_decode_attention": ("decode_attention",
                               "paged_decode_attention", {}),
    "verify_attention": ("decode_attention", "verify_attention", {}),
    "paged_verify_attention": ("decode_attention",
                               "paged_verify_attention", {}),
    "flash_attention": ("flash_attention", "flash_attention", {2: "sq"}),
    "int8_matmul": ("int8_matmul", "int8_matmul", {0: "m", 1: "n"}),
    "linear_scan": ("linear_scan", "linear_scan", {}),
}


def _port_contract(pkg):
    mod = importlib.import_module(f"repro_torch.kernels.{pkg}.ops")
    (contract,) = mod.CONTRACTS
    return mod, contract


def _planned(pkg, mod, case):
    """The wrapper's own plan at a case: (route, split or None)."""
    import torch
    dt = getattr(torch, case.get("dtype", "bfloat16"))
    n_sm = case.get("n_sm", 132)
    if pkg in ("decode_attention", "paged_decode_attention"):
        cap = case.get("s") or case["nb"] * case["page_size"]
        r, n, per = mod.plan(pkg, case["h"], case["kvh"], case["d"], dt,
                             cap, case["b"] * case["kvh"], n_sm)
    elif pkg in ("flash_attention", "verify_attention",
                 "paged_verify_attention"):
        sq = case.get("sq", case.get("t"))
        cap = case.get("skv") or case.get("s") or (case["nb"]
                                                   * case["page_size"])
        r, n, per = mod.plan(pkg, sq, case["h"], case["kvh"], case["d"], dt,
                             cap, case["b"] * case["kvh"], n_sm)
    elif pkg == "int8_matmul":
        return mod.plan(case["m"], case["k"], case["n"], getattr(
            torch, case.get("out_dtype", "bfloat16"))), None
    else:
        return mod.plan(getattr(torch, case.get("dtype", "float32")),
                        case["dh"]), None
    return r, ((n, per) if r == "split" else None)


@pytest.mark.parametrize("pkg", sorted(_REF))
def test_contract_routes_come_from_plan(pkg):
    """At every case the contract's route and split layout are the
    wrapper's ``plan``'s, every route the package has is declared at D
    64, 96 and 128 (dh 32, 64, 128 for the scan), and the split routes'
    scratch and merge follow the split count."""
    mod, contract = _port_contract(pkg)
    routes = set()
    for case in contract.cases:
        inst = contract.build(dict(case))
        assert (inst.route, inst.split) == _planned(pkg, mod, case), case
        routes.add(inst.route)
        if inst.route == "split":
            n_split = inst.split[0]
            assert inst.launches[0].grid[1] == n_split
            assert inst.buffer("o_part").shape[1] == n_split
            assert inst.launches[1].dynamic_smem == \
                geometry.merge_smem_bytes(n_split)
    want = {"decode_attention": {"split", "loop"},
            "paged_decode_attention": {"split", "loop"},
            "flash_attention": {"mma", "split", "tile_f32"},
            "verify_attention": {"mma", "split", "tile_f32"},
            "paged_verify_attention": {"mma", "split", "tile_f32"},
            "int8_matmul": {"wgmma", "sync"},
            "linear_scan": {"chunked", "loop"}}[pkg]
    assert routes == want
    dims = {c.get("d", c.get("dh")) for c in contract.cases}
    assert dims >= ({32, 64, 128} if pkg == "linear_scan"
                    else {64, 96, 128} if "d" in contract.cases[0]
                    else set())


@pytest.mark.parametrize("pkg", sorted(_REF))
def test_contract_outputs_have_the_reference_shape(pkg):
    """At every case of the reference's contract (the port's contract
    declares each of them), the port's output buffers have the
    reference's output shapes, with the reference wrapper's padding
    taken off the axes it pads."""
    ref_pkg, ref_name, padded = _REF[pkg]
    ref = importlib.import_module(f"repro.kernels.{ref_pkg}.ops")
    (ref_contract,) = [c for c in ref.CONTRACTS if c.name == ref_name]
    _, contract = _port_contract(pkg)
    assert all(c in contract.cases for c in ref_contract.cases)
    for case in ref_contract.cases:
        want = ref_contract.build(dict(case)).outputs
        inst = contract.build(dict(case))
        got = [b for b in inst.buffers if b.role == "output"]
        assert [b.name for b in got] == [o.name for o in want]
        for b, o in zip(got, want):
            shape = tuple(case[padded[i]] if i in padded else n
                          for i, n in enumerate(o.shape))
            assert b.shape == shape, (case, b.name)


def _c_constant(path, name):
    text = open(os.path.join(CSRC, path)).read()
    m = re.search(rf"constexpr int {name} = ([^;]+);", text)
    assert m, f"{name} not in {path}"
    return m.group(1).strip()


@pytest.mark.parametrize("path,name,value", [
    ("split_merge.cuh", "kMaxSplits", geometry.MAX_SPLITS),
    ("decode_split.cuh", "kThreads", geometry.DECODE_SPLIT_THREADS),
    ("decode_split.cuh", "kStages", geometry.DECODE_SPLIT_STAGES),
    ("decode_split.cuh", "kMaxStageElems", geometry.DECODE_SPLIT_STAGE_ELEMS),
    ("decode_body.cuh", "kDecodeWarps", geometry.DECODE_LOOP_WARPS),
    ("flash_mma.cuh", "kBK", geometry.MMA_BK),
    ("flash_mma.cuh", "kWarps", geometry.MMA_WARPS),
    ("flash_mma.cuh", "kStages", geometry.MMA_STAGES),
    ("flash_split.cuh", "kRows", geometry.SPLIT_ROWS),
    ("flash_split.cuh", "kChunk", geometry.SPLIT_CHUNK),
    ("flash_split.cuh", "kThreads", geometry.SPLIT_THREADS),
    ("attention_tile.cuh", "kBQ", geometry.TILE_BQ),
    ("attention_tile.cuh", "kBK", geometry.TILE_BK),
    ("attention_tile.cuh", "kTileThreads", geometry.TILE_THREADS),
    ("int8_matmul.cu", "kBM", geometry.SYNC_BM),
    ("int8_matmul.cu", "kBN", geometry.SYNC_BN),
    ("int8_matmul.cu", "kBK", geometry.SYNC_BK),
    ("int8_matmul.cu", "kThreads", geometry.SYNC_THREADS),
    ("int8_wgmma.cuh", "kBK", geometry.WGMMA_BK),
    ("int8_wgmma.cuh", "kBN", geometry.WGMMA_BN),
    ("int8_wgmma.cuh", "kBM", geometry.WGMMA_BM),
    ("int8_wgmma.cuh", "kStages", geometry.WGMMA_STAGES),
    ("linear_scan.cu", "kStageFloats", geometry.SCAN_STAGE_FLOATS),
    ("scan_chunked.cuh", "kSub", geometry.SCAN_SUB),
    ("scan_chunked.cuh", "kVB", geometry.SCAN_VB),
    ("scan_chunked.cuh", "kQ", geometry.SCAN_Q),
    ("scan_chunked.cuh", "NS", geometry.SCAN_CARRY_STAGES),
])
def test_geometry_mirrors_the_c_constants(path, name, value):
    text = _c_constant(path, name)
    assert int(text) == value, (path, name, text)


@pytest.mark.parametrize("path,name,text", [
    # the derived constants, as the C code spells them
    ("int8_matmul.cu", "kRow", "kBK + 16"),
    ("int8_wgmma.cuh", "kThreads", "kConsumers + 128 + 32"),
    ("int8_wgmma.cuh", "kConsumers", "256"),
    ("scan_chunked.cuh", "kPWarps", "8"),
    ("scan_chunked.cuh", "kP", "32 * kPWarps"),
    ("decode_body.cuh", "kDecodeThreads", "kDecodeWarps * 32"),
    ("flash_mma.cuh", "kThreads", "32 * kWarps"),
])
def test_geometry_derived_constants(path, name, text):
    assert _c_constant(path, name) == text
    assert geometry.SYNC_ROW == geometry.SYNC_BK + 16
    assert geometry.WGMMA_THREADS == 256 + 128 + 32
    assert geometry.SCAN_P == 32 * 8
    assert geometry.DECODE_LOOP_THREADS == 8 * 32
    assert geometry.MMA_THREADS == 32 * 4


def test_wrappers_share_geometry_constants():
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.int8_matmul import ops as iops
    assert fops.SPLIT_CHUNK == geometry.SPLIT_CHUNK
    assert fops.SPLIT_MAX_ROWS == geometry.SPLIT_ROWS
    assert iops.WGMMA_TILE == (geometry.WGMMA_BM, geometry.WGMMA_BN)
    # the scan's chunk as its library reports it (the contract's copy)
    assert [geometry.scan_chunk_steps(d) for d in (32, 64, 128)] == \
        [64, 64, 32]


@pytest.mark.parametrize("signature,static", [
    # ptxas's report of the H100 build (phase 29), one per family
    (f"decode_split_kernel<8,96,ContiguousCache<{geometry.BF16}>>", 36864),
    (f"decode_split_kernel<2,128,PagedCache<{geometry.BF16}>>", 49152),
    ("decode_attention_kernel<8,128>", 33280),
    ("decode_attention_kernel<2,128>", 8320),
    (f"flash_split_kernel<128,ContiguousCache<{geometry.BF16}>>", 46592),
    (f"flash_split_kernel<64,PagedCache<{geometry.BF16}>>", 26112),
    ("flash_attention_kernel<float,128>", 35456),
    ("window_tile_kernel<float,64,ContiguousCache<float>>", 19072),
    ("linear_scan_kernel<float,64>", 20608),
    ("int8_matmul_kernel<float>", 30720),
    (f"flash_mma_kernel<128,ContiguousCache<{geometry.BF16}>>", 0),
    ("scan_carry_kernel<64,64>", 0),
])
def test_static_smem_as_ptxas_places_it(signature, static):
    assert geometry.static_smem(signature) == static


def test_phase29_covers_every_route(monkeypatch):
    """``chip_smoke.py`` phase 29's cases take every route of every
    kernel package, each a case its contract builds."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_test", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, spec.name, cs)
    spec.loader.exec_module(cs)
    seen = {}
    n = 0
    for pkg, case in cs.CONTRACT_CASES:
        _, contract = _port_contract(pkg)
        inst = contract.build(dict(case))
        seen.setdefault(pkg, set()).add(inst.route)
        n += len(inst.launches)
        assert krn.check_instance(contract, case, inst, "x", 1) == []
    for pkg in _REF:
        _, contract = _port_contract(pkg)
        assert seen[pkg] == {contract.build(dict(c)).route
                             for c in contract.cases}, pkg
    assert n == 23


# --- the chip-side checker: ptxas, the trace, and one launch ------------------

_PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN5repro12decode_split19decode_split_kernelILi8ELi96ENS_15ContiguousCacheI13__nv_bfloat16EEEEvPKS3_T1_PKiiPfSA_iiif' for 'sm_90a'
ptxas info    : Function properties for _ZN5repro12decode_split19decode_split_kernelILi8ELi96ENS_15ContiguousCacheI13__nv_bfloat16EEEEvPKS3_T1_PKiiPfSA_iiif
    40 bytes stack frame, 40 bytes spill stores, 40 bytes spill loads
ptxas info    : Used 254 registers, used 1 barriers, 40 bytes cumulative stack size, 36864 bytes smem
ptxas info    : Compile time = 254.161 ms
ptxas info    : Compiling entry function '_ZN5repro19merge_splits_kernelI13__nv_bfloat16NS_12decode_split11HeadRowsOutEEEvPKfS5_iiiT0_' for 'sm_90a'
ptxas info    : Function properties for _ZN5repro19merge_splits_kernelI13__nv_bfloat16NS_12decode_split11HeadRowsOutEEEvPKfS5_iiiT0_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers
"""
_DEMANGLED = {
    "_ZN5repro12decode_split19decode_split_kernelILi8ELi96ENS_15Contiguous"
    "CacheI13__nv_bfloat16EEEEvPKS3_T1_PKiiPfSA_iiif":
    "void repro::decode_split::decode_split_kernel<8, 96, "
    "repro::ContiguousCache<__nv_bfloat16> >(__nv_bfloat16 const*, "
    "repro::ContiguousCache<__nv_bfloat16>, int const*, int, float*, "
    "float*, int, int, int, float)",
    "_ZN5repro19merge_splits_kernelI13__nv_bfloat16NS_12decode_split11Head"
    "RowsOutEEEvPKfS5_iiiT0_":
    "void repro::merge_splits_kernel<__nv_bfloat16, "
    "repro::decode_split::HeadRowsOut>(float const*, float const*, int, "
    "int, int, repro::decode_split::HeadRowsOut)",
}


@pytest.mark.parametrize("name,want", [
    ("void repro::decode_split::decode_split_kernel<2, 128, "
     "repro::PagedCache<__nv_bfloat16> >(__nv_bfloat16 const*, int)",
     "decode_split_kernel<2,128,PagedCache<__nv_bfloat16>>"),
    ("void (anonymous namespace)::decode_attention_kernel<2, 128>(float "
     "const*, float const*)", "decode_attention_kernel<2,128>"),
    ("void repro::mma_tile::(anonymous namespace)::flash_mma_kernel<64, "
     "repro::ContiguousCache<__nv_bfloat16>>(__nv_bfloat16 const*)",
     "flash_mma_kernel<64,ContiguousCache<__nv_bfloat16>>"),
    ("void {anonymous}::linear_scan_kernel<float, 64>(float const*)",
     "linear_scan_kernel<float,64>"),
])
def test_normalize_matches_launch_signatures(name, want):
    assert launches.normalize(name) == want


def test_parse_ptxas_reads_registers_spills_and_smem():
    got = launches.parse_ptxas(_PTXAS, demangler=lambda ns: [
        _DEMANGLED[n] for n in ns])
    split = got[f"decode_split_kernel<8,96,ContiguousCache<{geometry.BF16}>>"]
    assert (split["registers"], split["spill_stores"], split["spill_loads"],
            split["smem"]) == (254, 40, 40, 36864)
    merge = got[f"merge_splits_kernel<{geometry.BF16},HeadRowsOut>"]
    assert (merge["registers"], merge["spill_stores"], merge["smem"]) == \
        (32, 0, 0)


def test_demangle_through_cxxfilt():
    names = list(_DEMANGLED)
    if shutil.which("c++filt") is None:
        with pytest.raises(RuntimeError, match="c\\+\\+filt"):
            launches.demangle(names)
        return
    assert [launches.normalize(n) for n in launches.demangle(names)] == [
        launches.normalize(_DEMANGLED[n]) for n in names]


def _decode_split_instance():
    from repro_torch.kernels.decode_attention.ops import CONTRACTS
    return CONTRACTS[0].build({"b": 8, "s": 2048, "h": 16, "kvh": 8,
                               "d": 128})


def _record(launch, **kw):
    rec = {"name": f"void repro::x::{launch.kernel}<"
                   f"{', '.join(launch.template)}>(int)",
           "ts": 0, "grid": launch.grid, "block": (launch.threads, 1, 1),
           "registers": 108, "smem": launch.smem_bytes(), "args": {}}
    rec.update(kw)
    return rec


def _ptxas(launch, **kw):
    return {"registers": 108, "spill_stores": launch.spill_bytes,
            "spill_loads": 0, "smem": launch.static_smem, **kw}


def test_hold_accepts_the_cards_record():
    inst = _decode_split_instance()
    for ln in inst.launches:
        row, bad = launches.hold(ln, _record(ln), _ptxas(ln))
        assert bad == [], bad
        assert row["registers"] == 108 and row["sources"]["smem"] == "trace"


@pytest.mark.parametrize("rec,ptx,words", [
    (dict(grid=(64, 15, 1)), {}, "grid (64, 15, 1)"),
    (dict(block=(256, 1, 1)), {}, "block (256, 1, 1)"),
    (dict(smem=49152 + 16), {}, "shared memory 49168"),
    ({}, dict(smem=0), "ptxas static shared memory 0"),
    ({}, dict(spill_stores=8), "ptxas spill stores 8"),
    (dict(registers=600), dict(registers=600), "registers x"),
    (dict(registers=100), {}, "100 registers in the trace, 108 in ptxas"),
    (dict(name="void k<1>(int)"), {}, "name 'k<1>'"),
])
def test_hold_reports_each_mismatch(rec, ptx, words):
    ln = _decode_split_instance().launches[0]
    _, bad = launches.hold(ln, _record(ln, **rec), _ptxas(ln, **ptx))
    assert any(words in b for b in bad), bad


def test_hold_takes_registers_from_ptxas_where_the_trace_lacks_them():
    ln = _decode_split_instance().launches[0]
    row, bad = launches.hold(ln, _record(ln, registers=None, smem=None),
                             _ptxas(ln))
    assert bad == []
    assert row["sources"] == {"smem": "ptxas (static only)",
                              "registers": "ptxas"}


def test_kernel_records_and_match(tmp_path):
    inst = _decode_split_instance()
    split, merge = inst.launches
    events = [
        {"cat": "kernel", "ts": 9, "name": _record(merge)["name"],
         "args": {"grid": list(merge.grid), "block": [merge.threads, 1, 1],
                  "registers per thread": 32, "shared memory": 128}},
        {"cat": "kernel", "ts": 5, "name": _record(split)["name"],
         "args": {"grid": list(split.grid), "block": [128, 1, 1],
                  "registers per thread": 108, "shared memory": 49152}},
        {"cat": "kernel", "ts": 1,
         "name": "void at::native::vectorized_elementwise_kernel<4>(int)",
         "args": {}},
        {"cat": "cpu_op", "ts": 0, "name": "aten::empty"},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    recs = launches.kernel_records(str(path))
    assert [r["ts"] for r in recs] == [1, 5, 9]
    got = launches.match(inst.launches, recs)
    assert [launches.normalize(r["name"]) for r in got] == [
        split.signature, merge.signature]
    assert launches.match(inst.launches, recs[:2])[1] is None


# --- Pass 2: device-body purity (PUR) --------------------------------------

_ENGINE = "class ContinuousBatchingEngine:\n"


def _body(code, method="_decode_chunk", args="self, params, state"):
    """A device body ``method`` of a ContinuousBatchingEngine holding
    ``code``."""
    return (_ENGINE + f"    def {method}({args}):\n"
            + textwrap.indent(textwrap.dedent(code), " " * 8))


def _both(tmp_path, jax_src, torch_src):
    """The reference's pass on the JAX snippet, the port's on the torch
    one: (reference findings, port findings)."""
    j = tmp_path / "j"
    t = tmp_path / "t"
    j.mkdir()
    t.mkdir()
    _write_tree(j, "f.py", jax_src)
    (t / "f.py").write_text(torch_src)
    return (ref_pur.run(str(j), subdirs=("f.py",)),
            pur.run(str(t), subdirs=("f.py",)))


class TestPurityRules:
    def test_item_in_device_body_pur001(self, tmp_path):
        ref, out = _both(tmp_path, """
            import jax

            @jax.jit
            def step(x):
                return x.item()
        """, _body("import torch\nreturn state['tok'].item()\n"))
        assert _rules(ref) == _rules(out) == ["PUR001"]
        f = out[0]
        assert f.line == 4 and ".item()" in f.message
        assert "ContinuousBatchingEngine._decode_chunk" in f.message

    def test_override_and_nested_are_device_bodies(self, tmp_path):
        # the reference's "_impl suffix is traced": the port's device
        # bodies reach subclasses' overrides and nested functions
        src = (_ENGINE + "    pass\n\n"
               "class Sharded(ContinuousBatchingEngine):\n"
               "    def _spec_chunk(self, params, dparams, state):\n"
               "        def inner(x):\n"
               "            return float(x)\n"
               "        return float(state['pos'])\n")
        ref, out = _both(tmp_path, """
            def decode_impl(x, n):
                return float(x)
        """, src)
        assert _rules(ref) == ["PUR001"]
        assert _rules(out) == ["PUR001", "PUR001"]
        assert "'float(x)'" in out[0].message or "'float(x)'" in \
            out[1].message

    @pytest.mark.parametrize("code,words", [
        ("return state['tok'].tolist()", ".tolist()"),
        ("return state['tok'].cpu()", ".cpu()"),
        ("return state['tok'].numpy()", ".numpy()"),
        ("return state['tok'].to('cpu')", '.to("cpu")'),
        ("import torch\ntorch.cuda.synchronize()", "synchronize"),
        ("import numpy as np\nreturn np.asarray(state)", "numpy call"),
        ("import time\nt = time.perf_counter()", "wall-clock"),
        ("import torch\nreturn torch.nonzero(state['tok'])",
         "sizes its output"),
        ("n = int(state['remaining'].sum())", "'int("),
        ("x = state['tok'] + 1\nreturn bool(x)", "'bool(x)'"),
    ])
    def test_host_reads_pur001(self, tmp_path, code, words):
        _write_tree(tmp_path, "f.py", _body(code))
        out = pur.run(str(tmp_path), subdirs=("f.py",))
        assert _rules(out) == ["PUR001"]
        assert words in out[0].message

    @pytest.mark.parametrize("code,kind", [
        ("if state['remaining'] > 0:\n    pass", "if"),
        ("active = state['remaining'] > 0\nwhile active.any():\n    pass",
         "while"),
        ("assert state['pos'].max() < 8", "assert"),
        ("x = 1 if state['tok'] else 2", "if"),
    ])
    def test_branch_on_tensor_pur002(self, tmp_path, code, kind):
        ref, out = _both(tmp_path, """
            import jax

            @jax.jit
            def gate(x):
                if x > 0:
                    return x
                return -x
        """, _body(code))
        assert _rules(ref) == _rules(out) == ["PUR002"]
        assert f"Python '{kind}'" in out[0].message
        assert "torch.where" in out[0].hint

    def test_none_presence_branch_not_pur002(self, tmp_path):
        ref, out = _both(tmp_path, """
            import jax

            @jax.jit
            def splice(cache, pages):
                if pages is not None:
                    return cache + pages
                if pages is None:
                    return cache
        """, _body("if state.get('pages') is not None:\n    pass\n"
                   "if params is None:\n    pass"))
        assert ref == out == []

    def test_host_argument_exempt(self, tmp_path):
        # the reference's static_argnames: a parameter annotated as a
        # host value, and one read from self, are not tensors
        ref, out = _both(tmp_path, """
            import jax
            from functools import partial

            @partial(jax.jit, static_argnames=("n",))
            def gate(x, n):
                if n > 4:
                    return x * 2
                return x
        """, _body("if start > 4 and self.chunk_steps:\n    pass\n"
                   "k = self.spec_k\nif k:\n    pass",
                   method="_prefill_chunk",
                   args="self, params, state, chunk, table, start: int"))
        assert ref == out == []

    def test_shape_branch_is_static(self, tmp_path):
        ref, out = _both(tmp_path, """
            import jax

            @jax.jit
            def pad(x):
                if x.shape[0] % 8:
                    return x
                return x * 2
        """, _body("if state['tok'].shape[0] % 8 or len(params):\n"
                   "    pass\nif state['tok'].size(0) > 2:\n    pass"))
        assert ref == out == []

    def test_mutable_default_pur003(self, tmp_path):
        src = """
            import dataclasses

            @dataclasses.dataclass
            class Spec:
                rate: float = 1.0

            @dataclasses.dataclass
            class Meter:
                spec: Spec = Spec()
                tags: list = []
        """
        ref, out = _both(tmp_path, src, textwrap.dedent(src))
        assert _rules(ref) == _rules(out) == ["PUR003", "PUR003"]
        assert "shared 'Spec()' instance" in out[0].message
        assert "default_factory" in out[0].hint

    def test_frozen_default_is_legal(self, tmp_path):
        src = """
            import dataclasses

            @dataclasses.dataclass(frozen=True)
            class Spec:
                rate: float = 1.0

            @dataclasses.dataclass
            class Meter:
                spec: Spec = Spec()
        """
        ref, out = _both(tmp_path, src, textwrap.dedent(src))
        assert ref == out == []

    def test_draw_without_generator_pur004(self, tmp_path):
        """PUR004 in the port: a random draw from the global generator
        (the reference's PUR004, a PRNG key reused, has no counterpart
        in PyTorch's stateful generators), anywhere in the tree."""
        ref, out = _both(tmp_path, """
            import jax

            def init(key):
                a = jax.random.normal(key, (4,))
                b = jax.random.normal(key, (4,))
                return a, b
        """, textwrap.dedent("""
            import torch

            def init(shape, t):
                a = torch.randn(shape)
                t.normal_(0.0, 1.0)
                return a
        """))
        assert _rules(ref) == ["PUR004"]
        assert _rules(out) == ["PUR004", "PUR004"]
        assert "generator=" in out[0].message
        assert sorted(f.line for f in out) == [5, 6]

    def test_draws_with_a_generator_ok(self, tmp_path):
        ref, out = _both(tmp_path, """
            import jax

            def init(key):
                a = jax.random.normal(key, (4,))
                key = jax.random.split(key)[0]
                b = jax.random.normal(key, (4,))
                return a, b
        """, textwrap.dedent("""
            import torch

            def init(shape, t, gen):
                a = torch.randn(shape, generator=gen)
                t.uniform_(-1, 1, generator=gen)
                return torch.multinomial(a, 1, generator=gen)
        """))
        assert ref == out == []

    def test_side_effects_pur005(self, tmp_path):
        """PUR005 in the port: a Python side effect in a device body that
        a CUDA-graph replay would skip (the reference's: one in a
        ``fori_loop`` body, run once at trace time)."""
        ref, out = _both(tmp_path, """
            import jax

            def scanit(xs, out):
                def body(i, c):
                    print(i)
                    out.append(c)
                    return c + 1
                return jax.lax.fori_loop(0, 4, body, 0)
        """, _body("""
            import logging
            print(state)
            self.log.append(1)
            self.decode_steps += 8
            count_launch(self)
            logging.info('chunk')
            mine = []
            mine.append(state)
        """))
        assert _rules(ref) == ["PUR005", "PUR005"]
        assert _rules(out) == ["PUR005"] * 5
        msgs = " ".join(f.message for f in out)
        for words in ("'print'", "'.append' on 'self.log'",
                      "'self.decode_steps += ...'", "'count_launch'",
                      "logging call"):
            assert words in msgs
        assert "'mine'" not in msgs        # a list the body made

    def test_global_write_pur005(self, tmp_path):
        _write_tree(tmp_path, "f.py", _body("global N\nN = 1"))
        out = pur.run(str(tmp_path), subdirs=("f.py",))
        assert _rules(out) == ["PUR005"]
        assert "'global' write" in out[0].message

    def test_declared_device_bodies_exist(self):
        """Every declared device body, and every port counterpart of a
        reference ``_impl`` body, exists by its qualified name; every
        ``_impl`` of the reference's serving engines is listed."""
        def quals(path):
            tree = ast.parse(open(os.path.join(ROOT, path)).read())
            out = set()
            for cls in tree.body:
                if isinstance(cls, ast.ClassDef):
                    out |= {f"{cls.name}.{f.name}" for f in cls.body
                            if isinstance(f, ast.FunctionDef)}
            return out

        for path, qual in pur.DEVICE_BODIES:
            assert qual in quals(path), qual
        listed = set()
        for ref, port, status in pur.REFERENCE_BODIES:
            rpath, rqual = ref.split(":")
            ppath, pqual = port.split(":")
            assert rqual in quals(rpath), ref
            assert pqual in quals(ppath), port
            assert (status == "device") == ((ppath, pqual)
                                            in pur.DEVICE_BODIES), port
            assert status == "device" or status.startswith("exempt: ")
            listed.add(ref)
        for path in ("src/repro/serving/engine.py",
                     "src/repro/serving/sharded.py",
                     "src/repro/serving/disagg.py"):
            impls = {f"{path}:{q}" for q in quals(path)
                     if q.endswith("_impl")}
            assert impls <= listed, impls - listed

    def test_live_device_bodies_report_the_chunk_counters(self):
        out = pur.run(ROOT)
        assert [(f.rule, f.obj) for f in out] == [
            ("PUR005", "ContinuousBatchingEngine._decode_chunk"),
            ("PUR005", "ContinuousBatchingEngine._spec_chunk")]
        src = open(os.path.join(ROOT, out[0].path)).read().splitlines()
        assert "self.decode_steps += self.chunk_steps" in \
            src[out[0].line - 1]


# --- Pass 3: units (UNT), the reference's snippets through both passes -----

_UNIT_SNIPPETS = {
    "watts_plus_joules": """
        def total(watts, joules):
            return watts + joules
    """,
    "ms_vs_s": """
        def clipped(t_ms, start_s):
            return t_ms >= start_s
    """,
    "energy_from_mean_watts": """
        import numpy as np

        def report(watts):
            energy_j = np.mean(watts)
            return energy_j
    """,
    "kwarg_mismatch": """
        def go(t_ms, measure):
            measure(duration_s=t_ms)
    """,
    "return_mismatch": """
        def delay_s(backoff_ms):
            return backoff_ms
    """,
    "correct_algebra": """
        import numpy as np

        SLO_S = 5.0
        TARGET_QPS = 200.0

        def summarize(watts, window_s, t_ms, sample_hz):
            energy_j = float(np.trapezoid(watts, t_ms / 1e3))
            avg_w = energy_j / max(window_s, 1e-12)
            period_s = 1.0 / sample_hz
            tok_per_j = 4096.0 / energy_j
            deadline_ms = SLO_S * 1e3
            return energy_j, avg_w, period_s, tok_per_j, deadline_ms
    """,
    "through_locals": """
        import numpy as np

        def report(watts):
            avg = np.mean(watts)
            energy_j = avg
            return energy_j
    """,
    "per_name": """
        def eff(tok_per_j, energy_j):
            watts = tok_per_j * energy_j
            return watts
    """,
    "joules_plus_wh": """
        def total(energy_j, energy_wh):
            return energy_j + energy_wh
    """,
    "kwh_conversion": """
        def bill(energy_j, energy_wh):
            energy_kwh = energy_j / 3.6e6
            back_j = energy_wh * 3.6e3
            return energy_kwh, back_j
    """,
    "gco2_from_kwh": """
        def footprint(energy_kwh, intensity_gco2_per_kwh):
            emitted_gco2 = energy_kwh * intensity_gco2_per_kwh
            return emitted_gco2
    """,
    "gco2_from_joules": """
        def footprint(energy_j, intensity_gco2_per_kwh):
            emitted_gco2 = energy_j * intensity_gco2_per_kwh
            return emitted_gco2
    """,
    "intensity_as_grams": """
        def emitted_gco2(intensity_gco2_per_kwh):
            return intensity_gco2_per_kwh
    """,
    "kwh_kwarg": """
        def go(energy_j, bill):
            bill(energy_kwh=energy_j)
    """,
}
_UNIT_RULES = {
    "watts_plus_joules": ["UNT001"], "ms_vs_s": ["UNT001"],
    "energy_from_mean_watts": ["UNT002"], "kwarg_mismatch": ["UNT003"],
    "return_mismatch": ["UNT004"], "correct_algebra": [],
    "through_locals": ["UNT002"], "per_name": ["UNT002"],
    "joules_plus_wh": ["UNT001"], "kwh_conversion": [],
    "gco2_from_kwh": [], "gco2_from_joules": ["UNT002"],
    "intensity_as_grams": ["UNT004"], "kwh_kwarg": ["UNT003"],
}


@pytest.mark.parametrize("name", sorted(_UNIT_SNIPPETS))
def test_units_match_the_reference(tmp_path, name):
    _write_tree(tmp_path, "f.py", _UNIT_SNIPPETS[name])
    ref = ref_unt.run(str(tmp_path), subdirs=("f.py",))
    out = unt.run(str(tmp_path), subdirs=("f.py",))
    key = [(f.rule, f.line, f.message, f.hint) for f in out]
    assert key == [(f.rule, f.line, f.message, f.hint) for f in ref]
    assert _rules(out) == _UNIT_RULES[name]


def test_units_walk_the_ports_measurement_stack():
    assert unt.DEFAULT_SUBDIRS == tuple(
        f"src/repro_torch/{d}" for d in ("power", "core", "harness",
                                         "fleet", "benchmarks"))
    assert all(os.path.isdir(os.path.join(ROOT, d))
               for d in unt.DEFAULT_SUBDIRS)
    assert unt.run(ROOT) == []


# --- suppression, baseline, runner, CLI ----------------------------------

class TestFindingModel:
    def test_rules_cover_the_reference_ids(self):
        from repro.analysis.findings import RULES as REF_RULES
        assert set(REF_RULES) | {"KRN006"} == set(RULES)

    def test_fingerprint_is_line_insensitive(self):
        a = Finding("UNT001", "error", "x.py", 10, "msg  here", obj="f")
        b = Finding("UNT001", "error", "x.py", 99, "msg here", obj="f")
        assert a.fingerprint == b.fingerprint
        assert a.format().startswith("x.py:10: UNT001")

    def test_noqa_parsing(self):
        src = ("a = 1\n"
               "b = watts + joules  # repro_torch: noqa[UNT001]\n"
               "c = 2  # repro_torch: noqa\n"
               "d = 3  # repro_torch: noqa[KRN001, PUR002]\n"
               "e = 4  # repro: noqa\n")
        supp = file_suppressions(src)
        assert supp == {2: frozenset({"UNT001"}), 3: None,
                        4: frozenset({"KRN001", "PUR002"})}
        f2 = Finding("UNT001", "error", "x.py", 2, "m")
        f2b = Finding("UNT002", "error", "x.py", 2, "m")
        f3 = Finding("PUR004", "error", "x.py", 3, "m")
        f5 = Finding("PUR004", "error", "x.py", 5, "m")
        assert is_suppressed(f2, supp)
        assert not is_suppressed(f2b, supp)      # wrong rule listed
        assert is_suppressed(f3, supp)           # bare form: any rule
        assert not is_suppressed(f5, supp)       # the reference's marker

    def test_inline_suppression_end_to_end(self, tmp_path):
        _write_tree(tmp_path, "f.py", """
            def total(watts, joules):
                return watts + joules  # repro_torch: noqa[UNT001]
        """)
        assert run_all(str(tmp_path), rules=("UNT",)) == []

    def test_baseline_roundtrip_and_justification(self, tmp_path):
        path = str(tmp_path / "baseline.json")
        f = Finding("UNT001", "error", "x.py", 3, "watts + joules")
        save_baseline(path, [f])
        base = load_baseline(path)
        assert base[f.fingerprint]["justification"] == UNREVIEWED
        base[f.fingerprint]["justification"] = "legacy scalar API"
        with open(path, "w") as fh:
            json.dump({"version": 1, "findings": base}, fh)
        save_baseline(path, [f], previous=load_baseline(path))
        assert (load_baseline(path)[f.fingerprint]["justification"]
                == "legacy scalar API")

    def test_gate_both_directions(self):
        old = Finding("UNT001", "error", "x.py", 3, "old finding")
        new = Finding("UNT002", "error", "y.py", 7, "new finding")
        baseline = {old.fingerprint: {"rule": "UNT001", "path": "x.py",
                                      "justification": "known"}}
        got_new, stale = gate([old, new], baseline)
        assert [f.fingerprint for f in got_new] == [new.fingerprint]
        assert stale == []
        got_new, stale = gate([new], baseline)
        assert stale == [old.fingerprint]

    def test_committed_baseline_is_justified(self):
        base = load_baseline(BASELINE)
        assert len(base) == 2
        for fp, entry in base.items():
            assert entry["rule"] == "PUR005"
            assert entry["justification"].startswith(
                "counted per replay by ROADMAP A.3")


class TestCLI:
    def _cli(self, *args, cwd=ROOT):
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis", *args],
            capture_output=True, text=True, env=env, cwd=cwd)

    def test_live_repo_is_clean_under_fail_on_new(self):
        r = self._cli("--fail-on-new")
        assert r.returncode == 0, r.stdout + r.stderr
        assert "0 new, 2 baselined; 0 stale" in r.stdout
        assert "engine.py:613: PUR005" in r.stdout

    def test_unknown_rule_prefix_is_usage_error(self):
        r = self._cli("--rules", "XYZ")
        assert r.returncode == 2
        assert "unknown rule prefix" in r.stderr

    def test_outside_the_repo_is_usage_error(self, tmp_path):
        r = self._cli(cwd=str(tmp_path))
        assert r.returncode == 2
        assert "no src/repro_torch found" in r.stderr

    def test_new_finding_fails_gate_with_hint(self, tmp_path):
        core = tmp_path / "src" / "repro_torch" / "core"
        core.mkdir(parents=True)
        _write_tree(core, "bad.py", """
            def total(watts, joules):
                return watts + joules
        """)
        r = self._cli("--root", str(tmp_path), "--rules", "UNT",
                      "--baseline", str(tmp_path / "b.json"),
                      "--fail-on-new")
        assert r.returncode == 1
        assert "UNT001" in r.stdout
        assert "--update-baseline" in r.stderr
        assert "repro_torch: noqa[RULE]" in r.stderr

    def test_update_baseline_then_gate_passes_then_stale_fails(
            self, tmp_path):
        core = tmp_path / "src" / "repro_torch" / "core"
        core.mkdir(parents=True)
        bad = _write_tree(core, "bad.py", """
            def total(watts, joules):
                return watts + joules
        """)
        baseline = str(tmp_path / "b.json")
        common = ("--root", str(tmp_path), "--rules", "UNT",
                  "--baseline", baseline)
        r = self._cli(*common, "--update-baseline")
        assert r.returncode == 0 and "1 finding" in r.stdout
        assert UNREVIEWED.split(" ")[0] in open(baseline).read()
        r = self._cli(*common, "--fail-on-new")
        assert r.returncode == 0, r.stdout + r.stderr
        os.unlink(bad)
        r = self._cli(*common, "--fail-on-new")
        assert r.returncode == 1
        assert "no longer fire" in r.stderr
        assert "stale:" in r.stderr

    def test_out_writes_findings_json(self, tmp_path):
        out = str(tmp_path / "findings.json")
        r = self._cli("--rules", "PUR", "--out", out)
        assert r.returncode == 0
        data = json.load(open(out))
        assert [f["rule"] for f in data["findings"]] == ["PUR005"] * 2
        assert len(data["baseline"]) == 2


# --- the meta-test: the whole live tree, all three passes ----------------

def test_live_tree_is_clean():
    """Every finding in the port is fixed or baselined with a reason;
    run_all over the real tree against the committed baseline comes back
    empty."""
    findings = run_all(ROOT)
    new, stale = gate(findings, load_baseline(BASELINE))
    assert new == [], "\n".join(f.format() for f in new)
    assert stale == [], stale
