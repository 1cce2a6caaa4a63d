"""The port's dry-run producers against the reference's, on the CPU.

- ``make_rules`` tables and every leaf of ``param_pspecs``,
  ``train_state_pspecs`` (float32 and int8 moments) and the cache
  pspecs (and the cache's summed per-device bytes) equal the
  reference's on ``jax.sharding.AbstractMesh`` at both production
  meshes, every assigned arch and mode (in-process, no devices);
- ``model_flops_for``, ``analytic_min_bytes`` and ``_depth_plan`` equal
  the reference's exactly for every arch and shape; the cell list equals
  the one built from the reference's ``ASSIGNED_ARCHS``, ``SHAPES`` and
  ``shape_applicable`` (``repro.launch.dryrun`` itself sets
  ``XLA_FLAGS`` at import and is not imported);
- on an 8-device host mesh (a subprocess), granite-3-2b at 4 layers:
  the port's argument bytes per device equal XLA's
  ``memory_analysis().argument_size_in_bytes`` within 0.1 %, its
  matrix-product FLOPs equal XLA's ``dot`` FLOPs exactly and its
  total lies within 0.5-2x of XLA's (unrolled) count less the CPU
  backend's bf16 converts, with the reference's in-place cache write;
- ``opcount``'s matrix-product FLOPs of a reduced dense prefill equal
  2 N T plus the lm head and the attention kernel's term exactly; each
  kernel wrapper's counted work is equal on the plain route (CPU) and
  on ``meta``; ``calibrated_costs`` equals the direct count within
  1e-9 for a reduced dense, MoE, hybrid and encdec config;
- ``python -m repro_torch.launch.dryrun``: ``--list`` prints the cells,
  ``--arch qwen3-1.7b --mesh pod`` writes three reports (calibrated) and
  ``--table`` renders them.
"""
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import textwrap

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs import ASSIGNED_ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as jget
from repro.configs import shape_applicable as j_applicable
from repro.launch import calibrate as jcal
from repro.launch import roofline as jroof
from repro.models import build_model as jbuild
from repro.optim import AdamWConfig as JAdamW
from repro.parallel import sharding as jsh
from repro.train.train_step import TrainHParams as JHP
from repro.train.train_step import train_state_pspecs as j_state_pspecs
from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, get_config, reduce_config
from repro_torch.launch import calibrate, dryrun, roofline
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.opcount import OpCount
from repro_torch.launch.specs import build_cell, count_cell
from repro_torch.models import build_model
from repro_torch.models.param import tree_leaves
from repro_torch.optim import AdamWConfig
from repro_torch.parallel import sharding as tsh
from repro_torch.train.train_step import TrainHParams, train_state_pspecs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}

torch.set_num_threads(1)


def _jleaves(tree) -> list:
    """The reference's PartitionSpec leaves as tuples, in leaf order."""
    return [tuple(p) for p in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))]


def _tleaves(tree) -> list:
    """The port's spec leaves (TrainState/OptState tuples, dicts; None
    entries skipped), in the reference's leaf order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return tree_leaves(tree)
    if hasattr(tree, "_fields"):
        return [x for t in tree for x in _tleaves(t)]
    return [tree]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_rules_and_pspecs_equal_the_reference(arch, mesh_name):
    shape, axes = MESHES[mesh_name]
    jm = AbstractMesh(shape, axes)
    tm = make_production_mesh(multi_pod=mesh_name == "multipod")
    jc, tc = jget(arch), get_config(arch)
    jmod, tmod = jbuild(jc), build_model(tc, "meta")
    for mode in ("train", "prefill", "decode"):
        jr, tr = jsh.make_rules(jc, jm, mode), tsh.make_rules(tc, tm, mode)
        assert tr.table == jr.table, mode
        assert tree_leaves(tsh.param_pspecs(tmod.param_defs(), tr)) == \
            _jleaves(jsh.param_pspecs(jmod.param_defs(), jr)), mode
        assert tree_leaves(tmod.cache_pspecs(tr)) == \
            _jleaves(jmod.cache_pspecs(jr)), mode
    # the decode cell's cache: the same bytes on each device
    cell = build_cell(tc, SHAPES["decode_32k"], tm)
    jps = jax.tree.leaves(jmod.cache_pspecs(jsh.make_rules(jc, jm, "decode")),
                          is_leaf=lambda x: isinstance(x, PartitionSpec))
    jbytes = 0
    for sds, ps in zip(jax.tree.leaves(jmod.cache_specs(128, 32768)), jps):
        n = sds.size * sds.dtype.itemsize
        for ax in jsh._fit_spec(ps, sds.shape, jm):
            if ax is not None:
                n //= jsh._size(jm, ax)
        jbytes += n
    tbytes = sum(tsh.shard_bytes(tuple(t.shape), t.element_size(), s, tm)
                 for t, s in zip(tree_leaves(cell.global_args[1]),
                                 tree_leaves(cell.arg_pspecs[1])))
    assert tbytes == jbytes
    for quant in (False, True):
        jst = j_state_pspecs(jmod, jsh.make_rules(jc, jm, "train"),
                             JHP(adamw=JAdamW(quant_moments=quant)))
        tst = train_state_pspecs(tmod, tsh.make_rules(tc, tm, "train"),
                                 TrainHParams(adamw=AdamWConfig(
                                     quant_moments=quant)))
        assert _tleaves(tst) == _jleaves(jst), quant


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_model_flops_min_bytes_and_depth_plan_equal_the_reference(arch):
    jc, tc = jget(arch), get_config(arch)
    def plain(plan):        # the two packages' config classes differ
        ovs, rows, real = plan
        return ([{k: dataclasses.asdict(v) if dataclasses.is_dataclass(v)
                  else v for k, v in ov.items()} for ov in ovs], rows, real)

    assert plain(calibrate._depth_plan(tc)) == plain(jcal._depth_plan(jc))
    for name in SHAPES:
        for n_dev in (1, 256, 512):
            assert roofline.analytic_min_bytes(tc, SHAPES[name], n_dev) == \
                jroof.analytic_min_bytes(jc, J_SHAPES[name], n_dev)
        assert roofline.model_flops_for(tc, SHAPES[name]) == \
            jroof.model_flops_for(jc, J_SHAPES[name])


def test_cell_list_equals_the_reference():
    assert ASSIGNED_ARCHS == J_ARCHS and list(SHAPES) == list(J_SHAPES)
    want = [(a, s, m) for a in J_ARCHS for s in J_SHAPES
            if j_applicable(jget(a), J_SHAPES[s])
            for m in ("pod", "multipod")]
    assert dryrun.cells() == want
    assert len(want) == 64


_HLO_DEF = re.compile(r"^\s*(?:ROOT )?%(\S+) = \w+\[([0-9,]*)\]\S* "
                      r"([\w-]+)\(([^)]*)\)(.*)$")


def _hlo_flops(hlo: str) -> dict:
    """XLA's FLOPs of a compiled module by kind, from its text: ``dot``
    (2 x result x contracted elements) and ``convert`` (one a result
    element, as ``cost_analysis`` counts an elementwise op)."""
    shapes, out = {}, {"dot": 0, "convert": 0}
    lines = [m for m in map(_HLO_DEF.match, hlo.splitlines()) if m]
    for m in lines:
        shapes[m.group(1)] = [int(d) for d in m.group(2).split(",") if d]
    for m in lines:
        name, _, op, operands, attrs = m.groups()
        if op == "dot":
            lhs = shapes[re.findall(r"%([\w.-]+)", operands)[0]]
            dims = re.search(r"lhs_contracting_dims=\{([0-9,]*)\}", attrs)
            k = math.prod(lhs[int(i)] for i in dims.group(1).split(",") if i)
            out["dot"] += 2 * math.prod(shapes[name]) * k
        elif op == "convert":
            out["convert"] += math.prod(shapes[name])
    return out


def test_argument_bytes_and_flops_against_xla_on_8_devices(tmp_path):
    """granite-3-2b at 4 layers on a (2, 4) host mesh: the reference's
    compiled cells (8 forced host devices, in a subprocess; layers
    unrolled, so that XLA counts each) against the port's count of the
    same cells, in-process, and the same cells on one device.  The port
    writes a decode step's K/V row in place: the reference's
    ``cache_dus`` form of the write (``dynamic_update_slice``), set
    here; its default one-hot write rebuilds the whole cache
    elementwise.

    Argument bytes agree within 0.1 %.  FLOPs, read by kind from the
    compiled HLO: the port's matrix products (``mm``/``bmm``/``addmm``
    and the kernels' own counts) equal XLA's ``dot`` FLOPs exactly, and
    its total lies within 0.5-2x of XLA's total less its
    ``convert``s.  Those are the CPU backend's: it computes no bf16
    arithmetic, so it upcasts every bf16 dot operand (weights, the whole
    KV cache) to f32, and under the mesh it writes the
    sequence-sharded cache (the reference shards ``kv_seq``) by a select
    over the whole shard between two converts, once a layer.  They are
    two thirds of XLA's total for the sharded decode cell, which reads
    about 3x the port's before they are taken out (printed).  The raw
    total is still held within 0.5-2x on the other three cells."""
    code = f"""
        import json
        from repro.configs import get_config, SHAPES
        from repro.launch.calibrate import _variant
        from repro.launch.mesh import make_mesh
        from repro.launch.roofline import cost_analysis_dict
        from repro.launch.specs import build_cell
        cfg = _variant(get_config("granite-3-2b"), n_layers=4,
                       cache_dus=True)
        out = {{}}
        for shape in ("train_4k", "decode_32k"):
            for mesh in (make_mesh((2, 4), ("data", "model")), None):
                compiled = build_cell(cfg, SHAPES[shape],
                                      mesh).lower().compile()
                key = f"{{shape}} {{mesh is None}}"
                with open({str(tmp_path)!r} + "/" + key + ".hlo", "w") as f:
                    f.write(compiled.as_text())
                out[key] = (
                    compiled.memory_analysis().argument_size_in_bytes,
                    cost_analysis_dict(compiled)["flops"])
        print("XLA", json.dumps(out))
    """
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=600,
                       env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    xla = json.loads(r.stdout.split("XLA ", 1)[1])
    cfg = get_config("granite-3-2b", n_layers=4)
    for key, (arg, flops) in xla.items():
        shape, single = key.split()
        mesh = None if single == "True" else make_mesh((2, 4),
                                                       ("data", "model"))
        cell = build_cell(cfg, SHAPES[shape], mesh)
        oc, _ = count_cell(cell)
        with open(tmp_path / f"{key}.hlo") as f:
            kinds = _hlo_flops(f.read())
        mm = sum(v[1] for k, v in oc.by_op.items()
                 if k in ("aten::mm", "aten::bmm", "aten::addmm")) \
            + sum(v[1] for v in oc.kernels.values())
        rest = flops - kinds["convert"]
        print(f"{shape} on {cell.n_devices} device(s): arg bytes a device "
              f"port {cell.arg_bytes} XLA {arg}; flops a device port "
              f"{oc.flops:.6g} XLA {flops:.6g} ({oc.flops / flops:.3f}); "
              f"products port {mm:.6g} XLA dots {kinds['dot']:.6g}; XLA "
              f"converts {kinds['convert']:.6g}, the rest {rest:.6g} "
              f"({oc.flops / rest:.3f})")
        assert abs(cell.arg_bytes - arg) <= 1e-3 * arg, key
        assert mm == kinds["dot"], (key, mm, kinds["dot"])
        assert 0.5 <= oc.flops / rest <= 2.0, key
        if (shape, mesh is None) != ("decode_32k", False):
            assert 0.5 <= oc.flops / flops <= 2.0, key


def test_opcount_matmul_flops_of_a_dense_prefill():
    """2 N T over the blocks' matrices, the lm head on the last token
    and the flash kernel's 4 D a visible pair, exactly."""
    cfg = reduce_config(get_config("qwen3-1.7b"))
    b, s = 2, 96
    shape = dataclasses.replace(SHAPES["prefill_32k"], seq_len=s,
                                global_batch=b)
    cell = build_cell(cfg, shape, None)
    oc, _ = count_cell(cell)
    d, dh, h, kvh, f = (cfg.d_model, cfg.head_dim, cfg.n_heads,
                        cfg.n_kv_heads, cfg.d_ff)
    per_layer = d * h * dh * 2 + 2 * d * kvh * dh + 3 * d * f
    mm = sum(v[1] for k, v in oc.by_op.items()
             if k in ("aten::mm", "aten::bmm", "aten::addmm"))
    attn = cfg.n_layers * 4 * b * h * dh * s * (s + 1) // 2
    assert mm == 2 * per_layer * b * s * cfg.n_layers \
        + 2 * d * cell.model.vp * b
    assert oc.kernels["flash_attention"][:2] == [cfg.n_layers, attn]


def test_replicated_kv_heads_are_projected_in_full_and_attended_by_group():
    """qwen3-1.7b's 8 KV heads on a model axis of 16 (one query head a
    device): the program projects and caches the one KV head its query
    head's group uses, and the other seven heads' projections are
    counted apart, so that the products sum to 2 N T with every KV head
    projected."""
    cfg = get_config("qwen3-1.7b")
    b, s = 16, 64
    shape = dataclasses.replace(SHAPES["prefill_32k"], seq_len=s,
                                global_batch=b)
    cell = build_cell(cfg, shape, make_production_mesh())
    assert (cell.model.cfg.n_heads, cell.model.cfg.n_kv_heads) == (1, 1)
    oc, _ = count_cell(cell)
    d, dh, f = cfg.d_model, cfg.head_dim, cfg.d_ff // 16
    t = b * s // 16
    per_layer = 2 * d * dh + 2 * d * cfg.n_kv_heads * dh + 3 * d * f
    mm = sum(v[1] for k, v in oc.by_op.items()
             if k in ("aten::mm", "aten::bmm", "aten::addmm"))
    apart = oc.by_op["unattended_kv_proj"][1]
    assert apart == cfg.n_layers * 2 * 2 * t * d * (cfg.n_kv_heads - 1) * dh
    assert mm + apart == 2 * per_layer * t * cfg.n_layers \
        + 2 * d * cell.model.vp * (b // 16)


def _kernel_calls(dev):
    """Each wrapper's call at a small shape on ``dev``; decode and
    verify positions at the cache's last rows (what ``meta`` counts)."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.int8_matmul.ops import int8_matmul
    from repro_torch.kernels.linear_scan.ops import linear_scan
    from repro_torch.kernels.paged_decode_attention.ops import (
        paged_decode_attention)
    from repro_torch.kernels.paged_verify_attention.ops import (
        paged_verify_attention)
    from repro_torch.kernels.verify_attention.ops import verify_attention

    bf = torch.bfloat16

    def z(*shape, dtype=bf):
        return torch.zeros(shape, dtype=dtype, device=dev)

    b, s, h, kvh, d, t, ps = 2, 32, 4, 2, 64, 5, 8
    pages = torch.arange(b * 4, dtype=torch.int32,
                         device=dev).view(b, 4)
    return {
        "flash_attention": lambda: flash_attention(
            z(b, s, h, d), z(b, s, kvh, d), z(b, s, kvh, d)),
        "decode_attention": lambda: decode_attention(
            z(b, 1, h, d), z(b, s, kvh, d), z(b, s, kvh, d),
            torch.full((b,), s - 1, dtype=torch.int32, device=dev)),
        "verify_attention": lambda: verify_attention(
            z(b, t, h, d), z(b, s, kvh, d), z(b, s, kvh, d),
            torch.full((b,), s - t, dtype=torch.int32, device=dev)),
        "paged_decode_attention": lambda: paged_decode_attention(
            z(b, 1, h, d), z(b * 4, ps, kvh, d), z(b * 4, ps, kvh, d),
            pages, torch.full((b,), 4 * ps - 1, dtype=torch.int32,
                              device=dev)),
        "paged_verify_attention": lambda: paged_verify_attention(
            z(b, t, h, d), z(b * 4, ps, kvh, d), z(b * 4, ps, kvh, d),
            pages, torch.full((b,), 4 * ps - t, dtype=torch.int32,
                              device=dev)),
        "linear_scan": lambda: linear_scan(
            z(1, 8, 2, 64), z(1, 8, 2, 64), z(1, 8, 2, 64),
            z(1, 8, 2, 64, dtype=torch.float32),
            z(2, 64, dtype=torch.float32)),
        "int8_matmul": lambda: int8_matmul(
            z(4, 16, dtype=torch.int8), z(16, 8, dtype=torch.int8),
            z(4, 1, dtype=torch.float32), z(1, 8, dtype=torch.float32),
            out_dtype=torch.float32),
    }


@pytest.mark.parametrize("name", sorted(_kernel_calls("cpu")))
def test_wrapper_work_is_equal_on_the_plain_route_and_on_meta(name):
    counted = {}
    for dev in ("cpu", "meta"):
        with OpCount() as oc:
            out = _kernel_calls(dev)[name]()
        counted[dev] = oc.kernels
        got = out if isinstance(out, tuple) else (out,)
        assert all(o.device.type == dev for o in got)
    assert counted["cpu"] == counted["meta"]
    assert counted["cpu"][name][0] == 1 and counted["cpu"][name][1] > 0
    # nothing inside the call counts: only the kernel's own entry
    assert list(counted["cpu"]) == [name]


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen3-moe-30b-a3b",
                                  "jamba-v0.1-52b", "whisper-small"])
def test_calibration_equals_the_direct_count(arch):
    cfg = reduce_config(get_config(arch))
    mesh = make_mesh((2, 4), ("data", "model"))
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        shape = dataclasses.replace(SHAPES[name], global_batch=8,
                                    seq_len=64)
        cell = build_cell(cfg, shape, mesh)
        oc, _ = count_cell(cell)
        coll = roofline.collective_bytes(cell.records, cell.n_devices)
        coll.pop("_counts")
        cal = calibrate.calibrated_costs(cfg, shape, mesh)
        for got, want in ((cal.flops, oc.flops), (cal.hbm_bytes, oc.bytes),
                          (cal.coll_bytes, sum(coll.values()))):
            assert abs(got - want) <= 1e-9 * max(want, 1.0), (name, got,
                                                              want)


def test_dryrun_cli_lists_writes_and_renders(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    dryrun.main(["--list"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "total 64 cells"
    assert lines[0].split() == ["granite-3-2b", "train_4k", "pod"]
    dryrun.main(["--arch", "qwen3-1.7b", "--mesh", "pod"])
    names = sorted(os.listdir(tmp_path))
    assert names == [f"qwen3-1.7b__{s}__pod.json"
                     for s in ("decode_32k", "prefill_32k", "train_4k")]
    for n in names:
        with open(tmp_path / n) as f:
            rec = json.load(f)
        assert rec["ok"] and rec["flops"] > 0 and rec["hbm_bytes"] > 0
        assert rec["notes"] == "calibrated" and rec["n_devices"] == 256
    capsys.readouterr()
    dryrun.main(["--arch", "qwen3-1.7b", "--mesh", "pod", "--table"])
    table = capsys.readouterr().out.splitlines()
    assert table[0].split()[:3] == ["arch", "shape", "mesh"]
    assert len(table) == 5 and all("qwen3-1.7b" in ln for ln in table[2:])
