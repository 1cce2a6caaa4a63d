"""The dry-run's collective plan (``launch/specs.py:collective_records``)
against the reference's compiled program, on a (2, 2) mesh of forced
host devices.

The reference side compiles ``build_cell`` (``make_train_step`` under
``make_rules(cfg, mesh, "train")``, or the prefill step) for each cell
of ``CELLS`` at two depths, remat as the cell says ("none": remat off),
layers unrolled, at 8 x 64, in one subprocess, and counts each
collective of the HLO text by (kind, operand shape): an all-to-all once
(one peer's piece of its tuple), an all-reduce once an operand (the
compiler combines independent ones into tuples).  One layer's (one
hybrid superblock's) collectives are the difference of the two depths.
The port's side counts the plan's records the same way
(``Collective.shape``).  A cell's arch may carry ``@h<H>k<K>``: the
reduced config with H query and K KV heads, for the attention layouts
the reduced configs' own 4 and 2 heads do not reach.

The comparison covers the layer's activations: the collectives whose
operand holds the layer's tokens (the local batch leading, rank 3 or
more, not a weight: an operand that a chain of bitcasts, copies,
slices and reshapes leads back to a parameter is one) and the MoE
``shard_map``'s capacity buffers.  There the plan follows the
reference's ``seq_sp`` (Megatron sequence parallelism): every block's
input and output split over the sequence, the attention's layout by how
its KV heads meet the model axis (``_gqa_variant``), a Mamba mixer's
input gathered, its (x, z) split by collective-permutes, ``x_proj``'s
partial (dt, B, C) all-reduced, the scan resharded in the backward pass,
the FFN run on the sequence shard with its weights whole
(``specs.py``'s ``_GQA``, ``_MLA``, ``_MAMBA``).  The layouts were read
from this mesh's programs (and ``kv_part`` from a (2, 4) one);
``tests/test_torch_collective_plan_mesh24.py`` holds them at (2, 4) and
at (2, 8), which none was read from, and
``tests/test_torch_collective_plan_real.py`` at the dry-run's own cells.

The weights' collectives (their gathers, gradient reductions and the
optimizer's norms) are the plan's own rule, whole leaves gathered over
their ``fsdp`` and router axes, not the program's per-product choices:
ROADMAP §C.5.  Their wire bytes are printed beside the program's.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from collections import Counter

import pytest

from repro_torch.configs import SHAPES, get_config, reduce_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.roofline import collective_bytes
from repro_torch.launch.specs import build_cell

ROOT = os.path.join(os.path.dirname(__file__), "..")
TIMEOUT_S = 600
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
# (arch, step, remat policy) -> the two depths one layer (superblock) is
# the difference of
CELLS = {("qwen3-moe-30b-a3b", "train", "nothing"): (2, 3),
         ("jamba-v0.1-52b", "train", "nothing"): (8, 16),
         ("deepseek-v3-671b", "train", "nothing"): (2, 3),
         ("qwen3-moe-30b-a3b", "train", "dots"): (2, 3),
         ("qwen3-moe-30b-a3b", "prefill", "nothing"): (2, 3),
         ("jamba-v0.1-52b", "prefill", "nothing"): (8, 16),
         # dense and vlm (their KV heads split with the heads), one KV
         # head, the Mamba mixer under "dots"
         ("qwen3-1.7b", "train", "nothing"): (2, 3),
         ("phi-3-vision-4.2b", "train", "nothing"): (2, 3),
         ("qwen3-1.7b@h4k1", "train", "nothing"): (2, 3),
         ("jamba-v0.1-52b", "train", "dots"): (8, 16),
         # 3 KV heads on 2 devices: the kv_on_seq table where the program
         # takes it; the plan calls the layout unchecked (UNCHECKED)
         ("qwen3-1.7b@h6k3", "train", "nothing"): (2, 3)}
# cells whose layout the plan calls unchecked (``specs.unchecked_layout``):
# with KV heads that neither divide nor are divided by the model axis
# the program picks kv_on_seq or x_gathered by more than the rule reads
UNCHECKED = {("qwen3-1.7b@h6k3", "train", "nothing")}
BATCH, SEQ = 8, 64

REFERENCE = r'''
import dataclasses, json, math, re, sys
from repro.configs import SHAPES, get_config, reduce_config
from repro.launch.mesh import make_mesh
from repro.launch.roofline import _DTYPE_BYTES as DTYPE_BYTES
from repro.launch.roofline import _group_size, collective_bytes
from repro.launch.specs import build_cell

COLL = re.compile(r"= .*?\b(all-gather|all-reduce|reduce-scatter|"
                  r"all-to-all|collective-permute)(-start)?\(")
THROUGH = ("bitcast", "copy", "convert", "reshape", "transpose", "slice",
           "dynamic-slice", "get-tuple-element")


def parameter_derived(defs, name):
    """Whether a chain of layout-only ops (or a fusion of them and
    constants) leads ``name`` back to a parameter: a weight."""
    for _ in range(16):
        d = defs.get(name, "")
        if " parameter(" in d:
            return True
        m = re.search(r"\b([\w-]+)\((%[\w.\-]+)", d)
        if not m:
            return False
        op = m.group(1)
        if op == "fusion" and "slice" in name:
            args = re.findall(r"(%[\w.\-]+)", d.split("fusion(", 1)[1]
                              .split(")", 1)[0])
            args = [a for a in args if not re.search(
                r"constant|partition-id", defs.get(a, "") + a)]
            if len(args) != 1:
                return False
            name = args[0]
            continue
        if op not in THROUGH:
            return False
        name = m.group(2)
    return False


def wire(kind, size, g):
    """The reference's ``collective_bytes`` cost of one operand."""
    frac = (g - 1) / g
    return {"all-reduce": 2.0 * size * frac, "all-gather": size * frac,
            "reduce-scatter": size * (g - 1), "all-to-all": size * frac,
            "collective-permute": float(size)}[kind]


def count(hlo, batch, n_dev):
    """The activations' collectives by (kind, shape) and their wire
    bytes by kind (an operand at a time: the combiner's tuples mix them
    with the weights' gradients), and every collective's wire bytes by
    kind (``collective_bytes``)."""
    defs = {}
    for line in hlo.splitlines():
        m = re.match(r"\s*(%[\w.\-]+) = (.*)", line)
        if m:
            defs[m.group(1)] = m.group(2)
    acts, act_bytes = {}, {}
    for line in hlo.splitlines():
        m = COLL.search(line)
        if not m or "-done" in line.split("=", 1)[0]:
            continue
        kind = m.group(1)
        res = line[line.index("= "):m.start(1)]
        typed = re.findall(r"(\w+)\[([\d,]*)\]", res)
        shapes = [[int(x) for x in s.split(",") if x] for _, s in typed]
        sizes = [math.prod(s) * DTYPE_BYTES[t]
                 for s, (t, _) in zip(shapes, typed)]
        args = re.findall(r"(%[\w.\-]+)", line[m.end():].split(")", 1)[0])
        g = _group_size(line, n_dev)
        if kind == "all-to-all":         # one exchange, a piece a peer
            shapes, sizes, args = shapes[:1], [sum(sizes)], args[:1]
        for shape, size, arg in zip(shapes, sizes, args):
            if "shard_map/all_to_all" in line:
                act = True
            elif "shard_map" in line:
                act = False
            else:
                act = (len(shape) >= 3 and shape[0] == batch
                       and not parameter_derived(defs, arg))
            if not act or g <= 1:
                continue
            key = f"{kind} {','.join(map(str, shape))}"
            acts[key] = acts.get(key, 0) + 1
            act_bytes[kind] = act_bytes.get(kind, 0.0) + wire(kind, size, g)
    every = collective_bytes(hlo, n_dev)
    every.pop("_counts")
    return dict(acts=acts, bytes=every, act_bytes=act_bytes)


mesh_shape, batch, seq = json.loads(sys.argv[1]), int(sys.argv[2]), \
    int(sys.argv[3])
mesh = make_mesh(tuple(mesh_shape), ("data", "model"))
n_dev = mesh_shape[0] * mesh_shape[1]
b_local = batch // mesh_shape[0]
out = {}
for name, arch, heads, step, pol, depths, full in json.loads(sys.argv[4]):
    base = "train_4k" if step == "train" else "prefill_32k"
    shape = dataclasses.replace(SHAPES[base], seq_len=seq,
                                global_batch=batch)
    for n in depths:
        cfg = dataclasses.replace(
            get_config(arch) if full else reduce_config(get_config(arch)),
            **heads, n_layers=n,
            remat=pol != "none", remat_policy="nothing" if pol == "none"
            else pol, unroll_scans=True, scan_layers=False)
        hlo = build_cell(cfg, shape, mesh).lower().compile().as_text()
        out[f"{name} {step} {pol} {n}"] = count(hlo, b_local, n_dev)
print("XLA", json.dumps(out))
'''


def arch_of(name: str) -> tuple:
    """(arch, the reduced config's head overrides) of a cell's arch."""
    arch, _, heads = name.partition("@h")
    if not heads:
        return arch, {}
    h, k = heads.split("k")
    return arch, dict(n_heads=int(h), n_kv_heads=int(k))


def cell_config(name: str, pol: str, n: int, full: bool = False):
    """The config of a cell's arch at ``n`` layers: reduced, or the
    arch's own widths (``full``)."""
    arch, heads = arch_of(name)
    cfg = get_config(arch) if full else reduce_config(get_config(arch))
    return dataclasses.replace(cfg, **heads, n_layers=n,
                               remat=pol != "none",
                               remat_policy="nothing" if pol == "none"
                               else pol)


def start_reference(mesh_shape, cells, batch=BATCH, seq=SEQ,
                    full=False) -> tuple:
    """The reference's subprocess for ``cells`` on ``mesh_shape`` at
    ``batch`` x ``seq`` (the configs reduced, or at their own widths:
    ``full``), its devices forced, started (``reference_layers`` reads
    it), so that several compile at once."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count="
                         f"{mesh_shape[0] * mesh_shape[1]}")
    arg = [[name, *arch_of(name), step, pol, depths, full]
           for (name, step, pol), depths in cells.items()]
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE),
         json.dumps(list(mesh_shape)), str(batch), str(seq),
         json.dumps(arg)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=ROOT)
    return proc, cells


def reference_layers(*started) -> dict:
    """One layer's program for each cell of one or more
    ``start_reference``: {cell: {"acts": Counter of (kind, shape),
    "bytes": wire bytes by kind, "act_bytes": the activations' wire
    bytes by kind}}."""
    got, cells = {}, {}
    try:
        for proc, part in started:
            stdout, stderr = proc.communicate(timeout=TIMEOUT_S)
            assert proc.returncode == 0, stderr[-4000:]
            got.update(json.loads(stdout.split("XLA ", 1)[1]))
            cells.update(part)
    finally:
        for proc, _ in started:
            proc.kill()
    out = {}
    for cell, (a, b) in cells.items():
        lo, hi = got[" ".join(map(str, (*cell, a)))], \
            got[" ".join(map(str, (*cell, b)))]
        acts = Counter({tuple([k.split()[0], tuple(
            int(x) for x in k.split()[1].split(",") if x)]): v
            for k, v in hi["acts"].items()})
        acts.subtract({tuple([k.split()[0], tuple(
            int(x) for x in k.split()[1].split(",") if x)]): v
            for k, v in lo["acts"].items()})
        out[cell] = dict(
            acts=+acts,
            bytes={k: hi["bytes"].get(k, 0) - lo["bytes"].get(k, 0)
                   for k in KINDS},
            act_bytes={k: hi["act_bytes"].get(k, 0)
                       - lo["act_bytes"].get(k, 0) for k in KINDS})
    return out


def plan_layers(mesh_shape, cells, batch=BATCH, seq=SEQ,
                full=False) -> dict:
    """The same for the port's plan: records with an operand shape are
    the activations'; and each cell's ``Cell.unchecked``."""
    mesh = make_mesh(tuple(mesh_shape), ("data", "model"))
    out = {}
    for (name, step, pol), depths in cells.items():
        base = "train_4k" if step == "train" else "prefill_32k"
        shape = dataclasses.replace(SHAPES[base], seq_len=seq,
                                    global_batch=batch)
        got = []
        for n in depths:
            cell = build_cell(cell_config(name, pol, n, full), shape,
                              mesh)
            acts = [r for r in cell.records if r.shape is not None]
            every = collective_bytes(cell.records, cell.n_devices)
            act_bytes = collective_bytes(acts, cell.n_devices)
            got.append((Counter((r[0], r.shape) for r in acts), every,
                        act_bytes))
        (lo, e0, a0), (hi, e1, a1) = got
        hi.subtract(lo)
        out[(name, step, pol)] = dict(
            acts=+hi, unchecked=cell.unchecked,
            bytes={k: e1.get(k, 0) - e0.get(k, 0) for k in KINDS},
            act_bytes={k: a1.get(k, 0) - a0.get(k, 0) for k in KINDS})
    return out


def print_bytes(cell, ref, plan) -> None:
    for k in KINDS:
        print(f"{' '.join(cell)} {k}: activations program "
              f"{ref['act_bytes'][k]:.0f} plan {plan['act_bytes'][k]:.0f}; "
              f"all program {ref['bytes'][k]:.0f} plan "
              f"{plan['bytes'][k]:.0f} (weights: ROADMAP §C.5)")


def jamba_apart(cells) -> list:
    """``cells`` in two parts, the hybrid's (its two depths are 8 and 16
    layers) and the rest, to compile at once."""
    jamba = {c: d for c, d in cells.items() if c[0].startswith("jamba")}
    return [jamba, {c: d for c, d in cells.items() if c not in jamba}]


@pytest.fixture(scope="module")
def layers():
    started = [start_reference((2, 2), part) for part in jamba_apart(CELLS)]
    plan = plan_layers((2, 2), CELLS)
    return reference_layers(*started), plan


def test_moe_and_mamba_plans_against_the_reference_s_compiled_program(
        layers):
    """C.4's pins, now equalities: a qwen3-moe-30b-a3b layer and a
    jamba-v0.1-52b superblock (4 MoE layers, 7 Mamba mixers) under remat
    "nothing".  The capacity buffers' all-to-alls (E / m x capacity x d
    a peer): 6 a MoE layer in both.  qwen3-moe: the 23 resharding
    all-to-alls and 5 activation all-reduces (B / d, S, d) in both (the
    plan had none and 3).  jamba: 26 activation all-reduces (the plan
    had 35), ``x_proj``'s all-reduces (14 of (dt, B, C), 7 of B and C's
    gradient, 7 of dt's: 3 events and 4 operands a mixer) and 56
    collective-permutes (the plan had none of either)."""
    ref, plan = layers
    q = ("qwen3-moe-30b-a3b", "train", "nothing")
    j = ("jamba-v0.1-52b", "train", "nothing")
    cap = (4, 40, 128)
    for cell, n_moe in ((q, 1), (j, 4)):
        r, p = ref[cell]["acts"], plan[cell]["acts"]
        assert r[("all-to-all", cap)] == p[("all-to-all", cap)] == 6 * n_moe
    for side in (ref, plan):
        qa, ja = side[q]["acts"], side[j]["acts"]
        assert sum(v for k, v in qa.items() if k[0] == "all-to-all"
                   and k[1] != cap) == 23
        assert qa[("all-reduce", (4, 64, 128))] == 5
        assert ja[("all-reduce", (4, 64, 128))] == 26
        assert ja[("all-reduce", (4, 64, 40))] == 14
        assert ja[("all-reduce", (4, 64, 16))] == \
            ja[("all-reduce", (4, 64, 8))] == 7
        assert sum(v for k, v in ja.items()
                   if k[0] == "collective-permute") == 56
    for cell in (q, j):
        assert plan[cell]["acts"] == ref[cell]["acts"]


@pytest.mark.parametrize("cell", list(CELLS), ids=[" ".join(c)
                                                   for c in CELLS])
def test_one_layer_s_layout_changes_equal_the_program_s(layers, cell):
    """One layer's (superblock's) activation collectives by (kind,
    operand shape), and with them their wire bytes by kind, equal the
    reference's compiled program: qwen3-moe-30b-a3b, jamba-v0.1-52b and
    deepseek-v3-671b trained under remat "nothing", qwen3-moe and jamba
    under "dots", both at prefill, qwen3-1.7b and phi-3-vision-4.2b,
    qwen3-1.7b with one KV head and with 3 KV heads of 6 (the kv_on_seq
    table).  The plan calls each checked but the last."""
    ref, plan = layers
    print_bytes(cell, ref[cell], plan[cell])
    assert (plan[cell]["unchecked"] == "") == (cell not in UNCHECKED)
    assert plan[cell]["acts"] == ref[cell]["acts"]
    assert sum(plan[cell]["acts"].values()) > 0
    for k in KINDS:
        assert plan[cell]["act_bytes"][k] == pytest.approx(
            ref[cell]["act_bytes"][k], rel=1e-12), k


def test_unchecked_layout_of_the_dry_run_s_cells():
    """Which of the dry-run's cells (model axis 16) have a plan the
    collective-plan tests do not hold.  Checked: the GQA prefill cells,
    whose layouts (KV heads dividing the axis: granite, qwen2.5, qwen3,
    yi, qwen3-moe; split with it: phi-3-vision) the (2, 8) mesh holds
    held out and ``tests/test_torch_collective_plan_real.py`` at the
    cells' own widths, and jamba's prefill (its attention's kv_part,
    its Mamba mixers' permutes as read at model axes up to 16, in
    shards of 2,048 rows).  Unchecked: every train cell (the backward
    of attention over 4 query chunks), deepseek-v3's prefill (MLA over
    32 chunks), rwkv6's and whisper's (no ``seq_sp`` layout, ROADMAP
    C.5).  Decode has no ``seq_sp``."""
    from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, shape_applicable
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import unchecked_layout
    from repro_torch.models import build_model
    from repro_torch.parallel.sharding import make_rules

    mesh = make_production_mesh()
    flagged = {}
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        model = build_model(cfg, "meta")
        for name, shape in SHAPES.items():
            if not shape_applicable(cfg, shape):
                continue
            rules = make_rules(cfg, mesh, shape.kind)
            why = unchecked_layout(cfg, shape, rules, model)
            if why:
                flagged[(arch, name)] = why
    checked = {(a, "prefill_32k") for a in (
        "granite-3-2b", "qwen2.5-3b", "qwen3-1.7b", "yi-9b",
        "qwen3-moe-30b-a3b", "phi-3-vision-4.2b", "jamba-v0.1-52b")}
    assert set(flagged) == {(a, s) for a in ASSIGNED_ARCHS
                            for s in ("train_4k", "prefill_32k")} - checked
    assert "query chunks" in flagged[("qwen3-1.7b", "train_4k")]
    assert "MLA" in flagged[("deepseek-v3-671b", "prefill_32k")]
    assert "query chunks" in flagged[("jamba-v0.1-52b", "train_4k")]
    assert "Mamba" not in flagged[("jamba-v0.1-52b", "train_4k")]
    assert "C.5" in flagged[("rwkv6-3b", "prefill_32k")]
