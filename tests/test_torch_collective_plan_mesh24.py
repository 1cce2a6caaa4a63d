"""The dry-run's collective plan against the reference's compiled
program at model axes of 4 and 8: a (2, 4) mesh of forced host devices,
and a held-out (2, 8) one.

The same counting as ``tests/test_torch_collective_plan.py``: one
layer's (one superblock's) activation collectives by (kind, operand
shape), an operand at a time, and their wire bytes by kind under the
reference's ``collective_bytes`` cost model, at 8 x 64 unless a cell
says otherwise.

(2, 4) is where the ``kv_part`` layout of ``launch/specs.py`` was read
(KV heads that divide the model axis without filling it: no (2, 2)
program has such heads), from reduced qwen3-moe-30b-a3b, granite-3-2b
and qwen3-1.7b, whose 2 KV heads divide 4; the other layouts, read at
(2, 2), hold here unchanged (KV heads split with the heads, one KV
head, MLA, the MoE capacity buffers, the Mamba mixer's gathers,
reductions and reshards), and at 16 x 256 as at 8 x 64.  (2, 8) is
where no attention layout was read from: every layout the plan calls
checked equals the program there, wire bytes included (``kv_part``'s
gathers run over m / K or K devices, as read at m = 4 where both are
2).

The Mamba mixer's collective-permutes (its (x, z) split and its conv's
halo) change with the model axis; their rule (``_mamba_permutes``) was
read from jamba's programs at model axes of 2, 4, 8 and 16, so here it
is a regression check, not a held-out one.

What does not carry (ROADMAP §C.4): the choice between kv_on_seq and
x_gathered where the KV heads neither divide nor are divided by the
axis (the plan calls it unchecked).
"""
import pytest

import test_torch_collective_plan as plan22

CELLS = {("qwen3-moe-30b-a3b", "train", "nothing"): (2, 3),
         ("jamba-v0.1-52b", "train", "nothing"): (8, 16)}
# more cells on (2, 4): kv_part without a query norm and at prefill,
# KV heads split with the heads, one KV head, MLA, and x_gathered where
# the program takes it (an unchecked layout)
MORE_24 = {("granite-3-2b", "train", "nothing"): (2, 3),
           ("qwen3-1.7b", "prefill", "nothing"): (2, 3),
           ("qwen3-1.7b@h8k4", "train", "nothing"): (2, 3),
           ("qwen3-1.7b@h8k1", "train", "nothing"): (2, 3),
           ("deepseek-v3-671b", "train", "nothing"): (2, 3),
           ("qwen3-1.7b@h24k3", "train", "nothing"): (2, 3)}
# on (2, 4) at 16 x 256: the layouts do not change with the shape
WIDE_24 = {("qwen3-moe-30b-a3b", "train", "nothing"): (2, 3),
           ("deepseek-v3-671b", "train", "nothing"): (2, 3)}
WIDE = (16, 256)
# the held-out (2, 8): kv_part with 2 KV heads (4 devices share one) and
# 4 (2 share one), under "nothing", "dots", remat off and at prefill;
# KV heads split, one KV head, MLA, and jamba under "nothing" and "dots"
CELLS_28 = {("qwen3-moe-30b-a3b@h16k2", "train", "nothing"): (2, 3),
            ("qwen3-moe-30b-a3b@h16k2", "train", "dots"): (2, 3),
            ("qwen3-moe-30b-a3b@h16k2", "prefill", "nothing"): (2, 3),
            ("qwen3-1.7b@h16k4", "train", "none"): (2, 3),
            ("granite-3-2b@h8k2", "train", "nothing"): (2, 3),
            ("qwen3-1.7b@h8k8", "train", "nothing"): (2, 3),
            ("qwen3-1.7b@h8k1", "train", "nothing"): (2, 3),
            ("deepseek-v3-671b@h8k2", "train", "nothing"): (2, 3),
            ("jamba-v0.1-52b@h16k2", "train", "nothing"): (8, 16),
            ("jamba-v0.1-52b@h16k2", "train", "dots"): (8, 16)}
UNCHECKED = {("qwen3-1.7b@h24k3", "train", "nothing")}
CP = "collective-permute"


@pytest.fixture(scope="module")
def layers():
    """{mesh name: (program, plan)} for "24" (``CELLS`` and ``MORE_24``),
    "24 wide" and "28", the reference's subprocesses all started at
    once."""
    runs = {"24": ((2, 4), {**CELLS, **MORE_24}, {}),
            "24 wide": ((2, 4), WIDE_24, dict(batch=WIDE[0], seq=WIDE[1])),
            "28": ((2, 8), CELLS_28, {})}
    started = {name: [plan22.start_reference(mesh, part, **kw)
                      for part in plan22.jamba_apart(cells) if part]
               for name, (mesh, cells, kw) in runs.items()}
    plans = {name: plan22.plan_layers(mesh, cells, **kw)
             for name, (mesh, cells, kw) in runs.items()}
    return {name: (plan22.reference_layers(*started[name]), plans[name])
            for name in runs}


@pytest.mark.parametrize("cell", list(CELLS), ids=[c[0] for c in CELLS])
def test_held_out_mesh_wire_bytes_by_kind(layers, cell):
    """Each kind's wire bytes on (2, 4) equal the program's, for
    qwen3-moe-30b-a3b and jamba-v0.1-52b, jamba's collective-permutes
    included (4,902,912 B a superblock: the (x, z) split's whole and
    half blocks and the conv's halos of 1 to 3 rows); the plan calls
    both cells checked."""
    ref, plan = layers["24"]
    plan22.print_bytes(cell, ref[cell], plan[cell])
    for kind in plan22.KINDS:
        got = ref[cell]["act_bytes"][kind], plan[cell]["act_bytes"][kind]
        print(f"{cell[0]} {kind}: program {got[0]:.0f} plan {got[1]:.0f}")
        assert got[1] == pytest.approx(got[0], rel=1e-12), kind
    if cell[0] == "jamba-v0.1-52b":
        assert ref[cell]["act_bytes"][CP] == 4902912
    assert plan[cell]["unchecked"] == ""


@pytest.mark.parametrize("cell", list(CELLS), ids=[c[0] for c in CELLS])
def test_held_out_mesh_capacity_and_mixer_collectives(layers, cell):
    """What the rule carries to a model axis of 4 exactly: the capacity
    buffers' all-to-alls (E / 4 experts x capacity x d a peer, 6 a MoE
    layer) and, in jamba's superblock, the Mamba mixers' ``x_proj``
    all-reduces (14 of (dt, B, C), 7 each of B and C's and dt's
    gradients), their scan's backward reshards and their collective-
    permutes (per mixer and pass one of whole blocks of (x, z) and three
    of half blocks; halos of 1, 2, 2 and 3 rows one way, 1 and 2 the
    other); every (kind, shape) equal."""
    ref, plan = layers["24"]
    r, p = ref[cell]["acts"], plan[cell]["acts"]
    n_moe = {"qwen3-moe-30b-a3b": 1, "jamba-v0.1-52b": 4}[cell[0]]
    cap = ("all-to-all", (2, 20, 128))
    assert r[cap] == p[cap] == 6 * n_moe
    if cell[0] == "jamba-v0.1-52b":
        for key, n in ((("all-reduce", (4, 64, 40)), 14),
                       (("all-reduce", (4, 64, 16)), 7),
                       (("all-reduce", (4, 64, 8)), 7),
                       (("all-to-all", (4, 1, 16, 64, 16)), 7),
                       (("all-to-all", (4, 16, 1, 64, 16)), 14),
                       (("all-to-all", (4, 16, 1, 128)), 7),
                       ((CP, (4, 64, 128)), 14), ((CP, (4, 64, 64)), 42),
                       ((CP, (4, 1, 256)), 14), ((CP, (4, 2, 256)), 21),
                       ((CP, (4, 3, 256)), 7)):
            assert r[key] == p[key] == n, key
    assert r == p


@pytest.mark.parametrize(
    "mesh,cell", [("24", c) for c in MORE_24] + [("24 wide", c)
                                                 for c in WIDE_24]
    + [("28", c) for c in CELLS_28],
    ids=[f"{m} {' '.join(c)}" for m, cs in (("24", MORE_24),
                                            ("24 wide", WIDE_24),
                                            ("28", CELLS_28)) for c in cs])
def test_layouts_at_model_axes_of_4_and_8(layers, mesh, cell):
    """One layer's activation collectives by (kind, operand shape), and
    their wire bytes by kind, equal the program's for every cell the
    plan calls checked, on (2, 4) at 8 x 64 and 16 x 256 and on (2, 8);
    x_gathered's table where the program takes it, which the plan calls
    unchecked.  jamba on (2, 8), under "nothing" and "dots": every kind,
    its Mamba mixers' collective-permutes included (halos of up to 7
    rows)."""
    ref, plan = layers[mesh]
    plan22.print_bytes(cell, ref[cell], plan[cell])
    r, p = ref[cell]["acts"], plan[cell]["acts"]
    assert (plan[cell]["unchecked"] == "") == (cell not in UNCHECKED)
    assert sum(p.values()) > 0
    assert p == r
    for k in plan22.KINDS:
        assert plan[cell]["act_bytes"][k] == pytest.approx(
            ref[cell]["act_bytes"][k], rel=1e-12), k
