"""The dry-run's collective plan (``launch/specs.py:collective_records``)
for an MoE layer and a Mamba mixer, against the reference's compiled
train step.

The reference side compiles ``build_cell`` (``make_train_step`` under
``make_rules(cfg, mesh, "train")``) for reduced qwen3-moe-30b-a3b at 2
and 3 layers and reduced jamba-v0.1-52b at 8 and 16 layers (one
superblock more), remat "nothing", layers unrolled, at a train shape of
8 x 64 on a (2, 2) mesh of forced host devices, in a subprocess, and
counts each collective by shape in the HLO text (an all-to-all once, an
all-reduce once an operand: the compiler combines independent ones into
tuples): one layer's (one superblock's) collectives are the difference.
The port's side counts the plan's records the same way.

What the compiled program shows (ROADMAP §C, "the collective plan of an
MoE layer and a Mamba mixer", a fault of the plan):

- the capacity buffers' all-to-alls (E / m x capacity x d per peer) run
  6 times a layer: dispatch and combine in the forward, the remat
  recompute and the backward, as the plan counts them;
- the reference also reshards between its sequence-split and head-split
  layouts: 23 more small all-to-alls a qwen3-moe layer, none planned;
- a qwen3-moe layer all-reduces 5 activation-sized operands (B / d, S,
  d), the plan 3; a jamba superblock 26, the plan 35 (the reference
  turns several of them into reduce-scatters and all-gathers);
- a Mamba mixer all-reduces ``x_proj``'s partial (dt, B, C) in the
  forward and the recompute and their gradients in the backward: 21 a
  superblock of 7 mixers, none planned; and its causal conv and its
  sequence-split input take 56 collective-permutes a superblock, none
  planned.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from collections import Counter

from repro_torch.configs import SHAPES, get_config, reduce_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.specs import build_cell

ROOT = os.path.join(os.path.dirname(__file__), "..")
CELLS = {"qwen3-moe-30b-a3b": (2, 3), "jamba-v0.1-52b": (8, 16)}
TIMEOUT_S = 600

REFERENCE = r'''
import dataclasses, json, re, sys
from repro.configs import SHAPES, get_config, reduce_config
from repro.launch.mesh import make_mesh
from repro.launch.specs import build_cell
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64, global_batch=8)
mesh = make_mesh((2, 2), ("data", "model"))
out = {}
for arch, depths in json.loads(sys.argv[1]).items():
    for n in depths:
        cfg = dataclasses.replace(
            reduce_config(get_config(arch)), n_layers=n, remat=True,
            remat_policy="nothing", unroll_scans=True, scan_layers=False)
        hlo = build_cell(cfg, shape, mesh).lower().compile().as_text()
        cnt = {}
        for line in hlo.splitlines():
            m = re.search(r"=\s*(.+?)\s+(all-reduce|all-gather|all-to-all|"
                          r"reduce-scatter|collective-permute)(-start)?\(",
                          line)
            if not m:
                continue
            shapes = re.findall(r"\w+\[([\d,]*)\]", m.group(1))
            if m.group(2) == "all-to-all":
                # one exchange, its tuple holding a piece a peer
                shapes = shapes[:1]
            for t in shapes:
                key = f"{m.group(2)} {t}"
                cnt[key] = cnt.get(key, 0) + 1
        out[f"{arch} {n}"] = cnt
print("XLA", json.dumps(out))
'''

SHAPE = dataclasses.replace(SHAPES["train_4k"], seq_len=64, global_batch=8)
ACT = "4,64,128"          # one data row's activations (B / d, S, d)


def _reference_layers() -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                        json.dumps(CELLS)], capture_output=True, text=True,
                       env=env, cwd=ROOT, timeout=TIMEOUT_S)
    assert r.returncode == 0, r.stderr[-4000:]
    got = json.loads(r.stdout.split("XLA ", 1)[1])
    out = {}
    for arch, (a, b) in CELLS.items():
        lo, hi = Counter(got[f"{arch} {a}"]), Counter(got[f"{arch} {b}"])
        hi.subtract(lo)
        out[arch] = +hi
    return out


def _plan_layers() -> dict:
    """One layer's (superblock's) plan records by kind and bytes."""
    mesh = make_mesh((2, 2), ("data", "model"))
    out = {}
    for arch, (a, b) in CELLS.items():
        counts = []
        for n in (a, b):
            cfg = dataclasses.replace(reduce_config(get_config(arch)),
                                      n_layers=n, remat=True,
                                      remat_policy="nothing")
            counts.append(Counter(r[:2] for r in
                                  build_cell(cfg, SHAPE, mesh).records))
        counts[1].subtract(counts[0])
        out[arch] = +counts[1]
    return out


def test_moe_and_mamba_plans_against_the_reference_s_compiled_program():
    """The capacity all-to-alls match (6 a MoE layer: remat repeats
    both); the activation all-reduces, the resharding all-to-alls, the
    Mamba mixer's ``x_proj`` all-reduces and its collective-permutes do
    not (module docstring): the counts on both sides, pinned."""
    ref, plan = _reference_layers(), _plan_layers()
    act_bytes = 4 * 64 * 128 * 4                 # float32
    cap = {"qwen3-moe-30b-a3b": 1, "jamba-v0.1-52b": 4}
    for arch, n_moe in cap.items():
        r, p = ref[arch], plan[arch]
        # the capacity buffers: (E / m, capacity, d) = (4, 40, 128)
        assert r["all-to-all 4,40,128"] == 6 * n_moe
        assert p[("all-to-all", 8 * 40 * 128 * 4)] == 6 * n_moe
        assert sum(v for k, v in p.items() if k[0] == "all-to-all") == \
            6 * n_moe
    q, j = ref["qwen3-moe-30b-a3b"], ref["jamba-v0.1-52b"]
    resharding = sum(v for k, v in q.items() if k.startswith("all-to-all")
                     and k != "all-to-all 4,40,128")
    assert resharding == 23
    assert q[f"all-reduce {ACT}"] == 5
    assert plan["qwen3-moe-30b-a3b"][("all-reduce", act_bytes)] == 3
    assert j[f"all-reduce {ACT}"] == 26
    assert plan["jamba-v0.1-52b"][("all-reduce", act_bytes)] == 35
    # x_proj: forward and recompute (dt_rank + 2 d_state = 40), backward
    # (B and C's 16, dt's 8), a mixer each
    assert j["all-reduce 4,64,40"] == 14
    assert j["all-reduce 4,64,16"] == j["all-reduce 4,64,8"] == 7
    permutes = sum(v for k, v in j.items()
                   if k.startswith("collective-permute"))
    assert permutes == 56
    assert not any(k[0] == "collective-permute"
                   for k in plan["jamba-v0.1-52b"])
