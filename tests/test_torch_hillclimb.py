"""The hillclimb's options and its ``main`` in the port against the
reference, on the CPU.

- ``flash_attention_plain`` with ``triangular`` and ``bf16_scores``
  against the reference's ``flash_attention_jnp(unroll=True, ...)``
  (whose unrolled loop is the one that skips blocks): queries longer
  than a chunk, a ragged last chunk, causal and bidirectional; float32
  within 1e-4, bf16 scores within 2e-2 (``tests/test_kernels.py:16``);
  triangular visits only the blocks at or below the diagonal;
- reduced qwen3-1.7b's ``train_loss`` and every gradient leaf under
  ``causal_skip`` + ``attn_bf16_scores`` (chunks of 8 over 32 tokens)
  and under ``remat_policy="dots"`` against the reference's loss and
  ``jax.grad`` on bridged weights (loss 1e-5 relative and gradients
  1e-4 x their max in float32, as tests/test_torch_train_lm.py; with
  bf16 scores 1e-3 and 2e-2 x max: the reference's own bf16 gradients
  lie 1.8e-2 x max from its float32 ones there);
- the counted train cell under "dots" has fewer FLOPs and more temp
  bytes than under "nothing", and its collectives follow
  ``launch/specs.py:collective_records``'s rule (5 / 4 / 4 activation
  all-reduces a layer under "nothing" / "dots" / no remat, the
  all-gathers kept under "dots"),
  which the reference's compiled program shows (granite-3-2b on 8
  forced host devices, in a subprocess);
  the selective-checkpoint modes nest under ``OpCount`` on ``meta``;
- ``CELLS`` and ``build_overrides`` equal the reference's (archs,
  shapes, tags, overrides; each hypothesis starts with the reference's
  text); ``_rebase_uncalibrated`` equals the reference's within 1e-12
  under a chip equal to ``TPU_V5E`` field for field;
- ``main`` on cell B writes its tagged records, each within 1e-9 of
  base (the port counts the prefill by the flash kernel's formula), and
  cell C's first iteration lowers the memory term.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import hw as jhw
from repro.launch import hillclimb as jhill
from repro.models import layers as jlayers
from repro_torch import hw as thw
from repro_torch.configs import SHAPES, get_config, reduce_config
from repro_torch.kernels.flash_attention.ops import flash_attention_plain
from repro_torch.launch import dryrun
from repro_torch.launch import hillclimb as thill
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.specs import build_cell, collective_records, count_cell

from test_torch_train_lm import (assert_grads_close, batch_np, port,
                                 reference)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL, BF16_TOL = 1e-4, 2e-2


def _qkv(b, sq, skv, h, kvh, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, skv, kvh, d)).astype(np.float32),
            rng.standard_normal((b, skv, kvh, d)).astype(np.float32))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,chunk", [(96, 32), (100, 32), (40, 64)])
def test_plain_flash_options_match_the_reference(sq, chunk, causal, bf16):
    """Sq 96 in three chunks, Sq 100 with a ragged last chunk of 4 (the
    reference pads it), and Sq 40 inside one chunk; G 2.  Causal and
    ragged, the reference's triangular loop raises (its padded last
    chunk's mask spans past the keys), so the port is held there to the
    reference's full loop, which computes the same function."""
    q, k, v = _qkv(2, sq, sq, 4, 2, 16)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    kw = dict(causal=causal, chunk=chunk, unroll=True, bf16_scores=bf16)
    ragged_causal = causal and sq % chunk and sq > chunk
    if ragged_causal:
        with pytest.raises(TypeError, match="broadcasting"):
            jlayers.flash_attention_jnp(*args, triangular=True, **kw)
    want = np.asarray(jlayers.flash_attention_jnp(
        *args, triangular=not ragged_causal, **kw))
    got = flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, chunk=chunk, triangular=True,
        bf16_scores=bf16).numpy()
    tol = BF16_TOL if bf16 else F32_TOL
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    plain = flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, chunk=chunk).numpy()
    np.testing.assert_allclose(got, plain, rtol=tol, atol=tol)


def test_triangular_visits_only_blocks_below_the_diagonal():
    """At S 4,096 and chunk 1,024 the causal score tensors hold 10 of
    the 16 (q chunk, KV chunk) blocks: the counted bmm FLOPs fall to
    10/16 of the full loop's."""
    from repro_torch.launch.opcount import OpCount
    q = torch.empty((1, 4096, 2, 8), device="meta")
    k = v = torch.empty((1, 4096, 1, 8), device="meta")
    flops = {}
    for tri in (False, True):
        with OpCount() as oc:
            flash_attention_plain(q, k, v, causal=True, chunk=1024,
                                  triangular=tri)
        flops[tri] = oc.by_op["aten::bmm"][1]
    assert flops[True] * 16 == flops[False] * 10


@pytest.mark.parametrize("opts,tol", [
    (dict(causal_skip=True, attn_chunk=8), None),
    (dict(causal_skip=True, attn_bf16_scores=True, attn_chunk=8), BF16_TOL),
    (dict(remat=True, remat_policy="dots"), None),
])
def test_train_loss_and_grads_under_the_options(opts, tol):
    """Reduced qwen3-1.7b, 2 x 32 tokens, bridged weights; the
    reference's scans unrolled (its triangular loop is the unrolled
    one)."""
    arch = "qwen3-1.7b"
    bn = batch_np(reduce_config(get_config(arch)), s=32)
    loss, _, grads, params = reference(arch, bn, unroll_scans=True, **opts)
    got, _, tgrads = port(arch, params, bn, **opts)
    if tol is None:
        assert abs(got - loss) <= 1e-5 * abs(loss)
        assert_grads_close(tgrads, grads)
    else:
        assert abs(got - loss) <= 1e-3 * abs(loss)
        _grads_within(tgrads, grads, tol)


def _grads_within(got, want, tol, path=""):
    if isinstance(want, dict):
        for k in want:
            _grads_within(got[k], want[k], tol, f"{path}/{k}")
        return
    g = got.detach().float().numpy()
    scale = float(np.abs(want).max())
    assert float(np.abs(g - want).max()) <= tol * max(scale, 1e-12), path


def test_dots_saves_products_and_drops_only_the_recomputed_all_reduces():
    """A train cell counted on meta (qwen3-1.7b, 2 layers, 4 x 1,024):
    "dots" fewer FLOPs (no recomputed 2-D product) and more temp bytes
    (the products kept) than "nothing".  On a (2, 4) mesh a layer's
    activation all-reduces in the plan fall from 5 to 4 (3 layers' less
    2 layers'), and its all-gathers and reduce-scatters stay."""
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=1024,
                                global_batch=4)
    counts, colls = {}, {}
    mesh = make_mesh((2, 4), ("data", "model"))
    for pol in ("nothing", "dots"):
        cfg = get_config("qwen3-1.7b", n_layers=2, remat_policy=pol)
        oc, _ = count_cell(build_cell(cfg, shape, None))
        counts[pol] = oc
        cell = build_cell(cfg, shape, mesh)
        colls[pol] = cell.records
    assert counts["dots"].flops < counts["nothing"].flops
    assert counts["dots"].temp_bytes > counts["nothing"].temp_bytes
    mm = {p: sum(v[1] for k, v in counts[p].by_op.items()
                 if k in ("aten::mm", "aten::addmm"))
          for p in counts}
    assert mm["dots"] < mm["nothing"]

    def kinds(records):
        out = {}
        for kind, nbytes, group in records:
            out[kind] = out.get(kind, 0) + 1
        return out

    n, d = kinds(colls["nothing"]), kinds(colls["dots"])
    assert d["all-gather"] == n["all-gather"] > 0
    assert d["reduce-scatter"] == n["reduce-scatter"] > 0
    assert [_layer_all_reduces("qwen3-1.7b", shape, mesh, pol=pol)
            for pol in ("nothing", "dots")] == [5, 4]


def _layer_all_reduces(arch, shape, mesh, pol="nothing", remat=True):
    """One layer's activation all-reduces in the plan: 3 layers' less
    2 layers'."""
    n = []
    for layers in (2, 3):
        cfg = get_config(arch, n_layers=layers, remat=remat,
                         remat_policy=pol)
        n.append(sum(r[0] == "all-reduce"
                     for r in build_cell(cfg, shape, mesh).records))
    return n[1] - n[0]


def test_collective_rule_without_remat_matches_dots_for_all_reduces():
    """The rule's other side: without remat the plan has as many
    activation all-reduces as under "dots" and half the parameter
    all-gathers of "nothing" (the records without an activation's
    operand shape: since the plan follows ``seq_sp`` it also gathers
    activations, which the rule for weights does not count)."""
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=1024,
                                global_batch=4)
    mesh = make_mesh((2, 4), ("data", "model"))
    got = {}
    for over in (dict(remat=False), dict(remat_policy="dots"),
                 dict(remat_policy="nothing")):
        cfg = get_config("granite-3-2b", n_layers=2, **over)
        cell = build_cell(cfg, shape, mesh)
        recs = collective_records(cfg, shape, cell.rules, cell.model,
                                  cell.model.param_defs())
        got[tuple(over.items())] = [r[0] for r in recs if r.shape is None
                                    or r[0] == "all-reduce"]
    no, dots, nothing = got.values()
    assert no.count("all-reduce") == dots.count("all-reduce")
    assert 2 * no.count("all-gather") == nothing.count("all-gather") \
        == dots.count("all-gather") > 0


def test_the_dots_rule_is_the_reference_s_compiled_program():
    """``collective_records``' rule for "dots", read from the
    reference's compiled train step: granite-3-2b at train_4k on a
    (2, 4) host mesh (8 forced host devices, in a subprocess), 2 and 3
    layers unrolled, so that one layer's collectives are the difference.
    A layer's activation all-reduces (operands of the per-device
    activation's shape, the combiner's tuples unpacked): 5 under
    "nothing", 4 under "dots", 4 without remat.  Its all-gathered
    elements under "dots" stay within 1 % of "nothing"'s (the weights
    are gathered again), 1.4x and more those without remat.  The port's
    plan (``collective_records``) counts the same all-reduces a layer."""
    code = """
        import json, math, re
        from repro.configs import get_config, SHAPES
        from repro.launch.calibrate import _variant
        from repro.launch.mesh import make_mesh
        from repro.launch.specs import build_cell
        out = {}
        for name, over in (("nothing", {}), ("dots", {"remat_policy": "dots"}),
                           ("none", {"remat": False})):
            for n in (2, 3):
                cfg = _variant(get_config("granite-3-2b"), n_layers=n, **over)
                hlo = build_cell(cfg, SHAPES["train_4k"], make_mesh(
                    (2, 4), ("data", "model"))).lower().compile().as_text()
                ar = ag = 0
                for line in hlo.splitlines():
                    m = re.search(r"=\\s*(.+?)\\s+(all-reduce|all-gather)"
                                  r"(-start)?\\(", line)
                    if not m:
                        continue
                    for t in re.findall(r"\\w+\\[([\\d,]*)\\]", m.group(1)):
                        dims = [int(x) for x in t.split(",") if x]
                        if m.group(2) == "all-gather":
                            ag += math.prod(dims)
                        elif dims[-2:] == [4096, 2048]:
                            ar += 1
                out[f"{name} {n}"] = (ar, ag)
        print("XLA", json.dumps(out))
    """
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=600,
                       env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    got = json.loads(r.stdout.split("XLA ", 1)[1])
    layer = {name: [b - a for a, b in zip(got[f"{name} 2"], got[f"{name} 3"])]
             for name in ("nothing", "dots", "none")}
    print(layer)
    assert [layer[n][0] for n in ("nothing", "dots", "none")] == [5, 4, 4]
    mesh = make_mesh((2, 4), ("data", "model"))
    assert [_layer_all_reduces("granite-3-2b", SHAPES["train_4k"], mesh,
                               pol=pol, remat=remat)
            for pol, remat in (("nothing", True), ("dots", True),
                               ("nothing", False))] == [5, 4, 4]
    assert abs(layer["dots"][1] / layer["nothing"][1] - 1) <= 0.01
    assert layer["dots"][1] >= 1.4 * layer["none"][1]


def test_cells_and_overrides_equal_the_reference():
    assert list(thill.CELLS) == list(jhill.CELLS)
    for cid, ref in jhill.CELLS.items():
        got = thill.CELLS[cid]
        assert (got["arch"], got["shape"]) == (ref["arch"], ref["shape"])
        assert len(got["iters"]) == len(ref["iters"])
        for (tag, hyp, over), (rtag, rhyp, rover) in zip(got["iters"],
                                                         ref["iters"]):
            assert tag == rtag and over == rover
            assert hyp.startswith(rhyp), (cid, tag)
            assert thill.build_overrides(over, got["arch"]) == \
                _as_plain(jhill.build_overrides(rover, ref["arch"]))
    assert thill.iterations() == [(c, t) for c in jhill.CELLS
                                  for t, _, _ in jhill.CELLS[c]["iters"]]


def _as_plain(pair):
    """The reference's overrides with its MoE config as the port's
    (both are frozen dataclasses of the same fields)."""
    from repro_torch.configs.base import MoEConfig
    cfg, hp = pair
    cfg = dict(cfg)
    if "moe" in cfg:
        cfg["moe"] = MoEConfig(**dataclasses.asdict(cfg["moe"]))
    return cfg, hp


def test_rebase_uncalibrated_equals_the_reference(monkeypatch):
    """Under a chip equal to the reference's TPU_V5E field for field."""
    chip = thw.ChipSpec(**dataclasses.asdict(jhw.TPU_V5E))
    assert dataclasses.asdict(chip) == dataclasses.asdict(jhw.TPU_V5E)
    monkeypatch.setattr(thw, "H100_SXM", chip)
    rng = np.random.default_rng(3)
    for _ in range(5):
        base = {k: float(10 ** rng.uniform(8, 14)) for k in (
            "flops", "hbm_bytes", "coll_bytes", "raw_flops",
            "raw_hbm_bytes", "raw_coll_bytes")}
        rec = {k: float(10 ** rng.uniform(8, 14)) for k in (
            "raw_flops", "raw_hbm_bytes", "raw_coll_bytes")}
        rec["notes"] = "x"
        want = jhill._rebase_uncalibrated(dict(rec), base)
        got = thill._rebase_uncalibrated(dict(rec), base)
        assert set(got) == set(want)
        for k, v in want.items():
            if isinstance(v, float):
                assert math.isclose(got[k], v, rel_tol=1e-12), k
            else:
                assert got[k] == v, k


def test_main_writes_cell_b_and_c_opt1_lowers_memory(tmp_path,
                                                       monkeypatch,
                                                       capsys):
    """``main(["--cell", "B"])`` into a fresh results directory counts
    the base and the three tagged records; each equals base within 1e-9
    in every roofline term.  Cell C's opt1, uncalibrated, lowers the
    train cell's memory term and keeps its collective term."""
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    thill.main(["--cell", "B"])
    out = capsys.readouterr().out
    assert "=== cell B: yi-9b / prefill_32k ===" in out
    base = json.load(open(dryrun.cell_path("yi-9b", "prefill_32k", "pod")))
    for tag in ("opt1", "opt2", "opt3"):
        rec = json.load(open(dryrun.cell_path("yi-9b", "prefill_32k",
                                              "pod", tag)))
        assert rec["hypothesis"].startswith("H")
        for k in ("flops", "hbm_bytes", "coll_bytes", "compute_s",
                  "memory_s", "collective_s"):
            assert math.isclose(rec[k], base[k], rel_tol=1e-9), (tag, k)
    c_base = dryrun.run_cell("qwen3-moe-30b-a3b", "train_4k", "pod",
                             verbose=False, calibrate=False)
    c1 = thill.finish_iteration("C", "opt1", thill.count_iteration(
        "C", "opt1", calibrate=False), c_base)
    assert c1["memory_s"] < c_base["memory_s"]
    assert c1["flops"] < c_base["flops"]
    assert c1["coll_bytes"] == c_base["coll_bytes"]
