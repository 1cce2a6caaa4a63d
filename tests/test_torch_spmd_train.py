"""Sharded training of the port on gloo CPU ranks against the
reference's own sharded runs on forced host devices.

The reference side runs in a subprocess with
``--xla_force_host_platform_device_count`` 4 and 8 (as
tests/test_multidevice.py does), on meshes (2, 2) and (2, 4): each
collective under ``shard_map`` (its value and ``jax.grad`` of sum(W *
F(X))), and for reduced qwen3-1.7b and qwen3-moe-30b-a3b the jitted
``value_and_grad`` of ``train_loss`` under ``make_rules(cfg, mesh,
"train")`` (a plain and a ``loss_mask`` batch) and one
``make_train_step(model, hp, rules)`` step with float32 moments, int8
moments and ``microbatches=2``.  Its metrics are read on every device.
The port side runs the same on a ``run_grid`` of 4 and 8 gloo ranks
(``parallel.grid.Grid``) on the same weights (``from_jax``, then
``shard``) and batches (numpy-seeded), and gathers every sharded leaf.
Each side spawns once per mesh (module-scoped fixtures).

At (2, 4) the reduced configs' 2 KV heads do not divide the model axis:
the rules leave them replicated and each rank attends with its query
heads' own KV head.  The MoE layer's capacity is per shard, as in the
reference's ``_moe_shard_map``.

Tolerances: tests/test_torch_train_lm.py's (loss and metrics 1e-5
relative, every gradient leaf 1e-4 x its reference's max |g|); the
collectives exactly but for float32 summation order (1e-6); after one
AdamW step the first and second moments 1e-4 x their max (linear in g)
and the parameters within 0.2 x lr (a step moves a weight by about lr;
where a gradient is near AdamW's eps the update is a ratio of float32
noise); int8 moments within one quantum of their row scale, the bf16
sqrt-space second moment within one bf16 step (2^-7 relative) plus
1e-4 x its max (the gradient's own tolerance).

The reference's ``_moe_shard_map`` returns ``aux`` with ``out_specs=P()``
under ``check_rep=False`` while each data row holds its own ``pmean``:
its devices disagree (ROADMAP §C), its reported loss is device 0's, and
its gradient is that of the mean over devices (``shard_map``'s transpose
divides an unmapped output's cotangent by the mesh size).  The port
computes that mean, and every metric is held to the mean of the
reference's devices' values.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro_torch.parallel.launch import run_grid

ROOT = os.path.join(os.path.dirname(__file__), "..")
MESHES = [(2, 2), (2, 4)]
ARCHS = ["qwen3-1.7b", "qwen3-moe-30b-a3b"]
LR = 1e-3
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
TIMEOUT_S = 600

REFERENCE = r'''
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs import get_config, reduce_config
from repro.launch.mesh import make_mesh
from repro.models import build_model
from repro.models.param import init_params
from repro.optim import AdamWConfig, adamw_init
from repro.parallel.sharding import make_rules, shard_map, sharding_ctx
from repro.train.train_step import TrainHParams, TrainState, make_train_step

D, M, OUT, LR = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], float(sys.argv[4])
mesh = make_mesh((D, M), ("data", "model"))
rng = np.random.default_rng(0)
res = {"collectives": {}, "models": {}}


def np_(t):
    return jax.tree.map(np.asarray, t)


def shards(a):
    return [float(s.data) for s in sorted(a.addressable_shards,
                                          key=lambda s: s.device.id)]


# each collective over one mesh axis: device (d, m) holds block [d, m] of
# a (D, M, k) input, or one copy per row where the input is replicated
full = P("data", "model")
for axis in ("model", "data"):
    n = mesh.shape[axis]
    rep = P("data", None) if axis == "model" else P(None, "model")
    rs = (D, 1) if axis == "model" else (1, M)

    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def run(name, body, ins, outs, x, w, check=True):
        f = shard_map(body, mesh=mesh, in_specs=(ins,), out_specs=outs,
                      check_rep=check)
        g = jax.grad(lambda x: jnp.sum(w * f(x)))(x)
        res["collectives"][(name, axis)] = dict(
            x=x, w=w, y=np.asarray(f(x)), g=np.asarray(g))

    run("reduce_from", lambda x: jax.lax.psum(x, axis), full, rep,
        arr(D, M, 6), arr(*rs, 6))
    run("copy_to", lambda x: jax.lax.pvary(x, axis), rep, full,
        arr(*rs, 6), arr(D, M, 6))
    run("gather", lambda x: jax.lax.all_gather(x, axis, axis=2, tiled=True),
        full, full, arr(D, M, 3), arr(D, M, 3 * n))
    run("split", lambda x: jax.lax.dynamic_slice_in_dim(
        x, jax.lax.axis_index(axis) * 3, 3, axis=2), rep, full,
        arr(*rs, 3 * n), arr(D, M, 3))
    run("gather_rep", lambda x: jax.lax.all_gather(x, axis, axis=2,
                                                   tiled=True),
        full, rep, arr(D, M, 3), arr(*rs, 3 * n), check=False)
    run("all_to_all", lambda x: jax.lax.all_to_all(
        x.reshape(1, 1, n, 2), axis, 2, 2, tiled=True).reshape(1, 1, 2 * n),
        full, full, arr(D, M, 2 * n), arr(D, M, 2 * n))
    x = arr(D, M, 5)
    f = shard_map(lambda x: jax.lax.pmax(x, axis), mesh=mesh,
                  in_specs=(full,), out_specs=rep, check_rep=False)
    res["collectives"][("all_reduce_max", axis)] = dict(x=x, y=np.asarray(f(x)))

for arch, seed in (("qwen3-1.7b", 1), ("qwen3-moe-30b-a3b", 2)):
    cfg = reduce_config(get_config(arch))
    model = build_model(cfg)
    params = init_params(model.param_defs(), jax.random.PRNGKey(seed))
    brng = np.random.default_rng(seed)
    toks = brng.integers(0, cfg.vocab_size, (8, 65))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    mbatch = dict(batch, loss_mask=(brng.random((8, 64)) < 0.7).astype(
        np.float32))
    rules = make_rules(cfg, mesh, "train")

    def loss_fn(p, b):
        with sharding_ctx(rules):
            return model.train_loss(p, b)

    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    out = {"params": np_(params), "batch": batch, "mbatch": mbatch}
    for key, b in (("plain", batch), ("mask", mbatch)):
        (loss, met), g = vg(params, b)
        out[key] = {"loss": shards(loss),
                    "metrics": {k: shards(v) for k, v in met.items()},
                    "grads": np_(g)}
    hps = {"f32": TrainHParams(peak_lr=LR, warmup=0, total_steps=10),
           "int8": TrainHParams(peak_lr=LR, warmup=0, total_steps=10,
                                adamw=AdamWConfig(quant_moments=True)),
           "mb2": TrainHParams(peak_lr=LR, warmup=0, total_steps=10,
                               microbatches=2)}
    for key, hp in hps.items():
        state = TrainState(params, adamw_init(params, hp.adamw),
                           jnp.zeros((), jnp.int32))
        new, met = jax.jit(make_train_step(model, hp, rules))(state, batch)
        out["step_" + key] = {
            "params": np_(new.params), "m": np_(new.opt.m),
            "m_scale": np_(new.opt.m_scale), "v": np_(new.opt.v),
            "metrics": {k: shards(v) for k, v in met.items()}}
    res["models"][arch] = out
with open(OUT, "wb") as f:
    pickle.dump(res, f)
'''


def _port_rank(grid, ref_path):
    """The port's side of everything on this rank (gloo); rank 0 returns
    numpy: each collective's output and input gradient on every rank
    (keyed by its (data, model) coordinates), and per arch the loss,
    metrics and gathered gradients, and one step's gathered parameters
    and moments."""
    import torch
    import torch.distributed as dist

    from repro_torch import configs as tcfg
    from repro_torch.models import build_model
    from repro_torch.models.param import from_jax, tree_map
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.sharding import gather_tree
    from repro_torch.train.train_step import (TrainHParams, TrainState,
                                              _value_and_grad,
                                              make_train_step,
                                              reduce_over_data,
                                              train_state_pspecs)
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    d, m = grid.coords

    def npy(tree):
        return tree_map(lambda t: t.detach().float().numpy(), tree)

    def block(a):
        return torch.from_numpy(a[min(d, a.shape[0] - 1),
                                  min(m, a.shape[1] - 1)])

    out = {"collectives": {}, "models": {}}
    for (name, axis), r in ref["collectives"].items():
        g = grid.group(axis)
        if name == "all_reduce_max":
            out["collectives"][(name, axis)] = {
                "y": C.all_reduce_max(block(r["x"]).clone(), g).numpy()}
            continue
        n = grid.mesh.shape[axis]
        op = {"reduce_from": lambda t: C.reduce_from(t, g),
              "copy_to": lambda t: C.copy_to(t, g),
              "gather": lambda t: C.gather(t, 0, g),
              "split": lambda t: C.split(t, 0, g),
              "gather_rep": lambda t: C.gather_rep(t, 0, g),
              "all_to_all": lambda t: C.all_to_all(
                  t.view(n, -1), g).reshape(-1)}[name]
        x = block(r["x"]).clone().requires_grad_()
        y = op(x)
        (y * block(r["w"])).sum().backward()
        out["collectives"][(name, axis)] = {"y": y.detach().numpy(),
                                            "g": x.grad.numpy()}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (grid.coords, out["collectives"]))
    out["collectives"] = dict(every)
    hps = {"f32": TrainHParams(peak_lr=LR, warmup=0, total_steps=10),
           "int8": TrainHParams(peak_lr=LR, warmup=0, total_steps=10,
                                adamw=AdamWConfig(quant_moments=True)),
           "mb2": TrainHParams(peak_lr=LR, warmup=0, total_steps=10,
                               microbatches=2)}
    for arch, r in ref["models"].items():
        cfg = tcfg.reduce_config(tcfg.get_config(arch))
        model = build_model(cfg, "cpu", grid=grid)
        params = model.shard(from_jax(r["params"], "cpu"))
        res = {}
        for key, b in (("plain", r["batch"]), ("mask", r["mbatch"])):
            b = {k: torch.from_numpy(v) for k, v in b.items()}
            (loss, met), g = _value_and_grad(model, params, b)
            g = reduce_over_data(g, model.pspecs, grid)
            res[key] = {"loss": float(loss),
                        "metrics": {k: float(v) for k, v in met.items()},
                        "grads": npy(model.gather(g))}
        b = {k: torch.from_numpy(v) for k, v in r["batch"].items()}
        for key, hp in hps.items():
            state = TrainState(params, adamw_init(params, hp.adamw),
                               torch.zeros((), dtype=torch.int32))
            new, met = make_train_step(model, hp)(state, b)
            sp = train_state_pspecs(model, model.rules, hp).opt
            res["step_" + key] = {
                "params": npy(model.gather(new.params)),
                "m": npy(gather_tree(new.opt.m, sp.m, grid)),
                "v": npy(gather_tree(new.opt.v, sp.v, grid)),
                "m_scale": (None if new.opt.m_scale is None else npy(
                    gather_tree(new.opt.m_scale, sp.m_scale, grid))),
                "metrics": {k: float(v) for k, v in met.items()}}
        out["models"][arch] = res
    out["counts"] = C.counts()
    return out if grid.rank == 0 else None


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{mesh: (reference, port)}: one subprocess and one run_grid job a
    mesh."""
    out = {}
    for d, m in MESHES:
        path = str(tmp_path_factory.mktemp("spmd") / f"ref_{d}x{m}.pkl")
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   JAX_PLATFORMS="cpu",
                   XLA_FLAGS=f"--xla_force_host_platform_device_count={d * m}")
        r = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                            str(d), str(m), path, str(LR)],
                           capture_output=True, text=True, env=env, cwd=ROOT,
                           timeout=TIMEOUT_S)
        assert r.returncode == 0, r.stderr[-4000:]
        with open(path, "rb") as f:
            ref = pickle.load(f)
        port = run_grid(_port_rank, d, m, timeout_s=TIMEOUT_S, args=(path,))
        out[(d, m)] = (ref, port)
    return out


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _mean(values) -> float:
    return float(np.mean(values))


def assert_tree_close(got, want, rel):
    """Same leaves; each within ``rel`` x its reference's max |x|."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert set(g) == set(w)
    for name, x in w.items():
        x = np.asarray(x, np.float32)
        scale = float(np.abs(x).max())
        err = float(np.abs(g[name] - x).max())
        assert err <= rel * scale + 1e-12, (name, err, scale)


COLLECTIVES = ["reduce_from", "copy_to", "gather", "split", "gather_rep",
               "all_to_all", "all_reduce_max"]


@pytest.mark.parametrize("axis", ["model", "data"])
@pytest.mark.parametrize("op", COLLECTIVES)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_collective_and_its_backward_match_shard_map(runs, mesh, op, axis):
    """Every rank's output and input gradient equal those of the device
    at its (data, model) coordinates (its row's or column's copy where
    the reference's value is replicated over ``axis``) of the
    reference's collective under ``shard_map`` (``psum``, ``pvary``,
    tiled ``all_gather``, a slice by ``axis_index``, ``all_to_all``,
    ``pmax``) with ``jax.grad`` of sum(W * F(X))."""
    ref, port = runs[mesh]
    r = ref["collectives"][(op, axis)]
    assert set(port["collectives"]) == {
        (d, m) for d in range(mesh[0]) for m in range(mesh[1])}

    def block(a, d, m):
        return a[min(d, a.shape[0] - 1), min(m, a.shape[1] - 1)]

    for (d, m), rank in port["collectives"].items():
        p = rank[(op, axis)]
        np.testing.assert_allclose(p["y"], block(r["y"], d, m), rtol=1e-6,
                                   atol=1e-6, err_msg=f"y at {(d, m)}")
        if "g" in r:
            np.testing.assert_allclose(p["g"], block(r["g"], d, m),
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"g at {(d, m)}")


@pytest.mark.parametrize("batch", ["plain", "mask"])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_loss_metrics_and_every_gradient_leaf(runs, mesh, arch, batch):
    """The sharded loss and metrics equal the mean of the reference's
    devices' values (1e-5 relative), and every gathered gradient leaf
    the reference's (1e-4 x its max |g|), with and without
    ``loss_mask``."""
    ref, port = runs[mesh]
    r, p = ref["models"][arch][batch], port["models"][arch][batch]
    assert abs(p["loss"] - _mean(r["loss"])) <= LOSS_RTOL * abs(
        _mean(r["loss"]))
    assert set(p["metrics"]) == set(r["metrics"])
    for k, v in r["metrics"].items():
        assert abs(p["metrics"][k] - _mean(v)) <= LOSS_RTOL * max(
            abs(_mean(v)), 1e-6), k
    assert_tree_close(p["grads"], r["grads"], GRAD_TOL)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_the_references_moe_aux_differs_across_data_rows(runs, mesh):
    """The fault the port does not copy (ROADMAP §C): the reference's
    ``aux`` (and so its loss) is one value a data row, equal within a
    row and different between rows; the dense model's is 0 everywhere,
    and ``ce`` is one value on every device."""
    ref, _ = runs[mesh]
    d, m = mesh
    aux = np.asarray(ref["models"]["qwen3-moe-30b-a3b"]["plain"]["metrics"][
        "aux"]).reshape(d, m)
    assert np.all(aux == aux[:, :1]) and aux[0, 0] != aux[1, 0]
    ce = ref["models"]["qwen3-moe-30b-a3b"]["plain"]["metrics"]["ce"]
    assert len(set(ce)) == 1
    assert set(ref["models"]["qwen3-1.7b"]["plain"]["metrics"]["aux"]) == {0.0}


@pytest.mark.parametrize("hp", ["f32", "int8", "mb2"])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_one_train_step(runs, mesh, arch, hp):
    """One ``make_train_step`` step on the grid against the reference's
    jitted sharded step from the same state: its metrics (loss,
    grad_norm, lr and the model's), the parameters after, and the
    moments (int8 ones within a quantum)."""
    ref, port = runs[mesh]
    r, p = (ref["models"][arch]["step_" + hp],
            port["models"][arch]["step_" + hp])
    assert set(p["metrics"]) == set(r["metrics"])
    for k, v in r["metrics"].items():
        assert abs(p["metrics"][k] - _mean(v)) <= LOSS_RTOL * max(
            abs(_mean(v)), 1e-6), k
    got, want = dict(_leaves(p["params"])), dict(_leaves(r["params"]))
    assert set(got) == set(want)
    for name, w in want.items():
        assert float(np.abs(got[name] - w).max()) <= 0.2 * LR, name
    if hp != "int8":
        assert_tree_close(p["m"], r["m"], GRAD_TOL)
        assert_tree_close(p["v"], r["v"], GRAD_TOL)
        return
    scales = dict(_leaves(r["m_scale"]))
    assert_tree_close(p["m_scale"], r["m_scale"], GRAD_TOL)
    mp, mr = dict(_leaves(p["m"])), dict(_leaves(r["m"]))
    for name, q in mr.items():
        dq = np.abs(mp[name] - q.astype(np.float32)) * scales[name]
        assert float(dq.max()) <= float(scales[name].max()) * 1.001, name
    vp, vr = dict(_leaves(p["v"])), dict(_leaves(r["v"]))
    for name, v in vr.items():
        v = np.asarray(v, np.float32)
        tol = 2.0 ** -7 * np.abs(v) + GRAD_TOL * float(np.abs(v).max())
        assert np.all(np.abs(vp[name] - v) <= tol), name


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_every_collective_ran(runs, mesh):
    """The job went through all five kinds of collective."""
    counts = runs[mesh][1]["counts"]
    assert all(v > 0 for v in counts.values()), counts


# ----------------------------------------------------------------------
# Elastic checkpoints and the launcher
# ----------------------------------------------------------------------
CKPT_ARCH = "qwen3-1.7b"


def _ckpt_setup(grid, seed):
    """(model, hp, state, pspecs) of reduced CKPT_ARCH with int8 moments
    (their row scales have a spec of their own), on ``grid`` or whole."""
    from repro_torch import configs as tcfg
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.train_step import (TrainHParams, init_train_state,
                                              train_state_pspecs)
    cfg = tcfg.reduce_config(tcfg.get_config(CKPT_ARCH))
    model = build_model(cfg, "cpu", grid=grid)
    hp = TrainHParams(adamw=AdamWConfig(quant_moments=True))
    specs = None if grid is None else train_state_pspecs(model, model.rules,
                                                         hp)
    return model, hp, init_train_state(model, seed, hp), specs


def _save_sharded(grid, directory):
    from repro_torch.checkpoint import CheckpointManager
    _, _, state, specs = _ckpt_setup(grid, 0)
    CheckpointManager(directory, grid=grid, pspecs=specs).save(
        5, state, {"note": "saved sharded"})
    return True


def _flat(tree):
    from repro_torch.checkpoint.manager import _flatten
    return _flatten(tree)


def _restore_sharded(grid, directory):
    """Each rank restores its blocks into a template of another seed;
    every block must equal its slice of the whole checkpoint, read
    unsharded on the same rank."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.parallel.sharding import shard_leaf
    _, _, template, specs = _ckpt_setup(grid, 1)
    got, meta = CheckpointManager(directory, grid=grid,
                                  pspecs=specs).restore(template)
    _, _, whole_template, _ = _ckpt_setup(None, 1)
    full, _ = CheckpointManager(directory).restore(whole_template)
    sp = _flatten(specs, specs=True)
    bad = [k for k, t in _flatten(got).items()
           if not torch.equal(t, shard_leaf(_flatten(full)[k], sp[k],
                                            grid.mesh, grid.axis_coords))]
    return {"bad": bad, "meta": meta, "n": len(_flatten(got))}


def _save_counting_gathers(grid, directory):
    """A (2, 2) save with ``gather_leaf`` wrapped: (gathers, the most
    earlier gathered leaves still alive when a gather starts) on every
    rank, keyed by its coordinates.  A leaf split over no axis comes
    back as the rank's own tensor and is not counted."""
    import weakref

    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.parallel import sharding
    _, _, state, specs = _ckpt_setup(grid, 0)
    inner, alive, calls, most = sharding.gather_leaf, [], [0], [0]

    def counting(t, spec, g):
        calls[0] += 1
        most[0] = max(most[0], sum(r() is not None for r in alive))
        out = inner(t, spec, g)
        if out is not t:
            alive.append(weakref.ref(out))
        return out

    sharding.gather_leaf = counting
    try:
        CheckpointManager(directory, grid=grid, pspecs=specs).save(1, state)
    finally:
        sharding.gather_leaf = inner
    every = [None] * dist.get_world_size()
    assert len(alive) > 10
    dist.all_gather_object(every, (grid.coords, (calls[0], most[0])))
    return dict(every)


def test_sharded_save_holds_one_full_leaf_at_a_time(tmp_path):
    """On every rank of a (2, 2) grid, ``save`` gathers each leaf once
    and has freed the previous full leaf before it gathers the next, so
    that a card holds its blocks and one full leaf (the reference copies
    one leaf at a time to the host)."""
    from repro_torch.checkpoint import CheckpointManager
    out = run_grid(_save_counting_gathers, 2, 2, timeout_s=TIMEOUT_S,
                   args=(str(tmp_path),))
    _, _, state, _ = _ckpt_setup(None, 0)
    n = len(_flat(state))
    assert out == {(d, m): (n, 0) for d in range(2) for m in range(2)}
    assert len(CheckpointManager(str(tmp_path)).meta(1)["manifest"]) == n


def test_checkpoint_saved_on_2x2_restores_on_one_rank_and_on_1x2(tmp_path):
    """A (2, 2) save (gathered, rank 0 writing the reference's format)
    restores on one rank bit for bit into the unsharded state of the
    same seed, and on a (1, 2) grid every rank's block equals its slice
    of the full leaf."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    d = str(tmp_path)
    assert run_grid(_save_sharded, 2, 2, timeout_s=TIMEOUT_S, args=(d,))
    _, _, want, _ = _ckpt_setup(None, 0)
    _, _, template, _ = _ckpt_setup(None, 1)
    got, meta = CheckpointManager(d).restore(template)
    assert meta["mesh"] == "2x2" and meta["note"] == "saved sharded"
    assert meta["step"] == 5
    fw, fg = _flat(want), _flat(got)
    assert set(fw) == set(fg) and any(".m_scale" in k for k in fw)
    assert all(torch.equal(fg[k], fw[k]) for k in fw)
    out = run_grid(_restore_sharded, 1, 2, timeout_s=TIMEOUT_S, args=(d,))
    assert out["bad"] == [] and out["n"] == len(fw)


REF_CKPT = r'''
import sys
import jax
from jax.sharding import NamedSharding
from repro.checkpoint import CheckpointManager
from repro.configs import get_config, reduce_config
from repro.launch.mesh import make_mesh
from repro.models import build_model
from repro.parallel.sharding import make_rules
from repro.train import init_train_state
from repro.train.train_step import TrainHParams, train_state_pspecs
cfg = reduce_config(get_config("qwen3-moe-30b-a3b"))
model = build_model(cfg)
hp = TrainHParams()
mesh = make_mesh((2, 4), ("data", "model"))
state = init_train_state(model, jax.random.PRNGKey(0), hp)
specs = train_state_pspecs(model, make_rules(cfg, mesh, "train"), hp)
state = jax.device_put(state, jax.tree.map(
    lambda s: NamedSharding(mesh, s), specs,
    is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
assert len(state.params["embed"].sharding.device_set) == 8
CheckpointManager(sys.argv[1]).save(5, state, {"mesh": "2x4"})
print("SAVED")
'''


def _restore_reference(grid, directory):
    """The reference's checkpoint into this rank's (2, 2) blocks of
    reduced qwen3-moe-30b-a3b: each block equals its slice."""
    import torch

    from repro_torch import configs as tcfg
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.models import build_model
    from repro_torch.parallel.sharding import shard_leaf, shardings
    from repro_torch.train.train_step import (TrainHParams, init_train_state,
                                              train_state_pspecs)
    cfg = tcfg.reduce_config(tcfg.get_config("qwen3-moe-30b-a3b"))
    hp = TrainHParams()
    model = build_model(cfg, "cpu", grid=grid)
    template = init_train_state(model, 1, hp)
    specs = train_state_pspecs(model, model.rules, hp)
    got, meta = CheckpointManager(directory).restore(
        template, shardings=shardings(specs, grid.mesh, grid.axis_coords))
    whole = build_model(cfg, "cpu")
    full, _ = CheckpointManager(directory).restore(
        init_train_state(whole, 1, hp))
    sp, ff = _flatten(specs, specs=True), _flatten(full)
    bad = [k for k, t in _flatten(got).items()
           if not torch.equal(t, shard_leaf(ff[k], sp[k], grid.mesh,
                                            grid.axis_coords))]
    split = sum(tuple(t.shape) != tuple(ff[k].shape)
                for k, t in _flatten(got).items())
    return {"bad": bad, "split": split, "mesh": meta["mesh"]}


def test_reference_checkpoint_from_8_devices_restores_on_2x2(tmp_path):
    """The reference's train state, sharded on a (2, 4) mesh of 8 host
    devices and saved there, restores into the port's (2, 2) grid:
    every rank's block equals its slice of the full leaf."""
    d = str(tmp_path)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REF_CKPT), d],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=TIMEOUT_S)
    assert r.returncode == 0 and "SAVED" in r.stdout, r.stderr[-4000:]
    out = run_grid(_restore_reference, 2, 2, timeout_s=TIMEOUT_S, args=(d,))
    assert out["bad"] == [] and out["mesh"] == "2x4"
    assert out["split"] > 10


def test_launch_train_model_axis_on_cpu_ranks(tmp_path, capfd):
    """``launch.train --model-axis 2 --devices 4 --device cpu --reduce``:
    6 steps on a (2, 2) gloo grid through run_with_recovery, rank 0
    printing the reference's lines, checkpoints at 5 and 6."""
    from repro_torch.launch import train as ttrain
    state, rep, summary = ttrain.main([
        "--arch", "qwen3-1.7b", "--reduce", "--steps", "6", "--batch", "4",
        "--seq", "32", "--model-axis", "2", "--devices", "4", "--device",
        "cpu", "--ckpt-dir", str(tmp_path)])
    assert state is None and rep.final_step == 6 and rep.failures == 0
    assert len(rep.losses) == 6 and all(np.isfinite(rep.losses))
    assert summary.energy_j > 0
    out = capfd.readouterr().out
    assert out.count("arch=qwen3-1.7b") == 1
    assert "mesh data=2 model=2 (gloo)" in out and "step 5:" in out
    assert "energy-to-train (modeled)" in out
    assert sorted(os.listdir(tmp_path)) == ["step_00000005",
                                            "step_00000006"]


def test_launch_train_model_axis_trains_the_hybrid(tmp_path, capfd):
    """``launch.train --arch jamba-v0.1-52b --model-axis 2 --devices 4
    --device cpu --reduce``: 6 steps of the Mamba + MoE hybrid on a
    (2, 2) gloo grid through run_with_recovery, checkpoints at 5 and
    6."""
    from repro_torch.launch import train as ttrain
    state, rep, summary = ttrain.main([
        "--arch", "jamba-v0.1-52b", "--reduce", "--steps", "6", "--batch",
        "4", "--seq", "32", "--model-axis", "2", "--devices", "4",
        "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert state is None and rep.final_step == 6 and rep.failures == 0
    assert len(rep.losses) == 6 and all(np.isfinite(rep.losses))
    out = capfd.readouterr().out
    assert "mesh data=2 model=2 (gloo)" in out
    assert sorted(os.listdir(tmp_path)) == ["step_00000005",
                                            "step_00000006"]


@pytest.mark.parametrize("argv,exc,match", [
    (["--arch", "qwen3-1.7b", "--model-axis", "3", "--devices", "4"],
     ValueError, "does not divide"),
    (["--arch", "qwen3-moe-30b-a3b", "--model-axis", "3", "--devices",
      "3"], NotImplementedError, "§A.8"),
])
def test_launch_train_sharded_refusals(argv, exc, match):
    """What stays refused: a model axis that does not divide the world;
    MoE experts that do not divide the model axis (8 over 3), before any
    rank is spawned."""
    from repro_torch.launch import train as ttrain
    with pytest.raises(exc, match=match):
        ttrain.main([*argv, "--reduce", "--device", "cpu"])


# ----------------------------------------------------------------------
# The data axis takes every decoder family
# ----------------------------------------------------------------------
DP_ARCHS = ["deepseek-v3-671b", "jamba-v0.1-52b", "rwkv6-3b",
            "phi-3-vision-4.2b"]

REF_DP = r'''
import pickle, sys
import jax, numpy as np
from repro.configs import get_config, reduce_config
from repro.launch.mesh import make_mesh
from repro.models import build_model
from repro.models.param import init_params
from repro.parallel.sharding import make_rules, sharding_ctx
mesh = make_mesh((2, 1), ("data", "model"))
res = {}
for i, arch in enumerate(sys.argv[2:]):
    cfg = reduce_config(get_config(arch))
    model = build_model(cfg)
    params = init_params(model.param_defs(), jax.random.PRNGKey(i))
    rng = np.random.default_rng(i)
    s, b = 32, 4
    batch = {}
    if cfg.vlm is not None:
        batch["patch_embeds"] = rng.standard_normal(
            (b, cfg.vlm.n_patches, cfg.vlm.patch_embed_dim or cfg.d_model)
        ).astype(np.float32)
        s -= cfg.vlm.n_patches
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1))
    batch["tokens"] = toks[:, :-1].astype(np.int32)
    batch["labels"] = toks[:, 1:].astype(np.int32)
    batch["loss_mask"] = (rng.random((b, s)) < 0.8).astype(np.float32)
    rules = make_rules(cfg, mesh, "train")

    def loss_fn(p, bt):
        with sharding_ctx(rules):
            return model.train_loss(p, bt)

    (loss, met), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, batch)
    sh = lambda a: [float(x.data) for x in sorted(
        a.addressable_shards, key=lambda x: x.device.id)]
    res[arch] = {"params": jax.tree.map(np.asarray, params), "batch": batch,
                 "loss": sh(loss), "metrics": {k: sh(v) for k, v in met.items()},
                 "grads": jax.tree.map(np.asarray, g)}
with open(sys.argv[1], "wb") as f:
    pickle.dump(res, f)
'''


def _dp_rank(grid, ref_path):
    import torch

    from repro_torch import configs as tcfg
    from repro_torch.models import build_model
    from repro_torch.models.param import from_jax, tree_map
    from repro_torch.train.train_step import _value_and_grad, reduce_over_data
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    out = {}
    for arch, r in ref.items():
        cfg = tcfg.reduce_config(tcfg.get_config(arch))
        model = build_model(cfg, "cpu", grid=grid)
        params = model.shard(from_jax(r["params"], "cpu"))
        b = {k: torch.from_numpy(v) for k, v in r["batch"].items()}
        (loss, met), g = _value_and_grad(model, params, b)
        g = reduce_over_data(g, model.pspecs, grid)
        out[arch] = {"loss": float(loss),
                     "metrics": {k: float(v) for k, v in met.items()},
                     "grads": tree_map(lambda t: t.float().numpy(),
                                       model.gather(g))}
    return out if grid.rank == 0 else None


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dp") / "ref.pkl")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REF_DP), path,
                        *DP_ARCHS], capture_output=True, text=True, env=env,
                       cwd=ROOT, timeout=TIMEOUT_S)
    assert r.returncode == 0, r.stderr[-4000:]
    with open(path, "rb") as f:
        ref = pickle.load(f)
    return ref, run_grid(_dp_rank, 2, 1, timeout_s=TIMEOUT_S, args=(path,))


@pytest.mark.parametrize("arch", DP_ARCHS)
def test_data_axis_takes_every_family(dp_runs, arch):
    """At (2, 1), FSDP over the data axis: the loss, metrics (DeepSeek's
    MTP among them) and every gradient leaf of the mla_moe, hybrid, rwkv
    and vlm families equal the reference's sharded run's, a ``loss_mask``
    batch (the MoE layers' capacity per data shard)."""
    ref, port = dp_runs
    r, p = ref[arch], port[arch]
    assert abs(p["loss"] - _mean(r["loss"])) <= LOSS_RTOL * abs(
        _mean(r["loss"]))
    assert set(p["metrics"]) == set(r["metrics"])
    for k, v in r["metrics"].items():
        assert abs(p["metrics"][k] - _mean(v)) <= LOSS_RTOL * max(
            abs(_mean(v)), 1e-6), k
    assert_tree_close(p["grads"], r["grads"], GRAD_TOL)


# ----------------------------------------------------------------------
# The collective plan chip_smoke.py's phase 30 holds the card to
# ----------------------------------------------------------------------
def _plan_rank(grid, arch, quant, overrides=None):
    import dataclasses

    import chip_smoke
    from repro_torch import configs as tcfg
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import collectives as C
    from repro_torch.train import (TrainHParams, init_train_state,
                                   make_train_step)
    cfg = dataclasses.replace(tcfg.reduce_config(tcfg.get_config(arch)),
                              remat=True, **(overrides or {}))
    model = build_model(cfg, "cpu", grid=grid)
    hp = TrainHParams(adamw=AdamWConfig(quant_moments=quant))
    state = init_train_state(model, 0, hp)
    batch = chip_smoke.family_batch(cfg, 2, 32, "cpu")
    C.reset_counts()
    make_train_step(model, hp)(state, batch)
    got = C.counts()
    want = chip_smoke.spmd_plan(
        cfg, chip_smoke.q8_leaf_count(model) if quant else 0,
        patches="patch_embeds" in batch)
    return got, want


@pytest.mark.parametrize("arch,quant", [
    ("qwen3-1.7b", False), ("qwen3-moe-30b-a3b", True),
    ("deepseek-v3-671b", True), ("jamba-v0.1-52b", True),
    ("rwkv6-3b", False), ("phi-3-vision-4.2b", False),
    ("whisper-small", False)])
def test_world_one_step_issues_the_planned_collectives(arch, quant):
    """A (1, 1) grid still issues every collective (none is skipped at
    size 1), and one remat step's calls equal ``chip_smoke.spmd_plan``,
    the plan phase 30 holds the H100's NCCL run to (a VLM's batch with
    its patches, whisper's with its frames)."""
    sys.path.insert(0, ROOT)
    got, want = run_grid(_plan_rank, 1, 1, timeout_s=TIMEOUT_S,
                         args=(arch, quant))
    assert got == want
    moe_layers = {"qwen3-moe-30b-a3b": 4, "deepseek-v3-671b": 3,
                  "jamba-v0.1-52b": 4}.get(arch, 0)
    assert got["all_to_all"] == 6 * moe_layers


def test_world_one_plan_under_sublayer_remat():
    """jamba with ``sublayer_remat`` (phase 30 (e)'s config): each
    sublayer is a remat unit, so each skips its own trailing collectives
    in the recompute; the calls equal ``chip_smoke.spmd_plan``."""
    sys.path.insert(0, ROOT)
    got, want = run_grid(_plan_rank, 1, 1, timeout_s=TIMEOUT_S,
                         args=("jamba-v0.1-52b", True,
                               {"sublayer_remat": True}))
    assert got == want
    whole, _ = run_grid(_plan_rank, 1, 1, timeout_s=TIMEOUT_S,
                        args=("jamba-v0.1-52b", True))
    assert got["all_gather"] < whole["all_gather"]


def _recovery_rank(grid, directory, fail_at):
    """Six steps of reduced qwen3-moe-30b-a3b on the grid through
    ``run_with_recovery`` with sharded checkpoints every 2 steps and, at
    ``fail_at``, one injected failure on every rank; returns rank 0's
    losses, failures and the final parameters, gathered."""
    from repro_torch import configs as tcfg
    from repro_torch.checkpoint import CheckpointManager, run_with_recovery
    from repro_torch.checkpoint.supervisor import SimulatedFailure
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import build_model
    from repro_torch.models.param import tree_map
    from repro_torch.train.train_step import (TrainHParams, init_train_state,
                                              make_train_step,
                                              train_state_pspecs)
    cfg = tcfg.reduce_config(tcfg.get_config("qwen3-moe-30b-a3b"))
    model = build_model(cfg, "cpu", grid=grid)
    hp = TrainHParams(peak_lr=LR, warmup=1, total_steps=6)
    data = SyntheticTokens(cfg.vocab_size, 32, 4, device="cpu")
    fired = []

    def injector(step):
        if step == fail_at and not fired:
            fired.append(step)
            raise SimulatedFailure(f"injected at {step}")

    ckpt = CheckpointManager(directory, grid=grid, pspecs=train_state_pspecs(
        model, model.rules, hp))
    state, rep = run_with_recovery(
        state=init_train_state(model, 0, hp),
        step_fn=make_train_step(model, hp), data_fn=data.batch,
        ckpt=ckpt, total_steps=6, ckpt_every=2,
        failure_injector=None if fail_at is None else injector)
    full = tree_map(lambda t: t.numpy(), model.gather(state.params))
    return (rep.losses, rep.failures, full) if grid.rank == 0 else None


def test_run_with_recovery_on_a_grid_resumes_from_the_sharded_checkpoint(
        tmp_path):
    """A failure at step 3 on a (2, 2) grid rewinds every rank to the
    step-2 checkpoint (gathered on save, cut again on restore); the run
    ends where an uninterrupted one does: the same final parameters bit
    for bit, and the replayed steps' losses equal the first ones."""
    clean = run_grid(_recovery_rank, 2, 2, timeout_s=TIMEOUT_S,
                     args=(str(tmp_path / "clean"), None))
    failed = run_grid(_recovery_rank, 2, 2, timeout_s=TIMEOUT_S,
                      args=(str(tmp_path / "failed"), 3))
    assert clean[1] == 0 and failed[1] == 1
    assert len(clean[0]) == 6 and len(failed[0]) == 7
    assert failed[0][:3] == clean[0][:3]
    assert failed[0][3:] == clean[0][2:]       # step 3 replayed from 2
    for name, want in _leaves(clean[2]):
        np.testing.assert_array_equal(dict(_leaves(failed[2]))[name], want)
