"""The port's checkpoints and recovery supervisor on the CPU: the
round trip, atomic publication and garbage collection, recovery that
resumes and finishes, giving up after ``max_restarts``, the straggler
monitor (the reference's tests/test_checkpoint_ft.py cases on the
port), and the reference's on-disk format both ways: files written by
the two packages from the same numbers are byte for byte the same, a
checkpoint either package wrote restores in the other, float32 and
int8 moments alike; bfloat16 leaves restore in the port bit for bit,
while the reference's own restore cannot cast them (``<V2`` has no cast
to bfloat16 in numpy), whoever wrote them.
"""
import dataclasses
import json
import os
import tempfile

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCkpt
from repro.configs import get_config as jget, reduce_config as jred
from repro.models import build_model as jax_build_model
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import OptState as JaxOptState
from repro.train import init_train_state as jax_init_state
from repro.train.train_step import TrainHParams as JaxHP
from repro.train.train_step import TrainState as JaxTrainState
from repro_torch import configs as tcfg
from repro_torch.checkpoint import (CheckpointManager, SimulatedFailure,
                                    StragglerMonitor, run_with_recovery)
from repro_torch.data import SyntheticTokens
from repro_torch.models import build_model
from repro_torch.models.param import from_jax, tree_leaves, tree_map
from repro_torch.optim import AdamWConfig, OptState
from repro_torch.train import (TrainHParams, TrainState, init_train_state,
                               make_train_step)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    cfg = tcfg.reduce_config(tcfg.get_config("granite-3-2b"))
    model = build_model(cfg, "cpu")
    hp = TrainHParams(total_steps=40, warmup=2)
    state = init_train_state(model, 0, hp)
    step = make_train_step(model, hp)
    gen = SyntheticTokens(cfg.vocab_size, 32, 4, device="cpu")
    return cfg, model, hp, state, step, gen


def _leaves(state):
    return [*tree_leaves(state.params), state.opt.step,
            *tree_leaves(state.opt.m), *tree_leaves(state.opt.v),
            *(tree_leaves(state.opt.m_scale) if state.opt.m_scale is not None
              else []), state.step]


def test_checkpoint_roundtrip(setup):
    _, _, _, state, _, _ = setup
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(3, state, {"cfg": "granite"})
        restored, meta = mgr.restore(state)
        assert meta["step"] == 3 and meta["cfg"] == "granite"
        assert isinstance(restored, TrainState)
        assert isinstance(restored.opt, OptState)
        for a, b in zip(_leaves(state), _leaves(restored)):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_atomicity_and_gc(setup):
    _, _, _, state, _, _ = setup
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, state)
        assert mgr.all_steps() == [3, 4]
        assert not any(p.endswith(".tmp") for p in os.listdir(d))
        # a crash mid-write leaves a .tmp that is neither listed nor read
        os.makedirs(os.path.join(d, "step_00000009.tmp"))
        assert mgr.latest_step() == 4
        mgr.save(9, state)
        assert mgr.all_steps() == [4, 9]


def test_restore_of_an_empty_directory_raises(setup):
    _, _, _, state, _, _ = setup
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(FileNotFoundError):
            CheckpointManager(d).restore(state)


def test_recovery_resumes_and_finishes(setup):
    _, _, _, state, step, gen = setup
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        boom = {7: True, 13: True}

        def injector(s):
            if boom.pop(s, None):
                raise SimulatedFailure(s)

        final, rep = run_with_recovery(
            state=state, step_fn=step, data_fn=gen.batch, ckpt=mgr,
            total_steps=20, ckpt_every=5, failure_injector=injector)
        assert rep.final_step == 20
        assert rep.failures == 2
        assert int(final.step) == 20
        assert len(rep.losses) == 20 + 2 + 3     # steps 5-6 and 10-12 again


def test_recovery_gives_up_after_max_restarts(setup):
    _, _, _, state, step, gen = setup
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)

        def always_fail(s):
            if s == 2:
                raise SimulatedFailure(s)

        with pytest.raises(SimulatedFailure):
            run_with_recovery(
                state=state, step_fn=step, data_fn=gen.batch, ckpt=mgr,
                total_steps=10, ckpt_every=100,
                failure_injector=always_fail, max_restarts=3)


def test_recovered_run_equals_an_unbroken_one(setup):
    """Data is a function of the step and the restore is exact, so a
    run through a failure ends where an unbroken one does."""
    _, _, _, state, step, gen = setup
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        plain, _ = run_with_recovery(
            state=state, step_fn=step, data_fn=gen.batch,
            ckpt=CheckpointManager(d1), total_steps=8, ckpt_every=3)
        boom = {5: True}

        def injector(s):
            if boom.pop(s, None):
                raise SimulatedFailure(s)

        broken, rep = run_with_recovery(
            state=state, step_fn=step, data_fn=gen.batch,
            ckpt=CheckpointManager(d2), total_steps=8, ckpt_every=3,
            failure_injector=injector)
        assert rep.failures == 1
        for a, b in zip(_leaves(plain), _leaves(broken)):
            assert torch.equal(a, b)


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(factor=2.0)
    for i in range(10):
        assert not mon.observe(i, 1.0)
    assert mon.observe(10, 5.0)
    assert len(mon.events) == 1
    assert mon.events[0]["step"] == 10


# ----------------------------------------------------------------------
# The reference's format, both ways
# ----------------------------------------------------------------------
def _jax_state(quant: bool, dtype: str = "float32"):
    cfg = dataclasses.replace(jred(jget("granite-3-2b")), dtype=dtype)
    hp = JaxHP(adamw=JaxAdamWConfig(quant_moments=quant))
    st = jax_init_state(jax_build_model(cfg), jax.random.PRNGKey(0), hp)
    st = jax.tree.map(np.asarray, st)
    # moments made nonzero (and the steps), so the files hold real values
    rng = np.random.default_rng(1)

    def fill(x):
        if x.ndim == 0:
            return np.asarray(5, x.dtype)
        if x.dtype == np.int8:
            return rng.integers(-127, 128, x.shape).astype(np.int8)
        return rng.standard_normal(x.shape).astype(x.dtype)

    opt = JaxOptState(fill(st.opt.step), jax.tree.map(fill, st.opt.m),
                      jax.tree.map(fill, st.opt.v),
                      None if st.opt.m_scale is None else
                      jax.tree.map(fill, st.opt.m_scale), None)
    return JaxTrainState(st.params, opt, fill(st.step))


def _port_state(js):
    def t(tree):
        return None if tree is None else from_jax(tree, "cpu")

    return TrainState(t(js.params), OptState(
        torch.from_numpy(np.array(js.opt.step)), t(js.opt.m), t(js.opt.v),
        t(js.opt.m_scale), None), torch.from_numpy(np.array(js.step)))


def _files(d):
    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            with open(os.path.join(root, n), "rb") as f:
                out[os.path.relpath(os.path.join(root, n), d)] = f.read()
    return out


def _same_as_reference(port_tree, ref_tree):
    got = _leaves(port_tree)
    want = [*jax.tree.leaves(ref_tree.params), ref_tree.opt.step,
            *jax.tree.leaves(ref_tree.opt.m), *jax.tree.leaves(ref_tree.opt.v),
            *(jax.tree.leaves(ref_tree.opt.m_scale)
              if ref_tree.opt.m_scale is not None else []), ref_tree.step]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        if b.dtype == ml_dtypes.bfloat16:
            assert a.dtype == torch.bfloat16
            np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                          b.view(np.int16))
        else:
            np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("quant,dtype", [(False, "float32"),
                                         (True, "float32"),
                                         (False, "bfloat16")])
def test_both_packages_write_the_same_files(quant, dtype):
    """The same state saved by each package: the same file names
    (``.params__<name>.npy``, ``.opt__.m__<name>.npy``, ...), the same
    bytes in every ``.npy`` (bfloat16 as ``<V2``), the same
    ``meta.json``."""
    js = _jax_state(quant, dtype)
    with tempfile.TemporaryDirectory() as a, \
            tempfile.TemporaryDirectory() as b:
        JaxCkpt(a).save(5, js, {"arch": "granite"})
        CheckpointManager(b).save(5, _port_state(js), {"arch": "granite"})
        fa, fb = _files(a), _files(b)
        assert sorted(fa) == sorted(fb)
        meta = "step_00000005/meta.json"
        assert json.loads(fa[meta]) == json.loads(fb[meta])
        for name in fa:
            if name != meta:
                assert fa[name] == fb[name], name
        keys = set(json.loads(fb[meta])["manifest"])
        assert ".params/embed" in keys and ".opt/.step" in keys
        assert ".step" in keys and ".opt/.m/embed" in keys
        assert (".opt/.m_scale/embed" in keys) == quant


@pytest.mark.parametrize("quant,dtype", [(False, "float32"),
                                         (True, "float32"),
                                         (False, "bfloat16")])
def test_a_reference_checkpoint_restores_in_the_port(quant, dtype):
    js = _jax_state(quant, dtype)
    template = _port_state(jax.tree.map(np.zeros_like, js))
    with tempfile.TemporaryDirectory() as d:
        JaxCkpt(d).save(5, js)
        got, meta = CheckpointManager(d).restore(template)
    assert meta["step"] == 5
    _same_as_reference(got, js)


@pytest.mark.parametrize("quant,dtype", [(False, "float32"),
                                         (True, "float32"),
                                         (False, "bfloat16")])
def test_a_port_checkpoint_restores_in_the_reference(quant, dtype):
    """float32 and int8 leaves restore bit for bit; a bfloat16 leaf
    makes the reference's restore raise, exactly as on a checkpoint the
    reference wrote itself (ROADMAP §C: a fault of the reference)."""
    js = _jax_state(quant, dtype)
    has_bf16 = any(np.asarray(x).dtype == ml_dtypes.bfloat16
                   for x in jax.tree.leaves(js))
    with tempfile.TemporaryDirectory() as d, \
            tempfile.TemporaryDirectory() as own:
        CheckpointManager(d).save(5, _port_state(js))
        JaxCkpt(own).save(5, js)
        if has_bf16:
            for where in (d, own):
                with pytest.raises(ValueError, match="cast"):
                    JaxCkpt(where).restore(js)
            return
        got, meta = JaxCkpt(d).restore(js)
    assert meta["step"] == 5
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(js)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_restore_casts_to_the_templates_dtype(setup):
    """A leaf restores in its template's dtype (a bf16 run from a
    float32 checkpoint), as the reference's restore casts."""
    _, _, _, state, _, _ = setup
    bf = state._replace(params=tree_map(lambda t: t.to(torch.bfloat16),
                                        state.params))
    with tempfile.TemporaryDirectory() as d:
        CheckpointManager(d).save(1, state)
        got, _ = CheckpointManager(d).restore(bf)
    for a, b in zip(tree_leaves(got.params), tree_leaves(state.params)):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, b.to(torch.bfloat16))
