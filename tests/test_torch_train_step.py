"""The port's train step on the CPU: three ``make_train_step`` steps on
reduced granite-3-2b against the reference's jitted step from the same
(bridged) state, the microbatch path (copied from the reference's
tests/test_checkpoint_ft.py::test_grad_accumulation_equivalence and held
against the reference's own microbatch step), ``init_train_state``, a
state left as it was, the metrics' keys and no host read inside a step.

Tolerances: losses within 1e-4 relative after three steps (each step's
AdamW update is ~lr = 3e-4 per weight, so float32 noise in the
gradients moves the next loss by far less), gradient norms 1e-4
relative.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduce_config as jred
from repro.data import SyntheticTokens as JaxTokens
from repro.models import build_model as jax_build_model
from repro.train import init_train_state as jax_init_state
from repro.train import make_train_step as jax_make_step
from repro.train.train_step import TrainHParams as JaxHP
from repro_torch import configs as tcfg
from repro_torch.data import SyntheticTokens
from repro_torch.models import build_model
from repro_torch.models.param import from_jax, tree_leaves
from repro_torch.optim import adamw_init
from repro_torch.train import (TrainHParams, TrainState, init_train_state,
                               make_train_step)

torch.set_num_threads(1)


def _bridge(jstate, hp):
    """The reference's initial TrainState as the port's."""
    params = from_jax(jax.tree.map(np.asarray, jstate.params), "cpu")
    return TrainState(params, adamw_init(params, hp.adamw),
                      torch.zeros((), dtype=torch.int32))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_three_steps_match_the_references_jitted_step(microbatches):
    cfg = jred(jget("granite-3-2b"))
    jmodel = jax_build_model(cfg)
    jhp = JaxHP(total_steps=40, warmup=2, microbatches=microbatches)
    jstate = jax_init_state(jmodel, jax.random.PRNGKey(0), jhp)
    jstep = jax.jit(jax_make_step(jmodel, jhp))
    hp = TrainHParams(total_steps=40, warmup=2, microbatches=microbatches)
    model = build_model(tcfg.reduce_config(tcfg.get_config("granite-3-2b")),
                        "cpu")
    state = _bridge(jstate, hp)
    step = make_train_step(model, hp)
    jgen = JaxTokens(cfg.vocab_size, 32, 4)
    gen = SyntheticTokens(cfg.vocab_size, 32, 4, device="cpu")
    for s in range(3):
        jstate, jm = jstep(jstate, jgen.batch(s))
        state, m = step(state, gen.batch(s))
        assert set(m) == set(jm)
        for k in ("loss", "grad_norm", "lr"):
            assert abs(float(m[k]) - float(jm[k])) <= 1e-4 * max(
                abs(float(jm[k])), 1e-6), (s, k)
    assert int(state.step) == int(jstate.step) == 3
    assert int(state.opt.step) == 3


def test_grad_accumulation_equivalence():
    """microbatches=2 == full batch (up to numerics), as the
    reference's own test holds its step."""
    cfg = tcfg.reduce_config(tcfg.get_config("qwen3-1.7b"))
    model = build_model(cfg, "cpu")
    hp1 = TrainHParams(total_steps=4, warmup=1, microbatches=1)
    hp2 = TrainHParams(total_steps=4, warmup=1, microbatches=2)
    state = init_train_state(model, 0, hp1)
    batch = SyntheticTokens(cfg.vocab_size, 32, 4, device="cpu").batch(0)
    s1, m1 = make_train_step(model, hp1)(state, batch)
    s2, m2 = make_train_step(model, hp2)(state, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-3)
    a = tree_leaves(s1.params)[0]
    b = tree_leaves(s2.params)[0]
    np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                               atol=2e-2)
    assert set(m2) == {"loss", "grad_norm", "lr", "ce"}


def test_microbatches_must_split_the_batch():
    cfg = tcfg.reduce_config(tcfg.get_config("qwen3-1.7b"))
    model = build_model(cfg, "cpu")
    hp = TrainHParams(microbatches=3)
    state = init_train_state(model, 0, hp)
    batch = SyntheticTokens(cfg.vocab_size, 8, 4, device="cpu").batch(0)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(model, hp)(state, batch)


def test_init_train_state_is_seeded_and_a_step_leaves_it_as_it_was():
    """``init_train_state`` draws ``model.init(seed)``; zero moments,
    step 0.  A step returns a new state and changes nothing of the old
    one (the microbatch and the one-batch step can start from it)."""
    cfg = tcfg.reduce_config(tcfg.get_config("qwen3-moe-30b-a3b"))
    model = build_model(cfg, "cpu")
    hp = TrainHParams(warmup=1)
    state = init_train_state(model, 7, hp)
    for a, b in zip(tree_leaves(state.params), tree_leaves(model.init(7))):
        assert torch.equal(a, b)
    assert all(not bool(m.any()) for m in tree_leaves(state.opt.m))
    assert int(state.step) == 0 and state.step.dtype == torch.int32
    before = [t.clone() for t in tree_leaves(state.params)]
    batch = SyntheticTokens(cfg.vocab_size, 16, 2, device="cpu").batch(0)
    new, m = make_train_step(model, hp)(state, batch)
    for a, b in zip(tree_leaves(state.params), before):
        assert torch.equal(a, b)
    assert all(not bool(x.any()) for x in tree_leaves(state.opt.m))
    assert set(m) == {"loss", "grad_norm", "lr", "ce", "aux"}
    assert all(not t.requires_grad for t in m.values())
    assert all(not t.requires_grad for t in tree_leaves(new.params))


class _HostRead(RuntimeError):
    pass


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen3-moe-30b-a3b"])
def test_a_step_makes_no_host_read(arch, monkeypatch):
    """Every tensor-to-Python conversion raises while a step runs (on a
    card each would be a device sync): the step, its schedule and its
    optimizer keep the step count and every metric on the device."""
    cfg = tcfg.reduce_config(tcfg.get_config(arch))
    model = build_model(cfg, "cpu")
    hp = TrainHParams(warmup=2, total_steps=10)
    state = init_train_state(model, 0, hp)
    batch = SyntheticTokens(cfg.vocab_size, 16, 2, device="cpu").batch(0)
    step = make_train_step(model, hp)

    def raiser(name):
        def f(*args, **kw):
            raise _HostRead(f"Tensor.{name} inside a train step")
        return f

    with monkeypatch.context() as m:
        for name in ("item", "tolist", "numpy", "cpu", "__bool__",
                     "__int__", "__float__", "__index__"):
            m.setattr(torch.Tensor, name, raiser(name))
        state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["loss"]))
