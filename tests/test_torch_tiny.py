"""The port's tiny keyword spotter on the CPU: the config, the float32
forward on weights bridged from the JAX package, the analytic MAC and
SRAM counts, the W8A8 accuracy measurement on the reference's own
weights and inputs, and the tiny launcher.

The forward is held within 1e-5 of the reference (both float32; only
the matmuls' summation order may differ).  The measurement must give
the reference's argmax agreement and its relative error within 1e-4:
its int8 GEMMs agree with the reference's bit for bit
(``tests/test_torch_int8_matmul.py``), so only the float32 forward
around them differs.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import tiny as jtiny
from repro.models.param import init_params as jax_init_params
from repro_torch import configs as tcfg
from repro_torch.benchmarks.quantization_efficiency import (
    tiny_accuracy_measurement)
from repro_torch.kernels.int8_matmul import int8_matmul
from repro_torch.launch import tiny_benchmark
from repro_torch.models import build_model
from repro_torch.models import tiny as ttiny
from repro_torch.models.param import from_jax

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
from benchmarks.quantization_efficiency import (  # noqa: E402
    tiny_accuracy_measurement as jax_tiny_accuracy_measurement)

# tiny shapes: one intra-op thread each, so that pytest-xdist workers do
# not oversubscribe the CPU that timing-sensitive tests share
torch.set_num_threads(1)


def _jax_params(seed=0):
    cfg = jax_get_config("tiny-kws")
    params = jax_init_params(jtiny.TinyModel(cfg).param_defs(),
                             jax.random.PRNGKey(seed))
    return cfg, params, jax.tree.map(np.asarray, params)


def test_config_is_the_reference_config_and_is_not_reduced():
    cfg = tcfg.get_config("tiny-kws")
    ref = jax_get_config("tiny-kws")
    for f in ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "d_ff", "vocab_size", "dtype"):
        assert getattr(cfg, f) == getattr(ref, f), f
    assert "tiny-kws" in tcfg.list_archs()
    assert tcfg.get_config("tiny_kws") == cfg
    assert tcfg.reduce_config(cfg) is cfg


def test_build_model_dispatches_to_the_tiny_model():
    cfg = tcfg.get_config("tiny-kws")
    model = build_model(cfg, "cpu")
    assert isinstance(model, ttiny.TinyModel)
    params = model.init(seed=0)
    defs = model.param_defs()
    assert set(params) == set(defs)
    for k, d in defs.items():
        assert tuple(params[k].shape) == d.shape
        assert params[k].dtype == torch.float32
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.train_loss(params, {})


@pytest.mark.parametrize("batch", [1, 8, 256])
def test_forward_matches_the_reference_on_bridged_weights(batch):
    cfg, jp, params_np = _jax_params()
    x = np.random.default_rng(batch).standard_normal(
        (batch, jtiny.IN_T, jtiny.IN_F)).astype(np.float32)
    ref = np.asarray(jtiny.TinyModel(cfg)(jp, jnp.asarray(x)))
    model = ttiny.TinyModel(tcfg.get_config("tiny-kws"), "cpu")
    got = model(from_jax(params_np, "cpu"), torch.from_numpy(x)).numpy()
    assert got.shape == (batch, cfg.vocab_size)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert np.linalg.norm(got - ref) <= 1e-5 * np.linalg.norm(ref)


def test_macs_and_sram_bytes_equal_the_reference():
    cfg = tcfg.get_config("tiny-kws")
    jcfg = jax_get_config("tiny-kws")
    model = ttiny.TinyModel(cfg, "cpu")
    assert ttiny.macs(cfg) == jtiny.macs(jcfg) == model.macs
    assert (ttiny.sram_bytes(cfg) == jtiny.sram_bytes(jcfg)
            == model.sram_bytes)
    assert (ttiny.IN_T, ttiny.IN_F) == (jtiny.IN_T, jtiny.IN_F)


def test_accuracy_measurement_matches_the_reference():
    """The reference's own weights (PRNGKey(0)) and inputs (PRNGKey(1))
    through the port: agreement 1.0 and relative error 0.007890 as in
    the reference, the GEMMs on the plain version (no launches)."""
    _, _, params_np = _jax_params()
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                     (256, jtiny.IN_T, jtiny.IN_F)))
    ref = jax_tiny_accuracy_measurement()
    before = int8_matmul.launches
    got = tiny_accuracy_measurement("cpu", params=params_np, x=x)
    assert int8_matmul.launches == before
    assert got["int8_argmax_agreement"] == ref["int8_argmax_agreement"]
    assert abs(got["int8_rel_err"] - ref["int8_rel_err"]) <= 1e-4
    assert got["int8_rel_err"] < 0.02
    plain = tiny_accuracy_measurement("cpu", params=params_np, x=x,
                                      kernels=False)
    assert plain == got


def test_accuracy_measurement_on_seeded_torch_weights():
    out = tiny_accuracy_measurement("cpu")
    assert out["device"] == "cpu"
    assert 0.0 < out["int8_rel_err"] < 0.02
    assert 0.0 <= out["int8_argmax_agreement"] <= 1.0


def test_default_device_is_cuda_and_never_falls_back():
    """Without ``device`` every tiny entry point asks for CUDA: with no
    GPU it raises rather than running on the CPU."""
    cfg = tcfg.get_config("tiny-kws")
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == "cuda"
        return
    for make in (lambda: build_model(cfg),
                 lambda: ttiny.TinyModel(cfg),
                 lambda: tiny_accuracy_measurement(),
                 lambda: tiny_benchmark.main(["--min-duration", "1"])):
        with pytest.raises(RuntimeError, match="cuda"):
            make()


@pytest.mark.parametrize("argv", [
    ["--min-duration", "1"],
    ["--min-duration", "1", "--period", "0.1", "--int8-accuracy"],
    ["--scenario", "multi"],
])
def test_launcher_review_passes_on_cpu(argv, capsys):
    out = tiny_benchmark.main(["--device", "cpu", *argv])
    text = capsys.readouterr().out
    assert out["review_passed"]
    assert "ACCEPTED" in text
    assert out["p50_us"] > 0
    if out["scenario"] == "single":
        assert "modeled MCU" in text
        assert out["n_forwards"] == out["n_queries"] >= 4
        assert out["modeled_uj_per_inf"] > 0 and out["pin_windows"] > 0
    else:
        assert out["bursts"] >= 8
    if "--int8-accuracy" in argv:
        assert "int8_argmax_agreement" in text
