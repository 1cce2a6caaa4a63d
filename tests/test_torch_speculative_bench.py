"""The port's ``speculative_efficiency`` benchmark on the CPU against
the reference's ``benchmarks/speculative_efficiency.py``: the same k
grid, budgets, keys and CSV rows, and on weights bridged from the
reference's (``from_jax``: the reduced qwen3-1.7b at 8 layers, damped,
its 1-layer self-draft, and the seed-99 random draft) and the same
prompts (the reference's request factory is given the port's numpy
prompts here, its own draw with ``jax.random``) the same acceptance and
draft energy share per point.  One repetition each (the reference's
``N_REPS`` set to 1 here, the port's ``n_reps=1``): acceptance and
share come from the best repetition's own counts."""
import copy
import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

from repro.models import build_model as jax_build_model
from repro.models.param import init_params as jax_init_params
from repro.serving import Request as JaxRequest
from repro_torch.benchmarks import speculative_efficiency as tse
from repro_torch.models import build_model
from repro_torch.models.param import from_jax
from repro_torch.serving import truncate_draft

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
from benchmarks import speculative_efficiency as jse  # noqa: E402

torch.set_num_threads(1)

POINTS = ("k0", "k2", "k4", "k8", "random_draft_k4")


def _port_cfg(jcfg_):
    from repro_torch.configs import get_config, reduce_config

    return dataclasses.replace(reduce_config(get_config("qwen3-1.7b")),
                               n_layers=jcfg_.n_layers)


def _bridge(params, dev):
    return from_jax(jax.tree.map(np.asarray, params), dev)


def _build(dev):
    """The reference's damped target, bridged; the port truncates its
    own self-draft from it (views of the same tensors)."""
    jc, _, jparams, _, _ = jse._build(True)
    cfg = _port_cfg(jc)
    model = build_model(cfg, dev)
    params = _bridge(jparams, dev)
    dmodel, dparams = truncate_draft(model, params, tse.DRAFT_LAYERS)
    return cfg, model, params, dmodel, dparams


def _random_draft(cfg, dev):
    """The reference's seed-99 random draft, bridged."""
    jc = dataclasses.replace(jse._build(True)[0], n_layers=tse.DRAFT_LAYERS,
                             name=f"{cfg.name}-random-draft")
    jparams = jax_init_params(jax_build_model(jc).param_defs(),
                              jax.random.PRNGKey(99))
    rcfg = dataclasses.replace(cfg, n_layers=tse.DRAFT_LAYERS,
                               name=f"{cfg.name}-random-draft")
    return build_model(rcfg, dev), _bridge(jparams, dev)


def _ref_request(cfg, rid, arrival_s):
    r = tse._make_request(cfg, rid, arrival_s)
    return JaxRequest(rid=r.rid, prompt=np.asarray(r.prompt),
                      max_new_tokens=r.max_new_tokens,
                      arrival_s=r.arrival_s)


@pytest.fixture(scope="module")
def both():
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jse, "N_REPS", 1)
        m.setattr(jse, "_make_request", _ref_request)
        m.setattr(tse, "_build", _build)
        m.setattr(tse, "_random_draft", _random_draft)
        return {"ref": jse.metrics(smoke=True),
                "port": tse.metrics(device="cpu", smoke=True, n_reps=1)}


def test_keys_are_the_reference_keys(both):
    ref, port = both["ref"], both["port"]
    assert list(port) == list(ref) == list(POINTS)
    for name in POINTS:
        assert set(port[name]) - set(ref[name]) == {"review_passed"}
        assert port[name]["review_passed"] is True
        assert port[name]["tokens_per_s"] > 0 and port[name]["tok_per_j"] > 0
        assert "accelerator_j" not in port[name]      # modeled on the CPU
    assert "acceptance" not in port["k0"] and "speedup" not in port["k0"]


@pytest.mark.parametrize("name", POINTS[1:])
def test_acceptance_and_draft_share_are_the_reference_figures(both, name):
    """Bit for bit: both come from integer counts of the same drafts and
    verifies over the same weights and prompts."""
    for key in ("acceptance", "draft_energy_share"):
        assert both["port"][name][key] == both["ref"][name][key]


def test_damped_pair_agrees_and_random_draft_does_not(both):
    p = both["port"]
    assert all(p[f"k{k}"]["acceptance"] >= 0.9 for k in (2, 4, 8))
    assert p["random_draft_k4"]["acceptance"] < 0.05
    # a 1-layer draft against an 8-layer target with a shared embed/head
    assert 0.1 < p["k4"]["draft_energy_share"] < 0.3


def test_csv_rows_are_the_reference_rows(both, monkeypatch):
    rows = {}
    for side, mod, fn in (("ref", jse, "_points"), ("port", tse, "metrics")):
        monkeypatch.setattr(mod, fn, lambda *a, _m=both[side], **k:
                            copy.deepcopy(_m))
        rows[side] = [r.split(",")[0] for r in mod.csv(smoke=True)]
    assert rows["port"] == rows["ref"] == [f"spec_{n}" for n in POINTS]


def test_sweep_is_the_reference_sweep():
    names = ("SLOTS", "PROMPT_LEN", "MAX_LEN", "TARGET_LAYERS", "MIX", "QPS",
             "K_SWEEP", "DRAFT_LAYERS", "DAMP", "N_REPS")
    assert ({n: getattr(tse, n) for n in names}
            == {n: getattr(jse, n) for n in names})


def test_metrics_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="cuda"):
        tse.metrics()
