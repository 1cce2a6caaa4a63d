"""The port's ``prefix_cache`` benchmark on the CPU against the
reference's ``benchmarks/prefix_cache.py``: the same geometry, request
stream, keys and CSV rows, and on weights bridged from the reference's
(``from_jax``, reduced qwen3-1.7b) the same cache accounting: hits,
lookups, cached tokens, peak pages and admission capacity per hit rate.
Both run one repetition (each module's ``N_REPS`` set to 1 here): the
accounting is the same in every repetition.  Both serve on one virtual
clock of 2 ms ticks (every ``now()`` read ticks it, ``sleep`` jumps
ahead), so that arrivals land against the work alike in both packages:
on each package's own wall clock hit 0.9's peak was 39 or 40 pages
depending on the machine's speed, in both."""
import copy
import os
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import build_model as jax_build_model
from repro.models.param import init_params as jax_init_params
from repro.serving import ContinuousBatchingEngine as JaxCBE
from repro_torch import configs as tcfg
from repro_torch.benchmarks import prefix_cache as tpc
from repro_torch.models import build_model
from repro_torch.models.param import from_jax
from repro_torch.serving import ContinuousBatchingEngine

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
from benchmarks import prefix_cache as jpc  # noqa: E402

torch.set_num_threads(1)

POINTS = ("hit0", "hit50", "hit90")


def _bridged(dev):
    """The reference's reduced model and seed-0 weights, in the port."""
    jc = jcfg.reduce_config(jcfg.get_config("qwen3-1.7b"))
    jm = jax_build_model(jc)
    jp = jax_init_params(jm.param_defs(), jax.random.PRNGKey(0))
    cfg = tcfg.reduce_config(tcfg.get_config("qwen3-1.7b"))
    return (cfg, build_model(cfg, dev),
            from_jax(jax.tree.map(np.asarray, jp), dev))


def _clocked(serve):
    """``serve`` on a fresh virtual clock of 2 ms ticks per call, unless
    the caller passes its own ``now``/``sleep``."""
    def clocked(engine, requests, *args, **kwargs):
        t = [0.0]

        def now():
            t[0] += 0.002
            return t[0]

        def sleep(dt):
            t[0] += max(0.0, dt)

        kwargs.setdefault("now", now)
        kwargs.setdefault("sleep", sleep)
        return serve(engine, requests, *args, **kwargs)

    return clocked


@pytest.fixture(scope="module")
def both():
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jpc, "N_REPS", 1)
        m.setattr(tpc, "N_REPS", 1)
        m.setattr(tpc, "_model", _bridged)
        for cls in (JaxCBE, ContinuousBatchingEngine):
            m.setattr(cls, "serve", _clocked(cls.serve))
        return {"ref": jpc.metrics(smoke=True),
                "port": tpc.metrics(device="cpu", smoke=True)}


def test_keys_are_the_reference_keys(both):
    ref, port = both["ref"], both["port"]
    assert list(port) == list(ref) == [*POINTS, "allocator"]
    for name in ref:
        extra = set(port[name]) - set(ref[name])
        assert extra == ({"review_passed"} if name != "allocator" else set())
    for name in POINTS:
        assert port[name]["review_passed"] is True
        assert port[name]["tokens_per_s"] > 0 and port[name]["tok_per_j"] > 0
        assert "accelerator_j" not in port[name]      # modeled on the CPU
    assert port["allocator"]["page_alloc_ops_per_s"] > 0


@pytest.mark.parametrize("key", ["hits", "lookups", "cached_tokens",
                                 "peak_pages", "capacity_ctx"])
def test_cache_accounting_is_the_reference_accounting(both, key):
    got = {name: both["port"][name][key] for name in POINTS}
    assert got == {name: both["ref"][name][key] for name in POINTS}


def test_hits_follow_the_request_stream(both):
    """10 queries at each rate: the shared-prefix ones all hit but the
    first, which pays the intern; each hit caches the 112-token prefix."""
    p = both["port"]
    assert [p[n]["hits"] for n in POINTS] == [0, 4, 8]
    assert all(p[n]["lookups"] == 10 for n in POINTS)
    assert all(p[n]["cached_tokens"] == p[n]["hits"] * tpc.SHARED_LEN
               for n in POINTS)
    assert "j_saved_per_cached_token" not in p["hit0"]
    assert "j_saved_per_cached_token" in p["hit90"]


def test_csv_rows_are_the_reference_rows(both, monkeypatch):
    rows = {}
    for side, mod, fn in (("ref", jpc, "_points"), ("port", tpc, "metrics")):
        monkeypatch.setattr(mod, fn, lambda *a, _m=both[side], **k:
                            copy.deepcopy(_m))
        rows[side] = [r.split(",")[0] for r in mod.csv(smoke=True)]
    assert rows["port"] == rows["ref"] == [
        "prefix_hit0", "prefix_hit50", "prefix_hit90", "prefix_allocator"]


def test_geometry_is_the_reference_geometry():
    names = ("SLOTS", "PAGE_SIZE", "MAX_LEN", "SHARED_LEN", "SUFFIX_LEN",
             "PROMPT_LEN", "NEW_TOKENS", "HIT_RATES", "N_REPS", "QPS")
    assert ({n: getattr(tpc, n) for n in names}
            == {n: getattr(jpc, n) for n in names})
    cfg = tcfg.reduce_config(tcfg.get_config("qwen3-1.7b"))
    for rid in (0, 3, 17):
        for h in (0.0, 0.5, 0.9):
            assert np.array_equal(
                tpc._make_request(cfg, rid, 0.0, h).prompt,
                jpc._make_request(cfg, rid, 0.0, h).prompt)


def test_metrics_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="cuda"):
        tpc.metrics()
