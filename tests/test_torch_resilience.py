"""The port's resilience benchmark against the reference's
``benchmarks/resilience.py``: both are modeled (numpy service times,
``CallableSUT`` replicas, the virtual meter stack) on the same seeds, so
their metrics and CSV rows must be equal, key for key and bit for bit."""
import copy
import os
import sys

import pytest

from repro_torch.benchmarks import resilience as tres

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
from benchmarks import resilience as jres  # noqa: E402


@pytest.fixture(scope="module")
def both():
    return {"ref": jres.metrics(smoke=True), "port": tres.metrics(smoke=True)}


def test_smoke_metrics_are_the_reference_metrics(both):
    assert both["port"] == both["ref"]
    m = both["port"]
    assert set(m) == {"baseline", "meter_dropout", "replica_crash",
                      "overload"}
    # the hardened runs stay valid where the naive ones die or are
    # refused, and overload is shed rather than served late
    for mode in ("meter_dropout", "replica_crash"):
        assert m[mode]["valid_rate"] == 1.0
        assert m[mode]["naive_valid_rate"] == 0.0
    assert m["overload"]["l1"]["n_shed"] > 0


@pytest.mark.parametrize("name", ["SEED", "TARGET_QPS", "SLO_S",
                                  "SERVICE_QPS", "WINDOW_S", "N_REPLICAS",
                                  "DROPOUT_S", "CRASH_AT_S", "BURST_QPS"])
def test_constants_are_the_reference_constants(name):
    assert getattr(tres, name) == getattr(jres, name)


@pytest.mark.parametrize("mode", ["meter_dropout", "replica_crash",
                                  "overload"])
@pytest.mark.parametrize("hardened", [False, True])
def test_mildest_level_runs_are_the_reference_runs(mode, hardened):
    level = {"meter_dropout": tres.DROPOUT_S, "replica_crash": tres.CRASH_AT_S,
             "overload": tres.BURST_QPS}[mode][0]
    out = {}
    for side, mod in (("ref", jres), ("port", tres)):
        faults, fleet = mod._mode_faults(mode, level)
        out[side] = mod._run(faults, fleet=fleet, hardened=hardened)
    assert out["port"] == out["ref"]


def test_csv_rows_are_the_reference_rows(both, monkeypatch):
    rows = {}
    for side, mod in (("ref", jres), ("port", tres)):
        monkeypatch.setattr(mod, "metrics",
                            lambda smoke=False, _m=both[side]:
                            copy.deepcopy(_m))
        rows[side] = mod.csv(smoke=True)
    assert rows["port"] == rows["ref"]
    assert rows["port"][0].startswith("resilience_baseline,")
    assert len(rows["port"]) == 1 + 3 * 2
