"""The port's ``serving_throughput`` benchmark and its launcher's
``--scenario`` runs on the CPU at reduced size: the benchmark reports
the reference's keys and CSV rows (and each run's review), the launcher
wires ``PowerRun`` for every scenario the reference launcher takes, and
neither falls back to the CPU or to a modeled trace when asked for the
card."""
import os
import sys

import pytest
import torch

from repro_torch.benchmarks import serving_throughput as tst
from repro_torch.launch import serve as tserve

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
from benchmarks import serving_throughput as jst  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def both():
    return {"ref": jst.metrics(smoke=True),
            "port": tst.metrics(device="cpu", smoke=True)}


def test_metrics_have_the_reference_keys(both):
    ref, port = both["ref"], both["port"]
    assert set(ref) <= set(port) and port["device"] == "cpu"
    for name in ("fixed", "continuous"):
        assert set(ref[name]) <= set(port[name])
        assert port[name]["review_passed"] is True
        assert port[name]["tokens_per_s"] > 0 and port[name]["tok_per_j"] > 0
        assert "accelerator_j" not in port[name]      # modeled on the CPU
    assert port["qps"] == ref["qps"] == 200.0
    assert port["chunk_syncs"] > 0 and port["speedup"] > 0


def test_csv_has_the_reference_rows(both, monkeypatch):
    rows = {}
    for side, mod in (("ref", jst), ("port", tst)):
        monkeypatch.setattr(mod, "metrics",
                            lambda *a, _m=both[side], **k: _m)
        rows[side] = [r.split(",")[0] for r in mod.csv(smoke=True)]
    assert rows["port"] == rows["ref"] == [
        "serving_fixed_qps200", "serving_continuous_qps200",
        "serving_continuous_speedup", "serving_meter_overhead"]


def test_traffic_is_the_reference_traffic():
    assert (tst.SLOTS, tst.PROMPT_LEN, tst.MAX_LEN, tst.MIX) == (
        jst.SLOTS, jst.PROMPT_LEN, jst.MAX_LEN, jst.MIX)


def test_metrics_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="cuda"):
        tst.metrics()


# 2 s: at the edge analyzer's 10 Hz a shorter window can deliver under
# the 95 % of its samples that R12 asks for (n = int(window x 10))
LAUNCH = ["--arch", "qwen3-1.7b", "--reduce", "--device", "cpu",
          "--min-duration", "2", "--new-tokens", "3"]


@pytest.mark.parametrize("argv", [
    ["--scenario", "server", "--qps", "16"],
    ["--scenario", "server", "--engine", "fixed", "--qps", "16"],
    ["--scenario", "offline", "--engine", "fixed"],
    ["--scenario", "single-stream", "--engine", "fixed"],
    ["--scenario", "multi-stream", "--engine", "fixed", "--streams", "3"],
], ids=["server-continuous", "server-fixed", "offline-fixed",
        "single-stream-fixed", "multi-stream-fixed"])
def test_launcher_scenarios_pass_review_on_cpu(argv, capsys):
    m = tserve.main(LAUNCH + argv)
    out = capsys.readouterr().out
    assert m["review_passed"], out
    assert "=> ACCEPTED" in out and "review ACCEPTED" in out
    assert m["tokens"] == 3 * m["requests"] > 0
    assert m["energy_j"] == pytest.approx(m["domain_energy_j"]["wall"])
    assert m["measured"] == [] and "(measured" not in out
    assert set(m["domain_energy_j"]) == {"accelerator", "dram", "host",
                                         "wall"}
    assert m["tok_per_j_accelerator"] > m["tok_per_j"] > 0
    # TTFT is the queue-form Server's: the continuous engine's
    assert (m["ttft_p50_s"] >= 0) == ("--engine" not in argv)


def test_launcher_refuses_the_continuous_engine_off_server(capsys):
    with pytest.raises(SystemExit):
        tserve.main(LAUNCH + ["--scenario", "offline"])
    assert "--scenario server" in capsys.readouterr().err


def test_launcher_refuses_the_measured_sync_server(capsys):
    """On the card the fixed engine's synchronous Server is refused
    before a model is built: its queueing waits are modeled."""
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "qwen3-1.7b", "--engine", "fixed",
                     "--scenario", "server"])
    assert "--engine continuous" in capsys.readouterr().err


def test_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.main(["--arch", "qwen3-1.7b", "--reduce"])
