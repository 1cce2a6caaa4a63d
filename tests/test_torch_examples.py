"""The port's examples, scripts and CSV sweep on the CPU:
``repro_torch.examples.quickstart`` and ``serve_power``,
``repro_torch.scripts.dev_smoke`` and ``paged_smoke``, and
``repro_torch.benchmarks.run``.

- quickstart: reduced qwen3-1.7b trains 10 steps, every loss finite, the
  modeled edge watts equal the reference's formula evaluated by the
  reference's own modules, the review ACCEPTs (its window relaxed to 0 s:
  a fast run can fall under the reference's 1 s);
- serve_power: reduced granite-3-2b under Offline and Server (a 3 s
  Server window: under ~2 s R12's sample coverage can refuse it, in
  either package), both reviews ACCEPT;
- dev_smoke: every arch of ``configs.list_archs()`` (the ten assigned,
  edge-vit and tiny-kws) reduced: loss, prefill and 2 decode steps
  finite;
- paged_smoke: every TP 1 parity and the sharded ones at TP 2 over gloo
  ranks;
- run.py with stubbed modules (rows, a smoke-aware one, one that raises,
  one that emits an ERROR row, one that takes a device) gives the
  reference's CSV rows, ERROR count and exit code;
- every entry point defaults to CUDA and raises without a GPU.
"""
import math
import types

import pytest
import torch

import benchmarks
import benchmarks.run as j_run
from repro_torch.benchmarks import run as t_run
from repro_torch.configs import list_archs
from repro_torch.examples import quickstart, serve_power
from repro_torch.scripts import dev_smoke, paged_smoke

torch.set_num_threads(1)


def test_quickstart_trains_and_accepts():
    from repro import configs as jcfg
    from repro.core import StepWork, SystemPowerModel
    from repro.hw import EDGE_SYSTEM
    out = quickstart.main(["--device", "cpu", "--reduce",
                           "--min-duration", "0"])
    assert len(out["losses"]) == 10
    assert all(math.isfinite(x) for x in out["losses"])
    n = jcfg.reduce_config(jcfg.get_config("qwen3-1.7b")).param_count()
    want = SystemPowerModel(EDGE_SYSTEM, 1).system_watts(
        StepWork(flops=6.0 * n * 8 * 64, hbm_bytes=6.0 * n * 4))
    assert out["watts"] == want
    assert out["review"].passed
    assert out["summary"].energy_j > 0


def test_serve_power_accepts_both_scenarios():
    out = serve_power.main(["--device", "cpu", "--reduce",
                            "--min-duration", "1", "--server-duration",
                            "3"])
    assert out["cfg"].n_layers < 40             # the reduced config
    assert out["offline"].passed and out["server"].passed
    assert out["offline"].outcome.result.n_queries > 0
    assert out["server"].outcome.server.total_tokens > 0
    assert out["host_syncs"] > 0


@pytest.mark.parametrize("arch", list_archs())
def test_dev_smoke(arch):
    r = dev_smoke.smoke(arch, "cpu")
    assert math.isfinite(r["loss"]) and r["loss"] > 0
    if arch != "tiny-kws":
        assert r["logits_shape"][:2] == (2, 1)


def test_device_config_widens_the_heads_the_kernels_take():
    """On CUDA the reduced heads of 32 become 64 (the kernels' smallest
    build) where attention reaches the kernels; MLA, RWKV, tiny-kws and
    the CPU keep the reduced config.  Each widened config trains and
    prefills on the CPU."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import build_model
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for arch in list_archs():
        cfg = reduce_config(get_config(arch))
        assert dev_smoke.device_config(cfg, cpu) is cfg
        wide = dev_smoke.device_config(cfg, cuda)
        if arch in ("deepseek-v3-671b", "rwkv6-3b", "tiny-kws"):
            assert wide is cfg, arch
            continue
        assert wide.head_dim == 64 and cfg.head_dim == 32, arch
        assert (wide.n_layers, wide.d_model, wide.n_heads, wide.n_kv_heads,
                wide.vocab_size) == (cfg.n_layers, cfg.d_model, cfg.n_heads,
                                     cfg.n_kv_heads, cfg.vocab_size), arch
        model = build_model(wide, "cpu")
        batch = dev_smoke.batch_for(wide, cpu)
        with torch.no_grad():
            loss, _ = model.train_loss(model.init(seed=1), batch)
        assert math.isfinite(float(loss)), arch


def test_dev_smoke_defaults_to_the_assigned_archs(monkeypatch):
    from repro_torch.configs import ASSIGNED_ARCHS
    seen = []
    monkeypatch.setattr(dev_smoke, "smoke", lambda arch, device: seen.append(
        (arch, device)) or {"arch": arch, "loss": 1.0})
    dev_smoke.main(["--device", "cpu"])
    assert seen == [(a, "cpu") for a in ASSIGNED_ARCHS]


def test_paged_smoke_parities_at_tp_1_and_tp_2(capfd):
    """The ranks print from their own processes: read at the fd."""
    assert paged_smoke.main(["--device", "cpu", "--tp", "2"]) == 0
    out = capfd.readouterr().out
    for line in ("TP=1 paged parity OK (in-order pool)",
                 "TP=1 paged parity OK (shuffled pool order)",
                 "TP=1 chunked-prefill parity OK (chunks=9)",
                 "prefix-hit parity OK", "speculative paged parity OK",
                 "TP=1 preempt/resume parity OK",
                 "TP=2: 2 gloo ranks on the CPU",
                 "TP=2 paged parity OK", "TP=2 chunked-prefill parity OK",
                 "TP=2 preempt/resume parity OK", "all parities hold"):
        assert out.count(f"[paged-smoke] {line}") == 1, line


def _stubs():
    """Five stub modules and twelve plain ones, in run.py's order."""
    def raising():
        raise ValueError("stub")

    special = [
        types.SimpleNamespace(
            csv=lambda: ["stub_a,1.500,x=1", "stub_b,2.000,"]),
        types.SimpleNamespace(
            csv=lambda smoke=False: [f"stub_c,0.000,smoke={smoke}"]),
        types.SimpleNamespace(csv=raising),
        types.SimpleNamespace(csv=lambda: ["stub_d,0.0,ERROR:emitted"]),
        types.SimpleNamespace(
            csv=lambda device="cuda": [f"stub_e,0.000,device={device}"]),
    ]
    plain = [types.SimpleNamespace(csv=lambda i=i: [f"plain_{i},0.000,ok"])
             for i in range(12)]
    return special + plain


def _rows(text):
    return [ln for ln in text.splitlines()
            if not ln.startswith("# elapsed") and not ln.startswith(
                "# summary")], [ln.rsplit(",", 1)[0] for ln in
                                text.splitlines()
                                if ln.startswith("# summary")]


@pytest.mark.parametrize("smoke", [False, True])
def test_run_gives_the_reference_s_csv_errors_and_exit_code(
        monkeypatch, capsys, smoke):
    stubs = _stubs()
    names = [n for n, _ in t_run.MODULES]
    ref_mods = ["power_range", "efficiency_trends", "scaling_energy",
                "energy_per_inference", "accuracy_cost",
                "quantization_efficiency", "sw_hw_optimizations",
                "roofline_table", "tiny_edge_measured",
                "serving_throughput", "scale_sweep",
                "speculative_efficiency", "power_breakdown", "resilience",
                "prefix_cache", "slo_sweep", "fleet_sweep"]
    assert [m for _, m in t_run.MODULES] == ref_mods
    for mod, stub in zip(ref_mods, stubs):
        monkeypatch.setattr(benchmarks, mod, stub, raising=False)
    argv = ["--smoke"] if smoke else []
    with pytest.raises(SystemExit) as ref_exit:
        j_run.main(argv)
    want = capsys.readouterr().out
    monkeypatch.setattr(t_run, "MODULES", list(zip(names, stubs)))
    with pytest.raises(SystemExit) as port_exit:
        t_run.main(argv)
    got = capsys.readouterr().out
    assert ref_exit.value.code == port_exit.value.code == 1
    assert _rows(got) == _rows(want)
    assert "# summary: 18 rows, 2 ERROR" in got
    assert f"stub_c,0.000,smoke={smoke}" in got
    assert "fig5_scaling_energy,0.0,ERROR:ValueError" in got


def test_run_passes_its_device(monkeypatch, capsys):
    seen = []
    mod = types.SimpleNamespace(
        csv=lambda device="cuda", smoke=False: seen.append(
            (device, smoke)) or ["x,0.000,ok"])
    monkeypatch.setattr(t_run, "MODULES", [("x", mod)])
    t_run.main(["--device", "cpu", "--smoke"])
    assert seen == [("cpu", True)]
    assert "# summary: 1 rows, 0 ERROR" in capsys.readouterr().out


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    for main in (quickstart.main, serve_power.main, dev_smoke.main,
                 paged_smoke.main):
        with pytest.raises(RuntimeError, match="cuda"):
            main([])
