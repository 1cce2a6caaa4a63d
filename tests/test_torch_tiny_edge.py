"""``repro_torch.benchmarks.tiny_edge_measured`` against the reference's
``benchmarks/tiny_edge_measured.py``, on the CPU.

Each of the four runs goes through both packages' harness, the
Offline and MultiStream ones at 3 s windows on both sides.  The rows'
keys equal the reference's and every review ACCEPTs.  Every modeled
figure that no measured latency enters equals the reference's within
1e-12: the tiny run's µJ/inference and inferences/J (its duty-cycled MCU
waveform is fixed by the MACs, the SRAM bytes and the frame period) and
the synthetic pipeline's samples/J.  Latencies, and the edge runs'
figures that their measured throughput shapes, are each package's own.
edge-vit runs at the reference's reduced config here (``reduce``); the
card runs it at full width (chip_smoke.py phase 28 (c)).
"""
import functools
import math

import pytest
import torch

import benchmarks.tiny_edge_measured as j_tem
from repro_torch.benchmarks import tiny_edge_measured as t_tem

torch.set_num_threads(1)


WINDOW_S = 3.0


@pytest.fixture(scope="module")
def rows():
    """(port rows, reference rows), one run of each function; the
    Offline and MultiStream runs on both sides at ``WINDOW_S`` (the
    reference's 1.0 and 0.5 s windows can miss R12's 95 % coverage by
    one 10 Hz sample on a loaded host, in either package)."""
    port = [t_tem.tiny_single_stream("cpu"),
            t_tem.edge_offline("cpu", reduce=True, min_duration_s=WINDOW_S),
            t_tem.edge_multi_stream("cpu", min_duration_s=WINDOW_S),
            t_tem.full_pipeline_compliance()]
    with pytest.MonkeyPatch.context() as mp:
        for name in ("Offline", "MultiStream"):
            cls = getattr(j_tem, name)
            mp.setattr(j_tem, name, functools.partial(
                _at_window, cls))
        ref = [j_tem.tiny_single_stream(), j_tem.edge_offline(),
               j_tem.edge_multi_stream(), j_tem.full_pipeline_compliance()]
    return port, ref


def _at_window(cls, **kw):
    kw["min_duration_s"] = WINDOW_S
    return cls(**kw)


def test_rows_keys_and_names_equal_the_reference(rows):
    port, ref = rows
    assert [r["name"] for r in port] == [r["name"] for r in ref]
    for p, r in zip(port, ref):
        assert list(p) == list(r), p["name"]


def test_every_review_accepts(rows):
    for side, rs in zip(("port", "reference"), rows):
        for r in rs:
            assert r["review_passed"] is True, (side, r["name"])


def test_latency_free_figures_equal_the_reference(rows):
    (tiny, _, _, pipe), (j_tiny, _, _, j_pipe) = rows
    for key in ("measured_uj_per_inf", "inv_joules"):
        assert math.isclose(tiny[key], j_tiny[key], rel_tol=1e-12), key
    assert math.isclose(pipe["samples_per_joule"],
                        j_pipe["samples_per_joule"], rel_tol=1e-12)


def test_measured_figures_are_positive_and_finite(rows):
    for r in rows[0]:
        for k, v in r.items():
            if isinstance(v, float):
                assert math.isfinite(v) and v > 0, (r["name"], k, v)


def test_csv_formats_rows_as_the_reference(rows, monkeypatch):
    """The same rows through both ``csv``s give the same lines."""
    port, ref = rows
    monkeypatch.setattr(t_tem, "run", lambda device="cuda": ref)
    monkeypatch.setattr(j_tem, "run", lambda: ref)
    assert t_tem.csv("cpu") == j_tem.csv()
    assert len(t_tem.csv("cpu")) == 4


def test_reduce_is_the_reference_s_reduced_edge_vit():
    from repro import configs as jcfg
    cfg, _ = t_tem.edge_loss_forward("cpu", reduce=True)
    ref = jcfg.reduce_config(jcfg.get_config("edge-vit"))
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab_size", "dtype"):
        assert getattr(cfg, f) == getattr(ref, f), f
    assert cfg.vlm.n_patches == ref.vlm.n_patches


def test_runs_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    for fn in (t_tem.tiny_single_stream, t_tem.edge_offline,
               t_tem.edge_multi_stream, t_tem.run):
        with pytest.raises(RuntimeError, match="cuda"):
            fn()
