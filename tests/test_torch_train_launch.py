"""The port's training launcher on the CPU: ``launch.train`` (reduced,
6 steps; with int8 moments; its refusals; its default device).
``launch.train_e2e`` is in tests/test_torch_train_e2e.py.
"""
import os

import pytest
import torch

from repro_torch.launch import train as ttrain

torch.set_num_threads(2)


@pytest.mark.parametrize("extra", [[], ["--quant-opt"]])
def test_launch_train_reduced_six_steps(tmp_path, capsys, extra):
    state, rep, summary = ttrain.main([
        "--arch", "qwen3-1.7b", "--reduce", "--steps", "6", "--batch", "4",
        "--seq", "32", "--device", "cpu", "--ckpt-dir", str(tmp_path),
        *extra])
    assert rep.final_step == 6 and rep.failures == 0
    assert int(state.step) == 6 and len(rep.losses) == 6
    assert summary.energy_j > 0
    out = capsys.readouterr().out
    assert "energy-to-train (modeled)" in out and "step 5:" in out
    # checkpoints at 5 and at the end, keep=2
    assert sorted(os.listdir(tmp_path)) == ["step_00000005",
                                            "step_00000006"]
    assert (state.opt.m_scale is not None) == bool(extra)


@pytest.mark.parametrize("argv,match", [
    (["--arch", "deepseek-v3-671b", "--reduce", "--model-axis", "3",
      "--devices", "3"], "§A.8"),
    (["--arch", "tiny-kws"], "tokens only"),
    (["--arch", "whisper-small", "--reduce"], "tokens only"),
])
def test_launch_train_refusals(argv, match):
    with pytest.raises(NotImplementedError, match=match):
        ttrain.main([*argv, "--device", "cpu"])


def test_launch_train_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.main(["--arch", "qwen3-1.7b", "--reduce", "--steps", "1"])
