"""``launch.train_e2e --smoke`` on the CPU: 12 steps of the ~106M
float32 model at 4 x 64 tokens through an injected failure (at step 4,
before the first checkpoint: the run restarts its step count with the
weights it has, as the reference's supervisor does), the modeled
energy-to-train and the compliance review (about 45 s).
"""
import os

import torch

from repro_torch.launch import train_e2e

torch.set_num_threads(2)


def test_train_e2e_smoke(capsys):
    out = train_e2e.main(["--smoke", "--device", "cpu"])
    rep = out["report"]
    assert rep.final_step == 12 and rep.failures == 1
    assert len(out["losses"]) >= 12
    assert out["summary"].energy_j > 0
    text = capsys.readouterr().out
    assert "injected node failure at step 4" in text
    assert "MLPerf Power compliance review" in text
    assert not os.path.exists(out["ckpt"].dir)      # its own temp dir
    assert 100e6 < train_e2e.model_100m().param_count() < 110e6
