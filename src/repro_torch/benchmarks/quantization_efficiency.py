"""Fig. 8's real measurement: the tiny keyword spotter's W8A8 path
against its float32 forward.

The port of ``benchmarks/quantization_efficiency.py:
tiny_accuracy_measurement``: the tiny model's four pointwise matmuls
(M = 256 x 49 = 12,544 rows, K = N = 64) run as int8 GEMMs with
per-row activation and per-column weight scales and float32 output,
and the logits are held against the float32 forward -- the
int8-meets-the-99%-target premise of the paper's quantization study.
The rest of that benchmark (``load_cell``, the ``DATACENTER_V5E``
power model, ``_eff``) is a TPU power model and is not ported (ROADMAP
§A.13).

  PYTHONPATH=src python -m repro_torch.benchmarks.quantization_efficiency
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.kernels.int8_matmul import (int8_matmul, int8_matmul_plain,
                                             quantize_int8)
from repro_torch.models.param import from_jax, tree_leaves
from repro_torch.models.tiny import IN_F, IN_T, TinyModel, depthwise_conv

BATCH = 256


def tiny_accuracy_measurement(device="cuda", *, params=None, x=None,
                              kernels: bool = True) -> dict:
    """Argmax agreement and relative logit error of the int8 tiny model
    against the float32 one.

    ``params`` (the tiny tree, tensors or numpy arrays) and ``x`` (256,
    49, 10) default to seeded draws on ``device``: ``TinyModel.init(0)``
    and a ``torch.Generator`` seeded 1.  ``kernels=False`` sends the
    GEMMs to ``int8_matmul_plain`` on any device; otherwise a CUDA
    tensor launches the kernel (4 launches) and a CPU tensor takes the
    plain version."""
    dev = resolve_device(device)
    cfg = get_config("tiny-kws")
    model = TinyModel(cfg, dev)
    if params is None:
        params = model.init(seed=0)
    elif any(isinstance(a, np.ndarray) for a in tree_leaves(params)):
        params = from_jax(params, dev)
    if x is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        x = torch.randn((BATCH, IN_T, IN_F), generator=gen, device=dev)
    else:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.array(x, np.float32))
        x = x.to(dev, torch.float32)
    gemm = int8_matmul if kernels else int8_matmul_plain
    ref = model(params, x)
    # int8 path on the dominant pointwise convs (pw matmuls)
    h = x @ params["stem"]
    for i in range(cfg.n_layers):
        conv = depthwise_conv(h, params[f"dw{i}"])
        cq, sx = quantize_int8(conv.reshape(-1, conv.shape[-1]), axis=1)
        wq, sw = quantize_int8(params[f"pw{i}"], axis=0)
        out = gemm(cq, wq, sx, sw, out_dtype=torch.float32)
        h = torch.relu(out.reshape(conv.shape) + params[f"b{i}"])
    q_logits = h.mean(dim=1) @ params["head"]
    agree = float((q_logits.argmax(-1) == ref.argmax(-1)).float().mean())
    rel = float(torch.linalg.norm(q_logits - ref) / torch.linalg.norm(ref))
    return {"arch": "tiny-kws(real)", "int8_argmax_agreement": agree,
            "int8_rel_err": rel, "device": str(dev)}


if __name__ == "__main__":
    print(tiny_accuracy_measurement())
