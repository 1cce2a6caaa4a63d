"""Fig. 8: quantization-driven efficiency at fixed accuracy targets
(port of ``benchmarks/quantization_efficiency.py``).

Per arch, normalized Samples/J for the bf16, fp16, fp8 and int8
deployments of the same prefill cell (the dry-run's records, modeled on
the H100 system, ``common.SYSTEM``) -- the FP8-closes-the-gap story of
Fig. 8 -- plus a real measurement on the tiny keyword spotter
(``tiny_accuracy_measurement``): its four pointwise matmuls (M = 256 x
49 = 12,544 rows, K = N = 64) run as int8 GEMMs with per-row
activation and per-column weight scales and float32 output, and the
logits are held against the float32 forward -- the
int8-meets-the-99%-target premise of the paper's quantization study.

  PYTHONPATH=src python -m repro_torch.benchmarks.quantization_efficiency
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.benchmarks import common
from repro_torch.benchmarks.common import csv_row, load_cell
from repro_torch.configs import get_config
from repro_torch.core.power_model import StepWork, SystemPowerModel, roofline
from repro_torch.kernels.int8_matmul import (int8_matmul, int8_matmul_plain,
                                             quantize_int8)
from repro_torch.models.param import from_jax, tree_leaves
from repro_torch.models.tiny import IN_F, IN_T, TinyModel, depthwise_conv

BATCH = 256

ARCHS = ["yi-9b", "qwen3-1.7b", "granite-3-2b"]
# effective precisions: (flops path, bytes scale) vs bf16 baseline
PRECISIONS = {
    "bf16": dict(int8=False, byte_scale=1.0, flop_scale=1.0),
    "fp16": dict(int8=False, byte_scale=1.0, flop_scale=1.0),
    "fp8": dict(int8=True, byte_scale=0.5, flop_scale=1.0),
    "int8": dict(int8=True, byte_scale=0.5, flop_scale=1.0),
}
# which precision meets which accuracy target (paper's Fig. 8 narrative)
TARGET_99 = "int8"
TARGET_999_OLD = "fp16"       # pre-v3.1 submissions
TARGET_999_NEW = "fp8"        # v3.1+ hardware


def _eff(rec, precision: str) -> float:
    """Samples/J (up to a constant) of a cell's step at ``precision`` on
    ``common.SYSTEM``."""
    p = PRECISIONS[precision]
    system = common.SYSTEM
    base = StepWork(rec["flops"], rec["hbm_bytes"], rec["coll_bytes"])
    work = StepWork(base.flops * p["flop_scale"],
                    base.hbm_bytes * p["byte_scale"],
                    base.ici_bytes * p["byte_scale"],
                    flops_int8=base.flops if p["int8"] else 0.0)
    model = SystemPowerModel(system, rec["n_devices"])
    rt = roofline(work, system.chip)
    watts = model.system_watts(work, rt.step_s)
    return 1.0 / (watts * rt.step_s)          # samples/J up to const


def run(device="cuda") -> list[dict]:
    """One row per ``ARCHS`` arch with a prefill record (efficiency at
    the 99.9% targets relative to int8 at 99%), then the tiny
    measurement on ``device``."""
    rows = []
    for arch in ARCHS:
        rec = load_cell(arch, "prefill_32k", "pod")
        if rec is None:
            continue
        base = _eff(rec, TARGET_99)
        rows.append({
            "arch": arch,
            "eff_99_int8": 1.0,
            "eff_999_fp16": _eff(rec, TARGET_999_OLD) / base,
            "eff_999_fp8": _eff(rec, TARGET_999_NEW) / base,
        })
    rows.append(tiny_accuracy_measurement(device))
    return rows


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


def csv(device="cuda") -> list[str]:
    out = []
    for r in run(device):
        if "eff_999_fp8" in r:
            out.append(csv_row(
                f"fig8_quant[{r['arch']}]", 0.0,
                f"eff99_int8=1.0;eff999_fp16={r['eff_999_fp16']:.3f};"
                f"eff999_fp8={r['eff_999_fp8']:.3f}"))
        else:
            out.append(csv_row(
                "fig8_quant[tiny_accuracy]", 0.0,
                f"agree={r['int8_argmax_agreement']:.4f};"
                f"rel={r['int8_rel_err']:.4f}"))
    return out


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    for r in run(ap.parse_args().device):
        print(r)
