"""Dev-loop smoke: one train-loss forward, a prefill and 2 decode steps
per reduced arch (PyTorch port of ``scripts/dev_smoke.py``).

  PYTHONPATH=src python -m repro_torch.scripts.dev_smoke [--device cuda]
      [arch ...]                       # default: every ASSIGNED_ARCHS entry

Every value must be finite.  Any arch of ``configs.list_archs()`` may be
named: edge-vit runs as the VLMs do (patch embeddings before the
tokens), tiny-kws (a classifier, no prefill or decode) its loss alone.
``--device`` defaults to ``cuda`` (the prefill and decode steps then go
through the hand-written kernels, at heads of 64: ``device_config``)
and raises without a GPU.  The
reference's ``--ci`` (its tier-1 CI script) has no counterpart here.
"""
from __future__ import annotations

import argparse
import dataclasses
import math

import torch

from repro_torch import resolve_device
from repro_torch.configs import ASSIGNED_ARCHS, get_config, reduce_config
from repro_torch.models import build_model
from repro_torch.models import tiny as tiny_mod


def batch_for(cfg, dev, b=2, s=64) -> dict:
    """The reference's ``batch_for``: tokens drawn from seed 0 (numpy's
    generator here), a VLM's patch embeddings of ones before ``s - P``
    tokens, an encdec's frames of ones."""
    import numpy as np
    rng = np.random.default_rng(0)
    if cfg.family == "tiny":
        return {"mfcc": torch.ones((b, tiny_mod.IN_T, tiny_mod.IN_F),
                                   device=dev),
                "labels": torch.as_tensor(rng.integers(0, cfg.vocab_size, b),
                                          device=dev)}
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                          device=dev)
    batch = {"tokens": tok, "labels": tok}
    if cfg.vlm is not None:
        n_p = cfg.vlm.n_patches
        batch["tokens"] = tok[:, : s - n_p]
        batch["labels"] = tok[:, : s - n_p]
        batch["patch_embeds"] = torch.ones((b, n_p, cfg.d_model),
                                           dtype=torch.float32, device=dev)
    if cfg.family == "encdec":
        batch["frames"] = torch.ones((b, cfg.encdec.enc_len, cfg.d_model),
                                     dtype=torch.float32, device=dev)
    return batch


def device_config(cfg, dev):
    """The reduced config as ``dev`` runs it.  On CUDA the attention
    kernels are built at head dims 64, 96 and 128
    (``kernels.flash_attention.ops.HEAD_DIMS``), so a family whose
    attention reaches them (dense, moe, hybrid, vlm, encdec) gets heads
    of 64 in place of the reduced 32; depth, width, head counts and
    vocabulary stay the reference's reduced ones.  MLA (no kernel) and
    RWKV (the scan is built at 32) keep theirs, as does the CPU."""
    from repro_torch.kernels.flash_attention.ops import HEAD_DIMS
    if (dev.type != "cuda" or cfg.family in ("tiny", "rwkv")
            or cfg.mla is not None or cfg.head_dim in HEAD_DIMS):
        return cfg
    return dataclasses.replace(cfg, d_head=min(HEAD_DIMS))


def _finite(t) -> bool:
    return bool(torch.isfinite(t).all())


@torch.no_grad()
def smoke(arch: str, device="cuda") -> dict:
    """One arch: (loss, the last decode step's logits shape)."""
    dev = resolve_device(device)
    cfg = device_config(reduce_config(get_config(arch)), dev)
    model = build_model(cfg, dev)
    params = model.init(seed=1)
    batch = batch_for(cfg, dev)
    loss, _ = model.train_loss(params, batch)
    assert _finite(loss), (arch, float(loss))
    out = {"arch": arch, "loss": float(loss)}
    if cfg.family == "tiny":
        return out
    # prefill + 2 decode steps
    if cfg.family == "encdec":
        inputs = {"frames": batch["frames"], "tokens": batch["tokens"]}
    else:
        inputs = {k: batch[k] for k in ("tokens", "patch_embeds")
                  if k in batch}
    logits, cache = model.prefill(params, inputs, max_len=96)
    assert _finite(logits), arch
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    for _ in range(2):
        logits, cache = model.decode_step(params, cache, tok)
        assert _finite(logits), arch
        tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    out["logits_shape"] = tuple(logits.shape)
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("archs", nargs="*")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    results = []
    for arch in args.archs or ASSIGNED_ARCHS:
        r = smoke(arch, args.device)
        assert math.isfinite(r["loss"])
        print(f"OK {arch}: loss={r['loss']:.4f}", flush=True)
        results.append(r)
    return results


if __name__ == "__main__":
    main()
