"""Deterministic synthetic data pipeline (PyTorch port of the reference
``data/pipeline.py``).

Every batch is a pure function of ``(seed, step)``, drawn by the same
numpy generator and formula as the reference, so the tokens are bit for
bit the reference's: after a failure and a checkpoint restore at step
k, the pipeline regenerates exactly batches k, k + 1, ... with no replay
or skip bookkeeping.  Each host can draw only its shard (``host_id``,
``n_hosts``).  Batches are int32 tensors on ``device`` (default
``cuda``).

Also document packing (concatenate and split with EOS boundaries).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass
class SyntheticTokens:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1
    # Markov-ish structure so that the loss can fall during training
    # (uniform noise cannot be learnt)
    structure: float = 0.8
    device: str = "cuda"

    def batch(self, step: int) -> dict:
        """{"tokens", "labels"}: (local batch, seq_len) int32 on
        ``device``, the labels the tokens shifted by one."""
        if self.global_batch % self.n_hosts:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {self.n_hosts} hosts")
        local_b = self.global_batch // self.n_hosts
        rng = np.random.default_rng(
            np.uint64(self.seed * 1_000_003 + step) * np.uint64(2654435761)
            + np.uint64(self.host_id))
        shape = (local_b, self.seq_len + 1)
        noise = rng.integers(0, self.vocab_size, size=shape, dtype=np.int64)
        # structured component: next token = (prev * 31 + 7) % vocab
        toks = np.empty(shape, dtype=np.int64)
        toks[:, 0] = noise[:, 0]
        use_rule = rng.random(shape) < self.structure
        for t in range(1, shape[1]):
            ruled = (toks[:, t - 1] * 31 + 7) % self.vocab_size
            toks[:, t] = np.where(use_rule[:, t], ruled, noise[:, t])
        dev = resolve_device(self.device)
        return {
            "tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)).to(dev),
            "labels": torch.from_numpy(toks[:, 1:].astype(np.int32)).to(dev),
        }

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def pack_documents(docs: list[np.ndarray], seq_len: int, eos: int,
                   pad: int = 0) -> np.ndarray:
    """Concatenate docs with EOS separators and split into rows."""
    stream: list[int] = []
    for d in docs:
        stream.extend(int(x) for x in d)
        stream.append(eos)
    n_rows = max(1, len(stream) // seq_len)
    stream = stream[: n_rows * seq_len]
    if not stream:
        stream = [pad] * seq_len
        n_rows = 1
    return np.asarray(stream, dtype=np.int32).reshape(n_rows, seq_len)


def batch_for_shape(cfg, shape, *, step: int = 0, seed: int = 0,
                    device="cuda") -> dict:
    """A concrete batch for an (arch, shape) cell.  A VLM's tokens make
    room for its ``n_patches`` float32 ``patch_embeds``; an encdec batch
    has float32 ``frames`` (B, enc_len, d_model).  Both are drawn from a
    ``torch.Generator`` seeded ``seed + step`` on ``device``: the
    reference draws them from ``jax.random``, so only their shapes and
    dtypes match its."""
    dev = resolve_device(device)
    gen = SyntheticTokens(cfg.vocab_size, shape.seq_len, shape.global_batch,
                          seed=seed, device=dev)
    batch = gen.batch(step)

    def normal(*dims):
        g = torch.Generator(device=dev)
        g.manual_seed(seed + step)
        return torch.randn(dims, generator=g, dtype=torch.float32,
                           device=dev)

    if cfg.vlm is not None:
        n_p = cfg.vlm.n_patches
        batch["tokens"] = batch["tokens"][:, : shape.seq_len - n_p]
        batch["labels"] = batch["labels"][:, : shape.seq_len - n_p]
        batch["patch_embeds"] = normal(
            shape.global_batch, n_p, cfg.vlm.patch_embed_dim or cfg.d_model)
    if cfg.family == "encdec":
        batch["frames"] = normal(shape.global_batch, cfg.encdec.enc_len,
                                 cfg.d_model)
    return batch
