"""Atomic checkpoints in the reference's on-disk format (PyTorch port of
the reference ``checkpoint/manager.py``).

Layout: ``<dir>/step_<k:08d>/`` holding one ``.npy`` per leaf, named
from the leaf's key path as the reference's ``_flatten`` names it (a
NamedTuple field ``.name``, a dict key as itself, a list index ``#i``,
joined by ``/``; the file name with ``/`` as ``__``), plus ``meta.json``
(step, the manifest of file, shape and dtype per key, extra metadata).
A ``TrainState`` gives ``.params/<name>``, ``.opt/.step``,
``.opt/.m/<name>``, ``.opt/.v/<name>``, ``.opt/.m_scale/<name>`` (int8
moments) and ``.step``.  Writes go to ``step_<k>.tmp`` and are renamed
only after ``meta.json`` is fsynced, so a crash mid-write never
corrupts the newest checkpoint; the oldest past ``keep`` are removed.

bfloat16 leaves are written as the reference writes them: numpy has no
bfloat16, so the file holds the raw 16-bit values under the descr
``<V2`` and the manifest says ``"bfloat16"``.  ``restore`` reads such a
leaf back bit for bit; a checkpoint either package wrote restores in
the other (the reference's own ``restore`` cannot cast ``<V2`` to
bfloat16, whoever wrote it).

Sharded training (a ``parallel.grid.Grid`` and the partition specs of
what is saved, e.g. ``train_state_pspecs``): ``save`` gathers one
leaf at a time whole over the grid, rank 0 alone writes it, in the same
format, and every rank frees it before the next is gathered, so that
a card holds its own blocks and one full leaf, as the reference copies
one leaf at a time to the host (``meta.json`` gets the grid as
``"mesh": "DxM"`` unless the caller names one); ``restore`` gives each
rank its block of each full leaf.  ``restore(..., shardings=)`` takes
the layout per leaf (a tree of ``parallel.sharding.Shard``, the
reference's ``NamedSharding``), so a checkpoint saved on one layout
restores on any other: one rank, a (1, 2) grid, or the reference's.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

_NP = {torch.float32: np.float32, torch.int32: np.int32,
       torch.int8: np.int8, torch.int64: np.int64,
       torch.float16: np.float16, torch.uint8: np.uint8}


def _flatten(tree, prefix: str = "", specs: bool = False) -> dict[str, Any]:
    """{key path: leaf} in the reference's key format; ``None`` holds no
    leaf.  ``specs``: ``tree`` holds partition specs, plain tuples taken
    as leaves."""
    def join(k):
        return f"{prefix}/{k}" if prefix else k

    if tree is None:
        return {}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for name in tree._fields:
            out.update(_flatten(getattr(tree, name), join(f".{name}"),
                                specs))
        return out
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], join(str(k)), specs))
        return out
    if isinstance(tree, (list, tuple)) and not specs:
        out = {}
        for i, x in enumerate(tree):
            out.update(_flatten(x, join(f"#{i}")))
        return out
    return {prefix: tree}


def _unflatten(template, loaded: dict, prefix: str = ""):
    """``template``'s structure with each leaf taken from ``loaded``."""
    def join(k):
        return f"{prefix}/{k}" if prefix else k

    if template is None:
        return None
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(
            _unflatten(getattr(template, n), loaded, join(f".{n}"))
            for n in template._fields))
    if isinstance(template, dict):
        return {k: _unflatten(v, loaded, join(str(k)))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(x, loaded, join(f"#{i}"))
                              for i, x in enumerate(template))
    return loaded[prefix]


def _save_leaf(path: str, t: torch.Tensor) -> tuple[list, str]:
    """Write one leaf; returns (shape, manifest dtype)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        raw = t.view(torch.int16).numpy()
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": "<V2", "fortran_order": False,
                    "shape": tuple(raw.shape)})
            f.write(raw.tobytes())
        return list(raw.shape), "bfloat16"
    if t.dtype not in _NP:
        raise TypeError(f"checkpoint: no numpy dtype for {t.dtype}")
    arr = t.numpy()
    np.save(path, arr)
    return list(arr.shape), str(arr.dtype)


def _load_leaf(path: str, dtype_name: str, like: torch.Tensor, cut=None):
    """One leaf onto ``like``'s device and dtype (cast where the file's
    dtype differs, as the reference's restore casts); ``cut`` (a
    ``Shard``) takes its block first."""
    arr = np.load(path)
    if dtype_name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if cut is not None:
        t = cut(t)
    return t.to(device=like.device, dtype=like.dtype)


class CheckpointManager:
    """``grid`` and ``pspecs`` (the partition specs of the trees saved
    and restored, e.g. ``train_state_pspecs``): sharded training's
    checkpoints; see the module docstring."""

    def __init__(self, directory: str, keep: int = 3, *, grid=None,
                 pspecs=None):
        if (grid is None) != (pspecs is None):
            raise ValueError("a sharded checkpoint needs grid and pspecs")
        self.dir = directory
        self.keep = keep
        self.grid, self.pspecs = grid, pspecs
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree, extra_meta: Optional[dict] = None):
        if self.grid is None:
            return self._write(step, _flatten(tree).items(), extra_meta)
        import torch.distributed as dist

        from repro_torch.parallel.sharding import gather_leaf
        specs = _flatten(self.pspecs, specs=True)
        # gathered as they are written: one full leaf alive at a time
        full = ((k, gather_leaf(t, specs[k], self.grid))
                for k, t in _flatten(tree).items())
        meta = {"mesh": f"{self.grid.data}x{self.grid.model}"}
        meta.update(extra_meta or {})
        final = None
        if self.grid.rank == 0:
            final = self._write(step, full, meta)
        else:
            for _, leaf in full:        # join every gather
                del leaf
        dev = self.grid.device
        dist.barrier(device_ids=[dev.index or 0] if dev.type == "cuda"
                     else None)
        return final

    def _write(self, step: int, leaves, extra_meta: Optional[dict] = None):
        """Write (key, leaf) pairs ``leaves`` as checkpoint ``step``; each
        leaf is dropped once written, before the next is drawn."""
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {}
        for key, leaf in leaves:
            fname = key.replace("/", "__") + ".npy"
            shape, dtype = _save_leaf(os.path.join(tmp, fname), leaf)
            del leaf
            manifest[key] = {"file": fname, "shape": shape, "dtype": dtype}
        meta = {"step": step, "manifest": manifest}
        meta.update(extra_meta or {})
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                      # atomic publish
        self._gc()
        return final

    def _gc(self):
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def all_steps(self) -> list[int]:
        return sorted(int(name.split("_")[1]) for name in os.listdir(self.dir)
                      if name.startswith("step_")
                      and not name.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None,
                shardings=None):
        """(tree, meta): the checkpoint at ``step`` (the newest without
        one) in ``template``'s structure, each leaf on its template
        leaf's device and in its dtype.  ``shardings``: a tree matching
        ``template`` of ``parallel.sharding.Shard`` (or ``None`` leaves):
        each full leaf is cut to the block it names; by default the
        manager's grid and pspecs give this rank's blocks."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        meta = self.meta(step)
        cut = {}
        if shardings is not None:
            cut = _flatten(shardings)
        elif self.grid is not None:
            from repro_torch.parallel.sharding import Shard
            coords = self.grid.axis_coords
            cut = {k: Shard(sp, self.grid.mesh, coords) for k, sp in
                   _flatten(self.pspecs, specs=True).items()}
        loaded = {}
        for key, leaf in _flatten(template).items():
            info = meta["manifest"][key]
            t = _load_leaf(os.path.join(d, info["file"]), info["dtype"],
                           leaf, cut.get(key))
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: restored {tuple(t.shape)} into "
                                 f"a template leaf of {tuple(leaf.shape)}")
            loaded[key] = t
        return _unflatten(template, loaded), meta

    def meta(self, step: Optional[int] = None) -> dict:
        if step is None:
            step = self.latest_step()
        with open(os.path.join(self.dir, f"step_{step:08d}",
                               "meta.json")) as f:
            return json.load(f)
