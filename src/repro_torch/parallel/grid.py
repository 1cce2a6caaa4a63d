"""The process grid of sharded training: ``(data, model)`` coordinates
of each rank of a ``torch.distributed`` world, and one process group
per data row and per model column (the counterpart of the reference's
``make_mesh((d, m), ("data", "model"))``, whose devices GSPMD and
``shard_map`` address by the same two axes).

Ranks are laid out row-major, as the reference's mesh orders its
devices: rank ``r`` sits at ``(r // model, r % model)``.  ``model_group``
holds the ranks of this rank's data row (the collectives "over model":
tensor and expert parallelism), ``data_group`` those of its model
column (the collectives "over data": data parallelism and FSDP).  Every
rank creates every group, in the same order, as ``dist.new_group``
requires.

  grid = Grid(data=2, model=2, device="cpu")   # inside a process group
  grid.coords, grid.mesh, grid.rules(cfg)
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import MeshSpec, make_mesh


class Grid:
    """This rank's place in a ``data`` x ``model`` grid of ranks."""

    def __init__(self, data: int, model: int, device="cpu"):
        if not dist.is_initialized():
            raise RuntimeError("Grid: torch.distributed is not initialised")
        world = dist.get_world_size()
        if data * model != world:
            raise ValueError(f"grid {data} x {model} != world of {world}")
        self.data, self.model = data, model
        self.device = torch.device(device)
        self.rank = dist.get_rank()
        self.data_group = self.model_group = None
        # every rank makes every group, in one order: the model rows,
        # then the data columns
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)])
            if d == self.coords[0]:
                self.model_group = g
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)])
            if m == self.coords[1]:
                self.data_group = g

    @property
    def coords(self) -> tuple[int, int]:
        """(data index, model index) of this rank."""
        return divmod(self.rank, self.model)

    @property
    def axis_coords(self) -> dict:
        """{"data": index, "model": index}: ``shard_tree``'s coords."""
        return dict(zip(("data", "model"), self.coords))

    @property
    def mesh(self) -> MeshSpec:
        return make_mesh((self.data, self.model), ("data", "model"))

    def group(self, axis: str):
        """The process group of mesh axis ``axis``."""
        return {"data": self.data_group, "model": self.model_group}[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.coords[("data", "model").index(axis)]

    def rules(self, cfg):
        """The reference's train-mode table on this grid's mesh
        (``make_rules(cfg, mesh, "train")``)."""
        from repro_torch.parallel.sharding import make_rules
        return make_rules(cfg, self.mesh, "train")
