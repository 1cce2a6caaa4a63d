"""Production mesh descriptions (PyTorch port of ``launch/mesh.py``).

A ``MeshSpec`` names the mesh axes and their sizes and holds no device:
the dry-run counts the program one device runs under a mesh's sharding
rules (``launch/specs.py``), so a 512-device mesh costs nothing here.
A ``MeshSpec`` is never built from devices: the port runs across
cards through ``torch.distributed`` process groups
(``parallel.launch.run_tp``, ``run_grid``), not through a device mesh.
``make_host_mesh`` (the reference's: whatever devices jax sees) takes
the visible cards on ``cuda`` and a rank count the caller gives on the
CPU, the counterpart of ``--xla_force_host_platform_device_count``.

  mesh = make_production_mesh(multi_pod=True)   # 2x16x16 pod, data, model
  mesh.shape["model"], mesh.axis_names, mesh.size
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Axis names and sizes of a device mesh, without devices.
    ``shape`` maps each axis to its size in axis order, as
    ``jax.sharding.Mesh.shape`` does."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.axis_sizes} differ in length")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """Single pod: 16x16 (data, model) = 256 chips.
    Multi-pod: 2x16x16 (pod, data, model) = 512 chips."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshSpec(axes, shape)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> MeshSpec:
    """Arbitrary mesh (scaling studies, tests, pipeline stages)."""
    return MeshSpec(tuple(axes), tuple(shape))


def make_host_mesh(model: int = 1, *, device="cuda",
                   devices: int | None = None) -> MeshSpec:
    """The (data, model) mesh of this host: on ``cuda`` its visible
    cards (``devices``, when given, must not exceed them), on the CPU
    ``devices`` ranks (required).  Raises unless ``model`` divides the
    world."""
    import torch
    kind = torch.device(device).type
    if kind == "cuda":
        have = torch.cuda.device_count()
        if have < 1:
            raise RuntimeError("make_host_mesh: no CUDA device is visible")
        n = have if devices is None else devices
        if n > have:
            raise ValueError(f"{n} ranks need {n} cards, {have} visible")
    elif devices is None:
        raise ValueError("make_host_mesh on the CPU needs a rank count "
                         "(devices=N)")
    else:
        n = devices
    if model < 1 or n % model:
        raise ValueError(f"model axis {model} does not divide a world of "
                         f"{n}")
    return make_mesh((n // model, model), ("data", "model"))


def make_tp_mesh(tp: int, axis: str = "model") -> MeshSpec:
    """1-D tensor-parallel mesh of ``tp`` shards (the sharded serving
    engine's layout; its processes are ``parallel.launch.run_tp``'s)."""
    if tp < 1:
        raise ValueError(f"tp={tp} < 1")
    return make_mesh((tp,), (axis,))
