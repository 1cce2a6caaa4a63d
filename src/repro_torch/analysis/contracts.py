"""Declarative CUDA launch contracts the static checker consumes.

The port's counterpart of ``repro.analysis.contracts``.  Each kernel
package's ``ops.py`` exports ``CONTRACTS``: one ``KernelContract`` per
wrapper.  A contract is a pure description: ``build(case)`` returns the
launches a call of that shape makes, in order, taking its route and
split layout from the wrapper's own ``plan`` and its grids from the
same arithmetic as the C launch code, so that the checker
(``repro_torch.analysis.kernels``) can enumerate every CTA in plain
Python, without a device, and ``chip_smoke.py`` phase 29 can hold each
launch against the one the card records.

Buffers are tiled: a CTA writes (and, for scratch, reads) whole tiles,
named by their tile index (element offset = index * tile).  Every grid
axis of a CUDA launch runs concurrently, so there is no "arbitrary"
axis: a loop inside a CTA is named in ``Launch.loops`` instead.

Budgets are the H100's (sm_90a; the ``hopper-kernels`` guide): 48 KB of
shared memory a CTA without opting in through ``cudaFuncSetAttribute``,
232,448 bytes with it, 1,024 threads a CTA, grid y and z at most
65,535, 65,536 registers an SM and 255 a thread.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

ROLES = ("input", "output", "scratch")

SMEM_DEFAULT_BYTES = 48 * 1024
SMEM_OPT_IN_BYTES = 232_448
MAX_THREADS = 1024
MAX_GRID = (2 ** 31 - 1, 65_535, 65_535)
REGISTERS_PER_SM = 65_536
MAX_REGISTERS = 255
# the most CTAs the checker enumerates for one case (a safety cap)
MAX_CTAS = 1 << 20


class PlanRefused(ValueError):
    """The wrapper's ``plan`` (or the C launch code's own checks) refuses
    a case: the checker reports it as KRN003."""


def planned(plan: Callable, *args):
    """``plan(*args)``, with its refusal (``ValueError``/``TypeError``)
    raised as ``PlanRefused``."""
    try:
        return plan(*args)
    except (ValueError, TypeError) as e:
        raise PlanRefused(str(e)) from e


@dataclasses.dataclass(frozen=True)
class Buffer:
    """One tensor of a call as the kernels see it.

    ``shape`` is the logical shape (the reference contract's layout where
    one exists, without its padding); ``tile`` the elements one CTA
    writes or reads along each axis (``None`` for an input that is not
    enumerated); ``masked``: the kernel checks the bounds of a ragged
    last tile, so a tile may cross the end."""

    name: str
    shape: tuple
    dtype: str
    role: str = "output"
    tile: Optional[tuple] = None
    masked: bool = False

    def __post_init__(self):
        if self.role not in ROLES:
            raise ValueError(f"buffer {self.name!r}: role {self.role!r}")
        if self.tile is not None and len(self.tile) != len(self.shape):
            raise ValueError(
                f"buffer {self.name!r}: tile rank {len(self.tile)} != "
                f"shape rank {len(self.shape)}")
        if self.role != "input" and self.tile is None:
            raise ValueError(f"{self.role} {self.name!r} needs a tile")

    def n_tiles(self) -> tuple:
        return tuple(-(-int(d) // int(t))
                     for d, t in zip(self.shape, self.tile))


@dataclasses.dataclass(frozen=True)
class Launch:
    """One ``<<<grid, threads, dynamic_smem>>>`` of a call.

    - ``kernel``/``template``: the ``__global__`` function and its
      template arguments as a demangler spells them, namespaces left
      out (``decode_split_kernel``, ``("2", "128",
      "ContiguousCache<__nv_bfloat16>")``): the name ptxas and the
      profiler report;
    - ``launch_bound``: the kernel's ``__launch_bounds__`` (``None``
      where it declares none);
    - ``static_smem``: its ``__shared__`` arrays, bytes;
      ``dynamic_smem``: the launch's third argument; ``opt_in``: the
      launch code raises the kernel's dynamic limit through
      ``cudaFuncSetAttribute``;
    - ``writes(x, y, z)`` / ``reads(x, y, z)``: the (buffer, tile
      index) pairs CTA (x, y, z) writes / reads (reads: scratch only);
    - ``loops``: what a CTA walks in order (a CTA-internal loop);
    - ``spill_bytes``: the spill stores ptxas reports for this build
      (0 but for builds that are known to spill)."""

    kernel: str
    template: tuple
    grid: tuple
    threads: int
    launch_bound: Optional[int]
    static_smem: int = 0
    dynamic_smem: int = 0
    opt_in: bool = False
    writes: Optional[Callable] = None
    reads: Optional[Callable] = None
    loops: tuple = ()
    spill_bytes: int = 0

    def __post_init__(self):
        if len(self.grid) != 3:
            raise ValueError(f"{self.kernel}: grid {self.grid} is not "
                             f"(x, y, z)")

    @property
    def signature(self) -> str:
        """``kernel<arg,arg>``, no spaces: what ``launches.normalize``
        makes of a demangled name."""
        if not self.template:
            return self.kernel
        return f"{self.kernel}<{','.join(self.template)}>".replace(" ", "")

    def smem_bytes(self) -> int:
        return self.static_smem + self.dynamic_smem

    def ctas(self):
        """Every CTA index (x, y, z) of the grid."""
        gx, gy, gz = (int(g) for g in self.grid)
        for z in range(gz):
            for y in range(gy):
                for x in range(gx):
                    yield x, y, z


@dataclasses.dataclass(frozen=True)
class KernelInstance:
    """One call's launches, in stream order, and the buffers they
    touch; ``route`` and ``split`` ((split count, keys per split), or
    ``None``) are the wrapper's ``plan``."""

    route: str
    launches: tuple
    buffers: tuple
    split: Optional[tuple] = None

    def buffer(self, name: str) -> Buffer:
        for b in self.buffers:
            if b.name == name:
                return b
        raise KeyError(name)


@dataclasses.dataclass(frozen=True)
class KernelContract:
    """What a kernel wrapper promises; ``repro_torch.analysis.kernels``
    proves it.

    - ``build(case)`` -> ``KernelInstance`` for one ``cases`` entry (a
      plain dict of dims), the route and split layout from the
      wrapper's ``plan``;
    - ``dtype_groups``: buffer-name groups that must share a dtype."""

    name: str
    build: Callable
    cases: tuple
    dtype_groups: tuple = ()
