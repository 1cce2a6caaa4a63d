"""Depth calibration of a cell's count (PyTorch port of
``launch/calibrate.py``).

The reference needs it because XLA's ``cost_analysis()`` counts a
while-loop body once, whatever its trip count: it compiles 2-3 fully
unrolled reduced-depth variants of a cell, fits the exact linear model

    cost(depths) = a + sum_i b_i * depth_i

and extrapolates to the real depth.  Eager PyTorch counts every layer,
so in the port the extrapolation is a cross-check of the direct count:
``dryrun.run_cell`` records both, and they must agree.  Layers within a
group are shape-identical, so the model is exact, not a regression.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass
class CalibratedCosts:
    flops: float
    hbm_bytes: float
    coll_bytes: float
    coll_breakdown: dict
    variants_compiled: int

    def to_json(self):
        return dataclasses.asdict(self)


def _variant(cfg: ModelConfig, **over) -> ModelConfig:
    over.setdefault("unroll_scans", True)
    over.setdefault("scan_layers", False)
    return dataclasses.replace(cfg, **over)


def _depth_plan(cfg: ModelConfig) -> tuple[list[dict], list[list[float]],
                                           list[float]]:
    """Returns (config-override list, depth matrix, real depth vector).

    Each variant contributes row [1, d1, d2, ...]; solving A x = cost
    gives [a, b1, b2, ...]; the real cost is [1, D1, D2, ...] . x.
    """
    if cfg.family == "mla_moe":
        k = cfg.moe.first_k_dense

        def ov(d, m):
            return {"n_layers": d + m,
                    "moe": dataclasses.replace(cfg.moe, first_k_dense=d)}

        return ([ov(1, 1), ov(2, 1), ov(1, 2)],
                [[1, 1, 1], [1, 2, 1], [1, 1, 2]],
                [1, k, cfg.n_layers - k])
    if cfg.family == "hybrid":
        p = cfg.hybrid.attn_period
        return ([{"n_layers": p}, {"n_layers": 2 * p}],
                [[1, 1], [1, 2]],
                [1, cfg.n_layers // p])
    if cfg.family == "encdec":
        def ov(e, d):
            return {"n_layers": d,
                    "encdec": dataclasses.replace(cfg.encdec, enc_layers=e)}

        return ([ov(1, 1), ov(2, 1), ov(1, 2)],
                [[1, 1, 1], [1, 2, 1], [1, 1, 2]],
                [1, cfg.encdec.enc_layers, cfg.n_layers])
    # homogeneous stacks
    return ([{"n_layers": 1}, {"n_layers": 2}],
            [[1, 1], [1, 2]],
            [1, cfg.n_layers])


def _solve(rows: list[list[float]], costs: list[float],
           real: list[float]) -> float:
    A = np.asarray(rows, dtype=np.float64)
    y = np.asarray(costs, dtype=np.float64)
    x, *_ = np.linalg.lstsq(A, y, rcond=None)
    val = float(np.asarray(real, dtype=np.float64) @ x)
    return max(val, 0.0)


def calibrated_costs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                     *, hp=None, verbose: bool = False) -> CalibratedCosts:
    """FLOPs, bytes and collective bytes of the cell at ``cfg``'s depth,
    extrapolated from counts of ``_depth_plan``'s reduced-depth variants
    (each built by ``specs.build_cell`` on ``meta`` and counted by
    ``opcount``)."""
    from repro_torch.launch.roofline import collective_bytes
    from repro_torch.launch.specs import build_cell, count_cell

    overrides, rows, real = _depth_plan(cfg)
    flops, hbm, coll_tot = [], [], []
    coll_kinds: dict[str, list[float]] = {}
    for ov in overrides:
        cell = build_cell(_variant(cfg, **ov), shape, mesh, hp=hp)
        oc, _ = count_cell(cell)
        flops.append(float(oc.flops))
        hbm.append(float(oc.bytes))
        coll = collective_bytes(cell.records, cell.n_devices)
        coll.pop("_counts", None)
        coll_tot.append(float(sum(coll.values())))
        for k in ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute"):
            coll_kinds.setdefault(k, []).append(float(coll.get(k, 0.0)))
        if verbose:
            print(f"    calib {ov}: flops={flops[-1]:.3e} "
                  f"bytes={hbm[-1]:.3e} coll={coll_tot[-1]:.3e}",
                  flush=True)
    breakdown = {k: _solve(rows, v, real) for k, v in coll_kinds.items()
                 if any(v)}
    return CalibratedCosts(
        flops=_solve(rows, flops, real),
        hbm_bytes=_solve(rows, hbm, real),
        coll_bytes=_solve(rows, coll_tot, real),
        coll_breakdown=breakdown,
        variants_compiled=len(overrides),
    )
