"""Shared helpers of the port's benchmarks (from the reference's
``benchmarks/common.py``; only what the ported benchmarks use)."""
from __future__ import annotations


def interleaved_best_of(run_fns: dict, n_reps: int = 4) -> dict:
    """Best-of-``n_reps`` PowerRun per point, repetitions interleaved
    round-robin across the points.

    Sub-second measured runs are scheduler-noise-dominated on shared
    boxes, and the noise is *temporally correlated* (slow phases last
    seconds).  Interleaving lets every point sample the same machine
    conditions, so best-rep *ratios* between points are honest; the
    fastest repetition per point is the least-perturbed one
    (hyperfine-min style).  The CI perf gate and the k-sweep speedups
    compare these numbers.

    ``run_fns``: {point_name: zero-arg closure returning a
    ``SubmissionResult``}; returns {point_name: best result}.
    """
    best: dict = {}
    for _ in range(n_reps):
        for name, run_once in run_fns.items():
            r = run_once()
            if name not in best or (r.outcome.server.tokens_per_s
                                    > best[name].outcome.server
                                    .tokens_per_s):
                best[name] = r
    return best
