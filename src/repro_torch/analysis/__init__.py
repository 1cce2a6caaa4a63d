"""The port's static checks: prove the CUDA kernels' launches, the
engine's device bodies and the energy units correct before anything
runs on a card.

The port's counterpart of ``repro.analysis``, with the same structure
and names, in PyTorch's and CUDA's terms:

- ``repro_torch.analysis.kernels``  (KRN rules): each kernel package's
  ``CONTRACTS`` (``repro_torch.analysis.contracts``): every CTA of every
  launch enumerated in plain Python: output and scratch coverage (no
  gaps, no two CTAs on one tile), ragged tails masked, the split
  routes' partials written before their merge reads them and all read,
  shared memory, threads and grids within the H100's budgets.
  ``chip_smoke.py`` phase 29 holds each contract's launches to the ones
  the card records (grid, block, shared memory; registers and spills
  from ptxas).
- ``repro_torch.analysis.purity``   (PUR rules): an AST pass over
  ``src/repro_torch/``: host reads, branches on tensors and Python side
  effects a CUDA-graph replay would skip inside the declared device
  bodies (the engine's chunk functions), shared mutable dataclass
  defaults, random draws without an explicit generator.
- ``repro_torch.analysis.units``    (UNT rules): the reference's
  dimensional analysis over the port's measurement stack.

CLI::

    python -m repro_torch.analysis                     # report
    python -m repro_torch.analysis --fail-on-new       # the gate
    python -m repro_torch.analysis --update-baseline   # ratchet refresh

Inline suppression: ``# repro_torch: noqa[KRN002]`` (or a bare
``# repro_torch: noqa``) on the flagged line.  Pre-existing findings
live in ``src/repro_torch/analysis/baseline.json``, each with a
justification; the gate fails on new findings and on baselined ones
that vanish without a refresh.
"""
from repro_torch.analysis.contracts import (  # noqa: F401
    Buffer, KernelContract, KernelInstance, Launch,
)
from repro_torch.analysis.findings import (  # noqa: F401
    Finding, load_baseline, save_baseline,
)
from repro_torch.analysis.runner import run_all  # noqa: F401
