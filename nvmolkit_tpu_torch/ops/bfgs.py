"""Minimizer constants and result type.

The port's copy of the constants and ``BfgsResult`` of
``nvmolkit_tpu/ops/bfgs.py``: RDKit's BFGS semantics as nvMolKit ports them
(``src/minimizer/bfgs_minimize.cu:33-34, 275-295``). This module is their one
home: kernel K5 (``csrc/mmff.cu``) takes them as arguments. The batched BFGS
minimizer itself comes with the port's ``batchedForcefield`` slice.
"""
from __future__ import annotations

import dataclasses

import torch

FUNCTOL = 1e-4
MOVETOL = 1e-7
TOLX = 4e-8
# functional-decrease convergence threshold (tighter than RDKit's FUNCTOL,
# so that only noise-floor cycling in float32 terminates on it)
TOLF = 1e-6
MAXSTEP_FACTOR = 100.0
EPS = 3e-8
# hard cap on line-search probes: lambda shrinks by at least 2x per probe,
# so ~64 pass below any lambda_min; it also ends NaN-poisoned searches
MAX_LS_ITERS = 64

# the status bits of BfgsResult.status
CONVERGED, FAILED, CAPPED = 1, 2, 4


@dataclasses.dataclass
class BfgsResult:
    positions: torch.Tensor   # [S, A, 3]
    energies: torch.Tensor    # [S]
    converged: torch.Tensor   # [S] bool (True = gradient/position test met)
    n_iters: torch.Tensor     # [S] int32: energy evaluations (probes) of each system
    status: torch.Tensor      # [S] int32: CONVERGED | FAILED | CAPPED bits
    n_accepted: torch.Tensor  # [S] int32: accepted steps of each system
