"""Conformer validity checkers.

The port's copies of ``nvmolkit_tpu/testutils.py``'s
``check_bounds_satisfied`` and ``check_chirality_preserved`` (the
reference's ``conformer_checkers``), over the port's bounds and the plain
version of triangle smoothing (K9's), with no framework but torch. The
smoothed bounds are cached on the ``Mol`` (``_smoothed_bounds_cache``), so a
molecule's conformers are checked at the cost of their distances.
"""
from __future__ import annotations

import numpy as np
import torch

from nvmolkit_tpu_torch.chem.mol import Mol


def check_bounds_satisfied(
    mol: Mol, positions: np.ndarray, tolerance: float = 0.35
) -> bool:
    """True iff all pairwise distances sit within the (smoothed)
    topological bounds stretched by ``tolerance``."""
    from nvmolkit_tpu_torch.chem.bounds import topological_bounds
    from nvmolkit_tpu_torch.ops.triangle_smooth import triangle_smooth_bounds_plain

    n = mol.num_atoms
    smoothed = getattr(mol, "_smoothed_bounds_cache", None)
    if smoothed is None:  # cached on the Mol, as topological_bounds caches its bounds
        u, l = topological_bounds(mol)
        ub, lb, ok = triangle_smooth_bounds_plain(
            torch.from_numpy(u[None]), torch.from_numpy(l[None]),
            torch.tensor([n], dtype=torch.int32))
        smoothed = mol._smoothed_bounds_cache = (ub[0].numpy(), lb[0].numpy(), bool(ok[0]))
    ub, lb, ok = smoothed
    if not ok:
        return False
    positions = np.asarray(positions)
    d = np.linalg.norm(positions[:, None] - positions[None, :], axis=-1)
    iu = np.triu_indices(n, 1)
    hi_ok = d[iu] <= ub[iu] * (1 + tolerance)
    lo_ok = d[iu] >= lb[iu] * (1 - tolerance)
    return bool(hi_ok.all() and lo_ok.all())


def check_chirality_preserved(mol: Mol, positions: np.ndarray) -> bool:
    """True iff every parsed @/@@ center has the demanded volume sign."""
    from nvmolkit_tpu_torch.models.dist_geom import build_chiral_sets

    cidx, clb, cub = build_chiral_sets(mol)
    positions = np.asarray(positions)
    for k in range(len(cidx)):
        pts = positions[cidx[k]]
        v = float(np.dot(pts[0] - pts[3], np.cross(pts[1] - pts[3], pts[2] - pts[3])))
        if not (clb[k] <= v <= cub[k]):
            return False
    return True
