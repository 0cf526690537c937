"""Pairwise conformer RMSD matrices — public API.

Mirrors ``nvmolkit_tpu/conformerRmsd.py``:
``GetConformerRMSMatrix(mol, prealigned=False)`` returns the condensed
lower-triangle RMSD vector (index (i, j), i > j -> i(i-1)/2 + j), ready to
be expanded for :func:`nvmolkit_tpu_torch.clustering.butina`;
``GetConformerRMSMatrixBatch`` does many molecules in one launch of kernel
K3 (:func:`nvmolkit_tpu_torch.ops.kabsch.conformer_rmsd_condensed`). Every
molecule's vector is a view of one flat float32 tensor on the device.

The work runs on ``device`` if given, else on the device of
``positionsFrom``, else on ``cuda:0``; without CUDA it raises unless
``device="cpu"`` is passed (the plain PyTorch version then runs).
"""
from __future__ import annotations

import numpy as np
import torch

from nvmolkit_tpu_torch.chem.mol import Mol
from nvmolkit_tpu_torch.ops.kabsch import conformer_rmsd_condensed
from nvmolkit_tpu_torch.types import AsyncResult, Dense3DResult, input_device, stream_scope


def _atom_mask(mols: list[Mol], n_atoms: int, heavyAtomsOnly: bool) -> np.ndarray:
    mask = np.zeros((len(mols), n_atoms), bool)
    for s, m in enumerate(mols):
        if heavyAtomsOnly:
            mask[s, : m.num_atoms] = [a.atomic_num > 1 for a in m.atoms]
        else:
            mask[s, : m.num_atoms] = True
    return mask


def conformer_stack(mols: list[Mol], heavyAtomsOnly: bool = False):
    """K3's host inputs for ``mols``: the flat float32 stack [sum C, A, 3] of
    every conformer (atoms zero-padded to the largest molecule), the atom
    mask [M, A] and the conformer counts."""
    n_confs = np.array([len(m.conformers) for m in mols], np.int64)
    n_atoms = max(m.num_atoms for m in mols)
    stack = np.zeros((int(n_confs.sum()), n_atoms, 3), np.float32)
    c = 0
    for m in mols:
        if m.conformers:
            stack[c:c + len(m.conformers), : m.num_atoms] = np.stack(m.conformers)
        c += len(m.conformers)
    return stack, _atom_mask(mols, n_atoms, heavyAtomsOnly), n_confs


def _split(flat: torch.Tensor, n_confs: np.ndarray) -> list[AsyncResult]:
    pairs = n_confs * (n_confs - 1) // 2
    starts = np.concatenate([[0], np.cumsum(pairs)])
    return [AsyncResult(flat[int(a):int(b)]) for a, b in zip(starts[:-1], starts[1:])]


def GetConformerRMSMatrix(
    mol: Mol, prealigned: bool = False, heavyAtomsOnly: bool = False, stream=None,
    *, device=None,
) -> AsyncResult:
    """Condensed lower-triangle RMSD over all conformer pairs of ``mol``."""
    if len(mol.conformers) < 2:
        raise ValueError("molecule needs at least 2 conformers")
    return GetConformerRMSMatrixBatch(
        [mol], prealigned, heavyAtomsOnly, stream=stream, device=device)[0]


def GetConformerRMSMatrixBatch(
    mols: list[Mol],
    prealigned: bool = False,
    heavyAtomsOnly: bool = False,
    positionsFrom: Dense3DResult | None = None,
    stream=None,
    *,
    device=None,
) -> list[AsyncResult]:
    """Condensed RMSD vectors, one per molecule, from one launch.

    The conformers come from each ``Mol`` (float64 on the host, copied to
    the device as float32), or, with ``positionsFrom``, from a
    :class:`Dense3DResult` read in place on its device: only the slots of
    its ``conf_mask`` count, in order, and a molecule with fewer than two
    gets an empty vector. ``heavyAtomsOnly`` aligns and measures over the
    atoms with atomic number > 1."""
    if not mols:
        return []
    dev = input_device(positionsFrom, device)
    if positionsFrom is not None:
        pos = positionsFrom.positions
        n_mol, max_confs, n_atoms = pos.shape[:3]
        if n_mol != len(mols):
            raise ValueError(f"positionsFrom holds {n_mol} molecules, mols {len(mols)}")
        with stream_scope(stream):
            x = pos.to(dev, torch.float32).contiguous().view(n_mol * max_confs, n_atoms, 3)
            cmask = positionsFrom.conf_mask.to(dev)
            rows = torch.nonzero(cmask.reshape(-1)).squeeze(1)
            n_confs = cmask.sum(dim=1).cpu().numpy().astype(np.int64)
            mask = torch.from_numpy(_atom_mask(mols, n_atoms, heavyAtomsOnly)).to(dev)
            flat = conformer_rmsd_condensed(x, mask, n_confs, rows, prealigned)
        return _split(flat, n_confs)

    if min(len(m.conformers) for m in mols) < 2:
        raise ValueError("every molecule needs at least 2 conformers")
    stack, mask, n_confs = conformer_stack(mols, heavyAtomsOnly)
    with stream_scope(stream):
        flat = conformer_rmsd_condensed(
            torch.from_numpy(stack).to(dev), torch.from_numpy(mask).to(dev), n_confs,
            prealigned=prealigned)
    return _split(flat, n_confs)
