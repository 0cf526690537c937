"""Torsion Fingerprint Deviation matrices — public API.

Mirrors ``nvmolkit_tpu/tfd.py``: ``GetTFDMatrix`` / ``GetTFDMatrices``
return each molecule's condensed lower triangle of TFD values over its
conformer pairs ((i, j), i > j, at i(i-1)/2 + j; feedable to Butina
clustering), with RDKit ``TorsionFingerprints.GetTFDMatrix`` semantics
(:mod:`nvmolkit_tpu_torch.ops.tfd`). The torsions are enumerated on the
host; then one launch of K17 (the dihedral angles) and one of K18 (the
deviation per pair) cover every molecule of the call, and every molecule's
vector is a view of one flat float32 tensor on the device.

The work runs on ``device`` if given, else on the device of
``positionsFrom``, else on the single entry of
``hardwareOptions.deviceIds``, else on ``cuda:0``; without CUDA it raises
unless ``device="cpu"`` is passed (the plain PyTorch versions then run).
"""
from __future__ import annotations

import numpy as np
import torch

from nvmolkit_tpu_torch.chem.mol import Mol
from nvmolkit_tpu_torch.ops.tfd import dihedral_angles, enumerate_torsions, make_batch, tfd_pairs
from nvmolkit_tpu_torch.types import AsyncResult, Dense3DResult, input_device
from nvmolkit_tpu_torch.utils.config import HardwareOptions

RETURN_TYPES = (None, "list", "numpy", "tensor")


def _split(flat: torch.Tensor, n_confs: list[int], return_type: str | None):
    """Each molecule's slice of the call's buffer, in ``return_type``:
    AsyncResults or tensors (views), or numpy arrays or lists from one
    copy of the whole buffer."""
    pairs = np.asarray(n_confs, np.int64) * (np.asarray(n_confs, np.int64) - 1) // 2
    bounds = np.concatenate([[0], np.cumsum(pairs)])
    spans = list(zip(bounds[:-1].tolist(), bounds[1:].tolist()))
    if return_type is None:
        return [AsyncResult(flat[a:b]) for a, b in spans]
    if return_type == "tensor":
        return [flat[a:b] for a, b in spans]
    host = AsyncResult(flat).numpy()
    if return_type == "numpy":
        return [host[a:b] for a, b in spans]
    return [host[a:b].tolist() for a, b in spans]


def conformer_batch(mols: list[Mol], torsion_sets, device):
    """(coordinates, batch) of K17 and K18 over the molecules' own
    conformers: every conformer packed into one float32 [R, 3] array (the
    float64 coordinates rounded as the JAX package's float32 working dtype
    rounds them), copied to ``device`` in one copy with the tables."""
    sizes = np.array([m.num_atoms * len(m.conformers) for m in mols], np.int64)
    first = np.concatenate([[0], np.cumsum(sizes)])
    rows = [first[k] + m.num_atoms * np.arange(len(m.conformers), dtype=np.int64)
            for k, m in enumerate(mols)]
    packed = np.concatenate([np.asarray(c, np.float32).reshape(-1, 3)
                             for m in mols for c in m.conformers])
    batch = make_batch(torsion_sets, rows, device, coords=packed)
    return batch.coords, batch


def positions_batch(positions: torch.Tensor, slots: list[np.ndarray], torsion_sets, device):
    """(coordinates, batch) of K17 and K18 over the conformer slots
    ``slots[k]`` of molecule k of a [M, C, A, 3] ``positions`` tensor, read in
    place (copied only if it is not float32 and contiguous on ``device``)."""
    _, c_max, n_atoms = positions.shape[:3]
    coords = positions.to(device, torch.float32).contiguous().view(-1, 3)
    rows = [(k * c_max + s.astype(np.int64)) * n_atoms for k, s in enumerate(slots)]
    return coords, make_batch(torsion_sets, rows, device)


def GetTFDMatrix(
    mol: Mol,
    useWeights: bool = True,
    maxDev: str = "equal",
    symmRadius: int = 2,
    ignoreColinearBonds: bool = True,
    hardwareOptions: HardwareOptions | None = None,
    return_type: str | None = None,
    *,
    device=None,
):
    """Condensed TFD matrix over all conformer pairs of one molecule."""
    return GetTFDMatrices(
        [mol], useWeights, maxDev, symmRadius, ignoreColinearBonds, hardwareOptions,
        return_type=return_type, device=device,
    )[0]


def GetTFDMatrices(
    mols: list[Mol],
    useWeights: bool = True,
    maxDev: str = "equal",
    symmRadius: int = 2,
    ignoreColinearBonds: bool = True,
    hardwareOptions: HardwareOptions | None = None,
    positionsFrom: Dense3DResult | None = None,
    return_type: str | None = None,
    *,
    device=None,
):
    """Condensed TFD vectors, one per molecule, from one launch of K17 and
    one of K18.

    The conformers come from each ``Mol`` (float64 on the host, packed and
    copied to the device as float32 in one copy with the torsion tables), or,
    with ``positionsFrom``, from a :class:`Dense3DResult` read in place on
    its device: the slots of its ``conf_mask``, in order. Every molecule
    needs two conformers (or slots) or more. ``return_type``: None
    (AsyncResults), 'tensor', 'numpy' or 'list'."""
    if maxDev not in ("equal", "spec"):
        raise ValueError("maxDev must be 'equal' or 'spec'")
    if not mols:
        return []
    if return_type not in RETURN_TYPES:
        raise ValueError(
            f"Invalid return_type {return_type!r}. Must be 'list', 'numpy', or 'tensor'.")
    dev = input_device(positionsFrom, device, hardwareOptions)
    pf = positionsFrom
    if pf is not None:
        n_mol, n_atoms = pf.positions.shape[0], pf.positions.shape[2]
        if n_mol != len(mols):
            raise ValueError(f"positionsFrom holds {n_mol} molecules, mols {len(mols)}")
        if max(m.num_atoms for m in mols) > n_atoms:
            raise ValueError(f"positionsFrom holds {n_atoms} atoms per molecule, fewer "
                             "than a molecule has")
        slots = [np.nonzero(r)[0] for r in pf.conf_mask.cpu().numpy()]
        n_confs = [len(s) for s in slots]
    else:
        n_confs = [len(m.conformers) for m in mols]
    if min(n_confs) < 2:
        raise ValueError("every molecule needs at least 2 conformers")
    sets = [enumerate_torsions(m, use_weights=useWeights, max_dev=maxDev,
                               symm_radius=symmRadius,
                               ignore_colinear_bonds=ignoreColinearBonds) for m in mols]
    if pf is not None:
        coords, batch = positions_batch(pf.positions, slots, sets, dev)
    else:
        coords, batch = conformer_batch(mols, sets, dev)
    flat = tfd_pairs(dihedral_angles(coords, batch), batch)
    return _split(flat, n_confs, return_type)
