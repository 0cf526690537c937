"""Batch UFF optimization — public API.

Mirrors ``nvmolkit_tpu/uffOptimization.py`` (and nvMolKit's
``nvmolkit/uffOptimization.py``): ``UFFOptimizeMoleculesConfs(molecules,
maxIters, vdwThreshold, ...)`` minimizes every conformer under UFF. On CUDA
each bucket chunk is one launch of kernel K5 (L-BFGS) or K8 (BFGS), or two
of K23 (the lockstep L-BFGS and its restart), which run every system's whole
minimization on the device, each probe an evaluation of kernel K6's device
function (``csrc/uff.cu``).

The work runs on ``device`` if given, else on ``hardwareOptions.deviceIds``
or ``targetGpu``, else on the device of ``positionsFrom``, else on
``cuda:0``; without CUDA it raises unless ``device="cpu"`` is passed (the
plain PyTorch versions then run).
"""
from __future__ import annotations

import dataclasses
from collections.abc import Sequence

from nvmolkit_tpu_torch.chem.mol import Mol
from nvmolkit_tpu_torch.mmffOptimization import _per_mol, minimizer
from nvmolkit_tpu_torch.models.optimize import (
    finalize_output,
    group_positions_from,
    merge_group_dense,
    optimize_molecules_confs,
)
from nvmolkit_tpu_torch.models.uff.energy import UFF, make_batched_uff
from nvmolkit_tpu_torch.types import CoordinateOutput, Dense3DResult, input_device
from nvmolkit_tpu_torch.utils.config import HardwareOptions


def UFFOptimizeMoleculesConfs(
    molecules: list[Mol],
    maxIters: int = 200,
    vdwThreshold: float | Sequence[float] = 10.0,
    ignoreInterfragInteractions: bool | Sequence[bool] = True,
    nonBondedThreshold: float | None = None,
    hardwareOptions: HardwareOptions | None = None,
    backend: str = "flat",
    output=None,
    positionsFrom: Dense3DResult | None = None,
    targetGpu: int = -1,
    *,
    device=None,
):
    """Minimize all conformers of all molecules under UFF.

    Returns ``(results, dense)``: ``results[mol][conf] = (not_converged,
    energy)`` (0 = converged, RDKit's convention) and ``dense`` a
    :class:`Dense3DResult` of the minimized coordinates, energies and
    flags; ``output=CoordinateOutput.DEVICE`` skips the writeback into the
    molecules' conformers and returns only ``dense``, on the device.
    ``positionsFrom`` takes a :class:`Dense3DResult` as the coordinate
    source: its ``conf_mask`` slots are the systems, and the result keeps
    its slots and holes.

    ``vdwThreshold`` and ``ignoreInterfragInteractions`` may be
    per-molecule sequences; molecules sharing ``ignoreInterfragInteractions``
    run in one pass.
    ``vdwThreshold`` is converted with ``float()`` per molecule and
    dropped, as in the JAX package: it changes no energy and does not split
    the molecules into passes. ``ignoreInterfragInteractions=False`` keeps the pairs between
    fragments (the JAX package drops them whatever the flag).
    ``nonBondedThreshold`` is accepted and unused (UFF takes
    ``vdwThreshold``). ``backend="flat"`` runs the L-BFGS minimizer (K5 on
    CUDA), ``"bfgs"`` the BFGS one (K8), ``"lbfgs"`` the lockstep L-BFGS
    (K23) with the JAX driver's restart at iteration 96. ``maxIters`` is the
    total budget.

    Raises nvMolKit's structured ``ValueError`` on None entries:
    ``e.args[1]`` is ``{"none": [...], "no_params": []}``.
    """
    del nonBondedThreshold  # UFF takes vdwThreshold (as nvMolKit's)
    minimize = minimizer(UFF, backend)
    if not molecules:
        if output == CoordinateOutput.DEVICE:
            raise ValueError("UFFOptimizeMoleculesConfs(output=DEVICE) requires at least "
                             "one molecule")
        return [], None
    none_indices = [i for i, m in enumerate(molecules) if m is None]
    if none_indices:
        raise ValueError(f"None at indices {none_indices}",
                         {"none": none_indices, "no_params": []})
    if targetGpu >= 0:
        hardwareOptions = hardwareOptions or HardwareOptions()
        if not hardwareOptions.deviceIds:
            hardwareOptions = dataclasses.replace(hardwareOptions, deviceIds=[targetGpu])
    dev = input_device(positionsFrom, device, hardwareOptions)

    n = len(molecules)
    groups: dict[bool, list[int]] = {}
    for mi in range(n):
        float(_per_mol(vdwThreshold, mi, n, "vdwThreshold"))  # checked, then dropped
        interfrag = bool(_per_mol(ignoreInterfragInteractions, mi, n,
                                  "ignoreInterfragInteractions"))
        groups.setdefault(interfrag, []).append(mi)

    results: list = [None] * n
    dense_parts: list = []
    for interfrag, mol_ids in groups.items():
        def make_batch(mols, max_atoms, _interfrag=interfrag):
            return make_batched_uff(mols, max_atoms, ignore_interfrag=_interfrag, device=dev)

        energies, statuses, dense = optimize_molecules_confs(
            [molecules[i] for i in mol_ids], make_batch, minimize, max_iters=maxIters,
            hardware_options=hardwareOptions,
            positions_from=group_positions_from(positionsFrom, mol_ids, len(groups)), device=dev)
        for g, mi in enumerate(mol_ids):
            results[mi] = [(statuses[g][c], energies[g][c]) for c in range(len(energies[g]))]
        dense_parts.append((mol_ids, dense))

    dense = dense_parts[0][1] if len(dense_parts) == 1 else merge_group_dense(molecules,
                                                                                dense_parts)
    return finalize_output(molecules, results, dense, output)
