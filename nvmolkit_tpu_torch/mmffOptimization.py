"""Batch MMFF optimization — public API.

Mirrors ``nvmolkit_tpu/mmffOptimization.py`` (and nvMolKit's
``nvmolkit/mmffOptimization.py:60-201``):
``MMFFOptimizeMoleculesConfs(molecules, maxIters, properties, ...)``
minimizes every conformer under MMFF94. On CUDA each bucket chunk is one
launch of kernel K5 (L-BFGS) or K8 (BFGS), or two of K23 (the lockstep
L-BFGS and its restart), which run every system's whole minimization on the
device, each probe an evaluation of kernel K4's device function
(``csrc/mmff.cu``).

The work runs on ``device`` if given, else on ``hardwareOptions.deviceIds``
or ``targetGpu``, else on the device of ``positionsFrom``, else on
``cuda:0``; without CUDA it raises unless ``device="cpu"`` is passed (the
plain PyTorch versions then run).
"""
from __future__ import annotations

import dataclasses
import functools
from collections.abc import Sequence

from nvmolkit_tpu_torch.chem.mol import Mol
from nvmolkit_tpu_torch.models import flat
from nvmolkit_tpu_torch.models.mmff import MMFFProperties, make_batched_mmff
from nvmolkit_tpu_torch.models.mmff.energy import MMFF
from nvmolkit_tpu_torch.models.optimize import (
    finalize_output,
    group_positions_from,
    merge_group_dense,
    optimize_molecules_confs,
)
from nvmolkit_tpu_torch.ops.bfgs import bfgs_minimize
from nvmolkit_tpu_torch.ops.lbfgs import minimize_restarting
from nvmolkit_tpu_torch.ops.lbfgs_flat import lbfgs
from nvmolkit_tpu_torch.types import CoordinateOutput, Dense3DResult, input_device
from nvmolkit_tpu_torch.utils.config import HardwareOptions


def _per_mol(value, i: int, n: int, name: str):
    """Scalar or length-n per-molecule sequence
    (nvMolKit's ``nvmolkit/mmffOptimization.py:42-43``)."""
    if isinstance(value, Sequence) and not isinstance(value, (str, bytes)):
        if len(value) != n:
            raise ValueError(f"{name} sequence length {len(value)} != molecule count {n}")
        return value[i]
    return value


def minimizer(ff: flat.ForceField, backend: str):
    """The chunk minimizer ``(pos0, batch, sys2mol, max_iters, grad_tol)`` of
    ``backend``: ``"flat"`` L-BFGS (K5), ``"bfgs"`` BFGS (K8), ``"lbfgs"``
    the lockstep L-BFGS with the JAX driver's restart at iteration 96 (K23)."""
    if backend == "flat":
        return functools.partial(lbfgs, ff)
    if backend == "bfgs":
        return lambda pos, batch, s2m, max_iters, grad_tol: bfgs_minimize(
            ff, pos, batch, s2m, None, max_iters, grad_tol)
    if backend == "lbfgs":
        return functools.partial(minimize_restarting, ff)
    raise ValueError(f"unknown backend {backend!r}")


def MMFFOptimizeMoleculesConfs(
    molecules: list[Mol],
    maxIters: int = 200,
    properties: MMFFProperties | list[MMFFProperties] | None = None,
    nonBondedThreshold: float | Sequence[float] = 100.0,
    ignoreInterfragInteractions: bool | Sequence[bool] = True,
    hardwareOptions: HardwareOptions | None = None,
    provider=None,
    backend: str = "flat",
    output=None,
    positionsFrom: Dense3DResult | None = None,
    targetGpu: int = -1,
    *,
    device=None,
):
    """Minimize all conformers of all molecules under MMFF94.

    ``output`` follows nvMolKit's ``CoordinateOutput``: the default
    CONFORMERS writes minimized coordinates back into each molecule's
    conformer list and returns ``(results, dense)``; DEVICE skips the
    writeback and returns only the :class:`Dense3DResult`, on the device.

    ``positionsFrom`` takes a :class:`Dense3DResult` as the coordinate
    source: its ``conf_mask`` slots are the systems, read on the device, and
    the result keeps its slots and holes.

    ``results[mol][conf] = (not_converged, energy)`` (0 = converged).
    Parametrization comes from ``provider`` (default: RDKit when importable,
    else the standalone empirical rules; see ``models/mmff/providers.py``).
    ``properties`` may be one MMFFProperties or a per-molecule list;
    molecules sharing a properties signature run in one batch.
    ``nonBondedThreshold`` is accepted and keys the caches, as in the JAX
    package, which does not apply it either.

    ``backend="flat"`` runs the L-BFGS minimizer (kernel K5 on CUDA),
    ``"bfgs"`` the BFGS one (kernel K8), ``"lbfgs"`` the JAX package's
    lockstep L-BFGS (kernel K23), which restarts the systems still running
    after 96 iterations with a fresh history, as the JAX package's driver
    does. ``maxIters`` is the total budget: accepted steps for ``"flat"``,
    line searches for ``"bfgs"`` and ``"lbfgs"``.

    Raises nvMolKit's structured ``ValueError`` when inputs are invalid:
    ``e.args[1]`` is ``{"none": [...], "no_params": [...]}`` with the
    offending molecule indices (``no_params`` is populated under the RDKit
    provider, which is where parametrization can fail).
    """
    minimize = minimizer(MMFF, backend)
    if not molecules:
        if output == CoordinateOutput.DEVICE:
            raise ValueError("MMFFOptimizeMoleculesConfs(output=DEVICE) requires at least "
                             "one molecule")
        return [], None

    none_indices = [i for i, m in enumerate(molecules) if m is None]
    no_params_indices: list[int] = []
    if not none_indices:
        from nvmolkit_tpu_torch.models.mmff.providers import RDKitMMFFProvider, default_provider

        prov = provider or default_provider()
        if isinstance(prov, RDKitMMFFProvider):
            from rdkit.Chem import AllChem

            for i, m in enumerate(molecules):
                rmol = getattr(m, "rdkit_mol", m)
                if not AllChem.MMFFHasAllMoleculeParams(rmol):
                    no_params_indices.append(i)
    if none_indices or no_params_indices:
        parts = []
        if none_indices:
            parts.append(f"None at indices {none_indices}")
        if no_params_indices:
            parts.append(f"lacking MMFF atom types at indices {no_params_indices}")
        raise ValueError("; ".join(parts), {"none": none_indices, "no_params": no_params_indices})

    if targetGpu >= 0:
        hardwareOptions = hardwareOptions or HardwareOptions()
        if not hardwareOptions.deviceIds:
            hardwareOptions = dataclasses.replace(hardwareOptions, deviceIds=[targetGpu])
    dev = input_device(positionsFrom, device, hardwareOptions)

    n = len(molecules)
    if isinstance(properties, list):
        if len(properties) != n:
            raise ValueError(
                f"properties list length {len(properties)} != molecule count {n}")
        per_mol = [
            p or MMFFProperties(
                nonBondedThreshold=_per_mol(nonBondedThreshold, i, n, "nonBondedThreshold"),
                ignoreInterfragInteractions=_per_mol(
                    ignoreInterfragInteractions, i, n, "ignoreInterfragInteractions"),
            )
            for i, p in enumerate(properties)
        ]
    elif properties is not None:
        per_mol = [properties] * n
    else:
        per_mol = [
            MMFFProperties(
                nonBondedThreshold=_per_mol(nonBondedThreshold, i, n, "nonBondedThreshold"),
                ignoreInterfragInteractions=_per_mol(
                    ignoreInterfragInteractions, i, n, "ignoreInterfragInteractions"),
            )
            for i in range(n)
        ]

    # group molecules by properties signature; one optimize pass each
    groups: dict[tuple, list[int]] = {}
    for mi, p in enumerate(per_mol):
        groups.setdefault(tuple(sorted(vars(p).items())), []).append(mi)

    results: list = [None] * n
    dense_parts: list = []
    for mol_ids in groups.values():
        props = per_mol[mol_ids[0]]
        group_pf = group_positions_from(positionsFrom, mol_ids, len(groups))

        def make_batch(mols, max_atoms, _props=props):
            return make_batched_mmff(mols, max_atoms, _props, provider=provider, device=dev)

        energies, statuses, dense = optimize_molecules_confs(
            [molecules[i] for i in mol_ids], make_batch, minimize, max_iters=maxIters,
            hardware_options=hardwareOptions, positions_from=group_pf, device=dev)
        for g, mi in enumerate(mol_ids):
            results[mi] = [(statuses[g][c], energies[g][c]) for c in range(len(energies[g]))]
        dense_parts.append((mol_ids, dense))

    dense = dense_parts[0][1] if len(dense_parts) == 1 else merge_group_dense(molecules,
                                                                                dense_parts)
    return finalize_output(molecules, results, dense, output)
