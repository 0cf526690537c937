"""Batch-minimization driver: bucket the (molecule, conformer) systems,
minimize each bucket chunk in one call, scatter the results back.

The port's counterpart of ``nvmolkit_tpu/models/optimize.py`` (itself the
counterpart of nvMolKit's ``src/minimizer/bfgs_mmff.cpp:116-157``). Each
atom-size bucket of ``HardwareOptions.atomBuckets`` is cut into chunks;
each chunk's tables are built once per unique molecule, its systems carry
``sys2mol``, and one call of the minimizer (on CUDA, one launch of K5)
minimizes the whole chunk. Every chunk is queued before any result is read
back, and the coordinates stay on the device in a :class:`Dense3DResult`.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from nvmolkit_tpu_torch.chem.mol import Mol
from nvmolkit_tpu_torch.types import Dense3DResult
from nvmolkit_tpu_torch.utils.config import HardwareOptions

# Systems per minimizer call when HardwareOptions.batchSize is auto. K5
# keeps a system's state in shared memory, so device memory per system is
# its positions in and out; the cap only bounds the host's packing.
CHUNK_CAP = 16384


def _bucket_for(n_atoms: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n_atoms <= b:
            return b
    raise ValueError(f"molecule with {n_atoms} atoms exceeds largest bucket {buckets[-1]}")


def optimize_molecules_confs(
    mols: list[Mol],
    make_batch_fn: Callable,     # (unique mols, max_atoms) -> batch on ``device``
    minimize_fn: Callable,       # (pos0, batch, sys2mol, max_iters, grad_tol) -> BfgsResult
    max_iters: int = 200,
    grad_tol: float = 1e-4,
    hardware_options: HardwareOptions | None = None,
    positions_from: Dense3DResult | None = None,
    *,
    device,
):
    """Minimize every conformer of every molecule on ``device``, which the
    caller resolves (the entry points by ``types.resolve_device``): this
    layer picks no device of its own.

    Returns ``(energies, not_converged, dense)``: ``energies`` a nested list
    [mol][conf] of final energies, ``not_converged`` RDKit's status
    convention (0 = converged), and ``dense`` a :class:`Dense3DResult` of the
    minimized coordinates on ``device``, with ``n_iters``, the probes each
    system's minimization made.

    ``positions_from`` chains a :class:`Dense3DResult` as the starting
    coordinates: the systems are the True slots of its ``conf_mask``, read
    on the device, and the returned result keeps the same slot layout.
    Without it the systems are each molecule's host conformers.
    """
    opts = hardware_options or HardwareOptions()
    dev = torch.device(device)
    pf = positions_from
    if pf is None:
        for i, m in enumerate(mols):
            if not m.conformers:
                raise ValueError(f"molecule {i} has no conformers")
        conf_slots = [list(range(len(m.conformers))) for m in mols]
        max_confs = max(len(m.conformers) for m in mols)
    else:
        if int(pf.positions.shape[0]) != len(mols):
            raise ValueError(
                f"positions_from covers {int(pf.positions.shape[0])} molecules, got {len(mols)}")
        pf_cmask = pf.conf_mask.cpu().numpy()
        conf_slots = [np.nonzero(pf_cmask[mi])[0].tolist() for mi in range(len(mols))]
        max_confs = int(pf.positions.shape[1])

    bucket_systems: dict[int, list[tuple[int, int]]] = {}
    for mi, m in enumerate(mols):
        b = _bucket_for(m.num_atoms, opts.atomBuckets)
        bucket_systems.setdefault(b, []).extend((mi, ci) for ci in conf_slots[mi])
    max_atoms_all = max(_bucket_for(m.num_atoms, opts.atomBuckets) for m in mols)
    n_mols = len(mols)

    conf_mask = np.zeros((n_mols, max_confs), bool)
    atom_mask = np.zeros((n_mols, max_atoms_all), bool)
    for mi, m in enumerate(mols):
        atom_mask[mi, : m.num_atoms] = True
        conf_mask[mi, conf_slots[mi]] = True
    out_pos = torch.zeros((n_mols, max_confs, max_atoms_all, 3), dtype=torch.float32, device=dev)
    out_e = torch.zeros((n_mols, max_confs), dtype=torch.float32, device=dev)
    out_conv = torch.zeros((n_mols, max_confs), dtype=torch.bool, device=dev)
    out_iters = torch.zeros((n_mols, max_confs), dtype=torch.int32, device=dev)
    pf_pos = None if pf is None else pf.positions.to(dev, torch.float32)

    cap = opts.batchSize if opts.batchSize > 0 else CHUNK_CAP
    pending = []
    for bucket, systems in sorted(bucket_systems.items()):
        for start in range(0, len(systems), cap):
            chunk = systems[start:start + cap]
            mol_ids = np.array([mi for mi, _ in chunk], np.int64)
            conf_ids = np.array([ci for _, ci in chunk], np.int64)
            unique, sys2mol = np.unique(mol_ids, return_inverse=True)
            batch = make_batch_fn([mols[i] for i in unique], bucket)
            s2m = torch.from_numpy(sys2mol.astype(np.int32)).to(dev)
            mi_t = torch.from_numpy(mol_ids).to(dev)
            ci_t = torch.from_numpy(conf_ids).to(dev)
            if pf_pos is not None:
                # device-resident chaining: a row gather from the input
                rows = pf_pos[mi_t, ci_t]
                pos0 = torch.zeros((len(chunk), bucket, 3), dtype=torch.float32, device=dev)
                width = min(bucket, rows.shape[1])
                pos0[:, :width] = rows[:, :width]
            else:
                host = np.zeros((len(chunk), bucket, 3), np.float32)
                for k, (mi, ci) in enumerate(chunk):
                    host[k, : mols[mi].num_atoms] = mols[mi].conformers[ci]
                pos0 = torch.from_numpy(host).to(dev)
            res = minimize_fn(pos0, batch, s2m, max_iters, grad_tol)
            out_pos[mi_t, ci_t, :bucket] = res.positions
            out_e[mi_t, ci_t] = res.energies
            out_conv[mi_t, ci_t] = res.converged
            out_iters[mi_t, ci_t] = res.n_iters
            pending.append((chunk, res))

    energies = [[0.0] * len(conf_slots[mi]) for mi in range(n_mols)]
    statuses = [[1] * len(conf_slots[mi]) for mi in range(n_mols)]
    slot_to_k = [{ci: k for k, ci in enumerate(conf_slots[mi])} for mi in range(n_mols)]
    for chunk, res in pending:
        e = res.energies.cpu().tolist()
        conv = res.converged.cpu().tolist()
        for (mi, ci), ej, cj in zip(chunk, e, conv):
            k = slot_to_k[mi][ci]
            energies[mi][k] = ej
            statuses[mi][k] = 0 if cj else 1

    dense = Dense3DResult(
        positions=out_pos,
        conf_mask=torch.from_numpy(conf_mask).to(dev),
        atom_mask=torch.from_numpy(atom_mask).to(dev),
        energies=out_e,
        converged=out_conv,
        n_iters=out_iters,
    )
    return energies, statuses, dense


def finalize_output(molecules, results, dense: Dense3DResult, output):
    """Apply the CoordinateOutput contract to an optimize result.

    CONFORMERS (default): write minimized coordinates back into each
    molecule's conformer list (coordinates update regardless of
    convergence, as nvMolKit does) and return ``(results, dense)``. DEVICE:
    no writeback; return ``dense`` only.
    """
    from nvmolkit_tpu_torch.types import CoordinateOutput

    output = output or CoordinateOutput.CONFORMERS
    if output == CoordinateOutput.DEVICE:
        return dense
    pos = dense.positions.cpu().numpy()
    cmask = dense.conf_mask.cpu().numpy()
    for mi, m in enumerate(molecules):
        na = m.num_atoms
        # the k-th True slot maps to m.conformers[k] (slots may have gaps
        # when chaining from an embed whose retries left holes)
        slots = np.nonzero(cmask[mi])[0]
        for k, ci in enumerate(slots[: len(m.conformers)]):
            m.conformers[k] = pos[mi, ci, :na].copy()
    return results, dense


def group_positions_from(pf: Dense3DResult | None, mol_ids: list[int],
                         n_groups: int) -> Dense3DResult | None:
    """The rows ``mol_ids`` of a ``positionsFrom`` input, for one of
    ``n_groups`` groups of molecules (the whole input when there is one)."""
    if pf is None or n_groups == 1:
        return pf
    rows = torch.as_tensor(mol_ids, dtype=torch.int64, device=pf.positions.device)
    return Dense3DResult(positions=pf.positions[rows], conf_mask=pf.conf_mask[rows],
                         atom_mask=pf.atom_mask[rows])


def merge_group_dense(molecules, dense_parts) -> Dense3DResult:
    """Merge per-group optimize results back into input molecule order.

    ``dense_parts`` is ``[(mol_ids, Dense3DResult), ...]`` from running
    :func:`optimize_molecules_confs` on property-homogeneous molecule
    groups. Each molecule's row is copied whole, slots and holes as its
    group's ``conf_mask`` has them: the width is the widest group's, not
    the count of host conformers (which is 0 for a molecule chained through
    ``positions_from``).
    """
    first = dense_parts[0][1]
    dev = first.positions.device
    n = len(molecules)
    max_confs = max(int(d.positions.shape[1]) for _, d in dense_parts)
    max_atoms = max(int(d.positions.shape[2]) for _, d in dense_parts)
    pos = torch.zeros((n, max_confs, max_atoms, 3), dtype=first.positions.dtype, device=dev)
    conf_mask = torch.zeros((n, max_confs), dtype=torch.bool, device=dev)
    atom_mask = torch.zeros((n, max_atoms), dtype=torch.bool, device=dev)
    e_out = torch.zeros((n, max_confs), dtype=torch.float32, device=dev)
    conv = torch.zeros((n, max_confs), dtype=torch.bool, device=dev)
    iters = torch.zeros((n, max_confs), dtype=torch.int32, device=dev)
    for mol_ids, d in dense_parts:
        rows = torch.as_tensor(mol_ids, dtype=torch.int64, device=dev)
        c, a = d.positions.shape[1:3]
        pos[rows, :c, :a] = d.positions
        conf_mask[rows, :c] = d.conf_mask
        atom_mask[rows, :a] = d.atom_mask
        e_out[rows, :c] = d.energies
        conv[rows, :c] = d.converged
        iters[rows, :c] = d.n_iters
    return Dense3DResult(positions=pos, conf_mask=conf_mask, atom_mask=atom_mask,
                         energies=e_out, converged=conv, n_iters=iters)
