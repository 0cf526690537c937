"""Batched force-field objects — public API.

Mirrors ``nvmolkit_tpu/batchedForcefield.py`` (nvMolKit's
``nvmolkit/batchedForcefield.py``): :class:`MMFFBatchedForcefield` and
:class:`UFFBatchedForcefield` wrap every conformer of a list of molecules
(the systems, in molecule order) in one atom bucket and expose
``compute_energy()``, ``compute_gradients()`` and ``minimize()`` over them,
with per-molecule constraints through the element views ``ff[i]``.

The tables are built once per molecule and the systems carry ``sys2mol``
(the JAX package builds them per system). On CUDA an energy or gradient is
one launch of the force field's kernel (K4 or K6) plus, with constraints,
one of K7; ``minimize()`` is those on the starts and one launch of K8 (BFGS,
``ops/bfgs.py``), which adds the constraints on every probe. The work runs
on ``device`` if given, else ``hardwareOptions.deviceIds``, else ``cuda:0``;
without CUDA it raises unless ``device="cpu"`` is passed (the plain PyTorch
versions then run).
"""
from __future__ import annotations

import collections.abc

import numpy as np
import torch

from nvmolkit_tpu_torch.chem.mol import Mol
from nvmolkit_tpu_torch.models import flat
from nvmolkit_tpu_torch.models.constraints import (
    PerSystemConstraints,
    build_constraint_batch,
    constraint_energy_and_grad,
)
from nvmolkit_tpu_torch.models.mmff import MMFFProperties, make_batched_mmff
from nvmolkit_tpu_torch.models.mmff.energy import MMFF
from nvmolkit_tpu_torch.models.uff.energy import UFF, make_batched_uff
from nvmolkit_tpu_torch.ops.bfgs import bfgs_minimize
from nvmolkit_tpu_torch.types import AsyncResult, CoordinateOutput, Dense3DResult, resolve_device
from nvmolkit_tpu_torch.utils.config import HardwareOptions


class _BatchElementBase:
    """Per-MOLECULE constraint editing view (nvMolKit's element views,
    ``batchedForcefield.py:171-289``): ``ff[i]`` addresses molecule ``i``;
    a constraint added here applies to every conformer (system) of it."""

    def __init__(self, parent: "_BatchedForcefieldBase", mol_idx: int):
        self._parent = parent
        self._idx = mol_idx

    @property
    def num_atoms(self) -> int:
        return self._parent.molecules[self._idx].num_atoms

    def _add(self, kind: str, atoms, row: tuple) -> None:
        n = self.num_atoms
        for a in atoms:
            if not (0 <= a < n):
                raise ValueError(f"atom index {a} out of range (molecule has {n})")
        for k, (mi, _ci) in enumerate(self._parent.systems):
            if mi == self._idx:
                getattr(self._parent._constraints[k], kind).append(row)
        self._parent._constraints_dirty = True

    def add_distance_constraint(self, idx1: int, idx2: int, minLen: float, maxLen: float,
                                forceConstant: float, relative: bool = False) -> None:
        self._add("distance", (idx1, idx2), (idx1, idx2, minLen, maxLen, forceConstant, relative))

    def add_position_constraint(self, idx: int, maxDispl: float, forceConstant: float) -> None:
        self._add("position", (idx,), (idx, maxDispl, forceConstant))

    def add_angle_constraint(self, idx1: int, idx2: int, idx3: int, minAngleDeg: float,
                             maxAngleDeg: float, forceConstant: float,
                             relative: bool = False) -> None:
        self._add("angle", (idx1, idx2, idx3),
                  (idx1, idx2, idx3, minAngleDeg, maxAngleDeg, forceConstant, relative))

    def add_torsion_constraint(self, idx1: int, idx2: int, idx3: int, idx4: int,
                               minDihedralDeg: float, maxDihedralDeg: float,
                               forceConstant: float, relative: bool = False) -> None:
        self._add("torsion", (idx1, idx2, idx3, idx4),
                  (idx1, idx2, idx3, idx4, minDihedralDeg, maxDihedralDeg, forceConstant,
                   relative))


class MMFFBatchElement(_BatchElementBase):
    """Per-molecule view of one molecule in an MMFF batch (``ff[i]``)."""


class UFFBatchElement(_BatchElementBase):
    """Per-molecule view of one molecule in a UFF batch (``ff[i]``)."""


class _BatchedForcefieldBase:
    """Flattened (molecule, conformer) batch over one atom bucket."""

    _element_cls: type = _BatchElementBase
    _ff: flat.ForceField

    def __init__(self, molecules: list[Mol], hardwareOptions: HardwareOptions | None = None,
                 device=None):
        if not molecules:
            raise ValueError("empty molecule list")
        for i, m in enumerate(molecules):
            if not m.conformers:
                raise ValueError(f"molecule {i} has no conformers")
        self.molecules = molecules
        self.opts = hardwareOptions or HardwareOptions()
        self.device = resolve_device(self.opts, device)
        max_needed = max(m.num_atoms for m in molecules)
        self.max_atoms = next((b for b in self.opts.atomBuckets if max_needed <= b), None)
        if self.max_atoms is None:
            raise ValueError(f"{max_needed} atoms exceeds largest bucket "
                             f"{self.opts.atomBuckets[-1]}")
        self.systems: list[tuple[int, int]] = [
            (mi, ci) for mi, m in enumerate(molecules) for ci in range(len(m.conformers))]
        pos = np.zeros((len(self.systems), self.max_atoms, 3), np.float32)
        for k, (mi, ci) in enumerate(self.systems):
            pos[k, : molecules[mi].num_atoms] = molecules[mi].conformers[ci]
        self._positions = torch.from_numpy(pos).to(self.device)
        self._sys2mol = torch.tensor([mi for mi, _ in self.systems], dtype=torch.int32,
                                     device=self.device)
        self._batch = self._build_batch()
        self._constraints = [PerSystemConstraints() for _ in self.systems]
        self._constraints_dirty = False
        self._constraint_batch = None

    def _build_batch(self):
        raise NotImplementedError

    def __getitem__(self, mol_idx: int) -> _BatchElementBase:
        if not (0 <= mol_idx < len(self.molecules)):
            raise IndexError(f"molecule index {mol_idx} out of range")
        return self._element_cls(self, mol_idx)

    def _constraints_now(self):
        """None without constraints, else their batch, rebuilt when the lists
        changed (nvMolKit's dirty rebuild, ``batchedForcefield.py:385-400``):
        relative windows resolve against the positions current then."""
        if all(c.empty() for c in self._constraints):
            return None
        if self._constraints_dirty or self._constraint_batch is None:
            self._constraint_batch = build_constraint_batch(
                self._constraints, self._positions.cpu().numpy(), device=self.device)
            self._constraints_dirty = False
        return self._constraint_batch

    def _energy_and_grad(self):
        x = self._positions
        e, g = self._ff.energy_and_grad(x, self._batch, self._sys2mol)
        cb = self._constraints_now()
        if cb is None:
            return e, g
        ce, cg = constraint_energy_and_grad(x, cb, flat.system_atoms(self._batch, self._sys2mol))
        return e + ce, g + cg

    @property
    def positions(self) -> torch.Tensor:
        """[n_systems, max_atoms, 3] current coordinates, on the device."""
        return self._positions

    def set_positions(self, positions) -> None:
        positions = torch.as_tensor(positions, dtype=torch.float32, device=self.device)
        if positions.shape != self._positions.shape:
            raise ValueError(f"positions shape {tuple(positions.shape)} != "
                             f"{tuple(self._positions.shape)}")
        self._positions = positions.contiguous()

    def compute_energy(self) -> AsyncResult:
        """Per-system energies [n_systems] (constraints included)."""
        return AsyncResult(self._energy_and_grad()[0])

    def compute_gradients(self) -> AsyncResult:
        """Per-system gradients [n_systems, max_atoms, 3] (padded rows 0)."""
        return AsyncResult(self._energy_and_grad()[1])

    def _per_system(self, value, name: str, dtype):
        """A per-molecule sequence -> a per-SYSTEM tensor; a scalar -> None
        (nvMolKit's option broadcasting, ``batchedForcefield.py:325-330``)."""
        if isinstance(value, collections.abc.Sequence):
            if len(value) != len(self.molecules):
                raise ValueError(f"expected {len(self.molecules)} values for {name}, "
                                 f"got {len(value)}")
            return torch.tensor([value[mi] for mi, _ci in self.systems], dtype=dtype,
                                device=self.device)
        return None

    def _apply_positions_from(self, pf: Dense3DResult) -> None:
        """Start from a :class:`Dense3DResult`: the FF's k-th conformer of
        molecule ``mi`` is the k-th True slot of ``pf.conf_mask[mi]``, read
        on the device."""
        if int(pf.positions.shape[0]) != len(self.molecules):
            raise ValueError(f"positionsFrom covers {int(pf.positions.shape[0])} molecules, "
                             f"forcefield has {len(self.molecules)}")
        cmask = pf.conf_mask.cpu().numpy()
        slot_of = []
        for mi, m in enumerate(self.molecules):
            slots = np.nonzero(cmask[mi])[0]
            if len(slots) != len(m.conformers):
                raise ValueError(f"positionsFrom has {len(slots)} embedded conformers for "
                                 f"molecule {mi}, forcefield batch has {len(m.conformers)}")
            slot_of.append(slots)
        max_confs_pf, a_pf = int(pf.positions.shape[1]), int(pf.positions.shape[2])
        rows = torch.tensor([mi * max_confs_pf + int(slot_of[mi][ci]) for mi, ci in self.systems],
                            dtype=torch.int64, device=pf.positions.device)
        src = pf.positions.reshape(-1, a_pf, 3)[rows].to(self.device, torch.float32)
        pos = torch.zeros_like(self._positions)
        width = min(a_pf, self.max_atoms)
        pos[:, :width] = src[:, :width]
        self._positions = pos

    def _dense_result(self, energies, converged) -> Dense3DResult:
        """The flat system axis scattered back to ``[n_mols, max_confs, A,
        3]`` on the device (nvMolKit's ``minimize(output=DEVICE)``)."""
        n_mols = len(self.molecules)
        max_confs = max(len(m.conformers) for m in self.molecules)
        rows = torch.tensor([mi * max_confs + ci for mi, ci in self.systems], dtype=torch.int64,
                            device=self.device)
        a = self.max_atoms

        def scatter(values, shape, dtype):
            out = torch.zeros((n_mols * max_confs,) + shape, dtype=dtype, device=self.device)
            out[rows] = values
            return out.reshape((n_mols, max_confs) + shape)

        conf_mask = np.zeros((n_mols, max_confs), bool)
        atom_mask = np.zeros((n_mols, a), bool)
        for mi, m in enumerate(self.molecules):
            conf_mask[mi, : len(m.conformers)] = True
            atom_mask[mi, : m.num_atoms] = True
        return Dense3DResult(
            positions=scatter(self._positions, (a, 3), self._positions.dtype),
            conf_mask=torch.from_numpy(conf_mask).to(self.device),
            atom_mask=torch.from_numpy(atom_mask).to(self.device),
            energies=scatter(energies, (), energies.dtype),
            converged=scatter(converged, (), torch.bool))

    def minimize(self, maxIters=200, forceTol=1e-4, output=None, target_gpu: int | None = None,
                 positionsFrom: Dense3DResult | None = None):
        """Minimize all systems in place by BFGS (K8 on CUDA), constraints
        included.

        Returns ``(energies, converged)`` AsyncResults over the flat system
        axis, or with ``output=CoordinateOutput.DEVICE`` a
        :class:`Dense3DResult` on the device. ``positionsFrom`` takes a
        Dense3DResult as the starting coordinates. ``target_gpu`` must be
        the wrapper's own device (the wrapper is single-device, as in
        nvMolKit). ``maxIters`` and ``forceTol`` take a scalar or a
        per-molecule sequence: the run is ``max(maxIters)`` line searches
        at most, each system stopping at its own cap (failed) and tested
        against its own tolerance."""
        if target_gpu is not None:
            own = self.opts.deviceIds[0] if self.opts.deviceIds else (self.device.index or 0)
            if int(target_gpu) != own:
                raise ValueError(
                    f"target_gpu={target_gpu} differs from the wrapper's device {own}; the "
                    "batched wrapper is single-device (use the standalone optimize APIs for "
                    "cross-device consolidation)")
        if positionsFrom is not None:
            self._apply_positions_from(positionsFrom)
        iter_caps = self._per_system(maxIters, "maxIters", torch.int32)
        grad_tols = self._per_system(forceTol, "forceTol", torch.float32)
        max_iters = int(np.max(maxIters)) if iter_caps is not None else int(maxIters)
        grad_tol = float(np.min(forceTol)) if grad_tols is not None else float(forceTol)
        res = bfgs_minimize(self._ff, self._positions, self._batch, self._sys2mol,
                            self._constraints_now(), max_iters, grad_tol, iter_caps, grad_tols)
        self._positions = res.positions
        if output == CoordinateOutput.DEVICE:
            return self._dense_result(res.energies, res.converged)
        return AsyncResult(res.energies), AsyncResult(res.converged)


class MMFFBatchedForcefield(_BatchedForcefieldBase):
    """Batched MMFF94 force field over molecules with conformers."""

    _element_cls = MMFFBatchElement

    def __init__(self, molecules: list[Mol], properties=None, provider=None,
                 hardwareOptions: HardwareOptions | None = None, *, device=None):
        self.properties = properties or MMFFProperties()
        self.provider = provider
        self._ff = MMFF
        super().__init__(molecules, hardwareOptions, device)

    def _build_batch(self):
        return make_batched_mmff(self.molecules, self.max_atoms, self.properties,
                                 provider=self.provider, device=self.device)


class UFFBatchedForcefield(_BatchedForcefieldBase):
    """Batched UFF force field over molecules with conformers."""

    _element_cls = UFFBatchElement

    def __init__(self, molecules: list[Mol], vdwThreshold: float = 10.0,
                 hardwareOptions: HardwareOptions | None = None, *, device=None):
        self.vdwThreshold = vdwThreshold
        self._ff = UFF
        super().__init__(molecules, hardwareOptions, device)

    def _build_batch(self):
        return make_batched_uff(self.molecules, self.max_atoms, self.vdwThreshold,
                                device=self.device)
