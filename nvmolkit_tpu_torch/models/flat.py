"""Flat per-molecule term tables with CSR offsets, shared by the force fields.

A batch (:class:`~nvmolkit_tpu_torch.models.mmff.energy.MMFFBatch`,
:class:`~nvmolkit_tpu_torch.models.uff.energy.UFFBatch`) holds, for each kind
of term, an int32 [T, arity] atom column and float32 [T, P] parameter rows
of U unique molecules, with int32 [K, U + 1] offsets, as nvMolKit lays its
force fields out (``src/forcefields/mmff.h:318-341``); the systems
(molecule, conformer) only carry ``sys2mol`` int32 [S]. The last kind is the
nonbonded pair list.

This module holds what the kernels' wrappers check and pass, and the plain
PyTorch evaluation over such tables: a force field supplies
``kind_energies(k, p, par, split)``, the term energies of kind ``k`` at the
positions ``p`` of its atoms (one tensor per atom slot) with parameter rows
``par``, as a tuple (with ``split``, a pair's parts apart).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class ForceField:
    """What the minimizers (``ops/lbfgs_flat.py``, ``ops/lbfgs.py``,
    ``ops/bfgs.py``) need of a force field: its name (its library's C
    functions are ``nvmk_<name>_lbfgs``, ``nvmk_<name>_lbfgs_lockstep`` and
    ``nvmk_<name>_bfgs``), its energy-and-gradient router
    ``(positions, batch, sys2mol) -> (e, g)`` (its kernel on CUDA), the plain
    ``(batch, sys2mol, a_pad) -> fn`` of the CPU path, its library, the C
    functions' arguments after the tables, from a batch. Its kernels'
    coordinates per atom are the library's (:func:`kernel_dim`)."""

    name: str
    energy_and_grad: Callable
    plain_energy_and_grad_fn: Callable
    lib: Callable
    extra_args: Callable = lambda batch: ()


def kernel_dim(lib, name: str) -> int:
    """The coordinates per atom that force field ``name``'s kernels take, as
    its library ``lib`` reports them (``nvmk_<name>_dim``, the force field's
    ``kDim`` in ``csrc/minimizers.cuh``)."""
    return int(getattr(lib, f"nvmk_{name}_dim")())


# K5 keeps 17 rows of 3 floats per atom in shared memory: 209 KB at 1024 atoms,
# within the 227 KB a block can have (with 4 floats per atom, 3/4 of the atoms)
MAX_KERNEL_ATOMS = 1024


def check_inputs(positions: torch.Tensor, batch, sys2mol: torch.Tensor, dim: int) -> None:
    if positions.dim() != 3 or positions.shape[2] != dim:
        raise ValueError(f"positions must be [S, A, {dim}], got {tuple(positions.shape)}")
    if sys2mol.dim() != 1 or sys2mol.shape[0] != positions.shape[0]:
        raise ValueError(f"sys2mol must be [{positions.shape[0]}], got {tuple(sys2mol.shape)}")
    if positions.shape[1] < batch.max_atoms:
        raise ValueError(f"positions hold {positions.shape[1]} atoms, the batch up to "
                         f"{batch.max_atoms}")


def check_kernel_inputs(positions: torch.Tensor, batch, sys2mol: torch.Tensor,
                        what: str, dim: int) -> None:
    """What the force-field kernels take: float32 contiguous positions,
    int32 sys2mol and the batch's tables, all contiguous on one device;
    ``dim`` coordinates per atom."""
    check_inputs(positions, batch, sys2mol, dim)
    if positions.dtype != torch.float32:
        raise ValueError(f"{what} takes float32 positions, got {positions.dtype}")
    if sys2mol.dtype != torch.int32:
        raise ValueError(f"{what} takes int32 sys2mol, got {sys2mol.dtype}")
    tensors = (positions, sys2mol, batch.n_atoms, batch.offsets) + kernel_tables(batch)
    for t in tensors:
        if t.device != positions.device or not t.is_contiguous():
            raise ValueError(f"{what}'s inputs must be contiguous and on one device")
    if positions.shape[1] > MAX_KERNEL_ATOMS * 3 // dim:
        raise ValueError(f"{what} takes up to {MAX_KERNEL_ATOMS * 3 // dim} atoms per system, "
                         f"got {positions.shape[1]}")


def system_atoms(batch, sys2mol: torch.Tensor) -> torch.Tensor:
    """int32 [S]: each system's atom count."""
    return batch.n_atoms[sys2mol.to(torch.int64)].contiguous()


def atom_mask(batch, sys2mol: torch.Tensor, a_pad: int) -> torch.Tensor:
    """bool [S, a_pad]: each system's atoms."""
    count = system_atoms(batch, sys2mol).to(torch.int64)
    return torch.arange(a_pad, device=count.device)[None] < count[:, None]


def kernel_tables(batch) -> tuple:
    """The tables a force field's kernels take: the atom columns of its
    kinds, their parameter rows, then (MMFF, UFF) the tables made from them
    when the batch is (``derived_tables``: the pair walk's,
    :func:`diagonal_pairs`)."""
    return batch.atoms + batch.params + tuple(getattr(batch, "derived_tables", ()))


def table_pointers(batch):
    """The device pointers of :func:`kernel_tables`."""
    tables = kernel_tables(batch)
    return (ctypes.c_void_p * len(tables))(*[t.data_ptr() for t in tables])


def pair_slot(i, j, n):
    """Where the pair (i, j), i != j, of a molecule of n atoms lies in its
    table by diagonals (``csrc/dg_pairs.cuh`` DiagTable): d = |i - j|, at
    (d - 1) (2 n - d) / 2 + min(i, j), the diagonals d = 1 .. n - 1 one
    after another, each n - d entries long (ints, numpy or torch)."""
    d = abs(i - j)
    return (d - 1) * (2 * n - d) // 2 + (i + j - d) // 2


def diagonal_pairs(n_atoms: torch.Tensor, layers, width: int):
    """The pair walk's table of a batch (``csrc/dg_pairs.cuh`` DiagTable):
    each molecule's n (n - 1) / 2 pairs laid out by diagonals
    (:func:`pair_slot`), zero where no row is listed. Each of ``layers``
    (offsets [U + 1], atoms int32 [T, 2], params [T, P], columns, ordered)
    puts each of its rows into ``columns`` of its pair's entry: the
    nonbonded list (``ordered``: its pairs i < j, checked) and the bonds
    (either order). A pair outside its molecule, or listed twice, raises.
    Returns (int32 [U + 1] each molecule's first entry, [sum n (n - 1) / 2,
    width] of the params' dtype), on the tables' device."""
    dev = n_atoms.device
    n = n_atoms.to(torch.int64)
    first = torch.zeros(n.shape[0] + 1, dtype=torch.int64, device=dev)
    torch.cumsum(n * (n - 1) // 2, 0, out=first[1:])
    if int(first[-1]) >= 2**31:
        raise ValueError("more than 2^31 pairs in a batch's pair table")
    table = torch.zeros((int(first[-1]), width), dtype=layers[0][2].dtype, device=dev)
    taken = torch.zeros(int(first[-1]), dtype=torch.int64, device=dev)
    for offsets, atoms, params, columns, ordered in layers:
        off = offsets.to(dev, torch.int64)
        mol = torch.repeat_interleave(torch.arange(n.shape[0], device=dev), off[1:] - off[:-1])
        i, j = atoms[:, 0].to(dev, torch.int64), atoms[:, 1].to(dev, torch.int64)
        if ordered and bool((i >= j).any()):
            raise ValueError("a pair list holds a pair (i, j) that is not i < j")
        if bool(((i == j) | (torch.maximum(i, j) >= n[mol])).any()):
            raise ValueError("a pair (i, j) outside its molecule's atoms")
        slot = first[mol] + pair_slot(i, j, n[mol])
        taken.index_add_(0, slot, torch.ones_like(slot))
        table[slot[:, None], torch.as_tensor(columns, device=dev)[None]] = params.to(dev)
    if bool((taken > 1).any()):
        raise ValueError("a pair listed twice (a bonded pair among the nonbonded ones?)")
    return first.to(torch.int32), table


def expand(batch, sys2mol: torch.Tensor, a_pad: int):
    """Per kind, the terms of every system: (system of each term, flat atom
    indices into [S * a_pad], parameter rows)."""
    dev = batch.offsets.device
    s2m = sys2mol.to(dev, torch.int64)
    systems = torch.arange(s2m.shape[0], device=dev)
    out = []
    for k in range(batch.offsets.shape[0]):
        off = batch.offsets[k].to(torch.int64)
        count = (off[1:] - off[:-1])[s2m]
        sys_of = torch.repeat_interleave(systems, count)
        first = torch.cumsum(count, 0) - count
        term = off[s2m][sys_of] + torch.arange(sys_of.shape[0], device=dev) - first[sys_of]
        atoms = batch.atoms[k].to(torch.int64)[term] + (sys_of * a_pad)[:, None]
        out.append((sys_of, atoms, batch.params[k][term]))
    return out


def _term_energies(flat, expanded, kind_energies: Callable, split=False):
    """(kind, system of each term, term energies) at positions ``flat``
    [S * a_pad, 3]."""
    out = []
    for k, (sys_of, atoms, par) in enumerate(expanded):
        p = [flat[atoms[:, q]] for q in range(atoms.shape[1])]
        out += [(k, sys_of, e) for e in kind_energies(k, p, par, split)]
    return out


def plain_energy_fn(batch, sys2mol: torch.Tensor, a_pad: int, kind_energies: Callable):
    """The plain per-system energy ``fn(positions [S, a_pad, 3]) -> [S]``;
    the term index is built once, so a minimizer calls ``fn`` at every
    probe. The nonbonded sum comes first, then the bonded kinds in order,
    as the JAX functions add them."""
    expanded = expand(batch, sys2mol, a_pad)
    n_sys = sys2mol.shape[0]

    def energy(positions: torch.Tensor) -> torch.Tensor:
        flat = positions.reshape(-1, 3)
        total = torch.zeros(n_sys, dtype=positions.dtype, device=positions.device)
        terms = _term_energies(flat, expanded, kind_energies)
        for _, sys_of, e in terms[-1:] + terms[:-1]:
            total = total + torch.zeros_like(total).index_add_(0, sys_of, e)
        return total

    return energy


def plain_energy_and_grad_fn(batch, sys2mol: torch.Tensor, a_pad: int,
                             kind_energies: Callable):
    """``fn(positions) -> (energy [S], gradient [S, a_pad, 3])``, the
    gradient by autograd of :func:`plain_energy_fn`, zero outside each
    system's atoms."""
    energy = plain_energy_fn(batch, sys2mol, a_pad, kind_energies)
    mask = atom_mask(batch, sys2mol.to(batch.offsets.device), a_pad)[..., None]

    def energy_and_grad(positions: torch.Tensor):
        with torch.enable_grad():
            x = positions.detach().requires_grad_(True)
            e = energy(x)
            (g,) = torch.autograd.grad(e.sum(), x)
        return e.detach(), torch.where(mask, g, 0.0)

    return energy_and_grad


def term_magnitude_plain(positions: torch.Tensor, batch, sys2mol: torch.Tensor,
                         kind_energies: Callable) -> torch.Tensor:
    """Per-system sum of |E_term| [S] (float64; a pair's parts counted
    apart): the scale of float32 rounding in the energy."""
    check_inputs(positions, batch, sys2mol, 3)
    flat = positions.detach().reshape(-1, 3)
    total = torch.zeros(positions.shape[0], dtype=torch.float64, device=positions.device)
    expanded = expand(batch, sys2mol, positions.shape[1])
    for _, sys_of, e in _term_energies(flat, expanded, kind_energies, split=True):
        total.index_add_(0, sys_of, e.abs().double())
    return total


def grad_magnitude_plain(positions: torch.Tensor, batch, sys2mol: torch.Tensor,
                         kind_energies: Callable) -> torch.Tensor:
    """Per gradient component, the sum over terms of |dE_term/dx| [S, A, 3]
    (float64; a pair's parts apart): the scale of float32 rounding in a
    gradient whose terms cancel."""
    check_inputs(positions, batch, sys2mol, 3)
    flat = positions.detach().reshape(-1, 3)
    out = torch.zeros(flat.shape, dtype=torch.float64, device=positions.device)
    for k, (_, atoms, par) in enumerate(expand(batch, sys2mol, positions.shape[1])):
        with torch.enable_grad():
            p = [flat[atoms[:, q]].requires_grad_(True) for q in range(atoms.shape[1])]
            parts = kind_energies(k, p, par, True)
            for i, e in enumerate(parts):
                grads = torch.autograd.grad(e.sum(), p, retain_graph=i + 1 < len(parts),
                                            allow_unused=True)
                for q, gq in enumerate(grads):
                    if gq is not None:
                        out.index_add_(0, atoms[:, q], gq.abs().double())
    return out.reshape(positions.shape)
