"""ctypes bindings to the repository's native SMILES featurizer.

Mirrors ``nvmolkit_tpu/chem/native.py``: :func:`morgan_batches_from_smiles`
(SMILES -> padded Morgan kernel inputs, no molecule objects) and
:func:`mols_from_smiles_native` (SMILES -> perceived :class:`Mol`
objects). The library is built from ``csrc/mol_graph.cpp`` by
:mod:`nvmolkit_tpu_torch._build`; if it cannot be built or loaded, the
call raises. The Python parser is taken only when asked for,
``mols_from_smiles(backend="python")``.
"""
from __future__ import annotations

import ctypes

import numpy as np

from nvmolkit_tpu_torch import _build
from nvmolkit_tpu_torch.chem.mol import Atom, Bond, BondType, ChiralTag, Mol

_i32p = ctypes.POINTER(ctypes.c_int32)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def _ptr(a: np.ndarray, ptype):
    return a.ctypes.data_as(ptype)


def num_atoms(smiles: list[str], n_threads: int = 0) -> np.ndarray:
    """Heavy-atom count of each SMILES (int32), -1 where the featurizer
    rejects it."""
    lib = _build.graph_lib()
    arr = (ctypes.c_char_p * len(smiles))(*[s.encode() for s in smiles])
    handle = lib.nvmk_parse_batch(arr, len(smiles), n_threads)
    if not handle:
        raise RuntimeError("nvmk_parse_batch failed")
    try:
        return np.array([lib.nvmk_num_atoms(handle, k) for k in range(len(smiles))], np.int32)
    finally:
        lib.nvmk_free(handle)


_ATOM_COLUMNS = (
    "atomic_num", "charge", "degree", "total_hs", "in_ring", "is_aromatic", "mass",
    "isotope", "min_ring_size", "chiral", "explicit_hs", "from_bracket",
)


def mols_from_smiles_native(
    smiles: list[str], n_threads: int = 0, strict: bool = True
) -> list[Mol | None]:
    """Parse a batch of SMILES with the native featurizer into perceived
    :class:`Mol` objects (rings, implicit Hs). ``strict=False`` yields None
    for a SMILES the featurizer rejects instead of raising ``ValueError``.

    Each Mol keeps the flat parse columns (``Mol._native_cols``), so its
    ``to_arrays()`` is rebuilt vectorized, as in the JAX package."""
    lib = _build.graph_lib()
    arr = (ctypes.c_char_p * len(smiles))(*[s.encode() for s in smiles])
    handle = lib.nvmk_parse_batch(arr, len(smiles), n_threads)
    if not handle:
        raise RuntimeError("nvmk_parse_batch failed")
    try:
        out: list[Mol | None] = []
        for k, smi in enumerate(smiles):
            na = lib.nvmk_num_atoms(handle, k)
            if na < 0:
                err = lib.nvmk_error(handle, k)
                if strict:
                    raise ValueError(f"SMILES {smi!r}: {err.decode() if err else 'parse error'}")
                out.append(None)
                continue
            nb = lib.nvmk_num_bonds(handle, k)
            cols = {name: np.zeros(max(na, 1), np.int32) for name in _ATOM_COLUMNS}
            lib.nvmk_get_atoms(handle, k, *[_ptr(cols[name], _i32p) for name in _ATOM_COLUMNS])
            bond_atoms = np.zeros((max(nb, 1), 2), np.int32)
            bond_type = np.zeros(max(nb, 1), np.int32)
            bond_ring = np.zeros(max(nb, 1), np.int32)
            lib.nvmk_get_bonds(handle, k, _ptr(bond_atoms, _i32p), _ptr(bond_type, _i32p),
                               _ptr(bond_ring, _i32p))

            mol = Mol()
            for i in range(na):
                mol.atoms.append(Atom(
                    atomic_num=int(cols["atomic_num"][i]),
                    formal_charge=int(cols["charge"][i]),
                    is_aromatic=bool(cols["is_aromatic"][i]),
                    isotope=int(cols["isotope"][i]),
                    explicit_hs=int(cols["explicit_hs"][i]),
                    from_bracket=bool(cols["from_bracket"][i]),
                    chiral_tag=ChiralTag(int(cols["chiral"][i])),
                    implicit_hs=int(cols["total_hs"][i] - cols["explicit_hs"][i]),
                    in_ring=bool(cols["in_ring"][i]),
                    min_ring_size=int(cols["min_ring_size"][i]),
                ))
            for bi in range(nb):
                mol.bonds.append(Bond(
                    begin=int(bond_atoms[bi, 0]),
                    end=int(bond_atoms[bi, 1]),
                    bond_type=BondType(int(bond_type[bi])),
                    is_aromatic=int(bond_type[bi]) == int(BondType.AROMATIC),
                    in_ring=bool(bond_ring[bi]),
                ))
            mol._neighbors = None
            mol._native_cols = (
                {name: col[:na].copy() for name, col in cols.items()},
                bond_atoms[:nb].copy(),
                bond_type[:nb].copy(),
                bond_ring[:nb].copy(),
            )
            out.append(mol)
        return out
    finally:
        lib.nvmk_free(handle)


def mols_from_smiles(smiles: list[str], backend: str = "native", n_threads: int = 0):
    """Batch SMILES parsing; ``backend`` is ``"native"`` (the C++
    featurizer; raises if it cannot be built) or ``"python"`` (the
    :mod:`nvmolkit_tpu_torch.chem.smiles` parser). ``"auto"`` is accepted
    for the JAX package's spelling and means ``"native"``."""
    if backend in ("auto", "native"):
        return mols_from_smiles_native(smiles, n_threads)
    if backend == "python":
        from nvmolkit_tpu_torch.chem.smiles import mol_from_smiles

        return [mol_from_smiles(s) for s in smiles]
    raise ValueError(f"unknown backend {backend!r}")


def morgan_batches_from_smiles(
    smiles: list[str],
    atom_buckets: tuple[int, ...],
    max_bonds_per_atom: int = 8,
    n_threads: int = 0,
    use_chirality: bool = False,
) -> dict[int, tuple[np.ndarray, dict[str, np.ndarray]]]:
    """SMILES -> padded Morgan kernel inputs, grouped by atom bucket.

    Returns ``{bucket: (input_indices, arrays)}`` with the arrays of
    ``nvmolkit_tpu``'s version: ``inv0`` uint32 [B, A], ``adj_atoms``,
    ``adj_code`` uint8 [B, A, K], ``adj_mask`` bool [B, A, K],
    ``own_bits`` uint32 [B, A, W], ``atom_mask`` bool [B, A] and
    ``degree`` uint8 [B, A]. Raises ``ValueError`` on a SMILES the
    featurizer rejects or a molecule beyond the largest bucket.
    """
    lib = _build.graph_lib()
    arr = (ctypes.c_char_p * len(smiles))(*[s.encode() for s in smiles])
    handle = lib.nvmk_parse_batch(arr, len(smiles), n_threads)
    if not handle:
        raise RuntimeError("nvmk_parse_batch failed")
    try:
        by_bucket: dict[int, list[int]] = {}
        for k, smi in enumerate(smiles):
            na = lib.nvmk_num_atoms(handle, k)
            if na < 0:
                err = lib.nvmk_error(handle, k)
                raise ValueError(f"SMILES {smi!r}: {err.decode() if err else 'parse error'}")
            for b in atom_buckets:
                if na <= b:
                    by_bucket.setdefault(b, []).append(k)
                    break
            else:
                raise ValueError(
                    f"molecule {k} has {na} atoms > largest bucket {atom_buckets[-1]}"
                )

        out = {}
        K = max_bonds_per_atom
        for bucket, indices in sorted(by_bucket.items()):
            B, A = len(indices), bucket
            # the C code sizes a bond bitset row as (2*A)/32 words but
            # admits up to 2*A bonds, so bond ids >= 32*W write one word
            # past an atom's row (csrc/mol_graph.cpp:606,614,654). Rows
            # keep the C layout, so results match the JAX package bit for
            # bit; one word of slack keeps the last row's overrun inside
            # the allocation.
            W = 2 * A // 32
            inv0 = np.zeros((B, A), np.uint32)
            adj_atoms = np.zeros((B, A, K), np.int32)
            adj_code = np.zeros((B, A, K), np.uint32)
            adj_mask = np.zeros((B, A, K), np.uint8)
            own_flat = np.zeros(B * A * W + 1, np.uint32)
            atom_mask = np.zeros((B, A), np.uint8)
            degree = np.zeros((B, A), np.int32)
            idx_arr = np.asarray(indices, np.int32)
            rc = lib.nvmk_fill_morgan_batch(
                handle, _ptr(idx_arr, _i32p), B, A, K, int(use_chirality),
                _ptr(inv0, _u32p), _ptr(adj_atoms, _i32p), _ptr(adj_code, _u32p),
                _ptr(adj_mask, _u8p), _ptr(own_flat, _u32p), _ptr(atom_mask, _u8p),
                _ptr(degree, _i32p),
            )
            if rc != 0:
                raise ValueError(f"bucket {bucket}: molecule exceeds capacity")
            out[bucket] = (
                idx_arr,
                {
                    "inv0": inv0,
                    "adj_atoms": adj_atoms.astype(np.uint8),
                    "adj_code": adj_code.astype(np.uint8),
                    "adj_mask": adj_mask.astype(bool),
                    "own_bits": own_flat[: B * A * W].reshape(B, A, W),
                    "atom_mask": atom_mask.astype(bool),
                    "degree": degree.astype(np.uint8),
                },
            )
        return out
    finally:
        lib.nvmk_free(handle)
