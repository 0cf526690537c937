"""ctypes bindings to the repository's native SMILES featurizer.

Only what the SMILES -> Morgan path needs, mirroring
``nvmolkit_tpu/chem/native.py::morgan_batches_from_smiles``. The library
is built from ``csrc/mol_graph.cpp`` by :mod:`nvmolkit_tpu_torch._build`;
if it cannot be built or loaded, the call raises (there is no Python
parser fallback in the port).
"""
from __future__ import annotations

import ctypes

import numpy as np

from nvmolkit_tpu_torch import _build

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
