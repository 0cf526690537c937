"""Force-field term tables and the batch cache.

The port's copy of ``TermTable`` and ``BoundedBatchCache`` from
``nvmolkit_tpu/models/terms.py`` (host code, no framework import). The JAX
package's one-hot selection layout (``slot_onehots*``, ``select_slots``,
``expand_batch_to_systems``) is a TPU device layout and is not carried
over: the port keeps flat per-molecule tables with CSR offsets, as
nvMolKit does (``src/forcefields/mmff.h:318-341``), and its kernels index
them directly (``models/mmff/energy.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TermTable:
    """One term kind for one system: int columns (atom indices) + float params."""

    atoms: np.ndarray          # [T, arity] int32 local atom indices
    params: dict[str, np.ndarray]  # each [T] float32

    @property
    def n_terms(self) -> int:
        return self.atoms.shape[0]

    @staticmethod
    def empty(arity: int, param_names: tuple[str, ...]) -> "TermTable":
        return TermTable(
            atoms=np.zeros((0, arity), dtype=np.int32),
            params={k: np.zeros(0, dtype=np.float32) for k in param_names},
        )


class BoundedBatchCache:
    """Bounded FIFO cache of fully-batched device term tables.

    Keyed by the identity tuple of a molecule list plus build options
    (the reference caches per-ROMol contribs, ``bfgs_mmff.cpp:199``;
    this caches one level up so repeated optimize calls over the same
    list skip the packing entirely). Entries hold strong Mol references
    so ``id()`` keys cannot alias after GC.
    """

    def __init__(self, max_entries: int = 8):
        self._max = max_entries
        self._store: dict = {}
        self._order: list = []

    def get(self, key):
        hit = self._store.get(key)
        return None if hit is None else hit[1]

    def put(self, key, mols, batch) -> None:
        self._store[key] = (list(mols), batch)
        self._order.append(key)
        while len(self._order) > self._max:
            self._store.pop(self._order.pop(0), None)
