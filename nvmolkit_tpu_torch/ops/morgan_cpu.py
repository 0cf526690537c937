"""Morgan (ECFP-style circular) fingerprints — numpy reference backend.

The port's copy of ``nvmolkit_tpu/ops/morgan_cpu.py``. This is the
ground-truth oracle for the device implementation, playing the
role of the reference's CPU backend (``src/morgan_fingerprint_cpu.cpp``),
and implements the same algorithm the reference's GPU kernel does
(``src/morgan_fingerprint_kernels.cu:150-503``):

  * round 0 sets bit ``atom_invariant % fp_size`` for every atom,
  * each radius round sorts the (bond_code, neighbor_invariant) pairs,
    hash-combines ``(round, current_invariant, pairs...)`` into the next
    invariant, grows per-atom bond-neighborhood bitsets, and
  * deduplicates neighborhoods — an atom whose bond environment is
    identical to an earlier atom's (earlier in (neighborhood, invariant,
    atom index) sort order this round, or accepted in any previous round)
    is marked dead and sets no bit.

All hashing is boost ``hash_combine`` over uint32
(:mod:`nvmolkit_tpu_torch.utils.hashing`), so results are deterministic and
:func:`nvmolkit_tpu_torch.ops.morgan.morgan_kernel` must match bit-for-bit.
"""
from __future__ import annotations

import numpy as np

from nvmolkit_tpu_torch.chem.mol import Mol
from nvmolkit_tpu_torch.ops.packed_bits import pack_bits_np
from nvmolkit_tpu_torch.utils.hashing import hash_combine_u32_np as hash_combine_u32

_U32 = np.uint32


def atom_invariants(
    arrays: dict[str, np.ndarray], use_chirality: bool = False
) -> np.ndarray:
    """Connectivity invariants: hash of (atomicNum, degree, totalHs, charge,
    deltaMass, inRing[, chiralTag]) per atom, as uint32."""
    n = arrays["atomic_num"].shape[0]
    inv = np.zeros(n, dtype=_U32)
    delta_mass = arrays["mass"] - arrays["atomic_num"] * 2  # stable small int
    components = [
        arrays["atomic_num"],
        arrays["degree"],
        arrays["total_hs"],
        arrays["charge"],
        delta_mass,
        arrays["in_ring"],
    ]
    if use_chirality:
        components.append(arrays["chiral_tag"])
    for comp in components:
        inv = hash_combine_u32(inv, comp.astype(np.int64).astype(_U32))
    return inv


def _bond_code(bond_type: int) -> int:
    # single=1, double=2, triple=3, aromatic=4 — matches chem.BondType codes
    return int(bond_type)


def morgan_fingerprint_cpu(
    mol: Mol, radius: int, fp_size: int, use_chirality: bool = False
) -> np.ndarray:
    """Return the packed uint32 fingerprint (fp_size//32 words) of one mol."""
    arrays = mol.to_arrays()
    n = mol.num_atoms
    inv = atom_invariants(arrays, use_chirality)
    bits = np.zeros(fp_size, dtype=np.uint8)

    # round 0
    for i in range(n):
        bits[int(inv[i]) % fp_size] = 1

    adj_bonds = arrays["adj_bonds"]
    adj_atoms = arrays["adj_atoms"]
    bond_type = arrays["bond_type"]
    degree = arrays["degree"]

    # neighborhood = frozenset of bond indices in the atom's environment
    neighborhoods: list[set[int]] = [set() for _ in range(n)]
    dead = [degree[i] == 0 for i in range(n)]
    seen: list[frozenset[int]] = []  # accepted neighborhoods from all rounds

    for rnd in range(1, radius + 1):
        next_inv = inv.copy()
        round_nbr: list[set[int]] = [set() for _ in range(n)]
        for i in range(n):
            if degree[i] == 0:
                continue
            pairs = []
            nbr = set(neighborhoods[i])
            for k in range(adj_bonds.shape[1]):
                bi = adj_bonds[i, k]
                if bi < 0:
                    break
                j = adj_atoms[i, k]
                pairs.append((_bond_code(bond_type[bi]), int(inv[j])))
                nbr.add(int(bi))
                nbr |= neighborhoods[j]
            pairs.sort()
            seed = _U32(0)
            seed = hash_combine_u32(seed, _U32(rnd))
            seed = hash_combine_u32(seed, inv[i])
            for code, v in pairs:
                seed = hash_combine_u32(seed, _U32(code))
                seed = hash_combine_u32(seed, _U32(v))
            next_inv[i] = seed
            round_nbr[i] = nbr

        # dedup in (neighborhood, invariant, atomIdx) sorted order
        order = sorted(
            (i for i in range(n) if not dead[i]),
            key=lambda i: (sorted(round_nbr[i]), int(next_inv[i]), i),
        )
        accepted_this_round: list[frozenset[int]] = []
        for i in order:
            fs = frozenset(round_nbr[i])
            if fs in seen or fs in accepted_this_round:
                dead[i] = True
                continue
            accepted_this_round.append(fs)
            bits[int(next_inv[i]) % fp_size] = 1
        seen.extend(accepted_this_round)

        inv = next_inv
        neighborhoods = round_nbr

    return pack_bits_np(bits)


def morgan_fingerprints_cpu(
    mols: list[Mol], radius: int, fp_size: int, use_chirality: bool = False
) -> np.ndarray:
    """Stacked packed fingerprints, shape (n_mols, fp_size//32) uint32."""
    return np.stack(
        [morgan_fingerprint_cpu(m, radius, fp_size, use_chirality) for m in mols]
    )


def morgan_atom_invariants_at_radius(
    mol: Mol, radius: int, fp_size: int = 2048, use_chirality: bool = False
) -> np.ndarray:
    """Per-atom Morgan environment invariant at exactly ``radius``,
    folded to ``fp_size`` (RDKit TorsionFingerprints
    ``_getAtomInvariantsWithRadius`` counterpart: the bitInfo bit id of
    each atom's radius-r environment; 0 when the atom's environment was
    deduplicated away before that round). Used for TFD symmetry
    detection at ``symmRadius``."""
    arrays = mol.to_arrays()
    n = mol.num_atoms
    inv = atom_invariants(arrays, use_chirality)
    if radius == 0:
        return (inv.astype(np.int64) % fp_size).astype(np.uint32)

    adj_bonds = arrays["adj_bonds"]
    adj_atoms = arrays["adj_atoms"]
    bond_type = arrays["bond_type"]
    degree = arrays["degree"]

    neighborhoods: list[set[int]] = [set() for _ in range(n)]
    dead = [degree[i] == 0 for i in range(n)]
    seen: list[frozenset[int]] = []
    out = np.zeros(n, dtype=np.uint32)

    for rnd in range(1, radius + 1):
        next_inv = inv.copy()
        round_nbr: list[set[int]] = [set() for _ in range(n)]
        for i in range(n):
            if degree[i] == 0:
                continue
            pairs = []
            nbr = set(neighborhoods[i])
            for k in range(adj_bonds.shape[1]):
                bi = adj_bonds[i, k]
                if bi < 0:
                    break
                j = adj_atoms[i, k]
                pairs.append((_bond_code(bond_type[bi]), int(inv[j])))
                nbr.add(int(bi))
                nbr |= neighborhoods[j]
            pairs.sort()
            seed = _U32(0)
            seed = hash_combine_u32(seed, _U32(rnd))
            seed = hash_combine_u32(seed, inv[i])
            for code, v in pairs:
                seed = hash_combine_u32(seed, _U32(code))
                seed = hash_combine_u32(seed, _U32(v))
            next_inv[i] = seed
            round_nbr[i] = nbr

        order = sorted(
            (i for i in range(n) if not dead[i]),
            key=lambda i: (sorted(round_nbr[i]), int(next_inv[i]), i),
        )
        accepted_this_round: list[frozenset[int]] = []
        accepted_atoms: list[int] = []
        for i in order:
            fs = frozenset(round_nbr[i])
            if fs in seen or fs in accepted_this_round:
                dead[i] = True
                continue
            accepted_this_round.append(fs)
            accepted_atoms.append(i)
        seen.extend(accepted_this_round)
        if rnd == radius:
            for i in accepted_atoms:
                out[i] = np.uint32(int(next_inv[i]) % fp_size)
        inv = next_inv
        neighborhoods = round_nbr
    return out


def morgan_fingerprint_cpu_unbounded(
    mol: Mol, radius: int, fp_size: int, use_chirality: bool = False
) -> np.ndarray:
    """CPU fallback without the 8-bonds-per-atom / atom-count caps.

    The accelerator path buckets molecules (max 256 atoms) and caps
    per-atom adjacency at 8 like the reference GPU kernel
    (``src/morgan_fingerprint_common.h:28``); molecules beyond either
    limit fall back here (the reference falls back to RDKit CPU,
    ``nvmolkit/fingerprints.py:83``). Same algorithm, adjacency built
    directly from the bond list with no cap."""
    arrays = mol.to_arrays()
    n = mol.num_atoms
    inv = atom_invariants(arrays, use_chirality)
    bits = np.zeros(fp_size, dtype=np.uint8)
    for i in range(n):
        bits[int(inv[i]) % fp_size] = 1

    # uncapped adjacency
    adj: list[list[tuple[int, int]]] = [[] for _ in range(n)]  # (bond, nbr)
    for bi, b in enumerate(mol.bonds):
        adj[b.begin].append((bi, b.end))
        adj[b.end].append((bi, b.begin))
    bond_type = arrays["bond_type"]

    neighborhoods: list[set[int]] = [set() for _ in range(n)]
    dead = [len(adj[i]) == 0 for i in range(n)]
    seen: list[frozenset[int]] = []

    for rnd in range(1, radius + 1):
        next_inv = inv.copy()
        round_nbr: list[set[int]] = [set() for _ in range(n)]
        for i in range(n):
            if not adj[i]:
                continue
            pairs = []
            nbr = set(neighborhoods[i])
            for bi, j in adj[i]:
                pairs.append((_bond_code(bond_type[bi]), int(inv[j])))
                nbr.add(bi)
                nbr |= neighborhoods[j]
            pairs.sort()
            seed = _U32(0)
            seed = hash_combine_u32(seed, _U32(rnd))
            seed = hash_combine_u32(seed, inv[i])
            for code, v in pairs:
                seed = hash_combine_u32(seed, _U32(code))
                seed = hash_combine_u32(seed, _U32(v))
            next_inv[i] = seed
            round_nbr[i] = nbr

        order = sorted(
            (i for i in range(n) if not dead[i]),
            key=lambda i: (sorted(round_nbr[i]), int(next_inv[i]), i),
        )
        accepted: list[frozenset[int]] = []
        for i in order:
            fs = frozenset(round_nbr[i])
            if fs in seen or fs in accepted:
                dead[i] = True
                continue
            accepted.append(fs)
            bits[int(next_inv[i]) % fp_size] = 1
        seen.extend(accepted)
        inv = next_inv
        neighborhoods = round_nbr

    return pack_bits_np(bits)
