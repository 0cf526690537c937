"""Torsion Fingerprint Deviation: torsion enumeration, kernels K17 and K18.

The port of ``nvmolkit_tpu/ops/tfd.py``, in two halves.

The host half is a copy of the JAX package's torsion enumeration, quirks
included (RDKit ``TorsionFingerprints`` semantics, ``src/tfd/tfd_common.cpp``
of the reference): :func:`enumerate_torsions` gives one
:class:`TorsionSet` per molecule, with the rotatable bonds' quartets chosen
by Morgan invariants at ``symm_radius`` (the degree at radius 0), one Ring
torsion per SSSR ring, the 'equal' or 'spec' maximum deviations and the
central-bond distance weights (the non-ring bonds' weights, then the
``get_bond_rings`` order, cut or extended to the torsion count).

The device half works on one flat CSR batch of a call's molecules
(:class:`TFDBatch`, made by :func:`make_batch`), without the TPU's padding:

* :func:`dihedral_angles` — K17 (``csrc/tfd.cu``) for CUDA tensors, else
  :func:`dihedral_angles_plain`: the dihedral of every (molecule,
  conformer, quartet) in degrees, as the JAX ``dihedral_angles`` computes
  it (atan2 of the normals' cross and dot products; 0 where a normal
  vanishes; plus 360 where negative, so in [0, 360]: a tiny negative angle
  plus 360 rounds to 360.0 in float32, which the circular difference
  takes as 0);
* :func:`tfd_pairs` — K18 for CUDA tensors, else :func:`tfd_pairs_plain`:
  per conformer pair the weighted mean over the torsions of the Single
  (circular difference of quartet 0), Ring (difference of the mean
  |angle - 180|) or Symmetric (least circular difference over every
  pairing of the quartets) deviation over ``max_dev``, as the JAX
  ``tfd_matrix_condensed`` does, written to each molecule's condensed
  offset (i > j at i(i-1)/2 + j) in one flat float32 buffer. K18 runs a
  block per tile of a molecule's pair triangle (``TFDBatch.tiles``, made
  with the batch: rows [i0, i0 + TILE), columns [j0, j0 + TILE)), its
  conformers' values staged in shared memory a chunk of torsions at a time
  (``TFDBatch.value_starts``, ``cap``).

A build or launch failure raises; there is no fallback. Everything on the
device is float32, the JAX package's default. ``launch_counts`` counts the
launches of K17 and K18.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque

import numpy as np
import torch

from nvmolkit_tpu_torch._build import tfd_lib
from nvmolkit_tpu_torch.chem.mol import Mol
from nvmolkit_tpu_torch.chem.rings import get_bond_rings, get_sssr
from nvmolkit_tpu_torch.ops.morgan_cpu import morgan_atom_invariants_at_radius

TORSION_SINGLE = 0
TORSION_RING = 1
TORSION_SYMMETRIC = 2


@dataclasses.dataclass
class TorsionSet:
    """Per-molecule torsion library (ragged: quartets CSR per torsion)."""

    quartets: np.ndarray        # [Qtot, 4] int32
    quartet_starts: np.ndarray  # [T+1] int32
    types: np.ndarray           # [T] int32 (TORSION_*)
    weights: np.ndarray         # [T] f32
    max_dev: np.ndarray         # [T] f32 (degrees)

    @property
    def n_torsions(self) -> int:
        return len(self.types)

    @staticmethod
    def empty() -> "TorsionSet":
        return TorsionSet(
            np.zeros((0, 4), np.int32), np.zeros(1, np.int32),
            np.zeros(0, np.int32), np.zeros(0, np.float32),
            np.zeros(0, np.float32),
        )


def _heavy_neighbors(mol: Mol, atom: int, exclude: int = -1) -> list[int]:
    return [
        v
        for v in mol.neighbors(atom)
        if mol.atoms[v].atomic_num != 1 and v != exclude
    ]


def _bonds_for_torsions(
    mol: Mol, ignore_colinear_bonds: bool
) -> list[tuple[int, int, list[int], list[int]]]:
    """(a1, a2, nb1, nb2) per torsion bond (getBondsForTorsions)."""
    n = mol.num_atoms
    flags = [0] * n
    for b in mol.bonds:
        if b.order == 3.0:
            flags[b.begin] = flags[b.end] = 1
    for i, atom in enumerate(mol.atoms):
        if atom.atomic_num != 6:
            continue
        if sum(1 for bi in mol.atom_bonds(i) if mol.bonds[bi].order == 2.0) == 2:
            flags[i] = 1

    out = []
    done = [False] * mol.num_bonds
    for bi, b in enumerate(mol.bonds):
        if b.in_ring:
            continue
        a1, a2 = b.begin, b.end
        nb1 = _heavy_neighbors(mol, a1, a2)
        nb2 = _heavy_neighbors(mol, a2, a1)
        if done[bi] or not nb1 or not nb2:
            continue
        done[bi] = True
        if flags[a1] or flags[a2]:
            if ignore_colinear_bonds:
                continue
            # walk outward past the colinear unit (RDKit's else branch)
            while len(nb1) == 1 and flags[a1]:
                a1_old, a1 = a1, nb1[0]
                bb = mol.bond_between(a1_old, a1)
                if bb is None:
                    break
                nb1 = _heavy_neighbors(mol, a1, a1_old)
                done[_bond_index(mol, a1_old, a1)] = True
            while len(nb2) == 1 and flags[a2]:
                a2_old, a2 = a2, nb2[0]
                bb = mol.bond_between(a2_old, a2)
                if bb is None:
                    break
                nb2 = _heavy_neighbors(mol, a2, a2_old)
                done[_bond_index(mol, a2_old, a2)] = True
            if nb1 and nb2:
                out.append((a1, a2, nb1, nb2))
        else:
            out.append((a1, a2, nb1, nb2))
    return out


def _bond_index(mol: Mol, a: int, b: int) -> int:
    for bi in mol.atom_bonds(a):
        if mol.bonds[bi].other(a) == b:
            return bi
    raise KeyError((a, b))


def _index_for_torsion(neighbors: list[int], inv: np.ndarray) -> list[int]:
    """Reference atoms for one side of a torsion (getIndexForTorsion)."""
    if len(neighbors) == 1:
        return neighbors
    invs = [int(inv[x]) for x in neighbors]
    if len(set(invs)) == 1:
        return neighbors  # all symmetric: keep all
    if len(neighbors) == 3:
        # exactly one different
        for x in range(3):
            others = [invs[y] for y in range(3) if y != x]
            if others[0] == others[1] and invs[x] != others[0]:
                return [neighbors[x]]
    return [min(neighbors, key=lambda x: int(inv[x]))]


def _topological_distances(mol: Mol) -> np.ndarray:
    """All-pairs unweighted shortest-path distances [n, n] (float)."""
    n = mol.num_atoms
    dist = np.full((n, n), 1e6, np.float64)
    for s in range(n):
        dist[s, s] = 0.0
        q = deque([s])
        while q:
            u = q.popleft()
            for v in mol.neighbors(u):
                if dist[s, v] > dist[s, u] + 1:
                    dist[s, v] = dist[s, u] + 1
                    q.append(v)
    return dist


def _find_central_bond(mol: Mol, dist: np.ndarray) -> tuple[int, int]:
    """Atom pair of the most central bond (min distance STD), or (-1,-1)."""
    n = mol.num_atoms
    stds = []
    for i in range(n):
        if len(_heavy_neighbors(mol, i)) < 2:
            continue
        d = np.delete(dist[i], i)
        stds.append((float(d.std()), i))
    if not stds:
        return -1, -1
    stds.sort()
    aid1 = stds[0][1]
    for _, cand in stds[1:]:
        if mol.bond_between(aid1, cand) is not None:
            return aid1, cand
    return -1, -1


def _beta(mol: Mol, dist: np.ndarray, aid1: int) -> float:
    """Weight decay parameter (calculateBeta, post-typo-fix RDKit)."""
    dmax = 0.0
    for b in mol.bonds:
        nb1 = _heavy_neighbors(mol, b.begin)
        nb2 = _heavy_neighbors(mol, b.end)
        if len(nb1) > 1 and len(nb2) > 1:
            d = max(dist[aid1, b.begin], dist[aid1, b.end])
            dmax = max(dmax, d)
    dmax2 = dmax / 2.0
    if dmax2 < 1e-6:
        dmax2 = 1.0
    return -math.log(0.1) / (dmax2 * dmax2)


def enumerate_torsions(
    mol: Mol,
    use_weights: bool = True,
    max_dev: str = "equal",
    symm_radius: int = 2,
    ignore_colinear_bonds: bool = True,
) -> TorsionSet:
    """Host-side torsion enumeration with RDKit TorsionFingerprints
    semantics (see module docstring)."""
    bonds = _bonds_for_torsions(mol, ignore_colinear_bonds)

    if symm_radius > 0:
        inv = morgan_atom_invariants_at_radius(mol, symm_radius)
    else:
        inv = np.asarray([mol.degree(i) for i in range(mol.num_atoms)], np.uint32)

    quartets: list[tuple[int, int, int, int]] = []
    starts = [0]
    types: list[int] = []
    maxdevs: list[float] = []

    for a1, a2, nb1, nb2 in bonds:
        d1 = _index_for_torsion(nb1, inv)
        d2 = _index_for_torsion(nb2, inv)
        if max_dev == "equal":
            qs = [(x, a1, a2, y) for x in d1 for y in d2]
            md = 180.0
        else:  # 'spec'
            if len(d1) == 1 and len(d2) == 1:
                qs = [(d1[0], a1, a2, d2[0])]
                md = 180.0
            elif len(d1) == 1:
                qs = [(d1[0], a1, a2, y) for y in d2]
                md = 90.0 if len(nb2) == 2 else 60.0
            elif len(d2) == 1:
                qs = [(x, a1, a2, d2[0]) for x in d1]
                md = 90.0 if len(nb1) == 2 else 60.0
            else:
                qs = [(x, a1, a2, y) for x in d1 for y in d2]
                if len(nb1) == 2 and len(nb2) == 2:
                    md = 90.0
                elif len(nb1) == 3 and len(nb2) == 3:
                    md = 60.0
                else:
                    md = 30.0
        if not qs:
            continue
        quartets.extend(qs)
        starts.append(len(quartets))
        types.append(TORSION_SYMMETRIC if len(qs) > 1 else TORSION_SINGLE)
        maxdevs.append(md)

    n_nonring = len(types)
    rings = get_sssr(mol)
    for ring in rings:
        num = len(ring)
        md = 180.0 if num >= 14 else 180.0 * math.exp(-0.025 * (num - 14) ** 2)
        qs = [
            (ring[i], ring[(i + 1) % num], ring[(i + 2) % num], ring[(i + 3) % num])
            for i in range(num)
        ]
        quartets.extend(qs)
        starts.append(len(quartets))
        types.append(TORSION_RING if len(qs) > 1 else TORSION_SINGLE)
        maxdevs.append(md)

    if not types:
        return TorsionSet.empty()

    # weights
    if use_weights:
        dist = _topological_distances(mol)
        aid1, aid2 = _find_central_bond(mol, dist)
        if aid1 < 0:
            weights = [1.0] * len(types)
        else:
            beta = _beta(mol, dist, aid1)
            weights = []
            for a1, a2, _nb1, _nb2 in bonds:
                if {a1, a2} == {aid1, aid2}:
                    d = 0.0
                else:
                    d = (
                        min(
                            dist[aid1, a1], dist[aid1, a2],
                            dist[aid2, a1], dist[aid2, a2],
                        )
                        + 1.0
                    )
                weights.append(math.exp(-beta * d * d))
            for bond_ring in get_bond_rings(mol):
                num = len(bond_ring)
                sum_d = 0.0
                for bidx in bond_ring:
                    b = mol.bonds[bidx]
                    sum_d += (
                        min(
                            dist[aid1, b.begin], dist[aid1, b.end],
                            dist[aid2, b.begin], dist[aid2, b.end],
                        )
                        + 1.0
                    )
                avg_d = sum_d / num
                weights.append(math.exp(-beta * avg_d * avg_d) * (num / 2.0))
            # non-ring weight list aligns with `bonds`; drop entries for
            # bonds that produced no quartets (never happens: nb1/nb2
            # non-empty implies quartets), and truncate/extend defensively
            weights = weights[: len(types)]
            while len(weights) < len(types):
                weights.append(1.0)
    else:
        weights = [1.0] * len(types)

    del n_nonring
    return TorsionSet(
        np.asarray(quartets, np.int32),
        np.asarray(starts, np.int32),
        np.asarray(types, np.int32),
        np.asarray(weights, np.float32),
        np.asarray(maxdevs, np.float32),
    )


# ---------------------------------------------------------------------------
# the device half
# ---------------------------------------------------------------------------

launch_counts = {"dihedral_angles": 0, "tfd_pairs": 0}

# rows of TFDBatch.mol_offsets
ANGLES, CONFS, PAIRS, OUT, TORSIONS = range(5)
TILE = 64        # conformers a side of K18's tile (csrc/tfd.cu TILE)
VALUE_CAP = 128  # values K18 stages a chunk, unless one torsion has more
# work items of a K17 block: about a K17_BLOCKS-th of the batch's, between
# K17_MIN_ITEMS and K17_ITEMS (one conformer's may pass them)
K17_ITEMS, K17_MIN_ITEMS, K17_BLOCKS = 1024, 256, 1024
SHARED_MAX = 227 * 1024  # shared bytes a block may hold (sm_90)
EPS32 = 2.0 ** -23
_DEGREES = 57.29577951308232  # 180 / pi, as a float32 factor on both sides
_PLAIN_BUDGET = 1 << 25  # float32 elements of tfd_pairs_plain's [pairs, T, Q, Q] per chunk


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


@dataclasses.dataclass
class TFDBatch:
    """The molecules of one call that have torsions, as flat tables on one device.

    ``mol_offsets`` int64 [5, M + 1] holds per molecule the prefix sums of
    its angles (conformers x quartets: K17's work items, the rows of the
    angle buffer, conformer-major), of its conformers (into ``conf_rows``),
    of its condensed pairs (K18's work items) and of its torsions; row OUT
    holds each molecule's first entry in the call's condensed buffer, and
    that buffer's length last. ``conf_rows`` int64 [sum C]: the first
    coordinate row of each conformer, in pair order. ``torsion_quartets``
    int64 [T + 1]: the quartet offsets of the torsions. ``quartets`` int32
    [Q, 4] atom indices, ``types`` int32 [T] (``TORSION_*``), ``weights``
    and ``max_dev`` float32 [T]. ``value_starts`` int64 [T + 1]: each
    torsion's first value among those K18 stages a conformer (a Symmetric
    torsion's values its quartets' angles, a Single's its angle, a Ring's
    its mean). ``tiles`` int32 [n_tiles, 3]: K18's tiles (batch molecule,
    i0, j0), i0 >= j0 multiples of ``TILE``, each molecule's in order, which
    together cover each of its pairs once. ``cap``: the values a K18 chunk
    stages (the largest molecule's, at most ``VALUE_CAP`` unless one torsion
    has more). ``conformer_blocks`` int32 [n_blocks, 4]: K17's blocks
    (batch molecule, first conformer, conformer count, quartet count), each
    molecule's in order, which together cover each of its conformers once;
    ``block_starts`` int64 [n_blocks, 3]: each block's molecule's first
    quartet, its first entry of ``conf_rows`` and its first angle;
    ``block_bytes``: the most shared memory one of them stages.
    ``coords`` float32 [R, 3] when the coordinates were packed on the host
    and copied with the tables."""

    mol_offsets: torch.Tensor
    conf_rows: torch.Tensor
    torsion_quartets: torch.Tensor
    quartets: torch.Tensor
    types: torch.Tensor
    weights: torch.Tensor
    max_dev: torch.Tensor
    value_starts: torch.Tensor
    tiles: torch.Tensor
    conformer_blocks: torch.Tensor
    block_starts: torch.Tensor
    n_angles: int
    n_pairs: int
    n_out: int
    cap: int
    block_bytes: int
    coords: torch.Tensor | None = None

    @property
    def n_mols(self) -> int:
        return self.mol_offsets.shape[1] - 1


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(a)
    if device.type == "cuda":  # pinned and queued: no host sync
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def pair_tiles(conf_counts: np.ndarray) -> np.ndarray:
    """int32 [n_tiles, 3]: K18's tiles (molecule, i0, j0) over molecules of
    ``conf_counts`` conformers, each molecule's in order: every (I, J), I >=
    J, of its ceil(C / TILE) blocks of conformers, at (I TILE, J TILE).
    (Not ``np.unique``: its first call can import ``numpy.ma``, ~0.1 s.)"""
    sides = -(-np.asarray(conf_counts, np.int64) // TILE)
    parts = [np.zeros((0, 3), np.int32)]
    for n in sorted(set(sides.tolist())):
        ks = np.nonzero(sides == n)[0]
        big, small = np.tril_indices(int(n))
        part = np.empty((len(ks), len(big), 3), np.int32)
        part[..., 0] = ks[:, None]
        part[..., 1] = big * TILE
        part[..., 2] = small * TILE
        parts.append(part.reshape(-1, 3))
    tiles = np.concatenate(parts)
    return tiles[np.argsort(tiles[:, 0], kind="stable")]


def conformer_blocks(conf_counts, n_quartets, items: int | None = None) -> np.ndarray:
    """int32 [n_blocks, 4]: K17's blocks (molecule, first conformer,
    conformer count, quartet count) over molecules of ``conf_counts``
    conformers and ``n_quartets`` quartets, each molecule's in order: its
    conformers cut into the fewest even pieces of at most ``items`` work
    items (by default a ``K17_BLOCKS``-th of the batch's, between
    ``K17_MIN_ITEMS`` and ``K17_ITEMS``), one conformer at least."""
    counts = np.asarray(conf_counts, np.int64)
    n_quartets = np.asarray(n_quartets, np.int64)
    if items is None:
        items = min(K17_ITEMS, max(K17_MIN_ITEMS, int(counts @ n_quartets) // K17_BLOCKS))
    pieces = -(-counts // np.maximum(1, items // n_quartets))
    size = -(-counts // np.maximum(pieces, 1))
    mol = np.repeat(np.arange(len(counts)), pieces)
    first = (np.arange(len(mol)) - np.repeat(np.cumsum(pieces) - pieces, pieces)) * size[mol]
    return np.stack([mol, first, np.minimum(size[mol], counts[mol] - first), n_quartets[mol]],
                    axis=1).astype(np.int32)


def block_starts(blocks: np.ndarray, off: np.ndarray, q_first: np.ndarray) -> np.ndarray:
    """int64 [n_blocks, 3]: each K17 block's molecule's first quartet
    (``q_first`` per molecule), its first entry of ``conf_rows`` and its first
    angle (``off``: the batch's ``mol_offsets``)."""
    mol, first = blocks[:, 0], blocks[:, 1].astype(np.int64)
    return np.stack([np.asarray(q_first, np.int64)[mol], off[CONFS, mol] + first,
                     off[ANGLES, mol] + first * blocks[:, 3]], axis=1)


def k17_block_bytes(blocks: np.ndarray) -> int:
    """The most shared memory a K17 block of ``blocks`` stages: its
    molecule's quartets (16 bytes each) and its conformers' rows (8)."""
    return int((16 * blocks[:, 3].astype(np.int64) + 8 * blocks[:, 2]).max(initial=0))


def make_batch(torsion_sets: list[TorsionSet], conf_rows: list[np.ndarray], device,
               coords: np.ndarray | None = None) -> TFDBatch:
    """The batch of a call's molecules: ``torsion_sets`` and ``conf_rows``
    (int64, the first coordinate row of each of the molecule's conformers,
    two or more) cover every molecule, in order, and the call's condensed
    buffer holds C(C-1)/2 entries for each; the molecules without torsions
    stay out of the batch (their entries stay 0). The integer tables, the
    quartets with the types, K18's tiles and K17's blocks, and the float
    tables (with ``coords``, float32 [R, 3], when given) go to ``device`` in
    one copy each."""
    device = torch.device(device)
    n_confs = np.array([len(r) for r in conf_rows], np.int64)
    pairs = n_confs * (n_confs - 1) // 2
    first_out = np.concatenate([[0], np.cumsum(pairs)])
    active = [k for k, ts in enumerate(torsion_sets) if ts.n_torsions]
    sets = [torsion_sets[k] for k in active]
    n_quartets = np.array([len(ts.quartets) for ts in sets], np.int64)
    conf_counts = n_confs[active]
    off = np.zeros((5, len(active) + 1), np.int64)
    np.cumsum(conf_counts * n_quartets, out=off[ANGLES, 1:])
    np.cumsum(conf_counts, out=off[CONFS, 1:])
    np.cumsum(pairs[active], out=off[PAIRS, 1:])
    off[OUT, :-1] = first_out[active]
    off[OUT, -1] = first_out[-1]
    np.cumsum([ts.n_torsions for ts in sets], out=off[TORSIONS, 1:])
    q_base = np.concatenate([[0], np.cumsum(n_quartets)])
    torsion_quartets = np.concatenate(
        [[0]] + [q_base[k] + ts.quartet_starts[1:] for k, ts in enumerate(sets)]).astype(np.int64)
    rows = np.concatenate([np.zeros(0, np.int64)] + [conf_rows[k] for k in active])
    types = np.concatenate([np.zeros(0, np.int32)] + [ts.types.astype(np.int32) for ts in sets])
    values = np.where(types == TORSION_SYMMETRIC, np.diff(torsion_quartets), 1)
    value_starts = np.concatenate([[0], np.cumsum(values)]).astype(np.int64)
    per_mol = value_starts[off[TORSIONS, 1:]] - value_starts[off[TORSIONS, :-1]]
    cap = max(min(VALUE_CAP, int(per_mol.max(initial=1))), int(values.max(initial=1)))
    tiles = pair_tiles(conf_counts)
    blocks = conformer_blocks(conf_counts, n_quartets)
    ints = np.concatenate([off.ravel(), rows.astype(np.int64), torsion_quartets, value_starts,
                           block_starts(blocks, off, q_base).ravel()])
    quartets = np.concatenate([np.zeros((0, 4), np.int32)] + [ts.quartets for ts in sets])
    # the quartets and K17's blocks first: K17 reads both as int4 (16-byte aligned)
    i32 = np.concatenate([quartets.astype(np.int32).ravel(), blocks.ravel(), types,
                          tiles.ravel()])
    n_t = int(off[TORSIONS, -1])
    floats = [ts.weights for ts in sets] + [ts.max_dev for ts in sets]
    if coords is not None:
        floats.append(np.asarray(coords).reshape(-1))
    f32 = np.concatenate([np.zeros(0, np.float32)] + floats).astype(np.float32)
    ints_d, i32_d, f32_d = (_to_device(a, device) for a in (ints, i32, f32))
    n_off, n_rows, n_q = off.size, len(rows), len(quartets)
    n_tq = n_off + n_rows + n_t + 1
    n_vs = n_tq + n_t + 1
    n_types = 4 * n_q + blocks.size
    return TFDBatch(
        mol_offsets=ints_d[:n_off].view(5, -1), conf_rows=ints_d[n_off:n_off + n_rows],
        torsion_quartets=ints_d[n_off + n_rows:n_tq], quartets=i32_d[:4 * n_q].view(n_q, 4),
        conformer_blocks=i32_d[4 * n_q:n_types].view(-1, 4),
        types=i32_d[n_types:n_types + n_t], weights=f32_d[:n_t], max_dev=f32_d[n_t:2 * n_t],
        value_starts=ints_d[n_tq:n_vs], tiles=i32_d[n_types + n_t:].view(-1, 3),
        block_starts=ints_d[n_vs:].view(-1, 3),
        n_angles=int(off[ANGLES, -1]), n_pairs=int(off[PAIRS, -1]), n_out=int(first_out[-1]),
        cap=cap, block_bytes=k17_block_bytes(blocks),
        coords=f32_d[2 * n_t:].view(-1, 3) if coords is not None else None)


def _molecule_quartets(batch: TFDBatch) -> tuple[torch.Tensor, torch.Tensor]:
    """Each molecule's first quartet and quartet count."""
    off, tq = batch.mol_offsets, batch.torsion_quartets
    first = tq[off[TORSIONS, :-1]]
    return first, tq[off[TORSIONS, 1:]] - first


def pair_ij(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(i, j), i > j, of condensed indices ``p = i(i-1)/2 + j`` (int64): a
    float64 square root, then one integer correction each way."""
    i = ((1.0 + torch.sqrt(8.0 * p.double() + 1.0)) * 0.5).long()
    i = i + (i * (i + 1) // 2 <= p).long()
    i = i - (i * (i - 1) // 2 > p).long()
    return i, p - i * (i - 1) // 2


def _quartet_points(coords: torch.Tensor, batch: TFDBatch) -> torch.Tensor:
    """[n_angles, 4, 3]: the four atoms of every K17 work item."""
    off = batch.mol_offsets
    w = torch.arange(batch.n_angles, device=off.device)
    m = torch.searchsorted(off[ANGLES], w, right=True) - 1
    first, count = _molecule_quartets(batch)
    local = w - off[ANGLES, m]
    c = torch.div(local, count[m], rounding_mode="floor")
    row = batch.conf_rows[off[CONFS, m] + c]
    atoms = batch.quartets[first[m] + local - c * count[m]].long()
    return coords[row[:, None] + atoms]


def dihedral_angles_plain(coords: torch.Tensor, batch: TFDBatch) -> torch.Tensor:
    """The plain version of :func:`dihedral_angles`: the JAX
    ``dihedral_angles`` arithmetic over every work item at once."""
    return dihedral_of_points(_quartet_points(coords, batch))


def dihedral_of_points(p: torch.Tensor) -> torch.Tensor:
    """The JAX ``dihedral_angles`` arithmetic on quartets of points [n, 4, 3]:
    the dihedral of each in [0, 360] degrees."""
    b1 = p[:, 2] - p[:, 1]
    v1 = p[:, 0] - p[:, 1]
    v2 = p[:, 3] - p[:, 2]
    n1 = torch.linalg.cross(v1, b1)
    n2 = torch.linalg.cross(b1, v2)
    x = (n1 * n2).sum(dim=-1)
    y = (torch.linalg.cross(n1, n2) * b1).sum(dim=-1) / torch.linalg.norm(
        b1, dim=-1).clamp_min(1e-10)
    deg = torch.atan2(y, x) * _DEGREES
    flat = (torch.linalg.norm(n1, dim=-1) < 1e-10) | (torch.linalg.norm(n2, dim=-1) < 1e-10)
    deg = torch.where(flat, 0.0, deg)
    return torch.where(deg < 0.0, deg + 360.0, deg)


def dihedral_tolerance(coords: torch.Tensor, batch: TFDBatch) -> torch.Tensor:
    """The largest circular |difference| in degrees allowed between two
    float32 evaluations of each angle (K17, the plain version, the JAX
    package), float64 [n_angles].

    The differences of the atoms are rounded alike in all of them; the
    normals' cross products may round differently (a fused multiply-add,
    another order), by ~2 eps |v1||b1| and 2 eps |b1||v2|, which turns each
    normal about b1 by that over its length; the dot products and atan2 add
    a few eps, the degrees and the 360 wrap half an ulp of 360. Allowed:
    1e-4 deg + 8 eps (2 + |v1||b1| / |n1| + |b1||v2| / |n2|) in radians, in
    degrees: ~3e-4 deg for a quartet bent by 60-120 deg, 1.3e-3 deg at 6
    deg from collinear. Where a normal vanishes both give 0 only if it
    vanishes in both, so the bound grows without limit there."""
    p = _quartet_points(coords, batch).double()
    b1 = p[:, 2] - p[:, 1]
    v1 = p[:, 0] - p[:, 1]
    v2 = p[:, 3] - p[:, 2]
    n1 = torch.linalg.norm(torch.linalg.cross(v1, b1), dim=-1)
    n2 = torch.linalg.norm(torch.linalg.cross(b1, v2), dim=-1)
    lb, l1, l2 = (torch.linalg.norm(v, dim=-1) for v in (b1, v1, v2))
    cond = 2.0 + l1 * lb / n1.clamp_min(1e-300) + lb * l2 / n2.clamp_min(1e-300)
    return 1e-4 + 8.0 * EPS32 * cond * (180.0 / math.pi)


def tfd_tolerance(coords: torch.Tensor, batch: TFDBatch) -> torch.Tensor:
    """The largest |difference| allowed between two float32 evaluations of
    each entry of the call's condensed buffer, float64 [n_out]: 1e-5 (the
    JAX package's own float32 bound, for the sums) plus, for pair (i, j),
    sum_t w_t (a_it + a_jt) / d_t / sum_t w_t, where a_it is the largest
    :func:`dihedral_tolerance` of torsion t's quartets in conformer i and
    d_t its ``max_dev``: each torsion's deviation moves by at most its two
    angles' errors (the circular difference, the ring means and the least
    pairing are 1-Lipschitz in each), over its maximum deviation, and the
    weighted mean by at most the weighted mean of those moves. An
    ill-conditioned quartet loosens only its own torsion's term."""
    off, tq = batch.mol_offsets, batch.torsion_quartets
    dev = off.device
    out = torch.full((batch.n_out,), 1e-5, dtype=torch.float64, device=dev)
    if batch.n_pairs == 0:
        return out
    tol = dihedral_tolerance(coords, batch)
    n_t = off[TORSIONS, 1:] - off[TORSIONS, :-1]
    n_c = off[CONFS, 1:] - off[CONFS, :-1]
    ct_first = torch.cumsum(n_c * n_t, 0) - n_c * n_t  # each molecule's first (conformer, torsion)
    # a_it: the largest angle bound of each (conformer, torsion), molecule by molecule
    w = torch.arange(batch.n_angles, device=dev)
    m = torch.searchsorted(off[ANGLES], w, right=True) - 1
    first, count = _molecule_quartets(batch)
    local = w - off[ANGLES, m]
    c = torch.div(local, count[m], rounding_mode="floor")
    t = torch.searchsorted(tq, first[m] + local - c * count[m], right=True) - 1
    a = torch.zeros(int((n_c * n_t).sum()), dtype=torch.float64, device=dev).scatter_reduce(
        0, ct_first[m] + c * n_t[m] + t - off[TORSIONS, m], tol, "amax")
    weights = batch.weights.double()
    mol_of_t = torch.searchsorted(off[TORSIONS], torch.arange(len(weights), device=dev),
                                  right=True) - 1
    wsum = torch.zeros(batch.n_mols, dtype=torch.float64, device=dev).index_add_(
        0, mol_of_t, weights)
    scale = weights / batch.max_dev.double().clamp_min(1e-6)
    g = torch.arange(batch.n_pairs, device=dev)
    m = torch.searchsorted(off[PAIRS], g, right=True) - 1
    p = g - off[PAIRS, m]
    i, j = pair_ij(p)
    row_i, row_j = ct_first[m] + i * n_t[m], ct_first[m] + j * n_t[m]
    num = torch.zeros(batch.n_pairs, dtype=torch.float64, device=dev)
    for k in range(int(n_t.max())):
        has = k < n_t[m]
        tk = torch.where(has, off[TORSIONS, m] + k, 0)
        term = scale[tk] * (a[torch.where(has, row_i + k, 0)] + a[torch.where(has, row_j + k, 0)])
        num += torch.where(has, term, 0.0)
    out[off[OUT, m] + p] += torch.where(wsum[m] > 1e-10, num / wsum[m].clamp_min(1e-10), 0.0)
    return out


def circular_difference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = (a - b).abs()
    return torch.minimum(d, 360.0 - d)


def tfd_pairs_plain(angles: torch.Tensor, batch: TFDBatch) -> torch.Tensor:
    """The plain version of :func:`tfd_pairs`: the JAX
    ``tfd_matrix_condensed`` arithmetic, every type's deviation of every
    torsion over its molecule's torsions padded to the batch's largest
    count and quartets, in chunks of pairs whose [pairs, T, Q, Q] block
    stays within ``_PLAIN_BUDGET`` elements. The sums run in K18's order
    (quartet by quartet, torsion by torsion; the padding adds zeros), so
    a molecule's values do not depend on the batch around it."""
    off, tq = batch.mol_offsets, batch.torsion_quartets
    dev = angles.device
    out = torch.zeros(batch.n_out, dtype=torch.float32, device=dev)
    if batch.n_pairs == 0:
        return out
    n_t = off[TORSIONS, 1:] - off[TORSIONS, :-1]
    n_q = tq[1:] - tq[:-1]
    t_max, q_max = int(n_t.max()), int(n_q.max())
    t_ok = torch.arange(t_max, device=dev) < n_t[:, None]                 # [M, T]
    torsion = torch.where(t_ok, off[TORSIONS, :-1, None] + torch.arange(t_max, device=dev), 0)
    first, count = _molecule_quartets(batch)
    q_ok = t_ok[..., None] & (torch.arange(q_max, device=dev) < n_q[torsion][..., None])
    local = torch.where(q_ok, (tq[torsion] - first[:, None])[..., None]
                        + torch.arange(q_max, device=dev), 0)                # [M, T, Q]
    types, max_dev = batch.types[torsion], batch.max_dev[torsion].clamp_min(1e-6)
    weights = torch.where(t_ok, batch.weights[torsion], 0.0)
    chunk = max(1, _PLAIN_BUDGET // (t_max * q_max * q_max))
    for lo in range(0, batch.n_pairs, chunk):
        g = torch.arange(lo, min(lo + chunk, batch.n_pairs), device=dev)
        m = torch.searchsorted(off[PAIRS], g, right=True) - 1
        p = g - off[PAIRS, m]
        i, j = pair_ij(p)
        base = (off[ANGLES, m])[:, None, None] + local[m]
        a = angles[base + (i * count[m])[:, None, None]]
        b = angles[base + (j * count[m])[:, None, None]]
        qm = q_ok[m]
        dev_single = circular_difference(a[..., 0], b[..., 0])
        ring_a = torch.where(qm, (a - 180.0).abs(), 0.0)
        ring_b = torch.where(qm, (b - 180.0).abs(), 0.0)
        sum_a, sum_b = ring_a[..., 0], ring_b[..., 0]
        for q in range(1, q_max):
            sum_a, sum_b = sum_a + ring_a[..., q], sum_b + ring_b[..., q]
        nq = qm.sum(dim=-1).clamp_min(1)
        dev_ring = (sum_a / nq - sum_b / nq).abs()
        pair_d = circular_difference(a[..., :, None], b[..., None, :])
        pair_ok = qm[..., :, None] & qm[..., None, :]
        dev_sym = torch.where(pair_ok, pair_d, 180.0).amin(dim=(-2, -1))
        t = types[m]
        dev_t = torch.where(t == TORSION_RING, dev_ring,
                            torch.where(t == TORSION_SYMMETRIC, dev_sym, dev_single)) / max_dev[m]
        w = weights[m]
        num, wsum = dev_t[:, 0] * w[:, 0], w[:, 0]
        for k in range(1, t_max):
            num, wsum = num + dev_t[:, k] * w[:, k], wsum + w[:, k]
        out[off[OUT, m] + p] = torch.where(wsum > 1e-10, num / wsum.clamp_min(1e-10), 0.0)
    return out


def _check_batch(batch: TFDBatch, device: torch.device) -> None:
    for name in ("mol_offsets", "conf_rows", "torsion_quartets", "quartets", "types", "weights",
                 "max_dev", "value_starts", "tiles", "conformer_blocks", "block_starts"):
        t = getattr(batch, name)
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"the batch's {name} must be contiguous and on {device}")


def dihedral_angles(coords: torch.Tensor, batch: TFDBatch) -> torch.Tensor:
    """Float32 [n_angles]: the dihedral in [0, 360] degrees of each quartet
    of each conformer of the batch's molecules, molecule by molecule,
    conformer-major. ``coords`` [R, 3] holds the conformers' atoms, each
    conformer's from its ``conf_rows`` entry on. K17 for CUDA tensors (one
    launch for the batch, a block per piece of a molecule's conformers), the
    plain version for CPU tensors."""
    if coords.dim() != 2 or coords.shape[1] != 3:
        raise ValueError(f"coordinates must be [R, 3], got {tuple(coords.shape)}")
    if not coords.is_cuda:
        return dihedral_angles_plain(coords, batch)
    if coords.dtype != torch.float32 or not coords.is_contiguous():
        raise ValueError(f"K17 takes contiguous float32 coordinates, got {coords.dtype}")
    dev = coords.device
    _check_batch(batch, dev)
    if batch.block_bytes > SHARED_MAX:
        raise ValueError(f"a K17 block stages {batch.block_bytes} bytes, past {SHARED_MAX}: "
                         "a molecule's quartets must fit a block")
    out = torch.empty(batch.n_angles, dtype=torch.float32, device=dev)
    if batch.n_angles == 0:
        return out
    lib = tfd_lib()
    with torch.cuda.device(dev):
        rc = lib.nvmk_dihedral_angles(
            coords.data_ptr(), batch.conf_rows.data_ptr(), batch.quartets.data_ptr(),
            batch.conformer_blocks.data_ptr(), batch.block_starts.data_ptr(),
            batch.conformer_blocks.shape[0], batch.block_bytes, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dihedral_angles kernel launch failed with CUDA error {rc}")
    launch_counts["dihedral_angles"] += 1
    return out


def dihedral_angles_info(batch: TFDBatch) -> dict:
    """K17's instantiation for ``batch``: registers and spilled bytes a
    thread, resident blocks an SM and shared bytes a block at its
    ``block_bytes``, threads a block and the grid (its blocks)."""
    import ctypes

    out = (ctypes.c_int * 5)()
    rc = tfd_lib().nvmk_dihedral_angles_info(batch.block_bytes, out)
    if rc != 0:
        raise RuntimeError(f"nvmk_dihedral_angles_info failed with CUDA error {rc}")
    keys = ("registers", "local_bytes", "blocks_per_sm", "shared_bytes", "threads")
    return {**dict(zip(keys, out)), "grid": int(batch.conformer_blocks.shape[0])}


def tfd_pairs(angles: torch.Tensor, batch: TFDBatch) -> torch.Tensor:
    """Float32 [n_out]: the call's condensed TFD buffer, each molecule's
    pairs (i > j at i(i-1)/2 + j) from its row OUT offset on, 0 for the
    molecules without torsions. K18 for CUDA tensors (one launch for the
    batch, a block per tile), the plain version for CPU tensors."""
    if angles.shape != (batch.n_angles,):
        raise ValueError(f"{batch.n_angles} angles expected, got {tuple(angles.shape)}")
    if not angles.is_cuda:
        return tfd_pairs_plain(angles, batch)
    if angles.dtype != torch.float32 or not angles.is_contiguous():
        raise ValueError(f"K18 takes contiguous float32 angles, got {angles.dtype}")
    dev = angles.device
    _check_batch(batch, dev)
    out = torch.empty(batch.n_out, dtype=torch.float32, device=dev)
    if batch.n_pairs < batch.n_out:  # a molecule without torsions: its entries are 0
        out.zero_()
    if batch.n_pairs == 0:
        return out
    lib = tfd_lib()
    with torch.cuda.device(dev):
        rc = lib.nvmk_tfd_pairs(
            angles.data_ptr(), batch.mol_offsets.data_ptr(), batch.torsion_quartets.data_ptr(),
            batch.value_starts.data_ptr(), batch.types.data_ptr(), batch.weights.data_ptr(),
            batch.max_dev.data_ptr(), batch.tiles.data_ptr(), batch.n_mols,
            batch.tiles.shape[0], batch.cap, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tfd_pairs kernel launch failed with CUDA error {rc}")
    launch_counts["tfd_pairs"] += 1
    return out


def tfd_pairs_info(batch: TFDBatch) -> dict:
    """K18's instantiation for ``batch``: registers and spilled bytes a
    thread, resident blocks an SM and shared bytes a block at its ``cap``,
    threads a block, the tile side, the grid (its tiles) and ``cap``."""
    import ctypes

    out = (ctypes.c_int * 6)()
    rc = tfd_lib().nvmk_tfd_pairs_info(batch.cap, out)
    if rc != 0:
        raise RuntimeError(f"nvmk_tfd_pairs_info failed with CUDA error {rc}")
    keys = ("registers", "local_bytes", "blocks_per_sm", "shared_bytes", "threads", "tile")
    return {**dict(zip(keys, out)), "grid": int(batch.tiles.shape[0]), "cap": batch.cap}
