"""UFF batched energy and gradient: kernel K6 and its plain PyTorch version.

The functional forms and guards are those of
``nvmolkit_tpu/models/uff/energy.py`` (Rappé et al., JACS 114 (1992)
10024); the layout is the port's own, as for MMFF
(:mod:`nvmolkit_tpu_torch.models.flat`):

* :class:`UFFBatch` holds, per unique molecule, flat tables with CSR
  offsets for bonds ``[i, j | r0, k]``, angles ``[i, j, k | k, a0..a4]``,
  torsions ``[i, j, k, l | b0..b6]``, inversions ``[i, j, k, l | k]`` and a
  vdW pair list ``[i, j | x2, d]``; the systems carry ``sys2mol``.
* The pair list holds exactly the nonzero entries of the JAX package's dense
  pair square (``_nb_rows``), bit for bit: ``x2`` is the float32 product
  ``x_i * x_j`` and ``d`` the float32 ``sqrt(max(D_i * D_j, 0))``, over the
  pairs i < j that are not 1-2 or 1-3 and, under ``ignore_interfrag``, lie
  in one fragment. With ``ignore_interfrag=False`` the cross-fragment pairs
  are kept: the JAX package drops them whatever the flag
  (``batch_uff_terms`` calls ``_nb_rows(m, A)`` without it), which the port
  does not copy.
* ``vdw_threshold`` is validated and keys the caches, and drops nothing, as
  in the JAX package (whose dense square keeps every pair).
* K6 reads the pairs from ``pair_table``: each molecule's triangle of pairs
  i < j laid out by diagonals, ``(x2, d)`` where the list has the pair,
  ``(-r0, k)`` where a bond joins it (x2 > 0 on a listed pair), zero
  elsewhere (``flat.diagonal_pairs``, made when the batch is): K6 takes the
  bonds in its pair walk.

:func:`uff_energy_and_grad` launches K6 (``csrc/uff.cu``) for CUDA tensors
and runs :func:`uff_energy_and_grad_plain` (the energy in torch, the
gradient by ``torch.autograd.grad``) for CPU tensors; a build or launch
failure raises. ``launch_counts`` counts K6's launches.
:func:`uff_energy_and_grad_model` computes K6's order and arithmetic on the
CPU, as ``mmff_energy_and_grad_model`` does K4's.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from nvmolkit_tpu_torch._build import uff_lib
from nvmolkit_tpu_torch.chem.mol import Mol, fragment_ids
from nvmolkit_tpu_torch.models import dist_geom, flat
from nvmolkit_tpu_torch.models.mmff.energy import bonded_terms_model, walk_pairs_model
from nvmolkit_tpu_torch.models.terms import BoundedBatchCache
from nvmolkit_tpu_torch.models.uff.builder import UFFTerms, build_uff_terms
from nvmolkit_tpu_torch.models.uff.params import uff_atom_type

_EPS = 1e-10

KINDS = ("bonds", "angles", "torsions", "inversions", "pairs")
ARITY = (2, 3, 4, 4, 2)
# parameter columns of each bonded kind, in the order csrc/uff.cu reads them
PARAMS = (
    ("r0", "k"),
    ("k", "a0", "a1", "a2", "a3", "a4"),
    ("b0", "b1", "b2", "b3", "b4", "b5", "b6"),
    ("k",),
)

# the phases of K6's per-warp clock (``phase_cycles=True``; csrc/dg_pairs.cuh
# EvalPhase): "terms_a" the bonds and angles, "terms_b" the torsions and
# inversions, "wait" the zeroing's barrier; "pairs_b" is not used
EVAL_PHASES = dist_geom.EVAL_PHASES
PAIR_WIDTH = 2  # the pair table's columns: x2, d (a bond's -r0, k)

launch_counts = {"uff_energy_grad": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


@dataclasses.dataclass
class UFFBatch:
    """Flat UFF tables of U unique molecules (see the module doc)."""

    max_atoms: int
    n_atoms: torch.Tensor             # int32 [U]
    offsets: torch.Tensor             # int32 [5, U + 1]
    atoms: tuple[torch.Tensor, ...]   # per kind int32 [T, arity]
    params: tuple[torch.Tensor, ...]  # per kind float32 [T, P]
    # K6's pair walk: each molecule's first entry, int32 [U + 1], and the
    # pairs by diagonals [sum n (n - 1) / 2, 2] (made from the pair list and
    # the bonds if None)
    pair_offsets: torch.Tensor | None = None
    pair_table: torch.Tensor | None = None

    def __post_init__(self):
        if self.pair_table is None:
            bonds = self.params[0] * torch.tensor([-1.0, 1.0], dtype=self.params[0].dtype,
                                                  device=self.params[0].device)
            if bool((bonds[:, 0] >= 0).any()):
                raise ValueError("a bond with r0 <= 0")
            self.pair_offsets, self.pair_table = flat.diagonal_pairs(self.n_atoms, (
                (self.offsets[4], self.atoms[4], self.params[4], (0, 1), True),
                (self.offsets[0], self.atoms[0], bonds, (0, 1), False)), PAIR_WIDTH)

    @property
    def derived_tables(self) -> tuple[torch.Tensor, torch.Tensor]:
        """What K6 reads beside the lists (``flat.kernel_tables``)."""
        return self.pair_offsets, self.pair_table

    @property
    def n_mols(self) -> int:
        return int(self.n_atoms.shape[0])

    @property
    def device(self) -> torch.device:
        return self.n_atoms.device

    def to(self, device) -> "UFFBatch":
        def put(t):
            return t.to(device, non_blocking=True)

        return dataclasses.replace(
            self, n_atoms=put(self.n_atoms), offsets=put(self.offsets),
            atoms=tuple(put(a) for a in self.atoms), params=tuple(put(p) for p in self.params),
            pair_offsets=put(self.pair_offsets), pair_table=put(self.pair_table))


def _excluded(mol: Mol) -> set[tuple[int, int]]:
    """The 1-2 and 1-3 pairs (i < j)."""
    out = {(min(b.begin, b.end), max(b.begin, b.end)) for b in mol.bonds}
    for j in range(mol.num_atoms):
        nbrs = mol.neighbors(j)
        for x in range(len(nbrs)):
            for y in range(x + 1, len(nbrs)):
                a, c = nbrs[x], nbrs[y]
                out.add((min(a, c), max(a, c)))
    return out


def pair_table(mol: Mol, ignore_interfrag: bool = True):
    """One molecule's vdW pair list, the nonzero entries of the JAX package's
    ``_nb_rows`` square in row-major order: (int32 [P, 2] atoms, float32
    [P, 2] (x2, d)). Cached on the molecule by ``ignore_interfrag``."""
    cache = getattr(mol, "_uff_pairs_cache", None)
    if cache is not None and cache[0] == ignore_interfrag:
        return cache[1]
    n = mol.num_atoms
    types = [uff_atom_type(mol, i) for i in range(n)]
    x = np.asarray([p.x1 for p in types], np.float32)
    d = np.asarray([p.D1 for p in types], np.float32)
    mask = np.triu(np.ones((n, n), bool), 1)
    for i, j in _excluded(mol):
        mask[i, j] = False
    if ignore_interfrag:
        frag = np.asarray(fragment_ids(mol))
        mask &= frag[:, None] == frag[None, :]
    x2 = np.where(mask, np.outer(x, x), 0.0).astype(np.float32)
    dij = np.where(mask, np.sqrt(np.maximum(np.outer(d, d), 0.0)), 0.0).astype(np.float32)
    i, j = np.nonzero((x2 != 0) | (dij != 0))
    rows = (np.stack([i, j], 1).astype(np.int32).reshape(-1, 2),
            np.stack([x2[i, j], dij[i, j]], 1).astype(np.float32).reshape(-1, 2))
    mol._uff_pairs_cache = (ignore_interfrag, rows)
    return rows


def batch_uff_terms(terms: list[UFFTerms], mols: list[Mol], max_atoms: int,
                    ignore_interfrag: bool = True, *, device) -> UFFBatch:
    """Pack the tables of unique molecules ``mols`` (their bonded ``terms``
    from :func:`build_uff_terms`, at most ``max_atoms`` atoms each) into one
    :class:`UFFBatch` on ``device``."""
    for s, m in enumerate(mols):
        if m.num_atoms > max_atoms:
            raise ValueError(f"system {s} has {m.num_atoms} atoms > bucket {max_atoms}")
    atoms, params = [], []
    counts = np.zeros((len(KINDS), len(terms)), np.int64)
    for k, kind in enumerate(KINDS[:4]):
        tables = [getattr(t, kind) for t in terms]
        atoms.append(np.concatenate([t.atoms for t in tables]) if tables
                     else np.zeros((0, ARITY[k]), np.int32))
        params.append(np.stack([np.concatenate([t.params[p] for t in tables])
                                for p in PARAMS[k]], 1) if tables
                      else np.zeros((0, len(PARAMS[k])), np.float32))
        counts[k] = [t.n_terms for t in tables]
    pairs = [pair_table(m, ignore_interfrag) for m in mols]
    atoms.append(np.concatenate([a for a, _ in pairs]) if pairs else np.zeros((0, 2), np.int32))
    params.append(np.concatenate([p for _, p in pairs]) if pairs else np.zeros((0, 2), np.float32))
    counts[4] = [len(a) for a, _ in pairs]
    offsets = np.zeros((len(KINDS), len(terms) + 1), np.int64)
    np.cumsum(counts, axis=1, out=offsets[:, 1:])
    if offsets[:, -1].max(initial=0) >= 2**31:
        raise ValueError("more than 2^31 terms of one kind in a batch")

    def tensor(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype))

    return UFFBatch(
        max_atoms=max_atoms, n_atoms=tensor(np.asarray([m.num_atoms for m in mols]), np.int32),
        offsets=tensor(offsets, np.int32), atoms=tuple(tensor(a, np.int32) for a in atoms),
        params=tuple(tensor(p, np.float32) for p in params)).to(device)


# Batch-level cache: repeated optimize calls over the SAME molecule list
# skip the packing and the host -> device copy of the tables.
_BATCH_CACHE = BoundedBatchCache()


def make_batched_uff(
    mols: list[Mol],
    max_atoms: int,
    vdw_threshold: float = 100.0,
    ignore_interfrag: bool = True,
    *,
    device,
) -> UFFBatch:
    """Build and batch UFF terms for a bucket of unique molecules, on
    ``device``, which the caller resolves.

    Per-molecule parametrization is cached on the Mol object
    (``_uff_terms_cache``, keyed by ``ignore_interfrag`` as in the JAX
    package), the batched tables per molecule LIST, bucket, flags and
    device. Editing a Mol's graph after the first use requires a fresh Mol.
    ``vdw_threshold`` must be a positive finite number; it keys the cache
    and drops no pair (see the module doc).
    """
    vdw_threshold = float(vdw_threshold)
    if not (math.isfinite(vdw_threshold) and vdw_threshold > 0):
        raise ValueError(f"vdwThreshold must be a positive number, got {vdw_threshold}")
    batch_key = (tuple(id(m) for m in mols), max_atoms, ignore_interfrag, vdw_threshold,
                 str(torch.device(device)))
    hit = _BATCH_CACHE.get(batch_key)
    if hit is not None:
        return hit
    terms = []
    for m in mols:
        cached = getattr(m, "_uff_terms_cache", None)
        if cached is None or cached[0] != ignore_interfrag:
            cached = (ignore_interfrag, build_uff_terms(m, ignore_interfrag=ignore_interfrag))
            m._uff_terms_cache = cached
        terms.append(cached[1])
    batch = batch_uff_terms(terms, mols, max_atoms, ignore_interfrag, device=device)
    _BATCH_CACHE.put(batch_key, mols, batch)
    return batch


# ---- the plain version --------------------------------------------------------

def _norm(d):
    return torch.sqrt((d * d).sum(-1) + _EPS)


def _dot(u, v):
    return (u * v).sum(-1)


def _bond(p, q):
    r0, k = q.unbind(1)
    dr = _norm(p[0] - p[1]) - r0
    return 0.5 * k * dr * dr


def _angle(p, q):
    k, a0, a1, a2, a3, a4 = q.unbind(1)
    u, v = p[0] - p[1], p[2] - p[1]
    c = torch.clamp(_dot(u, v) / (_norm(u) * _norm(v)), -1.0, 1.0)
    return k * (a0 + c * (a1 + c * (a2 + c * (a3 + c * a4))))


def _torsion(p, q):
    b = q.unbind(1)
    b1, b2, b3 = p[1] - p[0], p[2] - p[1], p[3] - p[2]
    n1, n2 = torch.linalg.cross(b1, b2), torch.linalg.cross(b2, b3)
    c = torch.clamp(_dot(n1, n2) / (_norm(n1) * _norm(n2)), -1.0, 1.0)
    return b[0] + c * (b[1] + c * (b[2] + c * (b[3] + c * (b[4] + c * (b[5] + c * b[6])))))


def _inversion(p, q):
    rji, rjk, rjl = p[0] - p[1], p[2] - p[1], p[3] - p[1]
    n = torch.linalg.cross(rji, rjk)
    sin_y = torch.clamp(_dot(n, rjl) / (_norm(n) * _norm(rjl)), -1.0, 1.0)
    cos_w = torch.sqrt(torch.clamp(1.0 - sin_y * sin_y, _EPS, 1.0))
    return q[:, 0] * (1.0 - cos_w)


def _pairs(p, q):
    d = p[0] - p[1]
    r2 = torch.clamp_min((d * d).sum(-1), 1e-2)
    r6 = (q[:, 0] / r2) ** 3
    return q[:, 1] * (r6 * r6 - 2.0 * r6)


_TERMS = (_bond, _angle, _torsion, _inversion, _pairs)


def _kind_energies(k: int, p, par, split=False):
    return (_TERMS[k](p, par),)


def plain_energy_and_grad_fn(batch: UFFBatch, sys2mol: torch.Tensor, a_pad: int):
    """``fn(positions [S, a_pad, 3]) -> (energy [S], gradient [S, a_pad,
    3])`` of ``batch``'s molecules ``sys2mol``, the gradient by autograd,
    zero outside each system's atoms; the term index is built once."""
    return flat.plain_energy_and_grad_fn(batch, sys2mol, a_pad, _kind_energies)


def uff_energy_plain(positions: torch.Tensor, batch: UFFBatch,
                     sys2mol: torch.Tensor) -> torch.Tensor:
    """Per-system UFF energies [S] (kcal/mol) of ``positions`` [S, A, 3];
    system s is molecule ``sys2mol[s]`` of ``batch``."""
    flat.check_inputs(positions, batch, sys2mol, 3)
    return flat.plain_energy_fn(batch, sys2mol, positions.shape[1], _kind_energies)(positions)


def uff_energy_and_grad_plain(positions: torch.Tensor, batch: UFFBatch, sys2mol: torch.Tensor):
    """The plain version of :func:`uff_energy_and_grad`: (energy [S],
    gradient [S, A, 3]) by ``torch.autograd.grad``."""
    flat.check_inputs(positions, batch, sys2mol, 3)
    return plain_energy_and_grad_fn(batch, sys2mol, positions.shape[1])(positions)


def uff_term_magnitude_plain(positions: torch.Tensor, batch: UFFBatch,
                             sys2mol: torch.Tensor) -> torch.Tensor:
    """Per-system sum of |E_term| [S] (float64): the scale of float32
    rounding in the energy."""
    return flat.term_magnitude_plain(positions, batch, sys2mol, _kind_energies)


def uff_grad_magnitude_plain(positions: torch.Tensor, batch: UFFBatch,
                             sys2mol: torch.Tensor) -> torch.Tensor:
    """Per gradient component, the sum over terms of |dE_term/dx| [S, A, 3]
    (float64): the scale of float32 rounding in a gradient whose terms
    cancel."""
    return flat.grad_magnitude_plain(positions, batch, sys2mol, _kind_energies)


def uff_energy(positions: torch.Tensor, batch: UFFBatch, sys2mol: torch.Tensor) -> torch.Tensor:
    """Per-system UFF energies [S] (kcal/mol): K6 for CUDA tensors (its
    gradient is dropped), the plain version for CPU tensors."""
    if positions.is_cuda:
        return uff_energy_and_grad(positions, batch, sys2mol)[0]
    return uff_energy_plain(positions, batch, sys2mol)


# ---- a torch model of K6's order and arithmetic ---------------------------------

def _walk_pair(d, p):
    """csrc/uff.cu PairTerm on one step's lanes: the separations d [S, 32, 3]
    and the table's rows p [S, 32, 2]; (dE/dr / r [S, 32], E [S, 32]). A
    vdW row: the division a reciprocal and multiplies; a bond's row (-r0, k):
    the bond term; zero elsewhere."""
    r2raw = (d * d).sum(-1)
    inv = torch.reciprocal(torch.clamp_min(r2raw, 1e-2))
    t = p[..., 0] * inv
    r6 = t * t * t
    e = p[..., 1] * (r6 * r6 - 2.0 * r6)
    c = -12.0 * p[..., 1] * r6 * (r6 - 1.0) * inv
    r_b = torch.sqrt(r2raw + _EPS)
    dr = r_b + p[..., 0]
    bond = p[..., 0] < 0
    on = ~bond & ((p[..., 0] != 0) | (p[..., 1] != 0))
    c = torch.where(bond, p[..., 1] * dr / r_b, torch.where(on & (r2raw >= 1e-2), c, 0.0))
    return c, torch.where(bond, 0.5 * p[..., 1] * dr * dr, torch.where(on, e, 0.0))


def uff_energy_and_grad_model(positions: torch.Tensor, batch: UFFBatch, sys2mol: torch.Tensor):
    """(energy [S], gradient [S, A, 3]) of ``positions`` by K6's order and
    arithmetic (csrc/uff.cu uff_eval), on the CPU: the pair walk over
    ``pair_table`` (``mmff.energy.walk_pairs_model``, the vdW term with its
    reciprocal, and the bonds), then the other bonded kinds in turn, the
    energy by
    ``dist_geom.block_total_model``."""
    flat.check_inputs(positions, batch, sys2mol, 3)
    x = positions.detach()
    g = torch.zeros_like(x)
    e_thread = torch.zeros((x.shape[0], dist_geom.THREADS), dtype=x.dtype)
    walk_pairs_model(x, batch, sys2mol, _walk_pair, g, e_thread)
    bonded_terms_model(x, batch, sys2mol, _kind_energies, g, e_thread, packed=False)
    mask = flat.atom_mask(batch, sys2mol, x.shape[1])
    return dist_geom.block_total_model(e_thread), torch.where(mask[..., None], g, 0.0)


# ---- kernel K6 ------------------------------------------------------------------

def uff_energy_and_grad(positions: torch.Tensor, batch: UFFBatch, sys2mol: torch.Tensor,
                        phase_cycles: bool = False):
    """(energy [S], gradient [S, A, 3]) of ``positions`` [S, A, 3], system s
    being molecule ``sys2mol[s]`` (int32) of ``batch``; the gradient is zero
    outside each system's atoms. K6 for CUDA tensors, the plain version for
    CPU tensors. With ``phase_cycles`` (CUDA only), K6's instrumented
    instantiation, and also each warp's cycles per phase (int64 [S, 4,
    len(EVAL_PHASES)])."""
    if not positions.is_cuda:
        if phase_cycles:
            raise ValueError("phase_cycles needs CUDA tensors")
        return uff_energy_and_grad_plain(positions, batch, sys2mol)
    lib = uff_lib()
    flat.check_kernel_inputs(positions, batch, sys2mol, "K6", flat.kernel_dim(lib, "uff"))
    n_sys, a_pad = positions.shape[:2]
    dev = positions.device
    energy = torch.empty(n_sys, dtype=torch.float32, device=dev)
    grad = torch.empty_like(positions)
    count = flat.system_atoms(batch, sys2mol)
    args = (positions.data_ptr(), n_sys, a_pad, sys2mol.data_ptr(), count.data_ptr(),
            batch.offsets.data_ptr(), batch.n_mols, flat.table_pointers(batch),
            energy.data_ptr(), grad.data_ptr())
    cycles = (torch.zeros((n_sys, dist_geom.WARPS, len(EVAL_PHASES)), dtype=torch.int64,
                          device=dev) if phase_cycles else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = (lib.nvmk_uff_energy_grad_cycles(*args, cycles.data_ptr(), stream) if phase_cycles
              else lib.nvmk_uff_energy_grad(*args, stream))
    if rc != 0:
        raise RuntimeError(f"uff_energy_grad kernel launch failed with CUDA error {rc}")
    launch_counts["uff_energy_grad"] += 1
    return (energy, grad, cycles) if phase_cycles else (energy, grad)


UFF = flat.ForceField("uff", uff_energy_and_grad, plain_energy_and_grad_fn, uff_lib)
