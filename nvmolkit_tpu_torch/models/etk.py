"""The ETK (experimental-torsion and basic-knowledge) 3-D force field: its
host terms, the per-molecule tables kernel K13 reads, and the plain
PyTorch version.

The port's counterpart of ``nvmolkit_tpu/models/etk.py``:

* the host half is copied (:class:`ETKTermsHost`, :func:`build_etk_terms`
  with its per-``Mol`` cache keyed by the provider's identity and
  ``forceTransAmides``, :func:`hybridization_batch`,
  :func:`build_etk_terms_batch`, :func:`pad_etk_batch`); the one-hot
  selection tables (``attach_etk_selection``) work round the TPU and are
  not ported;
* :class:`EtkBatch` holds, per unique molecule of a chunk, the impropers
  ``(i, centre, k, l, k_imp)`` and the torsions ``(i, j, k, l, F[6],
  phi0[6])`` as flat tables with CSR offsets, as K4's and K11's are, and
  the molecules' smoothed bounds (those of the chunk's :class:`DGBatch`);
* :func:`etk_energy_and_grad` launches K13 (``csrc/etk.cu``) for CUDA
  tensors and runs :func:`etk_energy_and_grad_plain` (``etk_energy``'s
  terms in torch, the gradient by ``torch.autograd.grad``) for CPU
  tensors. K5, K23 and K8 minimize over K13's device function (:data:`ETK`, 3
  coordinates per atom).

A build or launch failure raises. ``launch_counts`` counts K13's launches
(K5's and K8's are counted by their modules).
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from nvmolkit_tpu_torch._build import etk_ff_lib
from nvmolkit_tpu_torch.chem.mol import Mol
from nvmolkit_tpu_torch.models import flat
from nvmolkit_tpu_torch.models.dist_geom import (
    DGBatch,
    distance_energy_plain,
    distance_grad_magnitude_plain,
)

N_HARMONICS = 6

launch_counts = {"etk_energy_grad": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


@dataclasses.dataclass
class ETKTermsHost:
    improper_idx: np.ndarray   # [I, 4] (i, center, k, l)
    improper_k: np.ndarray     # [I]
    torsion_idx: np.ndarray    # [T, 4]
    torsion_coeffs: np.ndarray  # [T, 6] F_k
    torsion_phase: np.ndarray   # [T, 6] phi0_k (radians)


def build_etk_terms(
    mol: Mol, torsion_provider=None, force_trans_amides: bool = False
) -> ETKTermsHost:
    """Improper (planarity) terms from the graph; experimental-torsion
    terms from ``torsion_provider(mol) -> (idx, coeffs, phase)`` if
    given; with ``force_trans_amides``, an omega-torsion pin per amide
    bond (RDKit's ``forceTransAmides`` — RDKit clamps the 1-4 bounds,
    here it is an ETK torsion with its minimum at omega=180: the JAX
    package's departure from RDKit, fault 7 in ROADMAP.md, which the port
    follows so that its terms equal the JAX package's).

    Results cache on the Mol keyed by (provider identity, flag) — the
    reference caches per-ROMol contribs the same way
    (``bfgs_mmff.cpp:199``); editing the Mol's graph afterwards requires
    a fresh Mol or deleting ``_etk_terms_cache``.
    """
    cache = getattr(mol, "_etk_terms_cache", None)
    if (
        cache is not None
        and cache[0] is torsion_provider
        and len(cache) == 3
        and cache[2] == force_trans_amides
    ):
        return cache[1]
    out = _build_etk_terms_uncached(mol, torsion_provider, force_trans_amides)
    mol._etk_terms_cache = (torsion_provider, out, force_trans_amides)
    return out


def _hyb_from_flat(n, arom, ba, bt) -> np.ndarray:
    """[n] int8: 3=sp3, 2=sp2 (incl aromatic), 1=sp — vectorized;
    semantics of ``uff.builder._hybridization`` (the per-atom oracle,
    differential-tested). Works on one molecule or a concatenation
    with offset bond ids."""
    n_double = np.bincount(ba[bt == 2].ravel(), minlength=max(n, 1))[:n]
    n_triple = np.bincount(ba[bt == 3].ravel(), minlength=max(n, 1))[:n]
    hyb = np.full(n, 3, np.int8)
    hyb[n_double > 0] = 2
    hyb[(n_triple > 0) | (n_double >= 2)] = 1
    hyb[arom] = 2
    return hyb


def _hybridization_array(mol: Mol) -> np.ndarray:
    cached = getattr(mol, "_hyb_cache", None)
    if cached is not None:
        return cached
    arrays = mol.to_arrays()
    hyb = _hyb_from_flat(
        mol.num_atoms,
        np.asarray(arrays["is_aromatic"]).astype(bool),
        np.asarray(arrays["bond_atoms"]).reshape(-1, 2),
        np.asarray(arrays["bond_type"]).reshape(-1),
    )
    mol._hyb_cache = hyb
    return hyb


def hybridization_batch(mols: list[Mol]) -> None:
    """Fill ``_hyb_cache`` for every molecule with ONE vectorized pass
    over the concatenated graph (per-molecule numpy overhead at ~12
    atoms costs more than the loops it replaces — same batching as
    ``chem.bounds._uff_geom_arrays_batch``)."""
    todo = [m for m in mols if getattr(m, "_hyb_cache", None) is None]
    if not todo:
        return
    arom_parts, ba_parts, bt_parts, na_list = [], [], [], []
    off = 0
    for m in todo:
        arrays = m.to_arrays()
        arom_parts.append(np.asarray(arrays["is_aromatic"]).astype(bool))
        ba_parts.append(np.asarray(arrays["bond_atoms"]).reshape(-1, 2) + off)
        bt_parts.append(np.asarray(arrays["bond_type"]).reshape(-1))
        na_list.append(m.num_atoms)
        off += m.num_atoms
    hyb = _hyb_from_flat(
        off,
        np.concatenate(arom_parts),
        np.concatenate(ba_parts) if ba_parts else np.zeros((0, 2), np.int64),
        np.concatenate(bt_parts) if bt_parts else np.zeros(0, np.int32),
    )
    a0 = 0
    for m, na in zip(todo, na_list):
        m._hyb_cache = hyb[a0 : a0 + na]
        a0 += na


def _build_etk_terms_uncached(
    mol: Mol, torsion_provider=None, force_trans_amides: bool = False
) -> ETKTermsHost:
    arrays = mol.to_arrays()
    hyb = _hybridization_array(mol)
    z = np.asarray(arrays["atomic_num"])
    degree = np.asarray(arrays["degree"])
    adj_atoms = np.asarray(arrays["adj_atoms"])          # [n, 8], -1 pads

    centers = np.nonzero(
        (degree == 3) & ((z == 6) | (z == 7)) & (hyb == 2)
    )[0]
    if len(centers):
        nb = adj_atoms[centers]
        imp_idx = np.stack(
            [nb[:, 0], centers, nb[:, 1], nb[:, 2]], axis=1
        ).astype(np.int32)
        imp_k = np.full(len(centers), 10.0, np.float32)
    else:
        imp_idx = np.zeros((0, 4), np.int32)
        imp_k = np.zeros(0, np.float32)

    # planarity torsions around aromatic and double bonds:
    # E = F2 (1 + cos(2 phi - pi)) = F2 (1 - cos 2 phi), minima at
    # phi = 0/180. Degree-2 aromatic CH carbons have no improper
    # center (the H is implicit), so bond-centered torsions carry the
    # "basic knowledge" planarity instead. SINGLE bonds between two
    # sp2 systems (biaryls, dienes, amides) are NOT pinned here — the
    # experimental-torsion library carries their real preferences
    # (biphenyl twists ~42 deg; pinning it planar was a round-2 bug).
    t_rows: list[tuple[int, int, int, int]] = []
    t_c: list[np.ndarray] = []
    t_p: list[np.ndarray] = []
    bt_arr = np.asarray(arrays["bond_type"]).reshape(-1)
    ba_arr = np.asarray(arrays["bond_atoms"]).reshape(-1, 2)
    pin = (bt_arr == 4) | (bt_arr >= 2)
    if pin.any():
        je, ke = ba_arr[:, 0], ba_arr[:, 1]
        pin &= (hyb[je] == 2) & (hyb[ke] == 2)
        pin &= (degree[je] >= 2) & (degree[ke] >= 2)
    _planar_c = np.zeros(6, np.float32)
    _planar_p = np.zeros(6, np.float32)
    _planar_c[1] = 5.0
    _planar_p[1] = np.pi
    for bi in np.nonzero(pin)[0]:
        j, k = int(ba_arr[bi, 0]), int(ba_arr[bi, 1])
        for i in adj_atoms[j]:
            if i < 0 or i == k:
                continue
            for l in adj_atoms[k]:
                if l < 0 or l == j or l == i:
                    continue
                t_rows.append((int(i), j, k, int(l)))
                t_c.append(_planar_c)
                t_p.append(_planar_p)

    if torsion_provider is not None:
        p_idx, p_coeffs, p_phase = torsion_provider(mol)
        for r in range(len(p_idx)):
            t_rows.append(tuple(int(x) for x in p_idx[r]))
            t_c.append(np.asarray(p_coeffs[r], np.float32))
            t_p.append(np.asarray(p_phase[r], np.float32))

    if force_trans_amides:
        # omega pin per amide bond C(=O)-N: quartet (Ca, C, N, Cb) with
        # E = F (1 + cos omega), minimum at omega = 180 (trans). Ca is
        # a heavy C-neighbor that is not the carbonyl O or the amide N;
        # Cb a heavy N-neighbor that is not C. Skips formamide-like
        # ends with no heavy flanking atoms.
        for b in mol.bonds:
            for c_at, n_at in ((b.begin, b.end), (b.end, b.begin)):
                if b.order != 1 or b.is_aromatic:
                    continue
                if mol.atoms[c_at].atomic_num != 6:
                    continue
                if mol.atoms[n_at].atomic_num != 7:
                    continue
                o_at = next(
                    (
                        nb for nb in mol.neighbors(c_at)
                        if mol.atoms[nb].atomic_num == 8
                        and (bo := mol.bond_between(c_at, nb)) is not None
                        and bo.order == 2
                    ),
                    None,
                )
                if o_at is None:
                    continue
                ca = next(
                    (
                        nb for nb in mol.neighbors(c_at)
                        if nb not in (o_at, n_at)
                        and mol.atoms[nb].atomic_num > 1
                    ),
                    None,
                )
                cb = next(
                    (
                        nb for nb in mol.neighbors(n_at)
                        if nb != c_at and mol.atoms[nb].atomic_num > 1
                    ),
                    None,
                )
                if ca is None or cb is None:
                    continue
                coeffs = np.zeros(6, np.float32)
                phase = np.zeros(6, np.float32)
                coeffs[0] = 10.0  # strong omega pin
                phase[0] = 0.0    # E = F (1 + cos w): min at w = pi
                t_rows.append((ca, c_at, n_at, cb))
                t_c.append(coeffs)
                t_p.append(phase)

    if t_rows:
        t_idx = np.asarray(t_rows, np.int32)
        t_coeffs = np.stack(t_c)
        t_phase = np.stack(t_p)
    else:
        t_idx = np.zeros((0, 4), np.int32)
        t_coeffs = np.zeros((0, 6), np.float32)
        t_phase = np.zeros((0, 6), np.float32)

    return ETKTermsHost(
        improper_idx=np.asarray(imp_idx, np.int32).reshape(-1, 4),
        improper_k=np.asarray(imp_k, np.float32),
        torsion_idx=np.asarray(t_idx, np.int32).reshape(-1, 4),
        torsion_coeffs=np.asarray(t_coeffs, np.float32).reshape(-1, 6),
        torsion_phase=np.asarray(t_phase, np.float32).reshape(-1, 6),
    )


def build_etk_terms_batch(
    mols: list[Mol], torsion_provider=None, force_trans_amides: bool = False
) -> list[ETKTermsHost]:
    """Whole-batch ETK term assembly: ONE vectorized pass over the
    concatenated graph for impropers and planarity torsions, then
    per-molecule slicing. Emission order per molecule is identical to
    :func:`build_etk_terms` (bond-ascending, adjacency-slot-ordered
    combos, provider claims after the planarity rows — the per-mol
    builder stays as the differential oracle). Results cache per Mol
    exactly like the per-mol path."""
    need = [
        m for m in mols
        if not (
            (c := getattr(m, "_etk_terms_cache", None)) is not None
            and c[0] is torsion_provider
            and len(c) == 3
            and c[2] == force_trans_amides
        )
    ]
    if need:
        hybridization_batch(need)
        z_p, deg_p, adj_p, ba_p, bt_p, hyb_p = [], [], [], [], [], []
        na_list = []
        off = 0
        for m in need:
            arrays = m.to_arrays()
            na = m.num_atoms
            z_p.append(np.asarray(arrays["atomic_num"], np.int32))
            deg_p.append(np.asarray(arrays["degree"], np.int32))
            adj = np.asarray(arrays["adj_atoms"], np.int64).copy()
            adj[adj >= 0] += off
            adj_p.append(adj)
            ba_p.append(np.asarray(arrays["bond_atoms"], np.int64) + off)
            bt_p.append(np.asarray(arrays["bond_type"]).reshape(-1))
            hyb_p.append(m._hyb_cache)
            na_list.append(na)
            off += na
        z = np.concatenate(z_p)
        degree = np.concatenate(deg_p)
        adjcat = np.concatenate(adj_p, axis=0)
        ba = (
            np.concatenate(ba_p, axis=0).reshape(-1, 2)
            if ba_p else np.zeros((0, 2), np.int64)
        )
        bt = np.concatenate(bt_p) if bt_p else np.zeros(0, np.int32)
        hyb = np.concatenate(hyb_p)
        atom_off = np.zeros(len(need) + 1, np.int64)
        np.cumsum(na_list, out=atom_off[1:])

        # impropers (centers ascend with the concatenation => grouped
        # per molecule)
        centers = np.nonzero(
            (degree == 3) & ((z == 6) | (z == 7)) & (hyb == 2)
        )[0]
        nbc = adjcat[centers]
        imp_all = np.stack(
            [nbc[:, 0], centers, nbc[:, 1], nbc[:, 2]], axis=1
        ).astype(np.int64) if len(centers) else np.zeros((0, 4), np.int64)
        imp_split = np.searchsorted(centers, atom_off)

        # planarity torsions: all (i, j, k, l) combos of pinned bonds,
        # emitted in (bond, i-slot, l-slot) order == the oracle's
        pin = (bt >= 2) & (hyb[ba[:, 0]] == 2) & (hyb[ba[:, 1]] == 2)
        pin &= (degree[ba[:, 0]] >= 2) & (degree[ba[:, 1]] >= 2)
        pb = np.nonzero(pin)[0]
        if len(pb):
            je, ke = ba[pb, 0], ba[pb, 1]           # [B]
            ic = adjcat[je]                          # [B, 8]
            lc = adjcat[ke]
            okm = (
                (ic[:, :, None] >= 0)
                & (lc[:, None, :] >= 0)
                & (ic[:, :, None] != ke[:, None, None])
                & (lc[:, None, :] != je[:, None, None])
                & (ic[:, :, None] != lc[:, None, :])
            )                                        # [B, 8, 8]
            wb, wi, wl = np.nonzero(okm)
            tor_all = np.stack(
                [ic[wb, wi], je[wb], ke[wb], lc[wb, wl]], axis=1
            )                                        # [T, 4] global ids
            tor_mol = np.searchsorted(atom_off, je[wb], side="right") - 1
            tor_split = np.searchsorted(tor_mol, np.arange(len(need) + 1))
        else:
            tor_all = np.zeros((0, 4), np.int64)
            tor_split = np.zeros(len(need) + 1, np.int64)

        planar_c = np.zeros(6, np.float32)
        planar_p = np.zeros(6, np.float32)
        planar_c[1] = 5.0
        planar_p[1] = np.pi

        for k, m in enumerate(need):
            a0 = atom_off[k]
            imp = (imp_all[imp_split[k] : imp_split[k + 1]] - a0).astype(np.int32)
            tor = (tor_all[tor_split[k] : tor_split[k + 1]] - a0).astype(np.int32)
            n_t = len(tor)
            t_idx = [tor]
            t_c = [np.broadcast_to(planar_c, (n_t, 6))]
            t_p = [np.broadcast_to(planar_p, (n_t, 6))]
            if torsion_provider is not None:
                p_idx, p_coeffs, p_phase = torsion_provider(m)
                if len(p_idx):
                    t_idx.append(np.asarray(p_idx, np.int32).reshape(-1, 4))
                    t_c.append(np.asarray(p_coeffs, np.float32).reshape(-1, 6))
                    t_p.append(np.asarray(p_phase, np.float32).reshape(-1, 6))
            if force_trans_amides:
                # rare path: reuse the oracle for the amide scan
                oracle = _build_etk_terms_uncached(
                    m, torsion_provider, force_trans_amides
                )
                m._etk_terms_cache = (torsion_provider, oracle, True)
                continue
            terms = ETKTermsHost(
                improper_idx=imp.reshape(-1, 4),
                improper_k=np.full(len(imp), 10.0, np.float32),
                torsion_idx=np.concatenate(t_idx, axis=0),
                torsion_coeffs=np.concatenate(t_c, axis=0),
                torsion_phase=np.concatenate(t_p, axis=0),
            )
            m._etk_terms_cache = (torsion_provider, terms, False)
    return [build_etk_terms(m, torsion_provider, force_trans_amides) for m in mols]


def pad_etk_batch(terms: list[ETKTermsHost]) -> dict[str, np.ndarray]:
    """Pad per-system ETK terms into [S, Imax, ...] arrays with masks."""
    S = len(terms)
    Imax = max(1, max(t.improper_idx.shape[0] for t in terms))
    Tmax = max(1, max(t.torsion_idx.shape[0] for t in terms))
    out = {
        "improper_idx": np.zeros((S, Imax, 4), np.int32),
        "improper_k": np.zeros((S, Imax), np.float32),
        "improper_mask": np.zeros((S, Imax), bool),
        "torsion_idx": np.zeros((S, Tmax, 4), np.int32),
        # coeffs/phases [S, 6, T]: k harmonics on SUBLANES, terms on
        # LANES (a trailing 6-axis pads every TPU tile to 128 lanes)
        "torsion_coeffs": np.zeros((S, 6, Tmax), np.float32),
        "torsion_phase": np.zeros((S, 6, Tmax), np.float32),
        "torsion_mask": np.zeros((S, Tmax), bool),
    }
    for s, t in enumerate(terms):
        ni = t.improper_idx.shape[0]
        nt = t.torsion_idx.shape[0]
        if ni:
            out["improper_idx"][s, :ni] = t.improper_idx
            out["improper_k"][s, :ni] = t.improper_k
            out["improper_mask"][s, :ni] = True
        if nt:
            out["torsion_idx"][s, :nt] = t.torsion_idx
            out["torsion_coeffs"][s, :, :nt] = t.torsion_coeffs.T
            out["torsion_phase"][s, :, :nt] = t.torsion_phase.T
            out["torsion_mask"][s, :nt] = True
    return out


# ---------------------------------------------------------------------------
# the device layout and the energy
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EtkBatch:
    """The ETK terms of M unique molecules of one atom bucket A.

    ``offsets`` int32 [2, M + 1] indexes the impropers (``atoms[0]`` int32
    [I, 4] as (i, centre, k, l), ``params[0]`` float32 [I, 1] their k) and
    the torsions (``atoms[1]`` int32 [T, 4], ``params[1]`` float32 [T, 12]:
    F_1..F_6, then phi0_1..phi0_6 in radians); ``params[2]`` and
    ``params[3]`` are the molecules' smoothed upper and lower bounds float32
    [M, A, A] (the chunk's :class:`DGBatch`'s own tensors), under the
    distance term of weight ``bounds_weight``."""

    n_atoms: torch.Tensor
    offsets: torch.Tensor
    atoms: tuple
    params: tuple
    max_atoms: int
    bounds_weight: float = 1.0

    @property
    def n_mols(self) -> int:
        return self.n_atoms.shape[0]

    @property
    def upper(self) -> torch.Tensor:
        return self.params[2]

    @property
    def lower(self) -> torch.Tensor:
        return self.params[3]


def make_etk_batch(dg: DGBatch, terms: list[ETKTermsHost],
                   bounds_weight: float = 1.0) -> EtkBatch:
    """An :class:`EtkBatch` on the DG batch's device from each molecule's
    :class:`ETKTermsHost` (in the DG batch's molecule order), sharing the
    DG batch's smoothed bounds."""
    dev = dg.upper.device
    off = np.zeros((2, len(terms) + 1), np.int32)
    off[0, 1:] = np.cumsum([len(t.improper_idx) for t in terms])
    off[1, 1:] = np.cumsum([len(t.torsion_idx) for t in terms])
    imp = np.concatenate([t.improper_idx for t in terms]).reshape(-1, 4).astype(np.int32)
    k_imp = np.concatenate([t.improper_k for t in terms]).reshape(-1, 1).astype(np.float32)
    tor = np.concatenate([t.torsion_idx for t in terms]).reshape(-1, 4).astype(np.int32)
    tor_par = np.concatenate(
        [np.concatenate([t.torsion_coeffs, t.torsion_phase], axis=1) for t in terms]
    ).reshape(-1, 2 * N_HARMONICS).astype(np.float32)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return EtkBatch(n_atoms=dg.n_atoms, offsets=put(off), atoms=(put(imp), put(tor)),
                    params=(put(k_imp), put(tor_par), dg.upper, dg.lower),
                    max_atoms=dg.max_atoms, bounds_weight=float(bounds_weight))


def _norm1(d: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((d * d).sum(dim=-1) + 1e-10)


class _Atan2(torch.autograd.Function):
    """atan2(y, x) with the derivative JAX gives it, (x dy - y dx) / (x^2 +
    y^2): NaN at (0, 0), an exactly collinear b1, b2 or b2, b3, where the JAX
    function's gradient and K13's are NaN (torch's own atan2 gives 0
    there)."""

    @staticmethod
    def forward(ctx, y, x):
        ctx.save_for_backward(y, x)
        return torch.atan2(y, x)

    @staticmethod
    def backward(ctx, grad):
        y, x = ctx.saved_tensors
        r2 = x * x + y * y
        return grad * x / r2, -grad * y / r2


def improper_energies(p: list, par: torch.Tensor) -> torch.Tensor:
    """k (1 - cos w) of the impropers at the positions ``p`` of their four
    atoms (i, centre, k, l), ``par`` [I, 1] their k, as ``etk_energy``."""
    rji, rjk, rjl = p[0] - p[1], p[2] - p[1], p[3] - p[1]
    n = torch.linalg.cross(rji, rjk)
    sin_w = torch.clamp((n * rjl).sum(dim=-1) / (_norm1(n) * _norm1(rjl)), -1.0, 1.0)
    cos_w = torch.sqrt(torch.clamp(1.0 - sin_w * sin_w, 1e-10, 1.0))
    return par[:, 0].to(cos_w.dtype) * (1.0 - cos_w)


def torsion_energies(p: list, par: torch.Tensor, split: bool = False):
    """sum_k F_k (1 + cos(k phi - phi0_k)) of the torsions at the positions
    ``p`` of their four atoms, ``par`` [T, 12] their F and phi0, as
    ``etk_energy``; with ``split``, the six harmonics apart."""
    b1, b2, b3 = p[1] - p[0], p[2] - p[1], p[3] - p[2]
    n1 = torch.linalg.cross(b1, b2)
    n2 = torch.linalg.cross(b2, b3)
    m1 = torch.linalg.cross(n1, b2 / _norm1(b2)[:, None])
    phi = _Atan2.apply((m1 * n2).sum(dim=-1), (n1 * n2).sum(dim=-1))
    par = par.to(phi.dtype)
    terms = [par[:, k - 1] * (1.0 + torch.cos(k * phi - par[:, N_HARMONICS + k - 1]))
             for k in range(1, N_HARMONICS + 1)]
    if split:
        return tuple(terms)
    tor = terms[0]
    for term in terms[1:]:
        tor = tor + term
    return tor


def kind_energies(k: int, p: list, par: torch.Tensor, split: bool = False) -> tuple:
    """The term energies of kind ``k`` (0 impropers, 1 torsions), for
    ``flat``'s plain helpers."""
    if k == 0:
        return (improper_energies(p, par),)
    return torsion_energies(p, par, split) if split else (torsion_energies(p, par),)


def etk_energy_plain(positions: torch.Tensor, batch: EtkBatch, sys2mol: torch.Tensor,
                     terms=None) -> torch.Tensor:
    """Per-system energy [S] of ``positions`` [S, A, 3], as the JAX
    ``etk_energy`` computes it: the weighted distance term, then the
    impropers, then the torsions."""
    S, A, _ = positions.shape
    e = batch.bounds_weight * distance_energy_plain(positions, batch, sys2mol)
    expanded = terms if terms is not None else flat.expand(batch, sys2mol, A)
    p_flat = positions.reshape(-1, 3)
    for k, (sys_of, atoms, par) in enumerate(expanded):
        (part,) = kind_energies(k, [p_flat[atoms[:, q]] for q in range(4)], par)
        e = e + torch.zeros_like(e).index_add_(0, sys_of, part)
    return e


def plain_energy_and_grad_fn(batch: EtkBatch, sys2mol: torch.Tensor, a_pad: int):
    """``fn(positions) -> (energy [S], gradient [S, a_pad, 3])``, the
    gradient by autograd of :func:`etk_energy_plain`, zero outside each
    system's atoms (the term index is built once)."""
    expanded = flat.expand(batch, sys2mol, a_pad)
    mask = flat.atom_mask(batch, sys2mol.to(batch.n_atoms.device), a_pad)[..., None]

    def energy_and_grad(positions: torch.Tensor):
        with torch.enable_grad():
            x = positions.detach().requires_grad_(True)
            e = etk_energy_plain(x, batch, sys2mol, expanded)
            (g,) = torch.autograd.grad(e.sum(), x)
        return e.detach(), torch.where(mask.to(g.device), g, 0.0)

    return energy_and_grad


def etk_energy_and_grad_plain(positions: torch.Tensor, batch: EtkBatch, sys2mol: torch.Tensor):
    return plain_energy_and_grad_fn(batch, sys2mol, positions.shape[1])(positions)


def _float64(batch: EtkBatch) -> EtkBatch:
    return dataclasses.replace(batch, params=tuple(t.double() for t in batch.params))


def etk_term_magnitude_plain(positions: torch.Tensor, batch: EtkBatch,
                             sys2mol: torch.Tensor) -> torch.Tensor:
    """Per-system sum of |E_term| [S] (float64; a torsion's harmonics
    apart): the scale of float32 rounding in the energy."""
    x = positions.detach().double()
    out = batch.bounds_weight * distance_energy_plain(x, _float64(batch), sys2mol)
    return out + flat.term_magnitude_plain(x, batch, sys2mol, kind_energies)


def etk_grad_magnitude_plain(positions: torch.Tensor, batch: EtkBatch,
                             sys2mol: torch.Tensor) -> torch.Tensor:
    """Per gradient component, the sum over terms of |dE_term/dx| [S, A, 3]
    (float64): the scale of float32 rounding in a gradient whose terms
    cancel."""
    x = positions.detach().double()
    out = batch.bounds_weight * distance_grad_magnitude_plain(x, _float64(batch), sys2mol)
    out = out + flat.grad_magnitude_plain(x, batch, sys2mol, kind_energies)
    mask = flat.atom_mask(batch, sys2mol.to(batch.n_atoms.device), x.shape[1]).to(x.device)
    return torch.where(mask[..., None], out, 0.0)


def etk_energy_and_grad(positions: torch.Tensor, batch: EtkBatch, sys2mol: torch.Tensor):
    """(energy [S], gradient [S, A, 3]) of ``positions`` [S, A, 3], system s
    being molecule ``sys2mol[s]`` (int32) of ``batch``; the gradient is zero
    outside each system's atoms. K13 for CUDA tensors, the plain version for
    CPU tensors."""
    if not positions.is_cuda:
        return etk_energy_and_grad_plain(positions, batch, sys2mol)
    flat.check_kernel_inputs(positions, batch, sys2mol, "K13", flat.kernel_dim(etk_ff_lib(), "etk"))
    n_sys, a_pad = positions.shape[:2]
    if a_pad != batch.max_atoms:
        raise ValueError(f"K13 takes positions of the batch's {batch.max_atoms} atoms, got {a_pad}")
    dev = positions.device
    energy = torch.empty(n_sys, dtype=torch.float32, device=dev)
    grad = torch.empty_like(positions)
    count = flat.system_atoms(batch, sys2mol)
    with torch.cuda.device(dev):
        rc = etk_ff_lib().nvmk_etk_energy_grad(
            positions.data_ptr(), n_sys, a_pad, sys2mol.data_ptr(), count.data_ptr(),
            batch.offsets.data_ptr(), batch.n_mols, flat.table_pointers(batch),
            batch.bounds_weight, energy.data_ptr(), grad.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"etk_energy_grad kernel launch failed with CUDA error {rc}")
    launch_counts["etk_energy_grad"] += 1
    return energy, grad


ETK = flat.ForceField("etk", etk_energy_and_grad, plain_energy_and_grad_fn, etk_ff_lib,
                      lambda batch: (ctypes.c_float(batch.bounds_weight),))
