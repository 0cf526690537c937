"""MMFF94 batched energy and gradient: kernel K4 and its plain PyTorch version.

The functional forms, constants and guards are those of
``nvmolkit_tpu/models/mmff/energy.py`` (Halgren, J. Comput. Chem. 17 (1996)
490-519); the layout is the port's own:

* :class:`MMFFBatch` holds flat per-molecule tables with CSR offsets, as
  nvMolKit does (``src/forcefields/mmff.h:318-341``): for each of six kinds
  (bonds, angles, stretch-bends, out-of-plane, torsions, nonbonded pairs) an
  int32 [T, arity] atom column, float32 [T, P] parameter rows, and a row of
  the int32 [6, U + 1] offsets. A molecule's tables cross the host -> device
  link once, however many conformers it has: the systems (molecule,
  conformer) only carry ``sys2mol`` int32 [S].
* The nonbonded pair list holds, per molecule, the nonzero entries of the
  JAX package's dense pair square (``batch_mmff_terms``): ``(i, j, R*, eps,
  qq * (0.75 if 1-4 else 1))``; the square's zero entries add exactly 0.
  K4 reads the pairs from ``pair_table`` instead: each molecule's triangle
  of pairs i < j laid out by diagonals, (R*, eps, qq scale, 0) where the
  list has the pair, (r0, 0, 0, kb) where a bond joins it, zero elsewhere
  (``flat.diagonal_pairs``, made when the batch is), the order its pair
  walk reads them in: K4 takes the bonds in the walk. It takes each
  stretch-bend with the angle on the same atoms (``angle_sb``: the
  stretch-bend's row for each angle, zeros where none; the rest listed in
  ``sb_rest``).
* A disabled term (``MMFFProperties.bondTerm`` ... ``eleTerm``) is dropped
  from the batch; ``dielConstant`` and ``dielModel`` are scalars.

:func:`mmff_energy_and_grad` launches K4 (``csrc/mmff.cu``) for CUDA
tensors and runs :func:`mmff_energy_and_grad_plain` (the energy in torch,
the gradient by ``torch.autograd.grad``) for CPU tensors; a build or launch
failure raises. ``launch_counts`` counts K4's launches.
:func:`mmff_energy_and_grad_model` computes K4's order and arithmetic on the
CPU (its pair walk over ``pair_table``, the reciprocals), the yardstick of
the layout the CPU tests hold to the JAX package.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from nvmolkit_tpu_torch._build import mmff_lib
from nvmolkit_tpu_torch.chem.mol import Mol
from nvmolkit_tpu_torch.models import dist_geom, flat
from nvmolkit_tpu_torch.models.mmff.terms import MMFFProperties, MMFFTerms
from nvmolkit_tpu_torch.models.terms import BoundedBatchCache

_EPS = 1e-10
_DEG = 180.0 / np.pi
_CS = -2.0
_CB = -0.006981317
# arccos/arcsin clip bound, strictly inside [-1, 1] (see the JAX module)
_CLIP = 1.0 - 1.0 / (1 << 20)

KINDS = ("bonds", "angles", "stretch_bends", "oop", "torsions", "pairs")
ARITY = (2, 3, 3, 4, 4, 2)
# parameter columns of each kind, in the order csrc/mmff.cu reads them
PARAMS = (
    ("kb", "r0"),
    ("ka", "theta0", "is_linear"),
    ("kba_ijk", "kba_kji", "r0_ij", "r0_kj", "theta0"),
    ("koop",),
    ("v1", "v2", "v3"),
    ("rstar", "eps", "qq_scale"),
)
_BONDED = KINDS[:5]

# the phases of K4's per-warp clock (``phase_cycles=True``; csrc/dg_pairs.cuh
# EvalPhase): "terms_a" the bonds, angles and stretch-bends, "terms_b" the
# out-of-plane terms and torsions, "wait" the zeroing's barrier; "pairs_b"
# is not used
EVAL_PHASES = dist_geom.EVAL_PHASES
PAIR_WIDTH = 4  # the pair table's columns: R*, eps, qq scale, 0; a bond's r0, 0, 0, kb

launch_counts = {"mmff_energy_grad": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


@dataclasses.dataclass
class MMFFBatch:
    """Flat MMFF tables of U unique molecules (see the module doc)."""

    max_atoms: int
    diel_constant: float
    diel_model: int
    n_atoms: torch.Tensor            # int32 [U]
    offsets: torch.Tensor            # int32 [6, U + 1]
    atoms: tuple[torch.Tensor, ...]  # per kind int32 [T, arity]
    params: tuple[torch.Tensor, ...]  # per kind float32 [T, P]
    # K4's pair walk: each molecule's first entry, int32 [U + 1], and the
    # pairs by diagonals [sum n (n - 1) / 2, 4] (made from the pair list and
    # the bonds if None)
    pair_offsets: torch.Tensor | None = None
    pair_table: torch.Tensor | None = None
    # each angle's stretch-bend row [A, 5] (zeros where it has none), and the
    # stretch-bends on no angle: offsets int32 [U + 1], their rows int32 [R]
    angle_sb: torch.Tensor | None = None
    sb_rest_offsets: torch.Tensor | None = None
    sb_rest: torch.Tensor | None = None

    def __post_init__(self):
        if self.pair_table is None:
            self.pair_offsets, self.pair_table = flat.diagonal_pairs(self.n_atoms, (
                (self.offsets[5], self.atoms[5], self.params[5], (0, 1, 2), True),
                (self.offsets[0], self.atoms[0], self.params[0][:, [1, 0]], (0, 3), False)),
                PAIR_WIDTH)
        if self.angle_sb is None:
            self.angle_sb, self.sb_rest_offsets, self.sb_rest = angle_stretch_bends(self)

    @property
    def derived_tables(self) -> tuple[torch.Tensor, ...]:
        """What K4 reads beside the lists (``flat.kernel_tables``)."""
        return (self.pair_offsets, self.pair_table, self.angle_sb, self.sb_rest_offsets,
                self.sb_rest)

    @property
    def n_mols(self) -> int:
        return int(self.n_atoms.shape[0])

    @property
    def device(self) -> torch.device:
        return self.n_atoms.device

    def to(self, device) -> "MMFFBatch":
        def put(t):
            return t.to(device, non_blocking=True)

        return dataclasses.replace(
            self, n_atoms=put(self.n_atoms), offsets=put(self.offsets),
            atoms=tuple(put(a) for a in self.atoms), params=tuple(put(p) for p in self.params),
            pair_offsets=put(self.pair_offsets), pair_table=put(self.pair_table),
            angle_sb=put(self.angle_sb), sb_rest_offsets=put(self.sb_rest_offsets),
            sb_rest=put(self.sb_rest))


def stretch_bend_angles(batch: MMFFBatch) -> torch.Tensor:
    """For each stretch-bend row of ``batch``, the row of the angle on the
    same atoms i, j, k in the same molecule (the first such), or -1."""
    U, A = batch.n_mols, max(batch.max_atoms, 1)
    dev = batch.offsets.device

    def keys(k):
        off = batch.offsets[k].to(torch.int64)
        mol = torch.repeat_interleave(torch.arange(U, device=dev), off[1:] - off[:-1])
        a = batch.atoms[k].to(torch.int64)
        return ((mol * A + a[:, 0]) * A + a[:, 1]) * A + a[:, 2]

    angle_keys, sb_keys = keys(1), keys(2)
    order = torch.argsort(angle_keys, stable=True)
    if order.numel() == 0:
        return torch.full_like(sb_keys, -1)
    at = torch.searchsorted(angle_keys[order], sb_keys).clamp_max(order.numel() - 1)
    return torch.where(angle_keys[order][at] == sb_keys, order[at], -1)


def angle_stretch_bends(batch: MMFFBatch):
    """K4's stretch-bends by angle: (float [A, 5] each angle's stretch-bend
    row, zeros where it has none; int32 [U + 1] offsets and int32 rows of the
    stretch-bends on no angle, or a second on one)."""
    angle = stretch_bend_angles(batch)
    first = torch.zeros_like(angle, dtype=torch.bool)
    hit = torch.nonzero(angle >= 0).squeeze(1)
    if hit.numel():
        _, inverse = torch.unique(angle[hit], return_inverse=True)
        seen = torch.full((int(inverse.max()) + 1,), hit.numel(), dtype=torch.int64,
                          device=hit.device).scatter_reduce(0, inverse, torch.arange(
                              hit.numel(), device=hit.device), "amin")
        first[hit[seen]] = True
    params = batch.params[2]
    table = torch.zeros((batch.atoms[1].shape[0], params.shape[1]), dtype=params.dtype,
                        device=params.device)
    table[angle[first]] = params[first]
    rest = torch.nonzero(~first).squeeze(1)
    off = batch.offsets[2].to(torch.int64)
    mol = torch.repeat_interleave(torch.arange(batch.n_mols, device=off.device),
                                  off[1:] - off[:-1])
    rest_off = torch.zeros(batch.n_mols + 1, dtype=torch.int64, device=off.device)
    torch.cumsum(torch.bincount(mol[rest], minlength=batch.n_mols), 0, out=rest_off[1:])
    return table, rest_off.to(torch.int32), rest.to(torch.int32)


def _pair_table(t: MMFFTerms, props: MMFFProperties):
    """One molecule's nonbonded pair list: the nonzero entries of the JAX
    package's dense (R*, eps, qq scale) square, in row-major order."""
    n = t.n_atoms
    rstar = np.zeros((n, n), np.float32)
    eps = np.zeros((n, n), np.float32)
    qq = np.zeros((n, n), np.float32)
    if props.vdWTerm and t.vdw.n_terms:
        i, j = t.vdw.atoms[:, 0], t.vdw.atoms[:, 1]
        rstar[i, j] = t.vdw.params["rstar"]
        eps[i, j] = t.vdw.params["eps"]
    if props.eleTerm and t.ele.n_terms:
        i, j = t.ele.atoms[:, 0], t.ele.atoms[:, 1]
        scale = np.where(t.ele.params["is_1_4"] > 0.5, 0.75, 1.0)
        qq[i, j] = t.ele.params["qq"] * scale
    i, j = np.nonzero((eps != 0) | (qq != 0))
    return np.stack([i, j], 1).astype(np.int32), np.stack([rstar[i, j], eps[i, j], qq[i, j]], 1)


def batch_mmff_terms(
    terms: list[MMFFTerms],
    n_atoms: list[int],
    max_atoms: int,
    properties: MMFFProperties | None = None,
    device=None,
) -> MMFFBatch:
    """Pack the tables of unique molecules ``terms`` (``n_atoms`` atoms each,
    at most ``max_atoms``) into one :class:`MMFFBatch` on ``device``
    (default CPU)."""
    props = properties or MMFFProperties()
    for s, na in enumerate(n_atoms):
        if na > max_atoms:
            raise ValueError(f"system {s}: {na} atoms > bucket {max_atoms}")
    enabled = (props.bondTerm, props.angleTerm, props.stretchBendTerm, props.oopTerm,
               props.torsionTerm)
    atoms, params = [], []
    counts = np.zeros((len(KINDS), len(terms)), np.int64)
    for k, kind in enumerate(_BONDED):
        tables = [getattr(t, kind) for t in terms] if enabled[k] else []
        atoms.append(np.concatenate([t.atoms for t in tables]) if tables
                     else np.zeros((0, ARITY[k]), np.int32))
        params.append(np.stack([np.concatenate([t.params[p] for t in tables]) for p in PARAMS[k]], 1)
                      if tables else np.zeros((0, len(PARAMS[k])), np.float32))
        counts[k] = [t.n_terms for t in tables] if tables else 0
    pairs = [_pair_table(t, props) for t in terms]
    atoms.append(np.concatenate([a for a, _ in pairs]) if pairs else np.zeros((0, 2), np.int32))
    params.append(np.concatenate([p for _, p in pairs]) if pairs else np.zeros((0, 3), np.float32))
    counts[5] = [len(a) for a, _ in pairs]
    offsets = np.zeros((len(KINDS), len(terms) + 1), np.int64)
    np.cumsum(counts, axis=1, out=offsets[:, 1:])
    if offsets[:, -1].max(initial=0) >= 2**31:
        raise ValueError("more than 2^31 terms of one kind in a batch")

    def tensor(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype))

    batch = MMFFBatch(
        max_atoms=max_atoms, diel_constant=float(props.dielConstant),
        diel_model=int(props.dielModel),
        n_atoms=tensor(np.asarray(n_atoms), np.int32), offsets=tensor(offsets, np.int32),
        atoms=tuple(tensor(a, np.int32) for a in atoms),
        params=tuple(tensor(p, np.float32) for p in params))
    return batch if device is None else batch.to(device)


# Batch-level cache: repeated optimize calls over the SAME molecule list
# skip the packing and the host -> device copy of the tables.
_BATCH_CACHE = BoundedBatchCache()


def make_batched_mmff(
    mols: list[Mol],
    max_atoms: int,
    properties: MMFFProperties | None = None,
    provider=None,
    *,
    device,
) -> MMFFBatch:
    """Build and batch MMFF terms for a bucket of unique molecules, on
    ``device``, which the caller resolves (the entry points by
    ``types.resolve_device``).

    Per-molecule parametrization is cached on the Mol object (the
    reference caches contribs per ROMol*, ``bfgs_mmff.cpp:199``), keyed by
    provider + the MMFFProperties knobs that affect term building; the
    batched tables additionally cache per molecule LIST and device, with the
    JAX package's keys. Editing a Mol's graph after the first use requires a
    fresh Mol (or deleting ``_mmff_terms_cache``).
    """
    from nvmolkit_tpu_torch.models.mmff.providers import default_provider

    provider = provider or default_provider()
    props = properties or MMFFProperties()
    key = (
        getattr(provider, "cache_key", type(provider).__name__),
        props.mmffVariant,
        props.nonBondedThreshold,
        props.ignoreInterfragInteractions,
    )
    batch_key = (
        tuple(id(m) for m in mols), max_atoms, key,
        tuple(sorted(vars(props).items())), str(torch.device(device)),
    )
    hit = _BATCH_CACHE.get(batch_key)
    if hit is not None:
        return hit
    terms = []
    for m in mols:
        cache = getattr(m, "_mmff_terms_cache", None)
        if cache is None or cache[0] != key:
            cache = (key, provider.build_terms(m, props))
            m._mmff_terms_cache = cache
        terms.append(cache[1])
    batch = batch_mmff_terms(terms, [m.num_atoms for m in mols], max_atoms, props, device)
    _BATCH_CACHE.put(batch_key, mols, batch)
    return batch


# ---- the plain version --------------------------------------------------------

def _norm(d):
    return torch.sqrt((d * d).sum(-1) + _EPS)


def _dot(u, v):
    return (u * v).sum(-1)


def _angle_cos(p):
    u = p[0] - p[1]
    v = p[2] - p[1]
    nu, nv = _norm(u), _norm(v)
    return nu, nv, torch.clamp(_dot(u, v) / (nu * nv), -_CLIP, _CLIP)


def _bond(p, q):
    kb, r0 = q.unbind(1)
    dr = _norm(p[0] - p[1]) - r0
    return 0.5 * 143.9325 * kb * dr * dr * (1.0 + _CS * dr + (7.0 / 12.0) * _CS * _CS * dr * dr)


def _angle(p, q):
    ka, theta0, is_linear = q.unbind(1)
    _, _, cos = _angle_cos(p)
    dt = torch.arccos(cos) * _DEG - theta0
    bent = 0.5 * 0.043844 * ka * dt * dt * (1.0 + _CB * dt)
    linear = 143.9325 * ka * (1.0 + cos)
    return torch.where(is_linear > 0.5, linear, bent)


def _stretch_bend(p, q):
    kba_ijk, kba_kji, r0_ij, r0_kj, theta0 = q.unbind(1)
    rij, rkj, cos = _angle_cos(p)
    dt = torch.arccos(cos) * _DEG - theta0
    return 2.51210 * (kba_ijk * (rij - r0_ij) + kba_kji * (rkj - r0_kj)) * dt


def _oop(p, q):
    rji, rjk, rjl = p[0] - p[1], p[2] - p[1], p[3] - p[1]
    n = torch.linalg.cross(rji, rjk)
    sin_chi = torch.clamp(_dot(n, rjl) / (_norm(n) * _norm(rjl)), -_CLIP, _CLIP)
    chi = torch.arcsin(sin_chi) * _DEG
    return 0.5 * 0.043844 * q[:, 0] * chi * chi


def _torsion(p, q):
    v1, v2, v3 = q.unbind(1)
    b1, b2, b3 = p[1] - p[0], p[2] - p[1], p[3] - p[2]
    n1 = torch.linalg.cross(b1, b2)
    n2 = torch.linalg.cross(b2, b3)
    c = torch.clamp(_dot(n1, n2) / (_norm(n1) * _norm(n2)), -1.0, 1.0)
    cos2 = 2.0 * c * c - 1.0
    cos3 = c * (2.0 * cos2 - 1.0)
    return 0.5 * (v1 * (1.0 + c) + v2 * (1.0 - cos2) + v3 * (1.0 + cos3))


def _pairs(p, q, diel_constant, diel_model, split=False):
    d = p[0] - p[1]
    r2 = torch.clamp_min((d * d).sum(-1), 1e-2)
    r = torch.sqrt(r2)
    rstar = torch.clamp_min(q[:, 0], 1e-3)
    ratio = 1.07 * rstar / (r + 0.07 * rstar)
    r7 = r2**3 * r
    rs7 = rstar**7
    e_vdw = q[:, 1] * ratio**7 * (1.12 * rs7 / (r7 + 0.12 * rs7) - 2.0)
    rb = r + 0.05
    denom = diel_constant * (rb if diel_model == 1 else rb * rb)
    e_ele = 332.0716 * q[:, 2] / denom
    return (e_vdw, e_ele) if split else e_vdw + e_ele


_TERMS = (_bond, _angle, _stretch_bend, _oop, _torsion)


def _kind_energies(k: int, p, par, split, batch: MMFFBatch):
    """Term energies of kind ``k`` at the term atoms' positions ``p``; with
    ``split`` the pairs give (vdW, electrostatics), else a tuple of one."""
    if KINDS[k] != "pairs":
        return (_TERMS[k](p, par),)
    e = _pairs(p, par, batch.diel_constant, batch.diel_model, split)
    return e if split else (e,)


def _kinds(batch: MMFFBatch):
    return functools.partial(_kind_energies, batch=batch)


def plain_energy_fn(batch: MMFFBatch, sys2mol: torch.Tensor, a_pad: int):
    """The plain per-system energy ``fn(positions [S, a_pad, 3]) -> [S]`` of
    ``batch``'s molecules ``sys2mol``; the term index is built once, so a
    minimizer calls ``fn`` at every probe."""
    return flat.plain_energy_fn(batch, sys2mol, a_pad, _kinds(batch))


def plain_energy_and_grad_fn(batch: MMFFBatch, sys2mol: torch.Tensor, a_pad: int):
    """``fn(positions) -> (energy [S], gradient [S, a_pad, 3])``, the gradient
    by autograd of :func:`plain_energy_fn`, zero outside each system's
    atoms."""
    return flat.plain_energy_and_grad_fn(batch, sys2mol, a_pad, _kinds(batch))


def mmff_energy_plain(positions: torch.Tensor, batch: MMFFBatch,
                      sys2mol: torch.Tensor) -> torch.Tensor:
    """Per-system MMFF energies [S] (kcal/mol) of ``positions`` [S, A, 3];
    system s is molecule ``sys2mol[s]`` of ``batch``."""
    flat.check_inputs(positions, batch, sys2mol, 3)
    return plain_energy_fn(batch, sys2mol, positions.shape[1])(positions)


def mmff_energy_and_grad_plain(positions: torch.Tensor, batch: MMFFBatch,
                               sys2mol: torch.Tensor):
    """The plain version of :func:`mmff_energy_and_grad`: (energy [S],
    gradient [S, A, 3]) by ``torch.autograd.grad``."""
    flat.check_inputs(positions, batch, sys2mol, 3)
    return plain_energy_and_grad_fn(batch, sys2mol, positions.shape[1])(positions)


def mmff_term_magnitude_plain(positions: torch.Tensor, batch: MMFFBatch,
                              sys2mol: torch.Tensor) -> torch.Tensor:
    """Per-system sum of |E_term| [S] (float64; vdW and electrostatics of a
    pair counted apart): the scale of float32 rounding in the energy."""
    return flat.term_magnitude_plain(positions, batch, sys2mol, _kinds(batch))


def mmff_grad_magnitude_plain(positions: torch.Tensor, batch: MMFFBatch,
                              sys2mol: torch.Tensor) -> torch.Tensor:
    """Per gradient component, the sum over terms of |dE_term/dx| [S, A, 3]
    (float64; vdW and electrostatics apart): the scale of float32 rounding
    in a gradient whose terms cancel."""
    return flat.grad_magnitude_plain(positions, batch, sys2mol, _kinds(batch))


def mmff_energy(positions: torch.Tensor, batch: MMFFBatch, sys2mol: torch.Tensor) -> torch.Tensor:
    """Per-system MMFF energies [S] (kcal/mol): K4 for CUDA tensors (its
    gradient is dropped), the plain version for CPU tensors."""
    if positions.is_cuda:
        return mmff_energy_and_grad(positions, batch, sys2mol)[0]
    return mmff_energy_plain(positions, batch, sys2mol)


# ---- a torch model of K4's order and arithmetic ---------------------------------

def _walk_pair(d, p, k_ele, diel_model: int):
    """csrc/mmff.cu PairTerm on one step's lanes: the separations d [S, 32,
    3] and the table's rows p [S, 32, 4]; (dE/dr / r [S, 32], E [S, 32]).
    A nonbonded row: 1/r a reciprocal square root and each other divisor's
    reciprocal taken once and multiplied; a bond's row: the bond term; zero
    elsewhere."""
    r2raw = (d * d).sum(-1)
    r_b = torch.sqrt(r2raw + _EPS)
    dr = r_b - p[..., 0]
    k_b = 0.5 * 143.9325 * p[..., 3]
    c_712 = (7.0 / 12.0) * _CS * _CS
    e_b = k_b * dr * dr * (1.0 + _CS * dr + c_712 * dr * dr)
    c_b = k_b * dr * (2.0 + 3.0 * _CS * dr + 4.0 * c_712 * dr * dr) / r_b
    r2 = torch.clamp_min(r2raw, 1e-2)
    inv_r = torch.rsqrt(r2)
    r = r2 * inv_r
    rstar, eps, qq = torch.clamp_min(p[..., 0], 1e-3), p[..., 1], p[..., 2]
    rs2 = rstar * rstar
    rs7 = rs2 * rs2 * rs2 * rstar
    inv_v = torch.reciprocal(r + 0.07 * rstar)
    ratio = 1.07 * rstar * inv_v
    ratio2 = ratio * ratio
    q7 = ratio2 * ratio2 * ratio2 * ratio
    r7 = r2 * r2 * r2 * r
    inv_b = torch.reciprocal(r7 + 0.12 * rs7)
    bracket = 1.12 * rs7 * inv_b - 2.0
    inv_rb = torch.reciprocal(r + 0.05)
    e_ele = k_ele * qq * (inv_rb if diel_model == 1 else inv_rb * inv_rb)
    e = eps * q7 * bracket + e_ele
    dq7 = -7.0 * q7 * inv_v
    dbracket = -7.84 * rs7 * (r7 * inv_r) * (inv_b * inv_b)  # 7 x 1.12
    n_ele = 1.0 if diel_model == 1 else 2.0
    dedr = eps * (dq7 * bracket + q7 * dbracket) - n_ele * e_ele * inv_rb
    on = (eps != 0) | (qq != 0)
    bond = ~on & (p[..., 3] != 0)
    c = torch.where(bond, c_b, torch.where(on & (r2raw >= 1e-2), dedr * inv_r, 0.0))
    return c, torch.where(bond, e_b, torch.where(on, e, 0.0))


def walk_pairs_model(x: torch.Tensor, batch, sys2mol: torch.Tensor, pair_fn, g: torch.Tensor,
                     e_thread: torch.Tensor) -> None:
    """K4's and K6's nonbonded terms at ``x`` [S, A, 3] in the kernels' order
    (``dist_geom.dealt_pairs_model``): each step's lanes read their pairs'
    rows of ``batch.pair_table`` (by diagonals, ``flat.pair_slot``), and
    ``pair_fn(d, rows) -> (dE/dr / r, E)`` gives their terms; the gradient
    into ``g`` [S, A, 3], the lanes' energies into ``e_thread`` [S,
    THREADS]."""
    s2m = sys2mol.to(torch.int64)
    first = batch.pair_offsets.to(torch.int64)[s2m]
    table = batch.pair_table.to(x.dtype)
    for n, rows in dist_geom._systems_by_atoms(batch, sys2mol).items():
        xs, base = x[rows], first[rows][:, None]

        def step(i, j, valid, xs=xs, base=base, n=n):
            ic, jc = np.minimum(i, n - 1), np.minimum(j, n - 1)
            d = xs[:, ic] - xs[:, jc]
            slot = torch.as_tensor(np.where(valid, flat.pair_slot(ic, jc, n), 0))
            c, e = pair_fn(d, table[base + slot[None]])
            on = torch.as_tensor(valid)[None]
            return torch.where(on[..., None], c[..., None] * d, 0.0), torch.where(on, e, 0.0)

        g_n, e_n = g[rows], e_thread[rows]
        dist_geom.dealt_pairs_model(step, n, 1.0, g_n, e_n)
        g[rows], e_thread[rows] = g_n, e_n


def packed_threads(local: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """csrc/dg_pairs.cuh packed_terms: the thread of term ``local`` of a
    kind's ``count`` terms (each a tensor): in round r = local / 128 of n
    terms, W = ceil(n / 32) warps, warp (local - 128 r) mod W, lane (local -
    128 r) / W."""
    r = local // dist_geom.THREADS
    left = local - r * dist_geom.THREADS
    w = (torch.clamp(count - r * dist_geom.THREADS, max=dist_geom.THREADS) + 31) // 32
    return (left % w) * 32 + left // w


def bonded_terms_model(x: torch.Tensor, batch, sys2mol: torch.Tensor, kind_energies,
                       g: torch.Tensor, e_thread: torch.Tensor, packed: bool = True,
                       slots=None) -> None:
    """K4's (``packed``) and K6's bonded kinds after the bonds (which their
    walks take) before the pairs, in turn: each term's energy on its
    thread (K4: :func:`packed_threads` of its index among its molecule's
    terms of the kind, or, for a kind in ``slots``, of the (index, count)
    that ``slots[kind]`` gives by its row in the kind's table; K6:
    ``dist_geom.term_threads``) and its gradient (by autograd of the plain
    term) added into ``g`` in term order."""
    flat_x = x.reshape(-1, 3)
    S = x.shape[0]
    s2m = sys2mol.to(torch.int64)
    expanded = flat.expand(batch, sys2mol, x.shape[1])
    for k, (sys_of, atoms, par) in enumerate(expanded[:-1]):
        if k == 0 or sys_of.shape[0] == 0:
            continue
        with torch.enable_grad():
            p = [flat_x[atoms[:, q]].requires_grad_(True) for q in range(atoms.shape[1])]
            (e_t,) = kind_energies(k, p, par.to(x.dtype), False)
            grads = torch.autograd.grad(e_t.sum(), p)
        off = batch.offsets[k].to(torch.int64)
        local = dist_geom.system_local(sys_of, S)
        count = (off[1:] - off[:-1])[s2m][sys_of]
        if slots is not None and k in slots:
            local, count = (v[off[s2m][sys_of] + local] for v in slots[k])
        dist_geom.add_terms_model(e_thread, g, sys_of, atoms, e_t.detach(), grads, S,
                                  packed_threads(local, count) if packed else None)


def stretch_bend_slots(batch: MMFFBatch):
    """For each stretch-bend row, where K4 takes it: (its index, the count)
    among the molecule's angles (its angle's), or, a stretch-bend on no
    angle, among the molecule's ``sb_rest``."""
    sb = batch.atoms[2].shape[0]
    off_s = batch.offsets[2].to(torch.int64)
    mol = torch.repeat_interleave(torch.arange(batch.n_mols), off_s[1:] - off_s[:-1])
    rest = batch.sb_rest.to(torch.int64)
    on_angle = torch.ones(sb, dtype=torch.bool)
    on_angle[rest] = False
    slot, count = torch.empty(sb, dtype=torch.int64), torch.empty(sb, dtype=torch.int64)
    off_a = batch.offsets[1].to(torch.int64)
    slot[on_angle] = stretch_bend_angles(batch)[on_angle] - off_a[mol[on_angle]]
    count[on_angle] = (off_a[1:] - off_a[:-1])[mol[on_angle]]
    off_r = batch.sb_rest_offsets.to(torch.int64)
    slot[rest] = torch.arange(rest.shape[0]) - off_r[mol[rest]]
    count[rest] = (off_r[1:] - off_r[:-1])[mol[rest]]
    return slot, count


def mmff_energy_and_grad_model(positions: torch.Tensor, batch: MMFFBatch,
                               sys2mol: torch.Tensor):
    """(energy [S], gradient [S, A, 3]) of ``positions`` by K4's order and
    arithmetic (csrc/mmff.cu mmff_eval), on the CPU: the pair walk over
    ``pair_table`` (:func:`walk_pairs_model`, the pair term with its
    reciprocals, and the bonds), then the other bonded kinds in turn
    (:func:`bonded_terms_model`; each stretch-bend's energy on its angle's
    thread, :func:`stretch_bend_slots`),
    the energy by ``dist_geom.block_total_model``. Where it departs from
    :func:`mmff_energy_and_grad_plain`: the order of the sums, the pairs'
    reciprocals, the table's walk in place of the list."""
    flat.check_inputs(positions, batch, sys2mol, 3)
    x = positions.detach()
    g = torch.zeros_like(x)
    e_thread = torch.zeros((x.shape[0], dist_geom.THREADS), dtype=x.dtype)
    k_ele = torch.tensor(332.0716, dtype=torch.float32) / torch.tensor(
        batch.diel_constant, dtype=torch.float32)
    walk_pairs_model(x, batch, sys2mol,
                     lambda d, p: _walk_pair(d, p, k_ele.to(x.dtype), batch.diel_model), g,
                     e_thread)
    bonded_terms_model(x, batch, sys2mol, _kinds(batch), g, e_thread,
                       slots={2: stretch_bend_slots(batch)})
    mask = flat.atom_mask(batch, sys2mol, x.shape[1])
    return dist_geom.block_total_model(e_thread), torch.where(mask[..., None], g, 0.0)


# ---- kernel K4 ------------------------------------------------------------------

def mmff_energy_and_grad(positions: torch.Tensor, batch: MMFFBatch, sys2mol: torch.Tensor,
                         phase_cycles: bool = False):
    """(energy [S], gradient [S, A, 3]) of ``positions`` [S, A, 3], system s
    being molecule ``sys2mol[s]`` (int32) of ``batch``; the gradient is zero
    outside each system's atoms. K4 for CUDA tensors, the plain version for
    CPU tensors. With ``phase_cycles`` (CUDA only), K4's instrumented
    instantiation, and also each warp's cycles per phase (int64 [S, 4,
    len(EVAL_PHASES)])."""
    if not positions.is_cuda:
        if phase_cycles:
            raise ValueError("phase_cycles needs CUDA tensors")
        return mmff_energy_and_grad_plain(positions, batch, sys2mol)
    lib = mmff_lib()
    flat.check_kernel_inputs(positions, batch, sys2mol, "K4", flat.kernel_dim(lib, "mmff"))
    n_sys, a_pad = positions.shape[:2]
    dev = positions.device
    energy = torch.empty(n_sys, dtype=torch.float32, device=dev)
    grad = torch.empty_like(positions)
    count = flat.system_atoms(batch, sys2mol)
    args = (positions.data_ptr(), n_sys, a_pad, sys2mol.data_ptr(), count.data_ptr(),
            batch.offsets.data_ptr(), batch.n_mols, flat.table_pointers(batch),
            batch.diel_constant, batch.diel_model, energy.data_ptr(), grad.data_ptr())
    cycles = (torch.zeros((n_sys, dist_geom.WARPS, len(EVAL_PHASES)), dtype=torch.int64,
                          device=dev) if phase_cycles else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = (lib.nvmk_mmff_energy_grad_cycles(*args, cycles.data_ptr(), stream) if phase_cycles
              else lib.nvmk_mmff_energy_grad(*args, stream))
    if rc != 0:
        raise RuntimeError(f"mmff_energy_grad kernel launch failed with CUDA error {rc}")
    launch_counts["mmff_energy_grad"] += 1
    return (energy, grad, cycles) if phase_cycles else (energy, grad)


MMFF = flat.ForceField("mmff", mmff_energy_and_grad, plain_energy_and_grad_fn, mmff_lib,
                       lambda batch: (batch.diel_constant, batch.diel_model))
