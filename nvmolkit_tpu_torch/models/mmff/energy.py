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
* A disabled term (``MMFFProperties.bondTerm`` ... ``eleTerm``) is dropped
  from the batch; ``dielConstant`` and ``dielModel`` are scalars.

:func:`mmff_energy_and_grad` launches K4 (``csrc/mmff.cu``) for CUDA
tensors and runs :func:`mmff_energy_and_grad_plain` (the energy in torch,
the gradient by ``torch.autograd.grad``) for CPU tensors; a build or launch
failure raises. ``launch_counts`` counts K4's launches.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from nvmolkit_tpu_torch._build import mmff_lib
from nvmolkit_tpu_torch.chem.mol import Mol
from nvmolkit_tpu_torch.models import flat
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
            atoms=tuple(put(a) for a in self.atoms), params=tuple(put(p) for p in self.params))


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


# ---- kernel K4 ------------------------------------------------------------------

def mmff_energy_and_grad(positions: torch.Tensor, batch: MMFFBatch, sys2mol: torch.Tensor):
    """(energy [S], gradient [S, A, 3]) of ``positions`` [S, A, 3], system s
    being molecule ``sys2mol[s]`` (int32) of ``batch``; the gradient is zero
    outside each system's atoms. K4 for CUDA tensors, the plain version for
    CPU tensors."""
    if not positions.is_cuda:
        return mmff_energy_and_grad_plain(positions, batch, sys2mol)
    lib = mmff_lib()
    flat.check_kernel_inputs(positions, batch, sys2mol, "K4", flat.kernel_dim(lib, "mmff"))
    n_sys, a_pad = positions.shape[:2]
    dev = positions.device
    energy = torch.empty(n_sys, dtype=torch.float32, device=dev)
    grad = torch.empty_like(positions)
    count = flat.system_atoms(batch, sys2mol)
    with torch.cuda.device(dev):
        rc = lib.nvmk_mmff_energy_grad(
            positions.data_ptr(), n_sys, a_pad, sys2mol.data_ptr(), count.data_ptr(),
            batch.offsets.data_ptr(), batch.n_mols, flat.table_pointers(batch),
            batch.diel_constant, batch.diel_model, energy.data_ptr(), grad.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mmff_energy_grad kernel launch failed with CUDA error {rc}")
    launch_counts["mmff_energy_grad"] += 1
    return energy, grad


MMFF = flat.ForceField("mmff", mmff_energy_and_grad, plain_energy_and_grad_fn, mmff_lib,
                       lambda batch: (batch.diel_constant, batch.diel_model))
