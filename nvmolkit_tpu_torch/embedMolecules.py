"""ETKDG conformer embedding — public API.

The port's counterpart of ``nvmolkit_tpu/embedMolecules.py``, with its
public names: :class:`EmbedParameters` (every field), the presets
:func:`ETKDG`, :func:`ETKDGv2`, :func:`ETKDGv3`, :func:`srETKDGv3`,
:func:`KDG` and :func:`ETDG`, :class:`EmbedFailureCounts` and
:func:`EmbedMolecules`. Per chunk of molecules of one atom bucket:

  1. topological bounds on the host (``chem/bounds.py``, the native batch
     builder ``csrc/topo_bounds.cpp``);
  2. triangle smoothing on the device (K9), with the relaxed-bounds retry
     and ``ignoreSmoothingFailures``;
  3. per attempt, over the systems (molecule, conformer) still to embed:
     coordinates from random distance matrices (K10, uniforms from a
     ``torch.Generator`` seeded by ``randomSeed``), the first DG
     minimization in four dimensions and the fourth-dimension compression
     (K5 under ``minimizerBackend="flat"``, K8 under ``"bfgs"``, K23 under
     ``"lbfgs"``, over the DG force field K11), then, with the ETK stage
     (``useBasicKnowledge`` or ``useExpTorsionAnglePrefs``, as the default
     ``EmbedParameters()`` and every preset have it), the ETK minimization in
     three dimensions on the same minimizer over the ETK force field K13
     (``etkMinimizeIters``, the bounds at weight 1), then the six checks
     (K12); the passing systems'
     positions are copied into the chunk's accepted buffer on the device.

The ETK stage's terms are built on the host once per chunk, after the
smoothing: the torsion provider (``torsionProvider`` if given; else a fresh
:class:`~nvmolkit_tpu_torch.models.etkdg_torsions.ExperimentalTorsionProvider`
for the small-ring and macrocycle tiers, the cached default otherwise; none
with ``useExpTorsionAnglePrefs=False``) matches the chunk's molecules with
its native matcher (``precompute``), then ``build_etk_terms_batch`` builds
the impropers and torsions (cached on each ``Mol``), which go to the device
as per-molecule tables (``models/etk.py``).

Two departures of the JAX package from RDKit stand, as there (fault 7):
``numZeroFail`` defaults to 0, and ``forceTransAmides`` is an ETK torsion
pin with its minimum at omega = 180 degrees (RDKit clamps the 1-4 bounds).
``minimizerBackend="lbfgs"`` runs the lockstep L-BFGS without the MMFF/UFF
driver's restart, as the JAX package's embedding calls it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from nvmolkit_tpu_torch.chem.bounds import topological_bounds, topological_bounds_batch
from nvmolkit_tpu_torch.chem.mol import Mol
from nvmolkit_tpu_torch.models import dist_geom, etk
from nvmolkit_tpu_torch.ops import embed_checks as checks
from nvmolkit_tpu_torch.ops.bfgs import bfgs_minimize
from nvmolkit_tpu_torch.ops.lbfgs import lbfgs_lockstep
from nvmolkit_tpu_torch.ops.lbfgs_flat import lbfgs
from nvmolkit_tpu_torch.ops.triangle_smooth import triangle_smooth_bounds
from nvmolkit_tpu_torch.types import CoordinateOutput, Dense3DResult, resolve_device
from nvmolkit_tpu_torch.utils.config import HardwareOptions

# the device memory one chunk of systems may take (the uniforms of the
# distance matrices, 4 A^2 bytes a system, dominate; K8's packed inverse
# Hessians, 2 n (n + 1) bytes a system of n = 4 x its atoms coordinates,
# are sliced by ops/bfgs.HESSIAN_BYTES on their own)
CHUNK_BYTES = 4 << 30
# the ETK tables of a molecule, per atom: up to ~4 torsion rows (112 bytes
# each: 4 atoms, 6 F and 6 phi0, and K13's 6 cos phi0 and 6 sin phi0) per
# bond and ~1.1 bonds per atom, an improper (20 bytes) per third of the atoms
ETK_BYTES_PER_ATOM = 512


@dataclasses.dataclass
class EmbedParameters:
    """RDKit ``EmbedParameters`` mirror, with the JAX package's fields and
    defaults. ``useRandomCoords`` must stay True."""

    useRandomCoords: bool = True
    randomSeed: int = 42
    # eigen-projection knobs (RDKit semantics): box side for randomized
    # eigencomponents, randomize-vs-zero for non-positive eigenvalues, and
    # the zero-eigenvalue failure count (0 here, unlike RDKit's 1, as in the
    # JAX package)
    boxSizeMult: float = 2.0
    randNegEig: bool = True
    numZeroFail: int = 0
    # an ETK torsion pin in the JAX package (RDKit adjusts the 1-4 bounds)
    forceTransAmides: bool = False
    maxViolationRatio: float = 0.35   # bounds-check acceptance
    minTetrahedralVolume: float = 0.5  # |6V| floor for sp3 centers
    chiralWeightFirst: float = 1.0
    fourthDimWeightFirst: float = 0.1
    chiralWeightSecond: float = 0.2
    fourthDimWeightSecond: float = 1.0
    firstMinimizeIters: int = 400
    fourthDimMinimizeIters: int = 200
    useBasicKnowledge: bool = True    # ETK improper (planarity) 3-D stage
    useExpTorsionAnglePrefs: bool = True
    useSmallRingTorsions: bool = False
    useMacrocycleTorsions: bool = False
    etkMinimizeIters: int = 150
    pruneRmsThresh: float = -1.0      # <=0 disables RMS pruning
    ignoreSmoothingFailures: bool = False  # embed with relaxed unsmoothed bounds
    # "flat" (L-BFGS, K5), "bfgs" (K8) or "lbfgs" (the lockstep L-BFGS, K23)
    minimizerBackend: str = "flat"


def ETKDG(**overrides) -> EmbedParameters:
    """RDKit ``ETKDG()`` preset: experimental torsions + basic knowledge."""
    return EmbedParameters(
        useExpTorsionAnglePrefs=True, useBasicKnowledge=True,
        forceTransAmides=True, **overrides,
    )


def ETKDGv2(**overrides) -> EmbedParameters:
    """RDKit ``ETKDGv2()`` preset."""
    return ETKDG(**overrides)


def ETKDGv3(**overrides) -> EmbedParameters:
    """RDKit ``ETKDGv3()`` preset: v3 torsions + macrocycle tiers."""
    return ETKDG(useMacrocycleTorsions=True, **overrides)


def srETKDGv3(**overrides) -> EmbedParameters:
    """RDKit ``srETKDGv3()`` preset: v3 with small-ring torsions."""
    return ETKDG(useSmallRingTorsions=True, **overrides)


def KDG(**overrides) -> EmbedParameters:
    """RDKit ``KDG()`` preset: basic knowledge only."""
    return EmbedParameters(
        useExpTorsionAnglePrefs=False, useBasicKnowledge=True, **overrides
    )


def ETDG(**overrides) -> EmbedParameters:
    """RDKit ``ETDG()`` preset: experimental torsions only."""
    return EmbedParameters(
        useExpTorsionAnglePrefs=True, useBasicKnowledge=False, **overrides
    )


@dataclasses.dataclass
class EmbedFailureCounts:
    """Per-stage failure counters (the reference's getFailures())."""

    double_bond_geometry: int = 0
    double_bond_stereo: int = 0
    chiral_dist_check: int = 0

    smoothing: int = 0
    initial_coords: int = 0   # numZeroFail eigen-rank check
    first_minimize: int = 0
    bounds_check: int = 0
    chiral_check: int = 0
    tetrahedral_check: int = 0


# the failure counters of one attempt's flags: the rank flag, then the checks
_COUNTERS = ("initial_coords",) + checks.CHECKS


class _StageTimer:
    """Wall seconds per stage (debugMode), the device synchronized at each
    stage's end."""

    def __init__(self, device: torch.device):
        self.device, self.seconds = device, {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        return "embed stages: " + ", ".join(f"{k} {v:.4f} s" for k, v in self.seconds.items())


def _chunk_cap(bucket: int, confs: int, use_etk: bool = False) -> int:
    """Systems per chunk of atom bucket ``bucket``: CHUNK_BYTES over a
    system's device bytes (the [A, A] uniforms, the positions, gradients and
    checks at ~160 bytes an atom, and its share of the molecule's two
    smoothed [A, A] bounds, their (u, l) by diagonals and, with the ETK
    stage, its ETK tables)."""
    per_mol = 16.0 * bucket * bucket + (ETK_BYTES_PER_ATOM * bucket if use_etk else 0.0)
    per_system = 4.0 * bucket * bucket + 160.0 * bucket + per_mol / max(1, confs)
    return max(8, int(CHUNK_BYTES / per_system))


def _retry_ladder(n_sys: int) -> list[int]:
    """The sub-batch sizes of the retries: n_sys, then quarters down to 16
    (the JAX package's ladder)."""
    ladder, size = [], n_sys
    while True:
        ladder.append(size)
        nxt = max(16, (size + 3) // 4)
        if nxt >= size:
            break
        size = nxt
    return sorted(set(ladder))


def EmbedMolecules(
    molecules: list[Mol],
    params: EmbedParameters | None = None,
    confsPerMolecule: int = 1,
    maxIterations: int = 10,
    hardwareOptions: HardwareOptions | None = None,
    failures: EmbedFailureCounts | None = None,
    torsionProvider=None,
    debugMode: bool = False,
    output=None,
    targetGpu: int = -1,
    *,
    device=None,
) -> Dense3DResult:
    """Generate ``confsPerMolecule`` conformers for every molecule by
    ETKDG (or its plain distance-geometry or partial variants, as ``params``
    say); also appends them to each ``Mol``'s conformer list
    unless ``output=CoordinateOutput.DEVICE``. Returns a
    :class:`Dense3DResult` on the device (``conf_mask`` marks the embedded
    conformers). Each system gets up to ``maxIterations`` attempts; the
    retries run the failing systems in sub-batches whose spare lanes try
    them again (a passing duplicate fills the slot), and the failure counters
    count each system's first row of an attempt. ``failures`` accumulates
    the counters; ``torsionProvider`` (a callable ``mol -> (idx [T, 4],
    coeffs [T, 6], phase [T, 6])``, with an optional ``precompute(mols)``)
    replaces the torsion library when ``useExpTorsionAnglePrefs`` is on;
    ``debugMode`` prints the stage times; ``targetGpu`` >= 0
    selects that card when ``hardwareOptions.deviceIds`` is unset; the work
    runs on ``device`` if given (``"cpu"`` for the plain versions), else on
    ``cuda``."""
    params = params or EmbedParameters()
    if not params.useRandomCoords:
        raise ValueError("only useRandomCoords=True is supported")
    if params.minimizerBackend == "flat":
        minimize = lbfgs
    elif params.minimizerBackend == "bfgs":
        minimize = bfgs_minimize
    elif params.minimizerBackend == "lbfgs":
        minimize = lbfgs_lockstep
    else:
        raise ValueError(f"minimizerBackend must be 'bfgs', 'lbfgs' or 'flat', "
                         f"got {params.minimizerBackend!r}")
    opts = hardwareOptions or HardwareOptions()
    if targetGpu >= 0 and not opts.deviceIds:
        opts = dataclasses.replace(opts, deviceIds=[targetGpu])
    dev = resolve_device(opts, device)
    fail = failures if failures is not None else EmbedFailureCounts()

    n_mols = len(molecules)
    buckets: dict[int, list[int]] = {}
    for mi, m in enumerate(molecules):
        for b in opts.atomBuckets:
            if m.num_atoms <= b:
                buckets.setdefault(b, []).append(mi)
                break
        else:
            raise ValueError(f"molecule {mi} has {m.num_atoms} atoms > largest bucket")
    max_atoms = max(buckets) if buckets else 1
    out_pos = torch.zeros((n_mols, confsPerMolecule, max_atoms, 3), dtype=torch.float32,
                          device=dev)
    out_conf_mask = np.zeros((n_mols, confsPerMolecule), bool)
    out_atom_mask = np.zeros((n_mols, max_atoms), bool)
    for mi, m in enumerate(molecules):
        out_atom_mask[mi, : m.num_atoms] = True
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(params.randomSeed))
    timer = _StageTimer(dev) if debugMode else None
    use_etk = params.useBasicKnowledge or params.useExpTorsionAnglePrefs
    provider = _torsion_provider(params, torsionProvider)

    for bucket, mol_ids in sorted(buckets.items()):
        cap = (opts.batchSize if opts.batchSize > 0
               else _chunk_cap(bucket, confsPerMolecule, use_etk))
        per_chunk = max(1, cap // max(1, confsPerMolecule))
        for start in range(0, len(mol_ids), per_chunk):
            _embed_chunk(molecules, mol_ids[start:start + per_chunk], bucket, confsPerMolecule,
                         maxIterations, params, gen, minimize, out_pos, out_conf_mask, fail,
                         timer, dev, use_etk, provider)
    if timer is not None:
        print(timer.report())

    if params.pruneRmsThresh > 0:
        _prune(out_pos, out_conf_mask, out_atom_mask, params.pruneRmsThresh)

    if output != CoordinateOutput.DEVICE and out_conf_mask.any():
        host = out_pos.cpu().numpy()
        for mi, m in enumerate(molecules):
            for ci in np.nonzero(out_conf_mask[mi])[0]:
                m.add_conformer(host[mi, ci, : m.num_atoms].astype(np.float64))

    return Dense3DResult(positions=out_pos, conf_mask=torch.from_numpy(out_conf_mask).to(dev),
                         atom_mask=torch.from_numpy(out_atom_mask).to(dev))


def _torsion_provider(params: EmbedParameters, torsion_provider):
    """The ETK stage's torsion provider, as the JAX package resolves it:
    none without ``useExpTorsionAnglePrefs``; the caller's if given; a fresh
    provider with the small-ring or macrocycle tiers when they are asked
    for; else the cached default."""
    if not params.useExpTorsionAnglePrefs:
        return None
    if torsion_provider is not None:
        return torsion_provider
    from nvmolkit_tpu_torch.models.etkdg_torsions import (
        ExperimentalTorsionProvider,
        default_torsion_provider,
    )

    if params.useSmallRingTorsions or params.useMacrocycleTorsions:
        return ExperimentalTorsionProvider(use_small_rings=params.useSmallRingTorsions,
                                           use_macrocycles=params.useMacrocycleTorsions)
    return default_torsion_provider()


def _prune(out_pos, out_conf_mask, out_atom_mask, threshold: float) -> None:
    """Greedy RMS pruning of each molecule's accepted conformers, in order:
    one is kept iff its RMSD after superposition to every kept one exceeds
    ``threshold``. The RMSDs are one K3 launch over every molecule's
    condensed triangle (``ops/kabsch.py``); the scan runs on the host."""
    from nvmolkit_tpu_torch.ops.kabsch import conformer_rmsd_condensed

    n_mols, confs = out_conf_mask.shape
    ids = [np.nonzero(out_conf_mask[m])[0] for m in range(n_mols)]
    n_confs = np.array([len(c) for c in ids], np.int64)
    if n_confs.max(initial=0) < 2:
        return
    rows = torch.from_numpy(np.concatenate(
        [m * confs + c for m, c in enumerate(ids)]).astype(np.int64)).to(out_pos.device)
    flat = out_pos.reshape(n_mols * confs, out_pos.shape[2], 3)
    mask = torch.from_numpy(out_atom_mask).to(out_pos.device)
    rms = conformer_rmsd_condensed(flat, mask, n_confs, rows).cpu().numpy()
    base = 0
    for m, c in enumerate(ids):
        kept: list[int] = []
        for i in range(len(c)):
            if all(rms[base + i * (i - 1) // 2 + k] > threshold for k in kept):
                kept.append(i)
        for i in set(range(len(c))) - set(kept):
            out_conf_mask[m, c[i]] = False
        base += len(c) * (len(c) - 1) // 2


def _embed_chunk(molecules, mol_ids, bucket, confs, max_iterations, params, gen, minimize,
                 out_pos, out_conf_mask, fail, timer, dev, use_etk, provider) -> None:
    def stage(name):
        return timer.stage(name) if timer is not None else contextlib.nullcontext()

    A = bucket
    mols = [molecules[mi] for mi in mol_ids]
    with stage("topological_bounds"):
        upper, lower = topological_bounds_batch(mols, A)
        n_atoms = np.array([m.num_atoms for m in mols], np.int32)
        chiral = [dist_geom.build_chiral_sets(m) for m in mols]
        tables = checks.build_check_tables(mols, chiral, dev)
    n_t = torch.from_numpy(n_atoms).to(dev)
    with stage("triangle_smoothing"):
        ub, lb, consistent = triangle_smooth_bounds(torch.from_numpy(upper).to(dev),
                                                    torch.from_numpy(lower).to(dev), n_t)
        consistent = consistent.cpu().numpy()
    if not consistent.all():
        # the reference's fallback for a failed smoothing: bounds without
        # 1-5 terms and with scaled vdW floors, smoothed again; with
        # ignoreSmoothingFailures, those relaxed bounds unsmoothed
        rows = np.nonzero(~consistent)[0]
        upper_r, lower_r = upper[rows].copy(), lower[rows].copy()
        for r, k in enumerate(rows):
            u, l = topological_bounds(mols[k], relaxed=True)
            upper_r[r, : n_atoms[k], : n_atoms[k]] = u
            lower_r[r, : n_atoms[k], : n_atoms[k]] = l
        up_r, lo_r = torch.from_numpy(upper_r).to(dev), torch.from_numpy(lower_r).to(dev)
        ub_r, lb_r, cons_r = triangle_smooth_bounds(up_r, lo_r, n_t[torch.from_numpy(rows)
                                                                   .to(dev)])
        cons_r = cons_r.cpu().numpy()
        if params.ignoreSmoothingFailures:
            keep = torch.from_numpy(~cons_r).to(dev)[:, None, None]
            ub_r, lb_r = torch.where(keep, up_r, ub_r), torch.where(keep, lo_r, lb_r)
            cons_r[:] = True
        rows_t = torch.from_numpy(rows).to(dev)
        ub[rows_t], lb[rows_t] = ub_r, lb_r
        consistent[rows] = cons_r
    fail.smoothing += int((~consistent).sum()) * confs
    if use_etk:
        with stage("etk_term_build"):
            if provider is not None and hasattr(provider, "precompute"):
                provider.precompute(mols)  # the native matcher, the whole chunk at once
            etk_terms = etk.build_etk_terms_batch(mols, provider, params.forceTransAmides)

    batch = dist_geom.make_dg_batch(ub, lb, n_t, chiral)
    etk_batch = etk.make_etk_batch(batch, etk_terms) if use_etk else None
    first = batch.weighted(params.chiralWeightFirst, params.fourthDimWeightFirst)
    second = batch.weighted(params.chiralWeightSecond, params.fourthDimWeightSecond)
    sys_mol = np.repeat(np.arange(len(mols)), confs)
    n_sys = len(sys_mol)
    needed = consistent[sys_mol].copy()
    ladder = _retry_ladder(n_sys)
    acc_buf = torch.zeros((n_sys, A, 3), dtype=torch.float32, device=dev)
    accepted = np.zeros(n_sys, bool)

    for _ in range(max_iterations):
        active = np.nonzero(needed)[0]
        if len(active) == 0:
            break
        sub = next(s for s in ladder if s >= len(active))
        if sub < n_sys:
            # spare lanes of the sub-batch try the failing systems again
            row_to_sys = np.resize(active, sub)
            first_row = np.arange(sub) < len(active)
        else:
            row_to_sys = active
            first_row = np.ones(len(active), bool)
        rows_mol = torch.from_numpy(sys_mol[row_to_sys].astype(np.int32)).to(dev)
        with stage("coordgen"):
            uniforms = dist_geom.draw_uniforms(gen, len(row_to_sys), A, dev)
            coords4, eig_ok, _ = dist_geom.random_distance_matrices(
                batch, rows_mol, uniforms, params.boxSizeMult, params.randNegEig,
                params.numZeroFail)
            del uniforms
        with stage("first_minimization"):
            res = minimize(dist_geom.DG, coords4, first, rows_mol,
                           max_iters=params.firstMinimizeIters)
        with stage("fourth_dim_minimization"):
            res = minimize(dist_geom.DG, res.positions, second, rows_mol,
                           max_iters=params.fourthDimMinimizeIters)
        pos3 = res.positions[..., :3].contiguous()
        if use_etk:
            with stage("etk_minimization"):
                pos3 = minimize(etk.ETK, pos3, etk_batch, rows_mol,
                                max_iters=params.etkMinimizeIters).positions
        with stage("stereo_checks"):
            oks = checks.embed_checks(pos3, ub, lb, rows_mol,
                                      n_t[rows_mol.to(torch.int64)].contiguous(), tables,
                                      params.maxViolationRatio, params.minTetrahedralVolume)
            flags = torch.cat([eig_ok[None], oks]).cpu().numpy()  # one fetch per attempt
        ok = np.ones(len(row_to_sys), bool)
        for name, flag in zip(_COUNTERS, flags):
            newly_failed = first_row & ok & ~flag
            setattr(fail, name, getattr(fail, name) + int(newly_failed.sum()))
            ok &= flag
        # the first passing row of each system fills its slot
        sys_ok, first_ok = np.unique(row_to_sys[ok], return_index=True)
        if len(sys_ok):
            src = torch.from_numpy(np.nonzero(ok)[0][first_ok]).to(dev)
            acc_buf.index_copy_(0, torch.from_numpy(sys_ok).to(dev), pos3[src])
            needed[sys_ok] = False
            accepted[sys_ok] = True

    acc = np.nonzero(accepted)[0]
    if len(acc):
        mi = np.asarray(mol_ids)[sys_mol[acc]]
        ci = acc % confs
        out_pos[torch.from_numpy(mi).to(dev), torch.from_numpy(ci).to(dev), :A] = \
            acc_buf[torch.from_numpy(acc).to(dev)]
        out_conf_mask[mi, ci] = True
