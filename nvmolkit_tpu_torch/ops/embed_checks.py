"""The six acceptance checks of an embedding: kernel K12 and its plain
PyTorch version.

The port's counterpart of ``nvmolkit_tpu/embedMolecules.py``'s
``_check_embeddings``: bounds ratio, chiral volume window, tetrahedral
volume, double-bond linearity, double-bond E/Z, chiral distances (each with
the JAX function's 1e-12 and 1e-6 guards). Where the JAX function pads each
check's terms per system, the port keeps them per molecule, as flat tables
with CSR offsets (:class:`CheckTables`, from :func:`build_check_tables`);
the bounds are each molecule's smoothed matrices.

* :func:`embed_checks_plain` is the JAX function's arithmetic in torch.
* :func:`embed_checks` launches K12 (``csrc/embed_checks.cu``: a warp per
  system up to :data:`WARP_MAX_ATOMS` atoms, a block per system past them;
  the pairs walked over the bounds laid out by diagonals, the table DG's
  kernels read, ``models/dist_geom.diagonal_bounds``) for CUDA tensors and
  runs the plain version for CPU tensors. A build or launch failure raises.
  :func:`launch_clocked` is K12 with each warp's phase cycles
  (:data:`K12_PHASES`).
* :func:`near_threshold_plain` flags, per check and system, a term whose
  quantity lies within float32 rounding of its threshold: there the kernel
  and the plain version (or the JAX function) may rightly disagree.

``launch_counts`` counts K12's launches.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from nvmolkit_tpu_torch.chem.stereo import find_double_bond_ends, find_stereo_double_bonds

CHECKS = ("bounds_check", "chiral_check", "tetrahedral_check", "double_bond_geometry",
          "double_bond_stereo", "chiral_dist_check")
ARITY = (4, 4, 3, 4, 2)  # chiral, tetrahedral, double-bond ends, stereo bonds, chiral pairs
# the relative distance from a threshold within which float32 rounding may
# flip a check (a few float32 ulps of the quantities the checks compare)
NEAR = 1e-5
# K12 runs a warp per system at buckets up to this many atoms (several
# systems a block), a block of 4 warps per system past it
WARP_MAX_ATOMS = 64
# the phases of K12's per-warp clock (launch_clocked; csrc/embed_checks.cu)
K12_PHASES = ("load", "pairs", "terms", "votes", "write")

launch_counts = {"embed_checks": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


@dataclasses.dataclass(frozen=True)
class CheckTables:
    """The checks' terms of M molecules: ``offsets`` int32 [5, M + 1] into
    ``atoms`` (int32 chiral quartets [T, 4], tetrahedral quartets [T, 4],
    double-bond ends [T, 3], stereo double bonds [T, 4], chiral-distance
    pairs [T, 2]), the chiral windows float32 [T, 2] and the stereo signs
    float32 [T] (-1 cis, +1 trans)."""

    offsets: torch.Tensor
    atoms: tuple
    windows: torch.Tensor
    signs: torch.Tensor


def tetrahedral_centers(mol) -> np.ndarray:
    """sp3-ish carbons with 4 neighbors: quartets for collapse checks (the
    JAX package's ``_tetrahedral_centers``, copied)."""
    quads = []
    for i, atom in enumerate(mol.atoms):
        if atom.atomic_num not in (6, 7) or atom.is_aromatic:
            continue
        nbrs = mol.neighbors(i)
        if len(nbrs) == 4:
            quads.append(nbrs)
    return (
        np.asarray(quads, np.int32) if quads else np.zeros((0, 4), np.int32)
    )


def chiral_distance_pairs(chiral_idx: np.ndarray) -> np.ndarray:
    """All pairs (a < b) of the atoms of a molecule's chiral sets (the
    reference's chiral distance-matrix check)."""
    atoms = sorted(set(np.asarray(chiral_idx).ravel().tolist()))
    pairs = [(a, b) for x, a in enumerate(atoms) for b in atoms[x + 1:]]
    return np.asarray(pairs, np.int32).reshape(-1, 2)


def build_check_tables(mols, chiral_sets, device) -> CheckTables:
    """The :class:`CheckTables` of ``mols`` (with their
    ``build_chiral_sets`` outputs), on ``device``."""
    per_kind = [[] for _ in ARITY]
    windows, signs = [], []
    for m, (cidx, clb, cub) in zip(mols, chiral_sets):
        sdbs = find_stereo_double_bonds(m)
        per_kind[0].append(np.asarray(cidx, np.int32).reshape(-1, 4))
        per_kind[1].append(tetrahedral_centers(m))
        per_kind[2].append(np.asarray(find_double_bond_ends(m), np.int32).reshape(-1, 3))
        per_kind[3].append(np.asarray([(s.i, s.j, s.k, s.l) for s in sdbs],
                                      np.int32).reshape(-1, 4))
        per_kind[4].append(chiral_distance_pairs(cidx))
        windows.append(np.stack([clb, cub], axis=1).reshape(-1, 2))
        signs.append(np.asarray([-1.0 if s.is_cis else 1.0 for s in sdbs], np.float32))
    off = np.zeros((len(ARITY), len(mols) + 1), np.int32)
    for k, parts in enumerate(per_kind):
        off[k, 1:] = np.cumsum([len(p) for p in parts])

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return CheckTables(
        offsets=t(off, np.int32),
        atoms=tuple(t(np.concatenate(p).reshape(-1, a), np.int32)
                    for p, a in zip(per_kind, ARITY)),
        windows=t(np.concatenate(windows).reshape(-1, 2), np.float32),
        signs=t(np.concatenate(signs), np.float32))


def _expand(tables: CheckTables, sys2mol: torch.Tensor, a_pad: int):
    """Per kind: (system of each term, flat atom indices into [S * a_pad],
    the term's index in its table)."""
    dev = tables.offsets.device
    s2m = sys2mol.to(dev, torch.int64)
    systems = torch.arange(s2m.shape[0], device=dev)
    out = []
    for k in range(len(ARITY)):
        off = tables.offsets[k].to(torch.int64)
        count = (off[1:] - off[:-1])[s2m]
        sys_of = torch.repeat_interleave(systems, count)
        first = torch.cumsum(count, 0) - count
        term = off[s2m][sys_of] + torch.arange(sys_of.shape[0], device=dev) - first[sys_of]
        atoms = tables.atoms[k].to(torch.int64)[term] + (sys_of * a_pad)[:, None]
        out.append((sys_of, atoms, term))
    return out


def _all_per_system(fail: torch.Tensor, sys_of: torch.Tensor, n_sys: int) -> torch.Tensor:
    bad = torch.zeros(n_sys, dtype=torch.int32, device=fail.device)
    bad.index_add_(0, sys_of, fail.to(torch.int32))
    return bad == 0


def _quantities(pos3, ub, lb, sys2mol, n_atoms_sys, tables):
    """Each check's compared quantities, in the dtype of ``pos3``."""
    S, A, _ = pos3.shape
    s2m = sys2mol.to(pos3.device, torch.int64)
    ubs, lbs = ub[s2m].to(pos3.dtype), lb[s2m].to(pos3.dtype)
    mask = torch.arange(A, device=pos3.device)[None] < n_atoms_sys.to(pos3.device)[:, None]
    tri = torch.ones((A, A), dtype=torch.bool, device=pos3.device).triu(1)
    pair_mask = mask[:, :, None] & mask[:, None, :] & tri[None]
    diff = pos3[:, :, None, :] - pos3[:, None, :, :]
    d = torch.sqrt((diff * diff).sum(dim=-1) + 1e-12)
    ratio_hi = torch.where(pair_mask, d / torch.clamp_min(ubs, 1e-6) - 1.0, 0.0)
    ratio_lo = torch.where(pair_mask, lbs / torch.clamp_min(d, 1e-6) - 1.0, 0.0)
    worst = torch.maximum(ratio_hi.amax(dim=(1, 2)), ratio_lo.amax(dim=(1, 2)))
    flat = pos3.reshape(-1, 3)
    terms = _expand(tables, sys2mol, A)

    def vol(atoms):
        p = [flat[atoms[:, q]] for q in range(4)]
        v1, v2, v3 = p[0] - p[3], p[1] - p[3], p[2] - p[3]
        scale = v1.norm(dim=-1) * v2.norm(dim=-1) * v3.norm(dim=-1)
        return (v1 * torch.linalg.cross(v2, v3)).sum(dim=-1), scale

    cvol, cscale = vol(terms[0][1])
    tvol, tscale = vol(terms[1][1])
    a = terms[2][1]
    u1 = flat[a[:, 1]] - flat[a[:, 0]]
    u2 = flat[a[:, 1]] - flat[a[:, 2]]
    n1 = torch.sqrt((u1 * u1).sum(-1) + 1e-12)
    n2 = torch.sqrt((u2 * u2).sum(-1) + 1e-12)
    ddot = (u1 * u2).sum(-1) / (n1 * n2)
    a = terms[3][1]
    axis = flat[a[:, 2]] - flat[a[:, 1]]
    c1 = torch.linalg.cross(flat[a[:, 0]] - flat[a[:, 1]], axis)
    c2 = torch.linalg.cross(flat[a[:, 3]] - flat[a[:, 2]], axis)
    denom = torch.sqrt((c1 * c1).sum(-1) * (c2 * c2).sum(-1) + 1e-12)
    cosang = (c1 * c2).sum(-1) / denom
    sys_cd, a, _ = terms[4]
    cdiff = flat[a[:, 0]] - flat[a[:, 1]]
    cdist = torch.sqrt((cdiff * cdiff).sum(-1) + 1e-12)
    local = a - (sys_cd * A)[:, None]
    cd_mol = s2m[sys_cd]
    cd_ub = ub[cd_mol, local[:, 0], local[:, 1]].to(pos3.dtype)
    cd_lb = lb[cd_mol, local[:, 0], local[:, 1]].to(pos3.dtype)
    return {"worst": worst, "terms": terms, "cvol": cvol, "cscale": cscale, "tvol": tvol,
            "tscale": tscale, "ddot": ddot, "cosang": cosang, "cdist": cdist, "cd_ub": cd_ub,
            "cd_lb": cd_lb}


def embed_checks_plain(pos3, ub, lb, sys2mol, n_atoms_sys, tables: CheckTables,
                       max_violation_ratio: float, min_tetra_volume: float) -> torch.Tensor:
    """bool [6, S]: the checks (order :data:`CHECKS`) of the systems at
    ``pos3`` [S, A, 3], system s being molecule ``sys2mol[s]`` with
    ``n_atoms_sys[s]`` real atoms, of the smoothed ``ub``/``lb`` [M, A, A]."""
    S = pos3.shape[0]
    q = _quantities(pos3, ub, lb, sys2mol, n_atoms_sys, tables)
    terms = q["terms"]
    win = tables.windows.to(pos3.dtype)[terms[0][2]]
    c_ok = (q["cvol"] >= win[:, 0]) & (q["cvol"] <= win[:, 1])
    t_ok = q["tvol"].abs() > min_tetra_volume
    g_ok = (q["ddot"] + 1.0) >= 1e-3
    s_ok = (tables.signs.to(pos3.dtype)[terms[3][2]] * q["cosang"]) <= 0.0
    cdist, cu, cl = q["cdist"], q["cd_ub"], q["cd_lb"]
    slack = 0.1 * cu
    bad = ((cdist < cl) & (cl - cdist > slack)) | ((cdist > cu) & (cdist - cu > slack))
    return torch.stack([q["worst"] < max_violation_ratio] + [
        _all_per_system(~ok, terms[k][0], S)
        for k, ok in enumerate((c_ok, t_ok, g_ok, s_ok, ~bad))])


def near_threshold_plain(pos3, ub, lb, sys2mol, n_atoms_sys, tables: CheckTables,
                         max_violation_ratio: float, min_tetra_volume: float) -> torch.Tensor:
    """bool [6, S]: a term of the check lies within NEAR (relative to its
    scale) of its threshold, computed in float64."""
    S = pos3.shape[0]
    q = _quantities(pos3.double(), ub.double(), lb.double(), sys2mol, n_atoms_sys, tables)
    terms = q["terms"]
    win = tables.windows.double()[terms[0][2]]
    c_near = torch.minimum((q["cvol"] - win[:, 0]).abs(),
                           (q["cvol"] - win[:, 1]).abs()) <= NEAR * (q["cscale"] + 1.0)
    t_near = (q["tvol"].abs() - min_tetra_volume).abs() <= NEAR * (q["tscale"] + 1.0)
    g_near = (q["ddot"] + 1.0 - 1e-3).abs() <= NEAR
    s_near = q["cosang"].abs() <= NEAR
    cdist, cu, cl = q["cdist"], q["cd_ub"], q["cd_lb"]
    cd_near = torch.minimum((cl - cdist - 0.1 * cu).abs(),
                            (cdist - cu - 0.1 * cu).abs()) <= NEAR * (cu + 1.0)
    near = [(q["worst"] - max_violation_ratio).abs() <= NEAR * (1.0 + max_violation_ratio)]
    for k, nr in enumerate((c_near, t_near, g_near, s_near, cd_near)):
        near.append(~_all_per_system(nr, terms[k][0], S))
    return torch.stack(near)


def check_list(tables: CheckTables, sys2mol) -> dict[str, np.ndarray]:
    """K12's terms as one list a system over the five tables in order
    (``csrc/embed_checks.cu``): per entry (every term of every system once)
    its ``system``, ``kind``, table ``row`` and list index ``entry`` (a warp
    per system: lane entry mod 32)."""
    off = tables.offsets.cpu().numpy().astype(np.int64)
    s2m = np.asarray(sys2mol.cpu() if torch.is_tensor(sys2mol) else sys2mol, np.int64)
    counts = (off[:, 1:] - off[:, :-1])[:, s2m]
    start = np.zeros((len(ARITY) + 1, len(s2m)), np.int64)
    np.cumsum(counts, axis=0, out=start[1:])
    parts = []
    for k in range(len(ARITY)):
        sys_of = np.repeat(np.arange(len(s2m)), counts[k])
        first = np.cumsum(counts[k]) - counts[k]
        within = np.arange(len(sys_of)) - first[sys_of]
        parts.append((sys_of, np.full(len(sys_of), k), off[k, s2m[sys_of]] + within,
                      start[k, sys_of] + within))
    system, kind, row, entry = (np.concatenate(c) for c in zip(*parts))
    return {"system": system, "kind": kind, "row": row, "entry": entry}


def diagonal_walk(n: int) -> tuple[np.ndarray, np.ndarray]:
    """K12's walk over the pairs i < j of n atoms (``csrc/embed_checks.cu``):
    round d (1 <= d <= n / 2) takes diagonal d's pairs (a, a + d), a < n -
    d, then diagonal n - d's (a, a + n - d), a < d (at even n the last round
    only the first part); entry t of the rounds laid end to end is pair t
    mod n of round 1 + t / n, lane l of a warp taking entries l, l + 32, ...
    Returns the entries' (a, diagonal) in order, int64 [n (n - 1) / 2]."""
    t = np.arange(n * (n - 1) // 2, dtype=np.int64)
    d, at = 1 + t // max(n, 1), t % max(n, 1)
    near = at < n - d
    return np.where(near, at, at - (n - d)), np.where(near, d, n - d)


def embed_checks_model(pos3, diag, sys2mol, n_atoms_sys, tables: CheckTables,
                       max_violation_ratio: float, min_tetra_volume: float) -> torch.Tensor:
    """bool [6, S]: K12's order of work on the CPU, in float32. Per system of
    n atoms the pairs i < j as :func:`diagonal_walk` takes them, a warp's
    step at a time, each pair's (u, l) read from ``diag`` [M, A, A, 2] (the
    bounds by diagonals) at [j - i, i],
    the ratio tests as comparisons against products of squares, d^2 < ((1 +
    r) max(u, 1e-6))^2 and l |l| < (1 + r)^2 max(d^2, 1e-12), with r > 0
    (NaN fails); the five
    tables as one list (:func:`check_list`), each term's test as the plain
    version's, the chiral distances' bounds from ``diag``; each check's
    flag the OR of its failures (the warp votes)."""
    S, A, _ = pos3.shape
    x = pos3.to(torch.float32)
    s2m = sys2mol.to(torch.int64).cpu()
    n_sys = n_atoms_sys.to(torch.int64).cpu()
    ul = diag.to(torch.float32)
    r1 = torch.tensor(1.0 + max_violation_ratio, dtype=torch.float32)
    bad = torch.zeros((6, S), dtype=torch.bool)
    for n in torch.unique(n_sys).tolist():
        rows = torch.nonzero(n_sys == n)[:, 0]
        xs, mols = x[rows], s2m[rows]
        walk_a, walk_e = (torch.from_numpy(v) for v in diagonal_walk(n))
        for t0 in range(0, len(walk_a), 32):  # a warp's step
            a, e = walk_a[t0:t0 + 32], walk_e[t0:t0 + 32]
            b = ul[mols[:, None], e[None], a[None]]  # [R, P, 2]
            d3 = xs[:, a] - xs[:, a + e]
            d2 = (d3 * d3).sum(-1) + 1e-12
            hu = r1 * torch.clamp_min(b[..., 0], 1e-6)
            low = b[..., 1]
            fail = ~(d2 < hu * hu) | ~(low * low.abs() < r1 * r1 * torch.clamp_min(d2, 1e-12))
            bad[0, rows] |= fail.any(dim=1)
    if not max_violation_ratio > 0.0:
        bad[0] = True
    lst = check_list(tables, s2m)
    flat = x.reshape(-1, 3)
    for k in range(len(ARITY)):
        sel = lst["kind"] == k
        if not sel.any():
            continue
        system = torch.from_numpy(lst["system"][sel])
        row = torch.from_numpy(lst["row"][sel])
        a = tables.atoms[k].cpu().to(torch.int64)[row]
        p = [flat[a[:, q] + system * A] for q in range(ARITY[k])]
        if k in (0, 1):
            v1, v2, v3 = p[0] - p[3], p[1] - p[3], p[2] - p[3]
            vol = (v1 * torch.linalg.cross(v2, v3)).sum(-1)
            if k == 0:
                win = tables.windows.cpu()[row]
                ok = (vol >= win[:, 0]) & (vol <= win[:, 1])
            else:
                ok = vol.abs() > min_tetra_volume
        elif k == 2:
            u1, u2 = p[1] - p[0], p[1] - p[2]
            n1 = torch.sqrt((u1 * u1).sum(-1) + 1e-12)
            n2 = torch.sqrt((u2 * u2).sum(-1) + 1e-12)
            ok = (u1 * u2).sum(-1) / (n1 * n2) + 1.0 >= 1e-3
        elif k == 3:
            axis = p[2] - p[1]
            c1 = torch.linalg.cross(p[0] - p[1], axis)
            c2 = torch.linalg.cross(p[3] - p[2], axis)
            cosang = (c1 * c2).sum(-1) / torch.sqrt((c1 * c1).sum(-1) * (c2 * c2).sum(-1) + 1e-12)
            ok = tables.signs.cpu()[row] * cosang <= 0.0
        else:
            dd = p[0] - p[1]
            dist = torch.sqrt((dd * dd).sum(-1) + 1e-12)
            lo, hi = torch.minimum(a[:, 0], a[:, 1]), torch.maximum(a[:, 0], a[:, 1])
            b = ul[s2m[system], hi - lo, lo]
            u, l = b[:, 0], b[:, 1]
            ok = ~(((dist < l) & (l - dist > 0.1 * u)) | ((dist > u) & (dist - u > 0.1 * u)))
        bad[k + 1] |= torch.zeros(S, dtype=torch.int32).index_add_(0, system, (~ok).int()) > 0
    return ~bad


def embed_checks(pos3, ub, lb, sys2mol, n_atoms_sys, tables: CheckTables,
                 max_violation_ratio: float, min_tetra_volume: float, *,
                 diag: torch.Tensor | None = None) -> torch.Tensor:
    """bool [6, S]: K12 for CUDA tensors, the plain version for CPU
    tensors (arguments as :func:`embed_checks_plain`'s). K12 reads the
    bounds as (u, l) by diagonals: ``diag`` [M, A, A, 2]
    (``models/dist_geom.diagonal_bounds(ub, lb)``, which a DG batch holds
    as ``DGBatch.diag``), made here when not given."""
    if not pos3.is_cuda:
        return embed_checks_plain(pos3, ub, lb, sys2mol, n_atoms_sys, tables,
                                  max_violation_ratio, min_tetra_volume)
    return _launch(pos3, ub, lb, sys2mol, n_atoms_sys, tables, max_violation_ratio,
                   min_tetra_volume, diag, False)[0]


def launch_clocked(pos3, ub, lb, sys2mol, n_atoms_sys, tables: CheckTables,
                   max_violation_ratio: float, min_tetra_volume: float, *,
                   diag: torch.Tensor | None = None):
    """K12 (CUDA tensors) with each warp's cycles per phase: (bool [6, S],
    int64 [S, warps per system, len(K12_PHASES)])."""
    return _launch(pos3, ub, lb, sys2mol, n_atoms_sys, tables, max_violation_ratio,
                   min_tetra_volume, diag, True)


def _launch(pos3, ub, lb, sys2mol, n_atoms_sys, tables, max_violation_ratio, min_tetra_volume,
            diag, clocked: bool):
    from nvmolkit_tpu_torch._build import embed_checks_lib
    from nvmolkit_tpu_torch.models.dist_geom import diagonal_bounds

    S, A = pos3.shape[:2]
    if pos3.shape[2] != 3 or pos3.dtype != torch.float32 or ub.shape[1:] != (A, A):
        raise ValueError(f"K12 takes float32 positions [S, A, 3] and bounds [M, A, A], got "
                         f"{tuple(pos3.shape)} {pos3.dtype} and {tuple(ub.shape)}")
    if sys2mol.dtype != torch.int32 or n_atoms_sys.dtype != torch.int32:
        raise ValueError("K12 takes int32 sys2mol and atom counts")
    if diag is None:
        diag = diagonal_bounds(ub, lb)
    if diag.shape != (ub.shape[0], A, A, 2) or diag.dtype != torch.float32:
        raise ValueError(f"K12 takes the bounds by diagonals float32 [M, A, A, 2], got "
                         f"{tuple(diag.shape)} {diag.dtype}")
    tensors = (pos3, diag, sys2mol, n_atoms_sys, tables.offsets, tables.windows,
               tables.signs) + tables.atoms
    for t in tensors:
        if t.device != pos3.device or not t.is_contiguous():
            raise ValueError("K12's inputs must be contiguous and on one device")
    ok = torch.empty((len(CHECKS), S), dtype=torch.uint8, device=pos3.device)
    block = A > WARP_MAX_ATOMS
    cycles = (torch.zeros((S, 4 if block else 1, len(K12_PHASES)), dtype=torch.int64,
                          device=pos3.device) if clocked else None)
    ptrs = tables.atoms + (tables.windows, tables.signs)
    table_ptrs = (ctypes.c_void_p * len(ptrs))(*[t.data_ptr() for t in ptrs])
    with torch.cuda.device(pos3.device):
        rc = embed_checks_lib().nvmk_embed_checks(
            pos3.data_ptr(), S, A, sys2mol.data_ptr(), n_atoms_sys.data_ptr(), diag.data_ptr(),
            tables.offsets.shape[1] - 1, table_ptrs, float(max_violation_ratio),
            float(min_tetra_volume), tables.offsets.data_ptr(), int(block), ok.data_ptr(),
            None if cycles is None else cycles.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"embed_checks kernel launch failed with CUDA error {rc}")
    launch_counts["embed_checks"] += 1
    return ok.bool(), cycles
