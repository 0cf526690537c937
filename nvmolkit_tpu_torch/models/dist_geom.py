"""Distance geometry: the 4-D force field (kernel K11), coordinate generation
(kernel K10) and the chiral sets, with their plain PyTorch versions.

The port's counterpart of ``nvmolkit_tpu/models/dist_geom.py``:

* :class:`DGBatch` holds, per unique molecule of a chunk, the smoothed
  bounds [M, A, A] and the chiral quartets with their volume windows as a
  flat table with CSR offsets; the systems carry ``sys2mol``. The weights
  of the chiral and fourth-dimension terms ride on the batch (the two
  embedding stages use two weightings of one batch, :meth:`DGBatch.weighted`).
* :func:`dg_energy_and_grad` launches K11 (``csrc/dist_geom.cu``) for CUDA
  tensors and runs :func:`dg_energy_and_grad_plain` (``dg_energy``'s terms
  in torch, the gradient by ``torch.autograd.grad``) for CPU tensors. K5,
  K23 and K8 minimize over K11's device function (:data:`DG`, 4 coordinates
  per atom).
* :func:`random_distance_matrices` launches K10 (``csrc/coordgen.cu``) for
  CUDA tensors and runs :func:`random_distance_matrices_plain` for CPU
  tensors: distance matrices drawn within the bounds, double centering, the
  top-4 eigenpairs by block power iteration with a Rayleigh-Ritz finish
  (:func:`top_k_eig_power_plain`), and the coordinates. The uniforms come
  from the caller's ``torch.Generator`` (:func:`draw_uniforms`).
* :func:`build_chiral_sets` is the JAX package's host function, copied.

A build or launch failure raises. ``launch_counts`` counts K10's and K11's
launches (K5's and K8's are counted by their modules).
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from nvmolkit_tpu_torch._build import coordgen_lib, dist_geom_lib
from nvmolkit_tpu_torch.models import flat

POWER_ITERS = 40
N_DIMS = 4
# the phases of K10's per-system clock (``_launch_k10(..., phase_cycles=True)``)
K10_PHASES = ("sample", "gq", "gram_schmidt", "wait", "ritz", "output")

launch_counts = {"dg_energy_grad": 0, "coordgen": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


@dataclasses.dataclass(frozen=True)
class DGBatch:
    """The DG terms of M unique molecules of one atom bucket A.

    ``offsets`` int32 [1, M + 1] indexes ``atoms[0]`` (the chiral quartets,
    int32 [C, 4]) and ``params[0]`` (their windows (lb, ub), float32 [C,
    2]); ``params[1]`` and ``params[2]`` are the smoothed upper and lower
    bounds, float32 [M, A, A]."""

    n_atoms: torch.Tensor
    offsets: torch.Tensor
    atoms: tuple
    params: tuple
    max_atoms: int
    chiral_weight: float = 1.0
    fourth_dim_weight: float = 0.1

    @property
    def n_mols(self) -> int:
        return self.n_atoms.shape[0]

    @property
    def upper(self) -> torch.Tensor:
        return self.params[1]

    @property
    def lower(self) -> torch.Tensor:
        return self.params[2]

    def weighted(self, chiral_weight: float, fourth_dim_weight: float) -> "DGBatch":
        return dataclasses.replace(self, chiral_weight=float(chiral_weight),
                                   fourth_dim_weight=float(fourth_dim_weight))


def make_dg_batch(upper: torch.Tensor, lower: torch.Tensor, n_atoms: torch.Tensor,
                  chiral_sets: list) -> DGBatch:
    """A :class:`DGBatch` on the bounds' device from the smoothed bounds
    [M, A, A], the atom counts [M] and each molecule's
    :func:`build_chiral_sets` output."""
    dev = upper.device
    counts = [len(c[0]) for c in chiral_sets]
    off = np.zeros((1, len(chiral_sets) + 1), np.int32)
    off[0, 1:] = np.cumsum(counts)
    idx = np.concatenate([c[0] for c in chiral_sets]).reshape(-1, 4).astype(np.int32)
    win = np.stack([np.concatenate([c[1] for c in chiral_sets]),
                    np.concatenate([c[2] for c in chiral_sets])], axis=1).astype(np.float32)
    return DGBatch(
        n_atoms=n_atoms.to(dev, torch.int32).contiguous(), offsets=torch.from_numpy(off).to(dev),
        atoms=(torch.from_numpy(idx).to(dev),), params=(torch.from_numpy(win).to(dev),
                                                         upper.contiguous(), lower.contiguous()),
        max_atoms=int(upper.shape[1]))


def _chiral_terms(batch: DGBatch, sys2mol: torch.Tensor, a_pad: int):
    """(system of each chiral term, its atoms as flat indices into [S *
    a_pad], its windows)."""
    return flat.expand(batch, sys2mol, a_pad)[0]


def distance_energy_plain(positions: torch.Tensor, batch, sys2mol: torch.Tensor) -> torch.Tensor:
    """The distance terms of ``dg_energy`` [S] at ``positions`` [S, A, D]
    (any D), under the smoothed bounds ``batch.upper``/``batch.lower`` of
    each system's molecule (the DG and the ETK force fields)."""
    S, A, D = positions.shape
    s2m = sys2mol.to(positions.device, torch.int64)
    ub = batch.upper[s2m]
    lb = batch.lower[s2m]
    ub2, lb2 = ub * ub, lb * lb
    mask = flat.atom_mask(batch, sys2mol.to(batch.n_atoms.device), A).to(positions.device)
    tri = torch.ones((A, A), dtype=torch.bool, device=positions.device).triu(1)
    pair_mask = mask[:, :, None] & mask[:, None, :] & tri[None]
    d2 = None
    for c in range(D):
        pc = positions[..., c]
        dc = pc[:, :, None] - pc[:, None, :]
        d2 = dc * dc if d2 is None else d2 + dc * dc
    upper_viol = torch.where(d2 > ub2, d2 / torch.clamp_min(ub2, 1e-8) - 1.0, 0.0)
    lower_viol = torch.where(d2 < lb2, 2.0 * lb2 / torch.clamp_min(lb2 + d2, 1e-8) - 1.0, 0.0)
    v = upper_viol + lower_viol
    return torch.where(pair_mask, v * v, 0.0).sum(dim=(1, 2))


def dg_energy_plain(positions: torch.Tensor, batch: DGBatch, sys2mol: torch.Tensor,
                    terms=None) -> torch.Tensor:
    """Per-system energy [S] of ``positions`` [S, A, D], as the JAX
    ``dg_energy`` computes it."""
    S, A, D = positions.shape
    e = distance_energy_plain(positions, batch, sys2mol)

    sys_of, atoms, win = terms if terms is not None else _chiral_terms(batch, sys2mol, A)
    p = positions.reshape(-1, D)[:, :3]
    pts = [p[atoms[:, q]] for q in range(4)]
    v1, v2, v3 = pts[0] - pts[3], pts[1] - pts[3], pts[2] - pts[3]
    vol = (v1 * torch.linalg.cross(v2, v3)).sum(dim=-1)
    lo, hi = win[:, 0].to(vol.dtype), win[:, 1].to(vol.dtype)
    viol = torch.where(vol < lo, lo - vol, torch.where(vol > hi, vol - hi, 0.0))
    e_chiral = torch.zeros_like(e).index_add_(0, sys_of, viol * viol)
    e = e + batch.chiral_weight * e_chiral
    if D > 3:
        x4 = positions[..., 3]
        e = e + batch.fourth_dim_weight * (x4 * x4).sum(dim=1)
    return e


def plain_energy_and_grad_fn(batch: DGBatch, sys2mol: torch.Tensor, a_pad: int):
    """``fn(positions) -> (energy [S], gradient [S, a_pad, D])``, the
    gradient by autograd of :func:`dg_energy_plain`, zero outside each
    system's atoms (the chiral index is built once)."""
    terms = _chiral_terms(batch, sys2mol, a_pad)
    mask = flat.atom_mask(batch, sys2mol.to(batch.n_atoms.device), a_pad)[..., None]

    def energy_and_grad(positions: torch.Tensor):
        with torch.enable_grad():
            x = positions.detach().requires_grad_(True)
            e = dg_energy_plain(x, batch, sys2mol, terms)
            (g,) = torch.autograd.grad(e.sum(), x)
        return e.detach(), torch.where(mask.to(g.device), g, 0.0)

    return energy_and_grad


def dg_energy_and_grad_plain(positions: torch.Tensor, batch: DGBatch, sys2mol: torch.Tensor):
    return plain_energy_and_grad_fn(batch, sys2mol, positions.shape[1])(positions)


def distance_grad_magnitude_plain(x: torch.Tensor, batch, sys2mol: torch.Tensor) -> torch.Tensor:
    """Per gradient component, the sum over the distance terms of
    |dE_term/dx| [S, A, D] at ``x`` (float64, as the batch's bounds)."""
    S, A, D = x.shape
    s2m = sys2mol.to(x.device, torch.int64)
    ub2, lb2 = batch.upper[s2m] ** 2, batch.lower[s2m] ** 2
    mask = flat.atom_mask(batch, sys2mol.to(batch.n_atoms.device), A).to(x.device)
    pair = mask[:, :, None] & mask[:, None, :]
    pair &= ~torch.eye(A, dtype=torch.bool, device=x.device)[None]
    diff = x[:, :, None, :] - x[:, None, :, :]
    d2 = (diff * diff).sum(-1)
    v = torch.where(d2 > ub2, d2 / torch.clamp_min(ub2, 1e-8) - 1.0, 0.0)
    dv = torch.where(d2 > ub2, 1.0 / torch.clamp_min(ub2, 1e-8), 0.0)
    s = torch.clamp_min(lb2 + d2, 1e-8)
    v = v + torch.where(d2 < lb2, 2.0 * lb2 / s - 1.0, 0.0)
    dv = dv - torch.where(d2 < lb2, 2.0 * lb2 / (s * s), 0.0)
    coef = torch.where(pair, (4.0 * v * dv).abs(), 0.0)
    return (coef[..., None] * diff.abs()).sum(dim=2)


def dg_grad_magnitude_plain(positions: torch.Tensor, batch: DGBatch,
                            sys2mol: torch.Tensor) -> torch.Tensor:
    """Per gradient component, the sum over terms of |dE_term/dx| [S, A, D]
    (float64): the scale of float32 rounding in a gradient whose terms
    cancel. (Every term is >= 0, so the energy itself is the sum of
    |E_term|.)"""
    x = positions.detach().double()
    S, A, D = x.shape
    b64 = dataclasses.replace(batch, params=tuple(t.double() for t in batch.params))
    mask = flat.atom_mask(batch, sys2mol.to(batch.n_atoms.device), A).to(x.device)
    out = distance_grad_magnitude_plain(x, b64, sys2mol)
    if D > 3:
        out[..., 3] += (2.0 * batch.fourth_dim_weight * x[..., 3]).abs()
    sys_of, atoms, win = _chiral_terms(b64, sys2mol, A)
    with torch.enable_grad():
        p = [x.reshape(-1, D)[atoms[:, q], :3].requires_grad_(True) for q in range(4)]
        vol = ((p[0] - p[3]) * torch.linalg.cross(p[1] - p[3], p[2] - p[3])).sum(-1)
        viol = torch.where(vol < win[:, 0], win[:, 0] - vol,
                           torch.where(vol > win[:, 1], vol - win[:, 1], 0.0))
        e = batch.chiral_weight * viol * viol
        grads = torch.autograd.grad(e.sum(), p)
    flat_out = out.reshape(-1, D)
    for q in range(4):
        flat_out[:, :3].index_add_(0, atoms[:, q], grads[q].abs().to(flat_out.dtype))
    return torch.where(mask[..., None], out, 0.0)


def dg_energy_and_grad(positions: torch.Tensor, batch: DGBatch, sys2mol: torch.Tensor):
    """(energy [S], gradient [S, A, 4]) of ``positions`` [S, A, 4], system s
    being molecule ``sys2mol[s]`` (int32) of ``batch``; the gradient is zero
    outside each system's atoms. K11 for CUDA tensors, the plain version for
    CPU tensors."""
    if not positions.is_cuda:
        return dg_energy_and_grad_plain(positions, batch, sys2mol)
    flat.check_kernel_inputs(positions, batch, sys2mol, "K11",
                             flat.kernel_dim(dist_geom_lib(), "dg"))
    n_sys, a_pad = positions.shape[:2]
    if a_pad != batch.max_atoms:
        raise ValueError(f"K11 takes positions of the batch's {batch.max_atoms} atoms, got {a_pad}")
    dev = positions.device
    energy = torch.empty(n_sys, dtype=torch.float32, device=dev)
    grad = torch.empty_like(positions)
    count = flat.system_atoms(batch, sys2mol)
    with torch.cuda.device(dev):
        rc = dist_geom_lib().nvmk_dg_energy_grad(
            positions.data_ptr(), n_sys, a_pad, sys2mol.data_ptr(), count.data_ptr(),
            batch.offsets.data_ptr(), batch.n_mols, flat.table_pointers(batch),
            batch.chiral_weight, batch.fourth_dim_weight, energy.data_ptr(), grad.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dg_energy_grad kernel launch failed with CUDA error {rc}")
    launch_counts["dg_energy_grad"] += 1
    return energy, grad


def _weights(batch: DGBatch):
    return (ctypes.c_float(batch.chiral_weight), ctypes.c_float(batch.fourth_dim_weight))


DG = flat.ForceField("dg", dg_energy_and_grad, plain_energy_and_grad_fn, dist_geom_lib,
                     _weights)


# ---------------------------------------------------------------------------
# coordinate generation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Uniforms:
    """The uniform draws of one coordinate generation: ``pairs`` [S, A, A]
    (the upper triangle is read), ``q0`` and ``neg`` [S, A, 4]."""

    pairs: torch.Tensor
    q0: torch.Tensor
    neg: torch.Tensor


def draw_uniforms(generator: torch.Generator, n_sys: int, a_pad: int, device) -> Uniforms:
    """Uniforms in [0, 1) from ``generator`` (on ``device``)."""
    def draw(*shape):
        return torch.rand(shape, generator=generator, device=device, dtype=torch.float32)

    return Uniforms(pairs=draw(n_sys, a_pad, a_pad), q0=draw(n_sys, a_pad, N_DIMS),
                    neg=draw(n_sys, a_pad, N_DIMS))


def top_k_eig_power_plain(g: torch.Tensor, atom_mask: torch.Tensor, q0_uniform: torch.Tensor,
                          iters: int = POWER_ITERS):
    """The top-k eigenpairs of the symmetric ``g`` [S, A, A] (zero padded),
    as the JAX ``_top_k_eig_power`` computes them from the start
    ``q0_uniform - 0.5`` [S, A, k]: (values [S, k] descending, vectors [S,
    A, k])."""
    k = q0_uniform.shape[2]
    q0 = (q0_uniform - 0.5) * atom_mask[..., None].to(g.dtype)

    def orthonormalize(z):
        cols = []
        for j in range(k):
            v = z[:, :, j]
            for q in cols:
                v = v - (q * v).sum(dim=1, keepdim=True) * q
            v = v / torch.sqrt((v * v).sum(dim=1, keepdim=True) + 1e-12)
            cols.append(v)
        return torch.stack(cols, dim=2)

    q = orthonormalize(q0)
    for _ in range(iters):
        q = orthonormalize(torch.bmm(g, q))
    gq = torch.bmm(g, q)
    b = torch.bmm(q.transpose(1, 2), gq)
    b = 0.5 * (b + b.transpose(1, 2))
    ritz_vals, w = torch.linalg.eigh(b)                    # ascending
    return ritz_vals.flip(1), torch.bmm(q, w.flip(2))


def metric_matrices_plain(upper: torch.Tensor, lower: torch.Tensor, atom_mask: torch.Tensor,
                          u_pairs: torch.Tensor) -> torch.Tensor:
    """The metric matrices [S, A, A] of the distance matrices drawn within
    the per-system bounds ``upper``/``lower`` [S, A, A] from ``u_pairs``."""
    A = upper.shape[1]
    u = torch.triu(u_pairs, 1)
    u = u + u.transpose(1, 2)
    d = lower + u * (upper - lower)
    d = torch.where(torch.eye(A, dtype=torch.bool, device=d.device), 0.0, d)
    pair_mask = atom_mask[:, :, None] & atom_mask[:, None, :]
    d = torch.where(pair_mask, d, 0.0)
    d2 = d * d
    n_real = torch.clamp_min(atom_mask.sum(dim=1), 1).to(d2.dtype)[:, None, None]
    row = d2.sum(dim=2, keepdim=True) / n_real
    col = d2.sum(dim=1, keepdim=True) / n_real
    grand = d2.sum(dim=(1, 2), keepdim=True) / (n_real * n_real)
    return torch.where(pair_mask, -0.5 * (d2 - row - col + grand), 0.0)


def project_plain(g: torch.Tensor, atom_mask: torch.Tensor, uniforms: Uniforms,
                  box_size_mult: float, rand_neg_eig: bool, num_zero_fail: int,
                  iters: int = POWER_ITERS):
    """(coords [S, A, 4], eig_ok [S] bool, eigenvalues [S, 4]) of the metric
    matrices ``g``, as the JAX ``random_distance_matrices`` projects them."""
    top_vals, top_vecs = top_k_eig_power_plain(g, atom_mask, uniforms.q0, iters)
    coords = top_vecs * torch.sqrt(torch.clamp_min(top_vals, 0.0))[:, None, :]
    if rand_neg_eig:
        rand = (uniforms.neg - 0.5) * box_size_mult
        coords = torch.where((top_vals > 1e-6)[:, None, :], coords, rand)
    else:
        coords = torch.where((top_vals > 0.0)[:, None, :], coords, 0.0)
    coords = torch.where(atom_mask[..., None], coords, 0.0)
    ok = torch.ones(g.shape[0], dtype=torch.bool, device=g.device)
    if num_zero_fail > 0:
        n_pts = torch.clamp_min(atom_mask.sum(dim=1), 1)
        achievable = torch.clamp_max(n_pts - 1, N_DIMS)
        in_rank = torch.arange(N_DIMS, device=g.device)[None, :] < achievable[:, None]
        tol = 1e-4 * torch.clamp_min(top_vals[:, :1], 1e-12)
        n_zero = ((top_vals <= tol) & in_rank).sum(dim=1)
        ok = n_zero < num_zero_fail
    return coords, ok, top_vals


def random_distance_matrices_plain(batch: DGBatch, sys2mol: torch.Tensor, uniforms: Uniforms,
                                   box_size_mult: float = 2.0, rand_neg_eig: bool = True,
                                   num_zero_fail: int = 0, iters: int = POWER_ITERS):
    """(coords [S, A, 4], eig_ok [S] bool, eigenvalues [S, 4]) as the JAX
    ``random_distance_matrices`` computes them from these uniforms."""
    A = batch.max_atoms
    s2m = sys2mol.to(batch.upper.device, torch.int64)
    mask = flat.atom_mask(batch, sys2mol.to(batch.n_atoms.device), A)
    g = metric_matrices_plain(batch.upper[s2m], batch.lower[s2m], mask, uniforms.pairs)
    return project_plain(g, mask, uniforms, box_size_mult, rand_neg_eig, num_zero_fail, iters)


def coordgen_info(a_pad: int) -> dict:
    """K10's instantiation at ``a_pad`` (``csrc/coordgen.cu``: a warp per
    system up to 192 atoms, with G in registers at the buckets of 64 atoms
    and under, a block of 128 threads per system above): registers and
    spilled bytes a thread, resident blocks an SM, shared bytes a block,
    systems a block and an SM, and the layout."""
    out = (ctypes.c_int * 6)()
    rc = coordgen_lib().nvmk_coordgen_info(a_pad, out)
    if rc != 0:
        raise RuntimeError(f"nvmk_coordgen_info failed with CUDA error {rc}")
    return {"registers": out[0], "local_bytes": out[1], "blocks_per_sm": out[2],
            "shared_bytes": out[3], "systems_per_block": out[4],
            "systems_per_sm": out[2] * out[4],
            "layout": ("block per system", "warp per system, G in shared memory",
                       "warp per system, G in registers")[out[5]]}


def _launch_k10(batch_or_none, g_in, n_atoms_sys, sys2mol, uniforms: Uniforms, a_pad: int,
                box_size_mult, rand_neg_eig, num_zero_fail, iters, phase_cycles: bool = False):
    """One K10 launch: (coords, eig_ok, eigenvalues), and with
    ``phase_cycles`` also int64 [S, 6] cycles of :data:`K10_PHASES` per
    system."""
    dev = uniforms.q0.device
    n_sys = uniforms.q0.shape[0]
    coords = torch.empty((n_sys, a_pad, N_DIMS), dtype=torch.float32, device=dev)
    vals = torch.empty((n_sys, N_DIMS), dtype=torch.float32, device=dev)
    ok = torch.empty(n_sys, dtype=torch.uint8, device=dev)
    gbuf = (torch.empty(n_sys * a_pad * (a_pad + 1), dtype=torch.float32, device=dev)
            if a_pad > 192 else None)
    cycles = (torch.zeros((n_sys, len(K10_PHASES)), dtype=torch.int64, device=dev)
              if phase_cycles else None)
    tensors = [uniforms.q0, uniforms.neg, n_atoms_sys] + (
        [g_in] if g_in is not None else [uniforms.pairs, batch_or_none.upper,
                                         batch_or_none.lower, sys2mol])
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("K10's inputs must be contiguous and on one device")

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        rc = coordgen_lib().nvmk_coordgen(
            ptr(None if batch_or_none is None else batch_or_none.upper),
            ptr(None if batch_or_none is None else batch_or_none.lower), ptr(g_in),
            ptr(None if g_in is not None else uniforms.pairs), uniforms.q0.data_ptr(),
            uniforms.neg.data_ptr(), n_sys, a_pad, ptr(sys2mol), n_atoms_sys.data_ptr(),
            int(iters), float(box_size_mult), int(bool(rand_neg_eig)), int(num_zero_fail),
            coords.data_ptr(), vals.data_ptr(), ok.data_ptr(), ptr(gbuf), ptr(cycles),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"coordgen kernel launch failed with CUDA error {rc}")
    launch_counts["coordgen"] += 1
    if phase_cycles:
        return coords, ok.bool(), vals, cycles
    return coords, ok.bool(), vals


def random_distance_matrices(batch: DGBatch, sys2mol: torch.Tensor, uniforms: Uniforms,
                             box_size_mult: float = 2.0, rand_neg_eig: bool = True,
                             num_zero_fail: int = 0, iters: int = POWER_ITERS):
    """Coordinates [S, A, 4] drawn within the bounds of ``batch`` for the
    systems ``sys2mol`` from ``uniforms``, the rank flag [S] bool (all True
    when ``num_zero_fail`` is 0) and the eigenvalues [S, 4]: K10 for CUDA
    tensors, the plain version for CPU tensors."""
    if not batch.upper.is_cuda:
        return random_distance_matrices_plain(batch, sys2mol, uniforms, box_size_mult,
                                              rand_neg_eig, num_zero_fail, iters)
    if sys2mol.dtype != torch.int32:
        raise ValueError("K10 takes int32 sys2mol")
    return _launch_k10(batch, None, flat.system_atoms(batch, sys2mol), sys2mol, uniforms,
                       batch.max_atoms, box_size_mult, rand_neg_eig, num_zero_fail, iters)


def project(g: torch.Tensor, n_atoms: torch.Tensor, uniforms: Uniforms,
            box_size_mult: float = 2.0, rand_neg_eig: bool = True, num_zero_fail: int = 0,
            iters: int = POWER_ITERS):
    """The projection alone of the metric matrices ``g`` [S, A, A] of
    systems with ``n_atoms`` int32 [S] real atoms: K10 for CUDA tensors,
    :func:`project_plain` for CPU tensors."""
    A = g.shape[1]
    if not g.is_cuda:
        mask = torch.arange(A)[None] < n_atoms.to(torch.int64)[:, None]
        return project_plain(g, mask, uniforms, box_size_mult, rand_neg_eig, num_zero_fail,
                             iters)
    return _launch_k10(None, g.contiguous(), n_atoms, None, uniforms, A, box_size_mult,
                       rand_neg_eig, num_zero_fail, iters)


# ---------------------------------------------------------------------------
# chiral sets (host)
# ---------------------------------------------------------------------------

def build_chiral_sets(mol) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Chiral volume constraints from parsed @/@@ tags (the JAX package's
    ``build_chiral_sets``, copied).

    Returns (idx [C,4], lb [C], ub [C]). For a tagged tetrahedral atom
    the four reference points are its neighbors (implicit-H centers use
    the center atom itself as the fourth point). Volume windows are
    [-limit, -5] or [5, limit] following RDKit's chiral-set convention.
    """
    from nvmolkit_tpu_torch.chem.mol import ChiralTag

    idx, lbs, ubs = [], [], []
    for i, atom in enumerate(mol.atoms):
        if atom.chiral_tag == ChiralTag.NONE:
            continue
        nbrs = mol.neighbors(i)
        if len(nbrs) < 3 or len(nbrs) > 4:
            continue
        pts = list(nbrs[:4])
        if len(pts) == 3:
            pts = [pts[0], pts[1], pts[2], i]
        # @ (CCW) -> positive volume with neighbor order as parsed
        if atom.chiral_tag == ChiralTag.CCW:
            lbs.append(1.0)
            ubs.append(100.0)
        else:
            lbs.append(-100.0)
            ubs.append(-1.0)
        idx.append(pts)
    if not idx:
        return (
            np.zeros((0, 4), np.int32),
            np.zeros(0, np.float32),
            np.zeros(0, np.float32),
        )
    return (
        np.asarray(idx, np.int32),
        np.asarray(lbs, np.float32),
        np.asarray(ubs, np.float32),
    )
