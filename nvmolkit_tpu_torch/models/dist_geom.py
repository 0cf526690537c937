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
import functools

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
    bounds, float32 [M, A, A]; ``params[3]`` their (u, l) by diagonals
    (:func:`diagonal_bounds`), which K11, K13 and K8 read (a batch whose
    bounds are replaced needs it made again)."""

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

    @property
    def diag(self) -> torch.Tensor:
        return self.params[3]

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
        atoms=(torch.from_numpy(idx).to(dev),),
        params=(torch.from_numpy(win).to(dev), upper.contiguous(), lower.contiguous(),
                diagonal_bounds(upper, lower)),
        max_atoms=int(upper.shape[1]))


def diagonal_bounds(upper: torch.Tensor, lower: torch.Tensor) -> torch.Tensor:
    """The smoothed bounds [M, A, A] as (u, l) pairs laid out by diagonals,
    float32 [M, A, A, 2]: the pair a < b at [b - a, a], zero past the
    triangle (``csrc/dg_pairs.cuh`` DiagBounds: a step of the pair walk
    reads at most two runs of consecutive entries)."""
    M, A, _ = upper.shape
    d = torch.arange(A, device=upper.device)[:, None]
    a = torch.arange(A, device=upper.device)[None, :]
    inside = a + d < A
    at = (a * A + torch.clamp(a + d, max=A - 1)).reshape(-1)
    pair = torch.stack([upper.reshape(M, -1)[:, at], lower.reshape(M, -1)[:, at]], dim=-1)
    return torch.where(inside.reshape(1, -1, 1), pair, 0.0).reshape(M, A, A, 2).to(
        torch.float32).contiguous()


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


# ---------------------------------------------------------------------------
# a torch model of K11's and K13's arithmetic (csrc/dg_pairs.cuh)
# ---------------------------------------------------------------------------

THREADS, WARPS = 128, 4
# the phases of K11's and K13's per-warp clock (``phase_cycles=True``;
# csrc/dg_pairs.cuh EvalPhase)
EVAL_PHASES = ("load", "pairs", "adds", "pairs_b", "wait", "terms_a", "terms_b", "sum",
               "write")
DG_ONCE_MAX_ATOMS = 96


@functools.lru_cache(maxsize=None)
def pair_schedule(n: int) -> tuple:
    """The walk of K11 and K13 over the pairs of n atoms (``dg_pairs.cuh``
    PairTiles): its units in order, each (I, J, k, steps), a run of steps of
    tile (I, J) from its k, unit u taken by warp u mod WARPS. At step k of
    tile (I, J) lane l takes the pair (32 I + l, 32 J + (l + k) mod 32)
    (:func:`step_pairs`)."""
    if n < 2:
        return ()
    nb = (n + 31) // 32
    last = min(16, n - 32 * (nb - 1) - 1)
    n_diag = 16 * (nb - 1) + last
    unit = max(1, -(-n_diag // WARPS)) if nb == 1 else (8 if nb % 2 else 16)
    out = []
    for I in range(nb):
        length = last if I == nb - 1 else 16
        out += [(I, I, first + 1, min(unit, length - first)) for first in range(0, length, unit)]
    for I in range(nb):
        for J in range(I + 1, nb):
            out += [(I, J, k, unit) for k in range(0, 32, unit)]
    return tuple(out)


def step_pairs(I: int, J: int, k: int, n: int):
    """Lane l's pair (i, j) at step k of tile (I, J) and whether it is one of
    the n atoms' pairs: three int64/bool [32] arrays."""
    lanes = np.arange(32)
    i, j = 32 * I + lanes, 32 * J + (lanes + k) % 32
    return i, j, (i < n) & (j < n) & ((I != J) | (k < 16) | (lanes < 16))


def _pair_step(x, u2, l2, i, j, valid):
    """One step's pair terms at ``x`` [S, A, D] under the squared bounds
    [S, A, A], as dg_pairs.cuh pair_term: (+dE/dx_i [S, 32, D], E [S, 32]),
    zero off ``valid`` and where nothing is violated; each division a
    reciprocal and a multiply."""
    A = x.shape[1]
    ic, jc = torch.as_tensor(np.minimum(i, A - 1)), torch.as_tensor(np.minimum(j, A - 1))
    lo_i, hi_i = torch.minimum(ic, jc), torch.maximum(ic, jc)
    d = x[:, ic] - x[:, jc]
    d2 = d[..., 0] * d[..., 0]
    for q in range(1, x.shape[2]):
        d2 = d2 + d[..., q] * d[..., q]
    U2, L2 = u2[:, lo_i, hi_i], l2[:, lo_i, hi_i]
    up, low = d2 > U2, d2 < L2
    r_u = torch.reciprocal(torch.clamp_min(U2, 1e-8))
    v = torch.where(up, d2 * r_u - 1.0, 0.0)
    dv = torch.where(up, r_u, 0.0)
    s = L2 + d2
    r_s = torch.reciprocal(torch.clamp_min(s, 1e-8))
    q = 2.0 * L2 * r_s
    v = v + torch.where(low, q - 1.0, 0.0)
    dv = dv - torch.where(low & (s > 1e-8), q * r_s, 0.0)
    on = torch.as_tensor(valid)[None] & (up | low)
    c = 4.0 * v * dv
    return torch.where(on[..., None], c[..., None] * d, 0.0), torch.where(on, v * v, 0.0)


def dealt_pairs_model(step, n: int, w: float, g: torch.Tensor, e_thread: torch.Tensor) -> None:
    """dg_pairs.cuh dealt_pairs on the CPU, for systems of n atoms: each dealt
    unit (:func:`pair_schedule`) with row i's and column j's gradient summed
    over the unit's steps in step order, ``step(i, j, valid)`` giving one
    step's +dE/dx_i [S, 32, D] and energies [S, 32] (zero off ``valid``); the
    unit's rows and columns times ``w`` added into ``g`` [S, A, D] in unit
    order (the kernels' atomics add in an order of their own), and each
    lane's pair energies, summed in its units' order and times ``w``, into
    ``e_thread`` [S, THREADS]."""
    S, _, D = g.shape
    lanes = np.arange(32)
    e_lane = torch.zeros((S, WARPS, 32), dtype=g.dtype)
    for u, (I, J, k0, steps) in enumerate(pair_schedule(n)):
        gi = torch.zeros((S, 32, D), dtype=g.dtype)
        gj = torch.zeros((S, 32, D), dtype=g.dtype)  # by column lane
        for k in range(k0, k0 + steps):
            f, ev = step(*step_pairs(I, J, k, n))
            gi = gi + f
            gj[:, (lanes + k) % 32] = gj[:, (lanes + k) % 32] - f
            e_lane[:, u % WARPS] = e_lane[:, u % WARPS] + ev
        rows, cols = 32 * I + lanes, 32 * J + lanes
        if I == J:
            g[:, rows[rows < n]] += (w * (gi + gj))[:, rows < n]
        else:
            g[:, rows[rows < n]] += (w * gi)[:, rows < n]
            g[:, cols[cols < n]] += (w * gj)[:, cols < n]
    e_thread += w * e_lane.reshape(S, THREADS)


def distance_terms_model(x: torch.Tensor, upper: torch.Tensor, lower: torch.Tensor,
                         n: int, w: float, g: torch.Tensor, e_thread: torch.Tensor) -> None:
    """K13's pair terms of systems of n atoms at ``x`` [S, A, D] under their
    bounds [S, A, A], in the kernel's order (:func:`dealt_pairs_model`), each
    reciprocal taken and multiplied."""
    u2, l2 = upper * upper, lower * lower
    dealt_pairs_model(lambda i, j, valid: _pair_step(x, u2, l2, i, j, valid), n, w, g, e_thread)


def block_total_model(e_thread: torch.Tensor) -> torch.Tensor:
    """dg_pairs.cuh block_total on [S, THREADS] per-thread energies: each
    warp's butterfly sum (shuffles at 16, 8, 4, 2, 1), then the warps' sums
    in order."""
    lanes = torch.arange(32)
    warps = e_thread.reshape(e_thread.shape[0], WARPS, 32)
    for o in (16, 8, 4, 2, 1):
        warps = warps + warps[:, :, lanes ^ o]
    total = warps[:, 0, 0]
    for k in range(1, WARPS):
        total = total + warps[:, k, 0]
    return total


def term_threads(count: int) -> np.ndarray:
    """The thread of each of a molecule's ``count`` terms of one kind in
    K13 (dg_pairs.cuh term_slot): term c on warp c mod 4, lane c / 4 mod 32."""
    c = np.arange(count)
    return (c % WARPS) * 32 + (c // WARPS) % 32


def _systems_by_atoms(batch, sys2mol: torch.Tensor) -> dict:
    counts = flat.system_atoms(batch, sys2mol).cpu().numpy()
    return {int(v): torch.from_numpy(np.nonzero(counts == v)[0]) for v in np.unique(counts)}


def dg_schedule(n: int) -> tuple:
    """K11's schedule of the pairs of n <= DG_ONCE_MAX_ATOMS atoms
    (``dg_pairs.cuh`` DgSchedule): per warp (its unit before the first
    barrier, its rows' and its columns' write (0 stored before the first
    barrier, 1 added between the two, -1 none; a diagonal tile's both with
    its rows), the blocks it owns, each with its diagonal tile added after
    the second barrier); a unit is (I, J, k, steps) or None. Each atom's
    row has one writer at a time."""
    nb = (n + 31) // 32
    last = min(16, n - 32 * (nb - 1) - 1) if n > 1 else 0
    n_diag = 16 * (nb - 1) + last if n > 1 else 0
    if nb <= 1:
        third = (n_diag + 2) // 3
        return ((None, -1, -1, (0,)),
                *(((0, 0, w * third + 1, max(0, min(third, n_diag - w * third))), w - 1, -1, ())
                  for w in (1, 2)),
                (None, -1, -1, ()))
    if nb == 2:
        return ((None, -1, -1, (0,)), (None, -1, -1, (1,)),
                ((0, 1, 0, 16), 0, 0, ()), ((0, 1, 16, 16), 1, 1, ()))
    return (((0, 1, 0, 32), 0, 0, (1,)), ((0, 2, 0, 32), 1, 0, ()),
            ((1, 2, 0, 32), 1, 1, ()), (None, -1, -1, (0, 2)))


def owned_tile(n: int, block: int) -> tuple:
    """The diagonal tile that the owner of ``block`` adds (``dg_schedule``;
    at one block, its first third) as (I, J, k, steps)."""
    nb = (n + 31) // 32
    last = min(16, n - 32 * (nb - 1) - 1) if n > 1 else 0
    if nb <= 1:
        return (0, 0, 1, min((last + 2) // 3, last))
    return (block, block, 1, last if block == nb - 1 else 16)


def _unit_model(x, u2, l2, n, unit, g_rows, g_cols, e_lane):
    """One unit's pair terms (I, J, k, steps) at ``x`` [S, A, D]: its rows'
    and columns' sums [S, 32, D] (by column lane) in step order, each lane's
    energies added into ``e_lane`` [S, 32] in step order."""
    lanes = np.arange(32)
    I, J, k0, steps = unit
    for k in range(k0, k0 + steps):
        i, j, valid = step_pairs(I, J, k, n)
        f, ev = _pair_step(x, u2, l2, i, j, valid)
        g_rows += f
        g_cols[:, (lanes + k) % 32] -= f
        e_lane += ev


def _rows_model(xs, u2, l2, n, w4, g_n, e_n) -> None:
    """K11's rows past DG_ONCE_MAX_ATOMS (one thread an atom there): each
    row summed over the other atoms in order, with the fourth dimension's
    term, written into ``g_n`` [S, A, 4]; the row's pairs j > i and that
    term's energy on its thread of ``e_n`` [S, THREADS]."""
    for i in range(n):
        gi = torch.zeros((xs.shape[0], xs.shape[2]), dtype=xs.dtype)
        ei = torch.zeros(xs.shape[0], dtype=xs.dtype)
        for j in range(n):
            if j != i:
                f, ev = _pair_step(xs, u2, l2, np.array([i]), np.array([j]), np.array([True]))
                gi += f[:, 0]
                if j > i:
                    ei += ev[:, 0]
        gi[:, 3] += 2.0 * w4 * xs[:, i, 3]
        g_n[:, i] = gi
        e_n[:, i % THREADS] += ei + w4 * (xs[:, i, 3] * xs[:, i, 3])


def _schedule_model(xs, u2, l2, n, w4, g_n, e_n, add_chiral) -> None:
    """K11's :func:`dg_schedule` at ``xs`` [S, A, 4]: the units' two sums
    into each atom's row (zero first, in warp order: in either order the
    same bits), then ``add_chiral(g_n, e_n, warp)`` (the chiral terms, their
    energy on ``warp``, which writes block 0 second), then each owned block's
    diagonal tile (rows and columns summed, then the fourth dimension's
    term); the lanes' energies into ``e_n`` [S, THREADS]."""
    lanes = np.arange(32)
    S_n, _, D = xs.shape
    e_w = e_n.reshape(S_n, WARPS, 32)
    plan = dg_schedule(n)
    held = {}
    chiral_warp = 0
    for w, (ua, rows, cols, owns) in enumerate(plan):
        if ua is not None:
            ga, gc = torch.zeros((S_n, 32, D), dtype=xs.dtype), torch.zeros((S_n, 32, D),
                                                                            dtype=xs.dtype)
            _unit_model(xs, u2, l2, n, ua, ga, gc, e_w[:, w])
            r, c = 32 * ua[0] + lanes, 32 * ua[1] + lanes
            if ua[0] == ua[1]:
                g_n[:, r[r < n]] += (ga + gc)[:, r < n]
            else:
                g_n[:, r[r < n]] += ga[:, r < n]
                g_n[:, c[c < n]] += gc[:, c < n]
            if (rows == 1 and ua[0] == 0) or (cols == 1 and ua[1] == 0):
                chiral_warp = w
        for block in owns:
            ga, gc = torch.zeros((S_n, 32, D), dtype=xs.dtype), torch.zeros((S_n, 32, D),
                                                                            dtype=xs.dtype)
            _unit_model(xs, u2, l2, n, owned_tile(n, block), ga, gc, e_w[:, w])
            held[w, block] = ga + gc
    add_chiral(g_n, e_n, chiral_warp)
    for w, (*_, owns) in enumerate(plan):
        for block in owns:
            r = 32 * block + lanes
            r = r[r < n]
            v = held[w, block]
            v[:, :len(r), 3] += 2.0 * w4 * xs[:, r, 3]
            e_w[:, w, :len(r)] += w4 * (xs[:, r, 3] * xs[:, r, 3])
            g_n[:, r] += v[:, :len(r)]


def dg_energy_and_grad_model(positions: torch.Tensor, batch: DGBatch, sys2mol: torch.Tensor):
    """(energy [S], gradient [S, A, 4]) of ``positions`` [S, A, 4] by K11's
    arithmetic and order (csrc/dist_geom.cu dg_eval), on the CPU. Up to
    DG_ONCE_MAX_ATOMS atoms (:func:`dg_schedule`): the units' two sums into
    each atom's row, then the chiral quartets (the plain version's terms, in
    term order; their energy a quartet a lane on the warp that writes block
    0 second), then each owned block's diagonal tile with the fourth
    dimension's term; past it the first design's rows (each pair twice, a
    row summed in atom order) with the fourth dimension, then the chiral
    quartets on consecutive threads. The energy by
    :func:`block_total_model`. Where it departs from
    :func:`dg_energy_and_grad_plain`: the order of the sums and the pairs'
    reciprocals."""
    x = positions.detach()
    S, A, D = x.shape
    s2m = sys2mol.to(torch.int64)
    w4 = batch.fourth_dim_weight
    mask = flat.atom_mask(batch, sys2mol, A)
    g = torch.zeros_like(x)
    e_thread = torch.zeros((S, THREADS), dtype=x.dtype)
    u2 = batch.upper.to(x.dtype)[s2m] ** 2
    l2 = batch.lower.to(x.dtype)[s2m] ** 2
    sys_of, atoms, win = _chiral_terms(batch, s2m, A)
    e_c = torch.zeros(0, dtype=x.dtype)
    grads = [torch.zeros((0, 3), dtype=x.dtype)] * 4
    if atoms.shape[0]:
        with torch.enable_grad():
            p = [x.reshape(-1, D)[atoms[:, q], :3].requires_grad_(True) for q in range(4)]
            vol = ((p[0] - p[3]) * torch.linalg.cross(p[1] - p[3], p[2] - p[3])).sum(-1)
            lo, hi = win[:, 0].to(x.dtype), win[:, 1].to(x.dtype)
            viol = torch.where(vol < lo, lo - vol, torch.where(vol > hi, vol - hi, 0.0))
            e_c = batch.chiral_weight * (viol * viol)
            grads = torch.autograd.grad(e_c.sum(), p)
        e_c = e_c.detach()
    count = torch.bincount(sys_of, minlength=S)
    local = torch.arange(sys_of.shape[0]) - (torch.cumsum(count, 0) - count)[sys_of]
    for n, rows in _systems_by_atoms(batch, sys2mol).items():
        g_n, e_n = g[rows], e_thread[rows]
        terms = torch.isin(sys_of, rows)
        t_sys = torch.searchsorted(rows, sys_of[terms])
        t_atoms = atoms[terms] - (sys_of[terms] * A)[:, None]
        t_local = local[terms]

        def add_chiral(g_n, e_n, warp, terms=terms, t_sys=t_sys, t_atoms=t_atoms,
                       t_local=t_local):
            thread = t_local % THREADS if warp is None else warp * 32 + t_local % 32
            e_n.index_put_((t_sys, thread), e_c[terms], accumulate=True)
            flat_g = g_n.reshape(-1, D)
            for q in range(4):
                flat_g[:, :3].index_add_(0, t_sys * A + t_atoms[:, q], grads[q][terms])

        if n > DG_ONCE_MAX_ATOMS:
            _rows_model(x[rows], u2[rows], l2[rows], n, w4, g_n, e_n)
            add_chiral(g_n, e_n, None)
        else:
            _schedule_model(x[rows], u2[rows], l2[rows], n, w4, g_n, e_n, add_chiral)
        g[rows], e_thread[rows] = g_n, e_n
    return block_total_model(e_thread), torch.where(mask[..., None], g, 0.0)


def system_local(sys_of: torch.Tensor, S: int) -> torch.Tensor:
    """Each term's index among its system's terms (``sys_of`` sorted)."""
    count = torch.bincount(sys_of, minlength=S)
    return torch.arange(sys_of.shape[0]) - (torch.cumsum(count, 0) - count)[sys_of]


def add_terms_model(e_thread, g, sys_of, atoms, energies, grads, S: int, thread=None) -> None:
    """K13's terms of one kind into the per-thread energies [S, THREADS]
    (each term on ``thread``, by default K13's, :func:`term_threads` of its
    index among its system's terms) and their gradients (one per atom slot,
    [T, 3]) into ``g`` [S, A, D]'s first three coordinates, in term order."""
    if thread is None:
        local = system_local(sys_of, S)
        thread = torch.from_numpy(term_threads(int(local.max()) + 1))[local]
    e_thread.index_put_((sys_of, thread), energies, accumulate=True)
    flat_g = g.reshape(-1, g.shape[2])
    for q, grad in enumerate(grads):
        flat_g[:, :3].index_add_(0, atoms[:, q], grad)


def dg_energy_and_grad(positions: torch.Tensor, batch: DGBatch, sys2mol: torch.Tensor,
                       phase_cycles: bool = False):
    """(energy [S], gradient [S, A, 4]) of ``positions`` [S, A, 4], system s
    being molecule ``sys2mol[s]`` (int32) of ``batch``; the gradient is zero
    outside each system's atoms. K11 for CUDA tensors, the plain version for
    CPU tensors. With ``phase_cycles`` (CUDA only), K11's instrumented
    instantiation, and also each warp's cycles per phase (int64 [S, 4,
    len(EVAL_PHASES)])."""
    if not positions.is_cuda:
        if phase_cycles:
            raise ValueError("phase_cycles needs CUDA tensors")
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
    lib = dist_geom_lib()
    args = (positions.data_ptr(), n_sys, a_pad, sys2mol.data_ptr(), count.data_ptr(),
            batch.offsets.data_ptr(), batch.n_mols, flat.table_pointers(batch),
            batch.chiral_weight, batch.fourth_dim_weight, energy.data_ptr(), grad.data_ptr())
    cycles = (torch.zeros((n_sys, WARPS, len(EVAL_PHASES)), dtype=torch.int64, device=dev)
              if phase_cycles else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = (lib.nvmk_dg_energy_grad_cycles(*args, cycles.data_ptr(), stream) if phase_cycles
              else lib.nvmk_dg_energy_grad(*args, stream))
    if rc != 0:
        raise RuntimeError(f"dg_energy_grad kernel launch failed with CUDA error {rc}")
    launch_counts["dg_energy_grad"] += 1
    return (energy, grad, cycles) if phase_cycles else (energy, grad)


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
