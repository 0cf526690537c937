"""Batched BFGS: kernel K8, its plain PyTorch version, and the minimizers'
constants and result type.

The port's counterpart of ``nvmolkit_tpu/ops/bfgs.py``: RDKit's BFGS
semantics as nvMolKit ports them (``src/minimizer/bfgs_minimize.cu:33-34,
275-295``). This module is the constants' one home: kernels K5, K23 and K8
take them as arguments.

* :func:`bfgs_plain` mirrors ``_minimize_impl`` and ``_line_search``
  (``bfgs.py:65-320``) over any ``energy_and_grad_fn``: per outer iteration
  every live system runs one Numerical-Recipes line search, then, on
  acceptance, the TOLX / scaled-gradient / functional convergence tests,
  the rank-2 inverse-Hessian update with the NR skip test, and the
  direction -H g capped at maxStep. Lambda underflow counts as converged,
  ``MAX_LS_ITERS`` probes as failed, a per-system ``iter_caps`` spent
  without converging as failed, and ``max_iters`` as capped. The gradient
  of an accepted point is the probe's: the JAX function evaluates the
  accepted point again (``bfgs.py:261``), which gives the same values.
  Its line search, :func:`line_search_plain`, is also the lockstep
  L-BFGS's (``ops/lbfgs.py``).
* :func:`bfgs_onepass_plain` is K8's order of work in plain torch, the
  same math as :func:`bfgs_plain`: the inverse Hessian kept as its packed
  upper triangle (:func:`pack_upper`), each accepted step's rank-2 update
  left pending and added in the next step's one pass over H, which also
  gives H g (:func:`onepass_plain`); H dg from it and the direction before
  the cap, and the next direction from dot products with g.
* :func:`bfgs_minimize` minimizes the systems of a force-field batch
  (:class:`~nvmolkit_tpu_torch.models.flat.ForceField`), with optional
  constraints: on CUDA one launch of the force field's energy kernel (K4 or
  K6) and, with constraints, of K7 on the starts, then K8 (``csrc/*.cu``
  via ``minimizers.cuh``), one block per system for its whole minimization;
  on the CPU the plain version. A build or launch failure raises.

All return each system's status bits, probes and accepted steps.
``launch_counts`` counts K8's launches per force field, under
``<name>_bfgs`` (0 for one not launched since the last reset).
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
from typing import Callable

import numpy as np
import torch

from nvmolkit_tpu_torch.models import flat
from nvmolkit_tpu_torch.models.constraints import (
    ConstraintBatch,
    constraint_energy_and_grad,
    constraint_energy_and_grad_plain,
)

FUNCTOL = 1e-4
MOVETOL = 1e-7
TOLX = 4e-8
# functional-decrease convergence threshold (tighter than RDKit's FUNCTOL,
# so that only noise-floor cycling in float32 terminates on it)
TOLF = 1e-6
MAXSTEP_FACTOR = 100.0
EPS = 3e-8
# hard cap on line-search probes: lambda shrinks by at least 2x per probe,
# so ~64 pass below any lambda_min; it also ends NaN-poisoned searches
MAX_LS_ITERS = 64

# the status bits of BfgsResult.status
CONVERGED, FAILED, CAPPED = 1, 2, 4

# K8 keeps each system's inverse Hessian in device memory as its packed
# upper triangle, n (n + 1) / 2 float32 for n = D * its atoms; a call whose
# triangles take more than this many bytes runs K8 once per slice of that
# size (hessian_slices), one after another on the stream
HESSIAN_BYTES = 4 << 30

# the phases of K8's cycle split (bfgs_minimize(..., phase_cycles=True);
# csrc/minimizers.cuh K8_PHASES): "eval" is the force field's evaluation,
# "constraints" the constraint terms' own time after it
K8_PHASES = ["init", "eval", "search", "h_pass", "h_wait", "update", "constraints"]

launch_counts: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    launch_counts.clear()


@dataclasses.dataclass
class BfgsResult:
    positions: torch.Tensor   # [S, A, D]
    energies: torch.Tensor    # [S]
    converged: torch.Tensor   # [S] bool (True = gradient/position test met)
    n_iters: torch.Tensor     # [S] int32: energy evaluations (probes) of each system
    status: torch.Tensor      # [S] int32: CONVERGED | FAILED | CAPPED bits
    n_accepted: torch.Tensor  # [S] int32: accepted steps of each system
    # [S] int32: line searches of each system (the lockstep L-BFGS's
    # iterations, ops/lbfgs.py); None from the other minimizers
    n_searches: torch.Tensor | None = None
    # int64 [S, phases]: the kernel's cycles per phase and system (thread 0
    # of its block), from phase_cycles=True: K8's (K8_PHASES) or K5's and
    # K23's (ops/lbfgs_flat.K5_PHASES)
    phase_cycles: torch.Tensor | None = None


def policy():
    """The constants the kernels take, as their ``policy`` array."""
    return (ctypes.c_float * 6)(FUNCTOL, MOVETOL, TOLX, TOLF, MAXSTEP_FACTOR, EPS)


def status_bits(converged, failed, capped) -> torch.Tensor:
    return (converged.to(torch.int32) * CONVERGED + failed.to(torch.int32) * FAILED
            + capped.to(torch.int32) * CAPPED)


def line_search_plain(eg: Callable, pos, e, grad, direction, active, probes, slope=None,
                      lam_min=None):
    """One Numerical-Recipes line search (the JAX package's
    ``ops/bfgs.py:65-141``) of every ``active`` system at once, from ``pos``
    [S, N] (energy ``e``, gradient ``grad``) along ``direction``, with
    ``eg(x) -> (e, g)``: the quadratic model on the first probe, the cubic
    after, clamped to [0.1, 0.5] lambda; sufficient decrease FUNCTOL *
    lambda * slope. Adds each system's probes to ``probes``; returns the
    accepted point's (positions, energy, gradient) (the start's where none
    was accepted), ``ls_ok`` and ``exhausted`` (still live after
    MAX_LS_ITERS probes). ``slope`` and ``lam_min``, when given, replace
    those summed over ``direction``."""
    S = pos.shape[0]
    dtype, dev = pos.dtype, pos.device
    if slope is None:
        slope = (grad * direction).sum(dim=1)
    if lam_min is None:
        rel = direction.abs() / torch.clamp_min(pos.abs(), 1.0)
        lam_min = MOVETOL / torch.clamp_min(rel.amax(dim=1), 1e-30)
    lam = torch.ones(S, dtype=dtype, device=dev)
    lam2 = torch.zeros(S, dtype=dtype, device=dev)
    e2, e_new, p_new, g_new = e, e, pos, grad
    done = torch.zeros(S, dtype=torch.bool, device=dev)
    ls_failed = ~active  # inactive systems are treated as already failed (no move)
    for ls_it in range(MAX_LS_ITERS):
        live = active & ~done & ~ls_failed
        if not bool(live.any()):
            break
        trial = pos + lam[:, None] * direction
        e_t, g_t = eg(trial)
        probes += live.to(torch.int32)
        accept = e_t - e <= FUNCTOL * lam * slope
        rhs1 = e_t - e - lam * slope
        rhs2 = e2 - e - lam2 * slope
        denom = torch.where(lam != lam2, lam - lam2, 1.0)
        lsq = torch.clamp_min(lam**2, 1e-30)
        l2sq = torch.clamp_min(lam2**2, 1e-30)
        a = (rhs1 / lsq - rhs2 / l2sq) / denom
        b = (-lam2 * rhs1 / lsq + lam * rhs2 / l2sq) / denom
        disc = b * b - 3.0 * a * slope
        a_safe = torch.where(a.abs() < 1e-20, 1e-20, a)
        b_safe = torch.where(b.abs() < 1e-20, 1e-20, b)
        cubic = torch.where(
            a.abs() < 1e-20, -slope / (2.0 * b_safe),
            torch.where(disc < 0, 0.5 * lam,
                        (-b + torch.sqrt(torch.clamp_min(disc, 0.0))) / (3.0 * a_safe)))
        quad = -slope * lam * lam / (2.0 * torch.clamp_min(rhs1, 1e-30))
        tmp = torch.minimum(quad if ls_it == 0 else cubic, 0.5 * lam)
        new_lam = torch.maximum(tmp, 0.1 * lam)
        done_now = live & accept
        reject = live & ~accept
        p_new = torch.where(done_now[:, None], trial, p_new)
        g_new = torch.where(done_now[:, None], g_t, g_new)
        e_new = torch.where(done_now, e_t, e_new)
        e2 = torch.where(reject, e_t, e2)
        lam2 = torch.where(reject, lam, lam2)
        lam = torch.where(reject, new_lam, lam)
        done = done | done_now
        ls_failed = ls_failed | (reject & (new_lam < lam_min))
    ls_ok = done & active
    # systems still live at the probe cap (NaN-poisoned or pathological)
    exhausted = active & ~done & ~ls_failed
    return p_new, e_new, g_new, ls_ok, exhausted


def bfgs_plain(
    energy_and_grad_fn: Callable,
    positions: torch.Tensor,   # [S, A, D]
    atom_mask: torch.Tensor,   # [S, A] bool
    max_iters: int = 200,
    grad_tol: float = 1e-4,
    iter_caps: torch.Tensor | None = None,   # [S] int32
    grad_tols: torch.Tensor | None = None,   # [S] float32
) -> BfgsResult:
    """Minimize every system of ``positions`` under ``energy_and_grad_fn``
    (positions -> (energy [S], gradient [S, A, D])), as the JAX package's
    ``batched_bfgs_minimize`` does; ``max_iters`` bounds the outer
    iterations (line searches)."""
    S, A, D = positions.shape
    N = D * A
    dev, dtype = positions.device, positions.dtype
    dmask = atom_mask.to(dev).repeat_interleave(D, dim=1).reshape(S, N)
    n_dof = dmask.sum(dim=1).to(dtype)
    tol = grad_tol if grad_tols is None else grad_tols.to(dev, dtype)

    def eg(p):
        e, g = energy_and_grad_fn(p.reshape(S, A, D))
        return e, g.reshape(S, N)

    def masked_max(x):
        return torch.where(dmask, x, 0.0).amax(dim=1)

    pos = positions.reshape(S, N)
    e, grad = eg(pos)
    hess = torch.eye(N, dtype=dtype, device=dev).expand(S, N, N).clone()
    direction = -grad
    failed = ~(torch.isfinite(e) & torch.isfinite(grad).all(dim=1))
    # zero-gradient convergence at entry (NR dfpmin's pre-loop test)
    gs0 = grad.abs() * torch.clamp_min(pos.abs(), 1.0)
    converged = (masked_max(gs0) / torch.clamp_min(e.abs(), 1.0) < tol) & ~failed
    probes = torch.zeros(S, dtype=torch.int32, device=dev)
    accepted = torch.zeros(S, dtype=torch.int32, device=dev)

    for it in range(max_iters):
        active = ~(converged | failed)
        if not bool(active.any()):
            break
        # cap the step length per system
        step_norm = torch.sqrt((direction * direction).sum(dim=1))
        max_step = MAXSTEP_FACTOR * torch.maximum(torch.sqrt((pos * pos * dmask).sum(dim=1)), n_dof)
        scale = torch.where(step_norm > max_step, max_step / torch.clamp_min(step_norm, 1e-30), 1.0)
        direction = direction * scale[:, None]

        p_new, e_new, g_new, ls_ok, exhausted = line_search_plain(eg, pos, e, grad, direction,
                                                                  active, probes)
        failed = failed | exhausted
        # NR lnsrch: lambda underflow means the position cannot improve ->
        # the TOLX test fires -> converged
        conv_ls = active & ~ls_ok & ~exhausted

        xi = p_new - pos
        conv_x = masked_max(xi.abs() / torch.clamp_min(p_new.abs(), 1.0)) < TOLX
        gscaled = g_new.abs() * torch.clamp_min(p_new.abs(), 1.0)
        conv_g = masked_max(gscaled) / torch.clamp_min(e_new.abs(), 1.0) < tol
        conv_f = 2.0 * (e - e_new).abs() <= TOLF * (e.abs() + e_new.abs() + 1e-10)
        newly_conv = (conv_ls | (ls_ok & (conv_x | conv_g | conv_f))) & active

        dgrad = g_new - grad
        hdg = torch.einsum("sij,sj->si", hess, dgrad)
        fac = (dgrad * xi).sum(dim=1)
        fae = (dgrad * hdg).sum(dim=1)
        sumdg = (dgrad * dgrad).sum(dim=1)
        sumxi = (xi * xi).sum(dim=1)
        do_update = (fac > torch.sqrt(EPS * sumdg * sumxi)) & ls_ok
        fac_i = 1.0 / torch.clamp_min(fac, 1e-30)
        fad_i = 1.0 / torch.clamp_min(fae, 1e-30)
        u = fac_i[:, None] * xi - fad_i[:, None] * hdg
        dh = (fac_i[:, None, None] * torch.einsum("si,sj->sij", xi, xi)
              - fad_i[:, None, None] * torch.einsum("si,sj->sij", hdg, hdg)
              + fae[:, None, None] * torch.einsum("si,sj->sij", u, u))
        hess = torch.where(do_update[:, None, None], hess + dh, hess)

        pos = torch.where(ls_ok[:, None], p_new, pos)
        e = torch.where(ls_ok, e_new, e)
        grad = torch.where(ls_ok[:, None], g_new, grad)
        direction = -torch.einsum("sij,sj->si", hess, grad)
        accepted += ls_ok.to(torch.int32)
        converged = converged | newly_conv
        if iter_caps is not None:
            # per-system budget spent without converging -> stop it, failed
            failed = failed | (active & ~newly_conv & (it + 1 >= iter_caps.to(dev)))

    capped = ~(converged | failed)
    return BfgsResult(positions=pos.reshape(S, A, D), energies=e, converged=converged,
                      n_iters=probes, status=status_bits(converged, failed, capped),
                      n_accepted=accepted)


def pack_upper(h: torch.Tensor) -> torch.Tensor:
    """[S, N, N] -> [S, N (N + 1) / 2]: the upper triangle by rows (row r,
    columns r..N-1), K8's layout of a system's inverse Hessian."""
    r, c = torch.triu_indices(h.shape[-1], h.shape[-1], device=h.device)
    return h[:, r, c]


def unpack_upper(p: torch.Tensor, n: int) -> torch.Tensor:
    """[S, n (n + 1) / 2] -> the symmetric [S, n, n] whose upper triangle
    :func:`pack_upper` packed."""
    r, c = torch.triu_indices(n, n, device=p.device)
    h = p.new_zeros((p.shape[0], n, n))
    h[:, c, r] = p
    h[:, r, c] = p
    return h


def onepass_plain(hp: torch.Tensor, n: int, pending: torch.Tensor, xi, hdg, fac_i, fad_i, fae,
                  g: torch.Tensor):
    """K8's one pass over the packed inverse Hessians ``hp`` [S, n (n + 1) /
    2]: where ``pending`` [S], add the update fac_i xi xi^T - fad_i hdg
    hdg^T + fae u u^T (u = fac_i xi - fad_i hdg) entry by entry, as the
    kernel writes it; returns (the new hp, H g [S, n]), every stored entry
    read once: it feeds its row's sum and, off the diagonal, its column's."""
    r, c = torch.triu_indices(n, n, device=hp.device)
    u = fac_i[:, None] * xi - fad_i[:, None] * hdg
    upd = (fac_i[:, None] * (xi[:, r] * xi[:, c]) - fad_i[:, None] * (hdg[:, r] * hdg[:, c])
           + fae[:, None] * (u[:, r] * u[:, c]))
    hp = torch.where(pending[:, None], hp + upd, hp)
    y = torch.zeros_like(g).index_add_(1, r, hp * g[:, c])
    off = r != c
    y.index_add_(1, c[off], hp[:, off] * g[:, r[off]])
    return hp, y


def bfgs_onepass_plain(
    energy_and_grad_fn: Callable,
    positions: torch.Tensor,   # [S, A, D]
    atom_mask: torch.Tensor,   # [S, A] bool
    max_iters: int = 200,
    grad_tol: float = 1e-4,
    iter_caps: torch.Tensor | None = None,   # [S] int32
    grad_tols: torch.Tensor | None = None,   # [S] float32
    stats: dict | None = None,
) -> BfgsResult:
    """:func:`bfgs_plain`'s minimization in K8's order of work. Per accepted
    step k, one pass (:func:`onepass_plain`) adds the update that step k - 1
    left pending to the packed H and gives y = H_k g_{k+1}; then H_k dg = y
    + d_k, with d_k = -H_k g_k the direction before the cap; the update's
    sums and the dot products xi.g and hdg.g in one reduction; and the next
    direction -H_{k+1} g_{k+1} = -(y + fac_i xi (xi.g) - fad_i hdg (hdg.g) +
    fae u (u.g)), u.g = fac_i xi.g - fad_i hdg.g. An update that fails the
    skip test leaves nothing pending. With ``stats``, it records per
    iteration which systems leave an update pending (``pending``) and the
    final packed H (``hessian``)."""
    S, A, D = positions.shape
    N = D * A
    dev, dtype = positions.device, positions.dtype
    dmask = atom_mask.to(dev).repeat_interleave(D, dim=1).reshape(S, N)
    n_dof = dmask.sum(dim=1).to(dtype)
    tol = grad_tol if grad_tols is None else grad_tols.to(dev, dtype)

    def eg(p):
        e, g = energy_and_grad_fn(p.reshape(S, A, D))
        return e, g.reshape(S, N)

    def masked_max(x):
        return torch.where(dmask, x, 0.0).amax(dim=1)

    pos = positions.reshape(S, N)
    e, grad = eg(pos)
    hp = pack_upper(torch.eye(N, dtype=dtype, device=dev).expand(1, N, N)).expand(S, -1).clone()
    zeros = torch.zeros(S, dtype=dtype, device=dev)
    pending = torch.zeros(S, dtype=torch.bool, device=dev)
    pxi, phdg = torch.zeros_like(grad), torch.zeros_like(grad)
    pfac_i, pfad_i, pfae = zeros, zeros, zeros
    d0 = -grad  # the direction before the cap
    failed = ~(torch.isfinite(e) & torch.isfinite(grad).all(dim=1))
    gs0 = grad.abs() * torch.clamp_min(pos.abs(), 1.0)
    converged = (masked_max(gs0) / torch.clamp_min(e.abs(), 1.0) < tol) & ~failed
    probes = torch.zeros(S, dtype=torch.int32, device=dev)
    accepted = torch.zeros(S, dtype=torch.int32, device=dev)
    if stats is not None:
        stats["pending"] = []

    for it in range(max_iters):
        active = ~(converged | failed)
        if not bool(active.any()):
            break
        step_norm = torch.sqrt((d0 * d0).sum(dim=1))
        max_step = MAXSTEP_FACTOR * torch.maximum(torch.sqrt((pos * pos * dmask).sum(dim=1)), n_dof)
        scale = torch.where(step_norm > max_step, max_step / torch.clamp_min(step_norm, 1e-30), 1.0)
        direction = d0 * scale[:, None]

        p_new, e_new, g_new, ls_ok, exhausted = line_search_plain(eg, pos, e, grad, direction,
                                                                  active, probes)
        failed = failed | exhausted
        conv_ls = active & ~ls_ok & ~exhausted
        xi = p_new - pos
        conv_x = masked_max(xi.abs() / torch.clamp_min(p_new.abs(), 1.0)) < TOLX
        gscaled = g_new.abs() * torch.clamp_min(p_new.abs(), 1.0)
        conv_g = masked_max(gscaled) / torch.clamp_min(e_new.abs(), 1.0) < tol
        conv_f = 2.0 * (e - e_new).abs() <= TOLF * (e.abs() + e_new.abs() + 1e-10)
        newly_conv = (conv_ls | (ls_ok & (conv_x | conv_g | conv_f))) & active

        # the one pass: the pending update into H where a step was accepted, y = H_k g_{k+1}
        hp, y = onepass_plain(hp, N, pending & ls_ok, pxi, phdg, pfac_i, pfad_i, pfae, g_new)
        dgrad = g_new - grad
        hdg = y + d0
        fac = (dgrad * xi).sum(dim=1)
        fae = (dgrad * hdg).sum(dim=1)
        sumdg = (dgrad * dgrad).sum(dim=1)
        sumxi = (xi * xi).sum(dim=1)
        xg = (xi * g_new).sum(dim=1)
        hg = (hdg * g_new).sum(dim=1)
        do_update = (fac > torch.sqrt(EPS * sumdg * sumxi)) & ls_ok
        fac_i = 1.0 / torch.clamp_min(fac, 1e-30)
        fad_i = 1.0 / torch.clamp_min(fae, 1e-30)
        ug = fac_i * xg - fad_i * hg
        u = fac_i[:, None] * xi - fad_i[:, None] * hdg
        rank2_g = (fac_i[:, None] * xi * xg[:, None] - fad_i[:, None] * hdg * hg[:, None]
                   + fae[:, None] * u * ug[:, None])
        d_new = -(y + torch.where(do_update[:, None], rank2_g, 0.0))

        keep = ls_ok[:, None]
        pending = torch.where(ls_ok, do_update, pending)
        pxi, phdg = torch.where(keep, xi, pxi), torch.where(keep, hdg, phdg)
        pfac_i = torch.where(ls_ok, fac_i, pfac_i)
        pfad_i = torch.where(ls_ok, fad_i, pfad_i)
        pfae = torch.where(ls_ok, fae, pfae)
        if stats is not None:
            stats["pending"].append(pending.clone())
        pos = torch.where(keep, p_new, pos)
        e = torch.where(ls_ok, e_new, e)
        grad = torch.where(keep, g_new, grad)
        d0 = torch.where(keep, d_new, d0)
        accepted += ls_ok.to(torch.int32)
        converged = converged | newly_conv
        if iter_caps is not None:
            failed = failed | (active & ~newly_conv & (it + 1 >= iter_caps.to(dev)))

    if stats is not None:
        stats["hessian"] = hp
    capped = ~(converged | failed)
    return BfgsResult(positions=pos.reshape(S, A, D), energies=e, converged=converged,
                      n_iters=probes, status=status_bits(converged, failed, capped),
                      n_accepted=accepted)


def hessian_pass_bytes(n) -> np.ndarray:
    """K8's inverse-Hessian bytes per accepted step for systems of ``n``
    degrees of freedom: one read and one write of the packed triangle (a
    step after a skipped update only reads it)."""
    n = np.asarray(n, np.int64)
    return 4 * n * (n + 1)


def kernel_info(ff: flat.ForceField, a_pad: int, constrained: bool = False) -> dict:
    """What the card makes of K8 over ``ff`` at ``a_pad``, launched with
    constraint tables (``constrained``) or without: its registers, spilled
    (local) bytes per thread, resident blocks per SM, shared bytes per
    block, and the constraint terms it stages per system in shared memory
    (``csrc/minimizers.cuh`` bfgs_stage_cap; a system's terms past them are
    read from device memory on every probe)."""
    out = (ctypes.c_int * 5)()
    rc = getattr(ff.lib(), f"nvmk_{ff.name}_bfgs_info")(a_pad, int(constrained), out)
    if rc != 0:
        raise RuntimeError(f"{ff.name}_bfgs_info failed with CUDA error {rc}")
    return {"registers": out[0], "local_bytes": out[1], "blocks_per_sm": out[2],
            "shared_bytes": out[3], "staged_terms": out[4]}


def hessian_slices(n_dof) -> tuple[np.ndarray, list[tuple[int, int]]]:
    """Each system's offset (in floats) into the packed inverse Hessians of
    systems with ``n_dof`` degrees of freedom, and the slices [start, end)
    of systems that K8 runs one launch each, their triangles within
    HESSIAN_BYTES (a system larger than that alone)."""
    n = np.asarray(n_dof, np.int64)
    ends = np.cumsum(n * (n + 1) // 2)
    off = ends - n * (n + 1) // 2
    slices, start = [], 0
    while start < len(n):
        end = int(np.searchsorted(ends, off[start] + HESSIAN_BYTES // 4, side="right"))
        end = max(end, start + 1)
        slices.append((start, end))
        start = end
    return off, slices


def with_constraints(fn: Callable, constraints: ConstraintBatch | None) -> Callable:
    """``fn`` (positions -> (e, g)) plus the constraints' plain penalties."""
    if constraints is None:
        return fn

    def energy_and_grad(positions):
        e, g = fn(positions)
        ce, cg = constraint_energy_and_grad_plain(positions, constraints)
        return e + ce, g + cg

    return energy_and_grad


def bfgs_minimize(
    ff: flat.ForceField,
    positions: torch.Tensor,
    batch,
    sys2mol: torch.Tensor,
    constraints: ConstraintBatch | None = None,
    max_iters: int = 200,
    grad_tol: float = 1e-4,
    iter_caps: torch.Tensor | None = None,
    grad_tols: torch.Tensor | None = None,
    phase_cycles: bool = False,
) -> BfgsResult:
    """Minimize the systems ``positions`` [S, A, D] of force field ``ff``,
    system s being molecule ``sys2mol[s]`` (int32) of ``batch``, with the
    penalties of ``constraints`` (its systems the same S) if given. For CUDA
    tensors the force field's kernel (and K7) on the starts, then K8, each
    system's packed inverse Hessian at its own offset (one host copy of the
    atom counts sizes them); for CPU tensors :func:`bfgs_plain`. With
    ``phase_cycles`` (CUDA), the result holds K8's cycles per phase."""
    n_sys, a_pad = positions.shape[:2]
    if constraints is not None and constraints.n_systems != n_sys:
        raise ValueError(f"constraints for {constraints.n_systems} systems, positions hold {n_sys}")
    if not positions.is_cuda:
        fn = with_constraints(ff.plain_energy_and_grad_fn(batch, sys2mol, a_pad), constraints)
        return bfgs_plain(fn, positions, flat.atom_mask(batch, sys2mol, a_pad), max_iters,
                          grad_tol, iter_caps, grad_tols)
    dim = flat.kernel_dim(ff.lib(), ff.name)
    flat.check_kernel_inputs(positions, batch, sys2mol, "K8", dim)
    dev = positions.device
    for name, t, dtype in (("iter_caps", iter_caps, torch.int32),
                           ("grad_tols", grad_tols, torch.float32)):
        if t is not None and (t.dtype != dtype or t.shape != (n_sys,) or t.device != dev
                              or not t.is_contiguous()):
            raise ValueError(f"K8 takes {name} as a contiguous {dtype} [{n_sys}] on {dev}")
    count = flat.system_atoms(batch, sys2mol)
    e0, g0 = ff.energy_and_grad(positions, batch, sys2mol)
    if constraints is not None:
        ce, cg = constraint_energy_and_grad(positions, constraints, count)
        e0, g0 = e0 + ce, g0 + cg
    pos_out = torch.empty_like(positions)
    energies = torch.empty(n_sys, dtype=torch.float32, device=dev)
    status = torch.empty(n_sys, dtype=torch.int32, device=dev)
    steps = torch.empty(n_sys, dtype=torch.int32, device=dev)
    accepted = torch.empty(n_sys, dtype=torch.int32, device=dev)
    # each system's packed triangle at its own offset, sized by its atoms:
    # the slices on the host (one copy of the counts), the offsets on the card
    n_dof = dim * count.cpu().numpy().astype(np.int64)
    off, slices = hessian_slices(n_dof)
    ends = off + n_dof * (n_dof + 1) // 2
    n_dev = dim * count.to(torch.int64)
    sizes = n_dev * (n_dev + 1) // 2
    hoff = torch.cumsum(sizes, 0) - sizes
    hess = torch.empty(max((int(ends[b - 1] - off[a]) for a, b in slices), default=0),
                       dtype=torch.float32, device=dev)
    cycles = (torch.zeros((n_sys, len(K8_PHASES)), dtype=torch.int64, device=dev)
              if phase_cycles else None)
    fn = getattr(ff.lib(), f"nvmk_{ff.name}_bfgs")

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        for start, end in slices:
            rc = fn(
                positions.data_ptr(), e0.data_ptr(), g0.data_ptr(), n_sys, start, end - start,
                a_pad, sys2mol.data_ptr(), count.data_ptr(), batch.offsets.data_ptr(),
                batch.n_mols, flat.table_pointers(batch), *ff.extra_args(batch),
                None if constraints is None else constraints.pointers(), policy(), MAX_LS_ITERS,
                int(max_iters), float(grad_tol), ptr(iter_caps), ptr(grad_tols), hess.data_ptr(),
                hoff.data_ptr(), int(off[start]), pos_out.data_ptr(), energies.data_ptr(),
                status.data_ptr(), steps.data_ptr(), accepted.data_ptr(),
                None if cycles is None else cycles[start:].data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{ff.name}_bfgs kernel launch failed with CUDA error {rc}")
            launch_counts[f"{ff.name}_bfgs"] += 1
    return BfgsResult(positions=pos_out, energies=energies, converged=(status & CONVERGED) != 0,
                      n_iters=steps, status=status, n_accepted=accepted, phase_cycles=cycles)
