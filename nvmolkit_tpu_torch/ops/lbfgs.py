"""Lockstep batched L-BFGS: kernel K23, its plain PyTorch version, and the
MMFF/UFF driver's restart at iteration 96.

The port's counterpart of ``nvmolkit_tpu/ops/lbfgs.py`` (``_lbfgs_impl``),
the JAX package's ``backend="lbfgs"``: per outer iteration every live system
builds its direction by the two-loop recursion over a ``HISTORY``-deep
(s, y) history (newest first, an empty slot skipped, scaled by ``gamma``),
caps it at maxStep, runs one whole Numerical-Recipes line search
(``ops/bfgs.py::line_search_plain``, K8's) and, on acceptance, pushes (s, y) (a zero slot where
y.s <= EPS). It shares K5's arithmetic (``ops/lbfgs_flat.py``) but differs
in four places, each kept:

1. nothing is tested before the first line search: a zero-gradient start
   takes one probe, which is accepted, and converges on TOLX after one
   iteration;
2. converged means lambda underflow, TOLX or the scaled gradient; there is
   no functional (TOLF) test;
3. ``max_iters`` bounds the line searches, and a line search that spends
   ``MAX_LS_ITERS`` probes fails the system;
4. the MMFF/UFF driver (:func:`minimize_restarting`, the JAX package's
   ``ops/minimize_driver.py``) runs ``min(PHASE1_ITERS, max_iters)``
   iterations, then restarts every system not converged (failed ones too)
   from its phase-1 position, with an empty history, gamma = 1 and a fresh
   start evaluation, for the remaining ``max_iters - PHASE1_ITERS``
   (ROADMAP §3 fault 19: the reference's quirk, mirrored). The embedding
   calls :func:`lbfgs_lockstep` with no restart.

* :func:`lbfgs_lockstep_plain` is the plain version, the whole batch in
  lockstep as the JAX function is, over any ``energy_and_grad_fn``, in the
  positions' dtype; :func:`minimize_restarting_plain` the driver over it.
  With ``fused=True`` it is the torch model of K23's order (K5's:
  ``ops/lbfgs_flat.compact_direction`` and ``fused_cap``).
* :func:`lbfgs_lockstep` minimizes the systems of a force-field batch: on
  CUDA it launches the force field's energy kernel (K4, K6, K11 or K13) on
  the starts, then K23 (``csrc/minimizers.cuh``, K5's body instantiated
  with ``Lockstep``) once, one block per system for its whole
  minimization; on the CPU the plain version. A build or launch failure
  raises. ``phase_cycles=True`` returns K23's cycles per phase, summed over
  the restart's two launches.

Both take an optional int32 ``done`` status per system: a system whose
CONVERGED bit is set keeps its inputs and status and runs nothing, which is
how the restart's second phase is one more launch over the same systems.
Each result carries per system the probes (``n_iters``), the accepted steps
(``n_accepted``) and the line searches (``n_searches``, the JAX function's
iterations). ``launch_counts`` counts K23's launches under
``<name>_lbfgs_lockstep``.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable

import torch

from nvmolkit_tpu_torch.models import flat
from nvmolkit_tpu_torch.ops import lbfgs_flat
from nvmolkit_tpu_torch.ops.bfgs import (
    CONVERGED,
    EPS,
    MAX_LS_ITERS,
    MAXSTEP_FACTOR,
    TOLX,
    BfgsResult,
    line_search_plain,
    policy,
    status_bits,
)

HISTORY = 6
PHASE1_ITERS = 96

launch_counts: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    launch_counts.clear()


def lbfgs_lockstep_plain(
    energy_and_grad_fn: Callable,
    positions: torch.Tensor,   # [S, A, D]
    atom_mask: torch.Tensor,   # [S, A] bool
    max_iters: int = 200,
    grad_tol: float = 1e-4,
    done: torch.Tensor | None = None,   # [S] int32 status
    fused: bool = False,
) -> BfgsResult:
    """Minimize every system of ``positions`` under ``energy_and_grad_fn``
    (positions -> (energy [S], gradient [S, A, D])), as the JAX package's
    ``batched_lbfgs_minimize`` does; ``max_iters`` bounds the line searches.
    Systems whose ``done`` has the CONVERGED bit keep their inputs.
    ``fused``: K23's order (``lbfgs_flat.compact_direction``, ``fused_cap``)."""
    S, A, D = positions.shape
    N = D * A
    m = HISTORY
    dev, dtype = positions.device, positions.dtype
    dmask = atom_mask.to(dev).repeat_interleave(D, dim=1).reshape(S, N)
    n_dof = dmask.sum(dim=1).to(dtype)

    def eg(p):
        e, g = energy_and_grad_fn(p.reshape(S, A, D))
        return e, g.reshape(S, N)

    def masked_max(x):
        return torch.where(dmask, x, 0.0).amax(dim=1)

    def two_loop(grad, s_hist, y_hist, rho, gamma):
        q = grad
        alphas = []
        for i in range(m):  # newest first
            a_i = torch.where(rho[i] > 0, rho[i] * (s_hist[i] * q).sum(dim=1), 0.0)
            q = q - a_i[:, None] * y_hist[i]
            alphas.append(a_i)
        q = q * gamma[:, None]
        for i in reversed(range(m)):
            b_i = torch.where(rho[i] > 0, rho[i] * (y_hist[i] * q).sum(dim=1), 0.0)
            q = q + (alphas[i] - b_i)[:, None] * s_hist[i]
        return -q

    pos = positions.reshape(S, N)
    e, grad = eg(pos)
    failed = ~(torch.isfinite(e) & torch.isfinite(grad).all(dim=1))
    converged = torch.zeros(S, dtype=torch.bool, device=dev)
    skip = (torch.zeros(S, dtype=torch.bool, device=dev) if done is None
            else (done.to(dev) & CONVERGED) != 0)
    s_hist = torch.zeros((m, S, N), dtype=dtype, device=dev)
    y_hist = torch.zeros((m, S, N), dtype=dtype, device=dev)
    rho = torch.zeros((m, S), dtype=dtype, device=dev)   # 0 marks an empty slot
    gamma = torch.ones(S, dtype=dtype, device=dev)
    searches = torch.zeros(S, dtype=torch.int32, device=dev)
    probes = torch.zeros(S, dtype=torch.int32, device=dev)
    accepted = torch.zeros(S, dtype=torch.int32, device=dev)

    for _ in range(max_iters):
        active = ~(converged | failed | skip)
        if not bool(active.any()):
            break
        slope = lam_min = None
        if fused:
            direction, slope, lam_min = lbfgs_flat.fused_cap(
                pos, lbfgs_flat.compact_direction(grad, s_hist, y_hist, rho, gamma), grad, dmask,
                n_dof)
        else:
            direction = two_loop(grad, s_hist, y_hist, rho, gamma)
            step_norm = torch.sqrt((direction * direction).sum(dim=1))
            max_step = MAXSTEP_FACTOR * torch.maximum(
                torch.sqrt((pos * pos * dmask).sum(dim=1)), n_dof)
            scale = torch.where(step_norm > max_step,
                                max_step / torch.clamp_min(step_norm, 1e-30), 1.0)
            direction = direction * scale[:, None]

        p_new, e_new, g_new, ls_ok, exhausted = line_search_plain(
            eg, pos, e, grad, direction, active, probes, slope, lam_min)
        failed = failed | exhausted
        # lambda underflow: the position cannot improve -> converged (TOLX)
        conv_ls = active & ~ls_ok & ~exhausted

        xi = p_new - pos
        conv_x = masked_max(xi.abs() / torch.clamp_min(p_new.abs(), 1.0)) < TOLX
        gscaled = g_new.abs() * torch.clamp_min(p_new.abs(), 1.0)
        conv_g = masked_max(gscaled) / torch.clamp_min(e_new.abs(), 1.0) < grad_tol
        newly_conv = (conv_ls | (ls_ok & (conv_x | conv_g))) & active

        # push the new pair, newest first; a zero slot where y.s <= EPS
        dgrad = g_new - grad
        ys = (dgrad * xi).sum(dim=1)
        yy = (dgrad * dgrad).sum(dim=1)
        store = (ys > EPS) & ls_ok
        s_hist = torch.cat([torch.where(store[:, None], xi, 0.0)[None], s_hist[:-1]])
        y_hist = torch.cat([torch.where(store[:, None], dgrad, 0.0)[None], y_hist[:-1]])
        rho = torch.cat([torch.where(store, 1.0 / torch.clamp_min(ys, 1e-30), 0.0)[None],
                         rho[:-1]])
        gamma = torch.where(store, ys / torch.clamp_min(yy, 1e-30), gamma)

        pos = torch.where(ls_ok[:, None], p_new, pos)
        e = torch.where(ls_ok, e_new, e)
        grad = torch.where(ls_ok[:, None], g_new, grad)
        searches += active.to(torch.int32)
        accepted += ls_ok.to(torch.int32)
        converged = converged | newly_conv

    status = status_bits(converged, failed, ~(converged | failed))
    if done is not None:
        status = torch.where(skip, done.to(dev, torch.int32), status)
    return BfgsResult(positions=pos.reshape(S, A, D), energies=e,
                      converged=(status & CONVERGED) != 0, n_iters=probes, status=status,
                      n_accepted=accepted, n_searches=searches)


def lbfgs_lockstep(
    ff: flat.ForceField,
    positions: torch.Tensor,
    batch,
    sys2mol: torch.Tensor,
    max_iters: int = 200,
    grad_tol: float = 1e-4,
    done: torch.Tensor | None = None,
    phase_cycles: bool = False,
) -> BfgsResult:
    """Minimize the systems ``positions`` [S, A, D] of force field ``ff``,
    system s being molecule ``sys2mol[s]`` (int32) of ``batch``, skipping
    those whose ``done`` status (int32 [S], or None) is converged. For CUDA
    tensors the force field's kernel on the starts, then K23 (one launch
    each); :func:`lbfgs_lockstep_plain` for CPU tensors. With
    ``phase_cycles`` (CUDA), the result holds K23's cycles per phase."""
    n_sys, a_pad = positions.shape[:2]
    if not positions.is_cuda:
        return lbfgs_lockstep_plain(ff.plain_energy_and_grad_fn(batch, sys2mol, a_pad), positions,
                                    flat.atom_mask(batch, sys2mol, a_pad), max_iters, grad_tol,
                                    done)
    flat.check_kernel_inputs(positions, batch, sys2mol, "K23", flat.kernel_dim(ff.lib(), ff.name))
    dev = positions.device
    if done is not None and (done.dtype != torch.int32 or done.shape != (n_sys,)
                             or done.device != dev or not done.is_contiguous()):
        raise ValueError(f"K23 takes done as a contiguous int32 [{n_sys}] on {dev}")
    e0, g0 = ff.energy_and_grad(positions, batch, sys2mol)
    pos_out = torch.empty_like(positions)
    energies = torch.empty(n_sys, dtype=torch.float32, device=dev)
    status, searches, probes, accepted = torch.empty((4, n_sys), dtype=torch.int32, device=dev)
    count = flat.system_atoms(batch, sys2mol)
    cycles = lbfgs_flat.cycles_buffer(n_sys, phase_cycles, dev)
    with torch.cuda.device(dev):
        rc = getattr(ff.lib(), f"nvmk_{ff.name}_lbfgs_lockstep")(
            positions.data_ptr(), e0.data_ptr(), g0.data_ptr(),
            None if done is None else done.data_ptr(), n_sys, a_pad, sys2mol.data_ptr(),
            count.data_ptr(), batch.offsets.data_ptr(), batch.n_mols, flat.table_pointers(batch),
            *ff.extra_args(batch), policy(), MAX_LS_ITERS, int(max_iters), float(grad_tol),
            pos_out.data_ptr(), energies.data_ptr(), status.data_ptr(), searches.data_ptr(),
            probes.data_ptr(), accepted.data_ptr(), lbfgs_flat.stages(ff, a_pad, n_sys, True, dev),
            None if cycles is None else cycles.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{ff.name}_lbfgs_lockstep kernel launch failed with CUDA error {rc}")
    launch_counts[f"{ff.name}_lbfgs_lockstep"] += 1
    return BfgsResult(positions=pos_out, energies=energies, converged=(status & CONVERGED) != 0,
                      n_iters=probes, status=status, n_accepted=accepted, n_searches=searches,
                      phase_cycles=cycles)


def _two_phases(run, positions, max_iters: int, phase1_iters: int) -> BfgsResult:
    """The restart (``ops/minimize_driver.py``): ``run(x, iters, done)`` for
    ``min(phase1_iters, max_iters)`` iterations, then again from where phase
    1 left every system, for the rest, the converged systems passed as
    ``done``. Counts add up over the phases; a system converged in phase 1
    keeps phase 1's result."""
    phase1 = min(phase1_iters, max_iters)
    r1 = run(positions, phase1, None)
    if phase1 >= max_iters:
        return r1
    r2 = run(r1.positions, max_iters - phase1, r1.status)
    return dataclasses.replace(
        r2, energies=torch.where(r1.converged, r1.energies, r2.energies),
        n_iters=r1.n_iters + r2.n_iters, n_accepted=r1.n_accepted + r2.n_accepted,
        n_searches=r1.n_searches + r2.n_searches,
        phase_cycles=None if r1.phase_cycles is None else r1.phase_cycles + r2.phase_cycles)


def minimize_restarting(
    ff: flat.ForceField,
    positions: torch.Tensor,
    batch,
    sys2mol: torch.Tensor,
    max_iters: int = 200,
    grad_tol: float = 1e-4,
    phase1_iters: int = PHASE1_ITERS,
    phase_cycles: bool = False,
) -> BfgsResult:
    """The JAX package's MMFF/UFF driver over :func:`lbfgs_lockstep`:
    ``min(phase1_iters, max_iters)`` iterations, then every system not
    converged restarts from where phase 1 left it for the rest of
    ``max_iters``. On CUDA two launches of the force field's kernel and of
    K23, with no host sync between them."""
    return _two_phases(
        lambda x, n, done: lbfgs_lockstep(ff, x, batch, sys2mol, n, grad_tol, done,
                                          phase_cycles),
        positions, max_iters, phase1_iters)


def minimize_restarting_plain(
    energy_and_grad_fn: Callable,
    positions: torch.Tensor,
    atom_mask: torch.Tensor,
    max_iters: int = 200,
    grad_tol: float = 1e-4,
    phase1_iters: int = PHASE1_ITERS,
) -> BfgsResult:
    """:func:`minimize_restarting`'s plain twin over any
    ``energy_and_grad_fn``, on any device."""
    return _two_phases(
        lambda x, n, done: lbfgs_lockstep_plain(energy_and_grad_fn, x, atom_mask, n, grad_tol,
                                                done),
        positions, max_iters, phase1_iters)
