"""Flat batched L-BFGS: kernel K5 and its plain PyTorch version.

Per system, the minimizer of ``nvmolkit_tpu/ops/lbfgs_flat.py``
(``_flat_impl`` with ``compact_after`` off): one energy and gradient
evaluation per step; each system carries its own Numerical-Recipes line
search (lambda, the previous lambda and energy, a probe count) and its own
count of accepted steps. A probe that meets the sufficient-decrease test is
accepted: the convergence tests run, the L-BFGS history (6 deep) is updated
and the next direction is built by the two-loop recursion, capped at
maxStep. A rejected probe backtracks lambda. Lambda underflow counts as
converged, ``MAX_LS_ITERS`` probes as failed, ``max_iters`` accepted steps as
capped, and ``max_iters * MAX_LS_ITERS`` probes end the run.

* :func:`lbfgs_flat_plain` is the plain version, written as the JAX
  function is, over any ``energy_and_grad_fn``; a system's ``n_iters`` is the
  number of probes it made. With ``fused=True`` it is the torch model of the
  kernel's own order: the direction by the two-loop recursion's compact form
  (:func:`compact_direction`) and the slope and lambda_min from the
  uncapped direction (:func:`fused_cap`).
* :func:`lbfgs` minimizes the systems of a force-field batch
  (:func:`mmff_lbfgs`, :func:`uff_lbfgs`): on CUDA it launches the force
  field's energy kernel (K4 or K6) on the starting positions and then K5
  (``csrc/minimizers.cuh``, instantiated in ``csrc/mmff.cu`` and
  ``csrc/uff.cu``) once, one block per system for its whole minimization
  from those energies and gradients, each probe a call of the force field's
  device function (DG and ETK read their pair bounds from shared memory,
  staged once per system, by :func:`stages`); on the CPU it runs the
  plain version over the force field's plain energy and gradient. A build
  or launch failure raises. ``phase_cycles=True`` returns K5's cycles per
  phase (``K5_PHASES``), and :func:`kernel_info` the attributes of the
  instantiation a launch takes (``tools/lbfgs_phase_split.py``).

Both return each system's status bits, probes and accepted steps.

Unlike the JAX package's driver (``ops/minimize_driver.py``), nothing
restarts the systems still running after a phase with a fresh history and a
second ``max_iters`` budget: ``max_iters`` is the total, as in nvMolKit.
``launch_counts`` counts K5's launches per force field, under
``<name>_lbfgs`` (0 for one not launched since the last reset; the force
fields' own kernels are counted by their modules).
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Callable

import torch

from nvmolkit_tpu_torch.models import flat
from nvmolkit_tpu_torch.models.mmff.energy import MMFF
from nvmolkit_tpu_torch.models.uff.energy import UFF
from nvmolkit_tpu_torch.ops.bfgs import (
    CONVERGED,
    EPS,
    FUNCTOL,
    MAX_LS_ITERS,
    MAXSTEP_FACTOR,
    MOVETOL,
    TOLF,
    TOLX,
    BfgsResult,
    policy,
    status_bits,
)

HISTORY = 6
# the phases of K5's and K23's cycle split (lbfgs(..., phase_cycles=True);
# csrc/minimizers.cuh LBFGS_PHASES)
K5_PHASES = ["init", "eval", "step", "accept", "direction", "wait"]
# the largest a_pad at which K5 and K23 always stage the DG and ETK bounds
# in shared memory (0: only by the size of the launch; see stages)
STAGE_MAX_ATOMS = 64

launch_counts: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    launch_counts.clear()


def compact_direction(grad, s_hist, y_hist, rho, gamma) -> torch.Tensor:
    """-H g of the L-BFGS two-loop recursion in its compact form, as K5 and
    K23 compute it (``csrc/minimizers.cuh``): the recursion's scalars from the
    history's dot products (s_k . y_j, y_k . y_j) and g's with every pair,
    then one pass over the history. ``grad`` [S, N]; ``s_hist``, ``y_hist``
    [m, S, N] and ``rho`` [m, S] newest first (rho 0: an empty slot, never
    read); ``gamma`` [S]. Newest first, alpha_k = rho_k (s_k . g - sum_{j<k}
    alpha_j s_k . y_j); oldest first, beta_k = rho_k (gamma (y_k . g - sum_j
    alpha_j y_k . y_j) + sum_{j>k} (alpha_j - beta_j) s_j . y_k), that last
    sum taken oldest first (each term as beta_j is known); then d =
    -gamma g + sum_k gamma alpha_k y_k - sum_k (alpha_k - beta_k) s_k. Equal
    to the two-loop recursion's direction in exact arithmetic."""
    m = s_hist.shape[0]
    live = rho > 0
    zero = torch.zeros_like(gamma)
    g_s = (s_hist * grad).sum(dim=-1)
    g_y = (y_hist * grad).sum(dim=-1)
    sy = torch.einsum("ksn,jsn->kjs", s_hist, y_hist)
    yy = torch.einsum("ksn,jsn->kjs", y_hist, y_hist)
    alpha = []
    for k in range(m):
        sq = g_s[k]
        for j in range(k):
            sq = sq - torch.where(live[j], alpha[j] * sy[k, j], zero)
        alpha.append(torch.where(live[k], rho[k] * sq, zero))
    beta = [zero] * m
    for k in reversed(range(m)):
        yq = g_y[k]
        for j in range(m):
            yq = yq - torch.where(live[j], alpha[j] * yy[k, j], zero)
        yr = gamma * yq
        for j in reversed(range(k + 1, m)):
            yr = yr + torch.where(live[j], (alpha[j] - beta[j]) * sy[j, k], zero)
        beta[k] = torch.where(live[k], rho[k] * yr, zero)
    d = -gamma[:, None] * grad
    for k in range(m):
        row = live[k][:, None]
        d = torch.where(row, d + (gamma * alpha[k])[:, None] * y_hist[k], d)
        d = torch.where(row, d - (alpha[k] - beta[k])[:, None] * s_hist[k], d)
    return d


def fused_cap(pos, raw_dir, grad, dmask, n_dof):
    """The cap of ``raw_dir`` at maxStep, as K5 and K23 make it: (the capped
    direction, its slope g . d, lambda_min = MOVETOL / max_i(|d_i| /
    max(|x_i|, 1))), the slope and lambda_min as the cap's scale times
    those of the uncapped direction."""
    step_norm = torch.sqrt((raw_dir * raw_dir).sum(dim=1))
    max_step = MAXSTEP_FACTOR * torch.maximum(torch.sqrt((pos * pos * dmask).sum(dim=1)), n_dof)
    scale = torch.where(step_norm > max_step, max_step / torch.clamp_min(step_norm, 1e-30), 1.0)
    rel = raw_dir.abs() / torch.clamp_min(pos.abs(), 1.0)
    slope = scale * (grad * raw_dir).sum(dim=1)
    lam_min = MOVETOL / torch.clamp_min(scale * rel.amax(dim=1), 1e-30)
    return raw_dir * scale[:, None], slope, lam_min


def lbfgs_flat_plain(
    energy_and_grad_fn: Callable,
    positions: torch.Tensor,   # [S, A, D]
    atom_mask: torch.Tensor,   # [S, A] bool
    max_iters: int = 200,
    grad_tol: float = 1e-4,
    max_steps: int | None = None,
    fused: bool = False,
) -> BfgsResult:
    """Minimize every system of ``positions`` under ``energy_and_grad_fn``
    (positions -> (energy [S], gradient [S, A, D])), as the JAX package's
    ``batched_lbfgs_flat_minimize`` does with ``compact_after`` off.
    ``max_steps`` bounds the probes (default ``max_iters * MAX_LS_ITERS``).
    ``fused``: K5's order (:func:`compact_direction`, :func:`fused_cap`)."""
    S, A, D = positions.shape
    N = D * A
    m = HISTORY
    dev, dtype = positions.device, positions.dtype
    dmask = atom_mask.to(dev).repeat_interleave(D, dim=1).reshape(S, N)
    n_dof = dmask.sum(dim=1).to(dtype)

    def eg(p):
        e, g = energy_and_grad_fn(p.reshape(S, A, D))
        return e, g.reshape(S, N)

    def two_loop(grad, s_hist, y_hist, rho, gamma):
        q = grad
        alphas = []
        for i in range(m):  # newest first
            a_i = rho[i] * (s_hist[i] * q).sum(dim=1)
            a_i = torch.where(rho[i] > 0, a_i, 0.0)
            q = q - a_i[:, None] * y_hist[i]
            alphas.append(a_i)
        q = q * gamma[:, None]
        for i in reversed(range(m)):
            b_i = rho[i] * (y_hist[i] * q).sum(dim=1)
            b_i = torch.where(rho[i] > 0, b_i, 0.0)
            q = q + (alphas[i] - b_i)[:, None] * s_hist[i]
        return -q

    def prep_direction(pos, raw_dir):
        """Cap at maxStep."""
        step_norm = torch.sqrt((raw_dir * raw_dir).sum(dim=1))
        max_step = MAXSTEP_FACTOR * torch.maximum(
            torch.sqrt((pos * pos * dmask).sum(dim=1)), n_dof)
        scale = torch.where(step_norm > max_step,
                            max_step / torch.clamp_min(step_norm, 1e-30), 1.0)
        return raw_dir * scale[:, None]

    def lam_min_of(pos, direction):
        rel = direction.abs() / torch.clamp_min(pos.abs(), 1.0)
        return MOVETOL / torch.clamp_min(rel.amax(dim=1), 1e-30)

    def masked_max(x):
        return torch.where(dmask, x, 0.0).amax(dim=1)

    pos = positions.reshape(S, N)
    e, grad = eg(pos)
    failed = ~(torch.isfinite(e) & torch.isfinite(grad).all(dim=1))
    # zero-gradient test BEFORE the first step (NR dfpmin does the same)
    gs0 = grad.abs() * torch.clamp_min(pos.abs(), 1.0)
    converged = (masked_max(gs0) / torch.clamp_min(e.abs(), 1.0) < grad_tol) & ~failed
    if fused:
        direction, slope, lam_min = fused_cap(pos, -grad, grad, dmask, n_dof)
    else:
        direction = prep_direction(pos, -grad)
        slope = (grad * direction).sum(dim=1)
        lam_min = lam_min_of(pos, direction)
    lam = torch.ones(S, dtype=dtype, device=dev)
    lam2 = torch.zeros(S, dtype=dtype, device=dev)
    e2 = e
    ls_it = torch.zeros(S, dtype=torch.int32, device=dev)
    s_hist = torch.zeros((m, S, N), dtype=dtype, device=dev)
    y_hist = torch.zeros((m, S, N), dtype=dtype, device=dev)
    rho = torch.zeros((m, S), dtype=dtype, device=dev)
    gamma = torch.ones(S, dtype=dtype, device=dev)
    outer = torch.zeros(S, dtype=torch.int32, device=dev)
    capped = torch.zeros(S, dtype=torch.bool, device=dev)
    n_iters = torch.zeros(S, dtype=torch.int32, device=dev)

    if max_steps is None:
        max_steps = max_iters * MAX_LS_ITERS
    for _ in range(max_steps):
        live = ~(converged | failed | capped)
        if not bool(live.any()):
            break
        n_iters += live.to(torch.int32)
        trial = pos + lam[:, None] * direction
        e_t, g_t = eg(trial)

        # --- NR sufficient-decrease test ---------------------------------
        accept = (e_t - e <= FUNCTOL * lam * slope) & live

        # --- backtracking lambda for rejecting systems --------------------
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
            a.abs() < 1e-20,
            -slope / (2.0 * b_safe),
            torch.where(disc < 0, 0.5 * lam,
                        (-b + torch.sqrt(torch.clamp_min(disc, 0.0))) / (3.0 * a_safe)),
        )
        quad = -slope * lam * lam / (2.0 * torch.clamp_min(rhs1, 1e-30))
        tmp = torch.where(ls_it == 0, quad, cubic)
        tmp = torch.minimum(tmp, 0.5 * lam)
        new_lam = torch.maximum(tmp, 0.1 * lam)

        reject = live & ~accept
        # lambda underflow: no acceptable move => converged (TOLX)
        conv_ls = reject & (new_lam < lam_min)
        # probe-count cap: NaN-poisoned or pathological line searches
        exhausted = reject & (ls_it + 1 >= MAX_LS_ITERS) & ~conv_ls

        # --- accept path: convergence tests + L-BFGS update ---------------
        acc_row = accept[:, None]
        xi = torch.where(acc_row, trial - pos, 0.0)
        xi_rel = xi.abs() / torch.clamp_min(trial.abs(), 1.0)
        conv_x = masked_max(xi_rel) < TOLX
        gscaled = g_t.abs() * torch.clamp_min(trial.abs(), 1.0)
        conv_g = masked_max(gscaled) / torch.clamp_min(e_t.abs(), 1.0) < grad_tol
        conv_f = 2.0 * (e - e_t).abs() <= TOLF * (e.abs() + e_t.abs() + 1e-10)
        newly_conv = accept & (conv_x | conv_g | conv_f)

        dgrad = g_t - grad
        ys = (dgrad * xi).sum(dim=1)
        yy = (dgrad * dgrad).sum(dim=1)
        store = (ys > EPS) & accept
        new_rho = torch.where(store, 1.0 / torch.clamp_min(ys, 1e-30), 0.0)
        new_s = [torch.where(acc_row, torch.where(store[:, None], xi, 0.0), s_hist[0])]
        new_y = [torch.where(acc_row, torch.where(store[:, None], dgrad, 0.0), y_hist[0])]
        new_r = [torch.where(accept, new_rho, rho[0])]
        for i in range(1, m):
            new_s.append(torch.where(acc_row, s_hist[i - 1], s_hist[i]))
            new_y.append(torch.where(acc_row, y_hist[i - 1], y_hist[i]))
            new_r.append(torch.where(accept, rho[i - 1], rho[i]))
        s_hist = torch.stack(new_s)
        y_hist = torch.stack(new_y)
        rho = torch.stack(new_r)
        gamma = torch.where(store, ys / torch.clamp_min(yy, 1e-30), gamma)

        # new state for accepted systems
        pos = torch.where(acc_row, trial, pos)
        e = torch.where(accept, e_t, e)
        grad = torch.where(acc_row, g_t, grad)
        outer = outer + accept.to(torch.int32)
        capped = capped | (accept & ~newly_conv & (outer >= max_iters))

        if fused:
            new_dir, new_slope, new_lam_min = fused_cap(
                pos, compact_direction(grad, s_hist, y_hist, rho, gamma), grad, dmask, n_dof)
        else:
            new_dir = prep_direction(pos, two_loop(grad, s_hist, y_hist, rho, gamma))
            new_slope = (grad * new_dir).sum(dim=1)
            new_lam_min = lam_min_of(pos, new_dir)
        direction = torch.where(acc_row, new_dir, direction)
        slope = torch.where(accept, new_slope, slope)
        lam_min = torch.where(accept, new_lam_min, lam_min)

        lam2 = torch.where(accept, 0.0, torch.where(reject, lam, lam2))
        e2 = torch.where(accept, e, torch.where(reject, e_t, e2))
        lam = torch.where(accept, 1.0, torch.where(reject, new_lam, lam))
        ls_it = torch.where(accept, 0, ls_it + reject.to(torch.int32))
        converged = converged | newly_conv | conv_ls
        failed = failed | exhausted

    return BfgsResult(positions=pos.reshape(S, A, D), energies=e, converged=converged,
                      n_iters=n_iters, status=status_bits(converged, failed, capped),
                      n_accepted=outer)


def kernel_info(ff: flat.ForceField, a_pad: int, lockstep: bool = False,
                staged: bool | None = None) -> dict:
    """What the card makes of an instantiation of K5 (or, ``lockstep``, K23)
    over ``ff`` at ``a_pad``: its registers, spilled (local) bytes per
    thread, resident blocks per SM, shared bytes per block, and whether it
    stages the pair bounds. ``staged`` asks for the staged (True) or
    unstaged (False) one, by default the one a launch of more systems than
    fit in one wave takes at ``a_pad``."""
    if staged is None:
        staged = a_pad <= STAGE_MAX_ATOMS
    out = (ctypes.c_int * 5)()
    rc = getattr(ff.lib(), f"nvmk_{ff.name}_lbfgs_info")(int(lockstep), a_pad, int(staged), out)
    if rc != 0:
        raise RuntimeError(f"{ff.name}_lbfgs_info failed with CUDA error {rc}")
    return {"registers": out[0], "local_bytes": out[1], "blocks_per_sm": out[2],
            "shared_bytes": out[3], "staged": bool(out[4])}


@functools.lru_cache(maxsize=None)
def _staged_slots(ff: flat.ForceField, a_pad: int, lockstep: bool, device: int) -> int:
    """The systems a staged launch over ``ff`` at ``a_pad`` runs at once on
    ``device``: SMs x resident blocks per SM (0 where nothing is staged)."""
    with torch.cuda.device(device):
        info = kernel_info(ff, a_pad, lockstep, staged=True)
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * info["blocks_per_sm"] if info["staged"] else 0


def stages(ff: flat.ForceField, a_pad: int, n_sys: int, lockstep: bool, device) -> int:
    """Whether K5 (or, ``lockstep``, K23) stages ``ff``'s pair bounds in
    shared memory for a launch of ``n_sys`` systems at ``a_pad`` on
    ``device``: up to STAGE_MAX_ATOMS atoms always (faster at every launch
    size measured), past them where the launch fits in one wave of staged
    blocks, as an embedding's retries do (each block is faster; the
    occupancy the shared memory costs adds no wave). The C side stages only
    a force field with pair bounds (DG, ETK)."""
    if a_pad <= STAGE_MAX_ATOMS:
        return 1
    return int(n_sys <= _staged_slots(ff, a_pad, lockstep, torch.device(device).index or 0))


def cycles_buffer(n_sys: int, on: bool, dev):
    """int64 [n_sys, len(K5_PHASES)] zeros for the phase clock, or None."""
    return torch.zeros((n_sys, len(K5_PHASES)), dtype=torch.int64, device=dev) if on else None


def lbfgs(
    ff: flat.ForceField,
    positions: torch.Tensor,
    batch,
    sys2mol: torch.Tensor,
    max_iters: int = 200,
    grad_tol: float = 1e-4,
    max_steps: int | None = None,
    phase_cycles: bool = False,
) -> BfgsResult:
    """Minimize the systems ``positions`` [S, A, D] of force field ``ff``,
    system s being molecule ``sys2mol[s]`` (int32) of ``batch``. For CUDA
    tensors the force field's kernel (K4 or K6) on the starts, then K5 (one
    launch each); :func:`lbfgs_flat_plain` for CPU tensors. With
    ``phase_cycles`` (CUDA), the result holds K5's cycles per phase."""
    if max_steps is None:
        max_steps = max_iters * MAX_LS_ITERS
    n_sys, a_pad = positions.shape[:2]
    if not positions.is_cuda:
        return lbfgs_flat_plain(ff.plain_energy_and_grad_fn(batch, sys2mol, a_pad), positions,
                                flat.atom_mask(batch, sys2mol, a_pad), max_iters, grad_tol,
                                max_steps=max_steps)
    flat.check_kernel_inputs(positions, batch, sys2mol, "K5", flat.kernel_dim(ff.lib(), ff.name))
    e0, g0 = ff.energy_and_grad(positions, batch, sys2mol)
    dev = positions.device
    pos_out = torch.empty_like(positions)
    energies = torch.empty(n_sys, dtype=torch.float32, device=dev)
    status = torch.empty(n_sys, dtype=torch.int32, device=dev)
    steps = torch.empty(n_sys, dtype=torch.int32, device=dev)
    accepted = torch.empty(n_sys, dtype=torch.int32, device=dev)
    count = flat.system_atoms(batch, sys2mol)
    cycles = cycles_buffer(n_sys, phase_cycles, dev)
    with torch.cuda.device(dev):
        rc = getattr(ff.lib(), f"nvmk_{ff.name}_lbfgs")(
            positions.data_ptr(), e0.data_ptr(), g0.data_ptr(), n_sys, a_pad,
            sys2mol.data_ptr(), count.data_ptr(), batch.offsets.data_ptr(), batch.n_mols,
            flat.table_pointers(batch), *ff.extra_args(batch), policy(), MAX_LS_ITERS,
            int(max_iters), float(grad_tol), int(max_steps), pos_out.data_ptr(),
            energies.data_ptr(), status.data_ptr(), steps.data_ptr(), accepted.data_ptr(),
            stages(ff, a_pad, n_sys, False, dev), None if cycles is None else cycles.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{ff.name}_lbfgs kernel launch failed with CUDA error {rc}")
    launch_counts[f"{ff.name}_lbfgs"] += 1
    return BfgsResult(positions=pos_out, energies=energies, converged=(status & CONVERGED) != 0,
                      n_iters=steps, status=status, n_accepted=accepted, phase_cycles=cycles)


def mmff_lbfgs(positions, batch, sys2mol, max_iters=200, grad_tol=1e-4, max_steps=None):
    """:func:`lbfgs` over MMFF (K4, then K5)."""
    return lbfgs(MMFF, positions, batch, sys2mol, max_iters, grad_tol, max_steps)


def uff_lbfgs(positions, batch, sys2mol, max_iters=200, grad_tol=1e-4, max_steps=None):
    """:func:`lbfgs` over UFF (K6, then K5)."""
    return lbfgs(UFF, positions, batch, sys2mol, max_iters, grad_tol, max_steps)
