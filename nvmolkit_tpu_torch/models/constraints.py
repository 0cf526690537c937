"""Force-field constraints (distance, position, angle, torsion): kernel K7
and its plain PyTorch version.

The port's counterpart of ``nvmolkit_tpu/models/constraints.py`` (itself
nvMolKit's ``src/forcefields/forcefield_constraints.h:30-98``): flat-bottomed
harmonic penalties added to any force field's energy, zero inside a window
[lo, hi] and half-harmonic outside; angles and torsions in degrees, the
torsion's violation circular. Relative windows resolve against the
coordinates current at build time, with the JAX package's formulas on the
host (numpy on the float32 coordinates, as it computes them).

The layout is the port's: :class:`ConstraintBatch` holds one flat table per
kind over the systems, with int32 offsets [4, S + 1] (system s's terms of
kind k are rows ``offsets[k, s]:offsets[k, s + 1]``): distance ``[i, j | lo,
hi, k]``, position ``[i | x0, y0, z0, maxd, k]``, angle ``[i, j, k | lo, hi,
kf]`` and torsion ``[i, j, k, l | lo, hi, kf]``. It replaces the JAX
package's padded rows with their ``sys`` and ``mask`` columns.

:func:`constraint_energy_and_grad` launches K7 (``csrc/constraints.cu``, a
block per :data:`SYSTEMS_PER_BLOCK` systems, a thread per term, each kind's
terms on whole warps) for CUDA tensors and runs :func:`constraint_energy_and_grad_plain` (the energy in
torch, the gradient by ``torch.autograd.grad``) for CPU tensors;
:func:`launch_clocked` is K7 with each system's phase cycles
(:data:`K7_PHASES`). K8 stages each system's terms in shared memory once
and evaluates them inside the force field's evaluation
(``csrc/constraints.cuh``). One departure from the JAX function:
where a constrained angle is exactly linear (cos = +-1), JAX's gradient is
NaN, inside the window or out (autodiff meets arccos's infinite derivative
there); the plain version and K7 take that derivative as 0.
``launch_counts`` counts K7's launches.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from nvmolkit_tpu_torch._build import constraints_lib

KINDS = ("distance", "position", "angle", "torsion")
ARITY = (2, 1, 3, 4)
N_PARAMS = (3, 5, 3, 3)
_DEG = 180.0 / np.pi

# the phases of K7's per-warp clock (launch_clocked; csrc/constraints.cu):
# the rows zeroed and the range's offsets read, the terms' rows and
# systems, the terms with their gradient adds, the energies written; and
# the systems a block of K7 takes
K7_PHASES = ("zero", "row", "term", "energy")
SYSTEMS_PER_BLOCK = 8

launch_counts = {"constraint_energy_grad": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


@dataclasses.dataclass
class PerSystemConstraints:
    """Host-side accumulating constraint lists for one system."""

    distance: list[tuple[int, int, float, float, float, bool]] = dataclasses.field(
        default_factory=list)  # (i, j, lo_or_minus, hi_or_plus, k, relative)
    position: list[tuple[int, float, float]] = dataclasses.field(
        default_factory=list)  # (i, max_displacement, k)
    angle: list[tuple[int, int, int, float, float, float, bool]] = dataclasses.field(
        default_factory=list)
    torsion: list[tuple[int, int, int, int, float, float, float, bool]] = dataclasses.field(
        default_factory=list)

    def empty(self) -> bool:
        return not (self.distance or self.position or self.angle or self.torsion)


@dataclasses.dataclass
class ConstraintBatch:
    """The constraints of S systems (see the module doc)."""

    offsets: torch.Tensor             # int32 [4, S + 1]
    atoms: tuple[torch.Tensor, ...]   # per kind int32 [T, arity]
    params: tuple[torch.Tensor, ...]  # per kind float32 [T, P]
    systems: tuple[torch.Tensor, ...]  # per kind int32 [T]: each term's system

    @property
    def n_systems(self) -> int:
        return int(self.offsets.shape[1]) - 1

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    def pointers(self):
        """The 13 device pointers K7 and K8 take: the offsets, the atom
        columns of the four kinds, their parameter rows (K8 reads these 9),
        then each kind's systems (K7)."""
        tensors = (self.offsets,) + self.atoms + self.params + self.systems
        return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def build_constraint_batch(constraints: list[PerSystemConstraints], ref_positions: np.ndarray,
                           *, device) -> ConstraintBatch:
    """Resolve relative windows against ``ref_positions`` [S, A, 3] (float32,
    the coordinates at build time) and pack every system's constraints, on
    ``device``."""
    ref = np.asarray(ref_positions, np.float32)

    def resolve_distance(s, c):
        i, j, lo, hi, k, relative = c
        if relative:
            d0 = float(np.linalg.norm(ref[s, i] - ref[s, j]))
            lo, hi = d0 - lo, d0 + hi
        return (i, j), (lo, hi, k)

    def resolve_angle(s, c):
        i, j, k_at, lo, hi, k, relative = c
        if relative:
            u = ref[s, i] - ref[s, j]
            v = ref[s, k_at] - ref[s, j]
            a0 = float(np.degrees(np.arccos(np.clip(
                np.dot(u, v) / max(np.linalg.norm(u) * np.linalg.norm(v), 1e-9), -1, 1))))
            lo, hi = a0 - lo, a0 + hi
        return (i, j, k_at), (lo, hi, k)

    def resolve_torsion(s, c):
        i, j, k_at, l, lo, hi, k, relative = c
        if relative:
            p = ref[s]
            b1, b2, b3 = p[j] - p[i], p[k_at] - p[j], p[l] - p[k_at]
            n1, n2 = np.cross(b1, b2), np.cross(b2, b3)
            m1 = np.cross(n1, b2 / max(np.linalg.norm(b2), 1e-9))
            phi0 = float(np.degrees(np.arctan2(np.dot(m1, n2), np.dot(n1, n2))))
            lo, hi = phi0 - lo, phi0 + hi
        return (i, j, k_at, l), (lo, hi, k)

    def resolve_position(s, c):
        i, maxd, k = c
        p0 = ref[s, i]
        return (i,), (p0[0], p0[1], p0[2], maxd, k)

    resolvers = (resolve_distance, resolve_position, resolve_angle, resolve_torsion)
    atoms = [[] for _ in KINDS]
    params = [[] for _ in KINDS]
    counts = np.zeros((len(KINDS), len(constraints)), np.int64)
    for s, cs in enumerate(constraints):
        for k, kind in enumerate(KINDS):
            for c in getattr(cs, kind):
                a, p = resolvers[k](s, c)
                atoms[k].append(a)
                params[k].append(p)
            counts[k, s] = len(getattr(cs, kind))
    offsets = np.zeros((len(KINDS), len(constraints) + 1), np.int64)
    np.cumsum(counts, axis=1, out=offsets[:, 1:])
    systems = np.arange(len(constraints), dtype=np.int32)
    return ConstraintBatch(
        offsets=torch.from_numpy(offsets.astype(np.int32)).to(device),
        atoms=tuple(torch.from_numpy(np.asarray(a, np.int32).reshape(-1, ARITY[k])).to(device)
                    for k, a in enumerate(atoms)),
        params=tuple(torch.from_numpy(np.asarray(p, np.float32).reshape(-1, N_PARAMS[k])).to(device)
                     for k, p in enumerate(params)),
        systems=tuple(torch.from_numpy(np.repeat(systems, counts[k])).to(device)
                      for k in range(len(KINDS))))


# ---- the plain version --------------------------------------------------------

def _window(x, lo, hi, k):
    v = torch.clamp_min(x - hi, 0.0) + torch.clamp_min(lo - x, 0.0)
    return 0.5 * k * v * v


def _arccos_deg(c):
    """arccos in degrees, its derivative taken as 0 at cos = +-1 (see the
    module doc)."""
    edge = c.abs() >= 1.0
    return torch.where(edge, torch.arccos(c.detach()), torch.arccos(torch.where(edge, 0.0, c))) * _DEG


def _distance(p, q):
    d = p[0] - p[1]
    return _window(torch.sqrt((d * d).sum(-1) + 1e-12), q[:, 0], q[:, 1], q[:, 2])


def _position(p, q):
    d = p[0] - q[:, 0:3]
    return _window(torch.sqrt((d * d).sum(-1) + 1e-12), 0.0, q[:, 3], q[:, 4])


def _angle(p, q):
    u, v = p[0] - p[1], p[2] - p[1]
    nu = torch.sqrt((u * u).sum(-1) + 1e-12)
    nv = torch.sqrt((v * v).sum(-1) + 1e-12)
    ang = _arccos_deg(torch.clamp((u * v).sum(-1) / (nu * nv), -1.0, 1.0))
    return _window(ang, q[:, 0], q[:, 1], q[:, 2])


def _torsion(p, q):
    b1, b2, b3 = p[1] - p[0], p[2] - p[1], p[3] - p[2]
    n1, n2 = torch.linalg.cross(b1, b2), torch.linalg.cross(b2, b3)
    m1 = torch.linalg.cross(n1, b2 / torch.linalg.norm(b2, dim=-1, keepdim=True).clamp_min(1e-9))
    phi = torch.rad2deg(torch.atan2((m1 * n2).sum(-1), (n1 * n2).sum(-1)))
    lo, hi, k = q.unbind(1)
    delta = torch.remainder(phi - 0.5 * (lo + hi) + 180.0, 360.0) - 180.0
    viol = torch.clamp_min(delta.abs() - 0.5 * (hi - lo), 0.0)
    return 0.5 * k * viol * viol


_TERMS = (_distance, _position, _angle, _torsion)


def _check(positions: torch.Tensor, batch: ConstraintBatch) -> None:
    if positions.dim() != 3 or positions.shape[2] != 3:
        raise ValueError(f"positions must be [S, A, 3], got {tuple(positions.shape)}")
    if positions.shape[0] != batch.n_systems:
        raise ValueError(f"positions hold {positions.shape[0]} systems, the constraints "
                         f"{batch.n_systems}")


def _expand(positions: torch.Tensor, batch: ConstraintBatch):
    """Per kind, (system of each term, flat atom indices into [S * A])."""
    _check(positions, batch)
    dev = batch.device
    out = []
    for k in range(len(KINDS)):
        off = batch.offsets[k].to(torch.int64)
        sys_of = torch.repeat_interleave(torch.arange(batch.n_systems, device=dev),
                                         off[1:] - off[:-1])
        out.append((sys_of, batch.atoms[k].to(torch.int64) + (sys_of * positions.shape[1])[:, None]))
    return out


def constraint_energy_plain(positions: torch.Tensor, batch: ConstraintBatch) -> torch.Tensor:
    """Per-system constraint energies [S] (kcal/mol)."""
    flat = positions.reshape(-1, 3)
    total = torch.zeros(positions.shape[0], dtype=positions.dtype, device=positions.device)
    for k, (sys_of, idx) in enumerate(_expand(positions, batch)):
        e = _TERMS[k]([flat[idx[:, q]] for q in range(ARITY[k])],
                      batch.params[k].to(positions.dtype))
        total = total + torch.zeros_like(total).index_add_(0, sys_of, e)
    return total


def constraint_energy_and_grad_plain(positions: torch.Tensor, batch: ConstraintBatch):
    """(energy [S], gradient [S, A, 3]), the gradient by autograd."""
    with torch.enable_grad():
        x = positions.detach().requires_grad_(True)
        e = constraint_energy_plain(x, batch)
        (g,) = torch.autograd.grad(e.sum(), x)
    return e.detach(), g


def constraint_magnitudes_plain(positions: torch.Tensor, batch: ConstraintBatch):
    """(per-system sum of |E_term| [S], per component the sum over terms of
    |dE_term/dx| [S, A, 3]), float64: the scales of float32 rounding."""
    flat = positions.detach().reshape(-1, 3)
    total = torch.zeros(positions.shape[0], dtype=torch.float64, device=positions.device)
    g_abs = torch.zeros(flat.shape, dtype=torch.float64, device=positions.device)
    for k, (sys_of, idx) in enumerate(_expand(positions, batch)):
        with torch.enable_grad():
            p = [flat[idx[:, q]].requires_grad_(True) for q in range(ARITY[k])]
            e = _TERMS[k](p, batch.params[k].to(positions.dtype))
            grads = torch.autograd.grad(e.sum(), p)
        total.index_add_(0, sys_of, e.detach().abs().double())
        for q, gq in enumerate(grads):
            g_abs.index_add_(0, idx[:, q], gq.abs().double())
    return total, g_abs.reshape(positions.shape)


# ---- the kernels' order of work, in torch -----------------------------------------

# csrc/constraints.cuh: the terms K8 stages a system at most (C_STAGE_MAX),
# and the block K7 and K8 run on
STAGE_MAX = 32
WARPS, THREADS = 4, 128


def term_schedule(offsets, cap: int = STAGE_MAX) -> dict[str, np.ndarray]:
    """How the kernels take each system's terms (``csrc/constraints.cuh``):
    one list a system over the four kinds in order (``TermList``); in K8's
    probe entry t of a system of T terms goes to slot r = T - 1 - t
    (``term_slot_of_thread``: warp WARPS - 1 - r mod WARPS, lane (r mod
    THREADS) / WARPS, round r / THREADS: the last entries, the longest
    terms, to warps 3, 2, 1, 0 first), staged in shared memory when t <
    ``cap``. K7 (``csrc/constraints.cu``) gives block b the systems
    [b S, b S + S) (S = SYSTEMS_PER_BLOCK) and their terms a slot each,
    kind by kind, each kind's run of slots from a multiple of 32. Per entry
    (every row of every kind once): its ``system``, ``kind``, table
    ``row``, list index ``entry``, K8's ``thread`` and ``round``,
    ``staged``, and K7's ``block`` and ``slot``."""
    off = np.asarray(offsets, np.int64)
    counts = off[:, 1:] - off[:, :-1]
    start = np.zeros((len(KINDS) + 1, counts.shape[1]), np.int64)
    np.cumsum(counts, axis=0, out=start[1:])
    parts = []
    for k in range(len(KINDS)):
        sys_of = np.repeat(np.arange(counts.shape[1]), counts[k])
        rows = np.arange(off[k, 0], off[k, -1])
        parts.append((sys_of, np.full(len(rows), k), rows, start[k, sys_of] + rows - off[k, sys_of]))
    system, kind, row, entry = (np.concatenate(c) for c in zip(*parts))
    rev = start[len(KINDS), system] - 1 - entry
    slot = rev % THREADS
    # K7: block b's range of each kind's rows, runs padded to 32 slots
    n_blocks = -(-counts.shape[1] // SYSTEMS_PER_BLOCK)
    edge = np.minimum(np.arange(n_blocks + 1) * SYSTEMS_PER_BLOCK, counts.shape[1])
    lo, hi = off[:, edge[:-1]], off[:, edge[1:]]  # [4, blocks]
    run = np.zeros((len(KINDS) + 1, n_blocks), np.int64)
    np.cumsum((hi - lo + 31) // 32 * 32, axis=0, out=run[1:])
    block = system // SYSTEMS_PER_BLOCK
    return {"system": system, "kind": kind, "row": row, "entry": entry,
            "thread": (WARPS - 1 - slot % WARPS) * 32 + slot // WARPS,
            "round": rev // THREADS, "staged": entry < cap, "block": block,
            "slot": run[kind, block] + row - lo[kind, block]}


def constraint_energy_and_grad_model(positions: torch.Tensor, batch: ConstraintBatch,
                                     cap: int = STAGE_MAX):
    """K8's constraint terms as a probe evaluates them, on the CPU: every
    entry of :func:`term_schedule` (staged or, past ``cap``, read from the
    tables), each thread's energies summed in round order, then each warp's
    threads, then the warps in order (the force field's closing sum, into
    which K8 folds them); the gradient by autograd through each entry.
    Returns (energy [S], gradient [S, A, 3], the schedule)."""
    sched = term_schedule(batch.offsets.cpu().numpy(), cap)
    S, A, _ = positions.shape
    with torch.enable_grad():
        x = positions.detach().requires_grad_(True)
        flat = x.reshape(-1, 3)
        e_entry = torch.zeros(len(sched["entry"]), dtype=positions.dtype)
        for k in range(len(KINDS)):
            sel = np.nonzero(sched["kind"] == k)[0]
            if len(sel) == 0:
                continue
            # the slab holds copies of the staged rows: either source reads
            # the same atoms and parameters
            rows = torch.from_numpy(sched["row"][sel])
            atoms, params = batch.atoms[k][rows].long(), batch.params[k][rows]
            idx = atoms + torch.from_numpy(sched["system"][sel] * A)[:, None]
            e_entry = e_entry.index_put((torch.from_numpy(sel),), _TERMS[k](
                [flat[idx[:, q]] for q in range(ARITY[k])], params.to(positions.dtype)))
        (g,) = torch.autograd.grad(e_entry.sum(), x) if len(e_entry) else (torch.zeros_like(x),)
    e_thread = torch.zeros((S, THREADS), dtype=positions.dtype)
    for r in range(int(sched["round"].max()) + 1 if len(e_entry) else 0):
        sel = torch.from_numpy(np.nonzero(sched["round"] == r)[0])
        e_thread.index_put_((torch.from_numpy(sched["system"])[sel],
                             torch.from_numpy(sched["thread"])[sel]), e_entry.detach()[sel],
                            accumulate=True)
    energy = torch.zeros(S, dtype=positions.dtype)
    for w in range(WARPS):
        energy = energy + e_thread[:, 32 * w:32 * (w + 1)].sum(dim=1)
    return energy, g, sched


# ---- kernel K7 ------------------------------------------------------------------

def constraint_energy_and_grad(positions: torch.Tensor, batch: ConstraintBatch,
                               atom_count: torch.Tensor):
    """(energy [S], gradient [S, A, 3]) of the constraints at ``positions``
    [S, A, 3]; ``atom_count`` int32 [S] bounds each system's gradient rows
    (zero past them). K7 for CUDA tensors, the plain version for CPU
    tensors."""
    if not positions.is_cuda:
        e, g = constraint_energy_and_grad_plain(positions, batch)
        mask = torch.arange(positions.shape[1])[None] < atom_count.to(torch.int64)[:, None]
        return e, torch.where(mask[..., None], g, 0.0)
    return _launch(positions, batch, atom_count, False)[:2]


def launch_clocked(positions: torch.Tensor, batch: ConstraintBatch, atom_count: torch.Tensor):
    """K7 (CUDA tensors) with each warp's cycles per phase: (energy [S],
    gradient [S, A, 3], int64 [blocks, 4, len(K7_PHASES)]; a block takes
    SYSTEMS_PER_BLOCK systems)."""
    return _launch(positions, batch, atom_count, True)


def _launch(positions, batch, atom_count, clocked: bool):
    _check(positions, batch)
    if positions.dtype != torch.float32 or atom_count.dtype != torch.int32:
        raise ValueError("K7 takes float32 positions and int32 atom counts")
    tensors = (positions, atom_count, batch.offsets) + batch.atoms + batch.params + batch.systems
    if any(t.device != positions.device or not t.is_contiguous() for t in tensors):
        raise ValueError("K7's inputs must be contiguous and on one device")
    n_sys, a_pad = positions.shape[:2]
    dev = positions.device
    energy = torch.empty(n_sys, dtype=torch.float32, device=dev)
    grad = torch.empty_like(positions)
    lib = constraints_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if clocked:
            blocks = -(-n_sys // SYSTEMS_PER_BLOCK)
            cycles = torch.zeros((blocks, WARPS, len(K7_PHASES)), dtype=torch.int64, device=dev)
            rc = lib.nvmk_constraint_energy_grad_cycles(
                positions.data_ptr(), n_sys, a_pad, batch.pointers(), energy.data_ptr(),
                grad.data_ptr(), cycles.data_ptr(), stream)
        else:
            cycles = None
            rc = lib.nvmk_constraint_energy_grad(
                positions.data_ptr(), n_sys, a_pad, batch.pointers(), energy.data_ptr(),
                grad.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"constraint_energy_grad kernel launch failed with CUDA error {rc}")
    launch_counts["constraint_energy_grad"] += 1
    return energy, grad, cycles
