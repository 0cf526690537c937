"""Triangle smoothing of distance-bounds matrices: kernel K9 and its plain
PyTorch version.

The port's counterpart of ``nvmolkit_tpu/ops/triangle_smooth.py``
(``triangle_smooth_bounds``): Floyd-Warshall over every pivot k,

    ub[i,j] <- min(ub[i,j], ub[i,k] + ub[k,j])
    lb[i,j] <- max(lb[i,j], lb[i,k] - ub[k,j], lb[k,j] - ub[i,k])

with padded pairs at upper ``_BIG`` and lower 0, then the per-molecule flag
``consistent`` (no real pair with lb > ub + 1e-5) and the diagonal zeroed.

* :func:`triangle_smooth_bounds_plain` is the JAX function written in
  PyTorch, pivot for pivot over the whole padded matrix; it equals the JAX
  function bit for bit.
* :func:`triangle_smooth_bounds` launches K9 (``csrc/triangle_smooth.cu``,
  one block per molecule for every pivot) for CUDA tensors, which equals the
  plain version bit for bit, and runs the plain version for CPU tensors. A
  build or launch failure raises.

Each molecule's real atoms come first; ``n_atoms`` counts them.
``launch_counts`` counts K9's launches.
"""
from __future__ import annotations

import torch

_BIG = 1e6

launch_counts = {"triangle_smooth": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def atom_mask_of(n_atoms: torch.Tensor, a_pad: int) -> torch.Tensor:
    """bool [M, a_pad]: the first ``n_atoms[m]`` atoms of each molecule."""
    return torch.arange(a_pad, device=n_atoms.device)[None] < n_atoms.to(torch.int64)[:, None]


def triangle_smooth_bounds_plain(upper: torch.Tensor, lower: torch.Tensor,
                                 n_atoms: torch.Tensor):
    """(ub, lb, consistent [M] bool), as the JAX function computes them."""
    A = upper.shape[1]
    atom_mask = atom_mask_of(n_atoms.to(upper.device), A)
    pair_mask = atom_mask[:, :, None] & atom_mask[:, None, :]
    ub = torch.where(pair_mask, upper, _BIG)
    lb = torch.where(pair_mask, lower, 0.0)
    for k in range(A):
        ub_ik, ub_kj = ub[:, :, k], ub[:, k, :]
        lb_ik, lb_kj = lb[:, :, k], lb[:, k, :]
        thru = ub_ik[:, :, None] + ub_kj[:, None, :]
        ub = torch.minimum(ub, thru)
        lb = torch.maximum(lb, torch.maximum(lb_ik[:, :, None] - ub_kj[:, None, :],
                                             lb_kj[:, None, :] - ub_ik[:, :, None]))
    viol = (lb > ub + 1e-5) & pair_mask
    consistent = ~viol.any(dim=(1, 2))
    eye = torch.eye(A, dtype=torch.bool, device=upper.device)
    return torch.where(eye, 0.0, ub), torch.where(eye, 0.0, lb), consistent


def triangle_smooth_bounds(upper: torch.Tensor, lower: torch.Tensor, n_atoms: torch.Tensor):
    """Smooth the bounds ``upper``/``lower`` [M, A, A] of molecules with
    ``n_atoms`` [M] real atoms: K9 for CUDA tensors, the plain version for
    CPU tensors. Returns (ub, lb, consistent [M] bool)."""
    if not upper.is_cuda:
        return triangle_smooth_bounds_plain(upper, lower, n_atoms)
    from nvmolkit_tpu_torch._build import triangle_smooth_lib

    M, A = upper.shape[:2]
    if upper.shape != (M, A, A) or lower.shape != upper.shape:
        raise ValueError(f"K9 takes [M, A, A] bounds, got {tuple(upper.shape)} and "
                         f"{tuple(lower.shape)}")
    if n_atoms.shape != (M,) or n_atoms.dtype != torch.int32:
        raise ValueError(f"K9 takes int32 n_atoms [{M}]")
    for t in (upper, lower, n_atoms):
        if t.device != upper.device or not t.is_contiguous():
            raise ValueError("K9's inputs must be contiguous and on one device")
    if upper.dtype != torch.float32 or lower.dtype != torch.float32:
        raise ValueError("K9 takes float32 bounds")
    ub = torch.empty_like(upper)
    lb = torch.empty_like(lower)
    ok = torch.empty(M, dtype=torch.uint8, device=upper.device)
    with torch.cuda.device(upper.device):
        rc = triangle_smooth_lib().nvmk_triangle_smooth(
            upper.data_ptr(), lower.data_ptr(), n_atoms.data_ptr(), M, A, ub.data_ptr(),
            lb.data_ptr(), ok.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"triangle_smooth kernel launch failed with CUDA error {rc}")
    launch_counts["triangle_smooth"] += 1
    return ub, lb, ok.bool()


WARP_MAX_ATOMS, REGISTER_MAX_ATOMS, SHARED_MAX_ATOMS = 32, 96, 160


def kernel_layout(a_pad: int) -> dict:
    """K9's layout at bucket ``a_pad`` (``csrc/triangle_smooth.cu``): a warp
    per molecule (lanes 4 x 8) up to 32 atoms, each a tile of ri x rj
    entries in registers; to 64 atoms a block of 8 x 16 threads, tiles of 2R
    x R, to 96 16 x 16 threads, R x R; past 96 a block of 16 x 16 threads
    owning the entries (ti + 16 r, tj + 16 c) in shared memory (to 160
    atoms) or global memory. ``span``: the stage's length (rows and columns
    the layout covers)."""
    if a_pad <= WARP_MAX_ATOMS:
        a = 16 if a_pad <= 16 else 32
        return {"kind": "warp", "ti": 4, "tj": 8, "ri": a // 4, "rj": a // 8, "span": a}
    if a_pad <= REGISTER_MAX_ATOMS:
        r = next(r for r in (3, 4, 5, 6) if a_pad <= 16 * r)
        ti = 8 if r <= 4 else 16
        return {"kind": "registers", "ti": ti, "tj": 16, "ri": 16 * r // ti, "rj": r,
                "span": 16 * r}
    span = -(-a_pad // 16) * 16
    return {"kind": "shared" if a_pad <= SHARED_MAX_ATOMS else "global", "ti": 16, "tj": 16,
            "ri": span // 16, "rj": span // 16, "span": span}


def symmetric_inputs(upper: torch.Tensor, lower: torch.Tensor, n_atoms: torch.Tensor):
    """bool [M]: K9's test for its symmetric pivot loop. Each molecule's
    real block of both inputs equals its transpose bit for bit, and every
    real entry is finite, not -0 and under 1e30 in magnitude (so no pivot
    makes a -0, a NaN or an inf)."""
    A = upper.shape[1]
    real = atom_mask_of(n_atoms, A)
    real = real[:, :, None] & real[:, None, :]
    ok = torch.ones(upper.shape[0], dtype=torch.bool, device=upper.device)
    for t in (upper, lower):
        bits = t.contiguous().view(torch.int32)
        same = bits == bits.transpose(1, 2)
        plain = (t.abs() < 1e30) & (bits != torch.iinfo(torch.int32).min)
        ok &= ((same & plain) | ~real).all(dim=(1, 2))
    return ok


def triangle_smooth_model(upper: torch.Tensor, lower: torch.Tensor, n_atoms: torch.Tensor):
    """K9's order of work, in torch: (ub, lb, consistent) as
    :func:`triangle_smooth_bounds` returns them.

    Each molecule's span x span work matrices (:func:`kernel_layout`) hold
    its real entries and, past its n atoms, 1e6 upper and 0 lower. Before
    pivot 0 the owners publish row 0 and column 0 into buffer 0 of a
    two-buffer stage; pivot k updates every entry from buffer k % 2 alone,
    then the owners of row and column k + 1 publish them, as they stand
    after pivot k, into the other buffer; a molecule whose inputs pass
    :func:`symmetric_inputs` reads column k from row k's stage (K9 publishes
    only the row there). Only the first n pivots run. The
    flag reads the real entries; the outputs are the padded matrices with a
    zero diagonal. (Which thread owns an entry changes no arithmetic: every
    entry is written by its owner only.)"""
    M, A = upper.shape[:2]
    span = kernel_layout(A)["span"]
    idx = torch.arange(span)
    n = n_atoms.to(torch.int64)
    real = (idx[None, :, None] < n[:, None, None]) & (idx[None, None, :] < n[:, None, None])
    pad = (0, span - A, 0, span - A)
    u = torch.where(real, torch.nn.functional.pad(upper, pad), _BIG)
    l = torch.where(real, torch.nn.functional.pad(lower, pad), 0.0)
    stage = torch.zeros((M, 2, 4, span), dtype=upper.dtype)

    def publish(k: int, buf: int, who: torch.Tensor):
        stage[who, buf, 0], stage[who, buf, 1] = u[who, k, :], l[who, k, :]
        stage[who, buf, 2], stage[who, buf, 3] = u[who, :, k], l[who, :, k]

    sym = symmetric_inputs(upper, lower, n_atoms)[:, None]
    publish(0, 0, n > 0)
    for k in range(int(n.max()) if M else 0):
        live = k < n
        ru, rl, cu, cl = (stage[:, k % 2, q] for q in range(4))
        # a symmetric molecule's threads read column k from row k's stage
        cu, cl = torch.where(sym, ru, cu), torch.where(sym, rl, cl)
        nu = torch.minimum(u, cu[:, :, None] + ru[:, None, :])
        nl = torch.maximum(l, torch.maximum(cl[:, :, None] - ru[:, None, :],
                                            rl[:, None, :] - cu[:, :, None]))
        u = torch.where(live[:, None, None], nu, u)
        l = torch.where(live[:, None, None], nl, l)
        if k + 1 < span:
            publish(k + 1, (k + 1) % 2, k + 1 < n)
    consistent = ~((l > u + 1e-5) & real).any(dim=(1, 2))
    u, l = u[:, :A, :A], l[:, :A, :A]
    real, eye = real[:, :A, :A], torch.eye(A, dtype=torch.bool)
    return (torch.where(eye, 0.0, torch.where(real, u, _BIG)),
            torch.where(eye, 0.0, torch.where(real, l, 0.0)), consistent)
