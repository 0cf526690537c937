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
