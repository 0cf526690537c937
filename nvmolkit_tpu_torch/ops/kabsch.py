"""Conformer RMSD matrices: kernel K3 and its plain PyTorch version.

For every pair of conformers of a molecule, the RMSD after optimal
superposition (or without it, ``prealigned``) over the molecule's masked
atoms, as ``nvmolkit_tpu/ops/kabsch.py::conformer_rms_matrices`` computes
it: centered coordinates, the 3 x 3 cross-covariance, the largest root of
the QCP quartic by 12 Newton steps from e0 = (g_i + g_j) / 2, and
``sqrt(max(2 (e0 - lambda), 0) / n)`` with ``n = max(sum(mask), 1)``.

* :func:`conformer_rms_matrices_plain` mirrors the JAX function on dense
  [M, C, A, 3] stacks; :func:`qcp_max_eig_plain` mirrors ``_qcp_max_eig``.
* :func:`conformer_rmsd_condensed` takes a flat conformer stack with
  per-molecule conformer offsets and returns every molecule's condensed
  lower triangle (index ``i(i-1)/2 + j`` for i > j) back to back in one
  flat float32 tensor. On CUDA it launches K3 (``csrc/rmsd.cu``) once for
  the whole batch; on the CPU it runs the plain version. A build or launch
  failure raises.

Everything is float32, the JAX package's default working dtype.
``launch_counts`` counts K3's launches.
"""
from __future__ import annotations

import numpy as np
import torch

from nvmolkit_tpu_torch._build import rmsd_lib

TILE = 16        # conformers per side of a pair tile (csrc/rmsd.cu)
_ATOM_CHUNK = 32  # atoms per shared-memory stage (csrc/rmsd.cu)
_GRAM_BUDGET = 1 << 28  # f32 elements of the plain version's Gram blocks per chunk
EPS32 = 2.0 ** -23

launch_counts = {"conformer_rmsd": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def qcp_max_eig_plain(h: torch.Tensor, e0: torch.Tensor) -> torch.Tensor:
    """Largest eigenvalue of the QCP 4x4 key matrix for cross-covariance
    blocks ``h`` [..., 3, 3], i.e. max_R tr(R h); Newton from the upper
    bound ``e0``, with ``_qcp_max_eig``'s coefficients and guard."""
    sxx, sxy, sxz = h[..., 0, 0], h[..., 0, 1], h[..., 0, 2]
    syx, syy, syz = h[..., 1, 0], h[..., 1, 1], h[..., 1, 2]
    szx, szy, szz = h[..., 2, 0], h[..., 2, 1], h[..., 2, 2]

    sxx2, sxy2, sxz2 = sxx * sxx, sxy * sxy, sxz * sxz
    syx2, syy2, syz2 = syx * syx, syy * syy, syz * syz
    szx2, szy2, szz2 = szx * szx, szy * szy, szz * szz

    c2 = -2.0 * (sxx2 + sxy2 + sxz2 + syx2 + syy2 + syz2 + szx2 + szy2 + szz2)
    c1 = 8.0 * (
        sxx * syz * szy + syy * szx * sxz + szz * sxy * syx
        - sxx * syy * szz - syz * szx * sxy - szy * syx * sxz
    )

    sxz_p_szx, sxz_m_szx = sxz + szx, sxz - szx
    syz_p_szy, syz_m_szy = syz + szy, syz - szy
    sxy_p_syx, sxy_m_syx = sxy + syx, sxy - syx
    sxx_p_syy, sxx_m_syy = sxx + syy, sxx - syy
    d1 = syy2 + szz2 - sxx2 + syz2 + szy2
    d2 = 2.0 * (syz * szy - syy * szz)
    t0 = sxy2 + sxz2 - syx2 - szx2
    c0 = (
        t0 * t0
        + (d1 + d2) * (d1 - d2)
        + (-(sxz_p_szx) * syz_m_szy + sxy_m_syx * (sxx_m_syy - szz))
        * (-(sxz_m_szx) * syz_p_szy + sxy_m_syx * (sxx_m_syy + szz))
        + (-(sxz_p_szx) * syz_p_szy - sxy_p_syx * (sxx_p_syy - szz))
        * (-(sxz_m_szx) * syz_m_szy - sxy_p_syx * (sxx_p_syy + szz))
        + (sxy_p_syx * syz_p_szy + sxz_p_szx * (sxx_m_syy + szz))
        * (-(sxy_m_syx) * syz_m_szy + sxz_p_szx * (sxx_p_syy + szz))
        + (sxy_p_syx * syz_m_szy + sxz_m_szx * (sxx_m_syy - szz))
        * (-(sxy_m_syx) * syz_p_szy + sxz_m_szx * (sxx_p_syy - szz))
    )

    lam = e0
    for _ in range(12):
        x2 = lam * lam
        b = (x2 + c2) * lam
        a = b + c1
        dp = 2.0 * x2 * lam + b + a  # P'(lam)
        safe = torch.where(dp.abs() > 0.0, dp, 1.0)
        lam = lam - (a * lam + c0) / safe
    return lam


def conformer_rms_matrices_plain(
    confs: torch.Tensor, mask: torch.Tensor, prealigned: bool = False,
) -> torch.Tensor:
    """Full RMSD matrices [M, C, C] of zero-padded conformer stacks
    ``confs`` [M, C, A, 3] over the atoms ``mask`` [M, A] (bool): the JAX
    function's arithmetic, in ``confs``' dtype."""
    w = mask.to(confs.dtype)[:, None, :, None]                   # [M,1,A,1]
    n = mask.to(confs.dtype).sum(dim=-1).clamp_min(1.0)          # [M]
    if prealigned:
        xm = confs * w
        g = (xm * confs).sum(dim=(2, 3))                         # [M, C]
        dots = torch.einsum("mcax,mdax->mcd", xm, confs)
        sq = g[:, :, None] + g[:, None, :] - 2.0 * dots
        return torch.sqrt(sq.clamp_min(0.0) / n[:, None, None])
    cent = (confs * w).sum(dim=2) / n[:, None, None]             # [M, C, 3]
    xc = (confs - cent[:, :, None, :]) * w                       # [M, C, A, 3]
    m_, c_, a_, _ = xc.shape
    x = xc.transpose(2, 3).reshape(m_, c_ * 3, a_)               # [M, C*3, A]
    gram = x @ x.transpose(1, 2)                                 # [M, C*3, C*3]
    h = gram.reshape(m_, c_, 3, c_, 3).transpose(2, 3)           # [M, C, C, 3, 3]
    g = (xc * xc).sum(dim=(2, 3))                                # [M, C]
    e0 = 0.5 * (g[:, :, None] + g[:, None, :])
    trace = qcp_max_eig_plain(h, e0)
    return torch.sqrt((2.0 * (e0 - trace)).clamp_min(0.0) / n[:, None, None])


def condensed_offsets(n_confs: np.ndarray) -> np.ndarray:
    """int64 [3, M + 1]: the prefix sums of conformers, of K3's pair tiles
    and of condensed pairs, for molecules of ``n_confs`` conformers."""
    c = np.asarray(n_confs, np.int64)
    t = (c + TILE - 1) // TILE
    tiles = np.where(c >= 2, t * (t + 1) // 2, 0)
    pairs = c * (c - 1) // 2
    off = np.zeros((3, len(c) + 1), np.int64)
    for k, v in enumerate((c, tiles, pairs)):
        np.cumsum(v, out=off[k, 1:])
    return off


def _pair_index(n_confs: np.ndarray):
    """(molecule, i, j) of every condensed entry, in output order."""
    c = np.asarray(n_confs, np.int64)
    pairs = c * (c - 1) // 2
    mol = np.repeat(np.arange(len(c)), pairs)
    start = np.concatenate([[0], np.cumsum(pairs)[:-1]])
    k = np.arange(int(pairs.sum()), dtype=np.int64) - np.repeat(start, pairs)
    i = ((1.0 + np.sqrt(8.0 * k + 1.0)) / 2.0).astype(np.int64)  # k = i(i-1)/2 + j
    i += (i * (i + 1) // 2 <= k).astype(np.int64)
    i -= (i * (i - 1) // 2 > k).astype(np.int64)
    return mol, i, k - i * (i - 1) // 2


def condensed_scales(
    x: torch.Tensor, mask: torch.Tensor, n_confs, rows: torch.Tensor | None = None,
    prealigned: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """float64 ``(e0, n)`` of every condensed entry of
    :func:`conformer_rmsd_condensed` on the same inputs: e0 = (g_i + g_j) / 2
    and the molecule's masked atom count, for :func:`rmsd_tolerance`."""
    n_confs = np.asarray(n_confs, np.int64)
    dev = x.device
    x = (x if rows is None else x[rows]).double()
    mol_of_conf = torch.from_numpy(np.repeat(np.arange(len(n_confs)), n_confs)).to(dev)
    w = mask[mol_of_conf].double()[:, :, None]
    n = mask.sum(dim=1).clamp_min(1).double()
    if not prealigned:
        x = x - (x * w).sum(dim=1, keepdim=True) / n[mol_of_conf][:, None, None]
    g = ((x * w) ** 2).sum(dim=(1, 2))
    mol, i, j = _pair_index(n_confs)
    first = np.concatenate([[0], np.cumsum(n_confs)[:-1]])[mol]
    gi, gj = (g[torch.from_numpy(first + k).to(dev)] for k in (i, j))
    return 0.5 * (gi + gj), n[torch.from_numpy(mol).to(dev)]


def rmsd_tolerance(rms: torch.Tensor, e0: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """The largest |difference| allowed between two float32 evaluations of
    one RMSD (K3, the plain version, the JAX package), in Å.

    RMSD^2 = S / n, where S = 2 (e0 - lambda) (prealigned: g_i + g_j - 2
    X_i.X_j) is a difference of terms of size ~2 e0. Rounding S's terms in
    float32, with the sums over n atoms taken in different orders, moves S
    by k eps e0, so RMSD moves by sqrt(k eps e0 / n) near 0 and by
    k eps e0 / (2 n RMSD) away from it. Allowed:
      RMSD < 0.1 Å:   max(2e-3 Å, sqrt(k eps e0 / n)),                  k = 9
      RMSD >= 0.1 Å:  max(1e-4 Å + 1e-4 RMSD, k eps e0 / (2 n RMSD)),   k = 16
    Measured k: 5.7 for K3 on exact rigid copies of 128 atoms (the plain
    version gave 0 there), about 7 between the plain version and the JAX
    package on prealigned stacks of 256 atoms away from the origin (CPU). Two atoms
    or fewer are collinear: lambda is then a double root of the quartic, a
    rounding of eps in its coefficients moves it by ~sqrt(eps) e0, and
    Newton converges linearly; there k = 32 / sqrt(eps) (measured: 9 /
    sqrt(eps), K3 against the plain version, two atoms at 0.28 Å)."""
    degenerate = 32.0 / EPS32 ** 0.5
    k_near = torch.where(n <= 2, degenerate, 9.0)
    k_far = torch.where(n <= 2, degenerate, 16.0)
    near = torch.clamp_min(torch.sqrt(k_near * EPS32 * e0 / n), 2e-3)
    far = torch.maximum(1e-4 + 1e-4 * rms, k_far * EPS32 * e0 / (2.0 * n * rms.clamp_min(0.1)))
    return torch.where(rms < 0.1, near, far)


def conformer_rmsd_condensed_plain(
    x: torch.Tensor, mask: torch.Tensor, n_confs, rows: torch.Tensor | None = None,
    prealigned: bool = False,
) -> torch.Tensor:
    """The plain version of :func:`conformer_rmsd_condensed`: the conformers
    are padded into dense [M, C, A, 3] chunks and go through
    :func:`conformer_rms_matrices_plain`; the condensed entries are gathered
    from its matrices."""
    n_confs = np.asarray(n_confs, np.int64)
    dev = x.device
    if rows is not None:
        x = x[rows]
    off = np.concatenate([[0], np.cumsum(n_confs)])
    mol, i, j = _pair_index(n_confs)
    out = torch.empty(len(mol), dtype=torch.float32, device=dev)
    c_max = int(n_confs.max(initial=0))
    per_chunk = max(1, _GRAM_BUDGET // max(1, (c_max * 3) ** 2))
    for lo in range(0, len(n_confs), per_chunk):
        hi = min(lo + per_chunk, len(n_confs))
        counts = n_confs[lo:hi]
        slot_m = np.repeat(np.arange(hi - lo), counts)
        slot_c = np.arange(off[hi] - off[lo]) - np.repeat(off[lo:hi] - off[lo], counts)
        dense = torch.zeros((hi - lo, c_max, x.shape[1], 3), dtype=torch.float32, device=dev)
        dense[torch.from_numpy(slot_m).to(dev), torch.from_numpy(slot_c).to(dev)] = (
            x[int(off[lo]):int(off[hi])].to(torch.float32))
        rms = conformer_rms_matrices_plain(dense, mask[lo:hi], prealigned)
        sel = (mol >= lo) & (mol < hi)
        where = torch.from_numpy(np.nonzero(sel)[0]).to(dev)
        idx = [torch.from_numpy(a[sel]).to(dev) for a in (mol - lo, i, j)]
        out[where] = rms[idx[0], idx[1], idx[2]]
    return out


def conformer_rmsd_condensed(
    x: torch.Tensor, mask: torch.Tensor, n_confs, rows: torch.Tensor | None = None,
    prealigned: bool = False,
) -> torch.Tensor:
    """Condensed RMSD matrices of a batch of molecules, back to back.

    ``x`` holds conformer rows [R, A, 3]; conformer c is row ``rows[c]``
    (int64 [N]) when given, else row c, and molecule m owns conformers
    ``sum(n_confs[:m])`` .. ``sum(n_confs[:m+1]) - 1``. ``mask`` [M, A] bool
    selects the atoms. Returns float32 [sum C(C-1)/2]: molecule m's entry
    (i, j), i > j, at ``pairs_before_m + i(i-1)/2 + j``. K3 for CUDA
    tensors (float32, contiguous), the plain version for CPU tensors."""
    n_confs = np.asarray(n_confs, np.int64)
    if x.dim() != 3 or x.shape[2] != 3:
        raise ValueError(f"conformer rows must be [R, A, 3], got {tuple(x.shape)}")
    if mask.shape != (len(n_confs), x.shape[1]) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool [{len(n_confs)}, {x.shape[1]}], got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    n_conf = int(n_confs.sum())
    if (x.shape[0] if rows is None else rows.shape[0]) != n_conf:
        raise ValueError(f"{n_conf} conformers in n_confs, but the rows hold another count")
    if not x.is_cuda:
        return conformer_rmsd_condensed_plain(x, mask, n_confs, rows, prealigned)
    if x.dtype != torch.float32:
        raise ValueError(f"K3 takes float32 coordinates, got {x.dtype}")
    if rows is not None and rows.dtype != torch.int64:
        raise ValueError("rows must be an int64 tensor")
    for t in (x, mask) + (() if rows is None else (rows,)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("K3's inputs must be contiguous and on one device")
    off = condensed_offsets(n_confs)
    dev = x.device
    out = torch.empty(int(off[2, -1]), dtype=torch.float32, device=dev)
    if n_conf == 0:
        return out
    a_in = x.shape[1]
    a_pad = max(_ATOM_CHUNK, -(-a_in // _ATOM_CHUNK) * _ATOM_CHUNK)
    # pinned and queued: no host sync, so launches can run ahead
    offsets = torch.from_numpy(off).pin_memory().to(dev, non_blocking=True)
    xc = torch.empty((n_conf, a_pad, 4), dtype=torch.float32, device=dev)
    g = torch.empty(n_conf, dtype=torch.float32, device=dev)
    count = torch.empty(len(n_confs), dtype=torch.int32, device=dev)
    lib = rmsd_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.nvmk_conformer_rmsd(
            x.data_ptr(), None if rows is None else rows.data_ptr(), n_conf, a_in,
            mask.data_ptr(), offsets.data_ptr(), len(n_confs), int(off[1, -1]),
            int(prealigned), xc.data_ptr(), a_pad, g.data_ptr(), count.data_ptr(),
            out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"conformer_rmsd kernel launch failed with CUDA error {rc}")
    launch_counts["conformer_rmsd"] += 1
    return out
