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
  flat float32 tensor. On CUDA it calls K3 (``csrc/rmsd.cu``) once for
  the whole batch (:func:`kernel_plan`: a block of ``molecule_kernel`` per
  molecule whose conformers fit in shared memory, ``center_kernel`` and
  ``tile_kernel`` for the others); on the CPU it runs the plain version. A
  build or launch failure raises.

Everything is float32, the JAX package's default working dtype.
``launch_counts`` counts K3's launches.
"""
from __future__ import annotations

import numpy as np
import torch

from nvmolkit_tpu_torch._build import rmsd_lib

TILE = 32        # conformers per side of tile_kernel's tiles (csrc/rmsd.cu)
_ATOM_CHUNK = 32  # atoms per shared-memory stage of tile_kernel (csrc/rmsd.cu)
# molecule_kernel's shared memory at most: a molecule whose conformers need
# more goes through center_kernel and tile_kernel (kernel_plan)
MOLECULE_SMEM_BYTES = 112 * 1024
_GRAM_BUDGET = 1 << 28  # f32 elements of the plain version's Gram blocks per chunk
EPS32 = 2.0 ** -23
# k of the float32 rounding dP = k eps e0^4 of the QCP quartic near its
# largest root (qcp_root_shift): the float32 plain version against float64
# on tools/k3_degenerate_probe.py's seeded three-atom sets needs about 3
# (k = 1: 13 of 87,000 pairs over, worst 2.4x; k = 4: worst 0.80x; k = 16:
# 0.23x), held by tests/test_torch_conformer_rmsd.py
QCP_ROUNDING = 16.0

launch_counts = {"conformer_rmsd": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _qcp_coefficients(h: torch.Tensor):
    """(c2, c1, c0) of the QCP quartic x^4 + c2 x^2 + c1 x + c0 of ``h``
    [..., 3, 3], with ``_qcp_max_eig``'s expressions."""
    sxx, sxy, sxz = h[..., 0, 0], h[..., 0, 1], h[..., 0, 2]
    syx, syy, syz = h[..., 1, 0], h[..., 1, 1], h[..., 1, 2]
    szx, szy, szz = h[..., 2, 0], h[..., 2, 1], h[..., 2, 2]
    sxx2, sxy2, sxz2 = sxx * sxx, sxy * sxy, sxz * sxz
    syx2, syy2, syz2 = syx * syx, syy * syy, syz * syz
    szx2, szy2, szz2 = szx * szx, szy * szy, szz * szz
    c2 = -2.0 * (sxx2 + sxy2 + sxz2 + syx2 + syy2 + syz2 + szx2 + szy2 + szz2)
    c1 = 8.0 * (sxx * syz * szy + syy * szx * sxz + szz * sxy * syx
                - sxx * syy * szz - syz * szx * sxy - szy * syx * sxz)
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
    return c2, c1, c0


def qcp_max_eig_plain(h: torch.Tensor, e0: torch.Tensor) -> torch.Tensor:
    """Largest eigenvalue of the QCP 4x4 key matrix for cross-covariance
    blocks ``h`` [..., 3, 3], i.e. max_R tr(R h); 12 Newton steps from the
    upper bound ``e0``, with ``_qcp_max_eig``'s coefficients and guard."""
    c2, c1, c0 = _qcp_coefficients(h)
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


def plane_stride(c):
    """molecule_kernel's plane row length for ``c`` conformers (an int or
    an int array; ``csrc/rmsd.cu`` ``plane_stride``)."""
    s = (np.asarray(c, np.int64) + 1) // 2 * 2 + 2
    s = np.where(s % 4 == 0, s + 2, s)
    return int(s) if s.ndim == 0 else s


def molecule_smem_bytes(c, a_in: int):
    """molecule_kernel's shared memory for molecules of ``c`` conformers
    (an int or an int array) of ``a_in`` atoms: x, y, z planes [a_in]
    [stride], g and the slots."""
    stride = plane_stride(c)
    return 4 * (3 * a_in * stride + stride) + 4 * a_in


def kernel_plan(n_confs, a_in: int):
    """K3's launch plan for molecules of ``n_confs`` conformers of ``a_in``
    atoms: (offsets int64 [3 (M + 1) + n_fit], n_tiles, n_fit, fit_smem).
    A molecule of >= 2 conformers whose conformers fit in
    MOLECULE_SMEM_BYTES takes a block of molecule_kernel (listed after the
    three prefix sums); the others take TILE x TILE tiles of tile_kernel.
    The prefix sums are of conformers, of tiles and of condensed pairs."""
    c = np.asarray(n_confs, np.int64)
    smem = np.asarray(molecule_smem_bytes(c, a_in), np.int64)
    fits = (c >= 2) & (smem <= MOLECULE_SMEM_BYTES)
    t = (c + TILE - 1) // TILE
    tiles = np.where((c >= 2) & ~fits, t * (t + 1) // 2, 0)
    pairs = c * (c - 1) // 2
    off = np.zeros((3, len(c) + 1), np.int64)
    for k, v in enumerate((c, tiles, pairs)):
        np.cumsum(v, out=off[k, 1:])
    fit_list = np.nonzero(fits)[0].astype(np.int64)
    return (np.concatenate([off.ravel(), fit_list]), int(off[1, -1]), len(fit_list),
            int(smem[fits].max(initial=0)))


def molecule_kernel_pairs(c: int) -> np.ndarray:
    """molecule_kernel's work for a molecule of ``c`` conformers, in its
    order: int64 [pairs, 3] of (work item, i, j) of every pair it writes.
    Item w < blocks is the 2 x 2 block {2p, 2p+1} x {2q, 2q+1}, w =
    p(p-1)/2 + q (p from a float32 square root, then corrected, as the
    kernel decodes it; thread w % 256 takes it); the items after them are
    the pairs (2p+1, 2p)."""
    P = (c + 1) // 2
    blocks = P * (P - 1) // 2
    w = np.arange(blocks, dtype=np.int64)
    p = ((np.float32(1.0) + np.sqrt(np.float32(8.0) * w.astype(np.float32) + np.float32(1.0)))
         * np.float32(0.5)).astype(np.int64)
    p += p * (p + 1) // 2 <= w
    p -= p * (p - 1) // 2 > w
    q = w - p * (p - 1) // 2
    parts = [np.stack([w, 2 * p + r, 2 * q + s], axis=1) for r in (0, 1) for s in (0, 1)]
    quad = np.concatenate(parts)
    quad = quad[quad[:, 1] < c]
    k = np.arange(c // 2, dtype=np.int64)
    single = np.stack([blocks + k, 2 * k + 1, 2 * k], axis=1)
    out = np.concatenate([quad, single])
    return out[np.argsort(out[:, 0], kind="stable")]


def tile_kernel_pairs(c: int) -> np.ndarray:
    """tile_kernel's work for a molecule of ``c`` conformers: int64 [pairs,
    4] of (tile, thread, i, j) of every pair it writes; tile ti (ti + 1) / 2
    + tj (tj <= ti), thread 16 uy + ux taking {TILE ti + 2 uy, +1} x
    {TILE tj + 2 ux, +1}."""
    t = (c + TILE - 1) // TILE
    ti, tj = np.tril_indices(t)
    th = np.arange(256, dtype=np.int64)
    uy, ux = th >> 4, th & 15
    parts = []
    for r in (0, 1):
        for s in (0, 1):
            i = TILE * ti[:, None] + 2 * uy[None, :] + r
            j = TILE * tj[:, None] + 2 * ux[None, :] + s
            tile = np.broadcast_to((ti * (ti + 1) // 2 + tj)[:, None], i.shape)
            thread = np.broadcast_to(th[None, :], i.shape)
            parts.append(np.stack([tile, thread, i, j], axis=-1).reshape(-1, 4))
    out = np.concatenate(parts)
    return out[(out[:, 2] < c) & (out[:, 3] < out[:, 2])]


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


def qcp_root_shift(h: torch.Tensor, e0: torch.Tensor) -> torch.Tensor:
    """How far a float32 evaluation of the QCP root may move it (float64,
    the shape of ``e0``), from the float64 cross-covariances ``h`` [..., 3, 3].

    Float32 rounds the quartic P(x) = prod (x - l_k) by dP = QCP_ROUNDING eps
    e0^4: its coefficients' terms are products of four entries of h, each at
    most e0, and the Newton steps evaluate it at x ~ e0. Near the largest
    root l_1, P(l_1 + d) = a_1 d + a_2 d^2 + a_3 d^3 + d^4, where a_1 is the
    first derivative at l_1, prod_{k>1} (l_1 - l_k); a_2 half the second,
    the sum of those gaps' products two at a time; a_3 a sixth of the third,
    4 l_1 (the roots sum to 0): all >= 0. l_1 comes from 60 Newton steps in
    float64 from e0 (converging linearly at a double root, they still reach
    float64's rounding). So the root moves by at most min_m (dP / a_m)^(1/m):
    dP / a_1 where the gap is wide, sqrt(dP / a_2) at a double root (two
    atoms, or three near a reflection). There Newton also converges only
    linearly (it halves its distance to a double root a step), so 12 steps
    from e0 can stop short of l_1, and a float32 run whose rounding split the
    root converges past where the float64 run stopped: the float64 run's own
    distance from l_1 after its 12 steps is added. (The gaps are those of
    the eigenvalues of Theobald's 4 x 4 key matrix, whose characteristic
    polynomial P is.)"""
    h, e0 = h.double(), e0.double()
    c2, c1, c0 = _qcp_coefficients(h)
    lam = e0
    for _ in range(60):
        x2 = lam * lam
        slope = 4.0 * x2 * lam + 2.0 * c2 * lam + c1
        lam = lam - (x2 * x2 + c2 * x2 + c1 * lam + c0) / torch.where(slope.abs() > 0.0, slope,
                                                                      1.0)
    a1 = (4.0 * lam ** 3 + 2.0 * c2 * lam + c1).abs()
    a2 = (6.0 * lam * lam + c2).abs()
    a3 = (4.0 * lam).abs()
    dp = QCP_ROUNDING * EPS32 * e0 ** 4
    shift = dp ** 0.25
    for a, m in ((a1, 1.0), (a2, 2.0), (a3, 3.0)):
        term = (dp / a.clamp_min(1e-300)) ** (1.0 / m)
        shift = torch.where(a > 0, torch.minimum(shift, term), shift)
    return shift + (qcp_max_eig_plain(h, e0) - lam).abs()


def condensed_scales(
    x: torch.Tensor, mask: torch.Tensor, n_confs, rows: torch.Tensor | None = None,
    prealigned: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """float64 ``(e0, n, root_shift)`` of every condensed entry of
    :func:`conformer_rmsd_condensed` on the same inputs, for
    :func:`rmsd_tolerance`: e0 = (g_i + g_j) / 2, the molecule's masked atom
    count, and :func:`qcp_root_shift` of the pair's cross-covariance (0 with
    ``prealigned``: no root)."""
    n_confs = np.asarray(n_confs, np.int64)
    dev = x.device
    x = (x if rows is None else x[rows]).double()
    mol_of_conf = torch.from_numpy(np.repeat(np.arange(len(n_confs)), n_confs)).to(dev)
    w = mask[mol_of_conf].double()[:, :, None]
    n = mask.sum(dim=1).clamp_min(1).double()
    if not prealigned:
        x = x - (x * w).sum(dim=1, keepdim=True) / n[mol_of_conf][:, None, None]
    x = x * w
    g = (x ** 2).sum(dim=(1, 2))
    mol, i, j = _pair_index(n_confs)
    first = np.concatenate([[0], np.cumsum(n_confs)[:-1]])[mol]
    ci, cj = (torch.from_numpy(first + k).to(dev) for k in (i, j))
    e0 = 0.5 * (g[ci] + g[cj])
    shift = torch.zeros_like(e0)
    if not prealigned:  # each pair's H = X_i^T X_j, in chunks of pairs
        step = max(1, _GRAM_BUDGET // (16 * max(1, x.shape[1])))
        for lo in range(0, len(mol), step):
            h = torch.einsum("pad,pae->pde", x[ci[lo:lo + step]], x[cj[lo:lo + step]])
            shift[lo:lo + step] = qcp_root_shift(h, e0[lo:lo + step])
    return e0, n[torch.from_numpy(mol).to(dev)], shift


def rmsd_tolerance(rms: torch.Tensor, e0: torch.Tensor, n: torch.Tensor,
                   root_shift: torch.Tensor | None = None) -> torch.Tensor:
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
    package on prealigned stacks of 256 atoms away from the origin (CPU).

    Two atoms or fewer are collinear: lambda is then a double root of the
    quartic, a rounding of eps in its coefficients moves it by ~sqrt(eps)
    e0, and Newton converges linearly; there k = 32 / sqrt(eps) (measured:
    9 / sqrt(eps), K3 against the plain version, two atoms at 0.28 Å).
    Against float64 a float32 run can be farther off there: rounding can
    split the double root into a complex pair, and 12 Newton steps then end
    where they end (0.195 against 0.114 Å at one seeded pair).

    A root near another at more atoms (three atoms near a reflection) moves
    by more than eps e0 too. With ``root_shift`` (the third of
    :func:`condensed_scales`: :func:`qcp_root_shift`, the pair's own
    sensitivity) the allowance is the larger of the above and what a shift
    dS = 2 root_shift of S does to the RMSD, RMSD - sqrt(max(RMSD^2 - dS /
    n, 0)); where the gap is wide that lies below the k eps e0 terms, so the
    bound stays as it was."""
    degenerate = 32.0 / EPS32 ** 0.5
    k_near = torch.where(n <= 2, degenerate, 9.0)
    k_far = torch.where(n <= 2, degenerate, 16.0)
    near = torch.clamp_min(torch.sqrt(k_near * EPS32 * e0 / n), 2e-3)
    far = torch.maximum(1e-4 + 1e-4 * rms, k_far * EPS32 * e0 / (2.0 * n * rms.clamp_min(0.1)))
    tol = torch.where(rms < 0.1, near, far)
    if root_shift is None:
        return tol
    root = rms - torch.sqrt((rms * rms - 2.0 * root_shift / n).clamp_min(0.0))
    return torch.maximum(tol, root)


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
    plan, n_tiles, n_fit, fit_smem = kernel_plan(n_confs, x.shape[1])
    dev = x.device
    out = torch.empty(int(plan[2 * (len(n_confs) + 1) + len(n_confs)]), dtype=torch.float32,
                      device=dev)
    if n_conf == 0:
        return out
    a_in = x.shape[1]
    a_pad = max(_ATOM_CHUNK, -(-a_in // _ATOM_CHUNK) * _ATOM_CHUNK)
    # pinned and queued: no host sync, so launches can run ahead
    offsets = torch.from_numpy(plan).pin_memory().to(dev, non_blocking=True)
    # tile_kernel's scratch, only when a molecule takes it
    scratch = (n_conf if n_tiles else 0, len(n_confs) if n_tiles else 0)
    xc = torch.empty((scratch[0], a_pad, 4), dtype=torch.float32, device=dev)
    g = torch.empty(scratch[0], dtype=torch.float32, device=dev)
    count = torch.empty(scratch[1], dtype=torch.int32, device=dev)
    lib = rmsd_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.nvmk_conformer_rmsd(
            x.data_ptr(), None if rows is None else rows.data_ptr(), n_conf, a_in,
            mask.data_ptr(), offsets.data_ptr(), len(n_confs), n_tiles, n_fit, fit_smem,
            int(prealigned), xc.data_ptr(), a_pad, g.data_ptr(), count.data_ptr(),
            out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"conformer_rmsd kernel launch failed with CUDA error {rc}")
    launch_counts["conformer_rmsd"] += 1
    return out
