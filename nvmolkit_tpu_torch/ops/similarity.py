"""Cross Tanimoto/cosine similarity and neighbor counts over packed fingerprints.

Fingerprints are int32 tensors [n, W] holding the u32 words (W = fpSize/32).
Each operation has two versions with the same results:

* the kernel in ``csrc/similarity.cu`` (K1 ``cross_similarity_kernel``
  and, for few columns, ``few_columns_kernel``; K2
  ``neighbor_counts_kernel``), launched for CUDA tensors on the current
  stream; a build or launch failure raises, there is no fallback;
* the plain PyTorch version (``*_plain``), used for CPU tensors and by the
  tests and ``chip_smoke.py`` as the reference on the card. It unpacks the
  bits to float32 and runs one matmul, which is exact: every count is an
  integer <= 4096 < 2**24.

Both take an optional int64 list of rows, read in place (the plain fused
Butina loop, ``ops/butina.fused_butina_plain``, runs over its free rows
only). ``launch_counts`` counts the launches of each kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from nvmolkit_tpu_torch._build import similarity_lib
from nvmolkit_tpu_torch.ops.packed_bits import popcount_rows, unpack_bits

METRICS = {"tanimoto": 0, "cosine": 1}
MAX_WORDS = 128  # 4096 bits
_TILE = 64       # output rows/columns per block (csrc/similarity.cu)
_MAX_GRID_Y = 65535
_PLAIN_BLOCK = 4096  # rows/columns per tile of neighbor_counts_plain
# K1 takes the few-column configuration up to this many columns; chosen from
# chip_smoke.py's sweep over m in {1, 8, 16, 32, 64} (PERF.md)
M_SKINNY = 16

launch_counts = {"cross_similarity": 0, "cross_similarity_few_columns": 0, "neighbor_counts": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _metric_id(metric: str) -> int:
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    return METRICS[metric]


def _check_fps(x: torch.Tensor, name: str) -> None:
    if x.dim() != 2 or x.dtype != torch.int32:
        raise ValueError(f"{name} must be a 2-D int32 tensor of packed words, got {x.dtype} {tuple(x.shape)}")
    if not 0 < x.shape[1] <= MAX_WORDS:
        raise ValueError(f"{name} has {x.shape[1]} words per row; 1..{MAX_WORDS} are supported")


def _check_rows(x: torch.Tensor, name: str) -> torch.Tensor:
    if x.dim() != 1 or x.dtype != torch.int64:
        raise ValueError(f"{name} must be a 1-D int64 tensor")
    return x


def _ptr(x: torch.Tensor | None) -> int | None:
    return None if x is None else x.data_ptr()


def _check_cuda(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed with CUDA error {rc}")


def _similarity_from_counts(common, pa, pb, metric: str) -> torch.Tensor:
    """Epilogue of the plain versions: float32 counts -> similarity."""
    if metric == "tanimoto":
        denom = pa[:, None] + pb[None, :] - common
    else:
        denom = torch.sqrt(pa[:, None] * pb[None, :])
    return torch.where(denom > 0, common / denom, 0.0)


def cross_similarity_plain(
    a: torch.Tensor, b: torch.Tensor, metric: str = "tanimoto", a_rows: torch.Tensor | None = None,
) -> torch.Tensor:
    """Dense [n, m] float32 similarity: unpack to float32, one matmul.
    With ``a_rows``, the rows are ``a[a_rows]``."""
    _metric_id(metric)
    if a_rows is not None:
        a = a[a_rows]
    common = unpack_bits(a) @ unpack_bits(b).T
    pa = popcount_rows(a).to(torch.float32)
    pb = popcount_rows(b).to(torch.float32)
    return _similarity_from_counts(common, pa, pb, metric)


def cross_similarity(
    a: torch.Tensor, b: torch.Tensor, metric: str = "tanimoto", a_rows: torch.Tensor | None = None,
) -> torch.Tensor:
    """Dense float32 similarity of a [n, W] against b [m, W], [n, m]; with
    ``a_rows`` (int64 [r]) of the rows ``a[a_rows]``, [r, m], read in place.
    Kernel K1 for CUDA tensors: the few-column configuration when
    m <= M_SKINNY and the rows are 16-byte aligned, else 64 x 64 tiles. The
    plain version for CPU tensors."""
    _metric_id(metric)
    _check_fps(a, "a")
    _check_fps(b, "b")
    if a.shape[1] != b.shape[1]:
        raise ValueError(f"word counts differ: {a.shape[1]} and {b.shape[1]}")
    extra = () if a_rows is None else (_check_rows(a_rows, "a_rows"),)
    if not a.is_cuda:
        if any(t.is_cuda for t in (b, *extra)):
            raise ValueError("a is on the CPU and another input on CUDA")
        return cross_similarity_plain(a, b, metric, a_rows)
    _check_cuda(a, b, *extra)
    return _launch_k1(a, b, metric, a_rows, _takes_few_columns(a, b.shape[0]))


def _takes_few_columns(a: torch.Tensor, m: int) -> bool:
    """Whether ``cross_similarity`` runs K1 over m columns of the rows ``a``
    in the few-column configuration."""
    return m <= M_SKINNY and a.shape[1] % 4 == 0 and a.data_ptr() % 16 == 0


def _launch_k1(
    a: torch.Tensor, b: torch.Tensor, metric: str, a_rows: torch.Tensor | None, few: bool,
) -> torch.Tensor:
    """K1 on checked CUDA inputs, in the configuration ``few`` names: the
    few-column kernel (up to 64 columns, 16-byte aligned rows, W % 4 == 0)
    or the 64 x 64 tiles. ``cross_similarity`` picks it; chip_smoke.py's
    M_SKINNY sweep and the CUDA tests force one."""
    n = a.shape[0] if a_rows is None else a_rows.shape[0]
    m, w = b.shape[0], a.shape[1]
    out = torch.empty((n, m), dtype=torch.float32, device=a.device)
    if n == 0 or m == 0:
        return out
    if not few and (n + _TILE - 1) // _TILE > _MAX_GRID_Y:
        raise ValueError(f"{n} rows exceed the kernel's grid; split the call")
    lib = similarity_lib()
    name, launch = (("cross_similarity_few_columns", lib.nvmk_few_columns_similarity) if few
                    else ("cross_similarity", lib.nvmk_cross_similarity))
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(a.data_ptr(), _ptr(a_rows), n, b.data_ptr(), m, w, _metric_id(metric),
                    out.data_ptr(), stream)
    _raise_on(rc, name)
    launch_counts[name] += 1
    return out


def neighbor_counts_plain(
    fps: torch.Tensor, cols: torch.Tensor, threshold: float, metric: str = "tanimoto",
    rows: torch.Tensor | None = None,
) -> torch.Tensor:
    """counts[i] = #{r : sim(fps[row i], fps[cols[r]]) >= threshold} (int32),
    where row i is ``rows[i]`` when ``rows`` is given, else i; computed over
    [_PLAIN_BLOCK, _PLAIN_BLOCK] tiles, so memory stays O(N + R) whatever
    the number of columns."""
    thr = float(np.float32(threshold))
    n = fps.shape[0] if rows is None else rows.shape[0]
    counts = torch.zeros(n, dtype=torch.int32, device=fps.device)
    for c0 in range(0, cols.shape[0], _PLAIN_BLOCK):
        b = fps[cols[c0:c0 + _PLAIN_BLOCK]]
        for r0 in range(0, n, _PLAIN_BLOCK):
            a = fps[r0:r0 + _PLAIN_BLOCK] if rows is None else fps[rows[r0:r0 + _PLAIN_BLOCK]]
            sim = cross_similarity_plain(a, b, metric)
            counts[r0:r0 + _PLAIN_BLOCK] += (sim >= thr).sum(dim=1, dtype=torch.int32)
    return counts


def neighbor_counts(
    fps: torch.Tensor, cols: torch.Tensor, threshold: float, metric: str = "tanimoto",
    rows: torch.Tensor | None = None,
) -> torch.Tensor:
    """Neighbor counts among the rows ``cols`` (int64 [R]) of ``fps`` [N, W],
    where a neighbor has similarity >= ``threshold`` (compared in float32):
    int32 [N], or int32 [len(rows)] over the rows ``rows`` (int64) when given.
    Kernel K2 on CUDA, else plain."""
    metric_id = _metric_id(metric)
    _check_fps(fps, "fps")
    _check_rows(cols, "cols")
    extra = () if rows is None else (_check_rows(rows, "rows"),)
    if not fps.is_cuda:
        return neighbor_counts_plain(fps, cols, threshold, metric, rows)
    _check_cuda(fps, cols, *extra)
    n = fps.shape[0] if rows is None else rows.shape[0]
    r = cols.shape[0]
    counts = torch.zeros(n, dtype=torch.int32, device=fps.device)
    if n == 0 or r == 0:
        return counts
    # enough blocks to fill the card when there are few row tiles: column
    # tiles are split over up to 8 groups, each adding into counts
    col_tiles = (r + _TILE - 1) // _TILE
    col_groups = max(1, min(col_tiles, 8))
    lib = similarity_lib()
    with torch.cuda.device(fps.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.nvmk_neighbor_counts(
            fps.data_ptr(), _ptr(rows), n, fps.shape[1], cols.data_ptr(), r,
            float(np.float32(threshold)), metric_id, counts.data_ptr(), col_groups, stream,
        )
    _raise_on(rc, "neighbor_counts")
    launch_counts["neighbor_counts"] += 1
    return counts


def cross_similarity_chunked(
    a: torch.Tensor, b: torch.Tensor, metric: str = "tanimoto",
    max_device_memory_bytes: int = 2 << 30,
) -> np.ndarray:
    """Memory-bounded variant: the [n, m] output is computed in row blocks
    (two float32 blocks fit in ``max_device_memory_bytes``) and each block
    is copied into one host numpy array."""
    n, m = a.shape[0], b.shape[0]
    rows_per_chunk = max(1, int(max_device_memory_bytes // (2 * 4 * max(m, 1))))
    out = np.empty((n, m), dtype=np.float32)
    for start in range(0, n, rows_per_chunk):
        stop = min(start + rows_per_chunk, n)
        out[start:stop] = cross_similarity(a[start:stop], b, metric).cpu().numpy()
    return out
