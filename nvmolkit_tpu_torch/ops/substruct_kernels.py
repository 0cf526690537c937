"""The substructure engine's device kernels K19-K22, with their plain versions.

One call covers one query against the live targets of one atom bucket
(``ops/substruct_device.py`` makes the inputs and keeps them on the card):

* :func:`gsi_join` — K19 (``csrc/substruct.cu``) for CUDA tensors, else
  :func:`gsi_join_plain`: the breadth-first join of the query's traversal
  slots over each pair, the JAX ``_device_gsi_join``. Level 0 lists slot 0's
  candidates in ascending target atom; each later level keeps the cells
  (partial row p, candidate t) that pass the label, injectivity and every
  back edge's bond-code mask, in row-major (p, t) order, the first P of
  them. A pair overflows when slot 0 has more than P candidates or a level
  more than P cells; its count is then 0 and its rows are not written (it
  drains to a host engine). K19 draws each row's candidates from the
  neighbour list of one back-edge atom (:func:`neighbor_lists`): no mask
  accepts bond code 0, so every other cell fails.
* :func:`dedup` — K20, else :func:`dedup_plain`: ``uniquify``, the JAX
  ``_dedup_frontier``: the first row of each set of matched atoms, the
  survivors recompacted to a prefix in order.
* :func:`extract` — K21, else :func:`extract_plain`: every kept row
  (``min(count, maxMatches)`` a pair) in query-atom order as int32, pair by
  pair, the JAX ``_extract_flat`` with the host decode ``flat[:, perm]``.
* :func:`root_mask` — K22, else :func:`root_mask_plain`: ``[B, T]`` bool,
  the target atoms where a complete match puts the pattern's atom 0, the
  JAX ``_root_mask_kernel``. K22 writes every byte of its output, so the
  wrapper allocates it with ``torch.empty`` (no fill launch).

Layouts: label bits as int32 words ``[N, nq, W]`` (bit t of slot s in word
t // 32, :func:`pack_label_words`), the bucket's bond codes ``kind +
8*in_ring`` as uint8 ``[N, T, T]``, each pair's bucket row as int32 ``[B]``,
the query's back edges as int32 ``[nq, E]`` tables (slot, or -1, and the
16-bit mask of accepted codes; K19 copies them into its launch's parameters,
so they may stay in host memory), the bucket's neighbour lists as int16
``[N, T, D]`` and uint8 degrees ``[N, T]``, the frontier as int16 ``[B, P, nq]`` with
each pair's valid rows a prefix (atom ids are below 256). A kernel launches
on the current stream and allocates nothing; its wrapper checks devices,
dtypes and shapes, allocates the outputs and raises on a failed build or
launch (no fallback). ``launch_counts`` counts the launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from nvmolkit_tpu_torch._build import substruct_gpu_lib

launch_counts = {"gsi_join": 0, "dedup": 0, "extract": 0, "root_mask": 0}
MAX_T = 256      # the largest atom bucket: ids fit int16, a row's atom mask 4 words
MAX_EDGES = 4    # EDGE_BUCKETS' largest
MAX_NQ = 64      # QUERY_BUCKETS' largest: K19's back edges ride in its parameters
MAX_DEGREE = 64  # K19 keeps a row's survivors among its walked neighbours in 64 bits
DEDUP_SHARED_ROWS = 128  # K20's survivors' masks a pair keeps in shared memory (csrc)
# the phases of K19's per-pair clock (``_launch_gsi(..., phase_cycles=True)``)
K19_PHASES = ("level0", "tests", "scan", "writes")


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def pack_label_words(labels: np.ndarray) -> np.ndarray:
    """bool ``[..., T]`` -> int32 ``[..., ceil(T / 32)]``, bit t in word t // 32
    at position t % 32."""
    T = labels.shape[-1]
    W = -(-T // 32)
    padded = np.zeros(labels.shape[:-1] + (W * 32,), bool)
    padded[..., :T] = labels
    return np.ascontiguousarray(np.packbits(padded, axis=-1, bitorder="little")).view("<i4")


def _label_bits(words: torch.Tensor, rows: torch.Tensor, T: int) -> torch.Tensor:
    """bool [B, nq, T] from the label words of the pairs' rows."""
    t = torch.arange(T, device=words.device)
    return ((words[rows.long()][:, :, t >> 5] >> (t & 31)) & 1).bool()


def neighbor_lists(adj: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The neighbour lists of bond codes ``adj`` uint8 ``[N, T, T]``, on its
    device: int16 ``[N, T, D]``, each atom's bonded atoms (nonzero codes) in
    ascending order padded with -1, and uint8 ``[N, T]`` their counts; D is
    the largest count (at least 1). Reading D and the bonded cells' count
    are two copies to the host."""
    N, T = adj.shape[:2]
    bonded = adj != 0
    deg = bonded.sum(dim=2)
    D = max(1, int(deg.max())) if deg.numel() else 1
    # the bonded cells in row-major order, so each atom's in ascending t; a
    # cell's place in its atom's list is its rank less the atom's first
    n, i, t = bonded.nonzero(as_tuple=True)
    flat_deg = deg.flatten()
    first = torch.cumsum(flat_deg, 0) - flat_deg
    row = n * T + i
    place = torch.arange(row.numel(), device=adj.device) - first[row]
    nbr = torch.full((N, T, D), -1, dtype=torch.int16, device=adj.device)
    nbr[n, i, place] = t.to(torch.int16)
    return nbr, deg.to(torch.uint8)


def _compact(ok: torch.Tensor, P: int):
    """The first P set cells of each pair's row-major ``ok`` [B, K]:
    (pair, output slot, flat cell) of each kept cell, and each pair's total."""
    total = ok.sum(dim=1)
    b, k = ok.nonzero(as_tuple=True)
    rank = (torch.cumsum(ok, dim=1) - 1)[b, k]
    keep = rank < P
    return b[keep], rank[keep], k[keep], total


def gsi_join_plain(words, adj, rows, back_slot, back_mask, frontier_cap: int):
    """:func:`gsi_join` in PyTorch operations."""
    B, nq, T, P = rows.shape[0], words.shape[1], adj.shape[1], frontier_cap
    dev = words.device
    labels = _label_bits(words, rows, T)
    rows_l = rows.long()
    frontier = torch.full((B, P, nq), -1, dtype=torch.int64, device=dev)
    b, slot, t, total = _compact(labels[:, 0, :], P)
    frontier[b, slot, 0] = t
    overflow = total > P
    n = total.clamp(max=P)
    slots, masks = back_slot.tolist(), back_mask.tolist()
    for i in range(1, nq):
        valid = torch.arange(P, device=dev)[None, :] < n[:, None]
        ok = valid[:, :, None] & labels[:, i][:, None, :]
        used = torch.zeros((B, P, T), dtype=torch.bool, device=dev)
        used.scatter_(2, frontier[:, :, :i].clamp(min=0), True)
        ok &= ~used
        for s, m in zip(slots[i], masks[i]):
            if s >= 0:
                code = adj[rows_l[:, None], frontier[:, :, s].clamp(min=0)].long()  # [B, P, T]
                ok &= ((m >> code) & 1).bool()
        b, slot, cell, total = _compact(ok.view(B, P * T), P)
        nxt = torch.full_like(frontier, -1)
        nxt[b, slot] = frontier[b, cell // T]
        nxt[b, slot, i] = cell % T
        frontier = nxt
        overflow |= total > P
        n = total.clamp(max=P)
    counts = torch.where(overflow, 0, n).to(torch.int32)
    return frontier.to(torch.int16), counts, overflow


def _check(name, t, dtype, dim, device):
    if t.dtype != dtype or t.dim() != dim or not t.is_contiguous() or t.device != device:
        raise ValueError(f"{name} must be a contiguous {dim}-d {dtype} tensor on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def gsi_join(words, adj, rows, back_slot, back_mask, frontier_cap: int, neighbors):
    """(frontier int16 [B, P, nq], counts int32 [B], overflow bool [B]) of
    one query over the pairs whose bucket rows are ``rows``: K19 for CUDA
    tensors (one launch), the plain version for CPU tensors. ``neighbors``
    is the bucket's ``(lists, degrees)`` (:func:`neighbor_lists` of
    ``adj``), which K19 walks; the plain version reads no lists (it may be
    None on the CPU)."""
    if not words.is_cuda:
        _edge_tables(back_slot, back_mask)
        return gsi_join_plain(words, adj, rows, back_slot, back_mask, frontier_cap)
    return _launch_gsi(words, adj, rows, back_slot, back_mask, frontier_cap, neighbors)


def _edge_tables(back_slot, back_mask) -> tuple[np.ndarray, np.ndarray]:
    """The back-edge tables as int32 host arrays (no copy from host tensors),
    refused when a mask accepts bond code 0 ("no bond") or a slot past the
    first has no back edge: the join's candidates are then not all bonded
    neighbours of a back-edge atom."""
    slots = np.ascontiguousarray(back_slot.cpu().numpy(), np.int32)
    masks = np.ascontiguousarray(back_mask.cpu().numpy(), np.int32)
    if ((masks & 1) != 0).any():
        raise ValueError("gsi_join walks neighbour lists: no back-edge mask may accept bond "
                         "code 0")
    if slots.ndim == 2 and len(slots) > 1 and not (slots[1:] >= 0).any(axis=1).all():
        raise ValueError("gsi_join needs a back edge at every traversal slot past the first "
                         "(a connected query)")
    return slots, masks


def _launch_gsi(words, adj, rows, back_slot, back_mask, frontier_cap: int, neighbors,
                phase_cycles: bool = False):
    """One K19 launch; with ``phase_cycles`` also int64 [B, 4] cycles of
    :data:`K19_PHASES` per pair."""
    dev = words.device
    _check("label words", words, torch.int32, 3, dev)
    _check("bond codes", adj, torch.uint8, 3, dev)
    _check("rows", rows, torch.int32, 1, dev)
    slots, masks = _edge_tables(back_slot, back_mask)
    N, nq, W = words.shape
    T = adj.shape[1]
    E = slots.shape[1] if slots.ndim == 2 else 0
    if (adj.shape != (N, T, T) or T > MAX_T or W != -(-T // 32) or not 1 <= E <= MAX_EDGES
            or nq > MAX_NQ or slots.shape != (nq, E) or masks.shape != (nq, E)
            or frontier_cap < 1):
        raise ValueError(f"K19 takes T <= {MAX_T}, [N, nq <= {MAX_NQ}, ceil(T/32)] words, "
                         f"[N, T, T] codes and [nq, E <= {MAX_EDGES}] back edges; got words "
                         f"{tuple(words.shape)}, codes {tuple(adj.shape)}, back edges "
                         f"{slots.shape}, P {frontier_cap}")
    if neighbors is None:
        raise ValueError("K19 walks the bucket's neighbour lists: pass neighbor_lists(adj)")
    nbr, deg = neighbors
    _check("neighbour lists", nbr, torch.int16, 3, dev)
    _check("degrees", deg, torch.uint8, 2, dev)
    D = nbr.shape[2]
    if nbr.shape[:2] != (N, T) or deg.shape != (N, T) or D > MAX_DEGREE:
        raise ValueError(f"K19 takes [N, T, D <= {MAX_DEGREE}] neighbour lists and [N, T] "
                         f"degrees of the [N, T, T] codes {tuple(adj.shape)}; got "
                         f"{tuple(nbr.shape)} and {tuple(deg.shape)}")
    B, P = rows.shape[0], frontier_cap
    out = torch.empty((B, P, nq), dtype=torch.int16, device=dev)
    counts = torch.empty(B, dtype=torch.int32, device=dev)
    overflow = torch.empty(B, dtype=torch.bool, device=dev)
    cycles = (torch.zeros((B, len(K19_PHASES)), dtype=torch.int64, device=dev)
              if phase_cycles else None)
    if B == 0:
        return (out, counts, overflow, cycles) if phase_cycles else (out, counts, overflow)
    scratch = torch.empty_like(out)
    lib = substruct_gpu_lib()
    with torch.cuda.device(dev):
        rc = lib.nvmk_gsi_join(
            words.data_ptr(), adj.data_ptr(), nbr.data_ptr(), deg.data_ptr(), rows.data_ptr(),
            slots.ctypes.data, masks.ctypes.data, B, nq, T, W, E, D, P, out.data_ptr(),
            scratch.data_ptr(), counts.data_ptr(), overflow.data_ptr(),
            None if cycles is None else cycles.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gsi_join kernel launch failed with CUDA error {rc}")
    launch_counts["gsi_join"] += 1
    return (out, counts, overflow, cycles) if phase_cycles else (out, counts, overflow)


def gsi_info() -> dict:
    """K19's instantiation: registers and spilled bytes a thread, resident
    blocks an SM, shared bytes a block, pairs a block and an SM."""
    out = (ctypes.c_int * 5)()
    rc = substruct_gpu_lib().nvmk_gsi_info(out)
    if rc != 0:
        raise RuntimeError(f"nvmk_gsi_info failed with CUDA error {rc}")
    return {"registers": out[0], "local_bytes": out[1], "blocks_per_sm": out[2],
            "shared_bytes": out[3], "pairs_per_block": out[4], "pairs_per_sm": out[2] * out[4],
            "layout": "warp per pair"}


def dedup_plain(frontier, counts, T: int):
    """:func:`dedup` in PyTorch operations."""
    B, P, nq = frontier.shape
    dev = frontier.device
    valid = torch.arange(P, device=dev)[None, :] < counts[:, None]
    atoms = torch.where(valid[:, :, None], frontier.long(), 0)  # rows past a count: any value
    # a row's atoms are distinct, so the sum of their bits is their OR
    words = torch.zeros((B, P, -(-T // 64)), dtype=torch.int64, device=dev)
    words.scatter_add_(2, atoms >> 6, torch.ones_like(atoms) << (atoms & 63))
    same = (words[:, :, None, :] == words[:, None, :, :]).all(dim=3)   # [B, P, P]
    earlier = torch.ones((P, P), dtype=torch.bool, device=dev).tril(-1)
    keep = valid & ~(same & earlier & valid[:, None, :]).any(dim=2)
    b, slot, row, total = _compact(keep, P)
    out = torch.full_like(frontier, -1)
    out[b, slot] = frontier[b, row]
    return out, total.to(torch.int32)


def dedup(frontier, counts, T: int):
    """(frontier', counts'): each pair's first row of every set of matched
    atoms, recompacted to a prefix. K20 for CUDA tensors (rows past a
    pair's new count left unwritten), the plain version for CPU tensors."""
    if not frontier.is_cuda:
        return dedup_plain(frontier, counts, T)
    dev = frontier.device
    _check("frontier", frontier, torch.int16, 3, dev)
    _check("counts", counts, torch.int32, 1, dev)
    B, P, nq = frontier.shape
    if counts.shape[0] != B or T > MAX_T or nq < 1:
        raise ValueError(f"K20 takes [B] counts, nq >= 1 and T <= {MAX_T}, got "
                         f"{tuple(counts.shape)}, nq {nq}, T {T}")
    out = torch.empty_like(frontier)
    new_counts = torch.empty_like(counts)
    if B == 0:
        return out, new_counts
    W64 = -(-T // 64)
    # the survivors' masks past the kernel's shared memory (a raised P only)
    spill = (torch.empty((B, P, W64), dtype=torch.int64, device=dev)
             if P > DEDUP_SHARED_ROWS else None)
    lib = substruct_gpu_lib()
    with torch.cuda.device(dev):
        rc = lib.nvmk_dedup(frontier.data_ptr(), counts.data_ptr(), B, nq, P, W64,
                            None if spill is None else spill.data_ptr(), out.data_ptr(),
                            new_counts.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dedup kernel launch failed with CUDA error {rc}")
    launch_counts["dedup"] += 1
    return out, new_counts


def kept_offsets(counts, max_matches: int, frontier_cap: int) -> torch.Tensor:
    """int64 [B]: the inclusive cumsum of each pair's kept rows,
    ``min(count, max_matches)`` (an overflowed pair's count is 0). One
    launch when ``max_matches >= frontier_cap`` (no count exceeds the cap),
    two otherwise."""
    kept = counts if max_matches >= frontier_cap else counts.clamp(max=max_matches)
    return torch.cumsum(kept, dim=0, dtype=torch.int64)


def extract_plain(frontier, counts, perm, max_matches: int):
    """:func:`extract` in PyTorch operations."""
    B, P, nq = frontier.shape
    keep = torch.arange(P, device=frontier.device)[None, :] < counts.long().clamp(
        max=max_matches)[:, None]
    return frontier[keep][:, perm.long()].to(torch.int32)


def extract(frontier, counts, perm, max_matches: int, n_rows: int | None = None):
    """int32 [sum of kept, nq]: each pair's first ``min(count, max_matches)``
    rows, pair by pair, column q the target atom of query atom q (``perm``:
    the traversal slot of each query atom). K21 for CUDA tensors, the plain
    version for CPU tensors; ``n_rows`` (the sum, when the caller has it on
    the host) saves a sync."""
    if not frontier.is_cuda:
        return extract_plain(frontier, counts, perm, max_matches)
    ends = kept_offsets(counts, max_matches, frontier.shape[1])
    return _launch_extract(frontier, counts, perm, max_matches, ends, n_rows)


def _launch_extract(frontier, counts, perm, max_matches: int, ends, n_rows: int | None = None):
    """One K21 launch on ``ends`` (:func:`kept_offsets` of the counts)."""
    dev = frontier.device
    _check("frontier", frontier, torch.int16, 3, dev)
    _check("counts", counts, torch.int32, 1, dev)
    _check("perm", perm, torch.int32, 1, dev)
    _check("ends", ends, torch.int64, 1, dev)
    B, P, nq = frontier.shape
    if (counts.shape[0] != B or perm.shape[0] != nq or ends.shape[0] != B or not 1 <= nq <= MAX_NQ
            or P * nq >= 2**31 or max_matches < 0):
        raise ValueError(f"K21 takes [B] counts and ends, [nq <= {MAX_NQ}] perm, P * nq < 2^31 "
                         f"and max_matches >= 0, got {tuple(counts.shape)}, {tuple(ends.shape)}, "
                         f"{tuple(perm.shape)} for a [{B}, {P}, {nq}] frontier, {max_matches}")
    if n_rows is None:
        n_rows = int(ends[-1]) if B else 0
    out = torch.empty((n_rows, nq), dtype=torch.int32, device=dev)
    if n_rows == 0:
        return out
    lib = substruct_gpu_lib()
    with torch.cuda.device(dev):
        rc = lib.nvmk_extract(frontier.data_ptr(), counts.data_ptr(), ends.data_ptr(),
                              perm.data_ptr(), B, nq, P, min(max_matches, P), out.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"extract kernel launch failed with CUDA error {rc}")
    launch_counts["extract"] += 1
    return out


def dedup_extract_info(B: int = 0) -> dict:
    """K20's (at one mask word) and K21's instantiations: registers and
    spilled bytes a thread, resident blocks an SM, shared bytes, pairs and
    threads a block, and the grid a launch over ``B`` pairs takes."""
    out = (ctypes.c_int * 14)()
    rc = substruct_gpu_lib().nvmk_dedup_extract_info(B, out)
    if rc != 0:
        raise RuntimeError(f"nvmk_dedup_extract_info failed with CUDA error {rc}")
    keys = ("registers", "local_bytes", "blocks_per_sm", "shared_bytes", "pairs_per_block", "grid",
            "threads")
    return {"dedup": dict(zip(keys, out[0:7])), "extract": dict(zip(keys, out[7:14]))}


def root_mask_plain(frontier, counts, slot0: int, T: int):
    """:func:`root_mask` in PyTorch operations."""
    B, P, _ = frontier.shape
    valid = torch.arange(P, device=frontier.device)[None, :] < counts[:, None]
    b, r = valid.nonzero(as_tuple=True)
    out = torch.zeros((B, T), dtype=torch.bool, device=frontier.device)
    out[b, frontier[b, r, slot0].long()] = True
    return out


def root_mask(frontier, counts, slot0: int, T: int):
    """bool [B, T]: the target atoms at traversal slot ``slot0`` of each
    pair's valid rows. K22 for CUDA tensors, the plain version for CPU
    tensors."""
    if not frontier.is_cuda:
        return root_mask_plain(frontier, counts, slot0, T)
    B = frontier.shape[0] if frontier.dim() == 3 else 0
    out = torch.empty((B, T), dtype=torch.bool, device=frontier.device)
    return _launch_root_mask(frontier, counts, slot0, T, out)


def _launch_root_mask(frontier, counts, slot0: int, T: int, out):
    """K22 into ``out`` (bool [B, T], contiguous, on the frontier's
    device), every byte written; returns ``out``."""
    dev = frontier.device
    _check("frontier", frontier, torch.int16, 3, dev)
    _check("counts", counts, torch.int32, 1, dev)
    _check("out", out, torch.bool, 2, dev)
    B, P, nq = frontier.shape
    if counts.shape[0] != B or not 0 <= slot0 < nq or not 1 <= T <= MAX_T or out.shape != (B, T):
        raise ValueError(f"K22 takes [B] counts, a slot below {nq}, 1 <= T <= {MAX_T} and a "
                         f"[B, T] output, got {tuple(counts.shape)}, {slot0}, {T}, "
                         f"{tuple(out.shape)}")
    if B == 0:
        return out
    lib = substruct_gpu_lib()
    with torch.cuda.device(dev):
        rc = lib.nvmk_root_mask(frontier.data_ptr(), counts.data_ptr(), B, P, nq, slot0, T,
                                out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"root_mask kernel launch failed with CUDA error {rc}")
    launch_counts["root_mask"] += 1
    return out


def root_mask_info(B: int = 0) -> dict:
    """K22's instantiation: registers and spilled bytes a thread, resident
    blocks an SM, shared bytes, pairs and threads a block, and the grid a
    launch over ``B`` pairs takes."""
    out = (ctypes.c_int * 7)()
    rc = substruct_gpu_lib().nvmk_root_mask_info(B, out)
    if rc != 0:
        raise RuntimeError(f"nvmk_root_mask_info failed with CUDA error {rc}")
    keys = ("registers", "local_bytes", "blocks_per_sm", "shared_bytes", "pairs_per_block", "grid",
            "threads")
    return dict(zip(keys, out))
