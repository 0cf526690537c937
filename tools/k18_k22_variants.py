"""Variants of K18 and K22, timed in turns with the package's kernels.

Run through ``python3 tools/k18_k22_phase_split.py --variants`` (one card).
Each variant is the package's ``nvmolkit_tpu_torch/csrc/tfd.cu`` (K18) or
``csrc/substruct.cu`` (K22) with the textual changes listed in
``VARIANTS``, written under the package's gitignored build directory and
built with nvcc (all at once); its ``nvmk_tfd_pairs`` / ``nvmk_root_mask``
(the package's C ABI) runs on the phase split's inputs, is held against the
package's output (K18: the largest |difference| and whether it is equal;
K22: equal), and is timed hot and cold (``chip_smoke.median_ms``) in turns:
package, each variant, then the same backwards. A variant with ``tile``
runs on a tile table of that side (``ops/tfd.pair_tiles``); one in
``DIAGONAL_ONLY`` runs only on inputs whose tiles are all on the diagonal
(no molecule past ``TILE`` conformers). ``clocked``
adds clock64() laps of thread 0 of each block (setup, chunk table,
staging, pairs, store) and prints their split
(``chip_smoke.phase_split``). A ``probe_`` variant leaves out part of the
work to time what is left: its output differs by design.
"""
from __future__ import annotations

import ctypes
import statistics
from concurrent.futures import ThreadPoolExecutor

K18_CLOCK_PHASES = ("setup", "chunk_table", "staging", "pairs", "store")
_DIV = "div_by(dev, md, rmd)"
_BYTE_ROW = ("    for (int t = lane; t < T; t += 32) "
             "dst[t] = (uint8_t)((row_bits[t >> 5] >> (t & 31)) & 1u);\n")
_LAP = ("{ if (threadIdx.x == 0) { const long long n_ = clock64(); clk_acc[%d] += n_ - clk_t; "
        "clk_t = n_; } }")
_CLOCKED = [
    ("extern __shared__ __align__(16) float vals[];\n",
     "extern __shared__ __align__(16) float vals[];\n"
     "  long long clk_t = clock64(), clk_acc[5] = {0, 0, 0, 0, 0};\n"),
    ("  for (int64_t t_lo = t_begin; t_lo < t_end;) {\n",
     "  {volatile float f_ = ang[0]; (void)f_;}\n  " + _LAP % 0 + "\n"
     "  for (int64_t t_lo = t_begin; t_lo < t_end;) {\n"),
    ("    __syncthreads();\n    // the tile's conformers' values",
     "    __syncthreads();\n    " + _LAP % 1 + "\n    // the tile's conformers' values"),
    ("    __syncthreads();\n    if (diag) {\n",
     "    __syncthreads();\n    " + _LAP % 2 + "\n    if (diag) {\n"),
    ("    __syncthreads();  // the next chunk restages\n",
     "    __syncthreads();  // the next chunk restages\n    " + _LAP % 3 + "\n"),
    ("        dst[row + j] = wsum > 1e-10f ? __fdiv_rn(num[r][h], fmaxf(wsum, 1e-10f)) : 0.0f;\n"
     "      }\n    }\n  }\n}\n",
     "        dst[row + j] = wsum > 1e-10f ? __fdiv_rn(num[r][h], fmaxf(wsum, 1e-10f)) : 0.0f;\n"
     "      }\n    }\n  }\n  " + _LAP % 4 + "\n"
     "  if (threadIdx.x == 0 && g_k18_cycles != nullptr)\n"
     "    for (int p = 0; p < 5; ++p) g_k18_cycles[(size_t)blockIdx.x * 5 + p] = clk_acc[p];\n}\n"),
    ("__host__ __device__ constexpr size_t tile_shared_bytes(",
     "__device__ long long* g_k18_cycles = nullptr;\n\n"
     "__host__ __device__ constexpr size_t tile_shared_bytes("),
    ('}  // extern "C"', 'int k18_set_cycles(void* p) {\n'
     '  return (int)cudaMemcpyToSymbol(g_k18_cycles, &p, sizeof(p));\n}\n\n}  // extern "C"'),
]

# name -> (kernel, [(old, new), ...] applied to the package's source, tile side or None)
VARIANTS = {
    "clocked": ("tfd", _CLOCKED, None),
    "probe_no_pairs": ("tfd", [("      for (int k = 0; k < nt; ++k) {\n        const int type",
                                "      for (int k = 0; k < 0; ++k) {\n        const int type")],
                       None),
    # the division as the plain version's operation (IEEE, __fdiv_rn), or by
    # the reciprocal without the correction step (an ulp of a term)
    "ieee_division": ("tfd", [(_DIV, "__fdiv_rn(dev, md)")], None),
    "reciprocal_uncorrected": ("tfd", [(_DIV, "__fmul_rn(dev, rmd)")], None),
    "min_6_blocks": ("tfd", [("__launch_bounds__(32 * TILE_WARPS)\ntfd_kernel(",
                              "__launch_bounds__(32 * TILE_WARPS, 6)\ntfd_kernel(")], None),
    "min_8_blocks": ("tfd", [("__launch_bounds__(32 * TILE_WARPS)\ntfd_kernel(",
                              "__launch_bounds__(32 * TILE_WARPS, 8)\ntfd_kernel(")], None),
    "tile_32": ("tfd", [("constexpr int TILE = 64;", "constexpr int TILE = 32;")], 32),
    "tile_32_4_warps": ("tfd", [("constexpr int TILE = 64;", "constexpr int TILE = 32;"),
                                ("constexpr int TILE_WARPS = 8;", "constexpr int TILE_WARPS = 4;")],
                        32),
    "tile_128_16_warps": ("tfd", [("constexpr int TILE = 64;", "constexpr int TILE = 128;"),
                                  ("constexpr int TILE_WARPS = 8;",
                                   "constexpr int TILE_WARPS = 16;")], 128),
    "root_mask_4_pairs_a_block": ("root_mask", [("constexpr int MASK_WARPS = 8;",
                                                 "constexpr int MASK_WARPS = 4;")], None),
    "root_mask_16_pairs_a_block": ("root_mask", [("constexpr int MASK_WARPS = 8;",
                                                  "constexpr int MASK_WARPS = 16;")], None),
    # the staged values at a stride of TILE: only where every tile is diagonal
    "stride_tile": ("tfd", [("constexpr int VSTRIDE = 2 * TILE;", "constexpr int VSTRIDE = TILE;")],
                    None),
    # the row written as T / 4 32-bit words (byte t of word u from bit 4u + (t & 3)):
    # only where T % 4 == 0 and the output is 4-byte aligned, as at the path's launches
    "root_mask_word_stores": ("root_mask", [(
        _BYTE_ROW,
        "    for (int u = lane; u < (T >> 2); u += 32) {\n"
        "      const unsigned nib = (row_bits[u >> 3] >> ((u & 7) * 4)) & 0xfu;\n"
        "      reinterpret_cast<uint32_t*>(dst)[u] =\n"
        "          (nib & 1u) | ((nib & 2u) << 7) | ((nib & 4u) << 14) | ((nib & 8u) << 21);\n"
        "    }\n")], None),
}
DIAGONAL_ONLY = {"stride_tile"}


def _build_variant(name: str, kernel: str, patches) -> ctypes.CDLL:
    from nvmolkit_tpu_torch import _build

    src_path = _build.TFD_SRC if kernel == "tfd" else _build.SUBSTRUCT_GPU_SRC
    text = src_path.read_text()
    for old, new in patches:
        if old not in text:
            raise RuntimeError(f"variant {name}: {old!r} is not in the package's source")
        text = text.replace(old, new)
    out_dir = _build.BUILD_DIR / "k18_k22_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"{name}.cu"
    src.write_text(text)
    lib = ctypes.CDLL(str(_build._build(f"libk18_k22_{name}", src, _build._nvcc_cmd(src))))
    if kernel == "tfd":
        _build._declare_tfd(lib)
    else:
        _build._declare_substruct_gpu(lib)
    if name == "clocked":
        lib.k18_set_cycles.restype = ctypes.c_int
        lib.k18_set_cycles.argtypes = [ctypes.c_void_p]
    return lib


def _stream():
    import torch

    return torch.cuda.current_stream().cuda_stream


def _tiles_of(batch, tile: int):
    """Tiles int32 [n, 3] on the batch's device at another side."""
    import torch

    from nvmolkit_tpu_torch.ops import tfd as tfd_ops

    counts = batch.mol_offsets[tfd_ops.CONFS].diff().cpu().numpy()
    saved = tfd_ops.TILE
    tfd_ops.TILE = tile
    try:
        tiles = tfd_ops.pair_tiles(counts)
    finally:
        tfd_ops.TILE = saved
    return torch.from_numpy(tiles).to(batch.tiles.device)


def _k18_with(lib, angles, batch, tile=None):
    import torch

    tiles = batch.tiles if tile is None else _tiles_of(batch, tile)
    out = torch.zeros(batch.n_out, dtype=torch.float32, device=angles.device)

    def launch():
        rc = lib.nvmk_tfd_pairs(
            angles.data_ptr(), batch.mol_offsets.data_ptr(), batch.torsion_quartets.data_ptr(),
            batch.value_starts.data_ptr(), batch.types.data_ptr(), batch.weights.data_ptr(),
            batch.max_dev.data_ptr(), tiles.data_ptr(), batch.n_mols, tiles.shape[0], batch.cap,
            out.data_ptr(), _stream())
        if rc != 0:
            raise RuntimeError(f"nvmk_tfd_pairs failed with CUDA error {rc}")
        return out
    return launch, tiles.shape[0]


def _k22_with(lib, args):
    import torch

    frontier, counts, slot0, T = args
    B, P, nq = frontier.shape
    out = torch.empty((B, T), dtype=torch.bool, device=frontier.device)

    def launch():
        rc = lib.nvmk_root_mask(frontier.data_ptr(), counts.data_ptr(), B, P, nq, slot0, T,
                                out.data_ptr(), _stream())
        if rc != 0:
            raise RuntimeError(f"nvmk_root_mask failed with CUDA error {rc}")
        return out
    return launch


def _turns(smoke, fns: dict, reps: int, flush) -> dict:
    names = list(fns)
    runs = {n: {"hot": [], "cold": []} for n in names}
    for n in names + names[::-1]:
        runs[n]["hot"].append(smoke.median_ms(fns[n], reps))
        runs[n]["cold"].append(smoke.median_ms(fns[n], reps, flush=flush))
    return {n: {"ms": statistics.median(v["hot"]), "ms_runs": v["hot"],
                "cold_ms": statistics.median(v["cold"]), "cold_ms_runs": v["cold"]}
            for n, v in runs.items()}


def run(smoke, tfd_inputs, k22_args, rates, reps, flush, emit) -> None:
    import torch

    from nvmolkit_tpu_torch import _build
    from nvmolkit_tpu_torch.ops import tfd as tfd_ops

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        jobs = {name: pool.submit(_build_variant, name, kernel, patches)
                for name, (kernel, patches, _) in VARIANTS.items()}
        libs = {}
        for name, job in jobs.items():
            try:
                libs[name] = job.result()
            except RuntimeError as err:  # a variant that does not build is reported, not timed
                emit(result="variant_build_failed", variant=name, error=str(err)[-2000:])
    for label, angles, batch, _, _ in tfd_inputs:
        diagonal = bool((batch.tiles[:, 1] == batch.tiles[:, 2]).all())
        names = [n for n, (k, _, _) in VARIANTS.items()
                 if k == "tfd" and n in libs and (diagonal or n not in DIAGONAL_ONLY)]
        fns, grids = {}, {}
        fns["package"], grids["package"] = _k18_with(_build.tfd_lib(), angles, batch)
        for n in names:
            fns[n], grids[n] = _k18_with(libs[n], angles, batch, VARIANTS[n][2])
        want = fns["package"]().clone()
        plain = tfd_ops.tfd_pairs_plain(angles, batch)
        checks = {}
        for n, fn in fns.items():
            got = fn()
            checks[n] = {"equal_to_package": bool(torch.equal(got, want)),
                         "max_abs_err_vs_package": float((got - want).abs().max()),
                         "max_abs_err_vs_plain": float((got - plain).abs().max()),
                         "grid": grids[n]}
        times = _turns(smoke, fns, reps, flush)
        row = {n: {**times[n], **checks[n]} for n in fns}
        if "clocked" in libs:
            cyc = torch.zeros((grids["clocked"], len(K18_CLOCK_PHASES)), dtype=torch.int64,
                              device=angles.device)
            libs["clocked"].k18_set_cycles(cyc.data_ptr())
            fns["clocked"]()
            torch.cuda.synchronize()
            cyc.zero_()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            flush.zero_()
            start.record()
            fns["clocked"]()
            stop.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(stop)
            libs["clocked"].k18_set_cycles(None)
            row["clocked"]["clocked_ms"] = ms
            row["clocked"]["phase_split"] = smoke.phase_split(cyc.cpu(), K18_CLOCK_PHASES, ms)
        emit(result="k18_variants", input=label, pairs=batch.n_pairs, **row)
    names = [n for n, (k, _, _) in VARIANTS.items() if k == "root_mask" and n in libs]
    fns = {"package": _k22_with(_build.substruct_gpu_lib(), k22_args)}
    fns.update({n: _k22_with(libs[n], k22_args) for n in names})
    want = fns["package"]().clone()
    equal = {n: bool(torch.equal(fn(), want)) for n, fn in fns.items()}
    times = _turns(smoke, fns, reps, flush)
    emit(result="k22_variants", pairs=k22_args[0].shape[0],
         **{n: {**times[n], "equal_to_package": equal[n]} for n in fns})
