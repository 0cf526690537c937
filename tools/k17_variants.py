"""Variants of K17, timed in turns with the package's kernel.

Run through ``python3 tools/k17_phase_split.py --variants`` (one card). Each
textual variant is the package's ``nvmolkit_tpu_torch/csrc/tfd.cu`` with the
changes listed in ``VARIANTS``, written under the package's gitignored build
directory and built with nvcc (all at once); its ``nvmk_dihedral_angles``
(the package's C ABI) runs on the phase split's inputs. Each ``items_N``
runs the package's kernel on a block table cut at N work items a block
(``ops/tfd.conformer_blocks(..., items=N)``). Every variant is held
against the package's output (equal bit for bit, or not) and timed hot and
cold (``chip_smoke.median_ms``) in turns: package, each variant, then the
same backwards. ``clocked`` adds clock64() laps of thread 0 of each block
(setup: the block's table row and starts; staging: the quartets and rows,
to the barrier; items: the work items, to a closing barrier) and prints
their split (``chip_smoke.phase_split``). A ``probe_`` variant leaves out
part of the work to time what is left: its output differs by design.
"""
from __future__ import annotations

import ctypes
import statistics
from concurrent.futures import ThreadPoolExecutor

K17_CLOCK_PHASES = ("setup", "staging", "items")
ITEMS = (256, 512, 1024, 2048)
_LAP = ("{ if (threadIdx.x == 0) { const long long n_ = clock64(); clk_acc[%d] += n_ - clk_t; "
        "clk_t = n_; } }")
_LOOP = "  for (int i = threadIdx.x; i < n_items; i += THREADS) {"
_ITEM = """    dst[i] = dihedral(load3(x + 3 * a.x), load3(x + 3 * a.y), load3(x + 3 * a.z),
                      load3(x + 3 * a.w));
"""
_CLOCKED = [
    ("  extern __shared__ int4 s_quartets[];\n",
     "  extern __shared__ int4 s_quartets[];\n"
     "  long long clk_t = clock64(), clk_acc[3] = {0, 0, 0};\n"),
    ("  int64_t* s_rows = ",
     "  {volatile int64_t v_ = q_first + start[1] + start[2] + n_c; (void)v_;}\n  "
     + _LAP % 0 + "\n  int64_t* s_rows = "),
    ("  __syncthreads();\n  // work item i",
     "  __syncthreads();\n  " + _LAP % 1 + "\n  // work item i"),
    ("      ++c;\n    }\n  }\n}\n",
     "      ++c;\n    }\n  }\n  __syncthreads();\n  " + _LAP % 2 + "\n"
     "  if (threadIdx.x == 0 && g_k17_cycles != nullptr)\n"
     "    for (int p = 0; p < 3; ++p) g_k17_cycles[(size_t)blockIdx.x * 3 + p] = clk_acc[p];\n"
     "}\n"),
    ("__global__ void __launch_bounds__(THREADS)\ndihedral_kernel(",
     "__device__ long long* g_k17_cycles = nullptr;\n\n"
     "__global__ void __launch_bounds__(THREADS)\ndihedral_kernel("),
    ('}  // extern "C"', 'int k17_set_cycles(void* p) {\n'
     '  return (int)cudaMemcpyToSymbol(g_k17_cycles, &p, sizeof(p));\n}\n\n}  // extern "C"'),
]

_KERNEL_HEAD = """  // 16 n_q + 8 n_c bytes: the molecule's quartets, then the block's rows
  extern __shared__ int4 s_quartets[];
  const int4 blk = blocks[blockIdx.x];
  const int n_c = blk.z, n_q = blk.w;
"""
_STAGING = """  int64_t* s_rows = reinterpret_cast<int64_t*>(s_quartets + n_q);
  for (int q = threadIdx.x; q < n_q; q += THREADS)
    copy_async16(s_quartets + q, quartets + q_first + q);
  for (int j = threadIdx.x; j < n_c; j += THREADS) copy_async8(s_rows + j, rows + j);
"""
# the atoms staged in shared memory: each warp's conformers' rows read at
# once (a lane each), every atom copied (cp.async, a float4 slot each), the
# items reading them by ld.shared; its tables carry each block's span (the
# largest atom its molecule's quartets name, plus one) in column 0
_STAGED = [
    (_KERNEL_HEAD, """  // 16 n_q + 16 n_c span bytes: the molecule's quartets, then the atoms
  extern __shared__ int4 s_quartets[];
  const int4 blk = blocks[blockIdx.x];
  const int span = blk.x, n_c = blk.z, n_q = blk.w;
"""),
    (_STAGING, """  float4* s_atoms = reinterpret_cast<float4*>(s_quartets + n_q);
  for (int q = threadIdx.x; q < n_q; q += THREADS)
    copy_async16(s_quartets + q, quartets + q_first + q);
  {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    constexpr int W = THREADS / 32;
    for (int base = warp; base < n_c; base += 32 * W) {
      const int64_t row = base + W * lane < n_c ? 3 * rows[base + W * lane] : 0;
      for (int u = 0; u < 32 && base + W * u < n_c; ++u) {
        const float* src = coords + __shfl_sync(0xffffffffu, row, u);
        float* slots = reinterpret_cast<float*>(s_atoms + (base + W * u) * span);
        for (int k = lane; k < 3 * span; k += 32)
          copy_async4(slots + k / 3 * 4 + k % 3, src + k);
      }
    }
  }
"""),
    ("    const float* x = coords + 3 * s_rows[c];\n" + _ITEM,
     "    const float4* x = s_atoms + c * span;\n"
     "    dst[i] = dihedral(xyz(x[a.x]), xyz(x[a.y]), xyz(x[a.z]), xyz(x[a.w]));\n"),
    ("__device__ __forceinline__ V3 sub(",
     "__device__ __forceinline__ V3 xyz(float4 p) { return {p.x, p.y, p.z}; }\n\n"
     "__device__ __forceinline__ V3 sub("),
    ("__device__ __forceinline__ void copy_async8(",
     "__device__ __forceinline__ void copy_async4(void* dst, const void* src) {\n"
     "  asm volatile(\"cp.async.ca.shared.global [%0], [%1], 4;\\n\" ::\n"
     "               \"r\"((unsigned)__cvta_generic_to_shared(dst)), \"l\"(src) : \"memory\");\n"
     "}\n\n__device__ __forceinline__ void copy_async8("),
]
# variants that run on tables of their own: name -> (work items a block or
# None for the package's, spans in column 0)
TABLES = {"staged_atoms": (None, True), "staged_atoms_items_512": (512, True),
          "staged_atoms_items_2048": (2048, True)}

# name -> [(old, new), ...] applied to the package's source
VARIANTS = {
    "staged_atoms": _STAGED,
    "staged_atoms_items_512": _STAGED,
    "staged_atoms_items_2048": _STAGED,
    "clocked": _CLOCKED,
    "threads_128": [("constexpr int THREADS = 256;", "constexpr int THREADS = 128;")],
    "threads_512": [("constexpr int THREADS = 256;", "constexpr int THREADS = 512;")],
    "min_8_blocks": [("__launch_bounds__(THREADS)\ndihedral_kernel(",
                      "__launch_bounds__(THREADS, 8)\ndihedral_kernel(")],
    "unroll_2": [(_LOOP, "#pragma unroll 2\n" + _LOOP)],
    # the first design's guard, by the normals' square roots (the same bits)
    "guard_roots": [("  if (dot(n1, n1) < 1e-20f || dot(n2, n2) < 1e-20f) deg = 0.0f;\n",
                     "  if (norm(n1) < 1e-10f || norm(n2) < 1e-10f) deg = 0.0f;\n")],
    # probes: the items without the arithmetic (a sum of two coordinates
    # stored), and no items at all (the setup and the staging)
    "probe_no_arithmetic": [
        (_ITEM, "    dst[i] = __fadd_rn(__ldg(x + 3 * a.x), __ldg(x + 3 * a.w + 2));\n")],
    "probe_no_items": [(_LOOP, "  for (int i = n_items; i < n_items; i += THREADS) {")],
}


def _build_variant(name: str, patches) -> ctypes.CDLL:
    from nvmolkit_tpu_torch import _build

    text = _build.TFD_SRC.read_text()
    for old, new in patches:
        if old not in text:
            raise RuntimeError(f"variant {name}: {old!r} is not in the package's source")
        text = text.replace(old, new)
    out_dir = _build.BUILD_DIR / "k17_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"{name}.cu"
    src.write_text(text)
    lib = ctypes.CDLL(str(_build._build(f"libk17_{name}", src, _build._nvcc_cmd(src))))
    _build._declare_tfd(lib)
    if name == "clocked":
        lib.k17_set_cycles.restype = ctypes.c_int
        lib.k17_set_cycles.argtypes = [ctypes.c_void_p]
    return lib


def blocks_at(batch, items: int | None, spans: bool = False):
    """K17's tables cut at ``items`` work items a block (None: the
    package's rule), on the batch's device: (blocks, starts, shared bytes);
    with ``spans``, each block's span in column 0 of its row and the shared
    bytes of its staged atoms (16 n_q + 16 n_c span)."""
    import numpy as np
    import torch

    from nvmolkit_tpu_torch.ops import tfd as tfd_ops

    off = batch.mol_offsets.cpu().numpy()
    q_first = batch.torsion_quartets.cpu().numpy()[off[tfd_ops.TORSIONS]]
    blocks = tfd_ops.conformer_blocks(np.diff(off[tfd_ops.CONFS]), np.diff(q_first), items)
    starts = tfd_ops.block_starts(blocks, off, q_first[:-1])
    nbytes = tfd_ops.k17_block_bytes(blocks)
    if spans:
        quartets = batch.quartets.cpu().numpy()
        span = np.maximum.reduceat(quartets.max(axis=1), q_first[:-1]) + 1
        blocks[:, 0] = span[blocks[:, 0]]
        nbytes = int((16 * (blocks[:, 3].astype(np.int64) + blocks[:, 2] * blocks[:, 0])).max())
    dev = batch.conformer_blocks.device
    return (torch.from_numpy(blocks).to(dev), torch.from_numpy(starts).to(dev), nbytes)


def _k17_with(lib, coords, batch, tables=None):
    import torch

    blocks, starts, nbytes = tables or (batch.conformer_blocks, batch.block_starts,
                                        batch.block_bytes)
    out = torch.empty(batch.n_angles, dtype=torch.float32, device=coords.device)

    def launch():
        rc = lib.nvmk_dihedral_angles(
            coords.data_ptr(), batch.conf_rows.data_ptr(), batch.quartets.data_ptr(),
            blocks.data_ptr(), starts.data_ptr(), blocks.shape[0], nbytes, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"nvmk_dihedral_angles failed with CUDA error {rc}")
        return out
    return launch, int(blocks.shape[0])


def _turns(smoke, fns: dict, reps: int, flush) -> dict:
    names = list(fns)
    runs = {n: {"hot": [], "cold": []} for n in names}
    for n in names + names[::-1]:
        runs[n]["hot"].append(smoke.median_ms(fns[n], reps))
        runs[n]["cold"].append(smoke.median_ms(fns[n], reps, flush=flush))
    return {n: {"ms": statistics.median(v["hot"]), "ms_runs": v["hot"],
                "cold_ms": statistics.median(v["cold"]), "cold_ms_runs": v["cold"]}
            for n, v in runs.items()}


def run(smoke, inputs, reps, flush, emit) -> None:
    import torch

    from nvmolkit_tpu_torch import _build

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        jobs = {name: pool.submit(_build_variant, name, patches)
                for name, patches in VARIANTS.items()}
        libs = {}
        for name, job in jobs.items():
            try:
                libs[name] = job.result()
            except RuntimeError as err:  # a variant that does not build is reported, not timed
                emit(result="variant_build_failed", variant=name, error=str(err)[-2000:])
    for label, coords, batch, _, _ in inputs:
        fns, grids = {}, {}
        fns["package"], grids["package"] = _k17_with(_build.tfd_lib(), coords, batch)
        for name in libs:
            tables = blocks_at(batch, *TABLES[name]) if name in TABLES else None
            fns[name], grids[name] = _k17_with(libs[name], coords, batch, tables)
        for items in ITEMS:
            fns[f"items_{items}"], grids[f"items_{items}"] = _k17_with(
                _build.tfd_lib(), coords, batch, blocks_at(batch, items))
        want = fns["package"]().clone()
        equal = {n: bool(torch.equal(fn(), want)) for n, fn in fns.items()}
        times = _turns(smoke, fns, reps, flush)
        row = {n: {**times[n], "equal_to_package": equal[n], "grid": grids[n]} for n in fns}
        if "clocked" in libs:
            cyc = torch.zeros((grids["clocked"], len(K17_CLOCK_PHASES)), dtype=torch.int64,
                              device=coords.device)
            libs["clocked"].k17_set_cycles(cyc.data_ptr())
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
            libs["clocked"].k17_set_cycles(None)
            row["clocked"]["clocked_ms"] = ms
            row["clocked"]["phase_split"] = smoke.phase_split(cyc.cpu(), K17_CLOCK_PHASES, ms)
        emit(result="k17_variants", input=label, angles=batch.n_angles, **row)
