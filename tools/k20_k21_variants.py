"""Variants of K20 and K21, timed in turns with the package's kernels.

Run through ``python3 tools/k20_k21_phase_split.py --variants`` (one card).
Each variant is the package's ``nvmolkit_tpu_torch/csrc/substruct.cu`` with
the textual changes listed in ``VARIANTS``, written under the package's
gitignored build directory and built with nvcc (all at once); its
``nvmk_dedup`` / ``nvmk_extract`` (the package's C ABI) run on the recorded
launches of the phase split, held bit for bit against the package's output,
and timed hot and cold (``chip_smoke.median_ms``) in turns: package, each
variant, then the same backwards. One JSON line per kernel, with each
variant's registers, blocks an SM and grid (``nvmk_dedup_extract_info``).
A ``probe_`` variant leaves out part of the work to time what is left: its
output differs by design.
"""
from __future__ import annotations

import ctypes
import pathlib
import statistics
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parent.parent

_DEDUP_BOUNDS = "__launch_bounds__(32 * DEDUP_WARPS, 64 / DEDUP_WARPS) dedup_kernel("
_GATHER = """    int r = r_lane, q = q_lane;
    for (int e = lane; e < n; e += 32) {
      dst[e] = src[r * nq + slot_of[q]];
      r += r_step;
      q += q_step;
      if (q >= nq) {
        q -= nq;
        ++r;
      }
    }
"""
# K21 with 4 gathers a lane in flight, then their stores
_GATHER_4 = """    int r = r_lane, q = q_lane;
    for (int e0 = lane; e0 < n; e0 += 4 * 32) {
      int v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (e0 + 32 * i < n) v[i] = src[r * nq + slot_of[q]];
        r += r_step;
        q += q_step;
        if (q >= nq) {
          q -= nq;
          ++r;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (e0 + 32 * i < n) dst[e0 + 32 * i] = v[i];
    }
"""
# K21 moving 32 / nq whole rows a step (nq <= 32): each lane loads the step's
# slot in frontier order (coalesced, its address free of perm), four steps'
# loads in flight, and takes its output's value from the lane holding it by a
# shuffle
_ROWS_BY_SHUFFLE = """    const int span = (32 / nq) * nq;
    const int from = lane / nq * nq + slot_of[lane % nq];
    if (nq > 32) {
""" + _GATHER + """    } else {
      for (int base = 0; base < n; base += 4 * span) {
        int w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = base + i * span + lane;
          w[i] = lane < span && e < n ? src[e] : 0;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int x = __shfl_sync(FULL_MASK, w[i], from);
          const int e = base + i * span + lane;
          if (lane < span && e < n) dst[e] = x;
        }
      }
    }
"""

# name -> (kernel, [(old, new), ...]) applied to the package's source
VARIANTS = {
    "dedup_16_bit_slots": ("dedup", [(
        "const bool words = nq % 2 == 0 && (uintptr_t)in % 4 == 0 && (uintptr_t)out % 4 == 0;",
        "const bool words = false;")]),
    "dedup_40_registers": ("dedup", [(_DEDUP_BOUNDS, "__launch_bounds__(32 * DEDUP_WARPS) "
                                                     "dedup_kernel(")]),
    "dedup_4_pairs_a_block": ("dedup", [("constexpr int DEDUP_WARPS = 8;",
                                         "constexpr int DEDUP_WARPS = 4;")]),
    "dedup_rows_before_the_count": ("dedup", [
        ("    for (int r0 = 0; r0 < n; r0 += 32) {\n", "    int r0 = 0;\n    do {\n"),
        ("      if (valid) {\n        if (WORDS)", "      if (r < P) {\n        if (WORDS)"),
        ("      __syncwarp();  // the survivors' masks are read by the next chunk\n    }\n",
         "      __syncwarp();\n      r0 += 32;\n    } while (r0 < n);\n")]),
    "probe_dedup_counts_only": ("dedup", [("for (int r0 = 0; r0 < n; r0 += 32) {",
                                           "for (int r0 = 0; r0 < 0; r0 += 32) {")]),
    "probe_dedup_no_copy": ("dedup", [("          for (int s = 0; s < nq / 2; ++s) dst[s] = src[s];\n",
                                       "")]),
    "extract_2_pairs_a_block": ("extract", [("constexpr int EXTRACT_WARPS = 4;",
                                             "constexpr int EXTRACT_WARPS = 2;")]),
    "extract_8_pairs_a_block": ("extract", [("constexpr int EXTRACT_WARPS = 4;",
                                             "constexpr int EXTRACT_WARPS = 8;")]),
    "extract_perm_from_global": ("extract", [
        ("  for (int q = threadIdx.x; q < nq; q += blockDim.x) slot_of[q] = perm[q];\n"
         "  __syncthreads();\n", ""),
        ("dst[e] = src[r * nq + slot_of[q]];", "dst[e] = src[r * nq + __ldg(perm + q)];")]),
    "extract_4_gathers_in_flight": ("extract", [(_GATHER, _GATHER_4)]),
    "extract_rows_by_shuffle": ("extract", [(_GATHER, _ROWS_BY_SHUFFLE)]),
    "probe_extract_no_gather": ("extract", [("dst[e] = src[r * nq + slot_of[q]];",
                                             "dst[e] = r;")]),
}


def _build_variant(name: str, patches) -> ctypes.CDLL:
    from nvmolkit_tpu_torch import _build

    text = _build.SUBSTRUCT_GPU_SRC.read_text()
    for old, new in patches:
        if old not in text:
            raise RuntimeError(f"variant {name}: {old!r} is not in the package's source")
        text = text.replace(old, new)
    out_dir = _build.BUILD_DIR / "k20_k21_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"{name}.cu"
    src.write_text(text)
    lib = ctypes.CDLL(str(_build._build(f"libk20_k21_{name}", src, _build._nvcc_cmd(src))))
    _build._declare_substruct_gpu(lib)
    return lib


def _info(lib, B: int, kernel: str) -> dict:
    out = (ctypes.c_int * 14)()
    rc = lib.nvmk_dedup_extract_info(B, out)
    if rc != 0:
        raise RuntimeError(f"nvmk_dedup_extract_info failed with CUDA error {rc}")
    keys = ("registers", "local_bytes", "blocks_per_sm", "shared_bytes", "pairs_per_block", "grid",
            "threads")
    return dict(zip(keys, out[0:7] if kernel == "dedup" else out[7:14]))


def run(smoke, rec, rates, reps, flush, emit) -> None:
    import torch

    from nvmolkit_tpu_torch import _build
    from nvmolkit_tpu_torch.ops import substruct_kernels as sk

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        jobs = {name: pool.submit(_build_variant, name, patches)
                for name, (_, patches) in VARIANTS.items()}
        libs = {}
        for name, job in jobs.items():
            try:
                libs[name] = job.result()
            except RuntimeError as err:  # a variant that does not build is reported, not timed
                emit(result="variant_build_failed", variant=name, error=str(err)[-2000:])
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    frontier, counts, T = rec["dedup"]
    B, P, nq = frontier.shape
    W64 = -(-T // 64)
    d_out, d_counts = torch.empty_like(frontier), torch.empty_like(counts)
    spill = torch.empty((B, P, W64), dtype=torch.int64, device=frontier.device)  # any layout's

    def dedup_with(lib):
        def launch():
            rc = lib.nvmk_dedup(frontier.data_ptr(), counts.data_ptr(), B, nq, P, W64,
                                spill.data_ptr(), d_out.data_ptr(), d_counts.data_ptr(), stream())
            if rc != 0:
                raise RuntimeError(f"nvmk_dedup failed with CUDA error {rc}")
            return d_out, d_counts
        return launch

    ef, ec, eperm, emm = rec["extract"][:4]
    eB, eP, enq = ef.shape
    ends = sk.kept_offsets(ec, emm, eP)
    n_rows = int(ends[-1])
    e_out = torch.empty((n_rows, enq), dtype=torch.int32, device=ef.device)

    def extract_with(lib):
        def launch():
            rc = lib.nvmk_extract(ef.data_ptr(), ec.data_ptr(), ends.data_ptr(), eperm.data_ptr(),
                                  eB, enq, eP, min(emm, eP), e_out.data_ptr(), stream())
            if rc != 0:
                raise RuntimeError(f"nvmk_extract failed with CUDA error {rc}")
            return e_out
        return launch

    package = _build.substruct_gpu_lib()
    for kernel, make, pairs, bound in (
            ("dedup", dedup_with, B, smoke.k20_work(frontier, counts, sk.dedup(frontier, counts,
                                                                               T)[1], T, rates)),
            ("extract", extract_with, eB, smoke.k21_work(ec, enq, emm, rates))):
        names = ["package"] + [n for n, (k, _) in VARIANTS.items() if k == kernel and n in libs]
        fns = {n: make(package if n == "package" else libs[n]) for n in names}
        want = [t.clone() for t in (lambda r: r if isinstance(r, tuple) else (r,))(fns["package"]())]
        equal = {}
        for n in names:
            got = fns[n]()
            got = got if isinstance(got, tuple) else (got,)
            if kernel == "dedup":
                valid = torch.arange(P, device=frontier.device)[None, :] < want[1][:, None]
                equal[n] = bool(torch.equal(got[1], want[1]) and torch.equal(got[0][valid],
                                                                              want[0][valid]))
            else:
                equal[n] = bool(torch.equal(got[0], want[0]))
        order = names + names[::-1]
        runs = {n: {"hot": [], "cold": []} for n in names}
        for n in order:
            runs[n]["hot"].append(smoke.median_ms(fns[n], reps))
            runs[n]["cold"].append(smoke.median_ms(fns[n], reps, flush=flush))
        emit(result=f"{kernel}_variants", pairs=pairs, bound_ms=bound["bound_ms"],
             **{n: {"ms": statistics.median(v["hot"]), "ms_runs": v["hot"],
                    "cold_ms_runs": v["cold"], "equal_to_package": equal[n],
                    **_info(package if n == "package" else libs[n], pairs, kernel)}
                for n, v in runs.items()})
