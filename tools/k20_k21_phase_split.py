#!/usr/bin/env python3
"""Per-phase split of the substructure engine's uniquify (K20) and match
extraction (K21) on one NVIDIA GPU, beside their first designs.

    python3 tools/k20_k21_phase_split.py [--first-only] [--reps N] [--variants]

Records the K20 launches of a uniquify search and the K21 launches of a
matches search over ``chip_smoke.py``'s substructure targets
(``benchmarks/_common.make_druglike_smiles(8192)`` in a ``SubstructLibrary``,
the 8 queries of ``benchmarks/substruct_bench.py``) and takes the largest of
each as ``chip_smoke.py`` picks it: K20's by rows in, K21's by elements out
(benzene over the 64-atom bucket for both).

Then per launch, in turns (first, package, package, first), the median of
CUDA-event times over ``--reps`` launches (behind a sleep kernel), hot (back
to back) and cold (after a 256 MB write):

* ``first``: the first design, ``tools/k20_k21_first_design.cu`` (built here
  with nvcc): K20 a block of 256 threads per pair with a device scratch of
  row masks; K21 a thread per output element with a binary search over the
  exclusive offsets;
* ``package``: ``ops/substruct_kernels.dedup`` (K20) and K21's raw launch
  ``substruct_kernels._launch_extract`` on offsets made once before; beside
  it the whole ``extract`` call (the offsets' cumsum included) and the
  first design's call with its offsets (cast, clamp, cumsum, zeros, cat).

One more launch of each first design with its phase clocks (K20: thread 0
of each block; K21: lane 0 of each warp): per phase the mean, its share and
that share of the clocked run's time (``chip_smoke.phase_split``).
Registers, spilled bytes, blocks an SM and shared bytes of every kernel;
the rows a pair (mean, p99, max; in, kept, surviving uniquify); an empty
kernel's time at each design's grid and at one block (the floor a launch
cannot go under), beside the bound (``chip_smoke.k20_work`` /
``k21_work``). Each package result is held bit for bit against the first
design's and the plain version's (valid rows and counts). ``--variants``
also times the variants of ``tools/k20_k21_variants.py`` (the package's
source with textual changes) in turns with the package's kernels. One JSON line per result; the card's name and power
limit first. Imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

K20_PHASES = ("keys", "compare", "scan", "copy")
K21_PHASES = ("search", "index", "copy")
THREADS = 256  # the first designs' block


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def first_lib():
    from nvmolkit_tpu_torch import _build

    src = ROOT / "tools" / "k20_k21_first_design.cu"
    lib = ctypes.CDLL(str(_build._build("libk20_k21_first", src, _build._nvcc_cmd(src))))
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.first_dedup.restype = ci
    lib.first_dedup.argtypes = [vp, vp, ci, ci, ci, ci, vp, vp, vp, vp, vp]
    lib.first_extract.restype = ci
    lib.first_extract.argtypes = [vp, vp, vp, ci, ci, ci, cll, vp, vp, vp]
    lib.first_empty.restype = ci
    lib.first_empty.argtypes = [ci, ci, vp]
    lib.first_k20_k21_info.restype = ci
    lib.first_k20_k21_info.argtypes = [ctypes.POINTER(ci)]
    return lib


def first_info(lib) -> dict:
    out = (ctypes.c_int * 8)()
    rc = lib.first_k20_k21_info(out)
    if rc != 0:
        raise RuntimeError(f"first_k20_k21_info failed with CUDA error {rc}")
    keys = ("registers", "local_bytes", "blocks_per_sm", "shared_bytes")
    return {"dedup": dict(zip(keys, out[0:4]), threads=THREADS, layout="block of 256 per pair"),
            "extract": dict(zip(keys, out[4:8]), threads=THREADS,
                            layout="thread per output element")}


def _stream():
    import torch

    return torch.cuda.current_stream().cuda_stream


def first_dedup(lib, frontier, counts, T: int, cycles: bool = False):
    """K20's first design: (frontier', counts', cycles or None)."""
    import torch

    B, P, nq = frontier.shape
    W64 = -(-T // 64)
    keys = torch.empty((B, P, W64), dtype=torch.int64, device=frontier.device)
    out = torch.empty_like(frontier)
    new_counts = torch.empty_like(counts)
    cyc = (torch.zeros((B, len(K20_PHASES)), dtype=torch.int64, device=frontier.device)
           if cycles else None)
    rc = lib.first_dedup(frontier.data_ptr(), counts.data_ptr(), B, nq, P, W64, keys.data_ptr(),
                         out.data_ptr(), new_counts.data_ptr(),
                         None if cyc is None else cyc.data_ptr(), _stream())
    if rc != 0:
        raise RuntimeError(f"first_dedup failed with CUDA error {rc}")
    return out, new_counts, cyc


def first_offsets(counts, max_matches: int):
    """int64 [B + 1]: the first design's exclusive offsets of the kept rows."""
    import torch

    kept = counts.long().clamp(max=max_matches)
    return torch.cat([kept.new_zeros(1), torch.cumsum(kept, dim=0)])


def first_extract(lib, frontier, offsets, perm, n_rows: int, cycles: bool = False):
    """K21's first design on exclusive ``offsets``: (rows int32 [n_rows, nq],
    cycles or None)."""
    import torch

    B, P, nq = frontier.shape
    n_out = n_rows * nq
    out = torch.empty((n_rows, nq), dtype=torch.int32, device=frontier.device)
    cyc = (torch.zeros((-(-n_out // 32), len(K21_PHASES)), dtype=torch.int64,
                       device=frontier.device) if cycles else None)
    if n_out:
        rc = lib.first_extract(frontier.data_ptr(), offsets.data_ptr(), perm.data_ptr(), B, nq, P,
                               n_out, out.data_ptr(), None if cyc is None else cyc.data_ptr(),
                               _stream())
        if rc != 0:
            raise RuntimeError(f"first_extract failed with CUDA error {rc}")
    return out, cyc


def record(fn, names):
    """The arguments of the ``sk`` wrappers ``names`` while ``fn`` runs."""
    from nvmolkit_tpu_torch.ops import substruct_kernels as sk

    seen = {name: [] for name in names}
    originals = {name: getattr(sk, name) for name in names}

    def recording(name):
        def call(*args):
            out = originals[name](*args)
            seen[name].append((args, out))
            return out
        return call

    for name in names:
        setattr(sk, name, recording(name))
    try:
        fn()
    finally:
        for name, f in originals.items():
            setattr(sk, name, f)
    return seen


def launches(smoke) -> dict:
    """The largest K20 launch of the uniquify search and the largest K21
    launch of the matches search, as ``chip_smoke.py`` picks them."""
    from nvmolkit_tpu_torch import substructure as sub_api
    from nvmolkit_tpu_torch.chem.native import mols_from_smiles

    mols = mols_from_smiles(smoke.load_by_path("benchmarks/_common.py").make_druglike_smiles(
        smoke.SUB_TARGETS))
    queries = list(smoke.load_by_path("benchmarks/substruct_bench.py").QUERIES)
    lib = sub_api.SubstructLibrary(mols)
    matches = record(lambda: sub_api.getSubstructMatches(lib, queries,
                                                         sub_api.SubstructSearchConfig()),
                     ("extract",))["extract"]
    uniq = record(lambda: sub_api.getSubstructMatches(
        lib, queries, sub_api.SubstructSearchConfig(uniquify=True)), ("dedup",))["dedup"]
    return {"dedup": max(uniq, key=lambda ao: int(ao[0][1].sum()))[0],
            "extract": max(matches, key=lambda ao: ao[1].numel())[0],
            "dedup_launches": len(uniq), "extract_launches": len(matches)}


def distribution(x) -> dict:
    import torch

    x = x.double()
    live = x[x > 0]
    return {"pairs": int(x.numel()), "pairs_nonzero": int(live.numel()), "sum": float(x.sum()),
            "mean": float(x.mean()) if x.numel() else 0.0,
            "mean_nonzero": float(live.mean()) if live.numel() else 0.0,
            "p99": float(torch.quantile(x, 0.99)) if x.numel() else 0.0,
            "max": float(x.max()) if x.numel() else 0.0}


def empty_ms(smoke, lib, blocks: int, threads: int, reps: int, flush=None) -> float:
    def launch():
        rc = lib.first_empty(blocks, threads, _stream())
        if rc != 0:
            raise RuntimeError(f"first_empty failed with CUDA error {rc}")
    return smoke.median_ms(launch, reps, flush=flush)


def clocked(fn, flush):
    """One clocked launch after a warm-up: (output, its CUDA-event ms)."""
    import torch

    fn()  # warm: the cycle buffer's allocation and fill kernel
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    flush.zero_()
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def timed_runs(smoke, fns: dict, order: list, reps: int, flush) -> dict:
    """Hot and cold medians of each of ``fns`` in the turns ``order``."""
    runs = {k: {"hot": [], "cold": []} for k in fns}
    for k in order:
        runs[k]["hot"].append(smoke.median_ms(fns[k], reps))
        runs[k]["cold"].append(smoke.median_ms(fns[k], reps, flush=flush))
    return {k: {"ms": statistics.median(v["hot"]), "ms_runs": v["hot"],
                "cold_ms": statistics.median(v["cold"]), "cold_ms_runs": v["cold"]}
            for k, v in runs.items()}


def k20_results(smoke, lib, args, rates, reps, flush, first_only) -> None:
    import torch

    from nvmolkit_tpu_torch.ops import substruct_kernels as sk

    frontier, counts, T = args
    B, P, nq = frontier.shape
    cuda = frontier.device
    pf, pc = sk.dedup_plain(frontier, counts, T)
    ff, fc, _ = first_dedup(lib, frontier, counts, T)
    valid = torch.arange(P, device=cuda)[None, :] < pc[:, None]
    first_equal = bool(torch.equal(fc, pc) and torch.equal(ff[valid], pf[valid]))
    fns = {"first": lambda: first_dedup(lib, frontier, counts, T)}
    if not first_only:
        fns["package"] = lambda: sk.dedup(frontier, counts, T)
    order = list(fns) + list(fns)[::-1]
    times = timed_runs(smoke, fns, order, reps, flush)
    (_, _, cyc), ms = clocked(lambda: first_dedup(lib, frontier, counts, T, True), flush)
    row = {"launch": "dedup", "pairs": B, "P": P, "nq": nq, "T": T,
           "rows_in": distribution(counts), "rows_kept": distribution(pc),
           **smoke.k20_work(frontier, counts, pc, T, rates),
           "empty_kernel_ms": {"first_grid": empty_ms(smoke, lib, B, THREADS, reps),
                               "one_block": empty_ms(smoke, lib, 1, 32, reps)},
           "first": {**times["first"], **first_info(lib)["dedup"], "equal_to_plain": first_equal,
                     "clocked_ms": ms,
                     "phase_split": smoke.phase_split(cyc.cpu(), K20_PHASES, ms)}}
    if not first_only:
        info = sk.dedup_extract_info(B)["dedup"]
        df, dc = sk.dedup(frontier, counts, T)
        row["empty_kernel_ms"]["package_grid"] = empty_ms(smoke, lib, info["grid"],
                                                          info["threads"], reps)
        row["package"] = {**times["package"], **info,
                          "equal_to_plain": bool(torch.equal(dc, pc)
                                                 and torch.equal(df[valid], pf[valid])),
                          "equal_to_first": bool(torch.equal(dc, fc)
                                                 and torch.equal(df[valid], ff[valid]))}
    emit(result="k20", **row)


def k21_results(smoke, lib, args, rates, reps, flush, first_only) -> None:
    import torch

    from nvmolkit_tpu_torch.ops import substruct_kernels as sk

    frontier, counts, perm, max_matches = args[:4]
    B, P, nq = frontier.shape
    offs = first_offsets(counts, max_matches)
    n_rows = int(offs[-1])
    want = sk.extract_plain(frontier, counts, perm, max_matches)
    got, _ = first_extract(lib, frontier, offs, perm, n_rows)
    fns = {"first": lambda: first_extract(lib, frontier, offs, perm, n_rows)}
    if not first_only:
        incl = sk.kept_offsets(counts, max_matches, P)
        fns["package"] = lambda: sk._launch_extract(frontier, counts, perm, max_matches, incl,
                                                    n_rows)
        fns["package_call"] = lambda: sk.extract(frontier, counts, perm, max_matches, n_rows)
        fns["first_call"] = lambda: first_extract(lib, frontier, first_offsets(counts, max_matches),
                                                  perm, n_rows)
    order = list(fns) + list(fns)[::-1]
    times = timed_runs(smoke, fns, order, reps, flush)
    (_, cyc), ms = clocked(lambda: first_extract(lib, frontier, offs, perm, n_rows, True), flush)
    n_out = n_rows * nq
    row = {"launch": "extract", "pairs": B, "P": P, "nq": nq, "max_matches": max_matches,
           "rows": n_rows, "elements": n_out,
           "rows_kept": distribution(counts.clamp(max=max_matches)),
           **smoke.k21_work(counts, nq, max_matches, rates),
           "empty_kernel_ms": {"first_grid": empty_ms(smoke, lib, -(-n_out // THREADS), THREADS,
                                                      reps),
                               "one_block": empty_ms(smoke, lib, 1, 32, reps)},
           "first": {**times["first"], **first_info(lib)["extract"],
                     "equal_to_plain": bool(torch.equal(got, want)), "clocked_ms": ms,
                     "phase_split": smoke.phase_split(cyc.cpu(), K21_PHASES, ms)}}
    if not first_only:
        info = sk.dedup_extract_info(B)["extract"]
        pk = sk._launch_extract(frontier, counts, perm, max_matches, incl, n_rows)
        row["empty_kernel_ms"]["package_grid"] = empty_ms(smoke, lib, info["grid"],
                                                          info["threads"], reps)
        row["package"] = {**times["package"], **info, "equal_to_plain": bool(torch.equal(pk, want)),
                          "equal_to_first": bool(torch.equal(pk, got))}
        row["package_call"], row["first_call"] = times["package_call"], times["first_call"]
    emit(result="k21", **row)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k20_k21_phase_split: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke

    args = sys.argv[1:]
    first_only = "--first-only" in args
    reps = int(args[args.index("--reps") + 1]) if "--reps" in args else 20
    cuda = torch.device("cuda", 0)
    rates = smoke.card_rates()
    emit(device=torch.cuda.get_device_name(0), nvidia_smi=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60).stdout.strip(), rates=rates)
    lib = first_lib()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=cuda)
    rec = launches(smoke)
    emit(result="launches", dedup=rec["dedup_launches"], extract=rec["extract_launches"])
    k20_results(smoke, lib, rec["dedup"], rates, reps, flush, first_only)
    k21_results(smoke, lib, rec["extract"], rates, reps, flush, first_only)
    if "--variants" in args:
        variants = smoke.load_by_path("tools/k20_k21_variants.py")
        variants.run(smoke, rec, rates, reps, flush, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
