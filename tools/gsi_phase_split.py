#!/usr/bin/env python3
"""Per-phase split of the substructure join K19 on one NVIDIA GPU.

    python3 tools/gsi_phase_split.py [--first-only] [--reps N]

Records the K19 launches of three searches over ``chip_smoke.py``'s
substructure targets (``benchmarks/_common.make_druglike_smiles(8192)`` in a
``SubstructLibrary``) and takes one launch of each:

* ``counts``: the counts screen (bench.py's 8 queries), its largest launch
  (pairs x query atoms; benzene over the 64-atom bucket);
* ``nq8``: a screen of ``LONG_QUERY`` (9 atoms), its largest launch;
* ``recursive``: the recursive screen on a new library, its largest launch
  (a ``$(...)`` sub-pattern over the whole bucket).

Then, per launch, in turns (first, package, package, first), each a median
of CUDA-event times over ``--reps`` launches (behind a sleep kernel, and
after a 256 MB write: cold in L2, as the search meets it):

* ``first``: the first design, ``tools/gsi_first_design.cu`` (built here
  with nvcc), a block of 256 threads per pair, every (row, target atom)
  cell of a level tested, a two-barrier block scan per chunk of cells;
* ``package``: ``ops/substruct_kernels.gsi_join`` (K19).

Then, after a warm-up, one more launch of each with its per-phase cycles (clock64(), thread
or lane 0 of each pair; ``substruct_kernels.K19_PHASES``): per phase the
mean over pairs, its share and that share of the instrumented run's time
(``chip_smoke.phase_split``); registers, pairs resident an SM; and the tail
as in ``tools/coordgen_phase_split.py``. Also per launch, from the plain
version: the rows per level (mean and max over the pairs that reach it),
the cells each design tests (every (row, atom) cell; each row's neighbours
of its back-edge atom of fewest neighbours) and the cells kept. Each
package run is held bit for bit against the first design. One JSON line per
result; the card's name and power limit first.
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

PHASES = ("level0", "tests", "scan", "writes")
LONG_QUERY = "c1ccccc1C(=O)N"  # 9 atoms: the aryl amide of the targets' linkers


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def first_lib():
    from nvmolkit_tpu_torch import _build

    src = ROOT / "tools" / "gsi_first_design.cu"
    lib = ctypes.CDLL(str(_build._build("libgsi_first", src, _build._nvcc_cmd(src))))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.first_gsi_join.restype = ci
    lib.first_gsi_join.argtypes = [vp] * 5 + [ci] * 6 + [vp] * 6
    lib.first_gsi_info.restype = ci
    lib.first_gsi_info.argtypes = [ctypes.POINTER(ci)]
    return lib


def first_info(lib) -> dict:
    out = (ctypes.c_int * 4)()
    rc = lib.first_gsi_info(out)
    if rc != 0:
        raise RuntimeError(f"first_gsi_info failed with CUDA error {rc}")
    return {"registers": out[0], "local_bytes": out[1], "blocks_per_sm": out[2],
            "pairs_per_block": 1, "pairs_per_sm": out[2], "shared_bytes": out[3],
            "layout": "block of 256 per pair (first design)"}


def first_call(lib, args, cycles: bool):
    """The first design on one recorded launch: (frontier, counts,
    overflow, cycles or None)."""
    import torch

    words, adj, rows, back_slot, back_mask, P = args[:6]
    dev = words.device
    bs = back_slot.to(dev, torch.int32).contiguous()
    bm = back_mask.to(dev, torch.int32).contiguous()
    N, nq, W = words.shape
    T, E, B = adj.shape[1], bs.shape[1], rows.shape[0]
    out = torch.empty((B, P, nq), dtype=torch.int16, device=dev)
    scratch = torch.empty_like(out)
    counts = torch.empty(B, dtype=torch.int32, device=dev)
    overflow = torch.empty(B, dtype=torch.bool, device=dev)
    cyc = torch.zeros((B, len(PHASES)), dtype=torch.int64, device=dev) if cycles else None
    rc = lib.first_gsi_join(words.data_ptr(), adj.data_ptr(), rows.data_ptr(), bs.data_ptr(),
                            bm.data_ptr(), B, nq, T, W, E, P, out.data_ptr(), scratch.data_ptr(),
                            counts.data_ptr(), overflow.data_ptr(),
                            None if cyc is None else cyc.data_ptr(),
                            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"first_gsi_join failed with CUDA error {rc}")
    return out, counts, overflow, cyc


def record(fn):
    """The K19 launches' arguments while ``fn`` runs."""
    from nvmolkit_tpu_torch.ops import substruct_kernels as sk

    seen, original = [], sk.gsi_join

    def recording(*args):
        seen.append(args)
        return original(*args)

    sk.gsi_join = recording
    try:
        fn()
    finally:
        sk.gsi_join = original
    return seen


def launches(smoke, cuda) -> dict:
    from nvmolkit_tpu_torch import substructure as sub_api
    from nvmolkit_tpu_torch.chem.native import mols_from_smiles

    mols = mols_from_smiles(smoke.load_by_path("benchmarks/_common.py").make_druglike_smiles(
        smoke.SUB_TARGETS))
    queries = list(smoke.load_by_path("benchmarks/substruct_bench.py").QUERIES)
    cfg = sub_api.SubstructSearchConfig()
    lib = sub_api.SubstructLibrary(mols)

    def largest(seen, key):
        return max(seen, key=key)

    size = lambda a: a[2].shape[0] * a[0].shape[1]  # noqa: E731 (pairs x query atoms)
    counts = record(lambda: sub_api.countSubstructMatches(lib, queries, cfg))
    long = record(lambda: sub_api.countSubstructMatches(lib, [LONG_QUERY], cfg))
    rec = record(lambda: sub_api.countSubstructMatches(sub_api.SubstructLibrary(mols),
                                                       smoke.SUB_REC_QUERIES, cfg))
    return {"counts": largest(counts, size),
            "nq8": largest([a for a in long if a[0].shape[1] >= 8], size),
            "recursive": largest(rec, lambda a: a[2].shape[0])}


def level_stats(args) -> dict:
    """Rows per level, cells tested by each design and cells kept, from the
    plain version over the query's first i + 1 slots."""
    import torch

    from nvmolkit_tpu_torch.ops import substruct_kernels as sk

    words, adj, rows, back_slot, back_mask, P = args[:6]
    B, nq, T = rows.shape[0], words.shape[1], adj.shape[1]
    dev = words.device
    deg = (adj != 0).sum(dim=2)                                       # [N, T]
    rows_l, slots = rows.long(), back_slot.tolist()
    levels, dense, walked, kept = [], 0, 0, 0
    prev = None
    for i in range(nq):
        f, n, _ = sk.gsi_join_plain(words[:, :i + 1], adj, rows, back_slot[:i + 1],
                                    back_mask[:i + 1], P)
        reach = n[n > 0].double()
        levels.append({"level": i, "pairs": int(reach.numel()),
                       "rows_mean": float(reach.mean()) if reach.numel() else 0.0,
                       "rows_max": int(reach.max()) if reach.numel() else 0})
        if i == 0:
            dense += B * T
            walked += B * T
        else:
            pf, pn = prev
            valid = torch.arange(P, device=dev)[None, :] < pn[:, None]
            live = [s for s in slots[i] if s >= 0]
            atoms = pf[:, :, live].long().clamp(min=0)                # [B, P, edges]
            d = deg[rows_l[:, None, None], atoms].amin(dim=2)           # [B, P]
            dense += int(valid.sum()) * T
            walked += int((d * valid).sum())
        kept += int(n.sum())
        prev = (f, n)
    return {"levels": levels, "cells_tested_first": dense, "cells_tested_lists": walked,
            "cells_kept": kept}


def split(cycles, ms: float, info: dict, rates: dict) -> dict:
    import chip_smoke as smoke

    per_pair = cycles.sum(dim=1).double()
    clock_hz = rates["max_sm_clock_mhz"] * 1e6
    packed_ms = float(per_pair.sum()) / (rates["sms"] * info["pairs_per_sm"]) / clock_hz * 1e3
    return {"instrumented_ms": ms, "phase_split": smoke.phase_split(cycles, PHASES, ms),
            "tail_ms": ms - packed_ms, "tail_share": (ms - packed_ms) / ms,
            "longest_pair_ms": float(per_pair.max()) / clock_hz * 1e3}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gsi_phase_split: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from nvmolkit_tpu_torch.ops import substruct_kernels as sk

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
    for name, a in launches(smoke, cuda).items():
        P = a[5]
        first = first_call(lib, a, False)
        row = {"launch": name, "pairs": int(a[2].shape[0]), "nq": int(a[0].shape[1]),
               "T": int(a[1].shape[1]), "P": P, **level_stats(a)}
        runs = {"first": [], "package": []}
        order = ["first", "first"] if first_only else ["first", "package", "package", "first"]
        for who in order:
            fn = ((lambda: first_call(lib, a, False)) if who == "first"
                  else (lambda: sk.gsi_join(*a)))
            runs[who].append(smoke.median_ms(fn, reps, flush=flush))
        for who in ("first",) if first_only else ("first", "package"):

            def clocked(who=who):
                return (first_call(lib, a, True) if who == "first"
                        else sk._launch_gsi(*a, phase_cycles=True))

            clocked()  # warm: the cycle buffer's allocation and fill kernel
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            flush.zero_()
            torch.cuda.synchronize()
            start.record()
            out = clocked()
            stop.record()
            torch.cuda.synchronize()
            info = first_info(lib) if who == "first" else sk.gsi_info()
            extra = {}
            if who == "package":
                f, c, o = out[:3]
                valid = torch.arange(P, device=cuda)[None, :] < c[:, None]
                extra["equal_to_first"] = bool(torch.equal(c, first[1]) and torch.equal(o, first[2])
                                               and torch.equal(f[valid], first[0][valid]))
            emit(result=who, **row, ms_runs=runs[who], ms=statistics.median(runs[who]), **info,
                 **split(out[3].cpu(), start.elapsed_time(stop), info, rates), **extra)
    return 0


if __name__ == "__main__":
    sys.exit(main())
