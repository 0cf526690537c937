#!/usr/bin/env python3
"""Per-phase split of the TFD pair kernel (K18) and the recursive-SMARTS
root masks (K22) on one NVIDIA GPU, beside their first designs.

    python3 tools/k18_k22_phase_split.py [--first-only] [--reps N] [--variants]

K18 at ``chip_smoke.py``'s TFD inputs: (c) 1,024 drug-like molecules with
hydrogens x 64 conformers, (b) one molecule x 2,000 conformers in 50
families, and bench.py's TFD configuration (``make_smiles(64)`` x 100
conformers of the port's ``EmbedMolecules``, read through ``positionsFrom``),
each on K17's angles. K22 at the substructure path's largest launch, as
``chip_smoke.py`` picks it: the K22 launch over the most pairs of the
counts screen and the recursive screen (``make_druglike_smiles(8192)`` in
a ``SubstructLibrary`` each).

Per launch, in turns (first, package, package, first), the median of
CUDA-event times over ``--reps`` launches (behind a sleep kernel), hot
(back to back) and cold (after a 256 MB write):

* ``first``: the first design, ``tools/k18_k22_first_design.cu`` (built
  here with nvcc): K18 a thread per condensed pair with a binary search
  over the molecules; K22 a thread per frontier row into an output zeroed
  once before (the kernel alone);
* ``package``: ``ops/tfd.tfd_pairs`` (K18) and K22's raw launch
  ``substruct_kernels._launch_root_mask`` into an output made once before;
  beside them K22's whole calls: ``substruct_kernels.root_mask``
  (allocation and kernel) and the first design's (``torch.zeros`` and
  kernel), and the ``torch.zeros`` fill alone.

One more launch of each first design with its phase clocks (lane 0 of each
warp): per phase the mean, its share and that share of the clocked run's
time (``chip_smoke.phase_split``). Registers, spilled bytes, blocks an SM
and shared bytes of every kernel; an empty kernel's time at each design's
grid and at one block (the floor a launch cannot go under); K18's two
bounds (``chip_smoke.k18_work``, per pair every torsion's work as the JAX
function does it, and ``k18_work_once``, each Ring torsion's mean once per
conformer), K22's (``k22_work``) and its rows a pair. Each package result
is held against the first design's and the plain version's (K18 within
``chip_smoke.K18_TOL``, K22 bit for bit). ``--variants`` also times the
variants of ``tools/k18_k22_variants.py`` (the package's sources with
textual changes) in turns with the package's kernels. One JSON line per
result; the card's name and power limit first. Imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

K18_PHASES = ("search", "index", "single", "ring", "symmetric", "store")
K22_PHASES = ("count", "row", "store")
THREADS = 256  # the first designs' block


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def first_lib():
    from nvmolkit_tpu_torch import _build

    src = ROOT / "tools" / "k18_k22_first_design.cu"
    lib = ctypes.CDLL(str(_build._build("libk18_k22_first", src, _build._nvcc_cmd(src))))
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.first_tfd_pairs.restype = ci
    lib.first_tfd_pairs.argtypes = [vp] * 6 + [ci, cll, vp, vp, vp]
    lib.first_root_mask.restype = ci
    lib.first_root_mask.argtypes = [vp, vp, ci, ci, ci, ci, ci, vp, vp, vp]
    lib.first_empty.restype = ci
    lib.first_empty.argtypes = [ci, ci, vp]
    lib.first_k18_k22_info.restype = ci
    lib.first_k18_k22_info.argtypes = [ctypes.POINTER(ci)]
    return lib


def first_info(lib) -> dict:
    out = (ctypes.c_int * 8)()
    rc = lib.first_k18_k22_info(out)
    if rc != 0:
        raise RuntimeError(f"first_k18_k22_info failed with CUDA error {rc}")
    keys = ("registers", "local_bytes", "blocks_per_sm", "shared_bytes")
    return {"tfd_pairs": dict(zip(keys, out[0:4]), threads=THREADS,
                          layout="thread per condensed pair"),
            "root_mask": dict(zip(keys, out[4:8]), threads=THREADS,
                          layout="thread per frontier row")}


def _stream():
    import torch

    return torch.cuda.current_stream().cuda_stream


def first_tfd_pairs(lib, angles, batch, cycles: bool = False):
    """K18's first design on K17's ``angles``: (the call's condensed buffer,
    cycles or None), the buffer zeroed first where a molecule has no
    torsions, as its wrapper did."""
    import torch

    out = torch.empty(batch.n_out, dtype=torch.float32, device=angles.device)
    if batch.n_pairs < batch.n_out:
        out.zero_()
    cyc = (torch.zeros((-(-batch.n_pairs // 32), len(K18_PHASES)), dtype=torch.int64,
                       device=angles.device) if cycles else None)
    if batch.n_pairs:
        rc = lib.first_tfd_pairs(
            angles.data_ptr(), batch.mol_offsets.data_ptr(), batch.torsion_quartets.data_ptr(),
            batch.types.data_ptr(), batch.weights.data_ptr(), batch.max_dev.data_ptr(),
            batch.n_mols, batch.n_pairs, out.data_ptr(),
            None if cyc is None else cyc.data_ptr(), _stream())
        if rc != 0:
            raise RuntimeError(f"first_tfd_pairs failed with CUDA error {rc}")
    return out, cyc


def first_root_mask_into(lib, frontier, counts, slot0: int, T: int, out, cycles=None) -> None:
    """K22's first design into ``out`` (bool [B, T], zeroed by the caller)."""
    B, P, nq = frontier.shape
    rc = lib.first_root_mask(frontier.data_ptr(), counts.data_ptr(), B, P, nq, slot0, T,
                             out.data_ptr(), None if cycles is None else cycles.data_ptr(),
                             _stream())
    if rc != 0:
        raise RuntimeError(f"first_root_mask failed with CUDA error {rc}")


def first_root_mask(lib, frontier, counts, slot0: int, T: int, cycles: bool = False):
    """K22's first design as its wrapper called it: (``torch.zeros`` [B, T]
    bool, then the kernel; cycles or None)."""
    import torch

    B, P, _ = frontier.shape
    out = torch.zeros((B, T), dtype=torch.bool, device=frontier.device)
    cyc = (torch.zeros((-(-B * P // 32), len(K22_PHASES)), dtype=torch.int64,
                       device=frontier.device) if cycles else None)
    if B:
        first_root_mask_into(lib, frontier, counts, slot0, T, out, cyc)
    return out, cyc


def empty_ms(smoke, lib, blocks: int, threads: int, reps: int) -> float:
    def launch():
        rc = lib.first_empty(blocks, threads, _stream())
        if rc != 0:
            raise RuntimeError(f"first_empty failed with CUDA error {rc}")
    return smoke.median_ms(launch, reps)


def clocked(fn, flush):
    """One clocked launch after a warm-up: (output, its CUDA-event ms)."""
    import torch

    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    flush.zero_()
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def timed_runs(smoke, fns: dict, reps: int, flush) -> dict:
    """Hot and cold medians of each of ``fns`` in turns (each, then each in
    reverse)."""
    order = list(fns) + list(fns)[::-1]
    runs = {k: {"hot": [], "cold": []} for k in fns}
    for k in order:
        runs[k]["hot"].append(smoke.median_ms(fns[k], reps))
        runs[k]["cold"].append(smoke.median_ms(fns[k], reps, flush=flush))
    return {k: {"ms": statistics.median(v["hot"]), "ms_runs": v["hot"],
                "cold_ms": statistics.median(v["cold"]), "cold_ms_runs": v["cold"]}
            for k, v in runs.items()}


def prebuild(first: dict) -> dict:
    """Every library the two paths run, one compiler each, started together."""
    import time

    from nvmolkit_tpu_torch import _build

    libs = {"tfd": _build.tfd_lib, "substruct_gpu": _build.substruct_gpu_lib,
            "substruct_host": _build.substruct_lib, "graph": _build.graph_lib,
            "bounds": _build.bounds_lib, "etk_match": _build.etk_lib,
            "triangle_smooth": _build.triangle_smooth_lib, "coordgen": _build.coordgen_lib,
            "dist_geom": _build.dist_geom_lib, "embed_checks": _build.embed_checks_lib,
            "etk": _build.etk_ff_lib, "mmff": _build.mmff_lib, "uff": _build.uff_lib,
            "k18_k22_first": lambda: first.setdefault("lib", first_lib())}

    def build(lib):
        t = time.perf_counter()
        lib()
        return time.perf_counter() - t

    with ThreadPoolExecutor(len(libs)) as pool:
        jobs = {k: pool.submit(build, lib) for k, lib in libs.items()}
        return {k: job.result() for k, job in jobs.items()}


def tfd_coords(smoke, cuda) -> list:
    """(label, coordinates, batch, torsion sets, conformer counts) of (c),
    (b) and bench.py's configuration, made as ``chip_smoke.py`` makes them:
    K17's inputs."""
    import numpy as np
    import torch

    from nvmolkit_tpu_torch import embedMolecules as embed_api
    from nvmolkit_tpu_torch import tfd as tfd_api
    from nvmolkit_tpu_torch.chem.native import mols_from_smiles
    from nvmolkit_tpu_torch.ops import tfd as tfd_ops
    from nvmolkit_tpu_torch.types import CoordinateOutput

    mols = mols_from_smiles(smoke.smoke_smiles())
    rng = np.random.default_rng(3)
    batch_mols = [m for m in mols if m.num_atoms >= 3][:smoke.RMSD_MOLS]
    for m in batch_mols:  # (a): drawn first, so that (c) and (b) get chip_smoke.py's draws
        for x in smoke.conformer_ensemble(rng, m.num_atoms, smoke.RMSD_CONFS):
            m.add_conformer(x)
    in_batch = {id(m) for m in batch_mols}
    big = next(m for m in mols if m.num_atoms >= 24 and id(m) not in in_batch)
    drug_mols = [smoke.with_hydrogens(m) for m in mols_from_smiles(smoke.random_smiles_batch(
        seed=11, n=smoke.RMSD_MOLS, min_heavy=smoke.DRUG_HEAVY[0],
        max_heavy=smoke.DRUG_HEAVY[1]))]
    for m in drug_mols:
        for x in smoke.conformer_ensemble(rng, m.num_atoms, smoke.RMSD_CONFS):
            m.add_conformer(x)
    for x in smoke.family_ensemble(rng, big.num_atoms):
        big.add_conformer(x)
    out = []
    for label, group in (("(c)", drug_mols), ("(b)", [big])):
        sets = [tfd_ops.enumerate_torsions(m) for m in group]
        coords, batch = tfd_api.conformer_batch(group, sets, cuda)
        out.append((label, coords, batch, sets, [len(m.conformers) for m in group]))
    bench_mols = mols_from_smiles(smoke.load_by_path("benchmarks/_common.py").make_smiles(64))
    dense = embed_api.EmbedMolecules(bench_mols, confsPerMolecule=100, maxIterations=8,
                                     output=CoordinateOutput.DEVICE, device=cuda)
    n_acc = dense.conf_mask.sum(dim=1).tolist()
    kept = [k for k, c in enumerate(n_acc) if c >= 2]
    sel = torch.tensor(kept, device=cuda)
    slots = [np.nonzero(r)[0] for r in dense.conf_mask[sel].cpu().numpy()]
    sets = [tfd_ops.enumerate_torsions(bench_mols[k]) for k in kept]
    coords, batch = tfd_api.positions_batch(dense.positions[sel].contiguous(), slots, sets, cuda)
    out.append(("bench", coords, batch, sets, [len(s) for s in slots]))
    return out


def tfd_inputs(smoke, cuda) -> list:
    """(label, angles, batch, torsion sets, conformer counts): K18's inputs,
    on K17's angles of :func:`tfd_coords`."""
    from nvmolkit_tpu_torch.ops import tfd as tfd_ops

    return [(label, tfd_ops.dihedral_angles(coords, batch), batch, sets, nc)
            for label, coords, batch, sets, nc in tfd_coords(smoke, cuda)]


def k18_results(smoke, lib, inputs, rates, reps, flush, first_only) -> None:
    import torch

    from nvmolkit_tpu_torch.ops import tfd as tfd_ops

    label, angles, batch, sets, n_confs = inputs
    plain = tfd_ops.tfd_pairs_plain(angles, batch)
    first, _ = first_tfd_pairs(lib, angles, batch)
    fns = {"first": lambda: first_tfd_pairs(lib, angles, batch)}
    if not first_only:
        fns["package"] = lambda: tfd_ops.tfd_pairs(angles, batch)
    times = timed_runs(smoke, fns, reps, flush)
    (_, cyc), ms = clocked(lambda: first_tfd_pairs(lib, angles, batch, True), flush)
    row = {"launch": "tfd_pairs", "input": label, "molecules": batch.n_mols,
           "conformers_max": max(n_confs), "pairs": batch.n_pairs,
           "torsions": int(sum(ts.n_torsions for ts in sets)),
           "quartets": int(sum(len(ts.quartets) for ts in sets)),
           "bound_per_pair": smoke.k18_work(sets, n_confs, rates),
           "bound_means_once": smoke.k18_work_once(sets, n_confs, rates),
           "empty_kernel_ms": {"first_grid": empty_ms(smoke, lib, -(-batch.n_pairs // THREADS),
                                                      THREADS, reps),
                               "one_block": empty_ms(smoke, lib, 1, 32, reps)},
           "first": {**times["first"], **first_info(lib)["tfd_pairs"],
                     "max_abs_err_vs_plain": float((first - plain).abs().max()),
                     "clocked_ms": ms,
                     "phase_split": smoke.phase_split(cyc.cpu(), K18_PHASES, ms)}}
    if not first_only:
        got = tfd_ops.tfd_pairs(angles, batch)
        info = tfd_ops.tfd_pairs_info(batch) if hasattr(tfd_ops, "tfd_pairs_info") else {}
        if "grid" in info:
            row["empty_kernel_ms"]["package_grid"] = empty_ms(smoke, lib, info["grid"],
                                                              info["threads"], reps)
        row["package"] = {**times["package"], **info,
                          "max_abs_err_vs_plain": float((got - plain).abs().max()),
                          "max_abs_err_vs_first": float((got - first).abs().max()),
                          "equal_to_first": bool(torch.equal(got, first))}
    emit(result="k18", **row)


def k22_launch(smoke, cuda):
    """The K22 launch over the most pairs of the counts and recursive
    screens (ties: the later), and the screens' K22 launch count."""
    from nvmolkit_tpu_torch import substructure as sub_api
    from nvmolkit_tpu_torch.chem.native import mols_from_smiles

    record = smoke.load_by_path("tools/k20_k21_phase_split.py").record
    mols = mols_from_smiles(smoke.load_by_path("benchmarks/_common.py").make_druglike_smiles(
        smoke.SUB_TARGETS))
    queries = list(smoke.load_by_path("benchmarks/substruct_bench.py").QUERIES)
    cfg = sub_api.SubstructSearchConfig()
    seen = record(lambda: sub_api.countSubstructMatches(sub_api.SubstructLibrary(mols), queries,
                                                        cfg), ("root_mask",))["root_mask"]
    seen += record(lambda: sub_api.countSubstructMatches(
        sub_api.SubstructLibrary(mols), smoke.SUB_REC_QUERIES, cfg), ("root_mask",))["root_mask"]
    best = max(range(len(seen)), key=lambda k: (seen[k][0][0].shape[0], k))
    return seen[best][0], len(seen)


def k22_results(smoke, lib, args, n_launches, rates, reps, flush, first_only) -> None:
    import torch

    from nvmolkit_tpu_torch.ops import substruct_kernels as sk

    frontier, counts, slot0, T = args
    B, P, nq = frontier.shape
    want = sk.root_mask_plain(*args)
    first, _ = first_root_mask(lib, *args)
    first_out = torch.zeros((B, T), dtype=torch.bool, device=frontier.device)
    fns = {"first": lambda: first_root_mask_into(lib, *args, first_out),
           "first_call": lambda: first_root_mask(lib, *args),
           "zeros": lambda: torch.zeros((B, T), dtype=torch.bool, device=frontier.device)}
    if not first_only:
        pk_out = torch.empty((B, T), dtype=torch.bool, device=frontier.device)
        fns["package"] = lambda: sk._launch_root_mask(*args, pk_out)
        fns["package_call"] = lambda: sk.root_mask(*args)
    times = timed_runs(smoke, fns, reps, flush)
    (_, cyc), ms = clocked(lambda: first_root_mask(lib, *args, cycles=True), flush)
    distribution = smoke.load_by_path("tools/k20_k21_phase_split.py").distribution
    row = {"launch": "root_mask", "launches_on_path": n_launches, "pairs": B, "P": P, "nq": nq,
           "slot0": slot0, "T": T, "rows": distribution(counts),
           **smoke.k22_work(frontier, counts, T, rates),
           "empty_kernel_ms": {"first_grid": empty_ms(smoke, lib, -(-B * P // THREADS), THREADS,
                                                      reps),
                               "one_block": empty_ms(smoke, lib, 1, 32, reps)},
           "first": {**times["first"], **first_info(lib)["root_mask"],
                     "equal_to_plain": bool(torch.equal(first, want)), "clocked_ms": ms,
                     "phase_split": smoke.phase_split(cyc.cpu(), K22_PHASES, ms)},
           "first_call": times["first_call"], "zeros": times["zeros"]}
    if not first_only:
        got = sk.root_mask(*args)
        info = sk.root_mask_info(B)
        row["empty_kernel_ms"]["package_grid"] = empty_ms(smoke, lib, info["grid"],
                                                          info["threads"], reps)
        row["package"] = {**times["package"], **info,
                          "equal_to_plain": bool(torch.equal(got, want)),
                          "equal_to_first": bool(torch.equal(got, first))}
        row["package_call"] = times["package_call"]
    emit(result="k22", **row)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k18_k22_phase_split: no CUDA device", file=sys.stderr)
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
    first = {}
    emit(result="build_s", **prebuild(first))
    lib = first["lib"]
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=cuda)
    tfd_in = tfd_inputs(smoke, cuda)
    for inputs in tfd_in:
        k18_results(smoke, lib, inputs, rates, reps, flush, first_only)
    k22_args, n22 = k22_launch(smoke, cuda)
    k22_results(smoke, lib, k22_args, n22, rates, reps, flush, first_only)
    if "--variants" in args:
        variants = smoke.load_by_path("tools/k18_k22_variants.py")
        variants.run(smoke, tfd_in, k22_args, rates, reps, flush, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
