#!/usr/bin/env python3
"""Per-phase split of the dihedral kernel (K17) on one NVIDIA GPU, beside
its first design.

    python3 tools/k17_phase_split.py [--first-only] [--reps N] [--variants]

K17 at ``chip_smoke.py``'s TFD inputs: (c) 1,024 drug-like molecules with
hydrogens x 64 conformers, (b) one molecule x 2,000 conformers in 50
families, and bench.py's TFD configuration (``make_smiles(64)`` x 100
conformers of the port's ``EmbedMolecules``, read through ``positionsFrom``),
made by ``tools/k18_k22_phase_split.tfd_coords``.

Per input, in turns (each design, then each in reverse), the median of
CUDA-event times over ``--reps`` launches (behind a sleep kernel), hot
(back to back) and cold (after a 256 MB write):

* ``first``: the first design, ``tools/k17_first_design.cu`` (built here
  with nvcc): a thread per (conformer, quartet) work item with a binary
  search over the molecules;
* ``first_no_division``, ``first_no_atan2``, ``first_guard_squared``: the
  first design with a product in place of the division and (y + x) in
  place of atan2(y, x) (timing only: their outputs differ by design), and
  with the squared normals tested in place of the guard's two square roots
  (the same decisions);
* ``package``: ``ops/tfd.dihedral_angles`` (not with ``--first-only``).

One more launch of the first design with its phase clocks (lane 0 of each
warp): per phase the mean, its share and that share of the clocked run's
time (``chip_smoke.phase_split``). Registers, spilled bytes and blocks an SM
of each design; an empty kernel's time at each design's grid and at one
block (the floor a launch cannot go under); K17's bound
(``chip_smoke.k17_work``). Each result is held against the plain version
(the largest circular difference over ``dihedral_tolerance``) and the
package's against the first design's (equal bit for bit). ``--variants``
also times the variants of ``tools/k17_variants.py`` (the package's source
with textual changes, and other block tables) in turns with the package's
kernel. One JSON line per result; the card's name and power limit first.
Imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

K17_PHASES = ("search", "index", "coords", "normals", "norms", "division", "atan2_wrap", "store")
# first_dihedral_angles' timing modes (tools/k17_first_design.cu)
MODES = {"first_no_division": 1, "first_no_atan2": 2, "first_guard_squared": 3}
THREADS = 256  # the first design's block


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def first_lib():
    from nvmolkit_tpu_torch import _build

    src = ROOT / "tools" / "k17_first_design.cu"
    lib = ctypes.CDLL(str(_build._build("libk17_first", src, _build._nvcc_cmd(src))))
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.first_dihedral_angles.restype = ci
    lib.first_dihedral_angles.argtypes = [vp] * 5 + [ci, cll, vp, vp, ci, vp]
    lib.first_empty.restype = ci
    lib.first_empty.argtypes = [ci, ci, vp]
    lib.first_k17_info.restype = ci
    lib.first_k17_info.argtypes = [ctypes.POINTER(ci)]
    return lib


def first_info(lib) -> dict:
    out = (ctypes.c_int * 3)()
    rc = lib.first_k17_info(out)
    if rc != 0:
        raise RuntimeError(f"first_k17_info failed with CUDA error {rc}")
    return {**dict(zip(("registers", "local_bytes", "blocks_per_sm"), out)), "threads": THREADS,
            "layout": "thread per conformer and quartet"}


def first_dihedral_angles(lib, coords, batch, cycles: bool = False, mode: int = 0):
    """K17's first design on the batch: (angles float32 [n_angles], cycles
    or None)."""
    import torch

    out = torch.empty(batch.n_angles, dtype=torch.float32, device=coords.device)
    cyc = (torch.zeros((-(-batch.n_angles // 32), len(K17_PHASES)), dtype=torch.int64,
                       device=coords.device) if cycles else None)
    rc = lib.first_dihedral_angles(
        coords.data_ptr(), batch.conf_rows.data_ptr(), batch.quartets.data_ptr(),
        batch.mol_offsets.data_ptr(), batch.torsion_quartets.data_ptr(), batch.n_mols,
        batch.n_angles, out.data_ptr(), None if cyc is None else cyc.data_ptr(), mode,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"first_dihedral_angles failed with CUDA error {rc}")
    return out, cyc


def empty(lib, blocks: int, threads: int) -> None:
    """An empty kernel at ``blocks`` x ``threads``: the floor of a launch."""
    import torch

    rc = lib.first_empty(blocks, threads, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"first_empty failed with CUDA error {rc}")


def err_over_bound(got, plain, tol) -> float:
    """The largest circular |got - plain| over ``dihedral_tolerance``."""
    import torch

    diff = (got.double() - plain.double()).abs()
    return float((torch.minimum(diff, 360.0 - diff) / tol).max())


def prebuild(first: dict) -> dict:
    """The TFD kernels, the embedding's libraries (bench.py's conformers)
    and the first design, one compiler each, started together."""
    from nvmolkit_tpu_torch import _build

    libs = {"tfd": _build.tfd_lib, "graph": _build.graph_lib, "bounds": _build.bounds_lib,
            "etk_match": _build.etk_lib, "triangle_smooth": _build.triangle_smooth_lib,
            "coordgen": _build.coordgen_lib, "dist_geom": _build.dist_geom_lib,
            "embed_checks": _build.embed_checks_lib, "etk": _build.etk_ff_lib,
            "mmff": _build.mmff_lib, "uff": _build.uff_lib,
            "k17_first": lambda: first.setdefault("lib", first_lib())}

    def build(lib):
        t = time.perf_counter()
        lib()
        return time.perf_counter() - t

    with ThreadPoolExecutor(len(libs)) as pool:
        jobs = {k: pool.submit(build, lib) for k, lib in libs.items()}
        return {k: job.result() for k, job in jobs.items()}


def k17_results(smoke, split, lib, inputs, rates, reps, flush, first_only) -> None:
    import torch

    from nvmolkit_tpu_torch.ops import tfd as tfd_ops

    label, coords, batch, sets, n_confs = inputs
    plain = tfd_ops.dihedral_angles_plain(coords, batch)
    tol = tfd_ops.dihedral_tolerance(coords, batch)
    first, _ = first_dihedral_angles(lib, coords, batch)
    fns = {"first": lambda: first_dihedral_angles(lib, coords, batch)}
    fns.update({name: lambda mode=mode: first_dihedral_angles(lib, coords, batch, mode=mode)
                for name, mode in MODES.items()})
    if not first_only:
        fns["package"] = lambda: tfd_ops.dihedral_angles(coords, batch)
    times = split.timed_runs(smoke, fns, reps, flush)
    (_, cyc), ms = split.clocked(lambda: first_dihedral_angles(lib, coords, batch, True), flush)
    row = {"launch": "dihedral_angles", "input": label, "molecules": batch.n_mols,
           "conformers_max": max(n_confs), "conformers": int(sum(n_confs)),
           "angles": batch.n_angles, "quartets": int(sum(len(ts.quartets) for ts in sets)),
           "bound": smoke.k17_work(sets, n_confs, rates),
           "empty_kernel_ms": {
               "first_grid": split.empty_ms(smoke, lib, -(-batch.n_angles // THREADS), THREADS,
                                            reps),
               "one_block": split.empty_ms(smoke, lib, 1, 32, reps)},
           "first": {**times["first"], **first_info(lib),
                     "err_over_bound_vs_plain": err_over_bound(first, plain, tol),
                     "clocked_ms": ms,
                     "phase_split": smoke.phase_split(cyc.cpu(), K17_PHASES, ms)},
           **{name: times[name] for name in MODES}}
    if not first_only:
        got = tfd_ops.dihedral_angles(coords, batch)
        info = tfd_ops.dihedral_angles_info(batch) if hasattr(
            tfd_ops, "dihedral_angles_info") else {}
        if "grid" in info:
            row["empty_kernel_ms"]["package_grid"] = split.empty_ms(
                smoke, lib, info["grid"], info["threads"], reps)
        row["package"] = {**times["package"], **info,
                          "err_over_bound_vs_plain": err_over_bound(got, plain, tol),
                          "equal_to_first": bool(torch.equal(got, first))}
    emit(result="k17", **row)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k17_phase_split: no CUDA device", file=sys.stderr)
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
    split = smoke.load_by_path("tools/k18_k22_phase_split.py")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=cuda)
    inputs = split.tfd_coords(smoke, cuda)
    for one in inputs:
        k17_results(smoke, split, first["lib"], one, rates, reps, flush, first_only)
    if "--variants" in args:
        smoke.load_by_path("tools/k17_variants.py").run(smoke, inputs, reps, flush, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
