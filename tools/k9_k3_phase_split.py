#!/usr/bin/env python3
"""Per-phase split of triangle smoothing (K9) and conformer RMSD (K3) on
one NVIDIA GPU, beside their first designs.

    python3 tools/k9_k3_phase_split.py [--first-only | --package-only]
        [--only k9,k3] [--reps N] [--variants] [--sass DIR]

Makes the inputs as ``chip_smoke.py`` makes them:

* ``k9``: set (c)'s drug-like molecules with hydrogens (``EMBED_MOLS``,
  ``random_smiles_batch(seed=11)``), their topological bounds at each atom
  bucket's chunk (the 64-atom chunk is the kernel table's 732 x 64), and
  long chains with hydrogens (``K10_LARGE_SMILES`` x 64, 195-242 atoms in
  the 256-atom bucket: past 160 atoms, K9's global-memory path).
* ``k3``: (a) the first 1,024 main-path molecules of 3 atoms or more x 64
  conformers, (c) 1,024 drug-like molecules with hydrogens x 64, (b) one
  molecule x 2,000 conformers in 50 families, made by the script's
  ``conformer_ensemble`` and ``family_ensemble`` in its order.

Then per input, in turns (first, package, package, first), the median of
CUDA-event times over ``--reps`` launches, hot (back to back) and cold
(after a 256 MB write):

* ``first``: the first design, ``tools/k9_k3_first_design.cu`` (built here
  with nvcc);
* ``package``: ``ops/triangle_smooth.triangle_smooth_bounds`` (K9) and
  ``ops/kabsch.conformer_rmsd_condensed`` (K3).

One more launch of the first design with its per-warp phase clocks: per
phase the mean over warps, its share and that share of the clocked run's
time (``chip_smoke.phase_split``); K3's ``center_kernel`` also alone, and
the share of idle threads on its diagonal tiles (and on all tiles) from
the tile plan. Registers, spilled bytes, blocks an SM and shared bytes of
each first-design kernel (``cudaFuncGetAttributes`` and the occupancy
API), and ``cuobjdump -res-usage`` of the package's two libraries. Every
output is held against the first design's and the plain version's: K9
bit for bit, K3 within ``kabsch.rmsd_tolerance``. One JSON line per
result, the card's name and power limit first. ``--variants`` runs instead
the variants of ``tools/k9_k3_variants.cu`` (K9 at the 48-, 64- and
96-atom chunks: without min and max, without the barrier, with split
arrive and wait; K3's molecule_kernel at (a) and (c) with its phase clocks
and with Newton's 12 steps), in turns with the package's kernels. Imports
nothing of JAX. ``--sass DIR`` writes the package libraries' SASS there
(``k9_k3_sass_out/`` is gitignored) and prints each kernel's opcode counts.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

K9_PHASES = ("load", "stage", "update", "flag", "write")
K3_PHASES = ("decode", "stage", "fma", "qcp")
WARPS = 8
TILE = 16


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def first_lib():
    """The first designs, built while the package's libraries build."""
    from nvmolkit_tpu_torch import _build

    src = ROOT / "tools" / "k9_k3_first_design.cu"
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    with ThreadPoolExecutor(3) as pool:
        built = [pool.submit(f) for f in (_build.triangle_smooth_lib, _build.rmsd_lib)]
        path = pool.submit(_build._build, "libk9_k3_first", src, _build._nvcc_cmd(src)).result()
        for b in built:
            b.result()
    lib = ctypes.CDLL(str(path))
    lib.first_k9.restype = lib.first_k3.restype = lib.first_info.restype = ci
    lib.first_k9.argtypes = [vp, vp, vp, ci, ci, vp, vp, vp, vp, vp]
    lib.first_k3.argtypes = [vp, vp, ci, ci, vp, vp, ci, cll, ci, vp, ci, vp, vp, vp, vp, vp, vp]
    lib.first_info.argtypes = [ci, ci, ctypes.POINTER(ci)]
    return lib


def first_info(lib, which: int, a_pad: int = 0) -> dict:
    out = (ctypes.c_int * 4)()
    rc = lib.first_info(which, a_pad, out)
    if rc != 0:
        raise RuntimeError(f"first_info failed with CUDA error {rc}")
    return {"registers": out[0], "local_bytes": out[1], "blocks_per_sm": out[2],
            "shared_bytes": out[3]}


def first_k9(lib, up, lo, n, cycles: bool):
    import torch

    m, a_pad = up.shape[:2]
    ub, lb = torch.empty_like(up), torch.empty_like(lo)
    ok = torch.empty(m, dtype=torch.uint8, device=up.device)
    cyc = (torch.zeros((m, WARPS, len(K9_PHASES)), dtype=torch.int64, device=up.device)
           if cycles else None)
    rc = lib.first_k9(up.data_ptr(), lo.data_ptr(), n.data_ptr(), m, a_pad, ub.data_ptr(),
                      lb.data_ptr(), ok.data_ptr(), None if cyc is None else cyc.data_ptr(),
                      torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"first_k9 failed with CUDA error {rc}")
    return (ub, lb, ok.bool()), cyc


def first_offsets(n_confs):
    """The first design's offsets: conformers, 16 x 16 tiles, pairs."""
    import numpy as np

    c = np.asarray(n_confs, np.int64)
    t = (c + TILE - 1) // TILE
    tiles = np.where(c >= 2, t * (t + 1) // 2, 0)
    off = np.zeros((3, len(c) + 1), np.int64)
    for k, v in enumerate((c, tiles, c * (c - 1) // 2)):
        np.cumsum(v, out=off[k, 1:])
    return off


def first_k3(lib, x, mask, n_confs, cycles: bool, off_dev, off):
    import torch

    n_conf, a_in = x.shape[:2]
    a_pad = max(32, -(-a_in // 32) * 32)
    xc = torch.empty((n_conf, a_pad, 4), dtype=torch.float32, device=x.device)
    g = torch.empty(n_conf, dtype=torch.float32, device=x.device)
    count = torch.empty(len(n_confs), dtype=torch.int32, device=x.device)
    out = torch.empty(int(off[2, -1]), dtype=torch.float32, device=x.device)
    n_tiles = int(off[1, -1])
    cc = torch.zeros(n_conf, dtype=torch.int64, device=x.device) if cycles else None
    pc = (torch.zeros((n_tiles, WARPS, len(K3_PHASES)), dtype=torch.int64, device=x.device)
          if cycles else None)
    rc = lib.first_k3(x.data_ptr(), None, n_conf, a_in, mask.data_ptr(), off_dev.data_ptr(),
                      len(n_confs), n_tiles, 0, xc.data_ptr(), a_pad, g.data_ptr(),
                      count.data_ptr(), out.data_ptr(), None if cc is None else cc.data_ptr(),
                      None if pc is None else pc.data_ptr(),
                      torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"first_k3 failed with CUDA error {rc}")
    return out, cc, pc


def clocked(fn):
    """(the instrumented launch's ms, its output)."""
    import torch

    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop), out


def timed_runs(smoke, fns: dict, order, reps: int, flush) -> dict:
    hot = {k: [] for k in fns}
    cold = {k: [] for k in fns}
    for who in order:
        hot[who].append(smoke.median_ms(fns[who], reps))
        cold[who].append(smoke.median_ms(fns[who], reps, flush=flush))
    return {k: {"ms_runs": hot[k], "ms": statistics.median(hot[k]), "cold_ms_runs": cold[k],
                "cold_ms": statistics.median(cold[k])} for k in fns if hot[k]}


def order_of(first_only: bool, package_only: bool):
    if first_only:
        return ["first", "first"]
    if package_only:
        return ["package", "package"]
    return ["first", "package", "package", "first"]


def k9_inputs(smoke, cuda):
    """(label, upper, lower, n_atoms) per bucket chunk of set (c) and the
    long chains' 256-atom chunk."""
    import torch

    from nvmolkit_tpu_torch.chem.bounds import topological_bounds_batch
    from nvmolkit_tpu_torch.chem.native import mols_from_smiles
    from nvmolkit_tpu_torch.utils.config import HardwareOptions

    emols = [smoke.with_hydrogens(m) for m in mols_from_smiles(smoke.random_smiles_batch(
        seed=11, n=smoke.EMBED_MOLS, min_heavy=smoke.DRUG_HEAVY[0],
        max_heavy=smoke.DRUG_HEAVY[1]))]
    chains = [smoke.with_hydrogens(m) for m in mols_from_smiles(smoke.K10_LARGE_SMILES)] * 64
    buckets = HardwareOptions().atomBuckets
    groups = {}
    for m in emols:
        groups.setdefault(next(b for b in buckets if m.num_atoms <= b), []).append(m)
    out = []
    for b, ms in sorted(groups.items()) + [(256, chains)]:
        up, lo = topological_bounds_batch(ms, b)
        n = torch.tensor([m.num_atoms for m in ms], dtype=torch.int32, device=cuda)
        label = f"{len(ms)} mols x {b} atoms" + (" (global memory)" if b > 160 else "")
        out.append((label, torch.from_numpy(up).to(cuda), torch.from_numpy(lo).to(cuda), n))
    return out


def k9_results(smoke, lib, cuda, rates, reps, flush, first_only, package_only):
    import torch

    from nvmolkit_tpu_torch.ops import triangle_smooth

    for label, up, lo, n in k9_inputs(smoke, cuda):
        a_pad = int(up.shape[1])
        work = smoke.k9_work(n.cpu().numpy(), a_pad, rates)
        want = triangle_smooth.triangle_smooth_bounds_plain(up, lo, n)
        fns = {}
        if not package_only:
            fns["first"] = lambda: first_k9(lib, up, lo, n, False)
        if not first_only:
            fns["package"] = lambda: triangle_smooth.triangle_smooth_bounds(up, lo, n)
        times = timed_runs(smoke, fns, order_of(first_only, package_only), reps, flush)
        for key in fns:
            entry = {"kernel": "K9", "input": label, "molecules": int(up.shape[0]),
                     "a_pad": a_pad, "bound_ms": work["bound_ms"], "bound_by": work["bound_by"],
                     "design": key, **times[key]}
            if key == "first":
                got, _ = first_k9(lib, up, lo, n, False)
                ms_c, (_, cyc) = clocked(lambda: first_k9(lib, up, lo, n, True))
                entry.update(instrumented_ms=ms_c, phase_split=smoke.phase_split(
                    cyc.cpu().reshape(-1, len(K9_PHASES)), K9_PHASES, ms_c),
                    **first_info(lib, 0, a_pad))
            else:
                got = triangle_smooth.triangle_smooth_bounds(up, lo, n)
            entry["equal_to_plain"] = all(torch.equal(g, w) for g, w in zip(got, want))
            entry["inconsistent_molecules"] = int((~want[2]).sum())
            emit(result="k9", **entry)


def k3_inputs(smoke, cuda):
    """(label, x, mask, n_confs) of (a), (c) and (b), made as chip_smoke.py
    makes them."""
    import numpy as np
    import torch

    from nvmolkit_tpu_torch.chem.native import mols_from_smiles
    from nvmolkit_tpu_torch.conformerRmsd import conformer_stack

    mols = mols_from_smiles(smoke.smoke_smiles())
    rng = np.random.default_rng(3)
    batch_mols = [m for m in mols if m.num_atoms >= 3][:smoke.RMSD_MOLS]
    for m in batch_mols:
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
    families = smoke.family_ensemble(rng, big.num_atoms)
    out = []
    for label, batch in (("(a)", batch_mols), ("(c)", drug_mols)):
        stack, mask, nc = conformer_stack(batch)
        out.append((label, torch.from_numpy(stack).to(cuda), torch.from_numpy(mask).to(cuda), nc))
    out.append(("(b)", torch.from_numpy(families.astype(np.float32)).to(cuda),
                torch.ones((1, big.num_atoms), dtype=torch.bool, device=cuda),
                np.array([len(families)])))
    return out


def idle_shares(n_confs) -> dict:
    """The first design's idle threads (no pair) on its diagonal tiles and
    on all its tiles."""
    import numpy as np

    c = np.asarray(n_confs, np.int64)
    t = (c + TILE - 1) // TILE
    diag_active = sum(int(((np.minimum(TILE, ci - TILE * np.arange(ti))
                            * (np.minimum(TILE, ci - TILE * np.arange(ti)) - 1)) // 2).sum())
                      for ci, ti in zip(c, t))
    n_diag = int(t.sum())
    n_tiles = int((t * (t + 1) // 2).sum())
    return {"diagonal_tiles": n_diag, "tiles": n_tiles,
            "idle_share_diagonal": 1.0 - diag_active / (TILE * TILE * n_diag),
            "idle_share_all": 1.0 - int((c * (c - 1) // 2).sum()) / (TILE * TILE * n_tiles)}


def k3_results(smoke, lib, cuda, rates, reps, flush, first_only, package_only):
    import torch

    from nvmolkit_tpu_torch.ops import kabsch

    for label, x, mask, nc in k3_inputs(smoke, cuda):
        off = first_offsets(nc)
        off_dev = torch.from_numpy(off).to(cuda)
        work = smoke.k3_work(nc, mask.sum(dim=1).cpu().numpy(), x.shape[1], False, rates)
        want = kabsch.conformer_rmsd_condensed_plain(x, mask, nc)
        scales = kabsch.condensed_scales(x, mask, nc)
        tol = kabsch.rmsd_tolerance(want.double(), *scales)
        fns = {}
        if not package_only:
            fns["first"] = lambda: first_k3(lib, x, mask, nc, False, off_dev, off)
        if not first_only:
            fns["package"] = lambda: kabsch.conformer_rmsd_condensed(x, mask, nc)
        times = timed_runs(smoke, fns, order_of(first_only, package_only), reps, flush)
        first_out = None
        for key in fns:
            entry = {"kernel": "K3", "input": label, "molecules": len(nc),
                     "conformers": int(nc.sum()), "atoms": int(x.shape[1]),
                     "pairs": int(want.shape[0]), "bound_ms": work["bound_ms"],
                     "bound_by": work["bound_by"], "design": key, **times[key]}
            if key == "first":
                first_out = got = first_k3(lib, x, mask, nc, False, off_dev, off)[0]
                ms_c, (_, cc, pc) = clocked(lambda: first_k3(lib, x, mask, nc, True, off_dev, off))
                cc = cc.cpu().double()
                entry.update(
                    instrumented_ms=ms_c,
                    center_cycles_mean=float(cc.mean()), center_cycles_max=float(cc.max()),
                    pair_phase_split=smoke.phase_split(pc.cpu().reshape(-1, len(K3_PHASES)),
                                                       K3_PHASES, ms_c),
                    **idle_shares(nc),
                    center_kernel=first_info(lib, 1), pair_kernel=first_info(lib, 2))
            else:
                got = kabsch.conformer_rmsd_condensed(x, mask, nc)
                if first_out is not None:
                    entry["equal_to_first"] = bool(torch.equal(got, first_out))
            err = (got.double() - want.double()).abs()
            entry["err_over_tolerance"] = float((err / tol).max())
            entry["max_abs_err"] = float(err.max())
            emit(result="k3", **entry)
        if not package_only:
            # center_kernel alone: the first design with no pair tile (every
            # molecule's tile count 0), its time a launch of it by itself
            off0 = off.copy()
            off0[1] = 0
            off0_dev = torch.from_numpy(off0).to(cuda)
            emit(result="k3_center_alone", input=label, ms=smoke.median_ms(
                lambda: first_k3(lib, x, mask, nc, False, off0_dev, off0), reps),
                cold_ms=smoke.median_ms(
                    lambda: first_k3(lib, x, mask, nc, False, off0_dev, off0), reps, flush=flush))
        del want, scales, tol
        torch.cuda.empty_cache()


K9_VARIANTS = ("redesign", "no_minmax", "no_barrier", "split_arrive", "split_arrive_int",
               "select_publish", "threads_128", "symmetric_128", "symmetric_64")
K3_VARIANTS = (("redesign", 8), ("newton_12", 8), ("two_staging", 8), ("threads_512", 16),
               ("four_staging", 8), ("roots_side_by_side", 8), ("eight_staging", 8))


def variants_lib():
    """tools/k9_k3_variants.cu, built here with nvcc."""
    from nvmolkit_tpu_torch import _build

    src = ROOT / "tools" / "k9_k3_variants.cu"
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib = ctypes.CDLL(str(_build._build("libk9_k3_variants", src, _build._nvcc_cmd(src))))
    lib.variant_k9.restype = lib.variant_k3.restype = ci
    lib.variant_k9.argtypes = [ci, vp, vp, vp, ci, ci, vp, vp, vp, vp]
    lib.variant_k3.argtypes = [ci, vp, ci, vp, vp, ci, ci, vp, vp, vp]
    return lib


def variant_results(smoke, cuda, rates, reps, flush) -> None:
    """K9's variants at the 33-96-atom chunks and K3's molecule_kernel with
    its phase clocks and without Newton's stopping rule at (a) and (c),
    each in turns with the package's kernel."""
    import torch

    from nvmolkit_tpu_torch.ops import kabsch, triangle_smooth

    lib = variants_lib()
    emit(result="res_usage", **res_usage("libk9_k3_variants", ROOT / "tools" / "k9_k3_variants.cu"))
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for label, up, lo, n in k9_inputs(smoke, cuda):
        a_pad = int(up.shape[1])
        if not 32 < a_pad <= 96:
            continue
        want = triangle_smooth.triangle_smooth_bounds_plain(up, lo, n)

        def run(mode):
            ub, lb = torch.empty_like(up), torch.empty_like(lo)
            ok = torch.empty(up.shape[0], dtype=torch.uint8, device=cuda)
            rc = lib.variant_k9(mode, up.data_ptr(), lo.data_ptr(), n.data_ptr(), up.shape[0],
                                a_pad, ub.data_ptr(), lb.data_ptr(), ok.data_ptr(), stream())
            if rc != 0:
                raise RuntimeError(f"variant_k9 {mode} failed with CUDA error {rc}")
            return ub, lb, ok.bool()

        fns = {name: (lambda m=m: run(m)) for m, name in enumerate(K9_VARIANTS)
               if name not in ("threads_128", "symmetric_64") or a_pad <= 64}
        fns["kernel"] = lambda: triangle_smooth.triangle_smooth_bounds(up, lo, n)
        order = list(fns) + list(fns)[::-1]
        times = timed_runs(smoke, fns, order, reps, flush)
        emit(result="k9_variants", input=label, a_pad=a_pad,
             bound_ms=smoke.k9_work(n.cpu().numpy(), a_pad, rates)["bound_ms"],
             **{k: {"ms": v["ms"], "ms_runs": v["ms_runs"], "cold_ms": v["cold_ms"],
                    "equal_to_plain": all(torch.equal(g, w) for g, w in zip(fns[k](), want))}
                for k, v in times.items()})
    for label, x, mask, nc in k3_inputs(smoke, cuda)[:2]:
        plan, _, n_fit, smem = kabsch.kernel_plan(nc, x.shape[1])
        assert n_fit == len(nc)
        off = torch.from_numpy(plan[:3 * (len(nc) + 1)].copy()).to(cuda)
        total = int(plan[2 * (len(nc) + 1) + len(nc)])

        def run(mode, cycles=None):
            out = torch.empty(total, dtype=torch.float32, device=cuda)
            rc = lib.variant_k3(mode, x.data_ptr(), x.shape[1], mask.data_ptr(), off.data_ptr(),
                                len(nc), smem, out.data_ptr(),
                                None if cycles is None else cycles.data_ptr(), stream())
            if rc != 0:
                raise RuntimeError(f"variant_k3 {mode} failed with CUDA error {rc}")
            return out

        fns = {name: (lambda m=m: run(m)) for m, (name, _) in enumerate(K3_VARIANTS)}
        fns["kernel"] = lambda: kabsch.conformer_rmsd_condensed(x, mask, nc)
        times = timed_runs(smoke, fns, list(fns) + list(fns)[::-1], reps, flush)
        got = kabsch.conformer_rmsd_condensed(x, mask, nc)
        splits = {}
        for m, (name, warps) in enumerate(K3_VARIANTS):
            cyc = torch.zeros((len(nc), warps, 3), dtype=torch.int64, device=cuda)
            ms_c, _ = clocked(lambda: run(m, cyc))
            splits[name] = {"instrumented_ms": ms_c, "phase_split": smoke.phase_split(
                cyc.cpu().reshape(-1, 3), ("stage", "pairs", "qcp"), ms_c)}
        emit(result="k3_variants", input=label,
             **{k: {"ms": v["ms"], "ms_runs": v["ms_runs"], "cold_ms": v["cold_ms"],
                    "equal_to_kernel": bool(torch.equal(fns[k](), got)), **splits.get(k, {})}
                for k, v in times.items()})


def res_usage(name: str, src) -> dict:
    """``cuobjdump -res-usage`` of a package library: each kernel's line."""
    from nvmolkit_tpu_torch import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    path = _build._build(name, src, _build._nvcc_cmd(src))
    proc = subprocess.run([tool, "-res-usage", str(path)], capture_output=True, text=True,
                          timeout=120)
    lines = [ln.strip() for ln in proc.stdout.splitlines() if ln.strip()]
    return {"library": name, "res_usage": lines}


def sass_dump(name: str, src, out_dir: pathlib.Path) -> dict:
    """``cuobjdump -sass`` of a package library into ``out_dir``; per kernel
    its instruction count and opcode histogram."""
    import re

    from nvmolkit_tpu_torch import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    path = _build._build(name, src, _build._nvcc_cmd(src))
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          timeout=300).stdout
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{name}.sass").write_text(sass)
    kernels = {}
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        fname, _, body = block.partition("\n")
        ops = {}
        for line in body.splitlines():
            m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
            if m:
                ops[m.group(2)] = ops.get(m.group(2), 0) + 1
        kernels[fname.strip()] = {"instructions": sum(ops.values()),
                                  "opcodes": dict(sorted(ops.items(), key=lambda kv: -kv[1]))}
    return {"library": name, "kernels": kernels}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k9_k3_phase_split: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from nvmolkit_tpu_torch import _build

    args = sys.argv[1:]

    def option(name, default):
        return args[args.index(name) + 1] if name in args else default

    first_only, package_only = "--first-only" in args, "--package-only" in args
    only = [] if "--variants" in args else option("--only", "k9,k3").split(",")
    reps = int(option("--reps", 20))
    cuda = torch.device("cuda", 0)
    rates = smoke.card_rates()
    emit(device=torch.cuda.get_device_name(0), nvidia_smi=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60).stdout.strip(), rates=rates)
    lib = first_lib()
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=cuda)
    if "k9" in only:
        k9_results(smoke, lib, cuda, rates, reps, flush, first_only, package_only)
    if "k3" in only:
        k3_results(smoke, lib, cuda, rates, reps, flush, first_only, package_only)
    if "--variants" in args:
        variant_results(smoke, cuda, rates, reps, flush)
    for name, src in (("libnvmk_triangle_smooth", _build.TRIANGLE_SMOOTH_SRC),
                      ("libnvmk_rmsd", _build.RMSD_SRC)):
        emit(result="res_usage", **res_usage(name, src))
        if "--sass" in args:
            emit(result="sass", **sass_dump(name, src, pathlib.Path(option("--sass", ""))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
