#!/usr/bin/env python3
"""Per-phase split of the L-BFGS kernels K5 and K23 on one NVIDIA GPU.

    python3 tools/lbfgs_phase_split.py [--first-only | --package-only]
        [--only dg,etk,mmff,uff] [--bucket ATOMS] [--systems N] [--stage-max-atoms N]

Makes the inputs of PERF.md's eight K5/K23 rows as ``chip_smoke.py`` does:
the MMFF phase's largest bucket chunk (the fixture's molecules x 32
conformers, 5,984 systems x 64 atoms; MMFF and UFF, maxIters 200, K23
through the restart driver ``ops/lbfgs.minimize_restarting``) and the
embedding's largest chunk (set (c)'s drug-like molecules x 8 conformers,
5,856 systems x 64 atoms; DG's first minimization from K10's starts,
maxIters 400, and ETK's from the DG stages' output, maxIters 150), or with
``--bucket`` the embedding chunk of that atom bucket (DG and ETK only);
``--systems`` keeps each chunk's first N systems (a retry's launch).
Then, per row, in turns (first, package, package, first):

* ``first``: the first design, ``tools/lbfgs_first_design.cu`` (built here
  with nvcc, once per force field), 17 two-barrier block reductions per
  accepted step and the bounds read from device memory at every probe;
* ``package``: ``ops/lbfgs_flat.lbfgs`` (K5) or ``ops/lbfgs.lbfgs_lockstep``
  / ``minimize_restarting`` (K23), the package's kernels; with
  ``--stage-max-atoms`` the DG/ETK bounds are staged in shared memory up to
  that a_pad whatever the launch's size (``lbfgs_flat.STAGE_MAX_ATOMS``;
  past it only a launch that fits in one wave of staged blocks stages).

Each call (the force field's kernel on the starts, then the minimizer's
launch or launches) is timed by CUDA events, then run once more with its
per-phase cycles (thread 0 of each block, clock64(); the phases of
``lbfgs_flat.K5_PHASES``): per phase the mean over blocks, its share, and
that share of the instrumented run's time (``chip_smoke.phase_split``).
Also, per row: the probes per system (mean, 99th percentile, maximum),
evaluations and nanoseconds per system-evaluation; the registers, spilled
bytes, resident blocks per SM and shared bytes of the instantiation
(``cudaFuncGetAttributes``, ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``);
and the tail: the instrumented run's time less the block cycles summed over
the launch, divided by (SMs x resident blocks per SM x the SM clock), with
the longest block's own time. One JSON line per result; the card's name and
power limit first.
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
sys.path.insert(0, str(ROOT / "tools"))

FORCE_FIELDS = ("dg", "etk", "mmff", "uff")
KERNELS = ("K5", "K23")


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def first_libs(names) -> dict:
    """The first design built once per force field, in parallel."""
    from nvmolkit_tpu_torch import _build

    src = ROOT / "tools" / "lbfgs_first_design.cu"

    def build(ff):
        cmd = _build._nvcc_cmd(src) + [f"-DFIRST_{ff.upper()}"]
        lib = ctypes.CDLL(str(_build._build(f"liblbfgs_first_{ff}", src, cmd)))
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tables, fp = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(cf)
        lib.first_lbfgs.restype = ci
        lib.first_lbfgs.argtypes = [ci, vp, vp, vp, vp, ci, ci, vp, vp, vp, ci, tables, fp, ci,
                                    fp, ci, ci, cf, ci] + [vp] * 8
        lib.first_lbfgs_info.restype = ci
        lib.first_lbfgs_info.argtypes = [ci, ci, ctypes.POINTER(ci)]
        return ff, lib

    with ThreadPoolExecutor(len(names)) as pool:
        return dict(pool.map(build, names))


def first_info(lib, lockstep: bool, a_pad: int) -> dict:
    out = (ctypes.c_int * 4)()
    rc = lib.first_lbfgs_info(int(lockstep), a_pad, out)
    if rc != 0:
        raise RuntimeError(f"first_lbfgs_info failed with CUDA error {rc}")
    return {"registers": out[0], "local_bytes": out[1], "blocks_per_sm": out[2],
            "shared_bytes": out[3], "staged": False}


def first_call(lib, ff, x, batch, s2m, lockstep: bool, max_iters: int, done, cycles: bool):
    """One launch of the first design after the force field's kernel on the
    starts ``x``; a dict of its outputs."""
    import torch

    from nvmolkit_tpu_torch.models import flat
    from nvmolkit_tpu_torch.ops import bfgs

    n_sys, a_pad, _ = x.shape
    dev = x.device
    count = flat.system_atoms(batch, s2m)
    e0, g0 = ff.energy_and_grad(x, batch, s2m)
    pos_out = torch.empty_like(x)
    energies = torch.empty(n_sys, dtype=torch.float32, device=dev)
    status, steps, accepted, iters = torch.empty((4, n_sys), dtype=torch.int32, device=dev)
    cyc = torch.zeros((n_sys, 6), dtype=torch.int64, device=dev) if cycles else None
    extra = [v.value if isinstance(v, ctypes.c_float) else v for v in ff.extra_args(batch)]
    floats = (ctypes.c_float * 4)(*[float(v) for v in extra if isinstance(v, float)])
    ints = [int(v) for v in extra if isinstance(v, int)]
    rc = lib.first_lbfgs(
        int(lockstep), x.data_ptr(), e0.data_ptr(), g0.data_ptr(),
        None if done is None else done.data_ptr(), n_sys, a_pad, s2m.data_ptr(),
        count.data_ptr(), batch.offsets.data_ptr(), batch.n_mols, flat.table_pointers(batch),
        floats, ints[0] if ints else 0, bfgs.policy(), bfgs.MAX_LS_ITERS, int(max_iters), 1e-4,
        int(max_iters) * bfgs.MAX_LS_ITERS, pos_out.data_ptr(), energies.data_ptr(),
        status.data_ptr(), steps.data_ptr(), accepted.data_ptr(),
        iters.data_ptr() if lockstep else None, None if cyc is None else cyc.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"first_lbfgs ({ff.name}) failed with CUDA error {rc}")
    return {"positions": pos_out, "status": status, "steps": steps, "accepted": accepted,
            "cycles": cyc, "launches": 1}


def merged(r1, r2):
    """The restart's two phases as one result (counts and cycles added)."""
    import torch

    out = dict(r2, steps=r1["steps"] + r2["steps"], accepted=r1["accepted"] + r2["accepted"],
               launches=2,
               status=torch.where((r1["status"] & 1) != 0, r1["status"], r2["status"]))
    if r1["cycles"] is not None:
        out["cycles"] = r1["cycles"] + r2["cycles"]
    return out


def first_minimize(lib, ff, x, batch, s2m, kernel, max_iters, restart, cycles=False):
    from nvmolkit_tpu_torch.ops import lbfgs

    if kernel == "K5":
        return first_call(lib, ff, x, batch, s2m, False, max_iters, None, cycles)
    if not restart:
        return first_call(lib, ff, x, batch, s2m, True, max_iters, None, cycles)
    p1 = min(lbfgs.PHASE1_ITERS, max_iters)
    r1 = first_call(lib, ff, x, batch, s2m, True, p1, None, cycles)
    if p1 >= max_iters:
        return r1
    return merged(r1, first_call(lib, ff, r1["positions"], batch, s2m, True, max_iters - p1,
                                 r1["status"], cycles))


def package_minimize(ff, x, batch, s2m, kernel, max_iters, restart, cycles=False):
    from nvmolkit_tpu_torch.ops import lbfgs, lbfgs_flat

    if kernel == "K5":
        res = lbfgs_flat.lbfgs(ff, x, batch, s2m, max_iters, phase_cycles=cycles)
    elif restart:
        res = lbfgs.minimize_restarting(ff, x, batch, s2m, max_iters, phase_cycles=cycles)
    else:
        res = lbfgs.lbfgs_lockstep(ff, x, batch, s2m, max_iters, phase_cycles=cycles)
    return {"positions": res.positions, "status": res.status, "steps": res.n_iters,
            "accepted": res.n_accepted, "cycles": res.phase_cycles,
            "launches": 2 if kernel == "K23" and restart else 1}


def event_ms(fn):
    import torch

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop), out


def forcefield_cases(smoke, cuda):
    """(name, force field, positions, batch, sys2mol, maxIters) of MMFF and
    UFF at the MMFF phase's largest bucket chunk, as chip_smoke.py builds it."""
    import numpy as np
    import torch

    from nvmolkit_tpu_torch.models.mmff import EmpiricalMMFFProvider, MMFFProperties
    from nvmolkit_tpu_torch.models.mmff import energy as mmff_energy
    from nvmolkit_tpu_torch.models.uff import energy as uff_energy
    from nvmolkit_tpu_torch.utils.config import HardwareOptions

    fx, starts = smoke.mmff_fixture()
    mols = smoke.mmff_molecules(fx)
    rng = np.random.default_rng(5)
    for m, s in zip(mols, starts):
        m.conformers = []
        for x in smoke.mmff_user_conformers(rng, s):
            m.add_conformer(x)
    buckets = HardwareOptions().atomBuckets
    mol_bucket = np.array([next(b for b in buckets if m.num_atoms <= b) for m in mols])
    big = max(sorted(set(mol_bucket.tolist())), key=lambda b: int((mol_bucket == b).sum()))
    chunk = [m for m, b in zip(mols, mol_bucket) if b == big]
    confs = smoke.MMFF_CONFS
    s2m = torch.from_numpy(np.repeat(np.arange(len(chunk)), confs).astype(np.int32)).to(cuda)
    pos = np.zeros((len(chunk) * confs, big, 3), np.float32)
    for k, m in enumerate(chunk):
        pos[k * confs:(k + 1) * confs, : m.num_atoms] = np.stack(m.conformers)
    x = torch.from_numpy(pos).to(cuda)
    mb = mmff_energy.make_batched_mmff(chunk, int(big), MMFFProperties(),
                                       provider=EmpiricalMMFFProvider(), device=cuda)
    ub = uff_energy.make_batched_uff(chunk, int(big), device=cuda)
    return [("mmff", mmff_energy.MMFF, x, mb, s2m, smoke.MMFF_MAX_ITERS),
            ("uff", uff_energy.UFF, x, ub, s2m, smoke.MMFF_MAX_ITERS)]


def summary(run, ms_c, info, n_sys, rates) -> dict:
    """What one instrumented run shows (``chip_smoke.lbfgs_split``), with
    its evaluations and nanoseconds per system-evaluation."""
    import chip_smoke as smoke

    evaluations = int(run["steps"].sum()) + run["launches"] * n_sys
    slots = rates["sms"] * info["blocks_per_sm"]
    return {"evaluations": evaluations, "accepted": int(run["accepted"].sum()),
            "ns_per_evaluation": ms_c * 1e6 / evaluations, "instrumented_ms": ms_c,
            "waves": n_sys * run["launches"] / slots, **info,
            **smoke.lbfgs_split(run["steps"].cpu().numpy(), run["cycles"].cpu(), ms_c, info,
                                rates)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("lbfgs_phase_split: no CUDA device", file=sys.stderr)
        return 1
    import bfgs_phase_split
    import chip_smoke as smoke
    from nvmolkit_tpu_torch.ops import lbfgs_flat

    args = sys.argv[1:]

    def option(name, default=None):
        return args[args.index(name) + 1] if name in args else default

    first_only, package_only = "--first-only" in args, "--package-only" in args
    only = option("--only", ",".join(FORCE_FIELDS)).split(",")
    bucket = option("--bucket")
    keep = int(option("--systems", 0)) or None
    if option("--stage-max-atoms") is not None:
        lbfgs_flat.STAGE_MAX_ATOMS = int(option("--stage-max-atoms"))
    cuda = torch.device("cuda", 0)
    rates = smoke.card_rates()
    emit(device=torch.cuda.get_device_name(0), nvidia_smi=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60).stdout.strip(), rates=rates,
        stage_max_atoms=lbfgs_flat.STAGE_MAX_ATOMS)
    libs = {} if package_only else first_libs([ff for ff in FORCE_FIELDS if ff in only])
    cases = []
    if any(ff in only for ff in ("dg", "etk")):
        cases += bfgs_phase_split.embedding_cases(smoke, cuda,
                                                  None if bucket is None else int(bucket))
    if bucket is None and any(ff in only for ff in ("mmff", "uff")):
        cases += forcefield_cases(smoke, cuda)
    for name, ff, x, batch, s2m, iters in cases:
        if name not in only:
            continue
        x, s2m = x[:keep].contiguous(), s2m[:keep].contiguous()
        n_sys, a_pad = x.shape[:2]
        restart = name in ("mmff", "uff")
        for kernel in KERNELS:
            lockstep = kernel == "K23"

            def first(cycles=False, kernel=kernel):
                return first_minimize(libs[name], ff, x, batch, s2m, kernel, iters, restart,
                                      cycles)

            def package(cycles=False, kernel=kernel):
                return package_minimize(ff, x, batch, s2m, kernel, iters, restart, cycles)

            if not package_only:
                first()  # warm: the libraries loaded, the allocator's pool grown
            if not first_only:
                package()
            runs = {"first": [], "package": []}
            order = (["first", "first"] if first_only else ["package", "package"]
                     if package_only else ["first", "package", "package", "first"])
            for who in order:
                runs[who].append(event_ms(first if who == "first" else package)[0])
            row = {"kernel": kernel, "force_field": name, "systems": int(n_sys),
                   "a_pad": int(a_pad), "max_iters": iters, "restart": restart and lockstep}
            f_status = None
            if not package_only:
                f_run = first()
                f_status = f_run["status"]
                ms_c, f_c = event_ms(lambda: first(True))
                emit(result="first", **row, ms_runs=runs["first"],
                     ms=statistics.median(runs["first"]),
                     **summary(f_c, ms_c, first_info(libs[name], lockstep, a_pad), n_sys, rates))
            if first_only:
                continue
            p_run = package()
            ms_c, p_c = event_ms(lambda: package(True))
            emit(result="package", **row, ms_runs=runs["package"],
                 ms=statistics.median(runs["package"]),
                 status_equal_to_first=None if f_status is None else float(
                     (p_run["status"] == f_status).double().mean()),
                 converged=float(((p_run["status"] & 1) != 0).double().mean()),
                 **summary(p_c, ms_c, lbfgs_flat.kernel_info(ff, a_pad, lockstep, bool(
                     lbfgs_flat.stages(ff, a_pad, n_sys, lockstep, x.device))), n_sys, rates))
            del p_run, p_c
    return 0


if __name__ == "__main__":
    sys.exit(main())
