#!/usr/bin/env python3
"""Per-phase split of the Butina loops K15 and K16 on one NVIDIA GPU.

    python3 tools/butina_phase_split.py [--first-only]

Makes the main path's inputs as ``chip_smoke.py`` does: its 24,500 SMILES
-> Morgan fingerprints (r=3, 2048 bits) -> the Tanimoto matrix -> the hit
matrix at distance cutoff 0.4 (K15's input), and 100,000 clustered
fingerprints -> K2's neighbor counts at cutoff 0.6 (K16's). Then, three
runs each:

* ``first``: the loops' first design, ``tools/butina_first_design.cu`` (built
  here with nvcc), whose thread 0 of each block adds clock64() deltas per
  phase: each phase's work (its slowest thread in the block) and the wait
  at the grid barrier after it;
* ``package``: the package's K15 and K16 (``ops/butina._launch_k15`` and
  ``_launch_k16``), timed as they run, then with their own per-phase
  cycles (``phase_cycles=True``).

For each: the CUDA-event time of each run, and per phase the mean over
blocks of its cycles and its share of the blocks' total (the share times
the instrumented run's time is the phase's time; ``chip_smoke.phase_split``).
Also the schedule K15's round loop takes on the hit matrix
(``ops/butina.butina_matrix_rounds_plain``): clusters taken one by one
while the best count exceeds ``LIST_CAP``, then the rounds and their
centers; and K16's work from the formed clusters' record. One JSON line
per result; the card's name and power limit first.
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

K15_PHASES = ["prelude", "prelude_wait", "A_local", "A_wait", "A_reduce", "B_members",
              "B_wait", "C_decrements", "C_wait"]
K16_PHASES = ["A_local", "A_wait", "A_reduce", "B_center", "B_wait", "C_tiles", "C_wait"]


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def first_lib():
    from nvmolkit_tpu_torch import _build

    src = ROOT / "tools" / "butina_first_design.cu"
    lib = ctypes.CDLL(str(_build._build("libbutina_first_design", src, _build._nvcc_cmd(src))))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.first_butina_matrix.restype = lib.first_fused_butina_loop.restype = ci
    lib.first_butina_matrix.argtypes = [vp, ci] + [vp] * 12
    lib.first_fused_butina_loop.argtypes = [vp, ci, ci, ctypes.c_float, ci] + [vp] * 13
    lib.first_grid.restype = ci
    lib.first_grid.argtypes = [ci]
    return lib


def timed_runs(fn, reps: int = 3):
    import torch

    out = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        res = fn()
        stop.record()
        torch.cuda.synchronize()
        out.append((start.elapsed_time(stop), res))
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("butina_phase_split: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from nvmolkit_tpu_torch.fingerprints import MorganFingerprintGenerator
    from nvmolkit_tpu_torch.ops import butina as ops
    from nvmolkit_tpu_torch.ops import similarity as sim_ops
    from nvmolkit_tpu_torch.similarity import crossTanimotoSimilarity

    cuda = torch.device("cuda", 0)
    emit(device=torch.cuda.get_device_name(0), nvidia_smi=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60).stdout.strip())
    lib = first_lib()
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    smiles = smoke.smoke_smiles()
    fps = MorganFingerprintGenerator(radius=3, fpSize=2048).GetFingerprintsFromSmiles(
        smiles, device=cuda)
    s = crossTanimotoSimilarity(fps).torch()
    hits = ((1.0 - s) <= 0.4).contiguous()
    del s
    n = hits.shape[0]
    fused = torch.from_numpy(smoke.clustered_fingerprints(smoke.FUSED_N, 2048).view(np.int32)
                             ).to(cuda)
    thr = 1.0 - smoke.FUSED_CUTOFF
    counts0 = sim_ops.neighbor_counts(fused, torch.arange(fused.shape[0], device=cuda), thr)

    # K15, the first design
    g15 = lib.first_grid(0)
    nw = (n + 31) // 32

    def first_outputs(n):  # the first design keeps a key per block
        out = ops._loop_outputs(n, cuda)
        out["keys"] = torch.empty(4096, dtype=torch.int64, device=cuda)
        return out

    def first_k15():
        out = first_outputs(n)
        cyc = torch.zeros((g15, len(K15_PHASES)), dtype=torch.int64, device=cuda)
        scratch = [torch.empty((n, nw), dtype=torch.int32, device=cuda),
                   torch.zeros(n, dtype=torch.int32, device=cuda),
                   torch.empty(nw, dtype=torch.int32, device=cuda)]
        members = torch.empty(n, dtype=torch.int32, device=cuda)
        n_members = torch.zeros(2, dtype=torch.int32, device=cuda)
        rc = lib.first_butina_matrix(
            hits.data_ptr(), n, *[t.data_ptr() for t in scratch], out["free"].data_ptr(),
            out["cluster_raw"].data_ptr(), out["centroids"].data_ptr(), members.data_ptr(),
            n_members.data_ptr(), out["keys"].data_ptr(), out["n_clusters"].data_ptr(),
            cyc.data_ptr(), stream())
        assert rc == 0, rc
        return out, cyc

    runs = timed_runs(first_k15)
    out, cyc = runs[-1][1]
    k = int(out["n_clusters"])
    want = ops.butina_matrix_plain(hits)
    got = ops._finish(out["cluster_raw"], out["free"], out["centroids"][:k])
    ms = statistics.median(r[0] for r in runs)
    emit(result="first_k15", grid=g15, n=n, formed=k, equal_to_plain=bool(
        torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])),
        ms_runs=[r[0] for r in runs], ms=ms,
        phases=smoke.phase_split(cyc.cpu(), K15_PHASES, ms))

    # K15's round schedule on the same matrix
    st = {}
    rounds = ops.butina_matrix_rounds_plain(hits, stats=st)
    per_round = [int(c.shape[0]) for c, _ in st["rounds"]]
    emit(result="k15_rounds", list_cap=ops.LIST_CAP, sequential=st["sequential"],
         rounds=len(per_round), round_centers=per_round, equal_to_plain=bool(
             torch.equal(rounds[0], want[0]) and torch.equal(rounds[1], want[1])))
    pure = {}
    ops.butina_matrix_rounds_plain(hits, list_cap=n, stats=pure)
    emit(result="k15_rounds_from_the_start", rounds=len(pure["rounds"]),
         round_centers=[int(c.shape[0]) for c, _ in pure["rounds"]])
    del pure, st

    # K16, the first design
    g16 = lib.first_grid(1)
    nf = fused.shape[0]

    def first_k16():
        out = first_outputs(nf)
        cyc = torch.zeros((g16, len(K16_PHASES)), dtype=torch.int64, device=cuda)
        free_rows = torch.empty((2, nf), dtype=torch.int64, device=cuda)
        free_rows[0] = torch.arange(nf, device=cuda)
        n_free = torch.tensor([nf, 0], dtype=torch.int32, device=cuda)
        members = torch.empty(nf, dtype=torch.int64, device=cuda)
        n_members = torch.zeros(1, dtype=torch.int32, device=cuda)
        record = torch.empty((nf, 3), dtype=torch.int64, device=cuda)
        counts = counts0.clone()
        rc = lib.first_fused_butina_loop(
            fused.data_ptr(), nf, fused.shape[1], float(np.float32(thr)), 0,
            counts.data_ptr(), free_rows.data_ptr(), n_free.data_ptr(),
            members.data_ptr(), n_members.data_ptr(), out["free"].data_ptr(),
            out["cluster_raw"].data_ptr(), out["centroids"].data_ptr(), record.data_ptr(),
            out["keys"].data_ptr(), out["n_clusters"].data_ptr(), cyc.data_ptr(), stream())
        assert rc == 0, rc
        return out, cyc, record

    runs = timed_runs(first_k16)
    out, cyc, record = runs[-1][1]
    k = int(out["n_clusters"])
    table = record[:k].cpu().numpy()
    free_before, members = table[:, 2], table[:, 1]
    ms = statistics.median(r[0] for r in runs)
    emit(result="first_k16", grid=g16, n=nf, formed=k, ms_runs=[r[0] for r in runs], ms=ms,
         sum_free_rows_center=int(free_before.sum()),
         sum_free_after_times_members=int(((free_before - members) * members).sum()),
         members_mean=float(members.mean()), members_max=int(members.max()),
         members_over_64=int((members > 64).sum()),
         phases=smoke.phase_split(cyc.cpu(), K16_PHASES, ms))

    if "--first-only" in sys.argv:
        return 0
    # the package's kernels: timed as they run, then with their phase cycles
    launches = {"package_k15": (lambda on: ops._launch_k15(hits, phase_cycles=on), ops.K15_PHASES),
                "package_k16": (lambda on: ops._launch_k16(fused, counts0.clone(), thr, "tanimoto",
                                                          False, phase_cycles=on),
                                ops.K16_PHASES)}
    for name, (launch, names) in launches.items():
        bare = timed_runs(lambda: launch(False))
        runs = timed_runs(lambda: launch(True))
        out = runs[-1][1]
        ms = statistics.median(r[0] for r in runs)
        emit(result=name, ms_runs=[r[0] for r in bare], ms=statistics.median(r[0] for r in bare),
             ms_with_cycles=ms, formed=int(out["n_clusters"]),
             schedule=out["schedule"].tolist() if "schedule" in out else None,
             phases=smoke.phase_split(out["phase_cycles"].cpu(), names, ms))
    return 0


if __name__ == "__main__":
    sys.exit(main())
