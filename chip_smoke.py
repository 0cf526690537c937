#!/usr/bin/env python3
"""Smoke run of nvmolkit_tpu_torch's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported as one JSON line with its seconds:
  0. device: the card's name and power limit;
  1. build: the similarity kernels (nvcc) and the SMILES featurizer (g++),
     from the sources in this checkout;
  2. kernels: K1 (cross similarity) and K2 (neighbor counts) against their
     plain PyTorch versions at side shapes (ragged, zero rows, 128..4096
     bits, 100k rows), and the median time of each, kernel and plain, at
     16384 x 16384 fingerprints of 2048 bits;
  3. main path: ~24.5k SMILES -> Morgan (r=3, 2048 bits) -> Tanimoto matrix
     -> Butina (cutoff 0.4), then fused Butina over 100k clustered
     fingerprints (cutoff 0.6), with the kernels' launch counts;
  4. checks of what the main path produced, and each kernel against its
     plain version at the shapes the main path gave it: K1's 24.5k x 24.5k
     matrix itself and its 100k x 1 center columns, K2's 100k x 100k counts
     and its 100k x members decrements;
  5. trace, per main-path phase: three warm untraced walls, then one run
     under torch.profiler with its wall, the span between CUDA events around
     it, the device-busy share (union of the intervals of device events,
     kernels and copies; null when the trace caught none), the host's
     launch and sync calls, and the largest device events and host calls.
Then one JSON line with the kernels, the nvidia-smi line, and as the last
line {"ok": true, "device": {...}}. Any failure raises and exits non-zero
before the last line; without CUDA it exits 1 at once.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def load_by_path(rel: str):
    """Import a file of this checkout by path (an installed ``tests`` or
    ``benchmarks`` package could shadow the directories)."""
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(f"_smoke_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx", "cudaLaunchKernelExC")
_SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def timed(fn) -> tuple[float, float]:
    """(host wall, CUDA-event span) of one run of ``fn``, in seconds."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, start.elapsed_time(stop) * 1e-3


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def trace(fn, reps: int = 3, top: int = 6) -> dict:
    """Warm walls of ``fn``, then one run under torch.profiler: device-busy
    share, device events, host launch/sync calls, largest items."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    warm = [timed(fn)[0] for _ in range(reps)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall, span = timed(fn)
    dev, host, intervals = {}, {}, []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            intervals.append((e.time_range.start, e.time_range.end))
            table = dev
        elif e.name.startswith("cu"):
            table = host
        else:
            continue
        us, n = table.get(e.name, (0.0, 0))
        table[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy = busy_us(intervals) * 1e-6

    def largest(table):
        items = sorted(table.items(), key=lambda kv: -kv[1][0])[:top]
        return [[name[:80], us / 1e3, n] for name, (us, n) in items]

    return {
        "warm_walls_s": warm, "traced_wall_s": wall, "event_span_s": span,
        "device_busy_s": busy, "busy_share": busy / wall if intervals else None,
        "n_device_events": len(intervals),
        "n_launch_calls": sum(host.get(k, (0, 0))[1] for k in _LAUNCHES),
        "n_sync_calls": sum(host.get(k, (0, 0))[1] for k in _SYNCS),
        "largest_device_ms": largest(dev), "largest_host_ms": largest(host),
    }


def median_ms(fn, reps: int = 10) -> float:
    """Median device time of ``fn`` over ``reps`` runs, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def random_fps(rng, n: int, words: int, n_centers: int = 0):
    """Sparse random packed fingerprints (uint32 [n, words]); with
    ``n_centers``, noisy copies of that many centers."""
    import numpy as np

    def sparse(rows):
        x = rng.integers(0, 2**32, (rows, words), dtype=np.uint64).astype(np.uint32)
        for _ in range(2):
            x &= rng.integers(0, 2**32, (rows, words), dtype=np.uint64).astype(np.uint32)
        return x

    if not n_centers:
        return sparse(n)
    centers = sparse(n_centers)
    return centers[rng.integers(0, n_centers, n)] ^ (sparse(n) & sparse(n))


def clustered_fingerprints(n: int, bits: int, n_centers: int = 2000, flip: float = 0.15,
                           seed: int = 2):
    """Fingerprints drawn around cluster centers: the recipe of the JAX
    package's fused-Butina benchmark (bench.py make_clustered_fingerprints),
    made in row blocks to bound host memory."""
    import numpy as np

    from nvmolkit_tpu_torch.ops.packed_bits import pack_bits_np

    rng = np.random.default_rng(seed)
    centers = rng.random((n_centers, bits)) < (64 / bits)
    assign = rng.integers(0, n_centers, n)
    drop = rng.random((n, bits)) < flip
    add = rng.random((n, bits)) < (64 * flip / bits)
    dense = (centers[assign] & ~drop) | add
    return pack_bits_np(dense.astype(np.uint8))


def ids_from_clusters(clusters, n):
    import numpy as np

    ids = np.full(n, -1, np.int64)
    for k, members in enumerate(clusters):
        ids[list(members)] = k
    return ids


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from nvmolkit_tpu_torch import _build
    from nvmolkit_tpu_torch.chem.native import morgan_batches_from_smiles
    from nvmolkit_tpu_torch.clustering import butina, fused_butina
    from nvmolkit_tpu_torch.fingerprints import MorganFingerprintGenerator
    from nvmolkit_tpu_torch.ops import similarity as sim_ops
    from nvmolkit_tpu_torch.ops.butina import butina_matrix
    from nvmolkit_tpu_torch.ops.packed_bits import unpack_bits_np
    from nvmolkit_tpu_torch.similarity import crossTanimotoSimilarity
    from nvmolkit_tpu_torch.utils.config import HardwareOptions

    cuda = torch.device("cuda", 0)
    smi_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    emit(phase="device", name=kind, nvidia_smi=smi_line, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count())

    # 1. build --------------------------------------------------------------
    t0 = time.perf_counter()
    _build.similarity_lib()
    t1 = time.perf_counter()
    _build.graph_lib()
    t2 = time.perf_counter()
    emit(phase="build", nvcc_s=t1 - t0, gxx_s=t2 - t1)

    # 2. kernels against their plain versions ---------------------------------
    t_phase = time.perf_counter()
    rng = np.random.default_rng(0)
    errs = {"cross_similarity": 0.0, "neighbor_counts": 0.0}

    def compare(name, got, want, tol, what):
        err = (got.to(torch.float32) - want.to(torch.float32)).abs().max().item()
        check(err <= tol, f"{name} {what}: max |err| {err} > {tol}")
        errs[name] = max(errs[name], err)

    for n, m, words in ((1000, 777, 4), (4096, 4096, 64), (3000, 5000, 128)):
        a = torch.from_numpy(random_fps(rng, n, words).view(np.int32)).to(cuda)
        b = torch.from_numpy(random_fps(rng, m, words).view(np.int32)).to(cuda)
        a[::97] = 0
        b[::89] = 0
        for metric, tol in (("tanimoto", 0.0), ("cosine", 1e-6)):
            compare("cross_similarity", sim_ops.cross_similarity(a, b, metric),
                    sim_ops.cross_similarity_plain(a, b, metric), tol,
                    f"{metric} {n}x{m}@{words * 32}")
    fps100k = torch.from_numpy(random_fps(rng, 100_000, 64, n_centers=64).view(np.int32)).to(cuda)
    for r in (1, 57, 1024):
        cols = torch.from_numpy(rng.choice(100_000, r, replace=False)).to(cuda)
        for metric in ("tanimoto", "cosine"):
            want = sim_ops.neighbor_counts_plain(fps100k, cols, 0.5, metric)
            compare("neighbor_counts", sim_ops.neighbor_counts(fps100k, cols, 0.5, metric),
                    want, 0, f"{metric} 100000x{r}")
            check(int(want.max()) > 0, f"K2 {metric} 100000x{r}: no neighbors at all")
    del fps100k
    x = torch.from_numpy(random_fps(rng, 16384, 64, n_centers=256).view(np.int32)).to(cuda)
    all_cols = torch.arange(16384, device=cuda)
    timing = {
        "k1_ms": median_ms(lambda: sim_ops.cross_similarity(x, x, "tanimoto")),
        "k1_plain_ms": median_ms(lambda: sim_ops.cross_similarity_plain(x, x, "tanimoto")),
        "k2_ms": median_ms(lambda: sim_ops.neighbor_counts(x, all_cols, 0.6)),
        "k2_plain_ms": median_ms(lambda: sim_ops.neighbor_counts_plain(x, all_cols, 0.6)),
    }
    del x, all_cols
    emit(phase="kernels", k1_max_abs_err=errs["cross_similarity"],
         k2_max_abs_err=errs["neighbor_counts"], timed_shape="16384x16384@2048", **timing, seconds=time.perf_counter() - t_phase)

    # 3. the main path ----------------------------------------------------------
    smiles = (
        load_by_path("benchmarks/_common.py").make_smiles(24_000)
        + load_by_path("tests/data/smiles.py").SMILES_100
        + load_by_path("tests/molgen.py").random_smiles_batch(seed=7, n=400)
    )
    fused_fps_host = clustered_fingerprints(100_000, 2048)
    gen = MorganFingerprintGenerator(radius=3, fpSize=2048)
    t0 = time.perf_counter()
    morgan_batches_from_smiles(smiles, HardwareOptions().atomBuckets)
    featurize_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    sim_ops.reset_launch_counts()
    t0 = time.perf_counter()
    fps = gen.GetFingerprintsFromSmiles(smiles, device=cuda).block_until_ready()
    t1 = time.perf_counter()
    sim = crossTanimotoSimilarity(fps).block_until_ready()
    t2 = time.perf_counter()
    ids, centroids = butina(1.0 - sim.torch(), 0.4, return_centroids=True)
    ids.block_until_ready()
    t3 = time.perf_counter()
    fused_fps = torch.from_numpy(fused_fps_host.view(np.int32)).to(cuda)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    clusters, sizes, fused_cent = fused_butina(fused_fps, 0.6, return_centroids=True)
    t5 = time.perf_counter()
    launches = dict(sim_ops.launch_counts)
    emit(phase="main_path", n_smiles=len(smiles), featurize_s=featurize_s,
         fingerprints_s=t1 - t0, similarity_s=t2 - t1, butina_s=t3 - t2,
         n_clusters=len(centroids), fused_butina_100k_s=t5 - t4,
         fused_n_clusters=len(clusters), launches=launches)

    # 4. checks -------------------------------------------------------------------
    t_phase = time.perf_counter()
    n = len(smiles)
    check(launches["cross_similarity"] > 0, "K1 was not launched on the main path")
    check(launches["neighbor_counts"] > 0, "K2 was not launched on the main path")
    for name, t in (("fingerprints", fps.torch()), ("similarity", sim.torch()),
                    ("cluster ids", ids.torch())):
        check(t.is_cuda, f"{name} are not on the GPU")
    check(fps.shape == (n, 64), f"fingerprint shape {fps.shape}")
    s = sim.torch()
    check(s.shape == (n, n) and bool(torch.isfinite(s).all()), "similarity shape/finite")
    check(bool((s.diagonal() == 1).all()), "self-similarity of a non-empty fingerprint is 1")
    # K1's main-path launch itself (24.5k x 24.5k, last row tile partial)
    compare("cross_similarity", s, sim_ops.cross_similarity_plain(fps.torch(), fps.torch()),
            0.0, f"main path Tanimoto {n}x{n}@2048")
    ids_np = ids.numpy()
    sizes_main = np.bincount(ids_np)
    check(ids_np.min() == 0 and len(sizes_main) == len(centroids), "butina ids are 0..k-1")
    check(bool((np.diff(sizes_main) <= 0).all()), "butina cluster sizes descend")
    check(bool((ids_np[centroids] == np.arange(len(centroids))).all()),
          "each butina centroid lies in its cluster")

    subset = np.arange(0, n, n // 2000)[:2000]
    cpu_fps = gen.GetFingerprintsFromSmiles([smiles[i] for i in subset], device="cpu")
    check(np.array_equal(cpu_fps.numpy(), fps.numpy()[subset]),
          "GPU fingerprints differ from the CPU run of the same code")

    golden = json.loads((ROOT / "tests/golden/regression_morgan.json").read_text())
    gold_fps = MorganFingerprintGenerator(radius=2, fpSize=1024).GetFingerprintsFromSmiles(
        golden["smiles"], device=cuda).numpy()
    for smi, row, want in zip(golden["smiles"], unpack_bits_np(gold_fps), golden["bits"]):
        check(np.nonzero(row)[0].tolist() == want, f"golden Morgan bits of {smi}")

    cut = 0.4
    sub = fps.torch()[:8192]
    fused_sub, _, fused_sub_cent = fused_butina(sub, cut, return_centroids=True)
    thr = float(np.float32(1.0 - cut))
    mat_ids, mat_cent, _ = butina_matrix(s[:8192, :8192] >= thr)
    check(np.array_equal(ids_from_clusters(fused_sub, 8192), mat_ids.cpu().numpy()),
          "fused and matrix Butina ids differ on 8192 fingerprints")
    check(np.array_equal(fused_sub_cent, mat_cent.cpu().numpy()),
          "fused and matrix Butina centroids differ on 8192 fingerprints")

    n_fused = fused_fps.shape[0]
    check(int(sizes.sum()) == n_fused, "fused cluster sizes sum to N")
    # fused Butina's K2 launches (all columns, then a cluster's members) and
    # K1 launches (the center's column) at their main-path shapes
    fused_thr = 1.0 - 0.6
    all_cols = torch.arange(n_fused, device=cuda)
    compare("neighbor_counts", sim_ops.neighbor_counts(fused_fps, all_cols, fused_thr),
            sim_ops.neighbor_counts_plain(fused_fps, all_cols, fused_thr), 0,
            f"main path counts {n_fused}x{n_fused}")
    for k in (0, len(clusters) // 2):
        member_cols = torch.tensor(clusters[k], dtype=torch.int64, device=cuda)
        compare("neighbor_counts", sim_ops.neighbor_counts(fused_fps, member_cols, fused_thr),
                sim_ops.neighbor_counts_plain(fused_fps, member_cols, fused_thr), 0,
                f"main path counts {n_fused}x{len(member_cols)}")
        c = int(fused_cent[k])
        compare("cross_similarity", sim_ops.cross_similarity(fused_fps, fused_fps[c:c + 1]),
                sim_ops.cross_similarity_plain(fused_fps, fused_fps[c:c + 1]), 0.0,
                f"main path center column {n_fused}x1")
    fused_ids = ids_from_clusters(clusters, n_fused)
    check(bool((fused_ids[fused_cent] == np.arange(len(clusters))).all()),
          "each fused centroid lies in its cluster")
    sample = np.random.default_rng(1).choice(n_fused, 2000, replace=False)
    members = torch.from_numpy(sample).to(cuda)
    cents = torch.from_numpy(fused_cent[fused_ids[sample]]).to(cuda)
    pair_sim = sim_ops.cross_similarity(fused_fps[members], fused_fps[cents]).diagonal()
    check(bool((pair_sim >= np.float32(0.4)).all()), "a fused member is farther than the cutoff")
    emit(phase="checks", seconds=time.perf_counter() - t_phase)

    # 5. where the main path's time goes ----------------------------------------
    state = {"fps": fps, "sim": sim}
    phases = {
        "fingerprints": lambda: state.update(
            fps=gen.GetFingerprintsFromSmiles(smiles, device=cuda)),
        "similarity": lambda: state.update(sim=crossTanimotoSimilarity(state["fps"])),
        "butina": lambda: butina(1.0 - state["sim"].torch(), 0.4, return_centroids=True),
        "fused_butina_100k": lambda: fused_butina(fused_fps, 0.6, return_centroids=True),
    }
    for name, fn in phases.items():
        emit(phase=f"trace_{name}", **trace(fn))

    print(json.dumps({"kernels": [
        {"name": "cross_similarity_kernel (K1)", "route": "cuda",
         "source": "nvmolkit_tpu_torch/csrc/similarity.cu",
         "replaces": "nvmolkit_tpu/ops/pallas_similarity.py:68",
         "launches": launches["cross_similarity"], "max_abs_err": errs["cross_similarity"],
         "ms": timing["k1_ms"], "plain_ms": timing["k1_plain_ms"]},
        {"name": "neighbor_counts_kernel (K2)", "route": "cuda",
         "source": "nvmolkit_tpu_torch/csrc/similarity.cu",
         "replaces": "nvmolkit_tpu/ops/butina.py:155",
         "launches": launches["neighbor_counts"], "max_abs_err": errs["neighbor_counts"],
         "ms": timing["k2_ms"], "plain_ms": timing["k2_plain_ms"]},
    ]}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
