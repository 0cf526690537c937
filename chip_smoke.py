#!/usr/bin/env python3
"""Smoke run of nvmolkit_tpu_torch's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported as one JSON line with its seconds:
  0. device: the card's name and power limit;
  1. build: the similarity kernels (nvcc) and the SMILES featurizer (g++),
     from the sources in this checkout;
  2. kernels: K1 (cross similarity, both launch configurations) and K2
     (neighbor counts) against their plain PyTorch versions at side shapes
     (ragged, zero rows, 128..4096 bits, with and without row lists, the
     column counts around the few-column limit M_SKINNY, 100k rows), and
     the median time of each, kernel and plain, at 16384 x 16384
     fingerprints of 2048 bits;
  3. main path: ~24.5k SMILES -> Morgan (r=3, 2048 bits) -> Tanimoto matrix
     -> Butina (cutoff 0.4), then fused Butina over 100k clustered
     fingerprints (cutoff 0.6), with the kernels' launch counts;
  4. checks of what the main path produced, and each kernel against its
     plain version at the shapes and row lists the main path gave it: K1's
     24.5k x 24.5k matrix itself, its free rows x 1 center columns, K2's
     100k x 100k counts and its free rows x members decrements; the sum
     over the fused loop of its free rows;
  5. timings at the main path's shapes: the median of each kernel and its
     plain version by CUDA events, beside its bound (the least time the
     card could take: bytes over the memory rate or POPCs over the integer
     pipe's rate, whichever is larger; the center columns and decrements
     also with a cold L2), and K1's two configurations over the column
     counts of the M_SKINNY sweep;
  6. trace, per main-path phase: three warm untraced walls, then one run
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
import random
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
POPC_PER_SM_CLOCK = 16     # __popc issue rate of one sm_90 SM
FUSED_N, FUSED_CUTOFF = 100_000, 0.6


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


# The random-SMILES generator of tests/molgen.py, copied: that file checks
# each string with the JAX package's parser, this copy with the port's
# featurizer, so the script loads nothing of the JAX package.
# tests/test_torch_slice.py holds the two lists equal.
_CHAIN_ATOMS = [
    ("C", 3), ("C", 3), ("C", 3), ("N", 2), ("O", 1), ("S", 1),
    ("F", 0), ("Cl", 0), ("Br", 0),
]
_AROMATIC_RINGS = ["c1ccccc1", "c1ccncc1", "c1ccoc1", "c1ccsc1", "c1cc[nH]c1"]
_ALI_RING_SIZES = (3, 4, 5, 6, 7)


def _ring_smiles(rng: random.Random, closure: int) -> tuple[str, int]:
    if rng.random() < 0.5:
        frag = rng.choice(_AROMATIC_RINGS).replace("1", str(closure))
        return frag, sum(1 for ch in frag if ch in "cnos")
    size = rng.choice(_ALI_RING_SIZES)
    atoms = ["C" if rng.random() < 0.8 else rng.choice(["N", "O", "S"]) for _ in range(size)]
    return atoms[0] + str(closure) + "".join(atoms[1:]) + str(closure), size


def _random_smiles(rng: random.Random, n_heavy: int) -> str:
    out: list[str] = []
    count = 0
    closure = 1
    while count < n_heavy:
        room = n_heavy - count
        r = rng.random()
        if r < 0.25 and room >= 5 and closure <= 8:
            frag, n = _ring_smiles(rng, closure)
            closure += 1
            if n > room:
                continue
            out.append(frag)
            count += n
        else:
            sym, _ = rng.choice(_CHAIN_ATOMS)
            token = sym
            if sym == "C" and rng.random() < 0.04:
                token = "[CH3+]" if count else "C"
            elif sym == "N" and rng.random() < 0.15:
                token = "[NH3+]" if rng.random() < 0.5 else "[N+](C)(C)C"
            elif sym == "O" and rng.random() < 0.12 and count:
                token = "[O-]"
            if count and rng.random() < 0.30:
                out.append("(" + token + ")")
            else:
                if count and token[0] in "CNO" and rng.random() < 0.15:
                    out.append(rng.choice(["=", "#"]) if token[0] == "C" else "=")
                out.append(token)
            count += token.count("C") + token.count("N") + token.count("O")
            count += sum(token.count(h) for h in ("S", "F", "Br"))
        if len(out) > 4 * n_heavy:
            break
    return "".join(out) or "C"


def random_smiles_batch(seed: int, n: int, min_heavy: int = 4, max_heavy: int = 30) -> list[str]:
    """``tests/molgen.random_smiles_batch(seed, n)``: n random SMILES that
    the featurizer accepts, with at least ``min_heavy`` heavy atoms."""
    from nvmolkit_tpu_torch.chem.native import num_atoms

    rng = random.Random(seed)
    out: list[str] = []
    attempts = 0
    while len(out) < n and attempts < 60 * n:
        # the candidates do not depend on which were accepted, so a chunk
        # of them goes through the featurizer at once
        chunk = [_random_smiles(rng, rng.randint(min_heavy, max_heavy))
                 for _ in range(min(n, 60 * n - attempts))]
        attempts += len(chunk)
        out += [s for s, na in zip(chunk, num_atoms(chunk)) if na >= min_heavy][:n - len(out)]
    check(len(out) == n, f"generator yield too low: {len(out)}/{n}")
    return out


def smoke_smiles() -> list[str]:
    """The main path's 24,500 SMILES."""
    return (
        load_by_path("benchmarks/_common.py").make_smiles(24_000)
        + load_by_path("tests/data/smiles.py").SMILES_100
        + random_smiles_batch(seed=7, n=400)
    )


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


def median_ms(fn, reps: int = 10, flush=None) -> float:
    """Median device time of ``fn`` over ``reps`` runs, by a pair of CUDA
    events around each run. The stream is held by a sleep kernel while the
    host queues every run, so the host's launch time stays out of the
    spans of short kernels. With ``flush`` (a large tensor), each run
    follows a write of it, so it finds the L2 cache cold."""
    import torch

    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for start, stop in events:
        if flush is not None:
            flush.zero_()
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(stop) for start, stop in events)


def card_rates() -> dict:
    """The rates the bounds use: device memory (data sheet) and POPC issue
    (16 per SM per clock at the card's highest SM clock)."""
    import torch

    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"hbm_bytes_per_s": HBM_BYTES_PER_S, "sms": sms, "max_sm_clock_mhz": clock_mhz,
            "popc_per_s": POPC_PER_SM_CLOCK * sms * clock_mhz * 1e6}


def bound(n_bytes: float, n_popc: float, rates: dict) -> dict:
    """The least time for the work: bytes moved (each input read once, each
    output written once) over the memory rate, or POPCs over their issue
    rate, whichever is larger."""
    t_bytes = n_bytes / rates["hbm_bytes_per_s"] * 1e3
    t_ops = n_popc / rates["popc_per_s"] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "popc": n_popc}


def k1_work(rows: int, m: int, words: int, listed: bool, rates: dict) -> dict:
    """K1 over ``rows`` A rows (gathered through an int64 list when
    ``listed``) and m B rows: one 32-bit AND-POPC per word of each pair."""
    n_bytes = 4 * words * (rows + m) + 4 * rows * m + (8 * rows if listed else 0)
    return bound(n_bytes, rows * m * words, rates)


def k2_work(rows: int, cols: int, words: int, listed: bool, rates: dict) -> dict:
    """K2 over ``rows`` rows (listed or all) and an int64 list of ``cols``
    columns, int32 counts out."""
    n_bytes = 4 * words * (rows + cols) + 8 * cols + 4 * rows + (8 * rows if listed else 0)
    return bound(n_bytes, rows * cols * words, rates)


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
    from nvmolkit_tpu_torch.ops import butina as butina_ops
    from nvmolkit_tpu_torch.ops import similarity as sim_ops
    from nvmolkit_tpu_torch.ops.packed_bits import unpack_bits_np
    from nvmolkit_tpu_torch.similarity import crossTanimotoSimilarity
    from nvmolkit_tpu_torch.utils.config import HardwareOptions

    cuda = torch.device("cuda", 0)
    smi_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    rates = card_rates()
    emit(phase="device", name=kind, nvidia_smi=smi_line, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count(), rates=rates)

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
    K1, K1F, K2 = "cross_similarity", "cross_similarity_few_columns", "neighbor_counts"
    errs = {K1: 0.0, K1F: 0.0, K2: 0.0}
    tolerance = {"tanimoto": 0.0, "cosine": 1e-6}

    def compare(name, got, want, tol, what):
        check(got.shape == want.shape, f"{name} {what}: shape {tuple(got.shape)}")
        if not got.numel():  # the last cluster may take every free row
            return
        err = (got.to(torch.float32) - want.to(torch.float32)).abs().max().item()
        check(err <= tol, f"{name} {what}: max |err| {err} > {tol}")
        errs[name] = max(errs[name], err)

    def check_k1(a, b, metric, what, a_rows=None, forced=False):
        """K1 against its plain version, through the configuration its
        wrapper should take, or with the few-column kernel ``forced``."""
        name = K1F if forced or sim_ops._takes_few_columns(a, b.shape[0]) else K1
        before = sim_ops.launch_counts[name]
        if forced:
            got = sim_ops._launch_k1(a, b, metric, a_rows, few=True)
        else:
            got = sim_ops.cross_similarity(a, b, metric, a_rows)
        check(sim_ops.launch_counts[name] == before + 1, f"K1 {what} did not launch {name}")
        compare(name, got, sim_ops.cross_similarity_plain(a, b, metric, a_rows),
                tolerance[metric], f"{metric} {what}")

    for n, m, words in ((1000, 777, 4), (4096, 4096, 64), (3000, 5000, 128)):
        a = torch.from_numpy(random_fps(rng, n, words).view(np.int32)).to(cuda)
        b = torch.from_numpy(random_fps(rng, m, words).view(np.int32)).to(cuda)
        a[::97] = 0
        b[::89] = 0
        for metric in tolerance:
            check_k1(a, b, metric, f"{n}x{m}@{words * 32}")
    # few columns: the counts around M_SKINNY and the sweep's 32 and 64
    # (forced), ragged rows with zero rows, with and without a row list
    # (unsorted, repeated), and a misaligned view that must take the tiles
    few_cases = sorted({1, 2, 7, 8, 9, sim_ops.M_SKINNY, sim_ops.M_SKINNY + 1})
    for words in (4, 64, 128):
        n = 3001
        a = torch.from_numpy(random_fps(rng, n, words, n_centers=8).view(np.int32)).to(cuda)
        a[::97] = 0
        a_rows = torch.from_numpy(rng.integers(0, n, 1777)).to(cuda)
        cases = [(m, False) for m in few_cases] + [(32, True), (64, True)]
        for m, forced in cases:
            b = a[torch.from_numpy(rng.integers(0, n, m)).to(cuda)].clone()
            b[1::5] = 0
            for rows in (None, a_rows):
                for metric in tolerance:
                    check_k1(a, b, metric, f"{n}x{m}@{words * 32} rows={rows is not None}",
                             rows, forced)
        shifted = a.view(-1)[1:1 + (n - 1) * words].view(n - 1, words)
        check_k1(shifted, a[:1], "tanimoto", f"misaligned {n - 1}x1@{words * 32}")
    fps100k = torch.from_numpy(random_fps(rng, 100_000, 64, n_centers=64).view(np.int32)).to(cuda)
    listed = torch.from_numpy(np.sort(rng.choice(100_000, 50_000, replace=False))).to(cuda)
    for r in (1, 57, 1024):
        cols = torch.from_numpy(rng.choice(100_000, r, replace=False)).to(cuda)
        for metric in tolerance:
            for rows in (None, listed):
                want = sim_ops.neighbor_counts_plain(fps100k, cols, 0.5, metric, rows)
                compare(K2, sim_ops.neighbor_counts(fps100k, cols, 0.5, metric, rows), want, 0,
                        f"{metric} 100000x{r} rows={rows is not None}")
                check(int(want.max()) > 0, f"K2 {metric} 100000x{r}: no neighbors at all")
    del fps100k, listed
    x = torch.from_numpy(random_fps(rng, 16384, 64, n_centers=256).view(np.int32)).to(cuda)
    all_cols = torch.arange(16384, device=cuda)
    timing = {
        "k1_ms": median_ms(lambda: sim_ops.cross_similarity(x, x, "tanimoto")),
        "k1_plain_ms": median_ms(lambda: sim_ops.cross_similarity_plain(x, x, "tanimoto")),
        "k2_ms": median_ms(lambda: sim_ops.neighbor_counts(x, all_cols, 0.6)),
        "k2_plain_ms": median_ms(lambda: sim_ops.neighbor_counts_plain(x, all_cols, 0.6)),
    }
    del x, all_cols
    emit(phase="kernels", k1_max_abs_err=errs[K1], k1_few_columns_max_abs_err=errs[K1F],
         k2_max_abs_err=errs[K2], m_skinny=sim_ops.M_SKINNY, timed_shape="16384x16384@2048",
         **timing, seconds=time.perf_counter() - t_phase)

    # 3. the main path ----------------------------------------------------------
    smiles = smoke_smiles()
    fused_fps_host = clustered_fingerprints(FUSED_N, 2048)
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
    clusters, sizes, fused_cent = fused_butina(fused_fps, FUSED_CUTOFF, return_centroids=True)
    t5 = time.perf_counter()
    launches = dict(sim_ops.launch_counts)
    emit(phase="main_path", n_smiles=len(smiles), featurize_s=featurize_s,
         fingerprints_s=t1 - t0, similarity_s=t2 - t1, butina_s=t3 - t2,
         n_clusters=len(centroids), fused_butina_100k_s=t5 - t4,
         fused_n_clusters=len(clusters), launches=launches)

    # 4. checks -------------------------------------------------------------------
    t_phase = time.perf_counter()
    n = len(smiles)
    multi = int((sizes >= 2).sum())  # clusters the fused loop formed
    left = int((sizes == 1).any())   # a K2 decrement follows the last one unless it took every row
    check(launches[K1] == 1, f"K1 tiles launched {launches[K1]} times, want 1 (the matrix)")
    check(launches[K1F] == multi, f"K1 few columns launched {launches[K1F]} times, want {multi}")
    check(launches[K2] == multi + left, f"K2 launched {launches[K2]} times, want {multi + left}")
    for name, t in (("fingerprints", fps.torch()), ("similarity", sim.torch()),
                    ("cluster ids", ids.torch())):
        check(t.is_cuda, f"{name} are not on the GPU")
    check(fps.shape == (n, 64), f"fingerprint shape {fps.shape}")
    s = sim.torch()
    check(s.shape == (n, n) and bool(torch.isfinite(s).all()), "similarity shape/finite")
    check(bool((s.diagonal() == 1).all()), "self-similarity of a non-empty fingerprint is 1")
    # K1's main-path launch itself (24.5k x 24.5k, last row tile partial)
    compare(K1, s, sim_ops.cross_similarity_plain(fps.torch(), fps.torch()),
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
    mat_ids, mat_cent, _ = butina_ops.butina_matrix(s[:8192, :8192] >= thr)
    check(np.array_equal(ids_from_clusters(fused_sub, 8192), mat_ids.cpu().numpy()),
          "fused and matrix Butina ids differ on 8192 fingerprints")
    check(np.array_equal(fused_sub_cent, mat_cent.cpu().numpy()),
          "fused and matrix Butina centroids differ on 8192 fingerprints")

    n_fused = fused_fps.shape[0]
    check(int(sizes.sum()) == n_fused, "fused cluster sizes sum to N")
    # the fused loop again, watched: the free rows each K1 center column and
    # each K2 decrement ran over
    fused_thr = 1.0 - FUSED_CUTOFF
    seen = {"k1_rows": 0, "k2_rows": 0, "clusters": []}
    keep_at = {0, multi // 2, multi - 1}

    def watch(before, center, members, after):
        k = len(seen["clusters"])
        seen["k1_rows"] += before.shape[0]
        seen["k2_rows"] += after.shape[0]
        seen["clusters"].append(None)
        if k in keep_at:
            seen["clusters"][k] = (before.clone(), center, members.clone(), after.clone())

    raw_ids, _, _ = butina_ops.fused_butina(fused_fps, fused_thr, on_cluster=watch)
    check(len(seen["clusters"]) == multi, "the watched fused loop formed other clusters")
    fused_ids = ids_from_clusters(clusters, n_fused)
    check(np.array_equal(raw_ids.cpu().numpy(), fused_ids), "the watched fused loop differs")
    for k in sorted(keep_at):
        before, center, members, after = seen["clusters"][k]
        check(bool((before.diff() > 0).all()) and bool((after.diff() > 0).all()),
              f"cluster {k}: free rows not ascending")
        check(before.shape[0] == after.shape[0] + members.shape[0]
              and bool(torch.isin(members, before).all())
              and not bool(torch.isin(after, members).any()),
              f"cluster {k}: free rows before != members + free rows after")
        col = fused_fps[center:center + 1]
        check_k1(fused_fps, col, "tanimoto", f"main path center column {before.shape[0]}x1",
                 before)
        compare(K2, sim_ops.neighbor_counts(fused_fps, members, fused_thr, rows=after),
                sim_ops.neighbor_counts_plain(fused_fps, members, fused_thr, rows=after), 0,
                f"main path decrement {after.shape[0]}x{members.shape[0]}")
    all_cols = torch.arange(n_fused, device=cuda)
    compare(K2, sim_ops.neighbor_counts(fused_fps, all_cols, fused_thr),
            sim_ops.neighbor_counts_plain(fused_fps, all_cols, fused_thr), 0,
            f"main path counts {n_fused}x{n_fused}")
    check(bool((fused_ids[fused_cent] == np.arange(len(clusters))).all()),
          "each fused centroid lies in its cluster")
    sample = np.random.default_rng(1).choice(n_fused, 2000, replace=False)
    members = torch.from_numpy(sample).to(cuda)
    cents = torch.from_numpy(fused_cent[fused_ids[sample]]).to(cuda)
    pair_sim = sim_ops.cross_similarity(fused_fps[members], fused_fps[cents]).diagonal()
    check(bool((pair_sim >= np.float32(0.4)).all()), "a fused member is farther than the cutoff")
    emit(phase="checks", fused_loop_clusters=multi,
         sum_free_rows_k1=seen["k1_rows"], sum_free_rows_k2=seen["k2_rows"],
         rows_each_without_compaction=multi * n_fused,
         seconds=time.perf_counter() - t_phase)

    # 5. timings at the main path's shapes ------------------------------------------
    t_phase = time.perf_counter()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=cuda)  # 256 MB > the 50 MB L2
    half = torch.from_numpy(np.sort(rng.choice(n_fused, n_fused // 2, replace=False))).to(cuda)
    cols50 = torch.from_numpy(rng.choice(n_fused, 50, replace=False)).to(cuda)
    col = fused_fps[:1]
    x24 = fps.torch()
    measured = []

    def row(name, shape, work, kernel, plain, reps=10, cold=False):
        """Median kernel and plain times; with ``cold``, the kernel's also
        after a write that empties the L2 (its inputs fit there, so the
        back-to-back time reads them from the L2, not at the HBM rate of
        the bound)."""
        entry = {"kernel": name, "shape": shape, "ms": median_ms(kernel, reps),
                 "plain_ms": median_ms(plain, max(3, reps // 3)), "library_ms": None, **work}
        if cold:
            entry["cold_l2_ms"] = median_ms(kernel, reps, flush=flush)
        measured.append(entry)
        return entry

    k1_matrix = row(K1, f"{n}x{n}@2048", k1_work(n, n, 64, False, rates),
                    lambda: sim_ops.cross_similarity(x24, x24),
                    lambda: sim_ops.cross_similarity_plain(x24, x24), reps=5)
    listed = {}
    for rows_list, label in ((None, "all"), (half, "50000 listed")):
        n_rows = n_fused if rows_list is None else rows_list.shape[0]
        listed[K1F] = row(
            K1F, f"{n_rows}x1@2048 ({label})", k1_work(n_rows, 1, 64, rows_list is not None, rates),
            lambda r=rows_list: sim_ops.cross_similarity(fused_fps, col, a_rows=r),
            lambda r=rows_list: sim_ops.cross_similarity_plain(fused_fps, col, a_rows=r),
            cold=True)
        listed[K2] = row(
            K2, f"{n_rows}x50@2048 ({label})", k2_work(n_rows, 50, 64, rows_list is not None, rates),
            lambda r=rows_list: sim_ops.neighbor_counts(fused_fps, cols50, fused_thr, rows=r),
            lambda r=rows_list: sim_ops.neighbor_counts_plain(fused_fps, cols50, fused_thr, rows=r),
            cold=True)
    row(K2, f"{n_fused}x{n_fused}@2048", k2_work(n_fused, n_fused, 64, False, rates),
        lambda: sim_ops.neighbor_counts(fused_fps, all_cols, fused_thr),
        lambda: sim_ops.neighbor_counts_plain(fused_fps, all_cols, fused_thr), reps=3)
    sweep = []
    for m in (1, 8, 16, 32, 64):
        b = fused_fps[:m]
        sweep.append({
            "m": m, "few_columns_ms": median_ms(
                lambda b=b: sim_ops._launch_k1(fused_fps, b, "tanimoto", None, few=True)),
            "tiles_ms": median_ms(
                lambda b=b: sim_ops._launch_k1(fused_fps, b, "tanimoto", None, few=False)),
            **k1_work(n_fused, m, 64, False, rates)})
    del flush
    emit(phase="timings", kernels=measured, m_skinny_sweep=sweep, m_skinny=sim_ops.M_SKINNY,
         seconds=time.perf_counter() - t_phase)

    # 6. where the main path's time goes ----------------------------------------
    state = {"fps": fps, "sim": sim}
    phases = {
        "fingerprints": lambda: state.update(
            fps=gen.GetFingerprintsFromSmiles(smiles, device=cuda)),
        "similarity": lambda: state.update(sim=crossTanimotoSimilarity(state["fps"])),
        "butina": lambda: butina(1.0 - state["sim"].torch(), 0.4, return_centroids=True),
        "fused_butina_100k": lambda: fused_butina(fused_fps, FUSED_CUTOFF, return_centroids=True),
    }
    for name, fn in phases.items():
        emit(phase=f"trace_{name}", **trace(fn))

    # one line per kernel, at the main-path shape that launches it most: the
    # matrix for the tiles; a list of free rows (the loop's average, half of
    # them) for the center columns and the decrements, timed with a cold L2
    # beside their bounds at the HBM rate
    main_shape = {K1: (k1_matrix, "ms"), K1F: (listed[K1F], "cold_l2_ms"),
                  K2: (listed[K2], "cold_l2_ms")}
    sources = {
        K1: ("cross_similarity_kernel (K1, 64 x 64 tiles)", "nvmolkit_tpu/ops/pallas_similarity.py:68"),
        K1F: ("few_columns_kernel (K1, few columns)", "nvmolkit_tpu/ops/pallas_similarity.py:68"),
        K2: ("neighbor_counts_kernel (K2)", "nvmolkit_tpu/ops/butina.py:155"),
    }
    lines = []
    for key, (label, replaces) in sources.items():
        entry, ms_key = main_shape[key]
        lines.append({
            "name": label, "route": "cuda", "source": "nvmolkit_tpu_torch/csrc/similarity.cu",
            "replaces": replaces, "launches": launches[key], "max_abs_err": errs[key],
            "shape": entry["shape"], "ms": entry[ms_key], "l2": "cold" if ms_key != "ms" else "hot",
            "plain_ms": entry["plain_ms"], "bound_ms": entry["bound_ms"],
            "bound_by": entry["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": lines}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
