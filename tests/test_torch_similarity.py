"""nvmolkit_tpu_torch similarity against the JAX package, on the CPU.

The same fingerprints, made with numpy from a seed, go through both
packages (via ``nvmolkit_tpu_torch.interop``). Tolerances: Tanimoto is
exactly equal (integer counts, one IEEE float32 division); cosine agrees
within 1e-6 absolute (float32 square root and division may round
differently in the two frameworks).
"""
import numpy as np
import pytest
import torch

from nvmolkit_tpu.ops.packed_bits import popcount_rows as jax_popcount_rows
from nvmolkit_tpu.ops.pallas_similarity import cross_tanimoto_pallas
from nvmolkit_tpu.ops.similarity import cross_similarity as jax_cross_similarity
from nvmolkit_tpu.ops.similarity import cross_similarity_cpu
from nvmolkit_tpu.similarity import crossCosineSimilarity as jax_cosine
from nvmolkit_tpu.similarity import crossTanimotoSimilarity as jax_tanimoto
from nvmolkit_tpu_torch import similarity as port
from nvmolkit_tpu_torch.interop import fps_from_reference, fps_to_reference
from nvmolkit_tpu_torch.ops import packed_bits as port_bits
from nvmolkit_tpu_torch.ops import similarity as port_ops
from nvmolkit_tpu_torch.types import AsyncResult

COSINE_ATOL = 1e-6


def _fps(seed, n, n_bits, zero_rows=(0,)):
    """Sparse random packed fingerprints with some all-zero rows."""
    rng = np.random.default_rng(seed)
    words = n_bits // 32
    x = rng.integers(0, 2**32, (n, words), dtype=np.uint64).astype(np.uint32)
    x &= rng.integers(0, 2**32, (n, words), dtype=np.uint64).astype(np.uint32)
    x &= rng.integers(0, 2**32, (n, words), dtype=np.uint64).astype(np.uint32)
    x[[r for r in zero_rows if r < n]] = 0
    return x


def _assert_close(got, want, metric):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    if metric == "tanimoto":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=COSINE_ATOL)


SHAPES = [(37, 53, 128), (64, 17, 256), (101, 99, 1024), (50, 70, 2048), (20, 300, 4096)]


@pytest.mark.parametrize("metric", ["tanimoto", "cosine"])
@pytest.mark.parametrize("n,m,n_bits", SHAPES)
def test_cross_similarity_matches_jax(metric, n, m, n_bits):
    a = _fps(n * 1000 + n_bits, n, n_bits, zero_rows=(0, 5))
    b = _fps(m * 1000 + n_bits + 1, m, n_bits, zero_rows=(m - 1,))
    got = port_ops.cross_similarity(fps_from_reference(a), fps_from_reference(b), metric)
    want = jax_cross_similarity(a, b, metric=metric)
    _assert_close(got.numpy(), want, metric)


@pytest.mark.parametrize("n,m,n_bits", [(256, 128, 512), (128, 384, 2048)])
def test_tanimoto_matches_pallas_kernel(n, m, n_bits):
    """The TPU kernel K1 replaces, run in interpret mode as the JAX
    package's own test runs it."""
    a = _fps(n + n_bits, n, n_bits, zero_rows=(3,))
    b = _fps(m + n_bits + 7, m, n_bits, zero_rows=(0, 1))
    want = np.asarray(cross_tanimoto_pallas(a, b, block=128, interpret=True))
    got = port_ops.cross_similarity(fps_from_reference(a), fps_from_reference(b), "tanimoto")
    _assert_close(got.numpy(), want, "tanimoto")


@pytest.mark.parametrize("api", ["tanimoto", "cosine"])
@pytest.mark.parametrize("second", [False, True])
@pytest.mark.parametrize("as_int32", [False, True])
def test_public_api_matches_jax(api, second, as_int32):
    a = _fps(11, 45, 1024)
    b = _fps(12, 33, 1024) if second else None
    port_fn = port.crossTanimotoSimilarity if api == "tanimoto" else port.crossCosineSimilarity
    jax_fn = jax_tanimoto if api == "tanimoto" else jax_cosine
    conv = (lambda x: x.view(np.int32)) if as_int32 else (lambda x: x)
    got = port_fn(conv(a), None if b is None else conv(b), device="cpu")
    want = jax_fn(conv(a), None if b is None else conv(b)).numpy()
    assert got.device == torch.device("cpu")
    _assert_close(got.numpy(), want, api)


def test_public_api_takes_tensors_and_async_results():
    a = _fps(13, 30, 512)
    t = fps_from_reference(a)
    want = port.crossTanimotoSimilarity(a, device="cpu").numpy()
    np.testing.assert_array_equal(port.crossTanimotoSimilarity(t).numpy(), want)
    np.testing.assert_array_equal(port.crossTanimotoSimilarity(t.view(torch.uint32)).numpy(), want)
    wrapped = AsyncResult(t, numpy_dtype=np.uint32)
    np.testing.assert_array_equal(port.crossTanimotoSimilarity(wrapped).numpy(), want)
    np.testing.assert_array_equal(wrapped.numpy(), a)


@pytest.mark.parametrize("metric", ["tanimoto", "cosine"])
@pytest.mark.parametrize("max_bytes", [1 << 12, 2 << 30])
def test_memory_constrained_matches_cpu_oracle(metric, max_bytes):
    a = _fps(21, 77, 2048, zero_rows=(2,))
    b = _fps(22, 40, 2048)
    fn = (port.crossTanimotoSimilarityMemoryConstrained if metric == "tanimoto"
          else port.crossCosineSimilarityMemoryConstrained)
    got = fn(a, b, maxDeviceMemoryBytes=max_bytes, device="cpu")
    assert isinstance(got, np.ndarray)
    want = cross_similarity_cpu(a, b, metric)
    # float64 oracle rounded once to float32 equals the float32 division
    _assert_close(got, want.astype(np.float32), metric)
    _assert_close(fn(a, maxDeviceMemoryBytes=max_bytes, device="cpu"), cross_similarity_cpu(a, a, metric)
                  .astype(np.float32), metric)


@pytest.mark.parametrize("metric", ["tanimoto", "cosine"])
@pytest.mark.parametrize("threshold", [0.0, 0.2, 0.35, 1.0])
def test_neighbor_counts_plain_matches_thresholded_jax(metric, threshold):
    rng = np.random.default_rng(31)
    base = _fps(32, 8, 256)
    x = base[rng.integers(0, 8, 150)] ^ (_fps(33, 150, 256) & _fps(34, 150, 256))
    x[4] = 0
    cols = np.array([0, 4, 17, 149, 17])
    sim = np.asarray(jax_cross_similarity(x, x[cols], metric=metric))
    want = (sim >= np.float32(threshold)).sum(axis=1)
    t = fps_from_reference(x)
    got = port_ops.neighbor_counts(t, torch.from_numpy(cols), threshold, metric)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # one column: the counts are that column's decisions, as fused Butina
    # takes them from cross_similarity
    counts = port_ops.neighbor_counts(t, torch.tensor([17]), threshold, metric)
    hits = port_ops.cross_similarity(t, t[17:18], metric)[:, 0] >= np.float32(threshold)
    np.testing.assert_array_equal(hits.numpy(), sim[:, 2] >= np.float32(threshold))
    np.testing.assert_array_equal(counts.numpy(), hits.numpy().astype(np.int32))


@pytest.mark.parametrize("block", [7, 64, 4096])
def test_neighbor_counts_plain_tiles_agree(monkeypatch, block):
    """The plain counts are summed over row and column tiles; the tile size
    must not change them (ragged last tiles, repeated columns)."""
    rng = np.random.default_rng(35)
    x = _fps(36, 6, 512)[rng.integers(0, 6, 90)] ^ (_fps(37, 90, 512) & _fps(38, 90, 512))
    x[3] = 0
    t = fps_from_reference(x)
    cols = torch.from_numpy(rng.integers(0, 90, 75))
    sim = np.asarray(jax_cross_similarity(x, x[cols.numpy()], metric="tanimoto"))
    monkeypatch.setattr(port_ops, "_PLAIN_BLOCK", block)
    got = port_ops.neighbor_counts_plain(t, cols, 0.3)
    np.testing.assert_array_equal(got.numpy(), (sim >= np.float32(0.3)).sum(axis=1))


@pytest.mark.parametrize("n_bits", [128, 2048, 4096])
def test_packed_bits_match_jax(n_bits):
    x = _fps(41 + n_bits, 25, n_bits, zero_rows=(1,))
    x[0] = 0xFFFFFFFF
    t = fps_from_reference(x)
    np.testing.assert_array_equal(
        port_bits.popcount_rows(t).numpy(), np.asarray(jax_popcount_rows(x))
    )
    bits = port_bits.unpack_bits(t, dtype=torch.uint8)
    np.testing.assert_array_equal(bits.numpy(), port_bits.unpack_bits_np(x))
    np.testing.assert_array_equal(fps_to_reference(port_bits.pack_bits(bits)), x)
    np.testing.assert_array_equal(port_bits.pack_bits_np(port_bits.unpack_bits_np(x)), x)


def test_interop_round_trip_is_bit_exact():
    x = _fps(51, 10, 256)
    x[0, 0], x[1, 1] = 0xFFFFFFFF, 0x80000000
    t = fps_from_reference(x)
    assert t.dtype == torch.int32 and t.device == torch.device("cpu")
    out = fps_to_reference(t)
    assert out.dtype == np.uint32
    np.testing.assert_array_equal(out, x)


def test_input_validation():
    with pytest.raises(ValueError):
        port.crossTanimotoSimilarity(np.zeros((3, 4, 5), dtype=np.uint32), device="cpu")
    with pytest.raises(ValueError):
        port.crossTanimotoSimilarity(np.zeros((3, 4), dtype=np.float32), device="cpu")
    with pytest.raises(ValueError):
        port_ops.cross_similarity(torch.zeros((3, 4), dtype=torch.int32),
                                  torch.zeros((3, 4), dtype=torch.int32), "dice")
    with pytest.raises(ValueError):
        port_ops.cross_similarity(torch.zeros((3, 4), dtype=torch.int32),
                                  torch.zeros((3, 8), dtype=torch.int32))
    with pytest.raises(TypeError):
        port.crossTanimotoSimilarity(np.zeros((3, 4), dtype=np.uint32), stream=object(),
                                     device="cpu")


# column counts around K1's few-column limit (its configuration changes
# there on the card; on the CPU every count takes the plain version)
FEW_M = sorted({1, 2, 7, 8, 9, port_ops.M_SKINNY, port_ops.M_SKINNY + 1})


@pytest.mark.parametrize("n_bits", [128, 2048, 4096])
@pytest.mark.parametrize("m", FEW_M)
def test_few_columns_and_row_list_match_jax(m, n_bits):
    """Few columns of B, over all rows of A and over an unsorted list of
    its rows with repeats, against the JAX package on the gathered rows."""
    a = _fps(70 + m + n_bits, 77, n_bits, zero_rows=(0, 40))
    b = _fps(71 + m + n_bits, m, n_bits, zero_rows=(m - 1,) if m > 2 else ())
    rows = np.random.default_rng(m).integers(0, 77, 53)
    ta, tb = fps_from_reference(a), fps_from_reference(b)
    for metric in ("tanimoto", "cosine"):
        got = port_ops.cross_similarity(ta, tb, metric)
        _assert_close(got.numpy(), jax_cross_similarity(a, b, metric=metric), metric)
        got = port_ops.cross_similarity(ta, tb, metric, a_rows=torch.from_numpy(rows))
        assert got.shape == (53, m)
        _assert_close(got.numpy(), jax_cross_similarity(a[rows], b, metric=metric), metric)


@pytest.mark.parametrize("m", FEW_M)
def test_row_list_matches_pallas_kernel(m):
    """The gathered few-column product against the TPU kernel K1 replaces,
    in interpret mode, on zero-padded blocks."""
    block = 128
    a = _fps(90 + m, 200, 2048, zero_rows=(7,))
    b = _fps(91 + m, m, 2048)
    rows = np.random.default_rng(90 + m).permutation(200)[:block - 3]
    pad = lambda x: np.concatenate([x, np.zeros((block - len(x), x.shape[1]), np.uint32)])
    want = np.asarray(cross_tanimoto_pallas(pad(a[rows]), pad(b), block=block, interpret=True))
    got = port_ops.cross_similarity(fps_from_reference(a), fps_from_reference(b), "tanimoto",
                                    a_rows=torch.from_numpy(rows))
    _assert_close(got.numpy(), want[:len(rows), :m], "tanimoto")


@pytest.mark.parametrize("metric", ["tanimoto", "cosine"])
@pytest.mark.parametrize("threshold", [0.0, 0.3, 1.0])
def test_neighbor_counts_row_list_equals_indexed_counts(metric, threshold):
    rng = np.random.default_rng(61)
    x = _fps(62, 6, 512)[rng.integers(0, 6, 120)] ^ (_fps(63, 120, 512) & _fps(64, 120, 512))
    x[9] = 0
    t = fps_from_reference(x)
    cols = torch.from_numpy(rng.integers(0, 120, 40))
    rows = torch.from_numpy(np.sort(rng.choice(120, 70, replace=False)))
    full = port_ops.neighbor_counts(t, cols, threshold, metric)
    got = port_ops.neighbor_counts(t, cols, threshold, metric, rows=rows)
    assert got.dtype == torch.int32 and got.shape == (70,)
    np.testing.assert_array_equal(got.numpy(), full[rows].numpy())
    np.testing.assert_array_equal(
        port_ops.neighbor_counts_plain(t, cols, threshold, metric, rows).numpy(), got.numpy())
    sim = np.asarray(jax_cross_similarity(x[rows.numpy()], x[cols.numpy()], metric=metric))
    np.testing.assert_array_equal(got.numpy(), (sim >= np.float32(threshold)).sum(axis=1))


def test_row_lists_are_validated():
    t = torch.zeros((5, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        port_ops.cross_similarity(t, t[:1], a_rows=torch.tensor([0, 1], dtype=torch.int32))
    with pytest.raises(ValueError):
        port_ops.neighbor_counts(t, torch.tensor([0]), 0.5, rows=torch.zeros((2, 1), dtype=torch.int64))
