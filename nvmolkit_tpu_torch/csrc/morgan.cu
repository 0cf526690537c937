// Kernel K14, Morgan fingerprints over a batch of featurized molecules, for
// Hopper (sm_90a).
//
// Replaces the XLA program nvmolkit_tpu/ops/morgan.py morgan_kernel, bit for
// bit (its plain twin is nvmolkit_tpu_torch/ops/morgan.py
// morgan_kernel_plain). One block per molecule, one thread per atom (a
// block-stride loop past 256 atoms), in the shape of nvMolKit's
// morgan_fingerprint_kernels.cu:150-503. Round 0 sets bit inv % fpSize of
// every real atom. Each radius round r then, for every atom:
//   * gathers the neighbors' invariants and sorts the eight (bond code,
//     invariant) pairs in registers as one 64-bit key, empty slots (code
//     256) last;
//   * hashes them onto hash_combine(hash_combine(0, r), inv) with boost's
//     hash_combine in native uint32, over the slots k < degree;
//   * grows its neighborhood, a bond bitset of W words: its own bonds, its
//     previous neighborhood and its neighbors' previous neighborhoods;
// then, for every atom still alive, the duplicate tests: killed by an atom
// alive before this round (an atom killed in this round still kills) with
// the same bitset and a smaller (invariant, atom index) key, or by a
// survivor of any earlier round with the same bitset. Dead atoms keep their
// invariants and bitsets up to date, for their neighbors read them; only
// their bits stop. Survivors atomicOr bit inv % fpSize into the molecule's
// fingerprint in shared memory, written out once at the end.
//
// The TPU program's one-hot matmul gather (sel_u32) is not ported: a
// gather is cheap here.
//
// Shared memory holds the fingerprint words, two invariant buffers, one
// alive flag per atom and round, and every round's bitsets (the earlier
// rounds' for the duplicate tests). Where a shape does not fit (many atoms,
// a large radius), the bitsets live in a global scratch buffer the wrapper
// allocates (nvmk_morgan_scratch_words), the same code over another
// pointer. What bounds K14: its integer work (the hash chains, the ORs, the
// duplicate tests over pairs of alive atoms) against its bytes, the inputs
// read once and the packed rows written once; at the main path's buckets
// the two are of one order, and a molecule's block is short (latency).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K = 8;                       // adjacency slots per atom
constexpr uint32_t EMPTY_CODE = 256u;      // above every bond code: empty slots sort last
constexpr int MAX_THREADS = 256;

__device__ __forceinline__ uint32_t hash_combine(uint32_t seed, uint32_t value) {
  return seed ^ (value + 0x9e3779b9u + (seed << 6) + (seed >> 2));
}

__device__ __forceinline__ bool words_equal(const uint32_t* a, const uint32_t* b, int w) {
  for (int k = 0; k < w; ++k) {
    if (a[k] != b[k]) return false;
  }
  return true;
}

__device__ __forceinline__ void set_bit(uint32_t* fp, uint32_t inv, uint32_t fp_size) {
  const uint32_t bit = inv % fp_size;
  atomicOr(fp + bit / 32, 1u << (bit % 32));
}

// Shared-memory bytes of one molecule's block, without (hist_in_shared
// false) or with its rounds' bitsets.
__host__ __device__ size_t smem_bytes(int a, int w, int radius, int fp_words,
                                      bool hist_in_shared) {
  size_t words = (size_t)fp_words + 2 * (size_t)a;
  if (hist_in_shared) words += (size_t)radius * a * w;
  return 4 * words + (((size_t)(radius + 1) * a + 3) / 4) * 4;
}

template <typename Idx>
__global__ void __launch_bounds__(MAX_THREADS)
morgan_kernel(const uint32_t* __restrict__ inv0, const Idx* __restrict__ adj_atoms,
              const uint8_t* __restrict__ adj_code, const bool* __restrict__ adj_mask,
              const uint32_t* __restrict__ own_bits, const bool* __restrict__ atom_mask,
              const uint8_t* __restrict__ degree, int a, int w, int radius, int fp_size,
              uint32_t* __restrict__ hist_global, uint32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int fp_words = fp_size / 32;
  const size_t mol = blockIdx.x;
  const size_t round_words = (size_t)a * w;
  uint32_t* fp = smem;
  uint32_t* inv_a = fp + fp_words;
  uint32_t* inv_b = inv_a + a;
  // hist + (r - 1) * round_words: the bitsets of round r
  uint32_t* hist = hist_global ? hist_global + mol * radius * round_words : inv_b + a;
  // flags + r * a: alive after round r (flags[0..a): alive before round 1)
  uint8_t* flags = reinterpret_cast<uint8_t*>(hist_global ? inv_b + a
                                                          : inv_b + a + radius * round_words);
  const size_t at = mol * a;
  const uint32_t fps = (uint32_t)fp_size;

  for (int q = threadIdx.x; q < fp_words; q += blockDim.x) fp[q] = 0u;
  __syncthreads();
  for (int i = threadIdx.x; i < a; i += blockDim.x) {
    const uint32_t v = inv0[at + i];
    inv_a[i] = v;
    flags[i] = atom_mask[at + i] && degree[at + i] > 0;
    if (atom_mask[at + i]) set_bit(fp, v, fps);
  }
  __syncthreads();

  for (int r = 1; r <= radius; ++r) {
    const uint32_t* inv = (r & 1) ? inv_a : inv_b;
    uint32_t* nxt = (r & 1) ? inv_b : inv_a;
    const uint32_t* nbr = r > 1 ? hist + (r - 2) * round_words : nullptr;
    uint32_t* nbr_new = hist + (r - 1) * round_words;
    const uint8_t* alive = flags + (size_t)(r - 1) * a;
    uint8_t* survivors = flags + (size_t)r * a;

    // the next invariants and the grown neighborhoods, of every atom
    for (int i = threadIdx.x; i < a; i += blockDim.x) {
      const size_t slot0 = (at + i) * K;
      uint64_t key[K];
      int nb[K];
      bool used[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        nb[k] = (int)adj_atoms[slot0 + k];
        used[k] = adj_mask[slot0 + k];
        const uint32_t code = used[k] ? (uint32_t)adj_code[slot0 + k] : EMPTY_CODE;
        key[k] = ((uint64_t)code << 32) | inv[nb[k]];
      }
#pragma unroll
      for (int k = 1; k < K; ++k) {  // insertion sort, ascending
#pragma unroll
        for (int m = k; m > 0; --m) {
          const uint64_t lo = key[m - 1], hi = key[m];
          key[m - 1] = lo < hi ? lo : hi;
          key[m] = lo < hi ? hi : lo;
        }
      }
      const int deg = degree[at + i];
      uint32_t seed = hash_combine(hash_combine(0u, (uint32_t)r), inv[i]);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k < deg) {
          seed = hash_combine(hash_combine(seed, (uint32_t)(key[k] >> 32)), (uint32_t)key[k]);
        }
      }
      nxt[i] = (atom_mask[at + i] && deg > 0) ? seed : inv[i];

      const uint32_t* own = own_bits + (at + i) * w;
      for (int q = 0; q < w; ++q) {
        uint32_t v = own[q];
        if (nbr) {
          v |= nbr[(size_t)i * w + q];
#pragma unroll
          for (int k = 0; k < K; ++k) {
            if (used[k]) v |= nbr[(size_t)nb[k] * w + q];
          }
        }
        nbr_new[(size_t)i * w + q] = v;
      }
    }
    __syncthreads();

    // the duplicate tests of the atoms alive before this round
    for (int i = threadIdx.x; i < a; i += blockDim.x) {
      bool survives = false;
      if (alive[i]) {
        const uint32_t ki = nxt[i];
        const uint32_t* bits = nbr_new + (size_t)i * w;
        bool dead = false;
        for (int j = 0; j < a && !dead; ++j) {
          const uint32_t kj = nxt[j];
          if (j != i && alive[j] && (kj < ki || (kj == ki && j < i))) {
            dead = words_equal(bits, nbr_new + (size_t)j * w, w);
          }
        }
        for (int rr = 1; rr < r && !dead; ++rr) {
          const uint8_t* ok = flags + (size_t)rr * a;
          const uint32_t* prev = hist + (rr - 1) * round_words;
          for (int j = 0; j < a && !dead; ++j) {
            if (ok[j]) dead = words_equal(bits, prev + (size_t)j * w, w);
          }
        }
        survives = !dead;
        if (survives) set_bit(fp, ki, fps);
      }
      survivors[i] = survives;
    }
    __syncthreads();
  }

  for (int q = threadIdx.x; q < fp_words; q += blockDim.x) out[mol * fp_words + q] = fp[q];
}

int max_shared_bytes() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 48 * 1024;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) {
    return 48 * 1024;
  }
  return bytes;
}

template <typename Idx>
cudaError_t launch(const void* inv0, const void* adj_atoms, const void* adj_code,
                   const void* adj_mask, const void* own_bits, const void* atom_mask,
                   const void* degree, int b, int a, int w, int radius, int fp_size,
                   void* scratch, void* out, cudaStream_t s) {
  const size_t smem = smem_bytes(a, w, radius, fp_size / 32, scratch == nullptr);
  auto* kernel = morgan_kernel<Idx>;
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)smem);
    if (rc != cudaSuccess) return rc;
  }
  int threads = (a + 31) / 32 * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  kernel<<<b, threads, smem, s>>>(
      static_cast<const uint32_t*>(inv0), static_cast<const Idx*>(adj_atoms),
      static_cast<const uint8_t*>(adj_code), static_cast<const bool*>(adj_mask),
      static_cast<const uint32_t*>(own_bits), static_cast<const bool*>(atom_mask),
      static_cast<const uint8_t*>(degree), a, w, radius, fp_size,
      static_cast<uint32_t*>(scratch), static_cast<uint32_t*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// 32-bit words of global scratch per molecule that nvmk_morgan needs for the
// rounds' bitsets: 0 when they fit in shared memory with the rest.
long long nvmk_morgan_scratch_words(int a, int w, int radius, int fp_size) {
  if (smem_bytes(a, w, radius, fp_size / 32, true) <= (size_t)max_shared_bytes()) return 0;
  return (long long)radius * a * w;
}

// out [b, fp_size / 32] = the packed Morgan fingerprints of b molecules of a
// atoms (padded), K = 8 adjacency slots, W bitset words: inv0 uint32 [b, a],
// adj_atoms [b, a, 8] uint8 (idx_bytes 1) or int32 (idx_bytes 4), adj_code
// uint8 [b, a, 8], adj_mask bool [b, a, 8], own_bits uint32 [b, a, w],
// atom_mask bool [b, a], degree uint8 [b, a]. scratch: null, or
// b * nvmk_morgan_scratch_words(...) words. Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for an index width other than 1 or 4.
int nvmk_morgan(const void* inv0, const void* adj_atoms, int idx_bytes, const void* adj_code,
                const void* adj_mask, const void* own_bits, const void* atom_mask,
                const void* degree, int b, int a, int w, int radius, int fp_size, void* scratch,
                void* out, void* stream) {
  if (b <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx_bytes == 1) {
    return (int)launch<uint8_t>(inv0, adj_atoms, adj_code, adj_mask, own_bits, atom_mask, degree,
                                b, a, w, radius, fp_size, scratch, out, s);
  }
  if (idx_bytes == 4) {
    return (int)launch<int32_t>(inv0, adj_atoms, adj_code, adj_mask, own_bits, atom_mask, degree,
                                b, a, w, radius, fp_size, scratch, out, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
