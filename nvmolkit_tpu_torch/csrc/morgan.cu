// Kernel K14, Morgan fingerprints over a batch of featurized molecules, for
// Hopper (sm_90a).
//
// Replaces the XLA program nvmolkit_tpu/ops/morgan.py morgan_kernel, bit for
// bit (its plain twin is nvmolkit_tpu_torch/ops/morgan.py
// morgan_kernel_plain). Round 0 sets bit inv % fpSize of every real atom.
// Each radius round r then, for every atom:
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
// Two layouts, the same rounds:
//   * half a warp per molecule up to 16 atoms, a warp up to 32
//     (morgan_warp_kernel; bitsets of at most two words), WARP_MOLS warps a
//     block, a lane per atom: the invariants, bitsets and alive flags live
//     in registers, the neighbors' come by shuffles, the same round's
//     duplicates by __match_any_sync, earlier rounds' by one lookup in a set
//     of their survivors' bitsets, and __syncwarp stands where the block
//     layout has a block barrier; each molecule keeps its own slice of
//     shared memory for that set and its fingerprint words. The main path's
//     molecules have 16-32 atoms: a block of one warp per molecule left half
//     of each SM's warp slots empty (32 blocks an SM at most), and each
//     atom's duplicate test looped over every atom of every round;
//   * a block per molecule (morgan_kernel) past 32 atoms (or wider
//     bitsets), one thread per atom (a block-stride loop past 256 atoms),
//     in the shape of nvMolKit's morgan_fingerprint_kernels.cu:150-503.
//
// The TPU program's one-hot matmul gather (sel_u32) is not ported: a
// gather is cheap here.
//
// In the block layout, shared memory holds the fingerprint words, the
// invariants, one alive flag per atom and round, and every round's bitsets
// (the earlier rounds' for the duplicate tests). Where a shape does not fit
// (many atoms, a large radius), the bitsets live in a global scratch buffer
// the wrapper allocates (nvmk_morgan_scratch_words), the same code over
// another pointer. What bounds K14: its integer work (the hash chains, the
// ORs, the duplicate tests) against its bytes, the inputs read once and the
// packed rows written once; at the main path's buckets the two are of one
// order, and a molecule's rounds are short (latency): the warp layout keeps
// more molecules in flight and issues fewer instructions a molecule.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K = 8;                       // adjacency slots per atom
constexpr uint32_t EMPTY_CODE = 256u;      // above every bond code: empty slots sort last
constexpr int MAX_THREADS = 256;
constexpr int WARP_ATOMS = 32;             // the warp layout's largest bucket
constexpr int WARP_MOLS = 8;               // warps a block in the warp layout
constexpr unsigned FULL = 0xffffffffu;

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

// sorts an atom's K (code << 32 | invariant) keys ascending and hashes the
// first ``deg`` onto hash_combine(hash_combine(0, r), inv)
__device__ __forceinline__ uint32_t round_seed(uint64_t (&key)[K], int deg, int r, uint32_t inv) {
#pragma unroll
  for (int k = 1; k < K; ++k) {  // insertion sort, ascending
#pragma unroll
    for (int m = k; m > 0; --m) {
      const uint64_t lo = key[m - 1], hi = key[m];
      key[m - 1] = lo < hi ? lo : hi;
      key[m] = lo < hi ? hi : lo;
    }
  }
  uint32_t seed = hash_combine(hash_combine(0u, (uint32_t)r), inv);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k < deg) seed = hash_combine(hash_combine(seed, (uint32_t)(key[k] >> 32)), (uint32_t)key[k]);
  }
  return seed;
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
      const int deg = degree[at + i];
      const uint32_t seed = round_seed(key, deg, r, inv[i]);
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

// Slots of a molecule's set of earlier survivors' bitsets in the warp
// layout (a power of two, at least twice the a (radius - 1) bitsets put in
// it; none when no round has an earlier one), and the 32-bit words of its
// slice of shared memory: the set (64-bit slots), then its fingerprint.
__host__ __device__ int warp_table_slots(int a, int radius) {
  int slots = 0;
  if (radius > 1)
    for (slots = 32; slots < 2 * a * (radius - 1); slots *= 2) {
    }
  return slots;
}
__host__ __device__ size_t warp_slice_words(int a, int radius, int fp_words) {
  return 2 * (size_t)warp_table_slots(a, radius) + ((size_t)fp_words + 1) / 2 * 2;
}

// the set of bitsets: open addressing over 64-bit keys (a bitset of at most
// two words; an alive atom's is never 0, the empty slot)
__device__ __forceinline__ unsigned slot_of(unsigned long long key) {
  return (unsigned)((key * 0x9E3779B97F4A7C15ull) >> 32);
}
__device__ void set_insert(unsigned long long* set, unsigned mask, unsigned long long key) {
  for (unsigned h = slot_of(key) & mask;; h = (h + 1) & mask) {
    const unsigned long long prev = atomicCAS(set + h, 0ull, key);
    if (prev == 0ull || prev == key) return;
  }
}
__device__ bool set_has(const unsigned long long* set, unsigned mask, unsigned long long key) {
  for (unsigned h = slot_of(key) & mask;; h = (h + 1) & mask) {
    if (set[h] == key) return true;
    if (set[h] == 0ull) return false;
  }
}

// The warp layout: G lanes a molecule (16 up to 16 atoms, else 32), 32 / G
// molecules a warp, WARP_MOLS warps a block, atom i on the group's lane i,
// its bitset (w <= 2 words) in registers; the same rounds as morgan_kernel.
// The neighbors' invariants and bitsets come by shuffles. The duplicate
// tests are the group's: the atoms with the bitset of atom i are found by
// __match_any_sync (no loop over the atoms) and their keys read by shuffles;
// the survivors of earlier rounds are a set of bitsets in shared memory,
// looked up once. A round with no atom alive in the warp sets no bit, nor
// does any after it.
template <int G, typename Idx>
__global__ void __launch_bounds__(WARP_MOLS * 32)
morgan_warp_kernel(const uint32_t* __restrict__ inv0, const Idx* __restrict__ adj_atoms,
                   const uint8_t* __restrict__ adj_code, const bool* __restrict__ adj_mask,
                   const uint32_t* __restrict__ own_bits, const bool* __restrict__ atom_mask,
                   const uint8_t* __restrict__ degree, int b, int a, int w, int radius,
                   int fp_size, uint32_t* __restrict__ out) {
  extern __shared__ unsigned long long smem64[];
  constexpr int PER_WARP = 32 / G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane / G, li = lane % G;
  const size_t first = ((size_t)blockIdx.x * WARP_MOLS + warp) * PER_WARP;
  if (first >= (size_t)b) return;  // a whole warp: no block barrier follows
  const size_t mol = first + sub;
  const bool valid = mol < (size_t)b;  // the warp's last group may hold none
  const unsigned group = G == 32 ? FULL : ((1u << (G % 32)) - 1) << (sub * G);
  auto local = [&](unsigned m) { return G == 32 ? m : (m & group) >> (sub * G); };
  const int fp_words = fp_size / 32;
  const int slots = warp_table_slots(a, radius);
  unsigned long long* set =
      smem64 + (warp * PER_WARP + sub) * warp_slice_words(a, radius, fp_words) / 2;
  uint32_t* fp = reinterpret_cast<uint32_t*>(set + slots);
  const size_t at = (valid ? mol : 0) * a;
  const uint32_t fps = (uint32_t)fp_size;
  const bool atom = valid && li < a;
  const int i = atom ? li : 0;

  const bool real = atom && atom_mask[at + i];
  const int deg = atom ? degree[at + i] : 0;
  uint32_t inv = atom ? inv0[at + i] : 0u;
  bool alive = real && deg > 0;
  int nb[K];
  bool used[K];
  uint32_t code[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const size_t slot = (at + i) * K + k;
    nb[k] = atom ? (int)adj_atoms[slot] : 0;
    used[k] = atom && adj_mask[slot];
    code[k] = used[k] ? (uint32_t)adj_code[slot] : EMPTY_CODE;
  }
  const uint32_t own0 = atom ? own_bits[(at + i) * w] : 0u;
  const uint32_t own1 = atom && w > 1 ? own_bits[(at + i) * w + 1] : 0u;
  uint32_t bits0 = 0u, bits1 = 0u;  // the last round's neighborhood
  if (valid) {
    for (int q = li; q < fp_words; q += G) fp[q] = 0u;
    for (int q = li; q < slots; q += G) set[q] = 0ull;
  }
  __syncwarp();
  if (real) set_bit(fp, inv, fps);

  for (int r = 1; r <= radius; ++r) {
    const unsigned alive_warp = __ballot_sync(FULL, alive);
    if (alive_warp == 0u) break;  // no atom sets a bit this round or later
    uint64_t key[K];
    uint32_t n0 = own0, n1 = own1;  // own bonds | last self | last neighbors
    if (r > 1) {
      n0 |= bits0;
      n1 |= bits1;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      key[k] = ((uint64_t)code[k] << 32) | __shfl_sync(FULL, inv, nb[k], G);
      const uint32_t s0 = __shfl_sync(FULL, bits0, nb[k], G);
      const uint32_t s1 = __shfl_sync(FULL, bits1, nb[k], G);
      if (used[k] && r > 1) {
        n0 |= s0;
        n1 |= s1;
      }
    }
    const uint32_t seed = round_seed(key, deg, r, inv);
    const uint32_t nxt = real && deg > 0 ? seed : inv;
    const unsigned long long hood = ((unsigned long long)n1 << 32) | n0;

    // this round: the group's alive atoms with my bitset, and their keys
    const unsigned same = local(alive_warp) & local(__match_any_sync(FULL, hood));
    unsigned rest = alive ? same & ~(1u << li) : 0u;
    bool dead = false;
    const unsigned trips = __reduce_max_sync(FULL, (unsigned)__popc(rest));
    for (unsigned t = 0; t < trips; ++t) {
      const int j = rest ? __ffs(rest) - 1 : li;
      rest &= rest - 1;
      const uint32_t kj = __shfl_sync(FULL, nxt, j, G);
      if (j != li && (kj < nxt || (kj == nxt && j < li))) dead = true;
    }
    // earlier rounds: the set of their survivors' bitsets
    if (alive && !dead && r > 1) dead = set_has(set, slots - 1, hood);
    const bool survives = alive && !dead;
    __syncwarp();  // every lookup of this round before its survivors join the set
    if (survives) {
      set_bit(fp, nxt, fps);
      if (r < radius) set_insert(set, slots - 1, hood);
    }
    alive = survives;
    inv = nxt;
    bits0 = n0;
    bits1 = n1;
    __syncwarp();
  }

  __syncwarp();  // round 0's bits when no round ran
  if (valid)
    for (int q = li; q < fp_words; q += G) out[mol * fp_words + q] = fp[q];
}

int max_shared_bytes() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 48 * 1024;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) {
    return 48 * 1024;
  }
  return bytes;
}

// molecules a block in the warp layout, and its shared-memory bytes
int warp_block_mols(int a) { return WARP_MOLS * (a <= 16 ? 2 : 1); }
size_t warp_block_bytes(int a, int radius, int fp_size) {
  return 4 * warp_block_mols(a) * warp_slice_words(a, radius, fp_size / 32);
}

// whether molecules of ``a`` atoms take the warp layout: a <= 32, bitsets
// of at most two words, and a block's slices fit in its shared memory
bool warp_layout(int a, int w, int radius, int fp_size) {
  return a <= WARP_ATOMS && w <= 2 &&
         warp_block_bytes(a, radius, fp_size) <= (size_t)max_shared_bytes();
}

template <int G, typename Idx>
cudaError_t launch_warp(const void* inv0, const void* adj_atoms, const void* adj_code,
                        const void* adj_mask, const void* own_bits, const void* atom_mask,
                        const void* degree, int b, int a, int w, int radius, int fp_size,
                        void* out, cudaStream_t s) {
  const size_t smem = warp_block_bytes(a, radius, fp_size);
  auto* kernel = morgan_warp_kernel<G, Idx>;
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)smem);
    if (rc != cudaSuccess) return rc;
  }
  const int per_block = warp_block_mols(a);
  kernel<<<(b + per_block - 1) / per_block, WARP_MOLS * 32, smem, s>>>(
      static_cast<const uint32_t*>(inv0), static_cast<const Idx*>(adj_atoms),
      static_cast<const uint8_t*>(adj_code), static_cast<const bool*>(adj_mask),
      static_cast<const uint32_t*>(own_bits), static_cast<const bool*>(atom_mask),
      static_cast<const uint8_t*>(degree), b, a, w, radius, fp_size, static_cast<uint32_t*>(out));
  return cudaGetLastError();
}

template <typename Idx>
cudaError_t launch(const void* inv0, const void* adj_atoms, const void* adj_code,
                   const void* adj_mask, const void* own_bits, const void* atom_mask,
                   const void* degree, int b, int a, int w, int radius, int fp_size,
                   void* scratch, void* out, cudaStream_t s) {
  if (warp_layout(a, w, radius, fp_size)) {
    if (scratch != nullptr) return cudaErrorInvalidValue;
    return a <= 16 ? launch_warp<16, Idx>(inv0, adj_atoms, adj_code, adj_mask, own_bits,
                                          atom_mask, degree, b, a, w, radius, fp_size, out, s)
                   : launch_warp<32, Idx>(inv0, adj_atoms, adj_code, adj_mask, own_bits,
                                          atom_mask, degree, b, a, w, radius, fp_size, out, s);
  }
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

// 1 when nvmk_morgan takes molecules of a atoms in the warp layout (half a
// warp or a warp per molecule), 0 when in the block layout
int nvmk_morgan_warp_layout(int a, int w, int radius, int fp_size) {
  return warp_layout(a, w, radius, fp_size) ? 1 : 0;
}

// 32-bit words of global scratch per molecule that nvmk_morgan needs for the
// rounds' bitsets: 0 when they fit in shared memory with the rest (always
// in the warp layout).
long long nvmk_morgan_scratch_words(int a, int w, int radius, int fp_size) {
  if (warp_layout(a, w, radius, fp_size) ||
      smem_bytes(a, w, radius, fp_size / 32, true) <= (size_t)max_shared_bytes())
    return 0;
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
