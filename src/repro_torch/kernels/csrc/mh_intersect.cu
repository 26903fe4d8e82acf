// MinHash sketch intersection counts for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/mh_intersect.py:
//   * pg_mh_intersect_pairs <- mh_intersect_pairs (body _mh_kernel): per
//     row pair of sentinel-padded int32[k] rows, the number of (i, j) with
//     a[i] == b[j] and both entries valid, duplicates counted with
//     multiplicity (the 1-Hash Jaccard numerator, k^2 compares).
//   * pg_khash_match_pairs <- khash_match_pairs (body _khash_kernel): the
//     number of positions i with a[i] == b[i] and both valid (the k-Hash
//     Jaccard numerator).
// An entry is valid when x < sentinel, a signed compare, so negative ids
// count as valid. Since a valid a[i] equal to b[j] makes b[j] valid too,
// both kernels test the validity of a alone.
//
// What bounds it: memory. Each row pair reads 2k int32 and writes one;
// khash does ~2 operations per pair of entries read and mh ~2k, so at the
// main path's k = 31 both sit far below the card's operations-per-byte
// balance. The least time is the bytes, 2·E·k·4 + E·4, over the card's
// memory bandwidth (the operations bound, E·k or E·k² over the 32-bit
// rate, is lower unless k is in the hundreds).
//
// Design:
//   * A group of G lanes (G = the power of two >= k, capped at 32) owns a
//     row pair, so a warp handles 32/G rows when rows are short. Lanes
//     stride the row (i = lane; i < k; i += G): neighbouring lanes read
//     neighbouring words, and neighbouring groups neighbouring rows.
//   * The TPU kernel compares a [block_e, k, k] tile at once in VMEM.
//     Here each lane holds one entry of a in a register; the group walks
//     b in tiles of G entries, one per lane, and broadcasts each with
//     __shfl_sync(width G), so b is read once per a-tile and the k^2
//     compares need no shared memory. Any k is taken in tiles.
//   * A __shfl_xor_sync tree closes the group's sum: no atomics, no
//     second pass. Every lane joins the shuffles, in range or not; lanes
//     past the row or past E hold the sentinel, which matches no valid a.
//   * Ragged E and any k >= 1 are masked here, so callers pad nothing.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see repro_torch/kernels/_build.py). Plain C
//        interface, loaded with ctypes; each entry point returns the
//        cudaError_t of its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// Sum over the G lanes of a group (G divides 32; groups are warp-aligned).
__device__ __forceinline__ unsigned group_sum(unsigned acc, int G) {
  for (int off = G >> 1; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kFull, acc, off);
  return acc;
}

__global__ void __launch_bounds__(kThreads)
khash_match_kernel(const int32_t* __restrict__ a,
                   const int32_t* __restrict__ b, long long E, int k,
                   int32_t sentinel, int group_log2,
                   int32_t* __restrict__ out) {
  const int G = 1 << group_log2;
  const int lane = threadIdx.x & (G - 1);
  const long long e = (long long)blockIdx.x * (kThreads >> group_log2) +
                      (threadIdx.x >> group_log2);
  unsigned acc = 0;
  if (e < E) {
    const int32_t* ra = a + e * k;
    const int32_t* rb = b + e * k;
    for (int i = lane; i < k; i += G) {
      const int32_t x = __ldg(ra + i);
      acc += (x < sentinel) & (x == __ldg(rb + i));
    }
  }
  acc = group_sum(acc, G);
  if (lane == 0 && e < E) out[e] = (int32_t)acc;
}

__global__ void __launch_bounds__(kThreads)
mh_intersect_kernel(const int32_t* __restrict__ a,
                    const int32_t* __restrict__ b, long long E, int k,
                    int32_t sentinel, int group_log2,
                    int32_t* __restrict__ out) {
  const int G = 1 << group_log2;
  const int lane = threadIdx.x & (G - 1);
  const long long e = (long long)blockIdx.x * (kThreads >> group_log2) +
                      (threadIdx.x >> group_log2);
  const bool live = e < E;
  const int32_t* ra = a + (live ? e : 0) * k;
  const int32_t* rb = b + (live ? e : 0) * k;
  unsigned acc = 0;
  // every loop bound depends on k alone, so all lanes of the warp run the
  // same iterations and the full-mask shuffles are well formed
  for (int i0 = 0; i0 < k; i0 += G) {
    const int i = i0 + lane;
    const int32_t x = (live && i < k) ? __ldg(ra + i) : sentinel;
    const bool valid = x < sentinel;
    for (int j0 = 0; j0 < k; j0 += G) {
      const int j = j0 + lane;
      const int32_t y = (live && j < k) ? __ldg(rb + j) : sentinel;
      const int jn = min(G, k - j0);
      for (int t = 0; t < jn; ++t)
        acc += valid & (x == __shfl_sync(kFull, y, t, G));
    }
  }
  acc = group_sum(acc, G);
  if (lane == 0 && live) out[e] = (int32_t)acc;
}

// log2 of the group size: the power of two >= k, capped at a warp.
int group_log2_for(int k) {
  int g = 0;
  while ((1 << g) < k && g < 5) ++g;
  return g;
}

bool grid_for(long long count, int group_log2, unsigned* blocks) {
  const long long per_block = kThreads >> group_log2;
  const long long b = (count + per_block - 1) / per_block;
  if (b < 1 || b > 0x7fffffffLL) return false;
  *blocks = (unsigned)b;
  return true;
}

}  // namespace

extern "C" {

const char* pg_mh_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int pg_khash_match_pairs(const void* a, const void* b, long long E, int k,
                         int sentinel, void* out, void* stream) {
  unsigned blocks;
  const int g = group_log2_for(k);
  if (k < 1 || !grid_for(E, g, &blocks)) return (int)cudaErrorInvalidValue;
  khash_match_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b), E, k,
      sentinel, g, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

int pg_mh_intersect_pairs(const void* a, const void* b, long long E, int k,
                          int sentinel, void* out, void* stream) {
  unsigned blocks;
  const int g = group_log2_for(k);
  if (k < 1 || !grid_for(E, g, &blocks)) return (int)cudaErrorInvalidValue;
  mh_intersect_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b), E, k,
      sentinel, g, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
