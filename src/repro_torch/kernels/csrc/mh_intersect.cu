// MinHash sketch intersection counts for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/mh_intersect.py:
//   * mh_intersect_pairs (body _mh_kernel): per row pair of sentinel-padded
//     int32[k] rows, the number of (i, j) with a[i] == b[j] and both entries
//     valid, duplicates counted with multiplicity (the 1-Hash Jaccard
//     numerator, k^2 compares).
//   * khash_match_pairs (body _khash_kernel): the number of positions i with
//     a[i] == b[i] and both valid (the k-Hash Jaccard numerator).
// An entry is valid when x < sentinel, a signed compare, so negative ids
// count as valid. Since a valid a[i] equal to b[j] makes b[j] valid too,
// both kernels test the validity of a alone. Rows are neither assumed
// sorted nor free of duplicates.
//
// Each count has two forms:
//   * rows   (pg_mh_intersect_pairs, pg_khash_match_pairs): int32[E, k]
//     rows a and b, the TPU kernels' signature;
//   * gather (pg_mh_intersect_gather, pg_khash_match_gather): the sketch
//     matrix int32[n, k] and pairs int32[E, 2]; pair e counts rows
//     data[u], data[v] read straight from the matrix, ids clamped to
//     [0, n) as every kernel of the port does. The caller copies no rows.
//
// What bounds it: memory. A pair reads 2k int32 (and, gathered, its two
// ids) and writes one. The operations bound, E·k (khash) or E·k² (mh)
// compares over the card's INT32 rate (64 INT32 lanes per SM × 132 SMs ×
// 1,980 MHz ≈ 16.7e12/s), stays below the bytes bound for mh up to
// k ≈ 40 and for khash at every k.
//
// Design:
//   * A group of G lanes owns a pair; each lane holds kLaneWords (4) words
//     of each row per tile of G·4 words: units of V words (V = 4, 2 or 1:
//     16-, 8- or 4-byte loads, from k and the rows' addresses) at unit
//     index lane + G·q, so a group reads its row in coalesced runs. G is
//     the power of two >= k/4, capped at a warp, and a compile-time
//     constant: every loop over the group and the lane's words unrolls.
//     Words past k hold the sentinel, which equals no valid entry, so the
//     compare loops need no j < k mask. k > 128 goes in tiles.
//   * A warp takes kBatch steps of 32/G pairs each and issues all their
//     row loads before it compares. Measured on the H100, one step per
//     warp (32 registers, a full SM of warps) beats 2 or 4 (48 and 78
//     registers): the kernels are latency-bound, and warps in flight
//     hide DRAM latency better than loads in flight per warp.
//   * mh: the group stages its words of b in shared memory and each lane
//     reads them back 16 bytes (four words) per load, each word meeting
//     the lane's four words of a; a lane counts its equalities over every
//     b[j] and adds them once if its a[i] is valid. Broadcasting b by
//     __shfl_sync, one word per shuffle, was slower (PERF.md).
//   * khash: the group compares its aligned words and sums them. A flat
//     stream of the rows form's a and b (16-byte vectors, per-row sums in
//     shared memory) lost to this layout at every load depth tried
//     (PERF.md).
//   * The rows and gather forms share each device body, templated on how
//     a pair's rows are found (RowsSrc, GatherSrc).
//   * A __shfl_xor_sync tree closes a group's sum: no atomics to device
//     memory, no second pass. Every lane joins every shuffle: lanes past E
//     hold sentinels. Any E >= 1 and k >= 1 are masked here; callers pad
//     nothing.
//   * minhash_variants.py at the root of the repository times the tuning
//     constants below (PERF.md).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see repro_torch/kernels/_build.py). Plain C
//        interface, loaded with ctypes; each entry point returns the
//        cudaError_t of its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// words of each row a lane holds per tile
constexpr int kLaneWords = 4;
// warp steps whose row loads a warp issues before it compares
constexpr int kBatch = 1;

// Rows form: pair e reads row e of a and row e of b.
struct RowsSrc {
  const int32_t* a;
  const int32_t* b;
  __device__ __forceinline__ void rows(long long e, int k,
                                       const int32_t*& ra,
                                       const int32_t*& rb) const {
    ra = a + e * k;
    rb = b + e * k;
  }
};

// Gather form: pair e reads rows pairs[e][0] and pairs[e][1] of data,
// ids clamped to [0, n).
struct GatherSrc {
  const int32_t* data;
  const int32_t* pairs;
  long long n;
  __device__ __forceinline__ void rows(long long e, int k,
                                       const int32_t*& ra,
                                       const int32_t*& rb) const {
    const long long u = min(max((long long)__ldg(pairs + 2 * e), 0LL), n - 1);
    const long long v =
        min(max((long long)__ldg(pairs + 2 * e + 1), 0LL), n - 1);
    ra = data + u * k;
    rb = data + v * k;
  }
};

template <int V> struct VecOf;
template <> struct VecOf<1> { using T = int; };
template <> struct VecOf<2> { using T = int2; };
template <> struct VecOf<4> { using T = int4; };

// Words c of a vector, as an array.
template <int V>
__device__ __forceinline__ void unpack(const typename VecOf<V>::T& v,
                                       int32_t (&w)[V]) {
  if constexpr (V == 4) {
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (V == 2) {
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = v;
  }
}

// A vector of the V words at w.
template <int V>
__device__ __forceinline__ typename VecOf<V>::T pack(const int32_t* w) {
  if constexpr (V == 4) {
    return make_int4(w[0], w[1], w[2], w[3]);
  } else if constexpr (V == 2) {
    return make_int2(w[0], w[1]);
  } else {
    return w[0];
  }
}

// The lane's kLaneWords words of the tile that starts at word t0 of row r:
// units of V words at unit index lane + G·q. Words past k, and every word
// of a dead lane, hold the sentinel. k % V == 0, so a unit is all in or
// all out; V <= kLaneWords.
template <int G, int V>
__device__ __forceinline__ void load_slice(const int32_t* r, int t0, int k,
                                           int lane, bool live,
                                           int32_t sentinel,
                                           int32_t (&w)[kLaneWords]) {
#pragma unroll
  for (int q = 0; q < kLaneWords / V; ++q) {
    const int i = t0 + (lane + G * q) * V;
    int32_t unit[V];
    if (live && i < k) {
      unpack<V>(__ldg(reinterpret_cast<const typename VecOf<V>::T*>(r + i)),
                unit);
    } else {
#pragma unroll
      for (int c = 0; c < V; ++c) unit[c] = sentinel;
    }
#pragma unroll
    for (int c = 0; c < V; ++c) w[q * V + c] = unit[c];
  }
}

// Sum over the G lanes of a group (groups are warp-aligned).
template <int G>
__device__ __forceinline__ unsigned group_sum(unsigned acc) {
#pragma unroll
  for (int off = G >> 1; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kFull, acc, off);
  return acc;
}

// words of b a shared-memory load of the broadcast reads (16 bytes)
constexpr int kStageVec = kLaneWords < 4 ? kLaneWords : 4;

// Per lane word i, the count of the group's b words equal to x[i]: every
// one of the group's G·kLaneWords words of b is broadcast to the group
// through sw, this warp's staging words in shared memory, which each lane
// reads back kStageVec words per load.
template <int G>
__device__ __forceinline__ void mh_tile(const int32_t (&x)[kLaneWords],
                                        const int32_t (&y)[kLaneWords],
                                        int32_t* sw, int lane32,
                                        unsigned (&cnt)[kLaneWords]) {
  using SV = typename VecOf<kStageVec>::T;
  __syncwarp();
  SV* mine = reinterpret_cast<SV*>(sw + lane32 * kLaneWords);
#pragma unroll
  for (int q = 0; q < kLaneWords / kStageVec; ++q)
    mine[q] = pack<kStageVec>(y + q * kStageVec);
  __syncwarp();
  const SV* group =
      reinterpret_cast<const SV*>(sw + (lane32 & ~(G - 1)) * kLaneWords);
#pragma unroll 4
  for (int s = 0; s < G * kLaneWords / kStageVec; ++s) {
    int32_t v[kStageVec];
    unpack<kStageVec>(group[s], v);
#pragma unroll
    for (int c = 0; c < kStageVec; ++c)
#pragma unroll
      for (int i = 0; i < kLaneWords; ++i) cnt[i] += x[i] == v[c];
  }
}

// The rows of the kBatch pairs this lane's group takes, and whether each
// exists. A warp takes kBatch steps of 32/G consecutive pairs.
template <class Src, int G>
__device__ __forceinline__ long long batch_rows(
    const Src& src, long long E, int k, const int32_t* (&ra)[kBatch],
    const int32_t* (&rb)[kBatch], bool (&live)[kBatch]) {
  const int group = (threadIdx.x & 31) / G;
  const long long first =
      ((long long)blockIdx.x * kWarps + threadIdx.x / 32) * kBatch *
          (32 / G) + group;
#pragma unroll
  for (int p = 0; p < kBatch; ++p) {
    const long long e = first + (long long)p * (32 / G);
    live[p] = e < E;
    ra[p] = rb[p] = nullptr;
    if (live[p]) src.rows(e, k, ra[p], rb[p]);
  }
  return first;
}

template <int G>
__device__ __forceinline__ void store_batch(long long first, long long E,
                                            const unsigned (&acc)[kBatch],
                                            int32_t* __restrict__ out) {
  const int lane = threadIdx.x & (G - 1);
#pragma unroll
  for (int p = 0; p < kBatch; ++p) {
    const unsigned s = group_sum<G>(acc[p]);
    const long long e = first + (long long)p * (32 / G);
    if (lane == 0 && e < E) out[e] = (int32_t)s;
  }
}

template <class Src, int G, int V>
__global__ void __launch_bounds__(kThreads)
mh_kernel(Src src, long long E, int k, int32_t sentinel,
          int32_t* __restrict__ out) {
  constexpr int kTile = G * kLaneWords;
  __shared__ __align__(16) int32_t stage[kThreads * kLaneWords];
  const int lane = threadIdx.x & (G - 1);
  const int32_t* ra[kBatch];
  const int32_t* rb[kBatch];
  bool live[kBatch];
  const long long first = batch_rows<Src, G>(src, E, k, ra, rb, live);
  int32_t* sw = stage + (threadIdx.x & ~31) * kLaneWords;
  unsigned acc[kBatch] = {};
  // every loop bound depends on k alone, so all lanes of the warp run the
  // same iterations, as __syncwarp and the full-mask shuffles need
  for (int ta = 0; ta < k; ta += kTile) {
    int32_t x[kBatch][kLaneWords];
#pragma unroll
    for (int p = 0; p < kBatch; ++p)
      load_slice<G, V>(ra[p], ta, k, lane, live[p], sentinel, x[p]);
    for (int tb = 0; tb < k; tb += kTile) {
      int32_t y[kBatch][kLaneWords];
#pragma unroll
      for (int p = 0; p < kBatch; ++p)
        load_slice<G, V>(rb[p], tb, k, lane, live[p], sentinel, y[p]);
#pragma unroll
      for (int p = 0; p < kBatch; ++p) {
        unsigned cnt[kLaneWords] = {};
        mh_tile<G>(x[p], y[p], sw, threadIdx.x & 31, cnt);
#pragma unroll
        for (int i = 0; i < kLaneWords; ++i)
          acc[p] += x[p][i] < sentinel ? cnt[i] : 0u;
      }
    }
  }
  store_batch<G>(first, E, acc, out);
}

template <class Src, int G, int V>
__global__ void __launch_bounds__(kThreads)
khash_kernel(Src src, long long E, int k, int32_t sentinel,
             int32_t* __restrict__ out) {
  constexpr int kTile = G * kLaneWords;
  const int lane = threadIdx.x & (G - 1);
  const int32_t* ra[kBatch];
  const int32_t* rb[kBatch];
  bool live[kBatch];
  const long long first = batch_rows<Src, G>(src, E, k, ra, rb, live);
  unsigned acc[kBatch] = {};
  for (int t = 0; t < k; t += kTile) {
    int32_t x[kBatch][kLaneWords], y[kBatch][kLaneWords];
#pragma unroll
    for (int p = 0; p < kBatch; ++p) {
      load_slice<G, V>(ra[p], t, k, lane, live[p], sentinel, x[p]);
      load_slice<G, V>(rb[p], t, k, lane, live[p], sentinel, y[p]);
    }
#pragma unroll
    for (int p = 0; p < kBatch; ++p)
#pragma unroll
      for (int i = 0; i < kLaneWords; ++i)
        acc[p] += (x[p][i] < sentinel) & (x[p][i] == y[p][i]);
  }
  store_batch<G>(first, E, acc, out);
}

// log2 of the group size: the power of two >= k / kLaneWords, capped at a
// warp.
int group_log2_for(int k) {
  int g = 0;
  while ((1 << g) * kLaneWords < k && g < 5) ++g;
  return g;
}

// Vector width in words: 4 or 2 when k, every row address and a lane's
// kLaneWords allow it.
int vec_for(int k, uintptr_t addr_bits) {
  if (kLaneWords % 4 == 0 && k % 4 == 0 && addr_bits % 16 == 0) return 4;
  if (kLaneWords % 2 == 0 && k % 2 == 0 && addr_bits % 8 == 0) return 2;
  return 1;
}

template <class Src, int G, int V>
cudaError_t launch_group(bool mh, const Src& src, long long E, int k,
                         int sentinel, int32_t* out, cudaStream_t stream) {
  const long long per_block = (long long)kWarps * kBatch * (32 / G);
  const long long blocks = (E + per_block - 1) / per_block;
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (mh)
    mh_kernel<Src, G, V><<<(unsigned)blocks, kThreads, 0, stream>>>(
        src, E, k, sentinel, out);
  else
    khash_kernel<Src, G, V><<<(unsigned)blocks, kThreads, 0, stream>>>(
        src, E, k, sentinel, out);
  return cudaGetLastError();
}

template <class Src, int V>
cudaError_t launch_g(bool mh, const Src& src, long long E, int k,
                     int sentinel, int32_t* out, cudaStream_t st) {
  switch (group_log2_for(k)) {
    case 0: return launch_group<Src, 1, V>(mh, src, E, k, sentinel, out, st);
    case 1: return launch_group<Src, 2, V>(mh, src, E, k, sentinel, out, st);
    case 2: return launch_group<Src, 4, V>(mh, src, E, k, sentinel, out, st);
    case 3: return launch_group<Src, 8, V>(mh, src, E, k, sentinel, out, st);
    case 4: return launch_group<Src, 16, V>(mh, src, E, k, sentinel, out, st);
    default: return launch_group<Src, 32, V>(mh, src, E, k, sentinel, out, st);
  }
}

template <class Src>
cudaError_t launch(bool mh, const Src& src, int vec, long long E, int k,
                   int sentinel, void* out, void* stream) {
  if (k < 1 || E < 1) return cudaErrorInvalidValue;
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4) return launch_g<Src, 4>(mh, src, E, k, sentinel, o, s);
  if (vec == 2) return launch_g<Src, 2>(mh, src, E, k, sentinel, o, s);
  return launch_g<Src, 1>(mh, src, E, k, sentinel, o, s);
}

}  // namespace

extern "C" {

const char* pg_mh_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int pg_mh_intersect_pairs(const void* a, const void* b, long long E, int k,
                          int sentinel, void* out, void* stream) {
  const RowsSrc src{static_cast<const int32_t*>(a),
                    static_cast<const int32_t*>(b)};
  const int vec = vec_for(k, (uintptr_t)a | (uintptr_t)b);
  return (int)launch(true, src, vec, E, k, sentinel, out, stream);
}

int pg_khash_match_pairs(const void* a, const void* b, long long E, int k,
                         int sentinel, void* out, void* stream) {
  const RowsSrc src{static_cast<const int32_t*>(a),
                    static_cast<const int32_t*>(b)};
  const int vec = vec_for(k, (uintptr_t)a | (uintptr_t)b);
  return (int)launch(false, src, vec, E, k, sentinel, out, stream);
}

int pg_mh_intersect_gather(const void* data, long long n, const void* pairs,
                           long long E, int k, int sentinel, void* out,
                           void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const GatherSrc src{static_cast<const int32_t*>(data),
                      static_cast<const int32_t*>(pairs), n};
  return (int)launch(true, src, vec_for(k, (uintptr_t)data), E, k,
                     sentinel, out, stream);
}

int pg_khash_match_gather(const void* data, long long n, const void* pairs,
                          long long E, int k, int sentinel, void* out,
                          void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const GatherSrc src{static_cast<const int32_t*>(data),
                      static_cast<const int32_t*>(pairs), n};
  return (int)launch(false, src, vec_for(k, (uintptr_t)data), E, k,
                     sentinel, out, stream);
}

}  // extern "C"
