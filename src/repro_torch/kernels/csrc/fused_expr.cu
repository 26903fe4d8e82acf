// Set-expression popcount kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/fused_expr.py:
//   * pg_fused_gather_popcount <- fused_gather_popcount (body
//     _gather_expr_kernel, _popcount_accumulate, row DMA
//     bf_intersect._gather_rows): for each tuple, gather k rows of the
//     sketch matrix, evaluate the AND/OR/ANDNOT tree, popcount the row.
//   * pg_fused_rows_popcount <- fused_rows_popcount (body
//     _rows_expr_kernel): the same tree over k dense, pre-gathered rows.
//   * pg_fused_segment_popcount <- the k-way AND form (k = 2, 3, 4) of
//     fused_gather_popcount and bf_intersect._edge3_impl, for tuples that
//     come in segments sharing their first k-1 rows (the clique launch);
//     its own note is above its kernel, below.
//
// What bounds it: memory. A tuple reads k rows of W words and writes one
// int32, doing about (k + 1) integer operations per word read, far below
// the card's operations-per-byte balance. The least time is the bytes
// moved, T·k·W·4 gathered plus T·(4k + 4) of ids and output, over the
// card's memory bandwidth (fewer when tuples share rows that L2 holds).
//
// Design:
//   * A group of G lanes (G = the power of two >= W, capped at 32) takes
//     one tuple, so a warp handles 32/G tuples when rows are short. Lanes
//     stride the row's words (w = lane; w < W; w += G), so neighbouring
//     lanes read neighbouring words and a row is read in whole 128-byte
//     lines.
//   * The Pallas kernel carries its popcount across grid steps over the
//     word axis. Blocks here run in no order, so the whole loop over words
//     lives inside the group and a __shfl_xor_sync tree closes the sum: no
//     atomics, no second pass.
//   * Each group loads its own row ids (the TPU kernel scalar-prefetches
//     them). Ids are clamped to [0, n), as the plain version does.
//   * The expression arrives as data: a postfix program of at most 16
//     instructions over at most 8 leaves, by value in the argument struct,
//     and the same program drives the plain PyTorch version. The k-way AND
//     (k = 2, 3, 4) is instantiated as a template that keeps the row
//     pointers in registers; every other program is interpreted per word.
//   * Ragged T and any W are masked here, so callers pad nothing.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see repro_torch/kernels/_build.py). Plain C
//        interface, loaded with ctypes; each entry point returns the
//        cudaError_t of its launch.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kMaxInstr = 16;
constexpr int kMaxLeaves = 8;
constexpr int kThreads = 256;
constexpr int kPush = 0, kAnd = 1, kOr = 2, kAndNot = 3;

struct Program {
  int n_instr;
  int n_leaves;
  int and_k;
  int op[kMaxInstr];
  int arg[kMaxInstr];
  int slot[kMaxLeaves];
};

struct Rows {
  const uint32_t* ptr[kMaxLeaves];
};

// Interpret the postfix program for word w of the leaf rows. A program of
// at most 16 instructions pushes at most 8 values, so 8 stack slots hold it.
__device__ __forceinline__ uint32_t eval_program(const Program& p,
                                                 const uint32_t* const* base,
                                                 int w) {
  uint32_t st[kMaxLeaves];
  int sp = 0;
  for (int i = 0; i < p.n_instr; ++i) {
    const int op = p.op[i];
    if (op == kPush) {
      st[sp++] = __ldg(base[p.arg[i]] + w);
    } else {
      const uint32_t b = st[--sp];
      const uint32_t a = st[sp - 1];
      st[sp - 1] = op == kAnd ? (a & b) : op == kOr ? (a | b) : (a & ~b);
    }
  }
  return st[0];
}

// Popcount of the evaluated row, summed over this lane's words.
// K > 0: the K-way AND of leaves 0..K-1; K == 0: interpret the program.
template <int K>
__device__ __forceinline__ uint32_t lane_popcount(const Program& p,
                                                  const uint32_t* const* base,
                                                  int W, int lane, int G) {
  uint32_t acc = 0;
  for (int w = lane; w < W; w += G) {
    uint32_t v;
    if constexpr (K > 0) {
      v = __ldg(base[0] + w);
#pragma unroll
      for (int j = 1; j < K; ++j) v &= __ldg(base[j] + w);
    } else {
      v = eval_program(p, base, w);
    }
    acc += __popc(v);
  }
  return acc;
}

// Sum over the G lanes of a group (G divides 32; groups are warp-aligned).
__device__ __forceinline__ uint32_t group_sum(uint32_t acc, int G) {
  for (int off = G >> 1; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
gather_popcount_kernel(const uint32_t* __restrict__ data, long long n, int W,
                       const int32_t* __restrict__ tuples, long long T,
                       int tuple_cols, Program p, int group_log2,
                       int32_t* __restrict__ out) {
  constexpr int kLeaves = K > 0 ? K : kMaxLeaves;
  const int G = 1 << group_log2;
  const int lane = threadIdx.x & (G - 1);
  const long long t = (long long)blockIdx.x * (kThreads >> group_log2) +
                      (threadIdx.x >> group_log2);
  uint32_t acc = 0;
  if (t < T) {
    const int32_t* tup = tuples + t * tuple_cols;
    const uint32_t* base[kLeaves];
    const int leaves = K > 0 ? K : p.n_leaves;
#pragma unroll
    for (int j = 0; j < kLeaves; ++j) {
      if (j < leaves) {
        long long id = __ldg(tup + p.slot[j]);
        id = id < 0 ? 0 : (id >= n ? n - 1 : id);
        base[j] = data + id * W;
      }
    }
    acc = lane_popcount<K>(p, base, W, lane, G);
  }
  acc = group_sum(acc, G);  // every lane takes part, in range or not
  if (lane == 0 && t < T) out[t] = (int32_t)acc;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
rows_popcount_kernel(Rows rows, long long E, int W, Program p, int group_log2,
                     int32_t* __restrict__ out) {
  constexpr int kLeaves = K > 0 ? K : kMaxLeaves;
  const int G = 1 << group_log2;
  const int lane = threadIdx.x & (G - 1);
  const long long e = (long long)blockIdx.x * (kThreads >> group_log2) +
                      (threadIdx.x >> group_log2);
  uint32_t acc = 0;
  if (e < E) {
    const uint32_t* base[kLeaves];
    const int leaves = K > 0 ? K : p.n_leaves;
#pragma unroll
    for (int j = 0; j < kLeaves; ++j)
      if (j < leaves) base[j] = rows.ptr[j] + e * W;
    acc = lane_popcount<K>(p, base, W, lane, G);
  }
  acc = group_sum(acc, G);
  if (lane == 0 && e < E) out[e] = (int32_t)acc;
}

// Copy the packed program into the argument struct and check it: opcodes,
// leaf indices, stack discipline, the AND fast-path arity and, when
// tuple_cols > 0, that every leaf's column exists.
bool unpack(const int* packed, int tuple_cols, Program* p) {
  p->n_instr = packed[0];
  p->n_leaves = packed[1];
  p->and_k = packed[2];
  if (p->n_instr < 1 || p->n_instr > kMaxInstr || p->n_leaves < 1 ||
      p->n_leaves > kMaxLeaves || p->and_k < 0 || p->and_k > p->n_leaves)
    return false;
  int depth = 0;
  for (int i = 0; i < kMaxInstr; ++i) {
    p->op[i] = packed[3 + i];
    p->arg[i] = packed[3 + kMaxInstr + i];
    if (i >= p->n_instr) continue;
    if (p->op[i] == kPush) {
      if (p->arg[i] < 0 || p->arg[i] >= p->n_leaves) return false;
      ++depth;
    } else if (p->op[i] >= kAnd && p->op[i] <= kAndNot && depth >= 2) {
      --depth;
    } else {
      return false;
    }
  }
  for (int j = 0; j < kMaxLeaves; ++j) {
    p->slot[j] = packed[3 + 2 * kMaxInstr + j];
    if (j < p->n_leaves && tuple_cols > 0 &&
        (p->slot[j] < 0 || p->slot[j] >= tuple_cols))
      return false;
  }
  return depth == 1;
}

// log2 of the group size: the power of two >= W, capped at a warp.
int group_log2_for(int W) {
  int g = 0;
  while ((1 << g) < W && g < 5) ++g;
  return g;
}

bool grid_for(long long count, int group_log2, unsigned* blocks) {
  const long long per_block = kThreads >> group_log2;
  const long long b = (count + per_block - 1) / per_block;
  if (b < 1 || b > 0x7fffffffLL) return false;
  *blocks = (unsigned)b;
  return true;
}

// ---------------------------------------------------------------------------
// The segmented k-way AND: tuples that share their first k-1 rows.
//
// Input: heads int32[S, k-1], offsets[S+1] (int32 or int64, ascending,
// offsets[0] = 0, offsets[S] = T) and tails int32[T]; tuple t of segment s
// (offsets[s] <= t < offsets[s+1]) is (heads[s, :], tails[t]), and its
// output is popcount(B_heads[s,0] & ... & B_tails[t]). The clique passes
// produce exactly this: a 4-clique launch is the survivors w of canonical
// edges (u, v), edge-major, ~385 per edge at Kronecker scale 21 (up to
// ~10^5 at hub edges, none at many); a 5-clique launch is the pairs x of
// triangles (u, v, w), ~85 per triangle at scale 16.
//
// What bounds it: bytes. Per tuple it must read one tail row of W words
// and its id and write one int32 (136 B at W = 32), plus the head rows
// and offsets once per segment, for about two integer operations per word
// read, far below the card's operations-per-byte balance. The [T, k]
// gather kernel above reads k rows and k ids per tuple (400 B at AND3,
// W = 32); this one reads a segment's head rows once and keeps their AND
// on chip, so a long segment streams 136 B per tuple.
//
// Design:
//   * A warp takes a chunk of `chunk_tiles` tiles of 32 consecutive tails
//     (fixed work per warp, so a hub segment of 10^5 tails spreads over
//     hundreds of warps and never serialises one). Its first segment comes
//     from a 32-ary search of offsets: each step the 32 lanes probe 32
//     points and a ballot narrows the range 32-fold.
//   * Per tile, lane j loads tail id j (one coalesced 128-byte load) and
//     offsets[s_lo + j + 1], the next 32 segment ends after the tile's
//     first segment s_lo; the previous tile issued these loads as soon as
//     it knew s_lo, so they overlap its row loads. A 5-step shuffle search
//     gives each lane its tuple's segment. When the tile spans fewer than `nslot` segments
//     (nearly always) their head ANDs come from a per-warp cache in shared
//     memory: `nslot` slots of W words, segment s in slot s mod nslot.
//     Segments not cached yet and not empty are filled: their k-1 head ids
//     are loaded by the lane of the segment, the groups split the segments
//     between them, each lane ANDs its part of the rows and stores it. The
//     next tile starts at the last tuple's segment, which stays cached, so
//     a long segment reads its heads once.
//   * A tile whose tuples span nslot or more segments (runs of empty
//     segments) takes the slow path: a binary search per lane and the head
//     rows read for each tuple, as the [T, k] kernel does.
//   * Rows are read as 16-byte vectors when W % 4 == 0 and the matrix is
//     16-byte aligned, else 8 or 4 bytes (W = 30 leaves odd rows only
//     8-byte aligned). A group of G lanes (the power of two >= W / V
//     vectors, at most 32) reads one row, so a warp reads 32 / G rows per
//     step: four whole 128-byte rows at W = 32. A tile's 32 tuples take G
//     steps; batches of 4 steps issue their 4 row loads per lane before the
//     first is used. Rows wider than 32 vectors are read in column blocks.
//   * The kernel is bound by latency before bandwidth: its time follows
//     the warps resident per SM more than the loads each has in flight.
//     Positions are 32-bit (a launch takes at most 2^30 tails and
//     segments), blocks hold 4 warps and batches 4 steps: on the card
//     these beat 64-bit positions, 8-warp blocks, batches of 2 or 8 and a
//     register cap that forces more warps per SM (segment_variants.py at
//     the root of the repository times the variants; PERF.md).
//   * A shuffle tree sums each group; a shuffle per step hands lane j the
//     sum of tuple j, so the tile writes its 32 outputs in one coalesced
//     store. Ids are clamped to [0, n), as everywhere in this file;
//     segment indices are clamped to [0, S), which keeps malformed offsets
//     memory-safe (their outputs are then unspecified).
// ---------------------------------------------------------------------------

constexpr int kSegWarps = 4;   // warps per block
constexpr int kSegBatch = 4;   // tuple steps whose row loads are in flight
constexpr unsigned kFull = 0xffffffffu;
// shared memory the segment cache of one block may take (the default limit)
constexpr int kSegSmemBytes = 48 * 1024;
// most segments and tails one launch takes: positions stay 32-bit
constexpr long long kSegMaxCount = 1LL << 30;

template <int V> struct VecOf;
template <> struct VecOf<1> { using T = uint32_t; };
template <> struct VecOf<2> { using T = uint2; };
template <> struct VecOf<4> { using T = uint4; };

__device__ __forceinline__ uint32_t vand(uint32_t a, uint32_t b) { return a & b; }
__device__ __forceinline__ uint2 vand(uint2 a, uint2 b) {
  return make_uint2(a.x & b.x, a.y & b.y);
}
__device__ __forceinline__ uint4 vand(uint4 a, uint4 b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}
__device__ __forceinline__ uint32_t vpopc(uint32_t a) { return __popc(a); }
__device__ __forceinline__ uint32_t vpopc(uint2 a) {
  return __popc(a.x) + __popc(a.y);
}
__device__ __forceinline__ uint32_t vpopc(uint4 a) {
  return __popc(a.x) + __popc(a.y) + __popc(a.z) + __popc(a.w);
}
template <typename VT> __device__ __forceinline__ VT vzero() { return VT{}; }

template <typename OffT>
__device__ __forceinline__ int seg_end(const OffT* __restrict__ off, int i,
                                       int S) {
  return i <= S ? (int)__ldg(off + i) : INT_MAX;
}

__device__ __forceinline__ int clamp_id(int id, int n) {
  return id < 0 ? 0 : (id >= n ? n - 1 : id);
}

// Position of the r-th set bit of m (r counted from 0).
__device__ __forceinline__ int nth_set(unsigned m, int r) {
  for (int i = 0; i < r; ++i) m &= m - 1;
  return __ffs(m) - 1;
}

template <int K, int V, typename OffT>
__global__ void __launch_bounds__(kSegWarps * 32)
segment_popcount_kernel(const uint32_t* __restrict__ data, int n, int W,
                        const int32_t* __restrict__ heads, int S,
                        const OffT* __restrict__ off,
                        const int32_t* __restrict__ tails, int T,
                        int group_log2, int nslot, int chunk_tiles,
                        int32_t* __restrict__ out) {
  using VT = typename VecOf<V>::T;
  constexpr int H = K - 1;                   // head rows per segment
  extern __shared__ uint4 seg_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int G = 1 << group_log2;             // lanes per row
  const int P = 32 >> group_log2;            // rows per warp step
  const int g = lane >> group_log2;          // this lane's group
  const int gl = lane & (G - 1);             // its lane within the group
  const int NV = W / V;                      // vectors per row
  const int ncb = (NV + G - 1) / G;          // column blocks
  const int steps = G;                       // steps per tile of 32 tuples
  VT* cache = reinterpret_cast<VT*>(seg_smem) + (size_t)warp * nslot * NV;
  const VT* rows = reinterpret_cast<const VT*>(data);

  const long long first = ((long long)blockIdx.x * kSegWarps + warp) *
                          chunk_tiles * 32LL;
  if (first >= T) return;                    // whole warp: warp-uniform
  const int c0 = (int)first;
  const int c1 = (int)min((long long)T, first + chunk_tiles * 32LL);

  // the chunk's first segment: the last s with offsets[s] <= c0
  int lo = 0, hi = S;
  while (hi > lo) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + (lane + 1) * step;
    const bool le = p <= hi && seg_end(off, p, S) <= c0;
    lo += __popc(__ballot_sync(kFull, le)) * step;
    hi = min(hi, lo + step - 1);
  }
  int s_lo = min(lo, S - 1);
  int cache_hi = -1;                         // segments <= this are cached
  // the first tile's tail id, and the start and end of segment s_lo + j;
  // each tile loads the next tile's as soon as it knows its s_lo
  int id = lane < c1 - c0 ? __ldg(tails + c0 + lane) : 0;
  int a_j = seg_end(off, s_lo + lane, S);
  int o_j = seg_end(off, s_lo + lane + 1, S);

  for (int b = c0; b < c1; b += 32) {
    const int nvalid = min(32, c1 - b);
    const int t = b + lane;
    const bool live = lane < nvalid;
    // this lane's tuple lies in segment s_lo + (number of ends o_j <= t)
    int pos = 0;
#pragma unroll
    for (int st = 16; st >= 1; st >>= 1)
      if (__shfl_sync(kFull, o_j, pos + st - 1) <= t) pos += st;
    const int last_end = __shfl_sync(kFull, o_j, 31);  // every lane
    if (pos == 31 && last_end <= t) pos = 32;
    const int span = __shfl_sync(kFull, pos, nvalid - 1);
    const bool fast = span < nslot;          // warp-uniform
    int seg = s_lo + pos;
    if (!fast && live && pos == 32) {        // past 32 ends: binary search
      int l2 = s_lo + 32, h2 = S;
      while (l2 < h2) {
        const int mid = l2 + (h2 - l2 + 1) / 2;
        if (seg_end(off, mid, S) <= t) l2 = mid; else h2 = mid - 1;
      }
      seg = l2;
    }
    seg = min(seg, S - 1);
    const int s_next = __shfl_sync(kFull, seg, nvalid - 1);
    const int tile_id = clamp_id(id, n);
    const bool nonempty = o_j > a_j;
    if (b + 32 < c1) {                       // prefetch the next tile's
      id = lane < c1 - b - 32 ? __ldg(tails + t + 32) : 0;
      a_j = seg_end(off, s_next + lane, S);
      o_j = seg_end(off, s_next + lane + 1, S);
    }

    // head ids: fast path, lane j loads those of segment s_lo + j when it
    // is in the tile, not cached and not empty; slow path, those of its
    // own tuple's segment
    const bool fill_me = fast && lane <= span && s_lo + lane > cache_hi &&
                         nonempty;
    const unsigned fill = __ballot_sync(kFull, fill_me);
    const int hs = fast ? min(s_lo + lane, S - 1) : seg;
    int hid[H];
#pragma unroll
    for (int i = 0; i < H; ++i)
      hid[i] = (fill_me || (!fast && live))
                   ? clamp_id(__ldg(heads + (size_t)hs * H + i), n) : 0;

    int res = 0;
    for (int j0 = 0; j0 < steps; j0 += kSegBatch) {
      uint32_t acc[kSegBatch];
#pragma unroll
      for (int j = 0; j < kSegBatch; ++j) acc[j] = 0;
      for (int cb = 0; cb < ncb; ++cb) {
        const int c = cb * G + gl;           // this lane's vector of a row
        const bool cin = c < NV;
        VT x[kSegBatch];
#pragma unroll
        for (int j = 0; j < kSegBatch; ++j) {
          const int idx = (j0 + j) * P + g;  // tile position of the tuple
          const int tid = __shfl_sync(kFull, tile_id, idx & 31);
          const bool ok = j0 + j < steps && idx < nvalid && cin;
          x[j] = ok ? __ldg(rows + (size_t)tid * NV + c) : vzero<VT>();
        }
        if (fast && j0 == 0) {
          // fill this column block of the new segments' slots
          __syncwarp();                      // the last tile's reads are done
          const int nfill = __popc(fill);
          for (int r0 = 0; r0 < nfill; r0 += P) {
            const int r = r0 + g;
            const int jr = r < nfill ? nth_set(fill, r) : 0;
            int h[H];
#pragma unroll
            for (int i = 0; i < H; ++i) h[i] = __shfl_sync(kFull, hid[i], jr);
            if (r < nfill && cin) {
              VT v = __ldg(rows + (size_t)h[0] * NV + c);
#pragma unroll
              for (int i = 1; i < H; ++i)
                v = vand(v, __ldg(rows + (size_t)h[i] * NV + c));
              cache[(size_t)((s_lo + jr) & (nslot - 1)) * NV + c] = v;
            }
          }
          __syncwarp();
        }
#pragma unroll
        for (int j = 0; j < kSegBatch; ++j) {
          const int idx = (j0 + j) * P + g;
          const bool ok = j0 + j < steps && idx < nvalid && cin;
          VT h;
          if (fast) {
            const int sg = __shfl_sync(kFull, seg, idx & 31);
            h = ok ? cache[(size_t)(sg & (nslot - 1)) * NV + c] : vzero<VT>();
          } else {
            int hh[H];
#pragma unroll
            for (int i = 0; i < H; ++i)
              hh[i] = __shfl_sync(kFull, hid[i], idx & 31);
            h = vzero<VT>();
            if (ok) {
              h = __ldg(rows + (size_t)hh[0] * NV + c);
#pragma unroll
              for (int i = 1; i < H; ++i)
                h = vand(h, __ldg(rows + (size_t)hh[i] * NV + c));
            }
          }
          acc[j] += vpopc(vand(x[j], h));
        }
      }
      // sum each group; lane L keeps tuple L's sum (step L / P, group L % P)
#pragma unroll
      for (int j = 0; j < kSegBatch; ++j) {
        uint32_t sum = acc[j];
        for (int o = G >> 1; o > 0; o >>= 1)
          sum += __shfl_xor_sync(kFull, sum, o);
        const uint32_t mine =
            __shfl_sync(kFull, sum, (lane & (P - 1)) << group_log2);
        if ((lane >> (5 - group_log2)) == j0 + j) res = (int)mine;
      }
    }
    if (live) out[t] = res;
    cache_hi = fast ? s_lo + span : -1;
    s_lo = s_next;
  }
}

// Rows are read V words at a time: 4 when W % 4 == 0 and the matrix is
// 16-byte aligned, 2 when W is even and it is 8-byte aligned, else 1.
int vector_words(int W, const void* data) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(data);
  if (W % 4 == 0 && a % 16 == 0) return 4;
  if (W % 2 == 0 && a % 8 == 0) return 2;
  return 1;
}

// Lanes per row: the power of two >= the row's vectors, at most 32.
int segment_group_log2(int W, int V) { return group_log2_for(W / V); }

// Cache slots per warp: the largest power of two <= 32 whose slots fit the
// block's shared memory budget; 0 (every tile on the slow path) if none.
int segment_slots(int W) {
  int slots = 32;
  while (slots > 0 &&
         (long long)kSegWarps * slots * W * 4 > kSegSmemBytes)
    slots >>= 1;
  return slots;
}

template <int K, int V, typename OffT>
int launch_segment(const void* data, long long n, int W, const void* heads,
                   long long S, const void* offsets, const void* tails,
                   long long T, int chunk_tiles, void* out,
                   cudaStream_t stream) {
  const int glog = segment_group_log2(W, V);
  const int slots = segment_slots(W);
  const long long per_block = (long long)kSegWarps * chunk_tiles * 32;
  const long long blocks = (T + per_block - 1) / per_block;
  if (blocks < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kSegWarps * slots * W * 4;
  segment_popcount_kernel<K, V, OffT><<<(unsigned)blocks, kSegWarps * 32,
                                        smem, stream>>>(
      static_cast<const uint32_t*>(data), (int)n, W,
      static_cast<const int32_t*>(heads), (int)S,
      static_cast<const OffT*>(offsets), static_cast<const int32_t*>(tails),
      (int)T, glog, slots, chunk_tiles, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

template <int K, typename OffT>
int launch_segment_v(int V, const void* data, long long n, int W,
                     const void* heads, long long S, const void* offsets,
                     const void* tails, long long T, int chunk_tiles,
                     void* out, cudaStream_t stream) {
  switch (V) {
    case 4:
      return launch_segment<K, 4, OffT>(data, n, W, heads, S, offsets, tails,
                                        T, chunk_tiles, out, stream);
    case 2:
      return launch_segment<K, 2, OffT>(data, n, W, heads, S, offsets, tails,
                                        T, chunk_tiles, out, stream);
    default:
      return launch_segment<K, 1, OffT>(data, n, W, heads, S, offsets, tails,
                                        T, chunk_tiles, out, stream);
  }
}

template <typename OffT>
int launch_segment_k(int k, int V, const void* data, long long n, int W,
                     const void* heads, long long S, const void* offsets,
                     const void* tails, long long T, int chunk_tiles,
                     void* out, cudaStream_t stream) {
  switch (k) {
    case 2:
      return launch_segment_v<2, OffT>(V, data, n, W, heads, S, offsets,
                                       tails, T, chunk_tiles, out, stream);
    case 3:
      return launch_segment_v<3, OffT>(V, data, n, W, heads, S, offsets,
                                       tails, T, chunk_tiles, out, stream);
    default:
      return launch_segment_v<4, OffT>(V, data, n, W, heads, S, offsets,
                                       tails, T, chunk_tiles, out, stream);
  }
}

}  // namespace

extern "C" {

const char* pg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int pg_fused_gather_popcount(const void* data, long long n, int W,
                             const void* tuples, long long T, int tuple_cols,
                             const int* program, void* out, void* stream) {
  Program p;
  unsigned blocks;
  const int g = group_log2_for(W);
  if (!unpack(program, tuple_cols, &p) || n < 1 || W < 1 || tuple_cols < 1 ||
      !grid_for(T, g, &blocks))
    return (int)cudaErrorInvalidValue;
  const uint32_t* d = static_cast<const uint32_t*>(data);
  const int32_t* tu = static_cast<const int32_t*>(tuples);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.and_k) {
    case 2:
      gather_popcount_kernel<2><<<blocks, kThreads, 0, s>>>(d, n, W, tu, T, tuple_cols, p, g, o);
      break;
    case 3:
      gather_popcount_kernel<3><<<blocks, kThreads, 0, s>>>(d, n, W, tu, T, tuple_cols, p, g, o);
      break;
    case 4:
      gather_popcount_kernel<4><<<blocks, kThreads, 0, s>>>(d, n, W, tu, T, tuple_cols, p, g, o);
      break;
    default:
      gather_popcount_kernel<0><<<blocks, kThreads, 0, s>>>(d, n, W, tu, T, tuple_cols, p, g, o);
  }
  return (int)cudaGetLastError();
}

int pg_fused_rows_popcount(const void* const* rows, int k, long long E, int W,
                           const int* program, void* out, void* stream) {
  Program p;
  Rows r;
  unsigned blocks;
  const int g = group_log2_for(W);
  if (!unpack(program, 0, &p) || k != p.n_leaves || W < 1 ||
      !grid_for(E, g, &blocks))
    return (int)cudaErrorInvalidValue;
  for (int j = 0; j < kMaxLeaves; ++j)
    r.ptr[j] = j < k ? static_cast<const uint32_t*>(rows[j]) : nullptr;
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.and_k) {
    case 2:
      rows_popcount_kernel<2><<<blocks, kThreads, 0, s>>>(r, E, W, p, g, o);
      break;
    case 3:
      rows_popcount_kernel<3><<<blocks, kThreads, 0, s>>>(r, E, W, p, g, o);
      break;
    case 4:
      rows_popcount_kernel<4><<<blocks, kThreads, 0, s>>>(r, E, W, p, g, o);
      break;
    default:
      rows_popcount_kernel<0><<<blocks, kThreads, 0, s>>>(r, E, W, p, g, o);
  }
  return (int)cudaGetLastError();
}

// popcount(B_heads[s,0] & ... & B_heads[s,k-2] & B_tails[t]) for every
// tail t of every segment s (see segment_popcount_kernel). offset_bytes is
// 4 (int32 offsets) or 8 (int64); chunk_tiles the tiles of 32 tails each
// warp takes.
int pg_fused_segment_popcount(const void* data, long long n, int W,
                              const void* heads, int k, long long S,
                              const void* offsets, int offset_bytes,
                              const void* tails, long long T,
                              int chunk_tiles, void* out, void* stream) {
  if (n < 1 || n > 0x7fffffffLL || W < 1 || k < 2 || k > 4 || S < 1 ||
      S > kSegMaxCount || T < 1 || T > kSegMaxCount || chunk_tiles < 1 ||
      (offset_bytes != 4 && offset_bytes != 8))
    return (int)cudaErrorInvalidValue;
  const int V = vector_words(W, data);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (offset_bytes == 4)
    return launch_segment_k<int32_t>(k, V, data, n, W, heads, S, offsets,
                                     tails, T, chunk_tiles, out, s);
  return launch_segment_k<long long>(k, V, data, n, W, heads, S, offsets,
                                     tails, T, chunk_tiles, out, s);
}

// The layout pg_fused_segment_popcount picks for rows of W words at data:
// layout[0] = words per vector load, [1] = lanes per row, [2] = cache
// slots per warp, [3] = shared memory bytes per block.
void pg_fused_segment_layout(int W, const void* data, int* layout) {
  const int V = vector_words(W, data);
  layout[0] = V;
  layout[1] = 1 << segment_group_log2(W, V);
  layout[2] = segment_slots(W);
  layout[3] = kSegWarps * layout[2] * W * 4;
}

}  // extern "C"
