// Set-expression popcount kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/fused_expr.py:
//   * pg_fused_gather_popcount <- fused_gather_popcount (body
//     _gather_expr_kernel, _popcount_accumulate, row DMA
//     bf_intersect._gather_rows), and its AND2 / AND3 forms
//     bf_intersect._edge_impl / _edge3_impl: for each tuple, gather k rows
//     of the sketch matrix, evaluate the AND/OR/ANDNOT tree, popcount it.
//   * pg_fused_rows_popcount <- fused_rows_popcount (body
//     _rows_expr_kernel), and its AND2 / AND3 forms
//     bf_intersect._pairs_impl / _pairs3_impl: the same tree over k dense,
//     pre-gathered operand matrices.
//   * pg_fused_segment_popcount <- the k-way AND form (k = 2, 3, 4) of
//     fused_gather_popcount and bf_intersect._edge3_impl, for tuples that
//     come in segments sharing their first k-1 rows (the clique launch);
//     its own note is above its kernel, below.
//
// What bounds the first two: memory. A tuple reads k rows of W words (and,
// gathered, its k ids) and writes one int32, for about k + 1 integer
// operations per word read, far below the card's operations-per-byte
// balance. The least time is the bytes moved over the card's memory
// bandwidth: each distinct row once, plus ids and outputs. A TC chunk
// (65,536 tuples of two 128-byte rows) moves ~17 MB: about 5 us, the
// order of a launch, so the kernel lives on latency: the id load, then
// the row loads, then the store, each a round trip to memory.
//
// Design (tile_popcount_kernel; one body, two row sources):
//   * A warp takes a tile of kTileTuples (16) consecutive tuples. Lane j
//     loads tuple j's ids once, one coalesced load per operand column (one
//     8-byte load for two-column tuples), clamps them to [0, n), and the
//     row groups take them by __shfl_sync: no lane loads an id another
//     lane holds. The dense form has no ids: operand p of tuple e is row e
//     of operand matrix p.
//   * Rows are read as vectors of V words: 16-byte loads when W % 4 == 0
//     and every base is 16-byte aligned, else 8 or 4 bytes. A group of G
//     lanes (the power of two >= W / V vectors, at most 32) reads one
//     row, so a warp reads 32 / G rows a step: four whole 128-byte rows at
//     W = 32. A tile takes kTileTuples / (32 / G) steps; the row loads of
//     kTileBatch (2) steps are all issued before the first is used. Rows
//     wider than 32 vectors are read in column blocks.
//   * The k-way AND (k = 2, 3, 4) is a template. Any other program is
//     rewritten on the host into operands in push order and binary ops
//     x[a] = x[a] op x[b] (a < b: the leftmost operand of each subtree
//     holds its value), so the kernel loads a step's operand vectors
//     first and then runs at most 7 ops on registers, each one switch
//     over the (op, a, b) code: no stack, no dynamically indexed array.
//     A leaf pushed twice is loaded twice (the second load hits L1).
//   * A shuffle tree sums each group's popcounts, a shuffle hands lane j
//     tuple j's sum, and the tile stores its outputs in one coalesced
//     store. Blocks run in any order, so where the Pallas kernel carries
//     its sum across grid steps over the word axis, here the loop over
//     words stays inside the group: no atomics, no second pass.
//   * Ragged T and any W are masked here, so callers pad nothing. The
//     expression arrives as data (at most 16 postfix instructions over at
//     most 8 leaves), and the same program drives the plain PyTorch
//     version.
//   * Like the segmented kernel, it is bound by latency before bandwidth:
//     on the card, tiles of 16 tuples with batches of 2 steps (48
//     registers at AND2) beat tiles of 32 or 8, batches of 1, 4 or 8,
//     8-warp blocks and the L2::128B prefetch hint on the row loads
//     (segment_variants.py --tile at the root of the repository times the
//     variants; PERF.md).
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
constexpr int kPush = 0, kAnd = 1, kOr = 2, kAndNot = 3;
constexpr unsigned kFull = 0xffffffffu;

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
__device__ __forceinline__ uint32_t vor(uint32_t a, uint32_t b) {
  return a | b;
}
__device__ __forceinline__ uint2 vor(uint2 a, uint2 b) {
  return make_uint2(a.x | b.x, a.y | b.y);
}
__device__ __forceinline__ uint4 vor(uint4 a, uint4 b) {
  return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}
__device__ __forceinline__ uint32_t vandn(uint32_t a, uint32_t b) {
  return a & ~b;
}
__device__ __forceinline__ uint2 vandn(uint2 a, uint2 b) {
  return make_uint2(a.x & ~b.x, a.y & ~b.y);
}
__device__ __forceinline__ uint4 vandn(uint4 a, uint4 b) {
  return make_uint4(a.x & ~b.x, a.y & ~b.y, a.z & ~b.z, a.w & ~b.w);
}
__device__ __forceinline__ uint32_t vpopc(uint32_t a) { return __popc(a); }
__device__ __forceinline__ uint32_t vpopc(uint2 a) {
  return __popc(a.x) + __popc(a.y);
}
__device__ __forceinline__ uint32_t vpopc(uint4 a) {
  return __popc(a.x) + __popc(a.y) + __popc(a.z) + __popc(a.w);
}
template <typename VT> __device__ __forceinline__ VT vzero() { return VT{}; }

__device__ __forceinline__ int clamp_id(int id, int n) {
  return id < 0 ? 0 : (id >= n ? n - 1 : id);
}

// Rows are read V words at a time: 4 when W % 4 == 0 and the address is
// 16-byte aligned, 2 when W is even and it is 8-byte aligned, else 1.
int vector_words(int W, const void* data) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(data);
  if (W % 4 == 0 && a % 16 == 0) return 4;
  if (W % 2 == 0 && a % 8 == 0) return 2;
  return 1;
}

// log2 of the lanes per row: the power of two >= the row's vectors,
// capped at a warp.
int group_log2_for(int vectors) {
  int g = 0;
  while ((1 << g) < vectors && g < 5) ++g;
  return g;
}

// ---------------------------------------------------------------------------
// The [T, k] gather and dense forms: tiles of tuples (the note at the top).
// ---------------------------------------------------------------------------

constexpr int kTileWarps = 4;     // warps per block
constexpr int kTileTuples = 16;   // tuples per warp: one tile
constexpr int kTileBatch = 2;     // steps whose row loads are in flight (AND)
constexpr int kProgBatch = 1;     // the same for other programs (8 operands)

// The expression as the kernel runs it: n_push operands in push order and
// n_push - 1 binary ops, op i being x[a] = x[a] op x[b] with code
// op << 6 | a << 3 | b. The result is x[0].
struct Expr {
  int n_push;
  int col[kMaxLeaves];          // gather form: the tuple column of operand p
  int code[kMaxLeaves - 1];
};

// Gather form: operand p of tuple t is row clamp(tuples[t][col[p]]) of data.
struct GatherSrc {
  static constexpr bool kGather = true;
  const uint32_t* data;         // [n, W]
  const int32_t* tuples;        // [T, cols]
  long long T;
  int cols;
  int last;                     // the last row id: min(n - 1, INT_MAX)
  int pair_ids;                 // cols == 2, 8-byte aligned: one int2 load
};

// Dense form: operand p of tuple e is row e of ptr[p].
struct RowsSrc {
  static constexpr bool kGather = false;
  const uint32_t* ptr[kMaxLeaves];   // [E, W] each, in push order
  long long T;
};

__device__ __forceinline__ int clamp_last(int id, int last) {
  return id < 0 ? 0 : min(id, last);
}

#define PG_OPS(a, b)                                                       \
  case kAnd << 6 | (a) << 3 | (b): x[a] = vand(x[a], x[b]); break;         \
  case kOr << 6 | (a) << 3 | (b): x[a] = vor(x[a], x[b]); break;           \
  case kAndNot << 6 | (a) << 3 | (b): x[a] = vandn(x[a], x[b]); break;

// The expression on one step's operand vectors. K > 0: the K-way AND of
// operands 0..K-1; K == 0: the ops of e, each a switch over its code.
template <int K, int NP, typename VT>
__device__ __forceinline__ VT eval_expr(const Expr& e, VT (&x)[NP]) {
  if constexpr (K > 0) {
    VT v = x[0];
#pragma unroll
    for (int p = 1; p < K; ++p) v = vand(v, x[p]);
    return v;
  } else {
#pragma unroll
    for (int i = 0; i < kMaxLeaves - 1; ++i) {
      if (i < e.n_push - 1) {
        switch (e.code[i]) {
          PG_OPS(0, 1) PG_OPS(0, 2) PG_OPS(0, 3) PG_OPS(0, 4) PG_OPS(0, 5)
          PG_OPS(0, 6) PG_OPS(0, 7) PG_OPS(1, 2) PG_OPS(1, 3) PG_OPS(1, 4)
          PG_OPS(1, 5) PG_OPS(1, 6) PG_OPS(1, 7) PG_OPS(2, 3) PG_OPS(2, 4)
          PG_OPS(2, 5) PG_OPS(2, 6) PG_OPS(2, 7) PG_OPS(3, 4) PG_OPS(3, 5)
          PG_OPS(3, 6) PG_OPS(3, 7) PG_OPS(4, 5) PG_OPS(4, 6) PG_OPS(4, 7)
          PG_OPS(5, 6) PG_OPS(5, 7) PG_OPS(6, 7)
          default: break;
        }
      }
    }
    return x[0];
  }
}

#undef PG_OPS

template <class Src, int K, int V>
__global__ void __launch_bounds__(kTileWarps * 32)
tile_popcount_kernel(Src src, Expr e, int W, int group_log2,
                     int32_t* __restrict__ out) {
  using VT = typename VecOf<V>::T;
  constexpr int NP = K > 0 ? K : kMaxLeaves;       // operand slots
  constexpr int B = K > 0 ? kTileBatch : kProgBatch;
  const int np = K > 0 ? K : e.n_push;
  const int lane = threadIdx.x & 31;
  const int G = 1 << group_log2;             // lanes per row
  const int P = 32 >> group_log2;            // rows per warp step
  const int g = lane >> group_log2;          // this lane's group
  const int gl = lane & (G - 1);             // its lane within the group
  const int NV = W / V;                      // vectors per row
  const int ncb = (NV + G - 1) / G;          // column blocks
  const int steps = (kTileTuples + P - 1) / P;
  const long long b =
      ((long long)blockIdx.x * kTileWarps + (threadIdx.x >> 5)) * kTileTuples;
  if (b >= src.T) return;                    // whole warp: warp-uniform
  const int nvalid = (int)min((long long)kTileTuples, src.T - b);
  const bool live = lane < nvalid;

  // lane j: the row ids of tuple b + j, one per operand (gather form)
  int id[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) id[p] = 0;
  if constexpr (Src::kGather) {
    if (src.pair_ids) {
      int2 two = make_int2(0, 0);
      if (live)
        two = __ldg(reinterpret_cast<const int2*>(src.tuples) + b + lane);
#pragma unroll
      for (int p = 0; p < NP; ++p)
        if (p < np) id[p] = clamp_last(e.col[p] ? two.y : two.x, src.last);
    } else {
      const int32_t* tup = src.tuples + (b + lane) * src.cols;
#pragma unroll
      for (int p = 0; p < NP; ++p)
        if (p < np && live) id[p] = clamp_last(__ldg(tup + e.col[p]),
                                               src.last);
    }
  }

  int res = 0;
  for (int j0 = 0; j0 < steps; j0 += B) {
    // the operand rows of each step of the batch
    const VT* row[B][NP];
    bool ok[B];
#pragma unroll
    for (int j = 0; j < B; ++j) {
      const int idx = (j0 + j) * P + g;      // tile position of the tuple
      ok[j] = j0 + j < steps && idx < nvalid;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        if (p < np) {
          if constexpr (Src::kGather) {
            const int r = __shfl_sync(kFull, id[p], idx & 31);
            row[j][p] = reinterpret_cast<const VT*>(src.data) + (size_t)r * NV;
          } else {
            row[j][p] = reinterpret_cast<const VT*>(src.ptr[p]) +
                        (size_t)(b + (ok[j] ? idx : 0)) * NV;
          }
        } else {
          row[j][p] = nullptr;
        }
      }
    }
    uint32_t acc[B];
#pragma unroll
    for (int j = 0; j < B; ++j) acc[j] = 0;
    for (int cb = 0; cb < ncb; ++cb) {
      const int c = cb * G + gl;             // this lane's vector of a row
      const bool cin = c < NV;
      VT x[B][NP];
#pragma unroll
      for (int j = 0; j < B; ++j)
#pragma unroll
        for (int p = 0; p < NP; ++p)
          x[j][p] = (p < np && ok[j] && cin) ? __ldg(row[j][p] + c)
                                             : vzero<VT>();
#pragma unroll
      for (int j = 0; j < B; ++j) acc[j] += vpopc(eval_expr<K>(e, x[j]));
    }
    // sum each group; lane L keeps tuple L's sum (step L / P, group L % P)
#pragma unroll
    for (int j = 0; j < B; ++j) {
      uint32_t sum = acc[j];
      for (int o = G >> 1; o > 0; o >>= 1)
        sum += __shfl_xor_sync(kFull, sum, o);
      const uint32_t mine =
          __shfl_sync(kFull, sum, (lane & (P - 1)) << group_log2);
      if ((lane >> (5 - group_log2)) == j0 + j) res = (int)mine;
    }
  }
  if (live) out[b + lane] = res;
}

template <class Src, int K, int V>
int launch_tile(const Src& src, const Expr& e, int W, int32_t* out,
                cudaStream_t stream) {
  const long long per_block = (long long)kTileWarps * kTileTuples;
  const long long blocks = (src.T + per_block - 1) / per_block;
  if (blocks < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  tile_popcount_kernel<Src, K, V><<<(unsigned)blocks, kTileWarps * 32, 0,
                                    stream>>>(
      src, e, W, group_log2_for(W / V), out);
  return (int)cudaGetLastError();
}

template <class Src, int K>
int launch_tile_v(int V, const Src& src, const Expr& e, int W, int32_t* out,
                  cudaStream_t stream) {
  switch (V) {
    case 4: return launch_tile<Src, K, 4>(src, e, W, out, stream);
    case 2: return launch_tile<Src, K, 2>(src, e, W, out, stream);
    default: return launch_tile<Src, K, 1>(src, e, W, out, stream);
  }
}

template <class Src>
int launch_tile_k(int and_k, int V, const Src& src, const Expr& e, int W,
                  void* out, void* stream) {
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (and_k) {
    case 2: return launch_tile_v<Src, 2>(V, src, e, W, o, s);
    case 3: return launch_tile_v<Src, 3>(V, src, e, W, o, s);
    case 4: return launch_tile_v<Src, 4>(V, src, e, W, o, s);
    default: return launch_tile_v<Src, 0>(V, src, e, W, o, s);
  }
}

// Check the packed program (opcodes, leaf indices, stack discipline, the
// AND fast path's claim and, when tuple_cols > 0, that every leaf's column
// exists) and rewrite it into e: operands in push order (leaf[p] is the
// leaf operand p reads) and ops on their positions. *and_k is K when the
// program is the K-way AND of leaves 0..K-1 in order (K = 2, 3, 4: the
// template), else 0.
bool compile_expr(const int* packed, int tuple_cols, Expr* e,
                  int leaf[kMaxLeaves], int* and_k) {
  const int n_instr = packed[0], n_leaves = packed[1], claim = packed[2];
  const int* op = packed + 3;
  const int* arg = packed + 3 + kMaxInstr;
  const int* slot = packed + 3 + 2 * kMaxInstr;
  if (n_instr < 1 || n_instr > kMaxInstr || n_leaves < 1 ||
      n_leaves > kMaxLeaves || claim < 0 || claim > n_leaves)
    return false;
  for (int j = 0; j < n_leaves; ++j)
    if (tuple_cols > 0 && (slot[j] < 0 || slot[j] >= tuple_cols))
      return false;
  int st[kMaxLeaves];              // stack of operand positions
  int sp = 0, np = 0, nop = 0;
  for (int i = 0; i < n_instr; ++i) {
    if (op[i] == kPush) {
      if (arg[i] < 0 || arg[i] >= n_leaves || np == kMaxLeaves) return false;
      leaf[np] = arg[i];
      e->col[np] = slot[arg[i]];
      st[sp++] = np++;
    } else if (op[i] >= kAnd && op[i] <= kAndNot && sp >= 2) {
      const int bpos = st[--sp];
      e->code[nop++] = op[i] << 6 | st[sp - 1] << 3 | bpos;
    } else {
      return false;
    }
  }
  if (sp != 1) return false;
  e->n_push = np;
  for (int p = np; p < kMaxLeaves; ++p) { leaf[p] = 0; e->col[p] = 0; }
  for (int i = nop; i < kMaxLeaves - 1; ++i) e->code[i] = 0;
  // the K-way AND: operand p is leaf p, op i is x[0] &= x[i + 1]
  bool chain = np >= 2;
  for (int p = 0; p < np && chain; ++p) chain = leaf[p] == p;
  for (int i = 0; i < nop && chain; ++i)
    chain = e->code[i] == (kAnd << 6 | (i + 1));
  if (claim != 0 && (!chain || claim != np)) return false;
  *and_k = chain && np <= 4 ? np : 0;
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
// shared memory the segment cache of one block may take (the default limit)
constexpr int kSegSmemBytes = 48 * 1024;
// most segments and tails one launch takes: positions stay 32-bit
constexpr long long kSegMaxCount = 1LL << 30;

template <typename OffT>
__device__ __forceinline__ int seg_end(const OffT* __restrict__ off, int i,
                                       int S) {
  return i <= S ? (int)__ldg(off + i) : INT_MAX;
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
  Expr e;
  int leaf[kMaxLeaves], and_k;
  if (!compile_expr(program, tuple_cols, &e, leaf, &and_k) || n < 1 ||
      W < 1 || tuple_cols < 1)
    return (int)cudaErrorInvalidValue;
  const GatherSrc src{
      static_cast<const uint32_t*>(data), static_cast<const int32_t*>(tuples),
      T, tuple_cols, (int)(n - 1 < INT_MAX ? n - 1 : INT_MAX),
      tuple_cols == 2 && reinterpret_cast<uintptr_t>(tuples) % 8 == 0};
  return launch_tile_k(and_k, vector_words(W, data), src, e, W, out, stream);
}

int pg_fused_rows_popcount(const void* const* rows, int k, long long E, int W,
                           const int* program, void* out, void* stream) {
  Expr e;
  int leaf[kMaxLeaves], and_k;
  if (!compile_expr(program, 0, &e, leaf, &and_k) || k != program[1] ||
      W < 1)
    return (int)cudaErrorInvalidValue;
  RowsSrc src;
  src.T = E;
  uintptr_t bases = 0;                       // every operand's address bits
  for (int p = 0; p < kMaxLeaves; ++p) {
    src.ptr[p] = p < e.n_push ? static_cast<const uint32_t*>(rows[leaf[p]])
                              : nullptr;
    bases |= reinterpret_cast<uintptr_t>(src.ptr[p]);
  }
  return launch_tile_k(and_k, vector_words(W, reinterpret_cast<void*>(bases)),
                       src, e, W, out, stream);
}

// The layout both [T, k] kernels pick for rows of W words at data:
// layout[0] = words per vector load, [1] = lanes per row, [2] = rows per
// warp step, [3] = column blocks, [4] = tuples per warp, [5] = steps per
// batch of row loads (k-way AND), [6] = warps per block.
void pg_fused_tile_layout(int W, const void* data, int* layout) {
  const int V = vector_words(W, data);
  const int glog = group_log2_for(W / V);
  layout[0] = V;
  layout[1] = 1 << glog;
  layout[2] = 32 >> glog;
  layout[3] = (W / V + (1 << glog) - 1) >> glog;
  layout[4] = kTileTuples;
  layout[5] = kTileBatch;
  layout[6] = kTileWarps;
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
