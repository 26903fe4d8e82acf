// Set-expression popcount kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/fused_expr.py:
//   * pg_fused_gather_popcount <- fused_gather_popcount (body
//     _gather_expr_kernel, _popcount_accumulate, row DMA
//     bf_intersect._gather_rows): for each tuple, gather k rows of the
//     sketch matrix, evaluate the AND/OR/ANDNOT tree, popcount the row.
//   * pg_fused_rows_popcount <- fused_rows_popcount (body
//     _rows_expr_kernel): the same tree over k dense, pre-gathered rows.
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

}  // extern "C"
