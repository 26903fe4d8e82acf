// Causal (optionally sliding-window) GQA attention forward for Hopper
// (sm_90a) on float32 inputs, with an online softmax on the CUDA cores.
// bfloat16 inputs go to the tensor-core kernel of flash_attention_wgmma.cu.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py:
// flash_attention_folded (body _fa_kernel), called through its wrapper
// flash_attention. Semantics kept from the reference:
//   * scores (q * 1/sqrt(D)) . k in fp32, q scaled in fp32 before the dot;
//   * causal with query and key positions both starting at 0, optional
//     window (kv_pos > q_pos - window); masked scores are -1e30;
//   * GQA/MQA: query head i reads kv head i / groups;
//   * fp32 running max, denominator and accumulator; out = acc /
//     max(l, 1e-30).
// Unlike the reference, which visits only skv / block_kv full kv blocks
// and so drops the keys of a ragged tail, every key is attended.
//
// What bounds it: operations. Attention does 4·D flops per (query, key)
// pair it attends and moves only Q, K, V and O, so at the repo's prefill
// shapes (S = 8K..32K, D = 120..256) it sits far above the card's
// operations-per-byte balance. The least time is the attended pairs'
// flops over the peak rate of the inputs' type: for float32 the 67
// TFLOP/s of the fp32 cores, where this kernel runs both products (TF32
// tensor cores would break the reference's fp32 parity of 2e-5).
//
// Design (simple first):
//   * One block of 256 threads per (head, tile of 64 queries). The grid is
//     1-D and hands out the last query tiles first: under a causal mask
//     they have the most keys, so the long blocks start early.
//   * The Q tile (pre-scaled) and each 64-key K and V tile are staged in
//     shared memory, zero-padded to Dp = 16·2^j >= D
//     (Dp up to 256; above 48 KB the block's dynamic shared memory is
//     raised with cudaFuncSetAttribute). Q and K rows have an odd stride,
//     so the 16 threads of a row group read 16 different banks.
//   * Thread (ty, tx) of the 16x16 block owns query rows ty + 16i (i < 4),
//     score columns tx + 16j (j < 4) and output columns tx + 16j (j <
//     Dp/16). A row's max and sum close with width-16 xor shuffles.
//   * The kv loop visits only the tiles that intersect the tile's causal /
//     window band. When a row of the tile sees no key at all (window > 0
//     and Sq > Skv), the block visits every tile: its scores are then all
//     -1e30 and the reference's softmax gives the mean of all values.
//   * Keys past Skv score -inf (weight exactly 0), queries past Sq are
//     computed and not stored, so any Sq, Skv >= 1 and any D <= 256 run.
//   * Inputs are read through (batch, head, position) strides, so the
//     [B, S, H, D] layout needs no folded copy; the last dim is contiguous.
//   * expf, not __expf, and a true division at the end, for fp32 parity.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see repro_torch/kernels/_build.py). Plain C
//        interface, loaded with ctypes; the entry point returns the
//        cudaError_t of its launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // 16 x 16
constexpr int kBQ = 64;            // query rows per block
constexpr int kBKV = 64;           // keys per tile
constexpr int kPS = kBKV + 1;      // row stride of the probability tile
constexpr float kMasked = -1e30f;  // the reference's masked score
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_b, q_h, q_s;  // element strides: batch, head, position
  long long k_b, k_h, k_s;
  long long v_b, v_h, v_s;
  long long o_b, o_h, o_s;
  int bh, sq, skv, d;
  int heads_q, heads_kv, groups, window;
  int q_tiles;
  float scale;
};

template <int NJ>
constexpr int smem_floats() {
  constexpr int Dp = 16 * NJ;
  return kBQ * (Dp + 1) + kBKV * (Dp + 1) + kBKV * Dp + kBQ * kPS;
}

template <int NJ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  constexpr int Dp = 16 * NJ;
  constexpr int QS = Dp + 1;
  extern __shared__ float smem[];
  float* Qs = smem;              // [kBQ][QS]
  float* Ks = Qs + kBQ * QS;     // [kBKV][QS]
  float* Vs = Ks + kBKV * QS;    // [kBKV][Dp]
  float* Ps = Vs + kBKV * Dp;    // [kBQ][kPS]

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int head = blockIdx.x % p.bh;
  const int qt = p.q_tiles - 1 - blockIdx.x / p.bh;  // last tiles first
  const int q0 = qt * kBQ;
  const int kv_head = head / p.groups;

  const float* q = static_cast<const float*>(p.q) +
               (long long)(head / p.heads_q) * p.q_b +
               (long long)(head % p.heads_q) * p.q_h;
  const float* k = static_cast<const float*>(p.k) +
               (long long)(kv_head / p.heads_kv) * p.k_b +
               (long long)(kv_head % p.heads_kv) * p.k_h;
  const float* v = static_cast<const float*>(p.v) +
               (long long)(kv_head / p.heads_kv) * p.v_b +
               (long long)(kv_head % p.heads_kv) * p.v_h;
  float* o = static_cast<float*>(p.o) + (long long)(head / p.heads_q) * p.o_b +
         (long long)(head % p.heads_q) * p.o_h;

  for (int i = threadIdx.x; i < kBQ * Dp; i += kThreads) {
    const int r = i / Dp, c = i % Dp;
    const int pos = q0 + r;
    float x = 0.f;
    if (pos < p.sq && c < p.d) x = q[pos * p.q_s + c] * p.scale;
    Qs[r * QS + c] = x;
  }

  // the kv tiles that meet the tile's band
  const int q_last = min(q0 + kBQ, p.sq) - 1;
  int kv_lo = 0, kv_hi = min(p.skv - 1, q_last);
  if (p.window > 0) {
    kv_lo = max(0, q0 - p.window + 1);
    if (q_last - p.window + 1 > p.skv - 1) {  // a row of the tile sees no key
      kv_lo = 0;
      kv_hi = p.skv - 1;
    }
  }

  float m_i[4], l_i[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kMasked;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int t = kv_lo / kBKV; t <= kv_hi / kBKV; ++t) {
    const int k0 = t * kBKV;
    __syncthreads();  // the Q tile is written; the last tile is consumed
    for (int i = threadIdx.x; i < kBKV * Dp; i += kThreads) {
      const int r = i / Dp, c = i % Dp;
      const int pos = k0 + r;
      const bool in = pos < p.skv && c < p.d;
      Ks[r * QS + c] = in ? k[pos * p.k_s + c] : 0.f;
      Vs[r * Dp + c] = in ? v[pos * p.v_s + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < Dp; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * QS + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ks[(tx + 16 * j) * QS + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q0 + r;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x;
        if (kpos >= p.skv) {
          x = -INFINITY;  // not a key: weight exactly 0
        } else {
          const bool ok = kpos <= qpos &&
                          (p.window == 0 || kpos > qpos - p.window);
          x = ok ? s[i][j] : kMasked;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = expf(s[i][j] - m_new);
        rs += pj;
        Ps[r * kPS + tx + 16 * j] = pj;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(kFull, rs, off);
      l_i[i] = l_i[i] * alpha + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBKV; ++c) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = Ps[(ty + 16 * i) * kPS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = Vs[c * Dp + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pr[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= p.sq) continue;
    const float den = fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < p.d) o[qpos * p.o_s + c] = acc[i][j] / den;
    }
  }
}

template <int NJ>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int bytes = smem_floats<NJ>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)p.bh * p.q_tiles;
  flash_fwd_kernel<NJ><<<(unsigned)blocks, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch(const Params& p, cudaStream_t stream) {
  if (p.d <= 16) return launch<1>(p, stream);
  if (p.d <= 32) return launch<2>(p, stream);
  if (p.d <= 64) return launch<4>(p, stream);
  if (p.d <= 128) return launch<8>(p, stream);
  return launch<16>(p, stream);
}

}  // namespace

extern "C" {

const char* pg_flash_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// q, k, v, o: device pointers to float32.
// strides: 12 element strides, (batch, head, position) of q, k, v and o;
// the head dim is contiguous. Query head `h` of `bh` = batch·heads_q
// reads kv head h / groups of batch·heads_kv.
int pg_flash_attention(const void* q, const void* k, const void* v, void* o,
                       int bh, int sq, int skv, int d,
                       int heads_q, int heads_kv, int groups, int window,
                       float scale, const long long* strides, void* stream) {
  if (bh < 1 || sq < 1 || skv < 1 || d < 1 || d > 256 || heads_q < 1 ||
      heads_kv < 1 || groups < 1 || window < 0 || bh % groups != 0 ||
      bh % heads_q != 0 || (bh / groups) % heads_kv != 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_b = strides[0]; p.q_h = strides[1]; p.q_s = strides[2];
  p.k_b = strides[3]; p.k_h = strides[4]; p.k_s = strides[5];
  p.v_b = strides[6]; p.v_h = strides[7]; p.v_s = strides[8];
  p.o_b = strides[9]; p.o_h = strides[10]; p.o_s = strides[11];
  p.bh = bh;
  p.sq = sq;
  p.skv = skv;
  p.d = d;
  p.heads_q = heads_q;
  p.heads_kv = heads_kv;
  p.groups = groups;
  p.window = window;
  p.q_tiles = (sq + kBQ - 1) / kBQ;
  p.scale = scale;
  if ((long long)bh * p.q_tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch(p, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
