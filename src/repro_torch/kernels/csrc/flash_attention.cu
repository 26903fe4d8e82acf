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
//   * fp32 running max, denominator and accumulator, expf (not __expf);
//     out = acc / max(l, 1e-30) with a true division.
// Unlike the reference, which visits only skv / block_kv full kv blocks
// and so drops the keys of a ragged tail, every key is attended. Keys past
// Skv score -inf (weight exactly 0); queries past Sq are computed and not
// stored, so any Sq, Skv >= 1 and any D <= 256 run. Inputs are read
// through their (batch, head, position) strides; the last dim is
// contiguous.
//
// What bounds it: operations. Attention does 4·D flops per (query, key)
// pair it attends and moves only Q, K, V and O, so at the repo's shapes it
// sits far above the card's operations-per-byte balance. Both products run
// in fp32 on the CUDA cores (TF32 tensor cores would break the reference's
// fp32 parity of 2e-5), so the least time is the attended pairs' flops over
// the fp32 cores' 67 TFLOP/s.
//
// What held the first version back (one block per (head, 64 queries), a
// 4x4 score tile per thread, synchronous K/V tiles):
//   * scalar shared-memory loads fed too few FMAs: 8 LDS per 16 FFMA in
//     Q·K^T and 4 + D/16 per 4·D/16 in P·V, where an SM issues four FFMA
//     warp-instructions per shared-memory wavefront;
//   * every K/V tile was loaded through registers and fenced by three
//     barriers, so no load overlapped the products;
//   * 115 KB of shared memory at D = 128 left one block of 8 warps an SM;
//   * each of the `groups` query heads of a kv head filled the same K/V
//     tiles into its own block (4x for qwen3_8b, 8x for MQA).
//
// Design, point by point:
//   1. GQA heads share a K/V tile. A block takes `hp` query heads of one kv
//      head (hp = min(groups, R); larger groups split into packs) and bq =
//      R / hp query positions: R rows in all, row r being head r / bq at
//      position q0 + r % bq. Every K/V tile in shared memory serves all of
//      them. The rows share their positions, so the causal/window band and
//      the no-key rule (a tile in which some row sees no key visits every
//      kv tile; its scores are then all -1e30 and the reference's softmax
//      gives the mean of all values) stay per tile. The grid is (batch ·
//      kv heads · packs) x query tiles, the last (heaviest under the causal
//      mask) tiles first.
//   2. Register tiles fed by 16-byte shared loads, each warp owning WR =
//      16 rows (8 at D > 128) for both products, as FlashAttention-2 splits
//      rows over warps. Q·K^T: a lane owns 4 rows x SC keys of S (SC = 4,
//      or 2 at D > 128). Q sits transposed in shared memory (Qt[d][row],
//      written once per block), K row-major, so a step of 4 d reads SC K
//      rows and 4 Qt rows as float4: 8 LDS.128 per 64 FFMA. P·V: a lane
//      owns 8 rows x 8 columns of O (fewer columns at D < 128); P goes
//      through the warp's own strip of shared memory (Pt[key][row], fenced
//      by __syncwarp), and each key reads 2 float4 of P and 2 of V: 4
//      LDS.128 per 64 FFMA. The row maxima, rescale factors and
//      denominators reach the P·V lanes by shuffles. Row strides are padded
//      (K by 4 floats, Qt by 8, the P strip by 4) so that the lanes of a
//      quarter-warp that read different rows hit different banks.
//   3. An asynchronous K/V ring of 2 stages of BKV = 32 keys, filled by
//      cp.async: tile t + 1 is issued right after the one block barrier of
//      tile t and lands while tile t's two products run. No other barrier
//      spans the block, so one warp's Q·K^T overlaps another's P·V. Each
//      thread copies chunks of W floats: 4 (16 bytes, cp.async.cg) when
//      the block's K and V bases and position strides are 16-byte
//      multiples, else 2 (cp.async.ca 8) or 1 (cp.async.ca 4), as for D =
//      30 or a strided q[..., 2:32] view. The width is chosen per block
//      from the pointers, as vector_words does in fused_expr.cu; the copy's
//      source size zero-fills keys past Skv and columns past D.
//   4. Occupancy by design. Three shapes of block (Tile below):
//        D <= 128 "wide":   R = 192 rows, 384 threads (12 warps), 1 block
//                           an SM (Qt 100 KB + ring 66 KB + P strips 30 KB
//                           at D = 128: 200 KB);
//        D <= 128 "narrow": R = 96, 192 threads, 2 blocks an SM where the
//                           shared memory allows (D <= 64), for grids too
//                           small to fill the card with wide blocks (fewer
//                           than 2 per SM): a wide block's 192 rows over
//                           the whole causal band would then set the time;
//        D > 128:           R = 64, 256 threads (8 warps), a 4x2 score tile
//                           (218 KB at D = 256).
//      Registers stay within __launch_bounds__'s 168 (wide, narrow) and
//      255 (D > 128) without spills (chip_smoke.py prints ptxas's counts).
//   5. The SASS (cuobjdump -sass of the built library, counted by
//      chip_smoke.py phase 2) holds no tensor-core instruction. Its
//      innermost loops at D = 128: Q·K^T 512 FFMA / 64 LDS.128 (8 FFMA
//      each), P·V 512 FFMA / 32 LDS.128 (16); at D = 256 256 / 48 (5.3)
//      and 512 / 32 (16); at D = 64 P·V 256 / 24 (10.7); at D = 16 P·V
//      64 / 16 (4). The Q·K^T loop is unrolled by 8 steps of 4 d, and P·V
//      runs each column of V over the lane's 8 rows: both measured faster
//      than the other orders and depths tried.
//
// What bounds it now (timed on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md):
// with every shared load hoisted out of the two loops they run at the FFMA
// rate nvcc's code reaches in a register-only 8x8 outer product, about 50
// of the 67 TFLOP/s; the shared loads add about a fifth to the loops, most
// of it in Q·K^T: an LDS.128 whose quarter-warps read 4 or more addresses
// costs 4 cycles of the shared-memory pipe, one that reads at most 2 about
// 2, and the 8 lanes of a quarter-warp hold 8 different (rows, keys) tiles,
// so one of the two operands always has 4 or more. A larger score tile
// would need BKV = 64, whose ring and P strips do not fit beside a
// 192-row Qt.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see repro_torch/kernels/_build.py). Plain C
//        interface, loaded with ctypes; the entry point returns the
//        cudaError_t of its launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMasked = -1e30f;  // the reference's masked score
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBKV = 32;           // keys per K/V tile

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
  int hp, bq, packs, units, q_tiles;  // heads a block, positions, packs,
                                      // (kv head, pack) pairs, query tiles
  float scale;
};

// One block's shape: DP = padded head dim (16·2^j), R rows, NT threads.
// Each warp owns WR = R / warps rows for both products.
template <int DP, int R, int NT>
struct Tile {
  static constexpr int BKV = kBKV;
  static constexpr int WARPS = NT / 32;
  static constexpr int WR = R / WARPS;      // rows a warp owns
  static constexpr int SR = 4;              // S rows a lane
  static constexpr int KG = 32 * SR / WR;   // lanes sharing an S row
  static constexpr int SC = BKV / KG;       // S keys a lane
  static constexpr int OR = 8;              // O rows a lane
  static constexpr int CG = 32 * OR / WR;   // lanes sharing O rows
  static constexpr int OC = DP / CG;        // O columns a lane
  static constexpr int CV = OC < 4 ? OC : 4;  // O column vector width
  static constexpr int NCS = OC / CV;       // O column segments
  static constexpr int QS = R + 8;          // Qt row stride (floats)
  static constexpr int PW = WR + 4;         // a warp's Pt row stride
  static constexpr int KS = DP + 4;         // K row stride
  static constexpr int VS = DP;             // V row stride
  static constexpr int FLOATS =
      DP * QS + 2 * BKV * KS + 2 * BKV * VS + WARPS * BKV * PW;
  static constexpr int BYTES = FLOATS * (int)sizeof(float);
  static_assert(WR % OR == 0 && WR * WARPS == R, "rows");
  static_assert(SC * KG == BKV && OC * CG == DP, "lane tiles");
  static_assert(BYTES <= 232448, "shared memory");
};

template <int N>
__device__ __forceinline__ void lds(const float* p, float* out) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  } else {
    out[0] = *p;
  }
}

__device__ __forceinline__ void sts4(float* p, float a, float b, float c,
                                     float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// cp.async of W floats (4: 16 bytes, .cg; 2 and 1: .ca), reading the
// first src_bytes bytes and zero-filling the rest.
template <int W>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (W == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
  else if constexpr (W == 2)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// floats per cp.async: the widest that every row's start meets
__device__ __forceinline__ int copy_width(const float* kb, const float* vb,
                                          long long k_s, long long v_s) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(kb) |
                      reinterpret_cast<uintptr_t>(vb) |
                      (uintptr_t)(k_s * 4) | (uintptr_t)(v_s * 4);
  return a % 16 == 0 ? 4 : a % 8 == 0 ? 2 : 1;
}

// Issue the copies of the K and V rows k0 .. k0 + BKV - 1 into one ring
// stage, W floats a cp.async; keys past skv and columns past d read
// nothing and are zero-filled.
template <int DP, int R, int NT, int W>
__device__ __forceinline__ void copy_kv(float* kd, float* vd,
                                        const float* kb, const float* vb,
                                        const Params& p, int k0) {
  using T = Tile<DP, R, NT>;
  constexpr int CPR = DP / W, CHUNKS = T::BKV * CPR;
#pragma unroll 4
  for (int c = 0; c < (CHUNKS + NT - 1) / NT; ++c) {
    const int i = threadIdx.x + c * NT;
    if (CHUNKS % NT != 0 && i >= CHUNKS) break;
    const int key = i / CPR, d0 = (i % CPR) * W;
    const int pos = k0 + key;
    const int n = pos < p.skv ? max(0, min(W, p.d - d0)) : 0;
    cp_async<W>(kd + key * T::KS + d0, n ? kb + pos * p.k_s + d0 : kb, 4 * n);
    cp_async<W>(vd + key * T::VS + d0, n ? vb + pos * p.v_s + d0 : vb, 4 * n);
  }
}

template <int DP, int R, int NT>
__global__ void __launch_bounds__(NT, (DP <= 128 && R == 96) ? 2 : 1)
flash_fwd_kernel(const Params p) {
  using T = Tile<DP, R, NT>;
  constexpr int BKV = T::BKV, WR = T::WR, SC = T::SC, KG = T::KG;
  constexpr int CG = T::CG, OC = T::OC, CV = T::CV, NCS = T::NCS;
  constexpr int QS = T::QS, PW = T::PW, KS = T::KS, VS = T::VS;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [DP][QS], q * scale
  float* Ks = Qt + DP * QS;                     // 2 x [BKV][KS]
  float* Vs = Ks + 2 * BKV * KS;                // 2 x [BKV][VS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* Pw = Vs + 2 * BKV * VS + warp * BKV * PW;  // the warp's [BKV][PW]
  const int unit = blockIdx.x % p.units;
  const int q0 = (p.q_tiles - 1 - blockIdx.x / p.units) * p.bq;
  const int g = unit / p.packs;  // kv head of batch·heads_kv
  const int pack = unit % p.packs;
  const int h0 = g * p.groups + pack * p.hp;  // first query head
  const int nh = min(p.hp, p.groups - pack * p.hp);

  const float* kb = static_cast<const float*>(p.k) +
                    (long long)(g / p.heads_kv) * p.k_b +
                    (long long)(g % p.heads_kv) * p.k_h;
  const float* vb = static_cast<const float*>(p.v) +
                    (long long)(g / p.heads_kv) * p.v_b +
                    (long long)(g % p.heads_kv) * p.v_h;
  const int width = copy_width(kb, vb, p.k_s, p.v_s);

  // the kv tiles that meet the tile's band
  const int q_last = min(q0 + p.bq, p.sq) - 1;
  int kv_lo = 0, kv_hi = min(p.skv - 1, q_last);
  if (p.window > 0) {
    kv_lo = max(0, q0 - p.window + 1);
    if (q_last - p.window + 1 > p.skv - 1) {  // a row of the tile sees no key
      kv_lo = 0;
      kv_hi = p.skv - 1;
    }
  }
  const int t_lo = kv_lo / BKV, t_hi = kv_hi / BKV;

  auto load_kv = [&](int t, int stage) {
    float* kd = Ks + stage * BKV * KS;
    float* vd = Vs + stage * BKV * VS;
    if (width == 4)
      copy_kv<DP, R, NT, 4>(kd, vd, kb, vb, p, t * BKV);
    else if (width == 2)
      copy_kv<DP, R, NT, 2>(kd, vd, kb, vb, p, t * BKV);
    else
      copy_kv<DP, R, NT, 1>(kd, vd, kb, vb, p, t * BKV);
    cp_async_commit();
  };
  load_kv(t_lo, 0);

  // Q, scaled, transposed into Qt: a warp covers 8 rows x 4 columns
  for (int c = warp; c < (R / 8) * (DP / 4); c += NT / 32) {
    const int r = (c % (R / 8)) * 8 + (lane & 7);
    const int d = (c / (R / 8)) * 4 + (lane >> 3);
    const int hl = r / p.bq, qpos = q0 + r % p.bq;
    float x = 0.f;
    if (hl < nh && qpos < p.sq && d < p.d) {
      const int h = h0 + hl;
      const float* q = static_cast<const float*>(p.q) +
                       (long long)(h / p.heads_q) * p.q_b +
                       (long long)(h % p.heads_q) * p.q_h;
      x = q[qpos * p.q_s + d] * p.scale;
    }
    Qt[d * QS + r] = x;
  }

  // S lanes: rows WR·warp + 4·s_rg + i, keys s_kg + KG·j
  const int s_kg = lane % KG, s_rg = lane / KG;
  const int s_row = WR * warp + 4 * s_rg;
  int qpos_s[4];
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qpos_s[i] = q0 + (s_row + i) % p.bq;
    m_i[i] = kMasked;
    l_i[i] = 0.f;
  }
  // O lanes: rows WR·warp + 8·o_rg + i, columns (DP/NCS)·b + CV·o_cg + c;
  // row 8·o_rg + i's softmax lives in S lane (2·o_rg + i/4)·KG
  const int o_cg = lane % CG, o_rg = lane / CG;
  float acc[8][OC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;

  for (int t = t_lo; t <= t_hi; ++t) {
    const int stage = (t - t_lo) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile t landed; tile t-1 is consumed; Qt is written
    if (t < t_hi) load_kv(t + 1, stage ^ 1);
    const float* Kst = Ks + stage * BKV * KS;
    const float* Vst = Vs + stage * BKV * VS;
    const int k0 = t * BKV;

    float s[4][SC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d4 = 0; d4 < DP / 4; ++d4) {
      float kf[SC][4];
#pragma unroll
      for (int j = 0; j < SC; ++j)
        lds<4>(Kst + (s_kg + KG * j) * KS + 4 * d4, kf[j]);
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        float qa[4];
        lds<4>(Qt + (4 * d4 + dd) * QS + s_row, qa);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < SC; ++j)
            s[i][j] = fmaf(qa[i], kf[j][dd], s[i][j]);
      }
    }

    // masks, unless the whole tile lies inside every row's band
    const bool inside = k0 + BKV <= p.skv && k0 + BKV - 1 <= q0 &&
                        (p.window == 0 || k0 > q0 + p.bq - 1 - p.window);
    if (!inside) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          const int kpos = k0 + s_kg + KG * j;
          if (kpos >= p.skv) {
            s[i][j] = -INFINITY;  // not a key: weight exactly 0
          } else if (kpos > qpos_s[i] ||
                     (p.window > 0 && kpos <= qpos_s[i] - p.window)) {
            s[i][j] = kMasked;
          }
        }
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < SC; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int off = KG / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      alpha[i] = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = KG / 2; off > 0; off >>= 1)
        rs += __shfl_xor_sync(kFull, rs, off);
      l_i[i] = l_i[i] * alpha[i] + rs;
      m_i[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < SC; ++j)
      sts4(Pw + (s_kg + KG * j) * PW + 4 * s_rg, s[0][j], s[1][j], s[2][j],
           s[3][j]);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float a = __shfl_sync(kFull, alpha[i & 3], (2 * o_rg + i / 4) * KG);
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= a;
    }
    __syncwarp();  // the warp's P is written

#pragma unroll 8
    for (int j = 0; j < BKV; ++j) {
      float pr[8], vv[OC];
      lds<4>(Pw + j * PW + 8 * o_rg, pr);
      lds<4>(Pw + j * PW + 8 * o_rg + 4, pr + 4);
#pragma unroll
      for (int b = 0; b < NCS; ++b)
        lds<CV>(Vst + j * VS + (DP / NCS) * b + CV * o_cg, vv + CV * b);
#pragma unroll
      for (int c = 0; c < OC; ++c)
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][c] = fmaf(pr[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float lsum = __shfl_sync(kFull, l_i[i & 3], (2 * o_rg + i / 4) * KG);
    const int r = WR * warp + 8 * o_rg + i;
    const int hl = r / p.bq, qpos = q0 + r % p.bq;
    if (hl >= nh || qpos >= p.sq) continue;
    const int h = h0 + hl;
    float* o = static_cast<float*>(p.o) + (long long)(h / p.heads_q) * p.o_b +
               (long long)(h % p.heads_q) * p.o_h + (long long)qpos * p.o_s;
    const float den = fmaxf(lsum, 1e-30f);
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int col = (DP / NCS) * (c / CV) + CV * o_cg + c % CV;
      if (col < p.d) o[col] = acc[i][c] / den;
    }
  }
}

// the block shape's grid: head packs and query tiles
template <int R>
long long plan(Params* p) {
  p->hp = p->groups < R ? p->groups : R;
  p->bq = R / p->hp;
  p->packs = (p->groups + p->hp - 1) / p->hp;
  p->units = p->bh / p->groups * p->packs;
  p->q_tiles = (p->sq + p->bq - 1) / p->bq;
  return (long long)p->units * p->q_tiles;
}

template <int DP, int R, int NT>
cudaError_t launch(Params p, cudaStream_t stream) {
  using T = Tile<DP, R, NT>;
  const long long blocks = plan<R>(&p);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DP, R, NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::BYTES);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<DP, R, NT><<<(unsigned)blocks, NT, T::BYTES, stream>>>(p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dp(const Params& p, bool wide, cudaStream_t stream) {
  return wide ? launch<DP, 192, 384>(p, stream) : launch<DP, 96, 192>(p, stream);
}

cudaError_t dispatch(const Params& p, cudaStream_t stream) {
  if (p.d > 128) return launch<256, 64, 256>(p, stream);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  Params wide = p;
  const bool w = plan<192>(&wide) >= 2LL * sms;
  if (p.d <= 16) return launch_dp<16>(p, w, stream);
  if (p.d <= 32) return launch_dp<32>(p, w, stream);
  if (p.d <= 64) return launch_dp<64>(p, w, stream);
  return launch_dp<128>(p, w, stream);
}

// every block shape the dispatch may launch: (DP, R, NT)
template <int DP, int R, int NT>
cudaError_t occupancy_of(int* out) {
  using T = Tile<DP, R, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DP, R, NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::BYTES);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, flash_fwd_kernel<DP, R, NT>, NT, T::BYTES);
  out[0] = DP;
  out[1] = R;
  out[2] = NT;
  out[3] = T::BYTES;
  out[4] = blocks;
  return err;
}

}  // namespace

extern "C" {

const char* pg_flash_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// For each of the 9 block shapes: (head dim DP, rows R, threads, dynamic
// shared memory bytes, blocks resident on an SM) into out[5·i ..]. Returns
// the first cudaError_t met.
int pg_flash_occupancy(int* out) {
  cudaError_t errs[] = {
      occupancy_of<16, 192, 384>(out), occupancy_of<32, 192, 384>(out + 5),
      occupancy_of<64, 192, 384>(out + 10),
      occupancy_of<128, 192, 384>(out + 15),
      occupancy_of<16, 96, 192>(out + 20), occupancy_of<32, 96, 192>(out + 25),
      occupancy_of<64, 96, 192>(out + 30), occupancy_of<128, 96, 192>(out + 35),
      occupancy_of<256, 64, 256>(out + 40)};
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return (int)e;
  return 0;
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
  p.scale = scale;
  return (int)dispatch(p, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
