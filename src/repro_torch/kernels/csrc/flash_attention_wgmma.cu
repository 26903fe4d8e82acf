// Causal (optionally sliding-window) GQA attention forward for Hopper
// (sm_90a) on bfloat16 inputs: both products on the tensor cores through
// wgmma, K and V fed by TMA through a warp-specialised pipeline.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py:
// _fa_kernel, launched by flash_attention_folded's pallas_call and reached
// through the wrapper flash_attention, for bfloat16 inputs (float32 inputs
// keep the CUDA-core kernel of flash_attention.cu). Semantics kept from
// the reference:
//   * causal with query and key positions both starting at 0, optional
//     window (kv_pos > q_pos - window); masked scores are -1e30;
//   * GQA/MQA: query head i reads kv head i / groups;
//   * fp32 scores, running max, denominator and accumulator; out = acc /
//     max(l, 1e-30), stored in bfloat16.
// Like the CUDA-core kernel, and unlike the reference, which drops the
// keys of a ragged kv tail, every key is attended.
//
// Precision. The reference multiplies P.V in fp32. Here, as in every
// tensor-core flash attention, the unnormalised P in [0, 1] is rounded to
// bf16 before the product; l is summed from the fp32 P. Each p_j then
// carries a relative error of at most 2^-9, so |d out| <= 2^-9 *
// sum_j p_j |v_j| / l <= 2^-9 * max|v|.
//
// What bounds it: operations. Attention does 4·H·D flop per attended
// (query, key) pair and moves only Q, K, V and O: at the repo's prefill
// shapes (S = 8K..32K, D = 120..256) that is over 10,000 flop per byte,
// far above the card's ~295 flop/byte balance for bf16. The least time is
// 4·H·D·pairs over the 989 TFLOP/s bf16 tensor-core rate, and only wgmma
// reaches that rate.
//
// Design (what it does about that bound):
//   * One block of 3 warpgroups (384 threads) per (query head, tile of 128
//     queries). Warpgroup 0 is the producer: it drops to kProducerRegs
//     registers (setmaxnreg.dec) and one thread issues every TMA load.
//     Warpgroups 1 and 2 are consumers (setmaxnreg.inc to kConsumerRegs);
//     each owns 64 query rows. The roles split in one if/else that never
//     reconverges.
//   * Shared memory: the Q tile (128 x Dp bf16) loaded once under its own
//     mbarrier; K and V tiles of BKV keys in a 2-stage ring with full and
//     empty mbarriers and expect_tx byte counts. Each tile is stored as
//     Dp/64 column chunks of [rows][64] bf16 with the 128-byte swizzle,
//     which the wgmma descriptors match. Dp in {64, 128, 256} is D rounded
//     up; TMA fills the columns past D (and rows past S) with zeros.
//     BKV = 128 for Dp <= 128, 64 for Dp = 256 (Q 64 KB + 2 x (K + V)
//     128 KB).
//   * S = Q.K^T: wgmma m64nBKVk16, A = Q and B = K both K-major from shared
//     memory, fp32 accumulators in registers (BKV/2 per thread).
//   * Softmax in the accumulator's registers: each thread holds 2 rows,
//     each row spread over the 4 lanes of a quad (xor shuffles over 1 and
//     2). Scale folded with log2(e) for exp2f; masks only on tiles that
//     cross the causal diagonal, the window's edge or Skv.
//   * O += P.V: P converted to bf16 in registers. For 16-bit inputs the
//     m64nN fp32 accumulator layout is the register A-fragment layout, so P
//     needs no shuffle and no trip through shared memory: wgmma m64nDpk16
//     with A from registers and B = V ([kv, D] row-major, MN-major for B:
//     the transpose bit) from shared memory.
//   * A consumer releases a ring stage once both of its products on it
//     have completed (wgmma.wait_group 0).
//   * The tile range and the no-key rule are the CUDA-core kernel's: the
//     kv loop visits the tiles that meet the block's causal/window band,
//     or every tile when a row of the block sees no key (its scores are
//     then all -1e30 and it averages every value). Keys past Skv score
//     -inf (weight 0).
//   * Blocks run the heavy (last) query tiles first; the query heads that
//     share a kv head are adjacent in blockIdx, so K/V tiles come from L2.
//   * Inputs are read through a 4-D TMA tensor map (D, H, S, B) over their
//     real strides: no folded copy. The wrapper guarantees D % 8 == 0,
//     16-byte aligned bases and strides (copying only inputs that break
//     that).
// What comes next (not here yet): overlapping one warpgroup's softmax with
// the other's products in an ordered ping-pong, and a tile's softmax with
// its next score product; persistent blocks; clusters with TMA multicast of
// K/V to the query heads of a group; fp8.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see repro_torch/kernels/_build.py). Plain C
//        interface, loaded with ctypes. cuTensorMapEncodeTiled is reached
//        through the runtime's driver entry point, so no -lcuda is needed.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 384;       // producer + 2 consumer warpgroups
constexpr int kBQ = 128;            // query rows per block, 64 per consumer
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;  // 40·128 + 232·256 <= 65,536
constexpr int kRowBytes = 128;      // one swizzled row: 64 bf16 columns
constexpr float kMasked = -1e30f;   // the reference's masked score
constexpr unsigned kFull = 0xffffffffu;

// error codes beyond cudaError_t
constexpr int kErrEncode = 10000;   // + the CUresult of the tensor-map encode
constexpr int kErrNoEncode = 20000;

struct Params {
  __nv_bfloat16* o;
  long long o_b, o_h, o_s;  // output element strides: batch, head, position
  int bh, sq, skv, d;       // d: the head dim as stored (a multiple of 8)
  int heads_q, heads_kv, groups, window;
  int q_tiles;
  float scale_log2;         // log2(e) / sqrt(true D)
};

template <int DP, int BKV>
struct Tiles {
  static constexpr int kChunks = DP / 64;
  static constexpr int kQBytes = kBQ * DP * 2;
  static constexpr int kKVBytes = BKV * DP * 2;  // one K or V tile
  // Q, two K and two V stages, and slack to align the base to 1024 bytes
  static constexpr int kSmem = kQBytes + 4 * kKVBytes + 1024;
};

// ---- PTX: shared addresses, mbarriers, TMA, wgmma ----------------------

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// returns once the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// one box of the 4-D map at coordinates (column, head, position, batch)
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int head,
                                         int pos, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(col), "r"(head), "r"(pos), "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; byte offsets
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x: the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- wgmma m64nNk16, bf16 in, fp32 accumulators --------------------------

// D[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, A and B K-major in shared
// memory (m64n64k16: the score tile of 64 keys)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] . B[128 x 16]^T (the score tile of 128 keys)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64]; A in registers, B MN-major in
// shared memory (transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128]; A in registers, B MN-major in
// shared memory (transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 256] += A[64 x 16] . B[16 x 256]; A in registers, B MN-major in
// shared memory (transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---- the kernel ---------------------------------------------------------

template <int DP, int BKV>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const Params p) {
  using T = Tiles<DP, BKV>;
  extern __shared__ uint8_t smem_raw[];
  // q_full; k_full[2]; v_full[2]; empty[2]
  __shared__ __align__(8) uint64_t bars[7];
  uint64_t* q_full = &bars[0];
  uint64_t* k_full = &bars[1];
  uint64_t* v_full = &bars[3];
  uint64_t* empty = &bars[5];
  // swizzled tiles start on 1024-byte boundaries (the swizzle's period)
  uint8_t* q_s = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* k_s = q_s + T::kQBytes;       // stage st at + st · kKVBytes
  uint8_t* v_s = k_s + 2 * T::kKVBytes;

  const int head = blockIdx.x % p.bh;
  const int q0 = (p.q_tiles - 1 - (int)(blockIdx.x / p.bh)) * kBQ;
  const int kv_head = head / p.groups;

  // the kv tiles that meet the block's band (as in flash_attention.cu)
  const int q_last = min(q0 + kBQ, p.sq) - 1;
  int kv_lo = 0, kv_hi = min(p.skv - 1, q_last);
  if (p.window > 0) {
    kv_lo = max(0, q0 - p.window + 1);
    if (q_last - p.window + 1 > p.skv - 1) {  // a row of the tile sees no key
      kv_lo = 0;
      kv_hi = p.skv - 1;
    }
  }
  const int t_lo = kv_lo / BKV, t_hi = kv_hi / BKV;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      mbar_init(&k_full[st], 1);
      mbar_init(&v_full[st], 1);
      mbar_init(&empty[st], 2 * 128);  // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (threadIdx.x == 0) {
      const int qb = head / p.heads_q, qh = head % p.heads_q;
      const int kb = kv_head / p.heads_kv, kh = kv_head % p.heads_kv;
      mbar_expect_tx(q_full, T::kQBytes);
#pragma unroll
      for (int c = 0; c < T::kChunks; ++c)
        tma_load(q_s + c * kBQ * kRowBytes, &tq, q_full, 64 * c, qh, q0, qb);
      for (int t = t_lo; t <= t_hi; ++t) {
        const int i = t - t_lo, st = i & 1;
        // a stage's second and later fills wait for both consumers
        if (i >= 2) mbar_wait(&empty[st], ((i >> 1) - 1) & 1);
        uint8_t* ks = k_s + st * T::kKVBytes;
        uint8_t* vs = v_s + st * T::kKVBytes;
        mbar_expect_tx(&k_full[st], T::kKVBytes);
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c)
          tma_load(ks + c * BKV * kRowBytes, &tk, &k_full[st], 64 * c, kh,
                   t * BKV, kb);
        mbar_expect_tx(&v_full[st], T::kKVBytes);
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c)
          tma_load(vs + c * BKV * kRowBytes, &tv, &v_full[st], 64 * c, kh,
                   t * BKV, kb);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kConsumerRegs));
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x & 127;
    const int lane = tid & 31;
    // this thread's rows: row0 and row0 + 8; its columns in each 8-column
    // block of an accumulator: col0 and col0 + 1
    const int qa = q0 + 64 * cw;
    const int row0 = qa + 16 * (tid >> 5) + (lane >> 2);
    const int col0 = 2 * (lane & 3);
    const uint32_t q_addr = smem_u32(q_s) + 64 * cw * kRowBytes;

    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float m[2] = {kMasked, kMasked};
    float l[2] = {0.f, 0.f};  // this thread's share of the row sums

    mbar_wait(q_full, 0);
    for (int t = t_lo; t <= t_hi; ++t) {
      const int i = t - t_lo, st = i & 1;
      const uint32_t phase = (i >> 1) & 1;
      const int k0 = t * BKV;

      // S = Q · K^T over Dp/16 steps of 16 columns: a step's 32 bytes lie
      // inside one 128-byte swizzled row of one chunk
      float s[BKV / 2];
      const uint32_t k_addr = smem_u32(k_s) + st * T::kKVBytes;
      mbar_wait(&k_full[st], phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        wgmma_ss(s,
                 sw128_desc(q_addr + (kk >> 2) * kBQ * kRowBytes + off, 16,
                            1024),
                 sw128_desc(k_addr + (kk >> 2) * BKV * kRowBytes + off, 16,
                            1024),
                 kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // scale, mask, online softmax; s[4j + 2h + e] is row row0 + 8h, key
      // k0 + 8j + col0 + e
      const bool edge = k0 + BKV - 1 > qa || k0 + BKV > p.skv ||
                        (p.window > 0 && k0 <= qa + 63 - p.window);
      float mx[2] = {kMasked, kMasked};
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = s[4 * j + 2 * h + e] * p.scale_log2;
            if (edge) {
              const int kpos = k0 + 8 * j + col0 + e;
              const int qpos = row0 + 8 * h;
              if (kpos >= p.skv)
                x = -INFINITY;  // not a key: weight exactly 0
              else if (kpos > qpos ||
                       (p.window > 0 && kpos <= qpos - p.window))
                x = kMasked;
            }
            s[4 * j + 2 * h + e] = x;
            mx[h] = fmaxf(mx[h], x);
          }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        alpha[h] = exp2f(m[h] - m_new);
        m[h] = m_new;
        l[h] *= alpha[h];
      }
      // P in fp32 for l, then in bf16 as the A fragments of P · V: step kk
      // takes keys 16kk..16kk+15, which are s[8kk..8kk+7]
      uint32_t pa[BKV / 16][4];
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float p0 = exp2f(s[4 * j + 2 * h] - m[h]);
          const float p1 = exp2f(s[4 * j + 2 * h + 1] - m[h]);
          l[h] += p0 + p1;
          pa[j >> 1][2 * (j & 1) + h] = pack_bf16(p0, p1);
        }
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          o[4 * j + 2 * h] *= alpha[h];
          o[4 * j + 2 * h + 1] *= alpha[h];
        }

      // O += P · V over BKV/16 steps of 16 keys: 16 swizzled rows of every
      // chunk; successive chunks of 64 columns are kKVBytes/kChunks apart
      const uint32_t v_addr = smem_u32(v_s) + st * T::kKVBytes;
      mbar_wait(&v_full[st], phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        wgmma_rs(o, pa[kk],
                 sw128_desc(v_addr + kk * 16 * kRowBytes, BKV * kRowBytes,
                            1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      mbar_arrive(&empty[st]);
    }

    // out = acc / max(l, 1e-30) in bf16
    __nv_bfloat16* out = p.o + (long long)(head / p.heads_q) * p.o_b +
                         (long long)(head % p.heads_q) * p.o_h;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(kFull, l[h], 1);
      l[h] += __shfl_xor_sync(kFull, l[h], 2);
      const int row = row0 + 8 * h;
      if (row >= p.sq) continue;
      const float den = fmaxf(l[h], 1e-30f);
      __nv_bfloat16* dst = out + (long long)row * p.o_s;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + col0;
        if (col < p.d)
          *reinterpret_cast<__nv_bfloat162*>(dst + col) =
              __floats2bfloat162_rn(o[4 * j + 2 * h] / den,
                                    o[4 * j + 2 * h + 1] / den);
      }
    }
  }
}

// ---- host side ----------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so that no -lcuda is needed
int encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || ptr == nullptr)
      return kErrNoEncode;
    cached = reinterpret_cast<EncodeTiled>(ptr);
  }
  *fn = cached;
  return 0;
}

// A 4-D map over bf16 data with element strides (head, position, batch)
// and a contiguous head dim: dims (D, heads, S, batch), innermost first;
// boxes of 64 columns x `rows` positions, 128-byte swizzle, zeros out of
// bounds. A dim of size 1 is never stepped, so it gets the packed stride.
int make_map(EncodeTiled encode, CUtensorMap* map, const void* base, int d,
             int heads, int s, int batch, long long h_stride,
             long long s_stride, long long b_stride, int rows) {
  if (heads == 1) h_stride = d;
  if (batch == 1) b_stride = s_stride * s;
  if (h_stride <= 0 || s_stride <= 0 || b_stride <= 0 || h_stride % 8 ||
      s_stride % 8 || b_stride % 8 || reinterpret_cast<uintptr_t>(base) % 16)
    return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)s, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)h_stride * 2,
                                 (cuuint64_t)s_stride * 2,
                                 (cuuint64_t)b_stride * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + (int)r;
}

template <int DP, int BKV>
int launch(const void* q, const void* k, const void* v, const long long* st,
           const Params& p, cudaStream_t stream) {
  EncodeTiled encode;
  int rc = encoder(&encode);
  if (rc) return rc;
  CUtensorMap tq, tk, tv;
  const int batch_kv = p.bh / p.groups / p.heads_kv;
  rc = make_map(encode, &tq, q, p.d, p.heads_q, p.sq, p.bh / p.heads_q,
                st[1], st[2], st[0], kBQ);
  if (!rc)
    rc = make_map(encode, &tk, k, p.d, p.heads_kv, p.skv, batch_kv, st[4],
                  st[5], st[3], BKV);
  if (!rc)
    rc = make_map(encode, &tv, v, p.d, p.heads_kv, p.skv, batch_kv, st[7],
                  st[8], st[6], BKV);
  if (rc) return rc;
  const int bytes = Tiles<DP, BKV>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<DP, BKV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)p.bh * p.q_tiles;
  flash_wgmma_kernel<DP, BKV>
      <<<(unsigned)blocks, kThreads, bytes, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* pg_flash_wgmma_error_string(int code) {
  if (code == kErrNoEncode)
    return "cuTensorMapEncodeTiled not found through the CUDA runtime";
  if (code >= kErrEncode && code < kErrNoEncode)
    return "cuTensorMapEncodeTiled refused a tensor map (CUresult = code - "
           "10000)";
  return cudaGetErrorString((cudaError_t)code);
}

// The register budgets of the two roles (setmaxnreg): producer, consumer.
void pg_flash_wgmma_roles(int* regs) {
  regs[0] = kProducerRegs;
  regs[1] = kConsumerRegs;
}

// q, k, v, o: device pointers to bfloat16. strides: 12 element strides,
// (batch, head, position) of q, k, v and o; the head dim is contiguous, d
// a multiple of 8 up to 256 and every base and non-unit stride 16-byte
// aligned (the wrapper copies inputs that are not). Query head `h` of
// `bh` = batch·heads_q reads kv head h / groups of batch·heads_kv; `scale`
// is 1/sqrt(true head dim).
int pg_flash_attention_wgmma(const void* q, const void* k, const void* v,
                             void* o, int bh, int sq, int skv, int d,
                             int heads_q, int heads_kv, int groups,
                             int window, float scale,
                             const long long* strides, void* stream) {
  if (bh < 1 || sq < 1 || skv < 1 || d < 8 || d > 256 || d % 8 != 0 ||
      heads_q < 1 || heads_kv < 1 || groups < 1 || window < 0 ||
      bh % groups != 0 || bh % heads_q != 0 ||
      (bh / groups) % heads_kv != 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.o_b = strides[9];
  p.o_h = strides[10];
  p.o_s = strides[11];
  p.bh = bh;
  p.sq = sq;
  p.skv = skv;
  p.d = d;
  p.heads_q = heads_q;
  p.heads_kv = heads_kv;
  p.groups = groups;
  p.window = window;
  p.q_tiles = (sq + kBQ - 1) / kBQ;
  p.scale_log2 = scale * 1.4426950408889634f;
  if ((long long)bh * p.q_tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return launch<64, 128>(q, k, v, strides, p, s);
  if (d <= 128) return launch<128, 128>(q, k, v, strides, p, s);
  return launch<256, 64>(q, k, v, strides, p, s);
}

}  // extern "C"
