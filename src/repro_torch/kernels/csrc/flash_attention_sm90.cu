// Blockwise attention o = softmax(q k^T / sqrt(d), causal mask) v on bf16
// operands, for Hopper's tensor cores: wgmma on tiles that TMA stages.
//
// Replaces the Pallas TPU kernel kernels/attention/flash_attention.py::
// flash_attention_p (body _flash_kernel) on the bf16 route; f32 stays on
// the CUDA-core kernel in flash_attention.cu (wgmma takes no f32 operand,
// and TF32 would break the f32 route's 1e-4 gate).  The arithmetic is the
// Pallas body's: scores q.k on the bf16 inputs accumulated in f32, times
// the scale, masked to -1e30; the online-softmax state (m, l, acc) in f32;
// p kept in f32 against v; l clamped at 1e-30; the output cast to bf16.
// Contract as in flash_attention.cu: grouped KV heads (query head h reads
// KV head h / group), ragged sq and sk, key tiles wholly above a query
// tile's diagonal not visited.
//
// Bound on an H100: causal attention over S tokens does 4 d H S^2 / 2
// flops on 2 (2 H + 2 Hkv) S d bytes of q, o, k and v, so it is bound by
// operations (989 TFLOP/s bf16 on the tensor cores) above the ridge of
// about 295 flops a byte: above about 700 tokens at qwen2-7b's 28 heads
// on 4 KV heads, about 1,200 at zamba2's 32 heads (no GQA), by bytes
// (3.35 TB/s) below.
//
// Design.  One block per (batch*head, query tile of 64 or 128 rows); query
// tiles run heaviest first.  Warps 0-3 (and 4-7) are consumer warpgroups,
// 64 query rows each; one more warp is the producer (beside two consumers
// it fills a warpgroup, and setmaxnreg gives the consumers 232 registers a
// thread: 168 would spill and serialise the wgmmas).  The producer loads
// the block's q tile once, then the k and v tiles into a ring of two
// stages, each guarded by a full / empty mbarrier pair, by TMA over 3-D
// tensor maps [batch*heads, S, d]: a ragged last tile is zero-filled along
// S and never reads the next head's rows.  A staged row is at most 128
// bytes (128-byte swizzle), so d = 128 is staged as two 64-column panels
// and d = 256 as four.
// Each consumer warpgroup runs S = q k^T as wgmma m64n{block_k}k16 from
// shared memory, then the masks (on the diagonal and last tiles only) and
// the online softmax in registers: a row's max and sum reduce over the
// four lanes of a quad.  O += P V is wgmma m64n{d}k16 with P from
// registers (the f32 accumulator fragment of S is the layout of the
// A-operand fragment) and V MN-major from shared memory.
//
// Head dim 256 (gemma3's global layers) is the same kernel at its budget's
// edge: O is m64n256, 128 f32 registers a consumer thread, and shared
// memory holds a 128-row q tile (64 KiB) and two k + v stages of 64 keys
// (64 KiB each), 193 KiB in all; 128-key stages would need 256 KiB, so
// d = 256 takes block_k 64 only (kBlockKMax256).
//
// Why P carries two bf16 terms.  wgmma multiplies bf16 by bf16, and one
// bf16 rounding of p (as SDPA and FlashAttention do) is not the
// reference's function: its f32 p against v differs from the rounded one
// by up to 2^-9 of each term, which leaves the 2^-7 |o| + 1e-4 gate on
// rows of few keys where terms cancel.  So p = p_hi + p_lo with p_hi =
// bf16(p) and p_lo = bf16(p - p_hi), two wgmmas into one f32 accumulator:
// v is exactly bf16, so the product carries about 16 bits of p, far
// inside the gate.  Beside q k^T, the two P V products make the
// tensor-core work 1.5x that of one rounding.
//
// Left for later: sharing one staged k/v tile across a GQA group's query
// heads (7 for qwen2-7b); persistent blocks; a ping-pong of two consumer
// warpgroups that overlaps one's softmax with the other's wgmma; an FP8
// route.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace rt;

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStages = 2;  // k / v ring
constexpr int kBlockKMax256 = 64;  // the widest key tile whose stages fit at d 256

// A staged row panel: the head dim's bytes, at most 128 (the widest swizzle).
__host__ __device__ constexpr int row_bytes(int d) {
  return d * 2 < 128 ? d * 2 : 128;
}
// wgmma descriptor layout of that swizzle: 1 = 128 B, 2 = 64 B, 3 = 32 B.
__host__ __device__ constexpr uint64_t swizzle_code(int d) {
  return d >= 64 ? 1 : d == 32 ? 2 : 3;
}

// wgmma_ss: D (+)= A B, A [64 x 16] and B [16 x N] K-major in shared memory.
// wgmma_rs: D += A B, A [64 x 16] bf16 pairs in registers, B [16 x N]
// MN-major (transposed) in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// Threads of a block with NC consumer warpgroups: the consumers, then the
// producer.  With two consumers the producer is a whole warpgroup, so that
// setmaxnreg can move its registers to them (40 + 2 x 232 per lane of
// three warpgroups fit the SM's 64 Ki); one consumer fits without.
__host__ __device__ constexpr int block_threads(int nc) {
  return nc == 2 ? 384 : 160;
}

// D: head dim; BK: keys per tile; NC: consumer warpgroups (64 query rows
// each).
template <int D, int BK, int NC>
__global__ void __launch_bounds__(block_threads(NC), 1)
    flash_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ o, int heads, int group,
                       int sq, int sk, int causal, float scale) {
  constexpr int BQ = 64 * NC;
  constexpr int RB = row_bytes(D);        // bytes of a staged row panel
  constexpr int PANELS = D * 2 / RB;      // panels of a row (64 columns)
  constexpr int Q_BYTES = BQ * D * 2, KV_BYTES = BK * D * 2;
  constexpr uint64_t SW = swizzle_code(D);

  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t q_full, full[kStages], empty[kStages];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* kv = qs + Q_BYTES;  // stage s: k at kv + 2 s KV_BYTES, v after it

  const int bh = blockIdx.x;  // b * heads + h
  const int kvh = (bh / heads) * (heads / group) + (bh % heads) / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int k_end = causal ? min(sk, q0 + BQ) : sk;
  const int n_tiles = (k_end + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC * 4);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= NC * 4) {  // producer
    if constexpr (NC == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == NC * 4 && lane == 0) {
      mbar_expect_tx(&q_full, Q_BYTES);
      for (int p = 0; p < PANELS; ++p)
        tma_load(qs + p * BQ * RB, &tq, &q_full, p * RB / 2, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * KV_BYTES);
        uint8_t* ks = kv + 2 * s * KV_BYTES;
        for (int p = 0; p < PANELS; ++p) {
          tma_load(ks + p * BK * RB, &tk, &full[s], p * RB / 2, t * BK, kvh);
          tma_load(ks + KV_BYTES + p * BK * RB, &tv, &full[s], p * RB / 2,
                   t * BK, kvh);
        }
      }
    }
  } else {
    if constexpr (NC == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    // Consumer warpgroup wg: query rows q0 + 64 wg ...; this thread holds
    // rows r and r + 8 and, in each group of 8 columns, columns cq and cq + 1.
    const int wg = warp / 4;
    const int row0 = q0 + 64 * wg;
    const int r = row0 + 16 * (warp % 4) + lane / 4;
    const int cq = 2 * (lane % 4);
    const uint32_t q_addr = smem_u32(qs) + 64 * wg * RB;

    float acc[D / 2], s[BK / 2];
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
    uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;

    mbar_wait(&q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kStages;
      const int k0 = t * BK;
      mbar_wait(&full[st], (t / kStages) & 1);
      // A tile wholly above this warpgroup's diagonal would leave its state
      // unchanged (p = 0, alpha = 1): skip it.
      if (!(causal && k0 > row0 + 63)) {
        const uint32_t k_addr = smem_u32(kv + 2 * st * KV_BYTES);
        const uint32_t v_addr = k_addr + KV_BYTES;

        // S = q k^T: d / 16 steps of 16 columns (32 bytes) along the rows.
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
          const uint32_t panel = j * 32 / RB, off = j * 32 % RB;
          wgmma_ss(s,
                   smem_desc(q_addr + panel * BQ * RB + off, 16, 8 * RB, SW),
                   smem_desc(k_addr + panel * BK * RB + off, 16, 8 * RB, SW),
                   j > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        pin(s);

        // Scale, mask, online softmax over this tile's columns.
        const bool masked = k0 + BK > sk || (causal && k0 + BK - 1 > row0);
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int i = 0; i < BK / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e / 2, col = k0 + 8 * i + cq + e % 2;
            float x = s[4 * i + e] * scale;
            if (masked && (col >= sk || (causal && col > r + 8 * h))) x = kNeg;
            s[4 * i + e] = x;
            mx[h] = fmaxf(mx[h], x);
          }
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) mx[h] = quad_max(mx[h]);
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int h = (i / 2) % 2;
          const float p = exp2f((s[i] - mx[h]) * kLog2e);
          s[i] = p;
          sum[h] += p;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float alpha = exp2f((m[h] - mx[h]) * kLog2e);
          l[h] = alpha * l[h] + quad_sum(sum[h]);
          m[h] = mx[h];
#pragma unroll
          for (int i = 0; i < D / 8; ++i) {
            acc[4 * i + 2 * h] *= alpha;
            acc[4 * i + 2 * h + 1] *= alpha;
          }
        }

        // P as the A fragment of each 16-key step, in two bf16 terms.
#pragma unroll
        for (int j = 0; j < BK / 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = s[8 * j + 2 * e], y = s[8 * j + 2 * e + 1];
            const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
            const float2 back = __bfloat1622float2(hi);
            p_hi[j][e] = bf16x2_bits(hi);
            p_lo[j][e] =
                bf16x2_bits(__floats2bfloat162_rn(x - back.x, y - back.y));
          }

        // O += P V: V [keys, d] is the MN-major B operand; a 16-key step is
        // 16 rows of every panel (the panels lie BK * RB apart).
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
          const uint64_t vd =
              smem_desc(v_addr + j * 16 * RB, BK * RB, 8 * RB, SW);
          wgmma_rs(acc, p_hi[j], vd);
          wgmma_rs(acc, p_lo[j], vd);
        }
        wgmma_commit();
        wgmma_wait_all();
        pin(acc);
        pin(p_hi);
        pin(p_lo);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      if (row >= sq) continue;
      const float lc = fmaxf(l[h], 1e-30f);
      __nv_bfloat16* dst = o + (static_cast<long long>(bh) * sq + row) * D + cq;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * i) = __floats2bfloat162_rn(
            acc[4 * i + 2 * h] / lc, acc[4 * i + 2 * h + 1] / lc);
    }
  }
}

// ---- host: tensor maps and launch ---------------------------------------

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled lives in libcuda, which this library does not link
// (it links only the CUDA runtime): it is looked up in the libcuda that
// PyTorch has already loaded.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h == nullptr ? nullptr
                        : reinterpret_cast<EncodeTiled>(
                              dlsym(h, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// [n, rows, d] bf16 at `base`, read as boxes of `box_rows` rows by one
// swizzled panel of columns; rows past `rows` read as zeros.
bool tensor_map(CUtensorMap* map, const void* base, int n, int rows, int d,
                int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const int rb = row_bytes(d);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(rows) * d * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(rb / 2),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = rb == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : rb == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Args {
  CUtensorMap tq, tk, tv;
  __nv_bfloat16* o;
  int bh, heads, group, sq, sk, causal;
  float scale;
  cudaStream_t stream;
};

template <int D, int BK, int NC>
int launch(const Args& a) {
  constexpr int BQ = 64 * NC;
  constexpr size_t smem = 1024 + static_cast<size_t>(BQ) * D * 2 +
                          static_cast<size_t>(kStages) * 2 * BK * D * 2;
  const dim3 grid(a.bh, (a.sq + BQ - 1) / BQ);
  return rt::launch(flash_kernel_wgmma<D, BK, NC>, grid,
                    dim3(block_threads(NC)), smem, a.stream, a.tq, a.tk, a.tv,
                    a.o, a.heads, a.group, a.sq, a.sk, a.causal, a.scale);
}

template <int D>
int launch_d(const Args& a, int bq, int bk) {
  if (bq == 64) return bk == 64 ? launch<D, 64, 1>(a) : launch<D, 128, 1>(a);
  return bk == 64 ? launch<D, 64, 2>(a) : launch<D, 128, 2>(a);
}

template <>
int launch_d<256>(const Args& a, int bq, int bk) {
  if (bk > kBlockKMax256) return static_cast<int>(cudaErrorInvalidValue);
  return bq == 64 ? launch<256, 64, 1>(a) : launch<256, 64, 2>(a);
}

}  // namespace

// q [batch, heads, sq, d]; k, v [batch, heads/group, sk, d]; o like q; all
// bf16, contiguous, 16-byte aligned.  block_q and block_k in {64, 128};
// at d = 256 block_k is 64.
extern "C" int flash_attention_bf16(const __nv_bfloat16* q,
                                    const __nv_bfloat16* k,
                                    const __nv_bfloat16* v, __nv_bfloat16* o,
                                    int batch, int heads, int group, int sq,
                                    int sk, int d, int bq, int bk, int causal,
                                    float scale, cudaStream_t stream) {
  const bool blocks_ok = (bq == 64 || bq == 128) && (bk == 64 || bk == 128);
  const bool dim_ok = d == 16 || d == 32 || d == 64 || d == 128 || d == 256;
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(o)) & 15) == 0;
  if (!blocks_ok || !dim_ok || !aligned || batch < 1 || group < 1 ||
      heads % group || sq < 1 || sk < 1 || (sq + bq - 1) / bq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  if (!tensor_map(&a.tq, q, batch * heads, sq, d, bq) ||
      !tensor_map(&a.tk, k, batch * (heads / group), sk, d, bk) ||
      !tensor_map(&a.tv, v, batch * (heads / group), sk, d, bk))
    return static_cast<int>(cudaErrorInvalidValue);
  a.o = o;
  a.bh = batch * heads;
  a.heads = heads;
  a.group = group;
  a.sq = sq;
  a.sk = sk;
  a.causal = causal;
  a.scale = scale;
  a.stream = stream;
  switch (d) {
    case 16: return launch_d<16>(a, bq, bk);
    case 32: return launch_d<32>(a, bq, bk);
    case 64: return launch_d<64>(a, bq, bk);
    case 128: return launch_d<128>(a, bq, bk);
    default: return launch_d<256>(a, bq, bk);
  }
}
