// Block-tile product of the FCU (fcu_matmul.cu) and KPU (kpu_conv.cu)
// kernels on Hopper's tensor cores: on f32 operands fp32-accurate through a
// 3xTF32 split, on bf16 operands one bf16 product a step (the bf16 route,
// below); both accumulate in f32 and write y in the operands' type.
//
// The problem is an implicit GEMM: M = N*Ho*Wo output pixels, N = d_out
// channels, K = kh*kw*d_in.  The FCU is the KPU's case with a 1x1 kernel,
// stride 1 and no padding (one frame of m pixels), so both run `mma_tile`
// and differ only in the shape they pass.
//
// One block owns a group of the plan's (bm x bn) output tiles, `rows`
// adjacent pixel tiles by `cols` adjacent column tiles, as one tile of
// rows bm pixels and cols bn channels (`plan_tile`, `MmaGroup`).  The
// FCU's group, and the KPU's on bf16, packs up to 64 / bm pixel tiles into
// one 64-row wgmma atom where bm < 64, and one column tile.  The KPU's on
// f32 packs up to 128 / bm pixel tiles where bm <= 64 (two atoms: two
// consumer warpgroups share each slot) and the widest run of column tiles
// that the accumulators allow, up to a wgmma width of 256 (each only where
// the cluster split it gets leaves a block 3 steps or more), so that one
// gathered window of x
// feeds all of them.  A group adds columns and rows to the products and
// changes no column's steps or their order, so at one cluster split (see
// below: the split follows the block count) it changes no output bit.
// The block walks its share of the contraction in the plan's bk steps:
// (input-channel step, tap) pairs.  Where the rows of x allow only 4-byte
// copies and one step holds all d_in channels (conv1's 3), a row of kw
// taps is one step: its (dx, ci) pairs lie contiguous in x's row and in
// w.  A ring slot holds a `ks`-channel slab of one step (ks divides the
// step rounded up to 8 channels): the [rows][ks] window of x (rows padded
// so the consumers' 8-byte reads hit distinct banks) and the [ks][bn]
// slice of w, both f32 as they lie in memory.
//
// Warp roles.  Warps 0 .. 4 NC - 1 are NC consumer warpgroups, each
// owning MA 64-row wgmma atoms of the tile (ragged rows read as zero and
// are never stored); the last warpgroup is the producer.  The producer
// fills the ring with cp.async, 16 bytes a copy where the rows allow it
// and 4 bytes otherwise, zero-filling (src-size 0) rows past the tile,
// taps in the SAME padding, channels past the step and columns past bn,
// from a per-row table of window origins made once per block (four rows'
// origins read before their copies, so that the reads overlap); each of
// its threads arrives on the slot's `full` mbarrier as its copies land.
// The consumers wait on `full`, split the slot's w into hi = rna_tf32(v)
// and lo = rna_tf32(v - hi), a (k8 step, column) at a time in 16-byte
// stores, in the K-major [bn][8] layout wgmma takes for a
// tf32 B operand (tf32 has no transposed mode; k permuted to match the
// reads of x), into one of two buffers by the item's parity, and meet at
// a named barrier.  Each then reads its x values with one 8-byte shared
// load per row pair, splits them in registers into A fragments and runs
// three wgmma m64nBNk8 tf32 products per k8 step into one f32 accumulator,
// the two lo terms first, then hi x hi; the next steps' loads overlap
// these steps' products.  The slot goes back to the producer through its
// `empty` mbarrier once its last x values are in registers (the products
// read w from the consumers' own buffers).  Beside two consumer
// warpgroups, setmaxnreg moves the producer's spare registers to them, so
// that two blocks fit an SM.
//
// The bf16 route.  The same producer, ring and consumers, with a slot of
// `ks` = 16 .. 64 channels (whole k16 steps): w first, as the MN-major B
// operand wgmma reads through the transpose bit, as flash_attention_sm90.cu
// reads V: rows of the tile's width (at most a 64-column panel, panels ks
// rows apart) whose 16-byte chunks the producer places where the
// descriptor's 32, 64 or 128-byte swizzle looks for them (a bn = 8 tile
// is one 8-column core matrix, no swizzle), on 1024-byte boundaries; then
// x as it lies.  So the consumers neither split nor rewrite w: after
// `full` (and a proxy fence, since the copies are not TMA's) each reads
// its x pairs with one 8-byte load per row pair as the A fragments (k
// permuted, w's rows placed to match: `bf16_row`) and runs one wgmma
// m64nBNk16 bf16 product a k16 step.  The producer's 16-byte copies carry
// 8 channels.  Where rows of x (conv1's 3 channels: a 6-byte pixel) or of w
// allow no 16-byte copy, the producer copies 2 bytes at a time through
// registers, eight loads in flight a thread, and arrives with a plain
// (release) arrival; a row of kw taps is then one step, as for f32.
//
// Cluster split.  Where the plan's tiles leave fewer blocks than SMs,
// `plan_tile` launches `split` blocks per tile as a thread-block cluster
// along z (`split_rule`): rank r takes steps [r S / split, (r + 1) S /
// split) of the S steps.  The ranks' partial tiles go to shared memory and each rank
// sums a slice of the tile's rows over all ranks through distributed
// shared memory in rank order (deterministic, no atomics).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>

#include "sm90.cuh"

namespace rt {

constexpr int kProducer = 128;  // threads of the producer warpgroup
constexpr int kMaxStages = 8;
constexpr int kMaxSplit = 8;    // blocks of a cluster (the portable limit)

struct MmaShape {
  int n, h, w, d_in, ho, wo, d_out, kh, kw, stride, pad_t, pad_l;
};

// The block's plan, made on the host by `plan_tile`.
struct MmaTile {
  int bm;           // the block's pixel rows: its pixel tiles x the plan's bm
  int bk;           // the plan's contraction tile
  int bn;           // the block's channels: its column tiles x the plan's bn
  int fold;         // a row of kw taps is one step (rows of x allow no
                    // 16-byte copy, d_in = bk)
  int kdim;         // channels a step contracts: bk, or kw d_in folded
  int bkp;          // kdim rounded up to a k step (8 f32, 16 bf16)
  int ks;           // channels a ring slot holds; divides bkp
  int xs;           // elements between two staged rows of x
  int stages;       // ring slots
  int slot_bytes;   // bytes of one ring slot
  int steps;        // steps of the contraction: d_in / bk x kh kw, or kh
  int vec;          // 16-byte copies of x (else 4-byte f32; bf16: of x
                    // and w, else 2-byte loads and stores)
  int wvec;         // f32: 16-byte copies of w (else 4-byte)
  int wrow;         // bf16: bytes of a B row in a slot (16, 32, 64, 128)
  int wbytes;       // bf16: bytes of a slot's B tile, before its x rows
};

// ---- device helpers -----------------------------------------------------

// Barrier `id` over `count` threads (the consumer warpgroups).
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Make this thread's shared-memory stores visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int M, int N>
__device__ __forceinline__ void pin(float (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+f"(r[i][j])::"memory");
}
template <int K, int M, int N>
__device__ __forceinline__ void pin(uint32_t (&r)[K][M][N]) {
#pragma unroll
  for (int k = 0; k < K; ++k) pin(r[k]);
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The float at shared address `addr` of cluster block `rank`.
__device__ __forceinline__ float ld_cluster(uint32_t addr, int rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(remote)
               : "memory");
  return v;
}

// D += A B, wgmma m64nNk8 tf32: A [64 x 8] in registers (a0 row g, k t;
// a1 row g + 8, k t; a2 row g, k t + 4; a3 row g + 8, k t + 4 of the
// warp's 16 rows, g = lane / 4, t = lane % 4), B [N x 8] K-major in
// shared memory; D is the f32 fragment of the m64nN tile.
__device__ __forceinline__ void wgmma_tf32(float (&d)[4],
                                           const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[8],
                                           const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[16],
                                           const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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

__device__ __forceinline__ void wgmma_tf32(float (&d)[128],
                                           const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
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
      "}, {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
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

// D += A B, wgmma m64nNk16 bf16: A [64 x 16] in registers (a0 row g, k 2t,
// 2t + 1; a1 row g + 8, k 2t, 2t + 1; a2 row g, k 2t + 8, 2t + 9; a3 row
// g + 8, k 2t + 8, 2t + 9 of the warp's 16 rows, the lower k in the lower
// half), B [16 x N] MN-major (transposed) in shared memory; D as for tf32.
__device__ __forceinline__ void wgmma_bf16(float (&d)[4],
                                           const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[8],
                                           const uint32_t (&a)[4], uint64_t b) {
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

__device__ __forceinline__ void wgmma_bf16(float (&d)[16],
                                           const uint32_t (&a)[4], uint64_t b) {
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

__device__ __forceinline__ void wgmma_bf16(float (&d)[32],
                                           const uint32_t (&a)[4], uint64_t b) {
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

__device__ __forceinline__ void wgmma_bf16(float (&d)[64],
                                           const uint32_t (&a)[4], uint64_t b) {
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

__device__ __forceinline__ void wgmma_bf16(float (&d)[128],
                                           const uint32_t (&a)[4], uint64_t b) {
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

// ---- the block ----------------------------------------------------------

// k8 steps a consumer issues per commit group: 4 / MA beside one consumer
// warpgroup, 2 / MA beside two (A fragments of 16 registers), at least 1.
__host__ __device__ constexpr int mma_chunk(int ma, int nc) {
  return (nc == 2 ? 2 : 4) / ma > 0 ? (nc == 2 ? 2 : 4) / ma : 1;
}

// Blocks an SM should hold at once (the kernels' __launch_bounds__): two
// where the accumulators leave room.  Beside two consumer warpgroups that
// caps a thread at 80 registers, and setmaxnreg then moves the producer's
// spare ones to the consumers (kProducerRegs, kConsumerRegs).
__host__ __device__ constexpr int mma_min_blocks(int bn, int ma, int nc) {
  return nc == 2 ? (ma * bn <= (ma == 4 ? 32 : 64) ? 2 : 1) : (bn <= 64 ? 2 : 1);
}
// 56 x 128 + 88 x 256 <= 80 x 384: the registers two blocks an SM leave.
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 88;


// Bytes of the per-row table of window origins (three ints a row).
__host__ __device__ constexpr int table_bytes(int rows) {
  return (12 * rows + 127) / 128 * 128;
}

// This thread's x values of `n` k8 steps (at most KC), as the A fragment
// wants them: rows g and g + 8 of each of its atoms (`xa`: row g of the
// first atom, at column 2t of the first step), where phys columns 2t,
// 2t + 1 of a step hold logical k = t, t + 4.
template <int KC, int MA>
__device__ __forceinline__ void load_a(float (&f)[KC][MA][4], const float* xa,
                                       int xs, int n) {
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    if (c >= n) break;
#pragma unroll
    for (int a = 0; a < MA; ++a) {
      const float* p = xa + 8 * c + a * 64 * xs;
      const float2 u = *reinterpret_cast<const float2*>(p);
      const float2 v = *reinterpret_cast<const float2*>(p + 8 * xs);
      f[c][a][0] = u.x;
      f[c][a][1] = v.x;
      f[c][a][2] = u.y;
      f[c][a][3] = v.y;
    }
  }
}

// `n` k8 steps of a consumer warpgroup: split its x values into the A
// fragments, then acc += x_lo w_hi + x_hi w_lo + x_hi w_hi for each step
// (`bh`, `bl`: w's halves at the first step), one commit group.  The
// caller retires the previous group first: wgmma reads A's registers
// while it runs.
template <int BN, int KC, int MA>
__device__ __forceinline__ void mma_steps(float (&acc)[MA][BN / 2],
                                          uint32_t (&ah)[KC][MA][4],
                                          uint32_t (&al)[KC][MA][4],
                                          const float (&f)[KC][MA][4], int n,
                                          uint32_t bh, uint32_t bl) {
#pragma unroll
  for (int c = 0; c < KC; ++c)
#pragma unroll
    for (int a = 0; a < MA; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ah[c][a][e] = tf32_rna(f[c][a][e]);
        al[c][a][e] = tf32_rna(f[c][a][e] - __uint_as_float(ah[c][a][e]));
      }
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    if (c >= n) break;
    // B [BN x 8] K-major without swizzle: 8-row x 16-byte core matrices,
    // the two k halves 128 bytes apart, groups of 8 rows 256 bytes apart
    const uint64_t dh = smem_desc(bh + c * BN * 32, 128, 256, 0);
    const uint64_t dl = smem_desc(bl + c * BN * 32, 128, 256, 0);
#pragma unroll
    for (int a = 0; a < MA; ++a) {
      wgmma_tf32(acc[a], al[c][a], dh);
      wgmma_tf32(acc[a], ah[c][a], dl);
      wgmma_tf32(acc[a], ah[c][a], dh);
    }
  }
  wgmma_commit();
}

// ---- the bf16 route --------------------------------------------------------

// This thread's x values of `n` k16 steps (at most KC) as bf16 pairs, as
// the A fragment wants them: rows g and g + 8 of each of its atoms (`xa`:
// row g of the first atom, at column 4t of the first step), where phys
// columns 4t .. 4t + 3 of a step hold logical k = 2t, 2t + 1, 2t + 8,
// 2t + 9 (`bf16_row` places w's rows to match).
template <int KC, int MA>
__device__ __forceinline__ void load_a16(uint32_t (&f)[KC][MA][4],
                                         const __nv_bfloat16* xa, int xs, int n) {
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    if (c >= n) break;
#pragma unroll
    for (int a = 0; a < MA; ++a) {
      const __nv_bfloat16* p = xa + 16 * c + a * 64 * xs;
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      const uint2 v = *reinterpret_cast<const uint2*>(p + 8 * xs);
      f[c][a][0] = u.x;
      f[c][a][1] = v.x;
      f[c][a][2] = u.y;
      f[c][a][3] = v.y;
    }
  }
}

// The B row (logical k) of a slot's channel kk: the permutation of
// `load_a16`'s reads within each k16 step.
__host__ __device__ __forceinline__ int bf16_row(int kk) {
  const int p = kk % 16;
  return kk - p + 2 * (p / 4) + p % 2 + 8 * (p / 2 % 2);
}

// Byte offset in a slot's B tile of the 16-byte chunk c8 (columns 8 c8 ..
// 8 c8 + 7) of B row `row`: MN-major rows of `wrow` bytes (16, 32, 64 or
// 128: the tile's width, at most a 64-column panel; panels of ks rows lie
// ks * wrow bytes apart), 16-byte chunks swizzled within each 8-row group
// as the wgmma descriptor's 32, 64 or 128-byte swizzle reads them (none
// for 16-byte rows).
__device__ __forceinline__ int bf16_chunk(int row, int c8, int ks, int wrow) {
  const int per = wrow / 16;
  const int lin = (c8 / per) * ks * wrow + row * wrow + (c8 % per) * 16;
  return lin ^ (((lin >> 7) & (per - 1)) << 4);
}

// The descriptor of the B tile of one k16 step at shared address `addr`.
__device__ __forceinline__ uint64_t bf16_desc(uint32_t addr, int ks, int wrow) {
  switch (wrow) {
    case 16: return smem_desc(addr, 128, 128, 0);  // one 8-column core matrix
    case 32: return smem_desc(addr, ks * 32, 256, 3);
    case 64: return smem_desc(addr, ks * 64, 512, 2);
  }
  return smem_desc(addr, ks * 128, 1024, 1);
}

// `n` k16 steps of a consumer warpgroup: copy its x values into the A
// fragments, then acc += x w for each step (`b`: the B tile of the first
// step), one commit group.  The caller retires the previous group first.
template <int BN, int KC, int MA>
__device__ __forceinline__ void mma_steps16(float (&acc)[MA][BN / 2],
                                            uint32_t (&ar)[KC][MA][4],
                                            const uint32_t (&f)[KC][MA][4], int n,
                                            uint32_t b, int ks, int wrow) {
#pragma unroll
  for (int c = 0; c < KC; ++c)
#pragma unroll
    for (int a = 0; a < MA; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) ar[c][a][e] = f[c][a][e];
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    if (c >= n) break;
    const uint64_t d = bf16_desc(b + c * 16 * wrow, ks, wrow);
#pragma unroll
    for (int a = 0; a < MA; ++a) wgmma_bf16(acc[a], ar[c][a], d);
  }
  wgmma_commit();
}

// ---- the block ------------------------------------------------------------

// y[p, n0 + c] for the block's tile (see the file's note), on f32 or bf16
// operands.  BN: the wgmma width (bn rounded up to a power of two, at least
// 8); MA: 64-row atoms of each of the NC consumer warpgroups.
template <typename T, int BN, int MA, int NC>
__device__ __forceinline__ void mma_tile(const T* __restrict__ x,
                                         const T* __restrict__ w,
                                         T* __restrict__ y,
                                         const MmaShape& s, const MmaTile& t) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int ROWS = 64 * MA * NC;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ uint64_t full[kMaxStages], empty[kMaxStages];
  // per-row window origin: frame (-1 past the tile), and the input row
  // and column of tap (0, 0) (negative inside the SAME padding)
  int* rn = reinterpret_cast<int*>(smem);
  int* riy = rn + ROWS;
  int* rix = riy + ROWS;
  uint8_t* ring = smem + table_bytes(ROWS);
  if constexpr (!kF32)  // the swizzled B tiles sit on 1024-byte boundaries
    ring += (1024 - (smem_u32(ring) & 1023)) & 1023;

  const long long npix = static_cast<long long>(s.n) * s.ho * s.wo;
  const long long m0 = static_cast<long long>(blockIdx.x) * t.bm;
  const int n0 = blockIdx.y * t.bn;
  const int split = gridDim.z, rank = blockIdx.z;
  const int taps = t.fold ? s.kh : s.kh * s.kw;  // taps (rows) a step walks
  const int per_step = t.bkp / t.ks;  // ring slots a bk step
  const int first = rank * t.steps / split;
  const int items = ((rank + 1) * t.steps / split - first) * per_step;

  for (int r = threadIdx.x; r < ROWS; r += blockDim.x) {
    const long long p = m0 + r;
    if (r < t.bm && p < npix) {
      const long long q = p / s.wo;
      rn[r] = static_cast<int>(q / s.ho);
      riy[r] = static_cast<int>(q % s.ho) * s.stride - s.pad_t;
      rix[r] = static_cast<int>(p % s.wo) * s.stride - s.pad_l;
    } else {
      rn[r] = -1;
    }
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < t.stages; ++i) {
      mbar_init(&full[i], kProducer);
      mbar_init(&empty[i], 4 * NC);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* red = reinterpret_cast<float*>(ring);
  // Cluster split: each rank's partial tile [ROWS][BN] is in its shared
  // memory (over the ring, which every rank has finished reading); rank
  // r sums rows [r bm / split, (r + 1) bm / split) over the ranks in rank
  // order, then waits until no rank reads its partials any more.
  auto reduce_cluster = [&]() {
    cluster_sync();
    const int r0 = rank * t.bm / split, r1 = (rank + 1) * t.bm / split;
    const uint32_t red_addr = smem_u32(red);
    for (int e = threadIdx.x; e < (r1 - r0) * BN; e += blockDim.x) {
      const int row = r0 + e / BN, col = e % BN;
      const long long p = m0 + row;
      if (col >= t.bn || p >= npix) continue;
      const uint32_t addr = red_addr + 4 * (row * BN + col);
      float sum = ld_cluster(addr, 0);
      for (int q = 1; q < split; ++q) sum += ld_cluster(addr, q);
      y[p * s.d_out + n0 + col] = from_f32<T>(sum);
    }
    cluster_sync();
  };

  constexpr bool rebalance = NC == 2 && mma_min_blocks(BN, MA, NC) == 2;
  if (warp >= 4 * NC) {
    if constexpr (rebalance)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int pt = threadIdx.x - kProducer * NC;
    constexpr int EV = 16 / sizeof(T);  // elements a 16-byte copy
    const int width = t.vec ? EV : kF32 ? 1 : 0;  // elements a copy of x
    const int cpr = width ? t.ks / width : 1;     // copies a staged row
    const int rpp = kProducer / cpr;              // rows a pass of the warpgroup
    const int pr = pt / cpr, pc = (pt % cpr) * width;
    const int wwidth = t.wvec ? 4 : 1;  // floats a copy of w (f32)
    const int tap_rows = t.fold ? s.kw * s.d_in : s.d_in;  // w rows a tap
    for (int it = 0; it < items; ++it) {
      const int st = it % t.stages;
      mbar_wait(&empty[st], ((it / t.stages) & 1) ^ 1);
      const int q = first + it / per_step;      // bk step
      const int kofs = (it % per_step) * t.ks;  // slot's offset in it
      const int tap = q % taps;
      const int dy = t.fold ? tap : tap / s.kw, dx = t.fold ? 0 : tap % s.kw;
      // slot's first channel; folded, its first (dx, ci) pair, which lie
      // contiguous in x's row and in w
      const int ci0 = (q / taps) * t.kdim + kofs;
      uint8_t* slot = ring + st * t.slot_bytes;
      const T* wsrc =
          w + (static_cast<long long>(tap) * tap_rows + ci0) * s.d_out + n0;
      if constexpr (kF32) {
        float* xs = reinterpret_cast<float*>(slot);
        if (pr < rpp) {
          const bool kin = kofs + pc < t.kdim;
          const int ex = t.fold ? (kofs + pc) / s.d_in : 0;  // folded tap
          // staged row r, whose tap window starts at input (nn, iy, ix)
          const auto gather = [&](int r, int nn, int iy, int ix) {
            const bool live =
                kin && nn >= 0 &&
                static_cast<unsigned>(iy) < static_cast<unsigned>(s.h) &&
                static_cast<unsigned>(ix + ex) < static_cast<unsigned>(s.w);
            const float* src =
                live ? x + (static_cast<long long>(nn * s.h + iy) * s.w + ix) *
                               s.d_in + ci0 + pc
                     : x;
            if (t.vec)
              cp_async16(xs + r * t.xs + pc, src, live ? 16 : 0);
            else
              cp_async4(xs + r * t.xs + pc, src, live ? 4 : 0);
          };
          // four rows a pass, their table reads ahead of their copies (no
          // read moves past a copy's asm): the reads overlap
          int r = pr;
          for (; r + 3 * rpp < ROWS; r += 4 * rpp) {
            int nn[4], iy[4], ix[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              nn[u] = rn[r + u * rpp];
              iy[u] = riy[r + u * rpp] + dy;
              ix[u] = rix[r + u * rpp] + dx;
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) gather(r + u * rpp, nn[u], iy[u], ix[u]);
          }
          for (; r < ROWS; r += rpp) gather(r, rn[r], riy[r] + dy, rix[r] + dx);
        }
        // w[tap][ci0 + kk][n0 + n] as it lies, [ks][BN] (zero past bk, bn)
        float* raw = xs + ROWS * t.xs;
        for (int e = pt * wwidth; e < t.ks * BN; e += kProducer * wwidth) {
          const int kk = e / BN, n = e % BN;
          const bool live = kofs + kk < t.kdim && n < t.bn;
          const float* src =
              live ? wsrc + static_cast<long long>(kk) * s.d_out + n : w;
          if (t.wvec)
            cp_async16(raw + e, src, live ? 16 : 0);
          else
            cp_async4(raw + e, src, live ? 4 : 0);
        }
        cp_async_arrive(&full[st]);
      } else {
        // B: w[tap][ci0 + kk][n0 ..] at row bf16_row(kk) of the slot's
        // swizzled MN-major tile (zero past bk, bn); then x [rows][ks]
        T* xs = reinterpret_cast<T*>(slot + t.wbytes);
        if (t.vec) {
          if (pr < rpp) {
            const bool kin = kofs + pc < t.kdim;
            for (int r = pr; r < ROWS; r += rpp) {
              const int nn = rn[r], iy = riy[r] + dy, ix = rix[r] + dx;
              const bool live =
                  kin && nn >= 0 &&
                  static_cast<unsigned>(iy) < static_cast<unsigned>(s.h) &&
                  static_cast<unsigned>(ix) < static_cast<unsigned>(s.w);
              const T* src =
                  live ? x + (static_cast<long long>(nn * s.h + iy) * s.w + ix) *
                                 s.d_in + ci0 + pc
                       : x;
              cp_async16(xs + r * t.xs + pc, src, live ? 16 : 0);
            }
          }
          for (int e = pt; e < t.ks * (BN / 8); e += kProducer) {
            const int kk = e / (BN / 8), c8 = e % (BN / 8);
            const bool live = kofs + kk < t.kdim && 8 * c8 < t.bn;
            const T* src =
                live ? wsrc + static_cast<long long>(kk) * s.d_out + 8 * c8 : w;
            cp_async16(slot + bf16_chunk(bf16_row(kk), c8, t.ks, t.wrow), src,
                       live ? 16 : 0);
          }
          cp_async_arrive(&full[st]);
        } else {
          // rows that allow no 16-byte copy (conv1's 3 channels): 2 bytes
          // at a time through registers, kU loads in flight a thread, then
          // a plain (release) arrival
          constexpr int kU = 8;
          for (int e0 = pt; e0 < ROWS * t.ks; e0 += kU * kProducer) {
            T v[kU];
#pragma unroll
            for (int u = 0; u < kU; ++u) {
              const int e = e0 + u * kProducer;
              const int r = min(e / t.ks, ROWS - 1), k = e % t.ks;
              const int nn = e < ROWS * t.ks ? rn[r] : -1;
              const int iy = riy[r] + dy, ix = rix[r] + dx;
              const int ex = t.fold ? (kofs + k) / s.d_in : 0;  // folded tap
              const bool live =
                  kofs + k < t.kdim && nn >= 0 &&
                  static_cast<unsigned>(iy) < static_cast<unsigned>(s.h) &&
                  static_cast<unsigned>(ix + ex) < static_cast<unsigned>(s.w);
              v[u] = live ? x[(static_cast<long long>(nn * s.h + iy) * s.w + ix) *
                                  s.d_in + ci0 + k]
                          : from_f32<T>(0.f);
            }
#pragma unroll
            for (int u = 0; u < kU; ++u) {
              const int e = e0 + u * kProducer;
              if (e < ROWS * t.ks) xs[e / t.ks * t.xs + e % t.ks] = v[u];
            }
          }
          for (int e0 = pt; e0 < t.ks * BN; e0 += kU * kProducer) {
            T v[kU];
#pragma unroll
            for (int u = 0; u < kU; ++u) {
              const int e = e0 + u * kProducer, kk = e / BN, n = e % BN;
              const bool live = e < t.ks * BN && kofs + kk < t.kdim && n < t.bn;
              v[u] = live ? wsrc[static_cast<long long>(kk) * s.d_out + n]
                          : from_f32<T>(0.f);
            }
#pragma unroll
            for (int u = 0; u < kU; ++u) {
              const int e = e0 + u * kProducer, kk = e / BN, n = e % BN;
              if (e < t.ks * BN)
                *reinterpret_cast<T*>(slot + bf16_chunk(bf16_row(kk), n / 8, t.ks, t.wrow) +
                                      2 * (n % 8)) = v[u];
            }
          }
          mbar_arrive(&full[st]);
        }
      }
    }
    cp_async_wait_all();
    if (split > 1) {
      cluster_sync();  // every rank has read its ring
      reduce_cluster();
    }
    return;
  }

  if constexpr (rebalance)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  // Consumer warpgroup wg, warp wq in it; this thread holds rows g and
  // g + 8 of the warp's 16 in each atom, columns 2 tq, 2 tq + 1 of each 8.
  const int wg = warp / 4, wq = warp % 4, g = lane / 4, tq = lane % 4;
  float acc[MA][BN / 2];
#pragma unroll
  for (int a = 0; a < MA; ++a)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[a][i] = 0.f;
  constexpr int KC = mma_chunk(MA, NC);
  const int row0 = 64 * MA * wg + 16 * wq + g;
  if constexpr (kF32) {
    uint32_t ah[KC][MA][4], al[KC][MA][4];
    float f[KC][MA][4];
    const int nk = t.ks / 8;
    // the consumers' two buffers of w's hi / lo halves (by item parity:
    // one is written while the other may still be read by wgmma)
    float* own = reinterpret_cast<float*>(ring + t.stages * t.slot_bytes);
    for (int it = 0; it < items; ++it) {
      const int st = it % t.stages;
      mbar_wait(&full[st], (it / t.stages) & 1);
      const float* xs = reinterpret_cast<const float*>(ring + st * t.slot_bytes);
      const float* xa = xs + row0 * t.xs + 2 * tq;
      // w as hi / lo into the consumers' buffer of the item's parity,
      // [ks / 8][BN / 8][2][8][4] floats each: logical k j of a k8 step at
      // phys kk = 2 (j % 4) + j / 4, as x is read
      const float* raw = xs + ROWS * t.xs;
      float* ph = own + (it & 1) * 2 * t.ks * BN;
      float* pl = ph + t.ks * BN;
      // item (k8 step c, column n): its even k are one 16-byte run of each
      // half, its odd k the run 32 floats on
      for (int e = threadIdx.x; e < nk * BN; e += kProducer * NC) {
        const int c = e / BN, n = e % BN;
        float h[2][4], l[2][4];  // [k % 2][k / 2]
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const float v = raw[(8 * c + kk) * BN + n];
          const uint32_t hi = tf32_rna(v);
          h[kk % 2][kk / 2] = __uint_as_float(hi);
          l[kk % 2][kk / 2] = __uint_as_float(tf32_rna(v - __uint_as_float(hi)));
        }
        const int off = c * BN * 8 + (n / 8) * 64 + (n % 8) * 4;
#pragma unroll
        for (int odd = 0; odd < 2; ++odd) {
          *reinterpret_cast<float4*>(ph + off + 32 * odd) =
              make_float4(h[odd][0], h[odd][1], h[odd][2], h[odd][3]);
          *reinterpret_cast<float4*>(pl + off + 32 * odd) =
              make_float4(l[odd][0], l[odd][1], l[odd][2], l[odd][3]);
        }
      }
      fence_proxy_async();
      named_sync(1, kProducer * NC);  // every consumer's share is in
      const uint32_t bh = smem_u32(ph);
      const uint32_t bl = smem_u32(pl);
      load_a(f, xa, t.xs, nk);
      for (int j = 0; j < nk; j += KC) {
        // the slot's last x values are in registers, and the products read
        // w from the consumers' own buffers: the slot goes back
        if (j + KC >= nk) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[st]);
        }
        mma_steps<BN, KC, MA>(acc, ah, al, f, nk - j, bh + j * BN * 32,
                              bl + j * BN * 32);
        // the next steps' x loads overlap these steps' products
        if (j + KC < nk) load_a(f, xa + 8 * (j + KC), t.xs, nk - j - KC);
        wgmma_wait_all();
        pin(ah);
        pin(al);
      }
      pin(acc);
    }
  } else {
    uint32_t ar[KC][MA][4], f[KC][MA][4];
    const int nk = t.ks / 16;
    for (int it = 0; it < items; ++it) {
      const int st = it % t.stages;
      mbar_wait(&full[st], (it / t.stages) & 1);
      // the producer's writes (cp.async or plain stores) before wgmma's
      // reads through the async proxy
      fence_proxy_async();
      const uint8_t* slot = ring + st * t.slot_bytes;
      const T* xa = reinterpret_cast<const T*>(slot + t.wbytes) + row0 * t.xs + 4 * tq;
      const uint32_t b = smem_u32(slot);
      load_a16(f, xa, t.xs, nk);
      for (int j = 0; j < nk; j += KC) {
        mma_steps16<BN, KC, MA>(acc, ar, f, nk - j, b + j * 16 * t.wrow, t.ks, t.wrow);
        if (j + KC < nk) load_a16(f, xa + 16 * (j + KC), t.xs, nk - j - KC);
        wgmma_wait_all();
        pin(ar);
      }
      pin(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
  }

  if (split == 1) {
    const bool pairs = !kF32 && s.d_out % 2 == 0 && t.bn % 2 == 0;
#pragma unroll
    for (int a = 0; a < MA; ++a)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 64 * (MA * wg + a) + 16 * wq + g + 8 * h;
        const long long p = m0 + row;
        if (row >= t.bm || p >= npix) continue;
        T* dst = y + p * s.d_out + n0;
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          const int col = 8 * i + 2 * tq;
          const float v0 = acc[a][4 * i + 2 * h], v1 = acc[a][4 * i + 2 * h + 1];
          if (pairs && col + 1 < t.bn) {
            *reinterpret_cast<uint32_t*>(dst + col) = bf16_pack(v0, v1);
            continue;
          }
          if (col < t.bn) dst[col] = from_f32<T>(v0);
          if (col + 1 < t.bn) dst[col + 1] = from_f32<T>(v1);
        }
      }
    return;
  }
  cluster_sync();  // every rank has read its ring
#pragma unroll
  for (int a = 0; a < MA; ++a)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 64 * (MA * wg + a) + 16 * wq + g + 8 * h;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        red[row * BN + 8 * i + 2 * tq] = acc[a][4 * i + 2 * h];
        red[row * BN + 8 * i + 2 * tq + 1] = acc[a][4 * i + 2 * h + 1];
      }
    }
  reduce_cluster();
}

// ---- host: the block's plan and launch ----------------------------------

// Shared memory one block may take, less the static mbarriers; and the
// share that leaves room for two blocks on an SM.
constexpr int kSmemBlock = 232448 - 1024;
constexpr int kSmemHalf = 232448 / 2 - 1024;

inline int pow2_at_least(int v, int lo) {
  int p = lo;
  while (p < v) p *= 2;
  return p;
}

// SMs of the current device (0 where it cannot be read), read once a device.
inline int sm_count() {
  static int sms[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 0;
  if (!sms[dev] &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms[dev] = 0;
  return sms[dev];
}

// Blocks each tile's `steps` are split over: 1 where the launch's `blocks`
// fill the `sms`, else a cluster of up to kMaxSplit (and up to two blocks
// an SM), as few blocks as give each the fewest steps.  A split down to
// one step a block is taken only where fewer than half the SMs have a
// block: MobileNetV2's two-step expand rows at 72-96 blocks timed up to
// 11 % slower split than not on an H100 (tools/cluster_split_times.py),
// which does not tell the cluster's reduction from its launch's host cost.
inline int split_rule(long long blocks, int steps, int sms) {
  if (blocks >= sms) return 1;
  const long long most = std::max<long long>(
      1, std::min<long long>({kMaxSplit, steps, 2 * sms / blocks}));
  const long long per = (steps + most - 1) / most;
  if (per == 1 && 2 * blocks >= sms) return 1;
  return static_cast<int>((steps + per - 1) / per);
}

// How a block groups the plan's tiles: `rows` pixel tiles and `cols`
// column tiles, each 0 for the rule of the kernel that asks.  The FCU's
// rule (`wide` false) packs up to 64 / bm pixel tiles into one 64-row atom
// where bm < 64, and one column tile.  The KPU's on f32 (`wide`) packs up
// to 128 / bm pixel tiles where bm <= 64 and the accumulators allow two
// consumer warpgroups (else as the FCU), then the widest run of column tiles
// (a power of two dividing d_out / bn) whose wgmma width, at most 256,
// leaves the consumers' accumulators within their budget; each step only
// where the cluster split the wider block gets leaves it 3 steps or more.
struct MmaGroup {
  bool wide;
  int rows, cols;
};

// The launch of one FCU / KPU call: template arguments, grid and plan,
// and the plan's pixel and column tiles a block runs.
struct MmaLaunch {
  int bn_pad, ma, nc, split;
  int rows, cols;
  MmaTile t;
  size_t smem;
  dim3 grid, block;
};

// 64-row atoms of a block of `rows` pixels and their consumer warpgroups
// (`nc`, each of `ma` atoms); false past 512 rows, or where the
// accumulators of a `bn_pad`-wide block pass a consumer thread's budget:
// 128 beside one warpgroup, 64 beside two (384 threads leave at most 168
// registers a thread).
inline bool block_atoms(long long rows, int bn_pad, int* ma, int* nc) {
  if (rows > 512 || bn_pad > 256) return false;
  const int atoms = rows <= 64 ? 1 : rows <= 128 ? 2 : rows <= 256 ? 4 : 8;
  *nc = atoms == 1 ? 1 : 2;
  *ma = atoms / *nc;
  return *ma * bn_pad / 2 <= (*nc == 1 ? 128 : 64);
}

// Plan the (bm, bk, bn) tile of `s`, grouped as `g` gives, split `split`
// ways along a cluster (0: as `split_rule` gives); false if the kernels
// do not take it.  `x_ok`, `w_ok`: x, w are 16-byte aligned; `elem`: bytes
// of an element (4: f32, 2: bf16).
inline bool plan_tile(const MmaShape& s, int bm, int bk, int bn, int split, MmaGroup g,
                      bool x_ok, bool w_ok, int elem, MmaLaunch* l) {
  if (bm < 1 || bm > 512 || bk < 1 || bn < 1 || bn > 256 || s.d_in % bk ||
      s.d_out % bn || split < 0 || split > kMaxSplit || g.rows < 0 || g.cols < 0 ||
      (s.d_out / bn) % (g.cols ? g.cols : 1))
    return false;
  const bool f32 = elem == 4;
  const int ev = 16 / elem;  // elements a 16-byte copy
  const bool narrow = s.d_in % ev || bk % ev;  // rows allow no 16-byte copy
  MmaTile& t = l->t;
  t.fold = narrow && bk == s.d_in && s.kw > 1;
  t.steps = t.fold ? s.kh : s.d_in / bk * s.kh * s.kw;
  const long long npix = static_cast<long long>(s.n) * s.ho * s.wo;
  const long long ptiles = (npix + bm - 1) / bm;  // the plan's pixel tiles
  const auto fits = [&](long long rows, int cols) {
    return block_atoms(bm * std::min(rows, ptiles), pow2_at_least(bn * cols, 8), &l->ma,
                       &l->nc);
  };
  // the KPU's rule takes a group only where the cluster split it would get
  // leaves each block 3 steps or more: at small batches a wider group
  // split further runs slower than the narrower one
  const auto deep = [&](long long rows, int cols) {
    const long long live = bm * std::min(rows, ptiles);
    const int ways = split_rule((npix + live - 1) / live * (s.d_out / (bn * cols)), t.steps,
                                sm_count());
    return fits(rows, cols) && (ways == 1 || t.steps >= 3 * ways);
  };
  l->cols = g.cols ? g.cols : 1;
  l->rows = g.rows ? g.rows : g.wide && bm <= 64 && deep(128 / bm, l->cols) ? 128 / bm
                            : bm < 64 ? 64 / bm : 1;
  l->rows = static_cast<int>(std::min<long long>(l->rows, ptiles));
  if (!fits(l->rows, l->cols)) return false;
  if (!g.cols && g.wide)
    for (int c = 2; (s.d_out / bn) % c == 0 && deep(l->rows, c); c *= 2) l->cols = c;
  const int rows_live = bm * l->rows;
  l->bn_pad = pow2_at_least(bn * l->cols, 8);
  fits(l->rows, l->cols);  // the chosen group's atoms
  const int atoms = l->ma * l->nc;
  const int rows = 64 * atoms;
  t.bm = rows_live;
  t.bk = bk;
  t.bn = bn * l->cols;
  t.vec = f32 ? x_ok && !narrow
              : x_ok && w_ok && !narrow && s.d_out % ev == 0 && bn % ev == 0;
  t.kdim = t.fold ? s.kw * s.d_in : bk;
  const int kstep = f32 ? 8 : 16;
  t.bkp = (t.kdim + kstep - 1) / kstep * kstep;
  t.wvec = w_ok && s.d_out % 4 == 0 && bn % 4 == 0;
  t.wrow = l->bn_pad * 2 < 128 ? l->bn_pad * 2 : 128;
  const long long tiles_m = (npix + rows_live - 1) / rows_live;
  if (split == 0) split = split_rule(tiles_m * (s.d_out / t.bn), t.steps, sm_count());
  if (split > t.steps) return false;
  const int red = split > 1 ? rows * l->bn_pad * 4 : 0;
  const int steps_per_block = (t.steps + split - 1) / split;
  // the widest slot that leaves room for two blocks an SM, else for one; a
  // KPU block whose registers allow one block an SM takes all of it
  const bool one = g.wide && mma_min_blocks(l->bn_pad, l->ma, l->nc) == 1;
  for (int budget : {one ? kSmemBlock : kSmemHalf, kSmemBlock}) {
    for (int k8 : {4, 3, 2, 1}) {
      const int ks = k8 * 32 / elem;  // a row slice of 128, 96, 64, 32 bytes
      if (t.bkp % ks) continue;
      t.ks = ks;
      int own, slack;
      if (f32) {
        t.xs = ks % 16 == 0 ? ks + 8 : ks;  // row pitch of 32 or 96 mod 128 B
        // x and w as copied; beside the ring, the consumers' two buffers of
        // w's hi and lo halves
        t.slot_bytes = rows * t.xs * 4 + ks * l->bn_pad * 4;
        own = 4 * ks * l->bn_pad * 4;
        slack = 0;
      } else {
        t.xs = ks % 32 == 0 ? ks + 16 : ks;  // row pitch of 32 or 96 mod 128 B
        // w as wgmma reads it, on a 1024-byte boundary, then x; the ring
        // starts on one too
        t.wbytes = (ks * l->bn_pad * 2 + 1023) / 1024 * 1024;
        t.slot_bytes = (t.wbytes + rows * t.xs * 2 + 1023) / 1024 * 1024;
        own = 0;
        slack = 1024;
      }
      const int room = budget - table_bytes(rows) - slack - own;
      // a ring of up to 8 slots, no more than a block has items
      const int items = steps_per_block * (t.bkp / ks);
      int stages = room / t.slot_bytes;
      if (stages > kMaxStages) stages = kMaxStages;
      if (stages > items) stages = items;
      if (stages < (items < 2 ? items : 2) || red > room + own) continue;
      t.stages = stages;
      const int ring = stages * t.slot_bytes + own;
      l->smem = table_bytes(rows) + slack + (ring > red ? ring : red);
      l->split = split;
      l->grid = dim3(static_cast<unsigned>(tiles_m), s.d_out / t.bn, split);
      l->block = dim3(kProducer * (l->nc + 1));
      return true;
    }
  }
  return false;
}

// Run F::template run<BN, MA, NC>() for the plan's template arguments.
template <int BN, typename F>
int dispatch_atoms(const MmaLaunch& l, F& f) {
  if (l.nc == 1) return f.template run<BN, 1, 1>();
  if (l.ma == 1) {
    if constexpr (BN <= 128) return f.template run<BN, 1, 2>();
  } else if (l.ma == 2) {
    if constexpr (BN <= 64) return f.template run<BN, 2, 2>();
  } else {
    if constexpr (BN <= 32) return f.template run<BN, 4, 2>();
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename F>
int dispatch(const MmaLaunch& l, F& f) {
  switch (l.bn_pad) {
    case 8: return dispatch_atoms<8>(l, f);
    case 16: return dispatch_atoms<16>(l, f);
    case 32: return dispatch_atoms<32>(l, f);
    case 64: return dispatch_atoms<64>(l, f);
    case 128: return dispatch_atoms<128>(l, f);
    case 256: return dispatch_atoms<256>(l, f);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace rt
