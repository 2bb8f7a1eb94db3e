// Block-tile product shared by the FCU (fcu_matmul.cu) and KPU
// (kpu_conv.cu) kernels.
//
// One thread block owns a (bm x bn) output tile and walks the contraction
// axis in planned bk steps.  Each step the block stages a [bk][LDX] slice
// of the input (pixel-minor, zero-filled past the tile's rows) and a
// [bk][LDW] slice of the weights in shared memory.  The block's threads
// are G k-groups (threadIdx.z) of TX x TY threads: group g takes the
// step's contraction rows kk = g, g+G, ..., and each thread accumulates a
// TM x TN register tile, rows ty + TY*i and columns tx + TX*j, in f32 with
// fmaf.  After the last step the groups' partial tiles are summed through
// shared memory in group order (deterministic).  More groups put more
// warps on a tile without changing it, which hides shared-memory latency
// where the plan's tiles leave few blocks.  LDX = TM*TY + 1: the one float
// of skew keeps the transposed staging stores free of bank conflicts.
//
// The layout (TX, TY, TM, TN, G) comes from the wrapper
// (repro_torch.core.tiles.gemm_layout), which also sized the shared memory.
#pragma once

#include <cuda_runtime.h>

namespace rt {

constexpr int kMaxThreads = 512;  // 512 x <=128 registers fit one SM

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

template <int TM, int TN>
__device__ __forceinline__ void accumulate_step(const float* __restrict__ xs,
                                                const float* __restrict__ ws,
                                                int bk, int ldx, int ldw,
                                                int tx, int ty, int TX, int TY,
                                                int g, int G,
                                                float (&acc)[TM][TN]) {
  for (int kk = g; kk < bk; kk += G) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = xs[kk * ldx + ty + TY * i];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = ws[kk * ldw + tx + TX * j];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Lanes a staging loop runs along a `width`-wide axis: up to a warp, and
// never more than the block has threads, so that `nthr / lanes` groups of
// lanes are at least one and every element is written.
__device__ __forceinline__ int staging_lanes(int width, int nthr) {
  const int lanes = width < 32 ? width : 32;
  return lanes < nthr ? lanes : nthr;
}

// Stage w[k0 + kk][n0 + c] (row stride d_out) into ws[kk][c] for
// kk < bk, c < ldw; columns at or past bn read as zero.  Lanes run along
// c so a warp reads neighbouring weights.
__device__ __forceinline__ void stage_weights(float* __restrict__ ws,
                                              const float* __restrict__ w,
                                              long long d_out, int bk,
                                              int ldw, int bn, int tid,
                                              int nthr) {
  const int lanes = staging_lanes(ldw, nthr);
  const int groups = nthr / lanes;
  if (tid >= groups * lanes) return;
  const int lane = tid % lanes;
  for (int kk = tid / lanes; kk < bk; kk += groups) {
    const float* src = w + kk * d_out;
    for (int c = lane; c < ldw; c += lanes)
      ws[kk * ldw + c] = c < bn ? src[c] : 0.f;
  }
}

// Sum the G groups' partial tiles into group 0's registers, in group
// order, through `red` (which may reuse the staging area).
template <int TM, int TN>
__device__ __forceinline__ void reduce_groups(float* red, int tx, int ty,
                                              int TX, int TY, int g, int G,
                                              float (&acc)[TM][TN]) {
  if (G == 1) return;
  const int ldn = TN * TX, out = TM * TY * ldn;
  if (g > 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        red[(g - 1) * out + (ty + TY * i) * ldn + tx + TX * j] = acc[i][j];
  }
  __syncthreads();
  if (g == 0) {
    for (int h = 1; h < G; ++h)
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] += red[(h - 1) * out + (ty + TY * i) * ldn + tx + TX * j];
  }
}

// Shared-memory bytes of one block: `extra` bytes of per-row indices, then
// [bk][LDX] + [bk][LDW] staged floats; the group reduction reuses it all.
inline size_t smem_bytes(int bk, int tx, int ty, int tm, int tn, int g,
                         size_t extra) {
  const size_t staged =
      extra + (static_cast<size_t>(tm) * ty + 1 + static_cast<size_t>(tn) * tx) *
                  bk * sizeof(float);
  const size_t reduce = static_cast<size_t>(g - 1) * tm * ty * tn * tx *
                        sizeof(float);
  return staged > reduce ? staged : reduce;
}

// Opt the kernel in to more than 48 KiB of dynamic shared memory, then
// launch it; return the launch's error code.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, dim3 block, size_t smem,
           cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, block, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// Map the runtime (tm, tn) in {1, 2, 4, 8}^2 onto a template instance:
// F::template run<TM, TN>() launches it.
template <int TM, typename F>
int dispatch_tn(int tn, F& f) {
  switch (tn) {
    case 1: return f.template run<TM, 1>();
    case 2: return f.template run<TM, 2>();
    case 4: return f.template run<TM, 4>();
    case 8: return f.template run<TM, 8>();
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename F>
int dispatch(int tm, int tn, F& f) {
  switch (tm) {
    case 1: return dispatch_tn<1>(tn, f);
    case 2: return dispatch_tn<2>(tn, f);
    case 4: return dispatch_tn<4>(tn, f);
    case 8: return dispatch_tn<8>(tn, f);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The checks every block-tile launch shares.
inline bool layout_ok(int bm, int bk, int bn, int tx, int ty, int tm, int tn,
                      int g) {
  return tx >= 1 && ty >= 1 && g >= 1 && g <= bk &&
         tx * ty * g <= kMaxThreads && tm * ty >= bm && tn * tx >= bn;
}

}  // namespace rt
