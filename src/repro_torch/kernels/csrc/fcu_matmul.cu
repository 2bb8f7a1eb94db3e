// FCU — the paper's fully-connected unit: y[m, d_out] = x[m, d_in] @ w[d_in, d_out].
//
// Replaces the Pallas TPU kernel kernels/fcu_matmul/fcu_matmul.py::fcu_matmul_p
// (body _fcu_kernel): grid (m/bm, d_out/bn, d_in/bk) with k innermost and an
// f32 VMEM accumulator.  Here one block owns a (bm x bn) output tile of the
// plan, loops over d_in in the planned bk steps itself (blocks run in no
// order on Hopper, so the sequential k grid axis becomes that loop) and keeps
// the accumulator in registers (tile_gemm.cuh); where the tile leaves few
// threads, k-groups of threads share it (tile_gemm.cuh).
//
// Bound on an H100: by the roofline, HBM bytes for MobileNetV2's narrow
// projections (below the fp32 ridge of ~20 flops a byte) and fp32
// operations for its wide expansions.  In practice the plan's narrow tiles
// launch few blocks, and the CUDA-core FMA loop with its shared-memory
// operand reads sets the time.  The design keeps a TM x TN register tile
// per thread so each staged float feeds TM or TN FMAs, and k-groups put
// more warps on a narrow tile.  Left for a later change: wgmma on
// TMA-staged tiles (tf32/bf16), multi-stage cp.async pipelining,
// vectorised staging.
#include <cuda_runtime.h>

#include "tile_gemm.cuh"

namespace {

template <int TM, int TN>
__global__ void __launch_bounds__(rt::kMaxThreads)
    fcu_kernel(const float* __restrict__ x, const float* __restrict__ w,
               float* __restrict__ y, int m, int d_in, int d_out, int bm,
               int bk, int bn) {
  extern __shared__ float smem[];
  const int TX = blockDim.x, TY = blockDim.y, G = blockDim.z;
  const int tx = threadIdx.x, ty = threadIdx.y, g = threadIdx.z;
  const int tid = (g * TY + ty) * TX + tx, nthr = TX * TY * G;
  const int ldx = TM * TY + 1, ldw = TN * TX;
  float* xs = smem;             // [bk][ldx]
  float* ws = smem + bk * ldx;  // [bk][ldw]
  const long long m0 = static_cast<long long>(blockIdx.x) * bm;
  const int n0 = blockIdx.y * bn;
  // staging lanes run along the contraction axis: a warp reads
  // neighbouring features of a row
  const int lanes = rt::staging_lanes(bk, nthr), rgroups = nthr / lanes;
  const int lane = tid % lanes;

  float acc[TM][TN];
  rt::zero(acc);
  for (int k0 = 0; k0 < d_in; k0 += bk) {
    if (tid < rgroups * lanes) {
      for (int r = tid / lanes; r < ldx - 1; r += rgroups) {
        const long long row = m0 + r;
        const bool live = r < bm && row < m;
        const float* src = x + row * d_in + k0;
        for (int kk = lane; kk < bk; kk += lanes)
          xs[kk * ldx + r] = live ? src[kk] : 0.f;
      }
    }
    rt::stage_weights(ws, w + static_cast<long long>(k0) * d_out + n0, d_out,
                      bk, ldw, bn, tid, nthr);
    __syncthreads();
    rt::accumulate_step<TM, TN>(xs, ws, bk, ldx, ldw, tx, ty, TX, TY, g, G,
                                acc);
    __syncthreads();
  }
  rt::reduce_groups<TM, TN>(smem, tx, ty, TX, TY, g, G, acc);
  if (g > 0) return;

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty + TY * i;
    const long long row = m0 + r;
    if (r >= bm || row >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = tx + TX * j;
      if (c < bn) y[row * d_out + n0 + c] = acc[i][j];
    }
  }
}

struct FcuLaunch {
  const float *x, *w;
  float* y;
  int m, d_in, d_out, bm, bk, bn, tx, ty, tm, tn, g;
  cudaStream_t stream;

  template <int TM, int TN>
  int run() {
    dim3 grid((m + bm - 1) / bm, d_out / bn);
    dim3 block(tx, ty, g);
    return rt::launch(fcu_kernel<TM, TN>, grid, block,
                      rt::smem_bytes(bk, tx, ty, tm, tn, g, 0), stream, x, w,
                      y, m, d_in, d_out, bm, bk, bn);
  }
};

}  // namespace

extern "C" int fcu_matmul_f32(const float* x, const float* w, float* y, int m,
                              int d_in, int d_out, int bm, int bk, int bn,
                              int tx, int ty, int tm, int tn, int g,
                              cudaStream_t stream) {
  if (!rt::layout_ok(bm, bk, bn, tx, ty, tm, tn, g) || d_in % bk || d_out % bn)
    return static_cast<int>(cudaErrorInvalidValue);
  FcuLaunch f{x, w, y, m, d_in, d_out, bm, bk, bn, tx, ty, tm, tn, g, stream};
  return rt::dispatch(tm, tn, f);
}
