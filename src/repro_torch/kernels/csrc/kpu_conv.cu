// KPU — the paper's kernel processing unit: a direct NHWC convolution with
// SAME padding, y[n, oy, ox, co] = sum_{dy, dx, ci} x[n, oy*s+dy-pt, ox*s+dx-pl, ci]
// * w[dy, dx, ci, co], x outside the frame reading as zero.
//
// Replaces the Pallas TPU kernel kernels/kpu_conv/kpu_conv.py::kpu_conv_p
// (body _kpu_kernel).  The TPU block holds a whole padded frame and, per
// (dy, dx) tap, multiplies a strided [Ho, Wo, bci] window by w[dy, dx].  A
// 224x224 frame does not fit one block's 227 KiB of shared memory, so this
// kernel is an implicit GEMM tiled over output pixels instead: M = N*Ho*Wo
// flattened pixels, one block per (bm pixels x bco output channels).  For
// each planned input-channel tile bci and each tap it gathers the strided
// window rows of its bm pixels into shared memory — only surviving windows
// are read (the paper's §II-E stride pruning), and the asymmetric SAME
// padding (ResNet conv1 at 224: (2, 3); MobileNetV2 conv1: (0, 1)) is
// zero-fill in the index math, so no padded copy of the input is made —
// then accumulates in registers (tile_gemm.cuh).  Each pixel row's window
// origin is computed once per block, so staging a tap costs a bounds check
// and a load per element.  d_in = 3 (conv1) is just a bci = 3 step.
//
// Bound on an H100: ResNet-18's 3x3 convs do 576-4608 MACs per pixel, far
// above the card's fp32 ridge, so the CUDA-core FMA loop and its
// shared-memory operand traffic bound it.  Left for a later change: wgmma
// on TMA-staged (im2col) tiles, pipelined staging, and reusing one staged
// halo across the kh*kw taps.
#include <cuda_runtime.h>

#include "tile_gemm.cuh"

namespace {

struct ConvShape {
  int n, h, w, d_in, ho, wo, d_out, kh, kw, stride, pad_t, pad_l;
};

template <int TM, int TN>
__global__ void __launch_bounds__(rt::kMaxThreads)
    kpu_kernel(const float* __restrict__ x, const float* __restrict__ wt,
               float* __restrict__ y, ConvShape s, int bm, int bci, int bco) {
  extern __shared__ float smem[];
  const int TX = blockDim.x, TY = blockDim.y, G = blockDim.z;
  const int tx = threadIdx.x, ty = threadIdx.y, g = threadIdx.z;
  const int tid = (g * TY + ty) * TX + tx, nthr = TX * TY * G;
  const int rows = TM * TY, ldx = rows + 1, ldw = TN * TX;
  // per-row window origin, computed once: frame (-1 past the tile), and
  // the input row / column of tap (0, 0) (negative inside the SAME pad)
  int* rn = reinterpret_cast<int*>(smem);
  int* riy = rn + rows;
  int* rix = riy + rows;
  float* xs = smem + 3 * rows;   // [bci][ldx]
  float* ws = xs + bci * ldx;    // [bci][ldw]
  const long long npix = static_cast<long long>(s.n) * s.ho * s.wo;
  const long long m0 = static_cast<long long>(blockIdx.x) * bm;
  const int co0 = blockIdx.y * bco;
  const int lanes = rt::staging_lanes(bci, nthr), rgroups = nthr / lanes;
  const int lane = tid % lanes;

  for (int r = tid; r < rows; r += nthr) {
    const long long p = m0 + r;
    if (r < bm && p < npix) {
      const int ox = static_cast<int>(p % s.wo);
      const long long t = p / s.wo;
      rn[r] = static_cast<int>(t / s.ho);
      riy[r] = static_cast<int>(t % s.ho) * s.stride - s.pad_t;
      rix[r] = ox * s.stride - s.pad_l;
    } else {
      rn[r] = -1;
    }
  }
  __syncthreads();

  float acc[TM][TN];
  rt::zero(acc);
  for (int ci0 = 0; ci0 < s.d_in; ci0 += bci) {
    for (int dy = 0; dy < s.kh; ++dy) {
      for (int dx = 0; dx < s.kw; ++dx) {
        if (tid < rgroups * lanes) {
          for (int r = tid / lanes; r < rows; r += rgroups) {
            const int nn = rn[r], iy = riy[r] + dy, ix = rix[r] + dx;
            const bool live = nn >= 0 && static_cast<unsigned>(iy) < s.h &&
                              static_cast<unsigned>(ix) < s.w;
            const float* src =
                x + (static_cast<long long>(nn * s.h + iy) * s.w + ix) * s.d_in +
                ci0;
            for (int kk = lane; kk < bci; kk += lanes)
              xs[kk * ldx + r] = live ? src[kk] : 0.f;
          }
        }
        rt::stage_weights(
            ws,
            wt + (static_cast<long long>(dy * s.kw + dx) * s.d_in + ci0) *
                     s.d_out + co0,
            s.d_out, bci, ldw, bco, tid, nthr);
        __syncthreads();
        rt::accumulate_step<TM, TN>(xs, ws, bci, ldx, ldw, tx, ty, TX, TY, g,
                                    G, acc);
        __syncthreads();
      }
    }
  }
  rt::reduce_groups<TM, TN>(smem, tx, ty, TX, TY, g, G, acc);
  if (g > 0) return;

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty + TY * i;
    const long long p = m0 + r;
    if (r >= bm || p >= npix) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = tx + TX * j;
      if (c < bco) y[p * s.d_out + co0 + c] = acc[i][j];
    }
  }
}

struct KpuLaunch {
  const float *x, *w;
  float* y;
  ConvShape s;
  int bm, bci, bco, tx, ty, tm, tn, g;
  cudaStream_t stream;

  template <int TM, int TN>
  int run() {
    const long long npix = static_cast<long long>(s.n) * s.ho * s.wo;
    dim3 grid(static_cast<unsigned>((npix + bm - 1) / bm), s.d_out / bco);
    dim3 block(tx, ty, g);
    const size_t rows_bytes = 3 * sizeof(int) * static_cast<size_t>(tm) * ty;
    return rt::launch(kpu_kernel<TM, TN>, grid, block,
                      rt::smem_bytes(bci, tx, ty, tm, tn, g, rows_bytes),
                      stream, x, w, y, s, bm, bci, bco);
  }
};

}  // namespace

extern "C" int kpu_conv_f32(const float* x, const float* w, float* y, int n,
                            int h, int wd, int d_in, int ho, int wo, int d_out,
                            int kh, int kw, int stride, int pad_t, int pad_l,
                            int bm, int bci, int bco, int tx, int ty, int tm,
                            int tn, int g, cudaStream_t stream) {
  if (!rt::layout_ok(bm, bci, bco, tx, ty, tm, tn, g) || d_in % bci ||
      d_out % bco)
    return static_cast<int>(cudaErrorInvalidValue);
  KpuLaunch f{x,  w,   y,   {n, h, wd, d_in, ho, wo, d_out, kh, kw, stride,
                              pad_t, pad_l},
              bm, bci, bco, tx, ty, tm, tn, g, stream};
  return rt::dispatch(tm, tn, f);
}
