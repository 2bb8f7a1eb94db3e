// Depthwise KPU — MobileNet's depthwise k x k convolution with channel
// multiplier 1 and SAME padding: y[n, oy, ox, c] = sum_{dy, dx}
// x[n, oy*s+dy-pt, ox*s+dx-pl, c] * w[dy, dx, c], x outside the frame
// reading as zero.  No reduction across channels.
//
// Replaces the Pallas TPU kernel kernels/dw_conv/dw_conv.py::dw_conv_p (body
// _dw_kernel), whose grid step (n, channel tile) streams a whole padded
// frame and so cannot keep to a memory budget.  This kernel is blocked over
// output rows: one block per (frame, run of `rows` output rows, planned
// channel tile bc).  Its threads are laid out channel-fastest, so the 32
// lanes of a warp read 32 neighbouring channels of one pixel (one 128-byte
// line for bc >= 32), and each thread accumulates its outputs' taps in f32
// with fmaf.  The block's k x k x bc weights are staged once in shared
// memory.  Stride pruning: only the windows of surviving outputs are read.
//
// Bound on an H100: 9 MACs per output against 4 bytes read per input
// element, well below the fp32 ridge, so HBM bytes bound it.  Inputs are
// read from global memory through L1/L2, up to kh*kw times each.  Left for
// a later change: a shared-memory halo of the block's input rows (so each
// element is read from HBM once) and 16-byte vector loads across channels.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    dw_kernel(const float* __restrict__ x, const float* __restrict__ w,
              float* __restrict__ y, int h, int wd, int c, int ho, int wo,
              int kh, int kw, int stride, int pad_t, int pad_l, int rows,
              int bc) {
  extern __shared__ float wsm[];  // [kh*kw][bc]
  const int row_blocks = (ho + rows - 1) / rows;
  const long long nn = blockIdx.x / row_blocks;
  const int oy0 = (blockIdx.x % row_blocks) * rows;
  const int c0 = blockIdx.y * bc;

  for (int idx = threadIdx.x; idx < kh * kw * bc; idx += blockDim.x)
    wsm[idx] = w[(idx / bc) * c + c0 + idx % bc];
  __syncthreads();

  const int total = rows * wo * bc;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int cc = idx % bc, pix = idx / bc;
    const int ox = pix % wo, oy = oy0 + pix / wo;
    if (oy >= ho) break;  // idx only grows, so every later oy is past too
    const int iy0 = oy * stride - pad_t, ix0 = ox * stride - pad_l;
    float acc = 0.f;
    for (int dy = 0; dy < kh; ++dy) {
      const int iy = iy0 + dy;
      if (iy < 0 || iy >= h) continue;
      for (int dx = 0; dx < kw; ++dx) {
        const int ix = ix0 + dx;
        if (ix < 0 || ix >= wd) continue;
        acc = fmaf(x[((nn * h + iy) * wd + ix) * c + c0 + cc],
                   wsm[(dy * kw + dx) * bc + cc], acc);
      }
    }
    y[((nn * ho + oy) * wo + ox) * c + c0 + cc] = acc;
  }
}

}  // namespace

extern "C" int dw_conv_f32(const float* x, const float* w, float* y, int n,
                           int h, int wd, int c, int ho, int wo, int kh,
                           int kw, int stride, int pad_t, int pad_l, int rows,
                           int bc, cudaStream_t stream) {
  if (rows < 1 || bc < 1 || c % bc) return static_cast<int>(cudaErrorInvalidValue);
  const int row_blocks = (ho + rows - 1) / rows;
  dim3 grid(static_cast<unsigned>(n) * row_blocks, c / bc);
  const size_t smem = static_cast<size_t>(kh) * kw * bc * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dw_kernel<<<grid, kThreads, smem, stream>>>(x, w, y, h, wd, c, ho, wo, kh, kw,
                                              stride, pad_t, pad_l, rows, bc);
  return static_cast<int>(cudaGetLastError());
}
