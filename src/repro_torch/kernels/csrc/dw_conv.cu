// Depthwise KPU — MobileNet's depthwise k x k convolution with channel
// multiplier 1 and SAME padding: y[n, oy, ox, c] = sum_{dy, dx}
// x[n, oy*s+dy-pt, ox*s+dx-pl, c] * w[dy, dx, c], x outside the frame
// reading as zero.  No reduction across channels.  f32 or bf16 operands,
// accumulated in f32, y in the operands' type.
//
// Replaces the Pallas TPU kernel kernels/dw_conv/dw_conv.py::dw_conv_p (body
// _dw_kernel), whose grid step (n, channel tile) streams a whole padded
// frame and so cannot keep to a memory budget.  Here one block owns
// (frame, run of `rows` output rows, planned channel tile bc).
//
// Bound on an H100 SXM at its 700 W limit (NVIDIA's data sheet): 9 MACs an
// output against one read of each input and one write of each output, far
// below the ridge, so HBM bytes at 3.35 TB/s bound it.  Over MobileNetV2's
// 17 depthwise layers at 224x224, batch 8, that is 0.058 ms at 4 bytes an
// element and 0.029 ms at 2.
//
// Design.  The block first stages the input rows its outputs read,
// (rows - 1) * stride + kh of them, each (wo - 1) * stride + kw pixels wide
// by bc channels, in shared memory once, with 16-byte cp.async copies; the
// SAME padding (asymmetric: (total / 2, total - total / 2)) is zero-filled
// in place by the index math (src-size 0), so no padded copy is made and no
// tap tests a bound.  Each thread then owns a run of kRun outputs along x
// for one vector of V channels (16 bytes: 4 f32 or 8 bf16), keeps their
// k x k weights in f32 registers, and for each tap row walks the staged
// input vectors under the run once, adding each to every output of the
// run that reads it: the window slides through registers, and a staged
// vector is read from shared memory about ((kRun - 1) * stride + k) / kRun
// times per tap row instead of k.  It accumulates in f32 and writes each
// output vector as one 16-byte store.  Neighbouring threads take
// neighbouring channel vectors of one pixel, so shared and global accesses
// are contiguous.  A channel tile that is not a whole number of 16-byte
// vectors (bc % V != 0: the low-rate plans' tiles of 1 or 3 channels) runs
// the same kernel with V = 1, staged and stored an element at a time.  One
// kernel, dw_kernel<T, V, stride>, takes the 3x3 taps of every CNN family
// at stride 1 and 2; any other kernel size or stride, and 16-byte tiles of
// operands that are not 16-byte aligned, are refused with an error (the
// Python wrapper raises before the launch).
//
// Left for later: overlapping one row block's staging with the previous
// one's arithmetic (a persistent block with a two-slot ring), TMA for the
// staging, and a tile rule sized for this block (core/tiles.py's
// DW_OUTPUTS cap leaves MobileNetV2's 7x7 rows few outputs a thread).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 4;    // outputs a thread owns along x
constexpr int kTaps = 3;   // the kernel's k x k taps
constexpr int kSmemMax = 232448;

// V channels as f32: one 16-byte vector (4 floats, 8 bf16) or one element.
template <typename T, int V>
struct Vec;

template <typename T>
struct Vec<T, 1> {
  __device__ static void load(const T* p, float (&v)[1]) { v[0] = rt::to_f32(*p); }
  __device__ static void store(T* p, const float (&v)[1]) { *p = rt::from_f32<T>(v[0]); }
};

template <>
struct Vec<float, 4> {
  __device__ static void load(const float* p, float (&v)[4]) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x;
    v[1] = u.y;
    v[2] = u.z;
    v[3] = u.w;
  }
  __device__ static void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  __device__ static void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = rt::bf16_lo(w[i]);
      v[2 * i + 1] = rt::bf16_hi(w[i]);
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float (&v)[8]) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(rt::bf16_pack(v[0], v[1]), rt::bf16_pack(v[2], v[3]),
                   rt::bf16_pack(v[4], v[5]), rt::bf16_pack(v[6], v[7]));
  }
};

// Channels in one 16-byte vector.
template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

// The block's place: frame, first output row, live output rows, first
// channel; and the staged rows' shape.
struct Place {
  long long nn;
  int oy0, rows, c0, rows_in, cols;
};

__device__ __forceinline__ Place place(int ho, int wo, int stride, int rows, int bc) {
  const int row_blocks = (ho + rows - 1) / rows;
  Place p;
  p.nn = blockIdx.x / row_blocks;
  p.oy0 = (blockIdx.x % row_blocks) * rows;
  p.rows = min(rows, ho - p.oy0);
  p.c0 = blockIdx.y * bc;
  p.rows_in = (p.rows - 1) * stride + kTaps;
  p.cols = (wo - 1) * stride + kTaps;
  return p;
}

// Stage input rows [oy0 * stride - pad_t, + rows_in) and columns
// [-pad_l, -pad_l + cols) of frame nn, channels [c0, c0 + bc), as
// [rows_in][cols][bc], zero outside the frame: 16-byte cp.async copies,
// or element copies where V = 1.
template <typename T, int V>
__device__ __forceinline__ void stage(T* tile, const T* __restrict__ x, const Place& p,
                                      int h, int wd, int c, int stride, int pad_t,
                                      int pad_l, int bc) {
  const int per_px = bc / V;
  const int total = p.rows_in * p.cols * per_px;
  const int iy0 = p.oy0 * stride - pad_t;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int v = e % per_px, px = e / per_px;
    const int iy = iy0 + px / p.cols, ix = px % p.cols - pad_l;
    const bool live = static_cast<unsigned>(iy) < static_cast<unsigned>(h) &&
                      static_cast<unsigned>(ix) < static_cast<unsigned>(wd);
    const T* src = live ? x + ((p.nn * h + iy) * wd + ix) * c + p.c0 + v * V : x;
    if constexpr (V == kVec<T>)
      rt::cp_async16(tile + static_cast<size_t>(e) * V, src, live ? 16 : 0);
    else
      tile[e] = live ? *src : rt::from_f32<T>(0.f);
  }
  if constexpr (V == kVec<T>) rt::cp_async_wait_all();
  __syncthreads();
}

// The 3x3 taps at stride S on V-channel vectors (see the file's note).
// Launched with lanes * (kThreads / lanes) threads, lanes = min(bc / V,
// kThreads), so a thread's channel vectors are fixed: v, v + lanes, ...
template <typename T, int V, int S>
__global__ void __launch_bounds__(kThreads)
    dw_kernel(const T* __restrict__ x, const T* __restrict__ w,
              T* __restrict__ y, int h, int wd, int c, int ho, int wo,
              int pad_t, int pad_l, int rows, int bc) {
  constexpr int K = kTaps, SPAN = (kRun - 1) * S + K;
  extern __shared__ __align__(16) uint8_t smem[];
  T* tile = reinterpret_cast<T*>(smem);
  const Place p = place(ho, wo, S, rows, bc);
  const int per_px = bc / V;
  const int lanes = min(per_px, kThreads);
  int v = threadIdx.x % lanes;

  // the first channel vector's weights, loaded while the rows stage
  float wr[K * K][V];
  auto load_weights = [&](int vec) {
#pragma unroll
    for (int t = 0; t < K * K; ++t)
      Vec<T, V>::load(w + static_cast<long long>(t) * c + p.c0 + vec * V, wr[t]);
  };
  load_weights(v);
  stage<T, V>(tile, x, p, h, wd, c, S, pad_t, pad_l, bc);

  const int runs = (wo + kRun - 1) / kRun;
  const int items = p.rows * runs;
  for (; v < per_px; v += lanes) {
    if (v >= lanes) load_weights(v);
    for (int it = threadIdx.x / lanes; it < items; it += blockDim.x / lanes) {
      const int oyl = it / runs, ox0 = (it % runs) * kRun;
      float acc[kRun][V];
#pragma unroll
      for (int j = 0; j < kRun; ++j)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[j][e] = 0.f;
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
        const T* row = tile + (static_cast<size_t>(oyl * S + dy) * p.cols) * bc + v * V;
        // staged column ox0 * S + i feeds output j through tap dx = i - j * S
#pragma unroll
        for (int i = 0; i < SPAN; ++i) {
          const int col = ox0 * S + i;
          if (col >= p.cols) break;  // only outputs past wo read it
          float xv[V];
          Vec<T, V>::load(row + static_cast<size_t>(col) * bc, xv);
#pragma unroll
          for (int j = 0; j < kRun; ++j) {
            const int dx = i - j * S;
            if (dx < 0 || dx >= K) continue;
#pragma unroll
            for (int e = 0; e < V; ++e)
              acc[j][e] = fmaf(xv[e], wr[dy * K + dx][e], acc[j][e]);
          }
        }
      }
      T* dst = y + ((p.nn * ho + p.oy0 + oyl) * wo + ox0) * c + p.c0 + v * V;
#pragma unroll
      for (int j = 0; j < kRun; ++j)
        if (ox0 + j < wo) Vec<T, V>::store(dst + static_cast<long long>(j) * c, acc[j]);
    }
  }
}

template <typename T, int V, int S>
int run(const T* x, const T* w, T* y, int n, int h, int wd, int c, int ho, int wo,
        int pad_t, int pad_l, int rows, int bc, size_t smem, cudaStream_t stream) {
  static bool opted[rt::kMaxDevices] = {};
  const int err = rt::opt_in_smem(dw_kernel<T, V, S>, kSmemMax, opted);
  if (err) return err;
  const int lanes = bc / V < kThreads ? bc / V : kThreads;
  const dim3 grid(static_cast<unsigned>(n) * ((ho + rows - 1) / rows), c / bc);
  dw_kernel<T, V, S><<<grid, lanes * (kThreads / lanes), smem, stream>>>(
      x, w, y, h, wd, c, ho, wo, pad_t, pad_l, rows, bc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int run_stride(const T* x, const T* w, T* y, int n, int h, int wd, int c, int ho,
               int wo, int stride, int pad_t, int pad_l, int rows, int bc, size_t smem,
               cudaStream_t stream) {
  return stride == 1
             ? run<T, V, 1>(x, w, y, n, h, wd, c, ho, wo, pad_t, pad_l, rows, bc, smem, stream)
             : run<T, V, 2>(x, w, y, n, h, wd, c, ho, wo, pad_t, pad_l, rows, bc, smem, stream);
}

template <typename T>
int launch(const T* x, const T* w, T* y, int n, int h, int wd, int c, int ho,
           int wo, int kh, int kw, int stride, int pad_t, int pad_l, int rows,
           int bc, cudaStream_t stream) {
  if (n < 1 || ho < 1 || wo < 1 || rows < 1 || bc < 1 || c % bc || kh != kTaps ||
      kw != kTaps || (stride != 1 && stride != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  rows = rows < ho ? rows : ho;
  const size_t smem = static_cast<size_t>((rows - 1) * stride + kh) *
                      ((wo - 1) * stride + kw) * bc * sizeof(T);
  if (smem > static_cast<size_t>(kSmemMax)) return static_cast<int>(cudaErrorInvalidValue);
  if (bc % kVec<T>)
    return run_stride<T, 1>(x, w, y, n, h, wd, c, ho, wo, stride, pad_t, pad_l, rows, bc,
                            smem, stream);
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(y)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  return run_stride<T, kVec<T>>(x, w, y, n, h, wd, c, ho, wo, stride, pad_t, pad_l, rows,
                                bc, smem, stream);
}

}  // namespace

// x [n, h, w, c] NHWC, w [kh, kw, c], y [n, ho, wo, c], contiguous, of one
// type; SAME pads (pad_t, pad_l) before the frame; `rows` output rows and
// `bc` channels a block.
extern "C" int dw_conv_f32(const float* x, const float* w, float* y, int n,
                           int h, int wd, int c, int ho, int wo, int kh,
                           int kw, int stride, int pad_t, int pad_l, int rows,
                           int bc, cudaStream_t stream) {
  return launch(x, w, y, n, h, wd, c, ho, wo, kh, kw, stride, pad_t, pad_l, rows,
                bc, stream);
}

extern "C" int dw_conv_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                            __nv_bfloat16* y, int n, int h, int wd, int c,
                            int ho, int wo, int kh, int kw, int stride,
                            int pad_t, int pad_l, int rows, int bc,
                            cudaStream_t stream) {
  return launch(x, w, y, n, h, wd, c, ho, wo, kh, kw, stride, pad_t, pad_l, rows,
                bc, stream);
}
