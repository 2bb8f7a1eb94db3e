// FCU — the paper's fully-connected unit: y[m, d_out] = x[m, d_in] @ w[d_in, d_out].
//
// Replaces the Pallas TPU kernel kernels/fcu_matmul/fcu_matmul.py::fcu_matmul_p
// (body _fcu_kernel): grid (m/bm, d_out/bn, d_in/bk) with k innermost and an
// f32 VMEM accumulator.  Here one block owns a (bm x bn) output tile of the
// plan and walks d_in in the planned bk steps itself (blocks run in no order
// on Hopper, so the sequential k grid axis becomes that loop), on the tensor
// cores: the shared mainloop of tile_mma.cuh, as the KPU's case of a 1x1
// kernel, stride 1 and no padding over one frame of m pixels.
//
// Bound on an H100 SXM at its 700 W limit (NVIDIA's data sheet): the larger
// of the product's bytes over 3.35 TB/s and its 2 m d_in d_out flops done
// three times (3xTF32) over 495 TFLOP/s TF32, i.e. 165 TFLOP/s of
// fp32-accurate work; on bf16 operands (half the bytes) the flops once over
// 989 TFLOP/s.  MobileNetV2's 1x1 layers do 16-480 flops a byte of
// x, w and y, so every one of them is bound by bytes; at the plan's tiles
// most launch few blocks, and latency and the per-launch cost set the time.
// The design puts the products on wgmma (the 3xTF32 split keeps the 1e-4
// gate, which one TF32 rounding misses), overlaps the copies with them
// through a ring of cp.async slots, packs up to 64 / bm pixel tiles into one
// 64-row atom where bm < 64 (the dense heads' bm = 1), and splits the bk
// steps over a thread-block cluster where the tiles leave SMs idle.  Left
// for later: TMA for the x tiles, persistent blocks that walk several
// column tiles, and a Hopper tile rule in the planner sized for this block
// (core/tiles.py still sizes bm for the CUDA-core block it replaced).
#include <cuda_runtime.h>

#include "tile_mma.cuh"

namespace {

template <typename T, int BN, int MA, int NC>
__global__ void __launch_bounds__(rt::kProducer * (NC + 1),
                                  rt::mma_min_blocks(BN, MA, NC))
    fcu_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ y, rt::MmaShape s, rt::MmaTile t) {
  rt::mma_tile<T, BN, MA, NC>(x, w, y, s, t);
}

template <typename T>
struct FcuLaunch {
  const T *x, *w;
  T* y;
  rt::MmaShape s;
  rt::MmaLaunch l;
  cudaStream_t stream;

  template <int BN, int MA, int NC>
  int run() {
    static bool opted[rt::kMaxDevices] = {};
    const int err = rt::opt_in_smem(fcu_kernel<T, BN, MA, NC>, rt::kSmemBlock, opted);
    if (err) return err;
    return rt::launch_cluster(fcu_kernel<T, BN, MA, NC>, l.grid, l.block, l.smem,
                              stream, l.split, x, w, y, s, l.t);
  }
};

template <typename T>
int fcu_launch(const T* x, const T* w, T* y, int m, int d_in, int d_out, int bm,
               int bk, int bn, int split, cudaStream_t stream) {
  const rt::MmaShape s{1, 1, m, d_in, 1, m, d_out, 1, 1, 1, 0, 0};
  FcuLaunch<T> f{x, w, y, s, {}, stream};
  const bool x_ok = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool w_ok = (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  if (m < 1 ||
      !rt::plan_tile(s, bm, bk, bn, split, {false, 0, 0}, x_ok, w_ok, sizeof(T), &f.l))
    return static_cast<int>(cudaErrorInvalidValue);
  return rt::dispatch(f.l, f);
}

}  // namespace

// x [m, d_in], w [d_in, d_out], y [m, d_out], contiguous, all f32 or all
// bf16; the plan's (bm, bk, bn) tile; `split` blocks a tile along a cluster
// (1: none, 0: as the rule gives, which the wrapper passes).
extern "C" int fcu_matmul_f32(const float* x, const float* w, float* y, int m,
                              int d_in, int d_out, int bm, int bk, int bn,
                              int split, cudaStream_t stream) {
  return fcu_launch(x, w, y, m, d_in, d_out, bm, bk, bn, split, stream);
}

extern "C" int fcu_matmul_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                               __nv_bfloat16* y, int m, int d_in, int d_out,
                               int bm, int bk, int bn, int split,
                               cudaStream_t stream) {
  return fcu_launch(x, w, y, m, d_in, d_out, bm, bk, bn, split, stream);
}
