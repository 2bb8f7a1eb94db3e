// KPU — the paper's kernel processing unit: a direct NHWC convolution with
// SAME padding, y[n, oy, ox, co] = sum_{dy, dx, ci} x[n, oy*s+dy-pt, ox*s+dx-pl, ci]
// * w[dy, dx, ci, co], x outside the frame reading as zero.
//
// Replaces the Pallas TPU kernel kernels/kpu_conv/kpu_conv.py::kpu_conv_p
// (body _kpu_kernel).  The TPU block holds a whole padded frame and, per
// (dy, dx) tap, multiplies a strided [Ho, Wo, bci] window by w[dy, dx].  A
// 224x224 frame does not fit one block's 227 KiB of shared memory, so this
// kernel is an implicit GEMM tiled over output pixels instead: M = N*Ho*Wo
// flattened pixels, one block per (bm pixels x bco output channels), on
// the tensor cores through the shared mainloop of tile_mma.cuh.  Its
// producer gathers, per planned input-channel step bci and tap, the
// strided window rows of the block's pixels with cp.async — only
// surviving windows are read (the paper's §II-E stride pruning), and the
// asymmetric SAME padding (ResNet conv1 at 224: (2, 3); MobileNetV2
// conv1: (0, 1)) is zero-fill in the index math, so no padded copy of the
// input is made.  d_in = 3 (conv1) is a bci = 3 step copied 4 bytes at a
// time (its 12-byte rows allow no wider copy, nor a TMA tensor map, whose
// strides must be multiples of 16 bytes); a row of its kw taps is one
// step of kw x 3 channels, zero-padded to k8 steps.  On bf16 operands a
// pixel is 6 bytes, which no cp.async width divides, so conv1's rows are
// copied 2 bytes at a time through registers (8 loads in flight a thread)
// and the folded step is zero-padded to k16 steps in shared memory.
//
// Bound on an H100 SXM at its 700 W limit (NVIDIA's data sheet):
// ResNet-18's 3x3 convs do 576-4608 MACs a pixel, far above the ridge, so
// the bound is their flops done three times (3xTF32) over 495 TFLOP/s TF32,
// i.e. 165 TFLOP/s of fp32-accurate work; on bf16 operands the flops once
// over 989 TFLOP/s.  The design puts the products on
// wgmma with the 3xTF32 split (the 1e-4 gate forbids one TF32 rounding),
// overlaps the gathers with them through a ring of cp.async slots, folds a
// row of conv1's 3-channel taps into one step, and splits the (bci step,
// tap) steps over a thread-block cluster where the tiles leave SMs idle.
// The plan's narrow tiles (bco = 32 of up to 512 channels) would make
// every block gather its windows again for each tap and each column tile,
// and issue wgmma m64n32k8, the narrowest useful product; so an f32 block
// runs a group of the plan's tiles (tile_mma.cuh, `MmaGroup`): the widest
// run of adjacent column tiles its accumulators allow (64 channels beside
// 256 pixel rows, 128 beside 128, 256 beside 64) and, where bm <= 64, two
// atoms' worth of pixel tiles, so that one gathered window feeds 64-256
// output channels; at small batches, where a wider block's cluster split
// would leave it fewer than 3 steps, the group stays narrower.  Each tile
// keeps its own contraction in the same order, so the group changes no
// output bit.  A bf16 block keeps the FCU's group (it ran up to 8 % slower
// grouped at batch 8).  Timed with parts of it taken out on an H100, the
// grouped f32 block spent more on the producer's gathers and on the
// consumers' split of w than on the products; so the f32 mainloop (the
// FCU's too) reads four rows' window origins ahead of their copies, splits
// w with 16-byte stores, and gives a slot back once its x values are in
// registers.  Left for later: conv1's 3-channel rows (4-byte copies, now
// the slowest KPU call a frame), staging one halo window per channel slab
// and reusing it across the kh*kw taps, TMA im2col, persistent blocks, and
// a Hopper tile rule in the planner sized for this block.
#include <cuda_runtime.h>

#include "tile_mma.cuh"

namespace {

template <typename T, int BN, int MA, int NC>
__global__ void __launch_bounds__(rt::kProducer * (NC + 1),
                                  rt::mma_min_blocks(BN, MA, NC))
    kpu_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ y, rt::MmaShape s, rt::MmaTile t) {
  rt::mma_tile<T, BN, MA, NC>(x, w, y, s, t);
}

template <typename T>
struct KpuLaunch {
  const T *x, *w;
  T* y;
  rt::MmaShape s;
  rt::MmaLaunch l;
  cudaStream_t stream;

  template <int BN, int MA, int NC>
  int run() {
    static bool opted[rt::kMaxDevices] = {};
    const int err = rt::opt_in_smem(kpu_kernel<T, BN, MA, NC>, rt::kSmemBlock, opted);
    if (err) return err;
    return rt::launch_cluster(kpu_kernel<T, BN, MA, NC>, l.grid, l.block, l.smem,
                              stream, l.split, x, w, y, s, l.t);
  }
};

template <typename T>
int kpu_launch(const T* x, const T* w, T* y, int n, int h, int wd, int d_in,
               int ho, int wo, int d_out, int kh, int kw, int stride, int pad_t,
               int pad_l, int bm, int bci, int bco, int split, int group_rows,
               int group_cols, int* group, cudaStream_t stream) {
  const rt::MmaShape s{n, h, wd, d_in, ho, wo, d_out, kh, kw, stride, pad_t,
                       pad_l};
  KpuLaunch<T> f{x, w, y, s, {}, stream};
  const bool x_ok = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool w_ok = (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  if (n < 1 || ho < 1 || wo < 1 ||
      !rt::plan_tile(s, bm, bci, bco, split, {sizeof(T) == 4, group_rows, group_cols},
                     x_ok, w_ok, sizeof(T), &f.l))
    return static_cast<int>(cudaErrorInvalidValue);
  group[0] = f.l.rows;
  group[1] = f.l.cols;
  return rt::dispatch(f.l, f);
}

}  // namespace

// x [n, h, w, d_in] NHWC, w [kh, kw, d_in, d_out] HWIO, y [n, ho, wo, d_out],
// contiguous, all f32 or all bf16; SAME pads (pad_t, pad_l) before the
// frame; the plan's (bm, bci, bco) tile; `split` blocks a tile along a
// cluster (1: none, 0: as the rule gives, which the wrapper passes);
// `group_rows`, `group_cols`: the plan's pixel and column tiles a block
// runs (0: as the rule gives); `group` receives the two the launch took.
extern "C" int kpu_conv_f32(const float* x, const float* w, float* y, int n,
                            int h, int wd, int d_in, int ho, int wo, int d_out,
                            int kh, int kw, int stride, int pad_t, int pad_l,
                            int bm, int bci, int bco, int split, int group_rows,
                            int group_cols, int* group, cudaStream_t stream) {
  return kpu_launch(x, w, y, n, h, wd, d_in, ho, wo, d_out, kh, kw, stride, pad_t,
                    pad_l, bm, bci, bco, split, group_rows, group_cols, group, stream);
}

extern "C" int kpu_conv_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                             __nv_bfloat16* y, int n, int h, int wd, int d_in,
                             int ho, int wo, int d_out, int kh, int kw,
                             int stride, int pad_t, int pad_l, int bm, int bci,
                             int bco, int split, int group_rows, int group_cols,
                             int* group, cudaStream_t stream) {
  return kpu_launch(x, w, y, n, h, wd, d_in, ho, wo, d_out, kh, kw, stride, pad_t,
                    pad_l, bm, bci, bco, split, group_rows, group_cols, group, stream);
}

// The plan the rule gives the (bm, bk, bn) tile of a KPU call (`kpu` 1) or
// an FCU call (`kpu` 0) on the current device for `elem`-byte elements (4:
// f32, 2: bf16): 1, with `plan` = {blocks a tile along a cluster (1 for
// none), the plan's pixel tiles a block, its column tiles a block}; 0 if
// the kernels do not take the tile.  The FCU over m pixels is the case
// n = h = ho = 1, w = wo = m of a 1x1 kernel.
extern "C" int mma_plan(int n, int h, int wd, int d_in, int ho, int wo, int d_out,
                        int kh, int kw, int bm, int bk, int bn, int elem, int kpu,
                        int* plan) {
  const rt::MmaShape s{n, h, wd, d_in, ho, wo, d_out, kh, kw, 1, 0, 0};
  rt::MmaLaunch l;
  if (!rt::plan_tile(s, bm, bk, bn, 0, {kpu != 0 && elem == 4, 0, 0}, true, true, elem, &l))
    return 0;
  plan[0] = l.split;
  plan[1] = l.rows;
  plan[2] = l.cols;
  return 1;
}
