// Blockwise attention o = softmax(q k^T / sqrt(d), causal mask) v with an
// online-softmax state, for grouped-query heads and any sequence length,
// in f32 on the CUDA cores.  The bf16 route is flash_attention_sm90.cu
// (wgmma); f32 stays here because wgmma takes no f32 operand, and TF32
// (its 10-bit mantissa) would break the f32 route's 1e-4 gate.
//
// Replaces the Pallas TPU kernel kernels/attention/flash_attention.py::
// flash_attention_p (body _flash_kernel): grid (batch*heads, q blocks,
// k blocks) with k innermost, the running (m, l, acc) state in VMEM scratch
// carried across the k grid axis.  Blocks carry nothing across each other
// on Hopper, so here one block owns a (head, query tile) pair and walks the
// key/value tiles itself, staging each through shared memory; the state
// stays in registers.  The arithmetic is the Pallas body's: scores
// q.k * scale in f32, masked to -1e30, m/l/acc in f32, l clamped at 1e-30.
//
// Differences of contract, none of which changes a result:
//   * GQA: k/v hold heads/group heads; query head h reads kv head h/group
//     (the JAX package's [B, Hkv, G] head order).  group = 1 is the Pallas
//     kernel's contract.
//   * Ragged lengths: query rows >= sq are not written, key columns >= sk
//     are masked (and their staged k/v are zero, so 0 * v stays 0).  The
//     Pallas kernel asserts that blocks divide the lengths.
//   * Causal skipping: key tiles wholly above the diagonal of the query
//     tile are not visited.  The Pallas kernel computes and masks them,
//     but there every score is -1e30, so p = exp(-1e30 - m) = 0 and
//     alpha = exp(m - m) = 1: the state comes out bit-identical.
//
// Design: 256 threads as a 16 x 16 grid, each holding a <=4 x 4 tile of
// scores (rows ty + 16i, columns tx + 16j) and the matching <=4 x d/16
// tile of the output, so each pair of staged floats it reads from shared
// memory feeds four FMAs; row max and sum go through warp shuffles over
// the 16 threads of a row.  Query tiles run heaviest first (the last tiles
// see the most keys).  It is off the timed path: the f32 checks run it.
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kTX = 16, kTY = 16;  // threads along keys / head dim, and rows
constexpr int kMaxR = 4;           // rows (columns) of a thread's score tile

// Reductions over the 16 threads of one score row: lanes tx = 0..15 of a
// half warp (threadIdx.y fixes the half).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = kTX / 2; off > 0; off /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = kTX / 2; off > 0; off /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kTX* kTY)
    flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int heads,
                 int group, int sq, int sk, int bq, int bk, int causal,
                 float scale) {
  constexpr int NC = D / kTX;  // output columns a thread holds
  constexpr int LD = D + 1;    // skewed rows: column reads hit 16 banks
  extern __shared__ float smem[];
  const int ldp = bk + 1;
  float* qs = smem;          // [bq][LD]
  float* ks = qs + bq * LD;  // [bk][LD]
  float* vs = ks + bk * LD;  // [bk][D]
  float* ps = vs + bk * D;   // [bq][ldp]

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTX + tx, nthr = kTX * kTY;
  const int rq = bq / kTY, rk = bk / kTX;
  const long long bh = blockIdx.x;  // b * heads + h
  const long long kvh = (bh / heads) * (heads / group) + (bh % heads) / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * bq;
  const float* qg = q + bh * sq * D;
  const float* kg = k + kvh * sk * D;
  const float* vg = v + kvh * sk * D;

  for (int i = tid; i < bq * D; i += nthr) {
    const int r = i / D, c = i % D;
    qs[r * LD + c] =
        q0 + r < sq ? qg[static_cast<long long>(q0 + r) * D + c] : 0.f;
  }

  float m[kMaxR], l[kMaxR], acc[kMaxR][NC];
#pragma unroll
  for (int i = 0; i < kMaxR; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int k_end = causal ? min(sk, q0 + bq) : sk;
  for (int k0 = 0; k0 < k_end; k0 += bk) {
    __syncthreads();  // the last tile's k, v and p are read
    for (int i = tid; i < bk * D; i += nthr) {
      const int r = i / D, c = i % D;
      const bool live = k0 + r < sk;
      const long long off = static_cast<long long>(k0 + r) * D + c;
      ks[r * LD + c] = live ? kg[off] : 0.f;
      vs[r * D + c] = live ? vg[off] : 0.f;
    }
    __syncthreads();

    float s[kMaxR][kMaxR];
#pragma unroll
    for (int i = 0; i < kMaxR; ++i)
#pragma unroll
      for (int j = 0; j < kMaxR; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[kMaxR], b[kMaxR];
#pragma unroll
      for (int i = 0; i < kMaxR; ++i)
        a[i] = i < rq ? qs[(ty + kTY * i) * LD + d] : 0.f;
#pragma unroll
      for (int j = 0; j < kMaxR; ++j)
        b[j] = j < rk ? ks[(tx + kTX * j) * LD + d] : 0.f;
#pragma unroll
      for (int i = 0; i < kMaxR; ++i)
#pragma unroll
        for (int j = 0; j < kMaxR; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kMaxR; ++i) {
      if (i >= rq) break;  // uniform over the block
      const int r = ty + kTY * i, row = q0 + r;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < kMaxR; ++j) {
        if (j >= rk) break;
        const int col = k0 + tx + kTX * j;
        float x = s[i][j] * scale;
        if (col >= sk || (causal && col > row)) x = kNeg;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxR; ++j) {
        if (j >= rk) break;
        const float p = expf(s[i][j] - m_new);
        ps[r * ldp + tx + kTX * j] = p;
        sum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int kk = 0; kk < bk; ++kk) {
      float b[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) b[c] = vs[kk * D + tx + kTX * c];
#pragma unroll
      for (int i = 0; i < kMaxR; ++i) {
        if (i >= rq) break;
        const float p = ps[(ty + kTY * i) * ldp + kk];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p, b[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kMaxR; ++i) {
    if (i >= rq) break;
    const int row = q0 + ty + kTY * i;
    if (row >= sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    float* dst = o + (bh * sq + row) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) dst[tx + kTX * c] = acc[i][c] / lc;
  }
}

template <int D>
int launch_d(const float* q, const float* k, const float* v, float* o,
             int batch, int heads, int group, int sq, int sk, int bq, int bk,
             int causal, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(bq + bk) * (D + 1) +
                       static_cast<size_t>(bk) * D +
                       static_cast<size_t>(bq) * (bk + 1));
  dim3 grid(static_cast<unsigned>(batch) * heads, (sq + bq - 1) / bq);
  return rt::launch(flash_kernel<D>, grid, dim3(kTX, kTY), smem, stream, q,
                    k, v, o, heads, group, sq, sk, bq, bk, causal, scale);
}

int launch(const float* q, const float* k, const float* v, float* o,
           int batch, int heads, int group, int sq, int sk, int d, int bq,
           int bk, int causal, float scale, cudaStream_t stream) {
  const bool tile_ok = bq % kTY == 0 && bk % kTX == 0 && bq >= kTY &&
                       bk >= kTX && bq <= kTY * kMaxR && bk <= kTX * kMaxR;
  if (!tile_ok || batch < 1 || group < 1 || heads % group || sq < 1 ||
      sk < 1 || (sq + bq - 1) / bq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 16:
      return launch_d<16>(q, k, v, o, batch, heads, group, sq, sk, bq, bk,
                          causal, scale, stream);
    case 32:
      return launch_d<32>(q, k, v, o, batch, heads, group, sq, sk, bq, bk,
                          causal, scale, stream);
    case 64:
      return launch_d<64>(q, k, v, o, batch, heads, group, sq, sk, bq, bk,
                          causal, scale, stream);
    case 128:
      return launch_d<128>(q, k, v, o, batch, heads, group, sq, sk, bq, bk,
                           causal, scale, stream);
    case 256:
      return launch_d<256>(q, k, v, o, batch, heads, group, sq, sk, bq, bk,
                           causal, scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q [batch, heads, sq, d]; k, v [batch, heads/group, sk, d]; o like q.
extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* o, int batch,
                                   int heads, int group, int sq, int sk, int d,
                                   int bq, int bk, int causal, float scale,
                                   cudaStream_t stream) {
  return launch(q, k, v, o, batch, heads, group, sq, sk, d, bq, bk, causal,
                scale, stream);
}
