// Mamba-2 SSD chunked scan: for each (batch, head) and each chunk of Q
// tokens, with a_cum = cumsum(dt * a) over the chunk and xd = dt * x,
//   y_i  = sum_{j<=i} exp(a_cum_i - a_cum_j) (C_i . B_j) xd_j
//          + exp(a_cum_i) C_i . S                      (the carried state)
//   S   <- exp(a_cum_end) S + sum_j exp(a_cum_end - a_cum_j) xd_j B_j^T
// and the final S.  x [B, L, H, P], dt [B, L, H], a [H], B and C
// [B, L, G, N] (head h reads group h / (H/G)), y like x, S [B, H, P, N];
// all f32, L a multiple of Q.
//
// Replaces the Pallas TPU kernel kernels/ssd_chunk/ssd_chunk.py::ssd_chunk_p
// (body _ssd_kernel): grid (batch, head blocks, chunks) with the chunks
// innermost and the state carried across them in a VMEM scratch, and B/C
// repeated to H heads by its adapter (ops.py).  Blocks carry nothing
// across each other on Hopper, so here one block owns a (batch, head,
// slice of PS head-dim columns) and walks the chunks itself, with its
// [PS, N] slice of the state in registers.  The columns of y and S that a
// slice owns need only its columns of x and S, so the slices are exact;
// each recomputes the chunk's C.B^T scores, the price of 2x to 4x more
// blocks for the 132 SMs (48 heads for mamba2, 64 for zamba2).  B and C
// are read at group width: no repeat.  The arithmetic is the Pallas body's
// in f32: exp of differences of a_cum only (a_cum reaches hundreds below
// zero, so exp(a_cum_i) / exp(a_cum_j) would be 0/0), and masked scores
// are selected to 0 before any product.  Padded tokens carry dt = 0 and
// leave the state as it was.
//
// Per chunk the block stages B [Q][N], dt*x [Q][PS] and a_cum [Q] (one
// warp's shuffle scan), then walks the output rows in tiles of 64: it
// stages the tile's C, forms its masked scores [64][<=Q] and the tile's y
// from them, dt*x and the state; then it updates the state.  256 threads
// as 16 x 16: in every product a thread holds a register tile whose rows
// step by 16 (ty) and columns by 16 (tx), so each pair of floats it reads
// from shared memory feeds several FMAs (4 x 8 in the scores).
//
// Bound on an H100: at mamba2's shapes (Q 128, N 128, P 64, one group) a
// chunk takes about 2.1 MFLOP of C.B^T scores per group (they depend on
// the group only) and 5.3 MFLOP per head for the diagonal output and the
// state's two products: about 4.07 GFLOP for a 2048-token prefill's 48
// heads, against about 54 MB of operands, far above the ridge.  So the
// scan is bound by operations, about 0.061 ms at 67 TFLOP/s f32.  This
// simple design forms the scores again in every block (once per head and
// head-dim slice), and runs on the CUDA cores with one block per SM (up to 199 KB of shared memory).  Left for a
// later change: the three products on tensor cores (3xTF32 to keep f32
// accuracy, or wgmma), B/C/x staged by TMA into a ring that overlaps the
// next chunk's loads, and the scores shared between slices of a head
// through a thread-block cluster.
#include <cuda_runtime.h>

#include "tile_gemm.cuh"

namespace {

constexpr int kT = 16;            // 16 x 16 threads
constexpr int kRows = 64;         // rows of a score tile: 4 a thread
constexpr int kRC = kRows / kT;
constexpr int kMaxQ = 128;        // score columns: at most 8 a thread
constexpr int kMaxN = 128;        // state columns: at most 8 a thread

// Scores of one row tile: acc[r][c] = C[ty + 16 r] . B[tx + 16 c] over n,
// for the first JC column groups (JC * 16 >= the tile's last row + 1).
template <int JC>
__device__ __forceinline__ void tile_scores(const float* __restrict__ cs,
                                            const float* __restrict__ bs,
                                            int ldn, int n_dim, int tx, int ty,
                                            float (&acc)[kRC][kMaxQ / kT]) {
#pragma unroll
  for (int r = 0; r < kRC; ++r)
#pragma unroll
    for (int c = 0; c < kMaxQ / kT; ++c) acc[r][c] = 0.f;
  for (int n = 0; n < n_dim; ++n) {
    float av[kRC], bv[JC];
#pragma unroll
    for (int r = 0; r < kRC; ++r) av[r] = cs[(ty + kT * r) * ldn + n];
#pragma unroll
    for (int c = 0; c < JC; ++c) bv[c] = bs[(tx + kT * c) * ldn + n];
#pragma unroll
    for (int r = 0; r < kRC; ++r)
#pragma unroll
      for (int c = 0; c < JC; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

template <int PS, int NC>
__global__ void __launch_bounds__(kT* kT)
    ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const float* __restrict__ bmat,
               const float* __restrict__ cmat, float* __restrict__ y,
               float* __restrict__ state, int L, int H, int G, int P, int N,
               int Q) {
  constexpr int PC = PS / kT;  // head-dim columns (rows of S) a thread holds
  extern __shared__ float smem[];
  const int ldn = N + 1, ldq = Q + 1;  // skewed rows: column reads hit 16 banks
  float* bs = smem;               // [Q][ldn]      B of the chunk
  float* cs = bs + Q * ldn;       // [kRows][ldn]  C of the row tile
  float* ms = cs + kRows * ldn;   // [kRows][ldq]  masked scores of the tile
  float* xs = ms + kRows * ldq;   // [Q][PS]       dt * x, the block's columns
  float* ss = xs + Q * PS;        // [PS][ldn]     the state entering the chunk
  float* acum = ss + PS * ldn;    // [Q]           cumsum(dt * a)
  float* wend = acum + Q;         // [Q]           exp(acum[Q-1] - acum[j])

  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kT + tx;
  constexpr int nthr = kT * kT;
  const int bb = blockIdx.x / H, h = blockIdx.x % H, g = h / (H / G);
  const int p0 = blockIdx.y * PS;
  const float ah = a[h];

  // State rows p0 + ty + 16 r, columns tx + 16 c.
  float s[PC][NC];
#pragma unroll
  for (int r = 0; r < PC; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) s[r][c] = 0.f;
  for (int i = tid; i < PS * ldn; i += nthr) ss[i] = 0.f;

  for (int l0 = 0; l0 < L; l0 += Q) {
    __syncthreads();  // the last chunk's B, dt*x and state are read / written
    const long long row0 = static_cast<long long>(bb) * L + l0;
    for (int i = tid; i < Q * N; i += nthr) {
      const int j = i / N, n = i % N;
      bs[j * ldn + n] = bmat[((row0 + j) * G + g) * N + n];
    }
    for (int i = tid; i < Q * PS; i += nthr) {
      const int j = i / PS, p = p0 + i % PS;
      const long long r = row0 + j;
      xs[i] = p < P ? x[(r * H + h) * P + p] * dt[r * H + h] : 0.f;
    }
    if (tid < 32) {  // a_cum: each lane sums <= 4 consecutive steps, then a
                     // shuffle scan over the lanes
      const int per = (Q + 31) / 32;
      float v[kMaxQ / 32], run = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxQ / 32; ++k) {
        const int j = tid * per + k;
        v[k] = k < per && j < Q ? dt[(row0 + j) * H + h] * ah : 0.f;
        run += v[k];
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += t;
      }
      float sum = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) sum = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxQ / 32; ++k) {
        const int j = tid * per + k;
        if (k < per && j < Q) {
          sum += v[k];
          acum[j] = sum;
        }
      }
    }
    __syncthreads();
    for (int j = tid; j < Q; j += nthr) wend[j] = expf(acum[Q - 1] - acum[j]);

    for (int i0 = 0; i0 < Q; i0 += kRows) {
      const int rows = min(kRows, Q - i0), jmax = i0 + rows;
      const int jc = (jmax + kT - 1) / kT;
      __syncthreads();  // the last tile's C and scores are read
      for (int i = tid; i < rows * N; i += nthr) {
        const int r = i / N, n = i % N;
        cs[r * ldn + n] = cmat[((row0 + i0 + r) * G + g) * N + n];
      }
      __syncthreads();
      // Rows past the tile and columns past its last row compute on stale
      // shared memory; they are never stored.
      float acc[kRC][kMaxQ / kT];
      if (jc <= 1)
        tile_scores<1>(cs, bs, ldn, N, tx, ty, acc);
      else if (jc <= 2)
        tile_scores<2>(cs, bs, ldn, N, tx, ty, acc);
      else if (jc <= 4)
        tile_scores<4>(cs, bs, ldn, N, tx, ty, acc);
      else
        tile_scores<8>(cs, bs, ldn, N, tx, ty, acc);
#pragma unroll
      for (int r = 0; r < kRC; ++r) {
        const int il = ty + kT * r, i = i0 + il;
        if (il >= rows) continue;
#pragma unroll
        for (int c = 0; c < kMaxQ / kT; ++c) {
          const int j = tx + kT * c;
          if (j < jmax)
            ms[il * ldq + j] = j <= i ? acc[r][c] * expf(acum[i] - acum[j]) : 0.f;
        }
      }
      __syncthreads();

      // y rows i0 + ty + 16 r, columns p0 + tx + 16 c: masked scores times
      // dt*x, plus exp(a_cum) C . S of the state entering the chunk.
      float yd[kRC][PC], yo[kRC][PC];
#pragma unroll
      for (int r = 0; r < kRC; ++r)
#pragma unroll
        for (int c = 0; c < PC; ++c) yd[r][c] = yo[r][c] = 0.f;
      for (int j = 0; j < jmax; ++j) {
        float av[kRC], bv[PC];
#pragma unroll
        for (int r = 0; r < kRC; ++r) av[r] = ms[(ty + kT * r) * ldq + j];
#pragma unroll
        for (int c = 0; c < PC; ++c) bv[c] = xs[j * PS + tx + kT * c];
#pragma unroll
        for (int r = 0; r < kRC; ++r)
#pragma unroll
          for (int c = 0; c < PC; ++c) yd[r][c] = fmaf(av[r], bv[c], yd[r][c]);
      }
      for (int n = 0; n < N; ++n) {
        float av[kRC], bv[PC];
#pragma unroll
        for (int r = 0; r < kRC; ++r) av[r] = cs[(ty + kT * r) * ldn + n];
#pragma unroll
        for (int c = 0; c < PC; ++c) bv[c] = ss[(tx + kT * c) * ldn + n];
#pragma unroll
        for (int r = 0; r < kRC; ++r)
#pragma unroll
          for (int c = 0; c < PC; ++c) yo[r][c] = fmaf(av[r], bv[c], yo[r][c]);
      }
#pragma unroll
      for (int r = 0; r < kRC; ++r) {
        const int il = ty + kT * r;
        if (il >= rows) continue;
        const long long row = row0 + i0 + il;
        const float e = expf(acum[i0 + il]);
#pragma unroll
        for (int c = 0; c < PC; ++c) {
          const int p = p0 + tx + kT * c;
          if (p < P) y[(row * H + h) * P + p] = yd[r][c] + e * yo[r][c];
        }
      }
    }

    __syncthreads();  // every tile has read the state entering the chunk
    const float e_end = expf(acum[Q - 1]);
#pragma unroll
    for (int r = 0; r < PC; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) s[r][c] *= e_end;
    for (int j = 0; j < Q; ++j) {
      const float w = wend[j];
      float av[PC], bv[NC];
#pragma unroll
      for (int r = 0; r < PC; ++r) av[r] = xs[j * PS + ty + kT * r] * w;
#pragma unroll
      for (int c = 0; c < NC; ++c) bv[c] = bs[j * ldn + tx + kT * c];
#pragma unroll
      for (int r = 0; r < PC; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) s[r][c] = fmaf(av[r], bv[c], s[r][c]);
    }
#pragma unroll
    for (int r = 0; r < PC; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int n = tx + kT * c;
        if (n < N) ss[(ty + kT * r) * ldn + n] = s[r][c];
      }
  }

#pragma unroll
  for (int r = 0; r < PC; ++r) {
    const int p = p0 + ty + kT * r;
    if (p >= P) continue;
    float* dst = state + ((static_cast<long long>(bb) * H + h) * P + p) * N;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int n = tx + kT * c;
      if (n < N) dst[n] = s[r][c];
    }
  }
}

template <int PS, int NC>
int launch_pn(const float* x, const float* dt, const float* a, const float* b,
              const float* c, float* y, float* state, int batch, int L, int H,
              int G, int P, int N, int Q, cudaStream_t stream) {
  const size_t ldn = N + 1, ldq = Q + 1;
  const size_t smem =
      sizeof(float) * (Q * ldn + kRows * ldn + kRows * ldq + Q * PS +
                       PS * ldn + 2 * static_cast<size_t>(Q));
  dim3 grid(static_cast<unsigned>(batch) * H, (P + PS - 1) / PS);
  return rt::launch(ssd_kernel<PS, NC>, grid, dim3(kT, kT), smem, stream, x,
                    dt, a, b, c, y, state, L, H, G, P, N, Q);
}

template <int PS>
int launch_p(const float* x, const float* dt, const float* a, const float* b,
             const float* c, float* y, float* state, int batch, int L, int H,
             int G, int P, int N, int Q, cudaStream_t stream) {
  const int nc = (N + kT - 1) / kT;
  if (nc <= 1)
    return launch_pn<PS, 1>(x, dt, a, b, c, y, state, batch, L, H, G, P, N, Q,
                            stream);
  if (nc <= 2)
    return launch_pn<PS, 2>(x, dt, a, b, c, y, state, batch, L, H, G, P, N, Q,
                            stream);
  if (nc <= 4)
    return launch_pn<PS, 4>(x, dt, a, b, c, y, state, batch, L, H, G, P, N, Q,
                            stream);
  return launch_pn<PS, 8>(x, dt, a, b, c, y, state, batch, L, H, G, P, N, Q,
                          stream);
}

}  // namespace

// x [batch, L, H, P]; dt [batch, L, H]; a [H]; b, c [batch, L, G, N];
// y like x; state [batch, H, P, N]; chunk Q; p_block in {16, 32, 64}.
extern "C" int ssd_chunk_f32(const float* x, const float* dt, const float* a,
                             const float* b, const float* c, float* y,
                             float* state, int batch, int L, int H, int G,
                             int P, int N, int Q, int p_block,
                             cudaStream_t stream) {
  if (batch < 1 || L < 1 || H < 1 || G < 1 || H % G || P < 1 || N < 1 ||
      N > kMaxN || Q < 1 || Q > kMaxQ || L % Q)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (p_block) {
    case 16:
      return launch_p<16>(x, dt, a, b, c, y, state, batch, L, H, G, P, N, Q,
                          stream);
    case 32:
      return launch_p<32>(x, dt, a, b, c, y, state, batch, L, H, G, P, N, Q,
                          stream);
    case 64:
      return launch_p<64>(x, dt, a, b, c, y, state, batch, L, H, G, P, N, Q,
                          stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
