// Mamba-2 SSD chunked scan: for each (batch, head) and each chunk of Q
// tokens, with a_cum = cumsum(dt * a) over the chunk and xd = dt * x,
//   y_i  = sum_{j<=i} exp(a_cum_i - a_cum_j) (C_i . B_j) xd_j
//          + exp(a_cum_i) C_i . S                      (the carried state)
//   S   <- exp(a_cum_end) S + sum_j exp(a_cum_end - a_cum_j) xd_j B_j^T
// and the final S.  x [B, L, H, P], dt [B, L, H], a [H] (f32), B and C
// [B, L, G, N] (head h reads group h / (H/G)), y like x, S [B, H, P, N]
// f32; x, dt, B, C and y all f32 or all bf16, computed in f32; L a
// multiple of Q.
//
// Replaces the Pallas TPU kernel kernels/ssd_chunk/ssd_chunk.py::ssd_chunk_p
// (body _ssd_kernel): grid (batch, head blocks, chunks) with the chunks
// innermost and the state carried across them in a VMEM scratch, and B/C
// repeated to H heads by its adapter (ops.py).  Blocks carry nothing across
// each other on Hopper, and a walk over the chunks in order leaves the card
// idle (16 dependent steps at 2048 tokens, a wave or two of blocks), so the
// scan follows the block decomposition of the SSD paper (Mamba-2,
// arXiv:2405.21060) instead, three kernels on one stream:
//
//   ssd_states  every (batch, chunk, run of heads of one group) at once:
//               the state each chunk adds, dS = sum_j exp(a_cum_end -
//               a_cum_j) xd_j^T B_j [P x N], into an f32 workspace
//               [B, nc, H, P, N], and each chunk's a_cum_end;
//   ssd_pass    the short recurrence, elementwise for each (batch, head):
//               S_c = exp(a_cum_end,c) S_{c-1} + dS_c, leaving in the
//               workspace the state entering each chunk; the final state;
//   ssd_output  every (batch, chunk, run of heads of one group) at once:
//               the chunk's C.B^T scores once, into shared memory, then for
//               each head (L o scores) xd + exp(a_cum) o (C S_{c-1}^T).
//
// Both served models have one group, so the scores, which depend on the
// group only, are formed once a block for its run of heads (6 of
// mamba2's 48 heads, 8 of zamba2's 64 at 2048 tokens: ssd_head_run in
// kernels/ssd_chunk.py), not once a head as before.  All products run on
// the tensor cores as mma.sync m16n8k8 tf32 from shared memory, in 3xTF32:
// each operand v split into hi = rna_tf32(v) and lo = rna_tf32(v - hi),
// a product as lo*hi + hi*lo + hi*hi into one f32 accumulator (one TF32
// rounding misses the 2e-4 gate: tests/test_torch_split_tf32.py).  A warp
// owns 32 x 32 output tiles; operands are staged with row pitches that
// put the fragment loads of a warp on 32 distinct banks.  Tiles of the
// scores above the diagonal are not formed, and the diagonal output walks
// only the keys up to its tile's last row.  The arithmetic is the Pallas
// body's in f32: a_cum from the same warp scan in both chunk kernels;
// exp of differences of a_cum only (a_cum reaches hundreds below zero, so
// exp(a_cum_i) / exp(a_cum_j) would be 0/0); masked scores are 0 before
// any product.  Padded tokens carry dt = 0 and leave the state as it was.
// bf16 inputs are converted to f32 as they are staged, and y is rounded
// to bf16 as it is written.
//
// Bound on an H100 SXM at its 700 W limit (NVIDIA's data sheet): at
// mamba2's shapes (Q 128, N 128, P 64, one group) a chunk takes about 2.1
// MFLOP of C.B^T scores per group and 5.3 MFLOP per head for the diagonal
// output and the state's two products: about 4.07 GFLOP for a 2048-token
// prefill's 48 heads, done three times in TF32 at 495 TFLOP/s (0.025 ms),
// against about 54 MB that the function reads and writes once (x, dt, B,
// C, y and the state: 0.016 ms), so operations bound it.  The workspace,
// about 50 MB written and read once, is this design's traffic, not the
// function's: the bound leaves it out (with it, 0.031 ms).  Left for later: TMA staging of B, C and x in a ring
// that overlaps the next head's loads with this one's products, wgmma in
// place of mma.sync, and the state pass fused into the output kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQ = 128;
constexpr int kMaxN = 128;
constexpr int kPB = 64;        // head-dim columns a block stages at once
constexpr int kSmemMax = 232448;

__host__ __device__ constexpr int pad32(int v) { return (v + 31) / 32 * 32; }
__host__ __device__ constexpr int pad8(int v) { return (v + 7) / 8 * 8; }
__host__ __device__ constexpr int max_of(int a, int b) { return a > b ? a : b; }

// D += A B, mma.sync m16n8k8 tf32: a0 (row g, k t), a1 (row g + 8, k t),
// a2 (row g, k t + 4), a3 (row g + 8, k t + 4); b0 (k t, col g), b1 (k t + 4,
// col g); d0, d1 (row g, cols 2t, 2t + 1), d2, d3 (row g + 8), with
// g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = rt::tf32_rna(v);
  lo = rt::tf32_rna(v - __uint_as_float(hi));
}

// A matrix in shared memory: (r, c) at p[r * sr + c * sc], as f32.
template <typename T>
struct Mat {
  const T* p;
  int sr, sc;
  __device__ __forceinline__ float operator()(int r, int c) const {
    return rt::to_f32(p[r * sr + c * sc]);
  }
};

// The chunk-state product's A: (p, j) = x_jp dt_j exp(a_cum_end - a_cum_j),
// x staged [j][p].
template <typename T>
struct DecayedX {
  const T* x;
  int ld;
  const float* dts;
  const float* wend;
  __device__ __forceinline__ float operator()(int p, int j) const {
    return rt::to_f32(x[j * ld + p]) * dts[j] * wend[j];
  }
};

// The diagonal output's B: (j, p) = x_jp dt_j, x staged [j][p].
template <typename T>
struct Xd {
  const T* x;
  int ld;
  const float* dts;
  __device__ __forceinline__ float operator()(int j, int p) const {
    return rt::to_f32(x[j * ld + p]) * dts[j];
  }
};

// One head's decay-masked scores: (i, j) = exp(a_cum_i - a_cum_j) s_ij for
// j <= i, 0 above the diagonal (never read there).  a_cum_i - a_cum_j <= 0,
// where __expf's error is a few ulp of a value at most 1.
struct Decayed {
  const float* s;
  int ld;
  const float* acum;
  __device__ __forceinline__ float operator()(int i, int j) const {
    return j <= i ? s[i * ld + j] * __expf(acum[i] - acum[j]) : 0.f;
  }
};

// Stage a [rows][cols] tile of T from global memory (rows `ld` elements
// apart) into shared memory (rows `sp` apart), zero past rows_live and
// cols_live: 16-byte cp.async copies where `vec` (rows, live columns and
// pitches of whole 16-byte chunks, 16-byte aligned), else one element at a
// time.  The caller waits (cp_async_wait_all, then a barrier).
template <typename T>
__device__ __forceinline__ void stage(T* dst, int sp, const T* __restrict__ src,
                                      long long ld, int rows_live, int cols_live,
                                      int rows, int cols, bool vec) {
  if (vec) {
    constexpr int EV = 16 / sizeof(T);
    const int cpr = cols / EV;
    for (int e = threadIdx.x; e < rows * cpr; e += blockDim.x) {
      const int r = e / cpr, c = e % cpr * EV;
      const bool live = r < rows_live && c < cols_live;
      rt::cp_async16(dst + r * sp + c, live ? src + r * ld + c : src, live ? 16 : 0);
    }
    return;
  }
  for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
    const int r = e / cols, c = e % cols;
    dst[r * sp + c] =
        r < rows_live && c < cols_live ? src[r * ld + c] : rt::from_f32<T>(0.f);
  }
}

// acc += A[m0 .. m0 + 32, 0 .. k_end) B[0 .. k_end, n0 .. n0 + 32) for the
// calling warp, in 3xTF32; acc[mi][ni] is the fragment of m16 tile mi and
// n8 tile ni.  k_end is a multiple of 8 inside the zero-padded operands.
template <class A, class B>
__device__ __forceinline__ void warp_mma(float (&acc)[2][4][4], const A& fa,
                                         const B& fb, int m0, int n0,
                                         int k_end) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k = 0; k < k_end; k += 8) {
    uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = m0 + 16 * mi + g;
      split(fa(r, k + t), ah[mi][0], al[mi][0]);
      split(fa(r + 8, k + t), ah[mi][1], al[mi][1]);
      split(fa(r, k + t + 4), ah[mi][2], al[mi][2]);
      split(fa(r + 8, k + t + 4), ah[mi][3], al[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + 8 * ni + g;
      split(fb(k + t, col), bh[ni][0], bl[ni][0]);
      split(fb(k + t + 4, col), bh[ni][1], bl[ni][1]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        mma_tf32(acc[mi][ni], al[mi], bh[ni]);
        mma_tf32(acc[mi][ni], ah[mi], bl[ni]);
        mma_tf32(acc[mi][ni], ah[mi], bh[ni]);
      }
  }
}

__device__ __forceinline__ void zero(float (&acc)[2][4][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
}

// Call f(row, col, value) for each element of the warp's 32 x 32 tile.
template <class F>
__device__ __forceinline__ void each(const float (&acc)[2][4][4], int m0, int n0,
                                     F f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f(m0 + 16 * mi + g + 8 * (e >> 1), n0 + 8 * ni + 2 * t + (e & 1),
          acc[mi][ni][e]);
}

// Warp 0: a_cum[j] = sum_{i<=j} dt_i a_h over the chunk's Q rows (each lane
// sums up to 4 consecutive steps, then a shuffle scan over the lanes),
// zero past Q up to Qp; dts[j] = dt_j.  The same code in both chunk
// kernels, so they see the same a_cum.
template <typename T>
__device__ __forceinline__ void chunk_scan(const T* __restrict__ dt,
                                           long long row0, int H, int h,
                                           float ah, int Q, int Qp, float* acum,
                                           float* dts) {
  const int lane = threadIdx.x;
  const int per = (Q + 31) / 32;
  float v[kMaxQ / 32], run = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxQ / 32; ++k) {
    const int j = lane * per + k;
    const float d = k < per && j < Q ? rt::to_f32(dt[(row0 + j) * H + h]) : 0.f;
    if (k < per && j < Q) dts[j] = d;
    v[k] = d * ah;
    run += v[k];
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  float sum = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) sum = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxQ / 32; ++k) {
    const int j = lane * per + k;
    if (k < per && j < Q) {
      sum += v[k];
      acum[j] = sum;
    }
  }
  for (int j = Q + lane; j < Qp; j += 32) {
    acum[j] = 0.f;
    dts[j] = 0.f;
  }
  __syncwarp();
}

// The block's (batch, chunk, group) and its first head.
struct Chunk {
  long long bb;
  int c, g, h0;
  long long row0;  // the chunk's first row of [B * L]
};

__device__ __forceinline__ Chunk chunk_of(int L, int H, int G, int Q, int run) {
  const int nc = L / Q;
  Chunk k;
  k.g = blockIdx.x % G;
  const int bc = blockIdx.x / G;
  k.c = bc % nc;
  k.bb = bc / nc;
  k.h0 = k.g * (H / G) + blockIdx.y * run;
  k.row0 = k.bb * L + static_cast<long long>(k.c) * Q;
  return k;
}

// Row pitches (elements) of the staged tiles, so that a warp's fragment
// loads fall on distinct banks: f32 tiles read along their rows (A [m][k],
// B [n][k]) 4 past a multiple of 32, read down their columns (A [k][m],
// B [k][n]) 8 past; bf16 tiles 8 past either way (16-byte rows).
template <typename T>
__host__ __device__ constexpr int pitch(int cols, bool down) {
  return cols + (sizeof(T) == 2 || down ? 8 : 4);
}

// Bytes of each chunk kernel's shared memory.
template <typename T>
__host__ __device__ constexpr int states_bytes(int Q, int N) {
  return sizeof(T) * (pad32(Q) * pitch<T>(pad32(N), true) + pad32(Q) * pitch<T>(kPB, true)) +
         sizeof(float) * 3 * pad32(Q);
}
template <typename T>
__host__ __device__ constexpr int output_bytes(int Q, int N) {
  return sizeof(T) * pad32(Q) * pitch<T>(pad32(N), false) +
         sizeof(float) * pad32(Q) * (pad32(Q) + 4) +
         max_of(sizeof(T) * pad32(Q) * pitch<T>(pad32(N), false),
                sizeof(T) * pad32(Q) * pitch<T>(kPB, true) +
                    sizeof(float) * (kPB * (pad32(N) + 4) + 3 * pad32(Q)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_states(const T* __restrict__ x, const T* __restrict__ dt,
               const float* __restrict__ a, const T* __restrict__ bmat,
               float* __restrict__ work, float* __restrict__ ends, int L,
               int H, int G, int P, int N, int Q, int run, int vec_b,
               int vec_x) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int Qp = pad32(Q), Np = pad32(N);
  const int ldb = pitch<T>(Np, true), ldx = pitch<T>(kPB, true);
  T* bs = reinterpret_cast<T*>(smem);              // [Qp][ldb]  B of the chunk
  T* xs = bs + Qp * ldb;                           // [Qp][ldx]  x, the block's columns
  float* acum = reinterpret_cast<float*>(xs + Qp * ldx);  // [Qp]
  float* dts = acum + Qp;                          // [Qp]
  float* wend = dts + Qp;                          // [Qp]  exp(a_cum_end - a_cum_j)
  const int nc = L / Q, warp = threadIdx.x / 32;
  const Chunk k = chunk_of(L, H, G, Q, run);

  stage(bs, ldb, bmat + (k.row0 * G + k.g) * N, static_cast<long long>(G) * N, Q, N, Qp,
        Np, vec_b);
  const int tiles_n = Np / 32;
  for (int hh = 0; hh < run; ++hh) {
    const int h = k.h0 + hh;
    const long long head = (k.bb * nc + k.c) * H + h;
    for (int p0 = 0; p0 < P; p0 += kPB) {
      const int pb = min(kPB, P - p0);
      __syncthreads();  // the last products have read x (and a_cum)
      stage(xs, ldx, x + (k.row0 * H + h) * P + p0, static_cast<long long>(H) * P, Q, pb,
            Qp, kPB, vec_x);
      if (p0 == 0 && warp == 0) {
        chunk_scan(dt, k.row0, H, h, a[h], Q, Qp, acum, dts);
        for (int j = threadIdx.x; j < Qp; j += 32)
          wend[j] = j < Q ? expf(acum[Q - 1] - acum[j]) : 0.f;
        if (threadIdx.x == 0) ends[head] = acum[Q - 1];
      }
      rt::cp_async_wait_all();
      __syncthreads();
      // dS[p, n] = sum_j x_jp dt_j wend_j B[j, n]
      float* dst = work + head * P * N + static_cast<long long>(p0) * N;
      for (int tile = warp; tile < (kPB / 32) * tiles_n; tile += kWarps) {
        const int m0 = tile / tiles_n * 32, n0 = tile % tiles_n * 32;
        if (m0 >= pb) continue;
        float acc[2][4][4];
        zero(acc);
        warp_mma(acc, DecayedX<T>{xs, ldx, dts, wend}, Mat<T>{bs, ldb, 1}, m0, n0,
                 pad8(Q));
        each(acc, m0, n0, [&](int p, int n, float v) {
          if (p < pb && n < N) dst[p * N + n] = v;
        });
      }
    }
  }
}

// The state entering each chunk, in place of the state it adds, and the
// final state: one thread 4 elements (1 where P N is not a multiple of 4)
// of a (batch, head)'s [P, N], 4 chunks' loads in flight at a time.
__global__ void __launch_bounds__(kThreads)
    ssd_pass(float* __restrict__ work, const float* __restrict__ ends,
             float* __restrict__ state, int nc, int H, int PN) {
  const int vec = PN % 4 == 0 ? 4 : 1;
  const int e = (blockIdx.y * kThreads + threadIdx.x) * vec;
  if (e >= PN) return;
  const long long bb = blockIdx.x / H;
  const int h = blockIdx.x % H;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < nc; c0 += 4) {
    float d[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (c0 + u >= nc) break;
      const float* p = work + ((bb * nc + c0 + u) * H + h) * PN + e;
      if (vec == 4) {
        const float4 v = *reinterpret_cast<const float4*>(p);
        d[u][0] = v.x;
        d[u][1] = v.y;
        d[u][2] = v.z;
        d[u][3] = v.w;
      } else {
        d[u][0] = *p;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (c0 + u >= nc) break;
      const long long head = (bb * nc + c0 + u) * H + h;
      float* p = work + head * PN + e;
      if (vec == 4)
        *reinterpret_cast<float4*>(p) = make_float4(s[0], s[1], s[2], s[3]);
      else
        *p = s[0];
      const float decay = expf(ends[head]);
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] = fmaf(decay, s[i], d[u][i]);
    }
  }
  float* out = state + (bb * H + h) * PN + e;
  if (vec == 4)
    *reinterpret_cast<float4*>(out) = make_float4(s[0], s[1], s[2], s[3]);
  else
    *out = s[0];
}

// One block an SM (up to 207 KB of shared memory), so all of its registers.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_output(const T* __restrict__ x, const T* __restrict__ dt,
               const float* __restrict__ a, const T* __restrict__ bmat,
               const T* __restrict__ cmat, const float* __restrict__ work,
               T* __restrict__ y, int L, int H, int G, int P, int N, int Q,
               int run, int vec_b, int vec_x, int vec_s) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int Qp = pad32(Q), Np = pad32(N);
  const int ldn = pitch<T>(Np, false), lds = Qp + 4, ldx = pitch<T>(kPB, true),
            ldp = Np + 4;
  T* cs = reinterpret_cast<T*>(smem);                    // [Qp][ldn]  C of the chunk
  float* ss = reinterpret_cast<float*>(cs + Qp * ldn);   // [Qp][lds]  scores C.B^T (on
                                                         // and below the diagonal's tiles)
  T* bs = reinterpret_cast<T*>(ss + Qp * lds);           // [Qp][ldn]  B of the chunk, then:
  T* xs = bs;                                            // [Qp][ldx]  x, the block's columns
  float* sp = reinterpret_cast<float*>(xs + Qp * ldx);   // [kPB][ldp] the state entering
  float* acum = sp + kPB * ldp;                          // [Qp]
  float* eac = acum + Qp;                                // [Qp]       exp(a_cum)
  float* dts = eac + Qp;                                 // [Qp]
  const int nc = L / Q, warp = threadIdx.x / 32;
  const Chunk k = chunk_of(L, H, G, Q, run);

  const long long bc0 = (k.row0 * G + k.g) * N;
  stage(cs, ldn, cmat + bc0, static_cast<long long>(G) * N, Q, N, Qp, Np, vec_b);
  stage(bs, ldn, bmat + bc0, static_cast<long long>(G) * N, Q, N, Qp, Np, vec_b);
  rt::cp_async_wait_all();
  __syncthreads();
  const int tiles_q = Qp / 32;
  for (int tile = warp; tile < tiles_q * tiles_q; tile += kWarps) {
    const int m0 = tile / tiles_q * 32, n0 = tile % tiles_q * 32;
    if (n0 > m0) continue;  // wholly above the diagonal
    float acc[2][4][4];
    zero(acc);
    warp_mma(acc, Mat<T>{cs, ldn, 1}, Mat<T>{bs, 1, ldn}, m0, n0, pad8(N));
    each(acc, m0, n0, [&](int i, int j, float v) { ss[i * lds + j] = v; });
  }

  const int tiles_p = kPB / 32;
  for (int hh = 0; hh < run; ++hh) {
    const int h = k.h0 + hh;
    const long long head = (k.bb * nc + k.c) * H + h;
    for (int p0 = 0; p0 < P; p0 += kPB) {
      const int pb = min(kPB, P - p0);
      __syncthreads();  // B, or the last products' operands, are read
      stage(xs, ldx, x + (k.row0 * H + h) * P + p0, static_cast<long long>(H) * P, Q, pb,
            Qp, kPB, vec_x);
      stage(sp, ldp, work + head * P * N + static_cast<long long>(p0) * N,
            static_cast<long long>(N), pb, N, kPB, Np, vec_s);
      if (p0 == 0 && warp == 0) {
        chunk_scan(dt, k.row0, H, h, a[h], Q, Qp, acum, dts);
        for (int j = threadIdx.x; j < Qp; j += 32) eac[j] = j < Q ? expf(acum[j]) : 0.f;
      }
      rt::cp_async_wait_all();
      __syncthreads();
      for (int tile = warp; tile < tiles_q * tiles_p; tile += kWarps) {
        const int m0 = tile / tiles_p * 32, n0 = tile % tiles_p * 32;
        if (n0 >= pb) continue;
        float acc[2][4][4];
        zero(acc);
        // C S^T, each row scaled by exp(a_cum_i), then the diagonal's
        // decayed scores times xd over the keys up to the tile's last row
        warp_mma(acc, Mat<T>{cs, ldn, 1}, Mat<float>{sp, 1, ldp}, m0, n0, pad8(N));
        {
          const int lane = threadIdx.x & 31, g = lane >> 2;
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const float e0 = eac[m0 + 16 * mi + g], e1 = eac[m0 + 16 * mi + g + 8];
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
              acc[mi][ni][0] *= e0;
              acc[mi][ni][1] *= e0;
              acc[mi][ni][2] *= e1;
              acc[mi][ni][3] *= e1;
            }
          }
        }
        warp_mma(acc, Decayed{ss, lds, acum}, Xd<T>{xs, ldx, dts}, m0, n0,
                 min(pad8(Q), m0 + 32));
        each(acc, m0, n0, [&](int i, int p, float v) {
          if (i < Q && p < pb)
            y[((k.row0 + i) * H + h) * P + p0 + p] = rt::from_f32<T>(v);
        });
      }
    }
  }
}

__host__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
int launch(const T* x, const T* dt, const float* a, const T* b, const T* c,
           T* y, float* state, float* work, int batch, int L, int H, int G,
           int P, int N, int Q, int run, cudaStream_t stream) {
  if (batch < 1 || L < 1 || H < 1 || G < 1 || H % G || P < 1 || N < 1 ||
      N > kMaxN || Q < 1 || Q > kMaxQ || L % Q || run < 1 || (H / G) % run)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = L / Q;
  float* ends = work + static_cast<long long>(batch) * nc * H * P * N;
  constexpr int EV = 16 / sizeof(T);
  // 16-byte staging where rows and their live columns are whole chunks
  const int vec_b = N % EV == 0 && aligned16(b) && aligned16(c);
  const int vec_x = P % EV == 0 && aligned16(x);
  const int vec_s = N % 4 == 0 && aligned16(work);
  const dim3 chunks(static_cast<unsigned>(batch) * nc * G, (H / G) / run);
  static bool opted[2][rt::kMaxDevices] = {};
  int err = rt::opt_in_smem(ssd_states<T>, kSmemMax, opted[0]);
  if (!err) err = rt::opt_in_smem(ssd_output<T>, kSmemMax, opted[1]);
  if (err) return err;
  ssd_states<T><<<chunks, kThreads, states_bytes<T>(Q, N), stream>>>(
      x, dt, a, b, work, ends, L, H, G, P, N, Q, run, vec_b, vec_x);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int per = P * N % 4 == 0 ? 4 : 1;
  const dim3 heads(static_cast<unsigned>(batch) * H,
                   (P * N / per + kThreads - 1) / kThreads);
  ssd_pass<<<heads, kThreads, 0, stream>>>(work, ends, state, nc, H, P * N);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  ssd_output<T><<<chunks, kThreads, output_bytes<T>(Q, N), stream>>>(
      x, dt, a, b, c, work, y, L, H, G, P, N, Q, run, vec_b, vec_x, vec_s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [batch, L, H, P]; dt [batch, L, H]; a [H] f32; b, c [batch, L, G, N];
// y like x; state [batch, H, P, N] f32; work the f32 workspace of
// batch * (L / Q) * H * (P * N + 1) floats; chunk Q; `run` heads of one
// group a chunk block (a divisor of H / G).
extern "C" int ssd_chunk_f32(const float* x, const float* dt, const float* a,
                             const float* b, const float* c, float* y,
                             float* state, float* work, int batch, int L, int H,
                             int G, int P, int N, int Q, int run,
                             cudaStream_t stream) {
  return launch(x, dt, a, b, c, y, state, work, batch, L, H, G, P, N, Q, run,
                stream);
}

extern "C" int ssd_chunk_bf16(const __nv_bfloat16* x, const __nv_bfloat16* dt,
                              const float* a, const __nv_bfloat16* b,
                              const __nv_bfloat16* c, __nv_bfloat16* y,
                              float* state, float* work, int batch, int L,
                              int H, int G, int P, int N, int Q, int run,
                              cudaStream_t stream) {
  return launch(x, dt, a, b, c, y, state, work, batch, L, H, G, P, N, Q, run,
                stream);
}
