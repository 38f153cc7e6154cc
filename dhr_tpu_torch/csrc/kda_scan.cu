// K7: Kimi Delta Attention's chunked delta-rule recurrence, for sm_90a.
//
// Replaces no Pallas kernel: the JAX package has no decoder.  It does all
// that the port's plain chunked scan (dhr_tpu_torch/models/decoder.py
// kda_scan) computes from the short convolutions' outputs to o, which ran
// as ~40 eager passes a layer over f32 re-layouts of the inputs: the
// per-head L2 norms, the chunk-local products and unit-triangular solve
// (decoder.py _chunk_local) and the state passed from chunk to chunk.  For
// passage b, head h, chunks of C = 64 positions and head dim D (d_v = D):
//
//   q <- q rsqrt(|q|^2 + 1e-6) D^-0.5,  k <- k rsqrt(|k|^2 + 1e-6)
//   A[r, s]  = beta_r sum_i k_r,i k_s,i exp(G(s, r]_i)        s < r
//   P[r, s]  = sum_i q_r,i k_s,i exp(G(s, r]_i)               s <= r
//   (I + A) [u | wk] = [beta v | beta exp(G[0, r]) k]          one solve
//   qs = exp(G[0, r]) q - P wk,  o_in = P u,  ks_s = exp(G(s, C-1]) k_s
//   W = u - wk S,  o = o_in + qs S,  S' = exp(G[0, C-1]) S + ks^T W
//
// with G(s, r]_i the sum of channel i's log-decays g over positions s+1..r
// of the chunk and S the (D, d_v) state, 0 before the first chunk.  Every
// product, the solve and the state are f32, by FFMA on the CUDA cores.
//
// Every exponent is a sum of the g it spans and <= 0, never a difference
// of two cumulative sums: a chunk's log-decay runs past -100, where the
// difference form loses ~4e-5 of the scale.  A and P factor at a split
// point e between s and r, exp(G(s, r]) = exp(G(e, r]) exp(G(s, e]), each
// factor a sum and <= 1, as _chunk_local's sub-chunks do; here the splits
// nest: level H = 32, 16, 8, 4, 2, 1 takes the pairs of each block of 2H
// positions whose s lies in its lower half and r in its upper, with e the
// lower half's last position.  Each level is one product over the D
// channels of row operands x_r exp(G(e, r]) against column operands k_s
// exp(G(s, e]), built once per position and level by a running sum; all
// the pairs s < r are taken once, and P's diagonal is q_r . k_r.  A factor
// that underflows does so only where its product is below 1e-38.
//
// What bounds it: the f32 FFMA rate, and in pass 1 latency.  At the Kimi
// cell's 8 x 2,048, 32 heads of 128, a layer is 8,192 (chunk, head) pairs
// of ~4.7M FMA each (~1.6M chunk-local, ~3.1M of state), ~1.1 ms at 67
// TFLOP/s; the bytes it must move (bf16 q, k, v, f32 g, the output) take
// ~0.2 ms.  Design:
// - two kernels, launched one after the other on the caller's stream;
// - pass 1, one block a (chunk, passage-head), all chunks at once, one
//   block to an SM (~204 KB of shared memory): loads the chunk's q, k, g
//   and beta through their strides (the convolution's output is
//   channel-major and is read in place; every load issued before any is
//   used) into channel-major shared tiles, normalises, forms A (row-major)
//   and P (transposed) level by level, the operands vectorised along
//   positions and the small levels' dot products split over 2-4 threads;
//   solves for [u | wk] a thread a column, in blocks of 16 rows held in
//   registers (A read by broadcast); and forms qs and o_in as one causal
//   product whose warps take one early and one late row group each, so
//   every warp does the same work.  It writes [-wk | qs] transposed, ks,
//   [u | o_in] and the decay, f32, to a scratch the wrapper allocates
//   (~160 KB a (chunk, head) at D = 128).  Its phases are loops, not
//   straight-line code: fully unrolled (~14k instructions, past what the
//   instruction cache holds) its solve alone took ~2x as long;
// - pass 2, one block a (passage-head, slice of 64 state columns), two
//   blocks to an SM: walks the chunks with its (D, 64) slice of the state
//   in shared memory and registers, [W | o] = [u | o_in] + [-wk | qs] S as
//   one product and then S' = decay S + ks^T W, each thread a 4 x 8 tile;
//   chunk j+1's [-wk | qs]^T is staged by cp.async during chunk j's state
//   update, ks read through the cache; o written once, in v's dtype, in
//   (B, L, h, d_v) layout.
// Positions past the length read as zeros (their k and beta are 0, so
// they change nothing) and are not written.

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kC = 64;          // the chunk
constexpr int kThreads = 256;   // both kernels
constexpr int kCP = kC + 4;     // row pitch of a channel-major tile [D][C]
constexpr int kSlice = 64;      // state columns a pass-2 block (D >= 64)

struct Strides {
  long long b, t, h, c;         // elements
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* g;
  const float* beta;
  Strides sq, sk, sv, sg, sbeta;  // sbeta.c unused
  float* work;                    // (B h, chunks, Per<D>) f32
  void* out;                      // (B, L, h, D), contiguous
  int length, heads, chunks;
  float q_scale;                  // D ** -0.5
};

// A (chunk, passage-head)'s scratch, in floats: [-wk | qs] transposed
// (D rows of 2C), ks (C rows of D), [u | o_in] (2C rows of D), the decay.
template <int D>
struct Work {
  static constexpr int AT = 0;
  static constexpr int KS = 2 * kC * D;
  static constexpr int UO = 3 * kC * D;
  static constexpr int DEC = 5 * kC * D;
  static constexpr int Per = 5 * kC * D + D;
};

template <int N>
__device__ __forceinline__ void ld(const float* p, float (&x)[N]) {
  dhr::load_vec<float, N>(p, x);
}

template <int N>
__device__ __forceinline__ void st(float* p, const float (&x)[N]) {
  using W = typename dhr::Word<4 * N>::T;
  W w;
  memcpy(&w, &x[0], sizeof(W));
  *reinterpret_cast<W*>(p) = w;
}

// A chunk's C positions x D channels of a strided input, a thread's
// share in registers: consecutive threads take consecutive addresses of
// whichever of the two dims has stride 1, so a thread's element n lies at
// (i0 + n di, r0 + n dr).  Every load is unconditional (a position past
// the length reads the tensor's first element, then counts as 0), so all
// are in flight before any is used.
template <int D>
struct Tile {
  static_assert(kThreads % D == 0 && kThreads % kC == 0 &&
                    (kC * D) % kThreads == 0,
                "a thread's elements step by whole rows or columns");
  static constexpr int N = kC * D / kThreads;
  float x[N];
  int i0, r0, di, dr;

  __device__ __forceinline__ explicit Tile(const Strides& s) {
    const bool channel_fast = s.c == 1;
    const int tid = threadIdx.x;
    i0 = channel_fast ? tid % D : tid / kC;
    r0 = channel_fast ? tid / D : tid % kC;
    di = channel_fast ? 0 : kThreads / kC;
    dr = channel_fast ? kThreads / D : 0;
  }
};

// x(b, t0 + r, h, i), zero past `valid` positions.
template <int D, int K>
__device__ __forceinline__ void fetch(Tile<D>& t, const void* src,
                                      const Strides& s, long long b,
                                      long long t0, long long h, int valid) {
  using T = typename dhr::Elem<K>::T;
  const T* base = static_cast<const T*>(src);
  const T* p0 = base + b * s.b + (t0 + t.r0) * s.t + h * s.h + t.i0 * s.c;
  const long long step = t.di * s.c + t.dr * s.t;
  T raw[Tile<D>::N];
#pragma unroll
  for (int n = 0; n < Tile<D>::N; ++n) {
    const bool in = t.r0 + n * t.dr < valid;
    raw[n] = *(in ? p0 + n * step : base);
  }
#pragma unroll
  for (int n = 0; n < Tile<D>::N; ++n) {
    const bool in = t.r0 + n * t.dr < valid;
    t.x[n] = in ? dhr::to_f32<K>(raw[n]) : 0.f;
  }
}

// dst[i * pi + r * pr] = x(i, r) * (row_scale ? row_scale[r] : 1).
template <int D>
__device__ __forceinline__ void put(float* dst, int pi, int pr,
                                    const Tile<D>& t,
                                    const float* row_scale = nullptr) {
#pragma unroll
  for (int n = 0; n < Tile<D>::N; ++n) {
    const int i = t.i0 + n * t.di, r = t.r0 + n * t.dr;
    dst[i * pi + r * pr] = row_scale ? t.x[n] * row_scale[r] : t.x[n];
  }
}

// Level H's operands: for each block of 2H positions with split e (its
// lower half's last), column operands Xk[., s] = k_s exp(G(s, e]) over the
// lower half and row operands Xk[., r] = k_r exp(G(e, r]), Xq[., r] = q_r
// exp(G(e, r]) over the upper; running sums along positions, 4 at a time.
template <int D, int H>
__device__ void build(const float* Kt, const float* Qt, const float* Gt,
                      float* Xk, float* Xq) {
  if constexpr (H >= 4) {
    for (int t = threadIdx.x; t < (kC / H) * D; t += kThreads) {
      const int i = t % D, half = t / D, lo = half * H;
      const float* g = Gt + i * kCP;
      const float* k = Kt + i * kCP;
      if (half % 2 == 0) {
        float acc = 0.f;
        for (int q4 = H / 4 - 1; q4 >= 0; --q4) {
          const int s0 = lo + 4 * q4;
          float g4[4], k4[4], x[4];
          ld(g + s0, g4);
          ld(k + s0, k4);
#pragma unroll
          for (int u = 3; u >= 0; --u) {
            x[u] = k4[u] * expf(acc);
            acc += g4[u];
          }
          st(Xk + i * kCP + s0, x);
        }
      } else {
        const float* q = Qt + i * kCP;
        float acc = 0.f;
        for (int q4 = 0; q4 < H / 4; ++q4) {
          const int r0 = lo + 4 * q4;
          float g4[4], k4[4], v4[4], xk[4], xq[4];
          ld(g + r0, g4);
          ld(k + r0, k4);
          ld(q + r0, v4);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            acc += g4[u];
            const float f = expf(acc);
            xk[u] = k4[u] * f;
            xq[u] = v4[u] * f;
          }
          st(Xk + i * kCP + r0, xk);
          st(Xq + i * kCP + r0, xq);
        }
      }
    }
  } else {
    // H = 2: one block of 4 a quad; H = 1: two blocks of 2.
    for (int t = threadIdx.x; t < (kC / 4) * D; t += kThreads) {
      const int i = t % D, s0 = 4 * (t / D);
      float g4[4], k4[4], v4[4], xk[4], xq[4] = {0.f, 0.f, 0.f, 0.f};
      ld(Gt + i * kCP + s0, g4);
      ld(Kt + i * kCP + s0, k4);
      ld(Qt + i * kCP + s0, v4);
      if constexpr (H == 2) {
        xk[0] = k4[0] * expf(g4[1]);
        xk[1] = k4[1];
        float f = expf(g4[2]);
        xk[2] = k4[2] * f;
        xq[2] = v4[2] * f;
        f = expf(g4[2] + g4[3]);
        xk[3] = k4[3] * f;
        xq[3] = v4[3] * f;
      } else {
#pragma unroll
        for (int p = 0; p < 4; p += 2) {
          const float f = expf(g4[p + 1]);
          xk[p] = k4[p];
          xk[p + 1] = k4[p + 1] * f;
          xq[p + 1] = v4[p + 1] * f;
        }
      }
      st(Xk + i * kCP + s0, xk);
      st(Xq + i * kCP + s0, xq);
    }
  }
}

// Level H's products, each tile TM x TN of one block's pairs taken by NP
// adjacent threads, each a 1/NP of the channels, summed by shuffles (the
// small levels have few pairs): rows 0..H-1 of a block are A's (k
// operands), H..2H-1 P's (q operands).  A[r][s] = beta_r (row . column),
// row-major; P^T[s][r], transposed.
template <int D, int H, int TM, int TN, int NP>
__device__ void products(const float* Xk, const float* Xq, const float* beta,
                         float* A, float* Pt) {
  constexpr int kCols = H / TN, kRows = 2 * H / TM;
  constexpr int kTasks = (kC / (2 * H)) * kRows * kCols * NP;
  static_assert(NP == 1 || kTasks == kThreads, "whole warps shuffle");
  for (int t = threadIdx.x; t < kTasks; t += kThreads) {
    const int part = t % NP, tile = t / NP;
    const int tn = tile % kCols, tm = (tile / kCols) % kRows;
    const int b0 = (tile / (kCols * kRows)) * 2 * H;
    const int vr = tm * TM;
    const bool is_k = vr < H;
    const int r0 = b0 + H + (is_k ? vr : vr - H), s0 = b0 + tn * TN;
    const float* rows = (is_k ? Xk : Xq) + r0;
    const float* cols = Xk + s0;
    float acc[TM][TN] = {};
#pragma unroll 8
    for (int i = part; i < D; i += NP) {
      float a[TM], b[TN];
      ld(rows + i * kCP, a);
      ld(cols + i * kCP, b);
#pragma unroll
      for (int u = 0; u < TM; ++u) {
#pragma unroll
        for (int w = 0; w < TN; ++w) acc[u][w] = fmaf(a[u], b[w], acc[u][w]);
      }
    }
#pragma unroll
    for (int u = 0; u < TM; ++u) {
#pragma unroll
      for (int w = 0; w < TN; ++w) {
#pragma unroll
        for (int m = 1; m < NP; m *= 2) {
          acc[u][w] += __shfl_xor_sync(0xffffffffu, acc[u][w], m);
        }
        if (part != 0) continue;
        if (is_k) {
          A[(r0 + u) * kCP + s0 + w] = beta[r0 + u] * acc[u][w];
        } else {
          Pt[(s0 + w) * kCP + r0 + u] = acc[u][w];
        }
      }
    }
  }
}

template <int D>
struct Local {
  static constexpr int Plane = D * kCP;  // floats of a [D][C] tile
  static constexpr int XS = 2 * D + 4;    // row pitch of [u | wk]
  static constexpr int XFloats = (2 * Plane > kC * XS ? 2 * Plane : kC * XS);
  static constexpr int Kt = 0, Qt = Plane, Gt = 2 * Plane, X = 3 * Plane;
  static constexpr int A = X + XFloats, Pt = A + kC * kCP, Beta = Pt + kC * kCP;
  static constexpr int Floats = Beta + kC;
  static constexpr int Smem = Floats * 4;
};

// Pass 1: the chunk-local part of one (chunk, passage-head).
template <int D, int K>
__global__ void __launch_bounds__(kThreads)
    local_kernel(const Params p) {
  static_assert(kThreads == 256 && kC == 64, "P3's row groups assume these");
  static_assert(2 * D <= kThreads && D % 4 == 0 && D <= 128, "head dim");
  using L = Local<D>;
  extern __shared__ __align__(16) float sm[];
  float* Kt = sm + L::Kt;
  float* Qt = sm + L::Qt;
  float* Gt = sm + L::Gt;
  float* Xk = sm + L::X;
  float* Xq = sm + L::X + L::Plane;
  float* Xs = sm + L::X;  // [u | wk], (C, XS), after the levels
  float* A = sm + L::A;
  float* Pt = sm + L::Pt;
  float* beta = sm + L::Beta;
  const int tid = threadIdx.x;
  const int chunk = blockIdx.x, bh = blockIdx.y;
  const long long b = bh / p.heads, h = bh % p.heads;
  const long long t0 = static_cast<long long>(chunk) * kC;
  const int valid =
      p.length - t0 < kC ? static_cast<int>(p.length - t0) : kC;
  float* work =
      p.work + (static_cast<long long>(bh) * p.chunks + chunk) * Work<D>::Per;

  // P0: the chunk's tiles, channel-major; beta; P^T zeroed (the levels
  // and the diagonal fill its entries with s <= r).
  Tile<D> tk(p.sk), tq(p.sq), tg(p.sg);
  fetch<D, K>(tk, p.k, p.sk, b, t0, h, valid);
  fetch<D, K>(tq, p.q, p.sq, b, t0, h, valid);
  fetch<D, dhr::kF32>(tg, p.g, p.sg, b, t0, h, valid);
  put<D>(Kt, kCP, 1, tk);
  put<D>(Qt, kCP, 1, tq);
  put<D>(Gt, kCP, 1, tg);
  if (tid < kC) {
    beta[tid] = tid < valid
                    ? p.beta[b * p.sbeta.b + (t0 + tid) * p.sbeta.t +
                             h * p.sbeta.h]
                    : 0.f;
  }
  for (int idx = tid; idx < kC * kCP; idx += kThreads) Pt[idx] = 0.f;
  __syncthreads();
  {
    // L2 norms: 4 threads a position, each a quarter of the channels
    const int r = tid >> 2, part = tid & 3;
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      float* x = which ? Qt : Kt;
      float ss = 0.f;
      for (int i = part; i < D; i += 4) {
        ss = fmaf(x[i * kCP + r], x[i * kCP + r], ss);
      }
      ss += __shfl_xor_sync(0xffffffffu, ss, 1);
      ss += __shfl_xor_sync(0xffffffffu, ss, 2);
      const float f = rsqrtf(ss + 1e-6f);
      for (int i = part; i < D; i += 4) {
        const float y = x[i * kCP + r] * f;
        x[i * kCP + r] = which ? y * p.q_scale : y;
      }
    }
  }
  __syncthreads();

  // P1: A and P, level by level.
#define KDA_LEVEL(H, TM, TN, NP)                   \
  build<D, H>(Kt, Qt, Gt, Xk, Xq);                 \
  __syncthreads();                                 \
  products<D, H, TM, TN, NP>(Xk, Xq, beta, A, Pt); \
  __syncthreads();
  KDA_LEVEL(32, 2, 4, 1)
  KDA_LEVEL(16, 2, 2, 1)
  KDA_LEVEL(8, 2, 1, 1)
  KDA_LEVEL(4, 1, 1, 1)
  KDA_LEVEL(2, 1, 1, 2)
  KDA_LEVEL(1, 1, 1, 4)
#undef KDA_LEVEL
  {
    // P's diagonal, q_r . k_r, four threads a position
    constexpr int NP = kThreads / kC;
    const int r = tid / NP, part = tid % NP;
    float acc = 0.f;
    for (int i = part; i < D; i += NP) {
      acc = fmaf(Qt[i * kCP + r], Kt[i * kCP + r], acc);
    }
#pragma unroll
    for (int m = 1; m < NP; m *= 2) {
      acc += __shfl_xor_sync(0xffffffffu, acc, m);
    }
    if (part == 0) Pt[r * kCP + r] = acc;
  }
  __syncthreads();  // the diagonal has read Qt, which P2a overwrites

  // P2a: the right-hand side [beta v | beta exp(G[0, r]) k] into Xs;
  // exp(G[0, r]) q into Qt in place; ks and the decay to the scratch.
  constexpr int XS = L::XS;
  Tile<D> tv(p.sv);  // in flight during the walks
  fetch<D, K>(tv, p.v, p.sv, b, t0, h, valid);
  if (tid < D) {
    const int i = tid;
    float acc = 0.f, e = 1.f;
    for (int r0 = 0; r0 < kC; r0 += 4) {
      float g4[4], k4[4], v4[4], b4[4], qe[4];
      ld(Gt + i * kCP + r0, g4);
      ld(Kt + i * kCP + r0, k4);
      ld(Qt + i * kCP + r0, v4);
      ld(beta + r0, b4);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        acc += g4[u];
        e = expf(acc);
        Xs[(r0 + u) * XS + D + i] = e * k4[u] * b4[u];
        qe[u] = e * v4[u];
      }
      st(Qt + i * kCP + r0, qe);
    }
    work[Work<D>::DEC + i] = e;
  } else if (tid < 2 * D) {
    const int i = tid - D;
    float acc = 0.f;
    for (int r0 = kC - 4; r0 >= 0; r0 -= 4) {
      float g4[4], k4[4];
      ld(Gt + i * kCP + r0, g4);
      ld(Kt + i * kCP + r0, k4);
#pragma unroll
      for (int u = 3; u >= 0; --u) {
        work[Work<D>::KS + (r0 + u) * D + i] = expf(acc) * k4[u];
        acc += g4[u];
      }
    }
  }
  put<D>(Xs, 1, XS, tv, beta);  // beta v: Xs[r][c], c < D
  __syncthreads();

  // P2b: (I + A) X = Xs by forward substitution, a thread a column, in
  // blocks of 16 rows: a block's x in registers, solved inside, then taken
  // out of every later row (A's rows read by broadcast).  Loops, not
  // straight-line code: the kernel's instructions must stay in cache.
  if (tid < 2 * D) {
    const int c = tid;
    for (int r0 = 0; r0 < kC; r0 += 16) {
      float x[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        x[u] = Xs[(r0 + u) * XS + c];
#pragma unroll
        for (int w = 0; w < u; ++w) {
          x[u] = fmaf(-A[(r0 + u) * kCP + r0 + w], x[w], x[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < 16; ++u) Xs[(r0 + u) * XS + c] = x[u];
#pragma unroll 2
      for (int r = r0 + 16; r < kC; ++r) {
        float a[16];
#pragma unroll
        for (int w = 0; w < 16; w += 4) {
          float a4[4];
          ld(A + r * kCP + r0 + w, a4);
#pragma unroll
          for (int u = 0; u < 4; ++u) a[w + u] = a4[u];
        }
        float y0 = Xs[r * XS + c], y1 = 0.f, y2 = 0.f, y3 = 0.f;
#pragma unroll
        for (int w = 0; w < 16; w += 4) {
          y0 = fmaf(-a[w], x[w], y0);
          y1 = fmaf(-a[w + 1], x[w + 1], y1);
          y2 = fmaf(-a[w + 2], x[w + 2], y2);
          y3 = fmaf(-a[w + 3], x[w + 3], y3);
        }
        Xs[r * XS + c] = (y0 + y1) + (y2 + y3);
      }
    }
    // u to [u | o_in]'s rows, -wk to [-wk | qs]^T's rows
    if (c < D) {
      for (int r = 0; r < kC; ++r) {
        work[Work<D>::UO + r * D + c] = Xs[r * XS + c];
      }
    } else {
      float* at_row = work + Work<D>::AT + (c - D) * 2 * kC;
      for (int r = 0; r < kC; r += 4) {
        const float w4[4] = {-Xs[r * XS + c], -Xs[(r + 1) * XS + c],
                             -Xs[(r + 2) * XS + c], -Xs[(r + 3) * XS + c]};
        st(at_row + r, w4);
      }
    }
  }
  __syncthreads();

  // P3: [o_in | P wk] = P [u | wk], causal; warp w takes rows 4w..4w+3
  // and 60-4w..63-4w, lane l columns 4l..4l+3 of u and of wk.
  {
    const int w = tid >> 5, l = tid & 31;
    if (l < D / 4) {
      const int ra = 4 * w, rb = kC - 4 - 4 * w;
      float acc[2][4][8] = {};
      // acc[grp] += P^T[s][rows of grp] (x) [u | wk][s][the lane's columns]
      auto step = [&](int s, int grp, int r0) {
        float pr[4], xu[4], xw[4];
        ld(Pt + s * kCP + r0, pr);
        ld(Xs + s * XS + 4 * l, xu);
        ld(Xs + s * XS + D + 4 * l, xw);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            acc[grp][u][n] = fmaf(pr[u], xu[n], acc[grp][u][n]);
            acc[grp][u][4 + n] = fmaf(pr[u], xw[n], acc[grp][u][4 + n]);
          }
        }
      };
#pragma unroll 4
      for (int s = 0; s < ra + 4; ++s) {
        step(s, 0, ra);
        step(s, 1, rb);
      }
#pragma unroll 4
      for (int s = ra + 4; s < rb + 4; ++s) step(s, 1, rb);
#pragma unroll
      for (int grp = 0; grp < 2; ++grp) {
        const int r0 = grp ? rb : ra;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float o4[4] = {acc[grp][u][0], acc[grp][u][1], acc[grp][u][2],
                               acc[grp][u][3]};
          st(work + Work<D>::UO + (kC + r0 + u) * D + 4 * l, o4);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int i = 4 * l + n;
          float qe[4], qs[4];
          ld(Qt + i * kCP + r0, qe);
#pragma unroll
          for (int u = 0; u < 4; ++u) qs[u] = qe[u] - acc[grp][u][4 + n];
          st(work + Work<D>::AT + i * 2 * kC + kC + r0, qs);
        }
      }
    }
  }
}

template <int D>
struct State {
  static constexpr int DS = D < kSlice ? D : kSlice;
  static constexpr int Buf = 2 * kC * D + D;  // [-wk | qs]^T, decay
  static constexpr int S = Buf, W = S + D * DS;
  static constexpr int Floats = W + kC * DS;
  static constexpr int Smem = Floats * 4;
};

// Stage chunk j's [-wk | qs]^T and decay into buf, 16 bytes a copy.
template <int D>
__device__ __forceinline__ void stage(float* buf, const float* src) {
  constexpr int kMain = 2 * kC * D / 4, kAll = kMain + D / 4;
  for (int idx = threadIdx.x; idx < kAll; idx += kThreads) {
    const bool ops = idx < kMain;
    const int off = ops ? 4 * idx : 4 * (idx - kMain);
    dhr::cp_async16(buf + (ops ? 0 : 2 * kC * D) + off,
                    src + (ops ? 0 : Work<D>::DEC) + off, 16);
  }
  dhr::cp_async_commit();
}

// y[u][n] += a[u] b[n] for a 4 x 8 tile.
__device__ __forceinline__ void outer(float (&y)[4][8], const float (&a)[4],
                                      const float (&b)[8]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
#pragma unroll
    for (int n = 0; n < 8; ++n) y[u][n] = fmaf(a[u], b[n], y[u][n]);
  }
}

// Pass 2: the state of one (passage-head, slice of DS columns), chunk by
// chunk, and the output of that slice; two blocks to an SM.  Each thread
// takes a 4 x 8 tile of each product: 4 rows, and 4 columns in each half
// of the slice.  Chunk j+1's [-wk | qs]^T is staged while chunk j's state
// update runs; ks is read from the scratch through the cache.
template <int D, int K>
__global__ void __launch_bounds__(kThreads, 2)
    state_kernel(const Params p) {
  using St = State<D>;
  static_assert(St::Smem <= 232448 / 2, "two blocks to an SM");
  constexpr int DS = St::DS, kTN = DS / 8, kHalf = DS / 2;
  extern __shared__ __align__(16) float sm[];
  float* S = sm + St::S;
  float* W = sm + St::W;
  const int tid = threadIdx.x;
  const int slice = blockIdx.x, bh = blockIdx.y;
  const long long b = bh / p.heads, h = bh % p.heads;
  const int tn = tid % kTN, n0 = 4 * tn, c0 = slice * DS + n0;
  const int tm = tid / kTN;  // rows 4 tm.. of the 2C (GEMM 1) or D (GEMM 2)
  const bool g1 = tm < 2 * kC / 4, g2 = tm < D / 4;
  const float* work =
      p.work + static_cast<long long>(bh) * p.chunks * Work<D>::Per;
  const float* at_ = sm;                 // (D, 2C)
  const float* dec = sm + 2 * kC * D;    // (D,)
  float s_reg[4][8] = {};
  for (int idx = tid; idx < D * DS; idx += kThreads) S[idx] = 0.f;
  stage<D>(sm, work);
  // the tile's 8 columns of a row of width DS (two runs of 4)
  auto row8 = [&](const float* row, float (&x)[8]) {
    float lo[4], hi[4];
    ld(row + n0, lo);
    ld(row + kHalf + n0, hi);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      x[n] = lo[n];
      x[4 + n] = hi[n];
    }
  };
  for (int j = 0; j < p.chunks; ++j) {
    dhr::cp_async_wait_group<0>();
    __syncthreads();
    const float* src = work + static_cast<long long>(j) * Work<D>::Per;
    float d4[4];
    if (g2) ld(dec + 4 * tm, d4);
    if (g1) {
      const int m0 = 4 * tm;
      float acc[4][8] = {};
#pragma unroll 4
      for (int k = 0; k < D; ++k) {
        float a[4], s8[8];
        ld(at_ + k * 2 * kC + m0, a);
        row8(S + k * DS, s8);
        outer(acc, a, s8);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float y[8];
        row8(src + Work<D>::UO + (m0 + u) * D + slice * DS, y);
#pragma unroll
        for (int n = 0; n < 8; ++n) y[n] += acc[u][n];
        if (m0 < kC) {
          float lo[4] = {y[0], y[1], y[2], y[3]};
          float hi[4] = {y[4], y[5], y[6], y[7]};
          st(W + (m0 + u) * DS + n0, lo);
          st(W + (m0 + u) * DS + kHalf + n0, hi);
        } else {
          const long long t = static_cast<long long>(j) * kC + m0 - kC + u;
          if (t < p.length) {
            using T = typename dhr::Elem<K>::T;
            T lo[4], hi[4];
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              lo[n] = dhr::from_f32<K>(y[n]);
              hi[n] = dhr::from_f32<K>(y[4 + n]);
            }
            T* dst = static_cast<T*>(p.out) +
                     ((b * p.length + t) * p.heads + h) * D + c0;
            dhr::store_vec<T, 4>(dst, 4, lo);
            dhr::store_vec<T, 4>(dst + kHalf, 4, hi);
          }
        }
      }
    }
    __syncthreads();
    if (j + 1 < p.chunks) stage<D>(sm, src + Work<D>::Per);
    if (g2) {
      const int i0 = 4 * tm;
      const float* ks = src + Work<D>::KS;   // (C, D)
      float acc[4][8];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int n = 0; n < 8; ++n) acc[u][n] = s_reg[u][n] * d4[u];
      }
#pragma unroll 4
      for (int s = 0; s < kC; ++s) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(
            ks + s * D + i0));
        const float a4[4] = {a.x, a.y, a.z, a.w};
        float w8[8];
        row8(W + s * DS, w8);
        outer(acc, a4, w8);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float lo[4], hi[4];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          s_reg[u][n] = lo[n] = acc[u][n];
          s_reg[u][4 + n] = hi[n] = acc[u][4 + n];
        }
        st(S + (i0 + u) * DS + n0, lo);
        st(S + (i0 + u) * DS + kHalf + n0, hi);
      }
    }
  }
}

template <int D, int K>
cudaError_t launch(const Params& p, long long bh, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      local_kernel<D, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Local<D>::Smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(state_kernel<D, K>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           State<D>::Smem);
  if (e != cudaSuccess) return e;
  local_kernel<D, K><<<dim3(p.chunks, static_cast<unsigned>(bh)), kThreads,
                       Local<D>::Smem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  state_kernel<D, K><<<dim3(D / State<D>::DS, static_cast<unsigned>(bh)),
                       kThreads, State<D>::Smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_kind(int kind, const Params& p, long long bh,
                        cudaStream_t stream) {
  switch (kind) {
    case dhr::kBF16: return launch<D, dhr::kBF16>(p, bh, stream);
    case dhr::kF32: return launch<D, dhr::kF32>(p, bh, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Floats of scratch a passage-head of `length` positions needs at head
// dim d (0: a head dim the kernel does not take).
extern "C" long long kda_scan_work_floats(int head_dim, long long length) {
  const long long chunks = (length + kC - 1) / kC;
  switch (head_dim) {
    case 128: return chunks * Work<128>::Per;
    case 8: return chunks * Work<8>::Per;
    default: return 0;
  }
}

// C entry, bound with ctypes.  Device pointers: q, k, v of `kind` (bf16
// or f32) and g f32, each (B, L, h, d) at the element strides
// strides[0..3], [4..7], [8..11], [12..15] (b, t, h, channel); beta f32
// (B, L, h) at strides[16..18]; work f32 of B h
// kda_scan_work_floats(d, L) floats; out of `kind`, (B, L, h, d) contiguous.
// strides is a host array.  d is 128 or 8.  Launches two kernels on
// `stream`, allocates nothing, does not synchronise, and returns
// cudaGetLastError() after the launches.
extern "C" int kda_scan_launch(const void* q, const void* k, const void* v,
                               const void* g, const void* beta, void* work,
                               void* out, const long long* strides,
                               long long batch, long long length, int heads,
                               int head_dim, int kind, void* stream) {
  const long long chunks = (length + kC - 1) / kC;
  if (batch < 1 || length < 1 || heads < 1 || batch * heads > 65535 ||
      chunks > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.g = static_cast<const float*>(g);
  p.beta = static_cast<const float*>(beta);
  Strides* all[4] = {&p.sq, &p.sk, &p.sv, &p.sg};
  for (int n = 0; n < 4; ++n) {
    *all[n] = Strides{strides[4 * n], strides[4 * n + 1], strides[4 * n + 2],
                      strides[4 * n + 3]};
  }
  p.sbeta = Strides{strides[16], strides[17], strides[18], 0};
  p.work = static_cast<float*>(work);
  p.out = out;
  p.length = static_cast<int>(length);
  p.heads = heads;
  p.chunks = static_cast<int>(chunks);
  p.q_scale =
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(head_dim)));
  const long long bh = batch * heads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 128: return launch_kind<128>(kind, p, bh, st);
    case 8: return launch_kind<8>(kind, p, bh, st);
    default: return cudaErrorInvalidValue;
  }
}
