// K8: Mamba-2's chunked SSD scan (Nemotron-H's state-space mixer), for
// sm_90a.
//
// Replaces no Pallas kernel: the JAX package has no decoder.  It does all
// that the port's plain chunked scan (dhr_tpu_torch/models/decoder.py
// ssd_scan) computes from the convolution's outputs to y, which ran as ~30
// eager f32 passes a mixer over (c x c) decay matrices in device memory.
// For passage b, head h of group g, chunks of c positions, a = dt A (<= 0):
//
//   y_i = sum_{j <= i} (C_i . B_j) exp(a(j, i]) dt_j x_j       within
//       + exp(a[0, i]) C_i S                                   entering
//       + D x_i                                                skip
//   S' = exp(a[0, c-1]) S + sum_j B_j^T exp(a(j, c-1]) dt_j x_j
//
// with a(j, i] the a of positions j+1..i of the chunk summed, S the (N, P)
// state entering the chunk, 0 before the first.  Every product and sum is
// f32, by FFMA on the CUDA cores.
//
// Every decay is the exp of a sum of the a it spans, or a product of such
// factors, each <= 1; never a difference of two cumulative sums (a chunk's
// decay runs past -800, where the difference form loses ~5e-5 of the
// scale).  Positions are taken in blocks of 8.  Within a block the sums
// run position by position; across blocks the decay of (j, i] factors as
// exp(a(j, end of j's block]) exp(a over each whole block between)
// exp(a[start of i's block, i]): the column factor goes into the product's
// left operand, the whole blocks' factors are applied by Horner's rule to
// the running sum (times a block's factor, then plus that block's terms),
// the row factor at the end.  A factor that underflows does so only where
// the product is below 1e-38 of its term.
//
// What bounds it: the f32 FFMA rate.  At the Nemotron cell's 8 x 2,048, 64
// heads of 64, 8 groups of state 128, chunks of 128, a mixer is 1,024
// (chunk, group) pairs of ~27M FMA (C B^T once a group, then per head the
// chunk's own state, the within-chunk product and the entering state's
// output), ~0.83 ms at 67 TFLOP/s; its bytes (bf16 x, B, C, y, f32 dt)
// take ~0.1 ms, the f32 states passed between chunks (~250 MB written,
// read and written again, read) ~0.3 ms.  Three kernels, launched one
// after the other on the caller's stream:
// - chunk_states, one block a (chunk, passage-group), all chunks but the
//   last at once, two blocks to an SM (~107 KB of shared memory): B's tile
//   (position-major), then per head x scaled by dt_j exp(a(j, c-1]) and the
//   (N, P) product B^T x, each thread 8 x 4 of it, to an f32 scratch of
//   states (~250 MB at 8 x 2,048); the chunk's decay beside them;
// - pass_states, one thread four state entries of a passage-head, walks
//   the chunks in order: each slot becomes the state entering the next
//   chunk, in place;
// - chunk_out, one block a (chunk, passage-group), all chunks at once, one
//   block to an SM (~219 KB): C's and B's tiles channel-major, as the
//   convolution lays them out (16-byte runs of 8 positions where they are
//   aligned); C B^T's lower triangle (halves of 8 x 8 tiles spread over
//   all warps), computed once for the group's heads and kept packed; per
//   head x and x times the column factors (position-major), the diagonal
//   blocks of M = C B^T dt times their exact decays, and the entering
//   state (cp.async, issued during the previous head's product); then y =
//   Horner(C S; C B^T (x times the column factors)) times the row factors
//   + the diagonal blocks' terms + D x, each thread 4 rows of an early
//   block and 4 of the mirrored late block (so every warp does the same
//   work) by 4 columns.  y is written once, in x's dtype, in (B, L, h, P)
//   layout.
// x, B and C are read in place through their strides: the convolution's
// output is channel-major, a chunk of a channel one contiguous run.
// Positions past the length read as zeros (their dt is 0, so they change
// nothing) and are not written.
//
// Tried and dropped (one H100, 8 x 2,048 bf16): C B^T kept in registers
// through the heads and M = C B^T times every factor staged per head (255
// registers, spills, ~2.2k instructions a warp a head of staging: the
// output pass 1.43-1.65 ms against 1.01 now); the next head's state
// prefetched through registers (more spills); capping the output pass at
// 128 or 168 registers (spills in its loops: 2.28 and 1.87 ms).  Kept:
// the 16-byte runs of C and B in chunk_out; with the general loads alone
// chunk_out took 1.106 ms against 0.988 and K8 1.751 against 1.646 (median
// of 10 timings each, in turns, every one slower).

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

template <int P_, int N_, int C_, int R_>
struct Shape {
  static constexpr int P = P_;  // head dim
  static constexpr int N = N_;  // state size
  static constexpr int C = C_;  // chunk
  static constexpr int R = R_;  // heads a group
  static constexpr int NB = C / 8;                  // blocks of 8 positions
  static constexpr int Threads = NB * (P / 4);      // chunk_states, chunk_out
  static constexpr int Tiles = NB * (NB + 1) / 2;   // C B^T's lower tiles
  static_assert(C % 16 == 0 && N == C && 2 * P == C,
                "the tilings take N = C = 2 P");
  static_assert(R * NB <= Threads && Tiles <= Threads, "a task a thread");
};
using Nano = Shape<64, 128, 128, 8>;  // NVIDIA-Nemotron-3-Nano-30B-A3B
using Tiny = Shape<8, 16, 16, 2>;     // DecoderConfig.tiny_nemotron_h

constexpr int kPassThreads = 128;

struct Strides {
  long long b, t, h, c;  // elements
};

struct Params {
  const void* x;
  const void* B;
  const void* C;
  const float* dt;
  const float* A;
  const float* D;
  Strides sx, sB, sC, sdt;  // sdt.c unused
  float* states;  // (B h, chunks - 1, N, P): chunk j's own state, then the
                  // state entering chunk j + 1
  float* decay;   // (B h, chunks - 1): exp(a over chunk j)
  void* y;        // (B, L, h, P), contiguous
  int length, heads, groups, chunks;
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

// acc[u][k] += a[u] b[k]
__device__ __forceinline__ void outer(float (&acc)[4][4], const float (&a)[4],
                                      const float (&b)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[u][k] = fmaf(a[u], b[k], acc[u][k]);
  }
}

// A chunk's c positions x W channels of a strided input at (b, ., hg, .),
// the thread's share: element m at (r, i), consecutive threads on
// consecutive addresses of whichever dim has stride 1 (positions for the
// convolution's output).  Every load is unconditional (a position past
// `valid` reads the last valid one, then counts as 0), so all are in
// flight before any is used.
template <class S, int W>
struct Rows {
  static constexpr int M = S::C * W / S::Threads;
  static_assert((S::C * W) % S::Threads == 0, "whole shares");
  __device__ static void at(int m, bool pos_fast, int& r, int& i) {
    const int e = threadIdx.x + m * S::Threads;
    r = pos_fast ? e % S::C : e / W;
    i = pos_fast ? e / S::C : e % W;
  }
};

// The same by quads of channels (r, 4q..4q+3), for tiles stored
// position-major: a quad goes to shared memory as one 16-byte store.
template <class S, int W>
struct Quads {
  static constexpr int M = S::C * W / 4 / S::Threads;
  static_assert((S::C * W / 4) % S::Threads == 0 && W % 4 == 0,
                "whole shares");
  __device__ static void at(int m, bool pos_fast, int& r, int& q) {
    const int e = threadIdx.x + m * S::Threads;
    r = pos_fast ? e % S::C : e / (W / 4);
    q = pos_fast ? e / S::C : e % (W / 4);
  }
};

template <int K>
__device__ __forceinline__ const typename dhr::Elem<K>::T* origin(
    const void* src, const Strides& s, long long b, long long t0,
    long long hg) {
  return static_cast<const typename dhr::Elem<K>::T*>(src) + b * s.b +
         t0 * s.t + hg * s.h;
}

template <class S, int W, int K>
__device__ __forceinline__ void fetch_rows(
    typename dhr::Elem<K>::T (&raw)[Rows<S, W>::M], const void* src,
    const Strides& s, long long b, long long t0, long long hg, int valid) {
  const typename dhr::Elem<K>::T* p0 = origin<K>(src, s, b, t0, hg);
#pragma unroll
  for (int m = 0; m < Rows<S, W>::M; ++m) {
    int r, i;
    Rows<S, W>::at(m, s.t == 1, r, i);
    raw[m] = p0[(r < valid ? r : valid - 1) * s.t + i * s.c];
  }
}

// The same tile as runs of 8 positions of a channel, one 16-byte load each,
// where the input allows it: bf16, position stride 1, a whole chunk, and
// every run 16-byte aligned.
template <class S, int W>
struct Runs {
  static constexpr int M = S::C / 8 * W / S::Threads;
  static_assert((S::C / 8 * W) % S::Threads == 0, "whole shares");
  __device__ static void at(int m, int& r8, int& i) {
    const int e = threadIdx.x + m * S::Threads;
    r8 = e % (S::C / 8);
    i = e / (S::C / 8);
  }
};

template <class S, int K>
__device__ __forceinline__ bool runs_of_8(const void* src, const Strides& s,
                                          long long b, long long t0,
                                          long long hg, int valid) {
  if (K != dhr::kBF16 || s.t != 1 || valid != S::C || s.c % 8 != 0) {
    return false;
  }
  return reinterpret_cast<uintptr_t>(origin<K>(src, s, b, t0, hg)) % 16 == 0;
}

template <class S, int W, int K>
__device__ __forceinline__ void fetch_runs(uint4 (&raw)[Runs<S, W>::M],
                                           const void* src, const Strides& s,
                                           long long b, long long t0,
                                           long long hg) {
  const auto* p0 = origin<K>(src, s, b, t0, hg);
#pragma unroll
  for (int m = 0; m < Runs<S, W>::M; ++m) {
    int r8, i;
    Runs<S, W>::at(m, r8, i);
    raw[m] = *reinterpret_cast<const uint4*>(p0 + i * s.c + 8 * r8);
  }
}

// dst[i * pitch + 8 r8 + u] = x(8 r8 + u, i), from bf16 runs.
template <class S, int W>
__device__ __forceinline__ void put_runs(float* dst, int pitch,
                                         const uint4 (&raw)[Runs<S, W>::M]) {
#pragma unroll
  for (int m = 0; m < Runs<S, W>::M; ++m) {
    int r8, i;
    Runs<S, W>::at(m, r8, i);
    const uint32_t w[4] = {raw[m].x, raw[m].y, raw[m].z, raw[m].w};
    float lo[4], hi[4];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      lo[2 * k] = __uint_as_float(w[k] << 16);
      lo[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
      hi[2 * k] = __uint_as_float(w[2 + k] << 16);
      hi[2 * k + 1] = __uint_as_float(w[2 + k] & 0xffff0000u);
    }
    st(dst + i * pitch + 8 * r8, lo);
    st(dst + i * pitch + 8 * r8 + 4, hi);
  }
}

// dst[i * pitch + r] = x(r, i): channel-major.
template <class S, int W, int K>
__device__ __forceinline__ void put_rows(
    float* dst, int pitch,
    const typename dhr::Elem<K>::T (&raw)[Rows<S, W>::M], const Strides& s,
    int valid) {
#pragma unroll
  for (int m = 0; m < Rows<S, W>::M; ++m) {
    int r, i;
    Rows<S, W>::at(m, s.t == 1, r, i);
    dst[i * pitch + r] = r < valid ? dhr::to_f32<K>(raw[m]) : 0.f;
  }
}

template <class S, int W, int K>
__device__ __forceinline__ void fetch_quads(
    typename dhr::Elem<K>::T (&raw)[Quads<S, W>::M][4], const void* src,
    const Strides& s, long long b, long long t0, long long hg, int valid) {
  const typename dhr::Elem<K>::T* p0 = origin<K>(src, s, b, t0, hg);
#pragma unroll
  for (int m = 0; m < Quads<S, W>::M; ++m) {
    int r, q;
    Quads<S, W>::at(m, s.t == 1, r, q);
    const auto* e = p0 + (r < valid ? r : valid - 1) * s.t + 4 * q * s.c;
#pragma unroll
    for (int k = 0; k < 4; ++k) raw[m][k] = e[k * s.c];
  }
}

// dst[r * pitch + 4 q + k] = x(r, 4 q + k) * (scale ? scale[r] : 1):
// position-major.
template <class S, int W, int K>
__device__ __forceinline__ void put_quads(
    float* dst, int pitch,
    const typename dhr::Elem<K>::T (&raw)[Quads<S, W>::M][4],
    const Strides& s, int valid, const float* scale) {
#pragma unroll
  for (int m = 0; m < Quads<S, W>::M; ++m) {
    int r, q;
    Quads<S, W>::at(m, s.t == 1, r, q);
    const float f = r < valid ? (scale ? scale[r] : 1.f) : 0.f;
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = dhr::to_f32<K>(raw[m][k]) * f;
    st(dst + r * pitch + 4 * q, v);
  }
}

// dt of head h at the 8 positions of block blk, 0 past `valid`.
__device__ __forceinline__ void fetch_dt(float (&d)[8], const Params& p,
                                         long long b, long long t0, int h,
                                         int blk, int valid) {
  const float* d0 = p.dt + b * p.sdt.b + h * p.sdt.h;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int r = 8 * blk + u;
    d[u] = r < valid ? d0[(t0 + r) * p.sdt.t] : 0.f;
  }
}

__device__ __forceinline__ int chunk_valid(const Params& p, long long t0,
                                           int c) {
  return p.length - t0 < c ? static_cast<int>(p.length - t0) : c;
}

// chunk_states' shared memory, in floats: B (c, N), x scaled (c, P), the
// heads' weights dt_j exp(a(j, c-1]) and their blocks' sums of a.
template <class S>
struct States {
  static constexpr int BP = S::N + 4, XP = S::P + 4;
  static constexpr int Bs = 0, Xs = Bs + S::C * BP, W = Xs + S::C * XP;
  static constexpr int Bsum = W + S::R * S::C;
  static constexpr int Smem = (Bsum + S::R * S::NB) * 4;
};

// Each chunk's own state B^T (exp(a(j, c-1]) dt x) and decay exp(a over
// the chunk), for every chunk but the last; two blocks to an SM.
template <class S, int K>
__global__ void __launch_bounds__(S::Threads, 2)
    chunk_states(const Params p) {
  using L = States<S>;
  using T = typename dhr::Elem<K>::T;
  extern __shared__ __align__(16) float sm[];
  float* Bs = sm + L::Bs;
  float* Xs = sm + L::Xs;
  float* w = sm + L::W;
  float* bsum = sm + L::Bsum;
  const int tid = threadIdx.x, chunk = blockIdx.x % (p.chunks - 1);
  const long long bg = blockIdx.x / (p.chunks - 1);
  const long long b = bg / p.groups;
  const int grp = bg % p.groups, h0 = grp * S::R;
  const long long t0 = static_cast<long long>(chunk) * S::C;
  const int valid = chunk_valid(p, t0, S::C);

  T rx[Quads<S, S::P>::M][4];
  {
    T rb[Quads<S, S::N>::M][4];
    fetch_quads<S, S::N, K>(rb, p.B, p.sB, b, t0, grp, valid);
    fetch_quads<S, S::P, K>(rx, p.x, p.sx, b, t0, h0, valid);
    put_quads<S, S::N, K>(Bs, L::BP, rb, p.sB, valid, nullptr);
  }
  // (head, block) tasks: a summed over each position's rest of its block,
  // and over the block
  const bool task = tid < S::R * S::NB;
  const int th = tid / S::NB, tb = tid % S::NB;
  float d8[8], suf[8];
  if (task) {
    fetch_dt(d8, p, b, t0, h0 + th, tb, valid);
    const float Ah = p.A[h0 + th];
    float run = 0.f;
#pragma unroll
    for (int u = 7; u >= 0; --u) {
      suf[u] = run;
      run += d8[u] * Ah;
    }
    bsum[th * S::NB + tb] = run;
  }
  __syncthreads();
  if (task) {
    float later = 0.f;  // a over the blocks after this one
    for (int k = tb + 1; k < S::NB; ++k) later += bsum[th * S::NB + k];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      w[th * S::C + 8 * tb + u] = d8[u] * expf(suf[u] + later);
    }
    if (tb == 0) {
      p.decay[(b * p.heads + h0 + th) * (p.chunks - 1) + chunk] =
          expf(bsum[th * S::NB] + later);
    }
  }
  __syncthreads();
  const int n0 = 8 * (tid / (S::P / 4)), p0 = 4 * (tid % (S::P / 4));
  for (int hh = 0; hh < S::R; ++hh) {
    put_quads<S, S::P, K>(Xs, L::XP, rx, p.sx, valid, w + hh * S::C);
    __syncthreads();
    if (hh + 1 < S::R) {
      fetch_quads<S, S::P, K>(rx, p.x, p.sx, b, t0, h0 + hh + 1, valid);
    }
    float lo[4][4] = {}, hi[4][4] = {};
#pragma unroll 4
    for (int t = 0; t < S::C; ++t) {
      float b0[4], b1[4], x4[4];
      ld(Bs + t * L::BP + n0, b0);
      ld(Bs + t * L::BP + n0 + 4, b1);
      ld(Xs + t * L::XP + p0, x4);
      outer(lo, b0, x4);
      outer(hi, b1, x4);
    }
    float* dst =
        p.states +
        ((b * p.heads + h0 + hh) * (p.chunks - 1) + chunk) * (S::N * S::P) +
        n0 * S::P + p0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      st(dst + u * S::P, lo[u]);
      st(dst + (4 + u) * S::P, hi[u]);
    }
    __syncthreads();
  }
}

// The states passed from chunk to chunk, in place: slot j becomes the
// state entering chunk j + 1, exp(a over chunk j) times the one entering
// chunk j plus chunk j's own.  A thread takes 4 entries of a passage-head.
template <class S>
__global__ void __launch_bounds__(kPassThreads) pass_states(const Params p) {
  constexpr int kVec = S::N * S::P / 4;
  constexpr int kBlocks = (kVec + kPassThreads - 1) / kPassThreads;
  const int q = blockIdx.x % kBlocks * kPassThreads + threadIdx.x;
  if (q >= kVec) return;
  const long long bh = blockIdx.x / kBlocks;
  const int n = p.chunks - 1;
  float4* slot = reinterpret_cast<float4*>(p.states) + bh * n * kVec + q;
  const float* dec = p.decay + bh * n;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 own = slot[0];
  for (int j = 0; j < n; ++j) {
    const float4 next = j + 1 < n ? slot[static_cast<long long>(j + 1) * kVec]
                                  : own;
    const float d = dec[j];
    s = make_float4(fmaf(d, s.x, own.x), fmaf(d, s.y, own.y),
                    fmaf(d, s.z, own.z), fmaf(d, s.w, own.w));
    slot[static_cast<long long>(j) * kVec] = s;
    own = next;
  }
}

// chunk_out's shared memory, in floats: C (N, c); B (N, c) during the
// prologue, then C B^T's lower triangle (packed) and the entering state
// (N, P); x and x times the column factors (c, P); the diagonal blocks'
// M (NB, 8, 8); the heads' scalars (dt, column factors, row factors,
// blocks' factors).
template <class S>
struct Out {
  static constexpr int CP = S::C + 4, SP = S::P + 4;
  static constexpr int CBFloats = 8 * S::NB * S::C - 32 * S::NB * (S::NB - 1);
  static constexpr int Ct = 0;
  static constexpr int Stage = Ct + S::N * CP;  // B, then C B^T and S
  static constexpr int CB = Stage, St = Stage + CBFloats;
  static constexpr int StageFloats = S::N * CP > CBFloats + S::N * SP
                                         ? S::N * CP
                                         : CBFloats + S::N * SP;
  static constexpr int X = Stage + StageFloats;
  static constexpr int Xq = X + S::C * SP;
  static constexpr int Md = Xq + S::C * SP;
  static constexpr int Sc = Md + S::NB * 64;
  static constexpr int ScPer = 3 * S::C + S::NB;  // dt, colf, rowf, e
  static constexpr int DT = 0, COLF = S::C, ROWF = 2 * S::C, E = 3 * S::C;
  static constexpr int Smem = (Sc + S::R * ScPer) * 4;
  // C B^T's row j (a position), columns 8 (j / 8) .. c - 1 (positions i
  // >= j's block), at row(j); each row 16-byte aligned
  __device__ static int row(int j) {
    const int J = j / 8;
    return 8 * S::C * J - 32 * J * (J - 1) + (j % 8) * (S::C - 8 * J);
  }
};

// The diagonal blocks of head hh's M: M[j][i] = (C_i . B_j) dt_j exp(a(j,
// i]) for j <= i in one block of 8 (a(j, i] summed position by position),
// 0 for j > i; at Md[(8 blk + j % 8) 8 + i % 8].
template <class S>
__device__ __forceinline__ void stage_diag(float* Md, const float* CBp,
                                           const float* sc, float Ah) {
  using L = Out<S>;
  for (int it = threadIdx.x; it < S::NB * 16; it += S::Threads) {
    const int blk = it / 16, v = (it / 2) % 8, q = it % 2;
    const int j = 8 * blk + v, i0 = 8 * blk + 4 * q;
    float cb4[4], m4[4];
    ld(CBp + L::row(j) + 4 * q, cb4);
    const float d = sc[L::DT + j];
    float run = 0.f;  // a over (j, i]
    for (int r = j + 1; r < i0; ++r) run += sc[L::DT + r] * Ah;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u;
      if (i > j) run += sc[L::DT + i] * Ah;
      m4[u] = i < j ? 0.f : cb4[u] * d * expf(run);
    }
    st(Md + 8 * (8 * blk + v) + 4 * q, m4);
  }
}

// acc += Md[block blk][., the thread's 4 rows from r0] x[., p0..p0+3]
template <class S>
__device__ __forceinline__ void diag_terms(float (&acc)[4][4], const float* Md,
                                           const float* Xs, int blk, int r0,
                                           int p0) {
  using L = Out<S>;
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    float m4[4], x4[4];
    ld(Md + 8 * (8 * blk + v) + r0 - 8 * blk, m4);
    ld(Xs + (8 * blk + v) * L::SP + p0, x4);
    outer(acc, m4, x4);
  }
}

template <class S, int K>
__device__ __forceinline__ void store_y(const Params& p,
                                        const float (&acc)[4][4], long long b,
                                        long long t0, int r0, int valid, int h,
                                        int p0) {
  using T = typename dhr::Elem<K>::T;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (r0 + u >= valid) continue;
    T o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = dhr::from_f32<K>(acc[u][k]);
    T* dst = static_cast<T*>(p.y) +
             ((b * p.length + t0 + r0 + u) * p.heads + h) * S::P + p0;
    dhr::store_vec<T, 4>(dst, 4, o);
  }
}

// The state entering the chunk for head h into dst (N, P) by cp.async
// (read-only here: pass_states wrote it).
template <class S>
__device__ __forceinline__ void fetch_state(float* dst, const Params& p,
                                            long long b, int h, int chunk) {
  const float* src =
      p.states +
      ((b * p.heads + h) * (p.chunks - 1) + chunk - 1) * (S::N * S::P);
  for (int q = threadIdx.x; q < S::N * S::P / 4; q += S::Threads) {
    const int n = q / (S::P / 4), c4 = q % (S::P / 4);
    dhr::cp_async16(dst + n * Out<S>::SP + 4 * c4, src + 4 * q, 16);
  }
  dhr::cp_async_commit();
}

// x, and x times the column factors dt_r exp(a(r, end of r's block]).
template <class S, int K>
__device__ __forceinline__ void put_x(
    float* Xs, float* Xq,
    const typename dhr::Elem<K>::T (&raw)[Quads<S, S::P>::M][4],
    const Strides& s, int valid, const float* colf) {
  using L = Out<S>;
#pragma unroll
  for (int m = 0; m < Quads<S, S::P>::M; ++m) {
    int r, q;
    Quads<S, S::P>::at(m, s.t == 1, r, q);
    const bool in = r < valid;
    const float f = colf[r];
    float v[4], w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = in ? dhr::to_f32<K>(raw[m][k]) : 0.f;
      w[k] = v[k] * f;
    }
    st(Xs + r * L::SP + 4 * q, v);
    st(Xq + r * L::SP + 4 * q, w);
  }
}

// acc *= f
__device__ __forceinline__ void scale(float (&acc)[4][4], float f) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[u][c] *= f;
  }
}

// y of one (chunk, passage-group), all its heads; one block to an SM.
template <class S, int K>
__global__ void __launch_bounds__(S::Threads, 1) chunk_out(const Params p) {
  using L = Out<S>;
  using T = typename dhr::Elem<K>::T;
  extern __shared__ __align__(16) float sm[];
  float* Ct = sm + L::Ct;
  float* Bt = sm + L::Stage;
  float* CBp = sm + L::CB;
  float* Ss = sm + L::St;
  float* Xs = sm + L::X;
  float* Xq = sm + L::Xq;
  float* Md = sm + L::Md;
  const int tid = threadIdx.x, chunk = blockIdx.x % p.chunks;
  const long long bg = blockIdx.x / p.chunks;
  const long long b = bg / p.groups;
  const int grp = bg % p.groups, h0 = grp * S::R;
  const long long t0 = static_cast<long long>(chunk) * S::C;
  const int valid = chunk_valid(p, t0, S::C);
  const bool entering = chunk > 0;

  // P0: C and B channel-major; head 0's x in flight; the heads' scalars
  T rx[Quads<S, S::P>::M][4];
  if (runs_of_8<S, K>(p.C, p.sC, b, t0, grp, valid) &&
      runs_of_8<S, K>(p.B, p.sB, b, t0, grp, valid)) {
    uint4 rc[Runs<S, S::N>::M], rb[Runs<S, S::N>::M];
    fetch_runs<S, S::N, K>(rc, p.C, p.sC, b, t0, grp);
    fetch_runs<S, S::N, K>(rb, p.B, p.sB, b, t0, grp);
    fetch_quads<S, S::P, K>(rx, p.x, p.sx, b, t0, h0, valid);
    put_runs<S, S::N>(Ct, L::CP, rc);
    put_runs<S, S::N>(Bt, L::CP, rb);
  } else {
    T rc[Rows<S, S::N>::M], rb[Rows<S, S::N>::M];
    fetch_rows<S, S::N, K>(rc, p.C, p.sC, b, t0, grp, valid);
    fetch_rows<S, S::N, K>(rb, p.B, p.sB, b, t0, grp, valid);
    fetch_quads<S, S::P, K>(rx, p.x, p.sx, b, t0, h0, valid);
    put_rows<S, S::N, K>(Ct, L::CP, rc, p.sC, valid);
    put_rows<S, S::N, K>(Bt, L::CP, rb, p.sB, valid);
  }
  if (tid < S::R * S::NB) {
    const int th = tid / S::NB, tb = tid % S::NB;
    float d8[8];
    fetch_dt(d8, p, b, t0, h0 + th, tb, valid);
    const float Ah = p.A[h0 + th];
    float* sc = sm + L::Sc + th * L::ScPer;
    float run = 0.f;  // a over [start of the block, r]
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      sc[L::DT + 8 * tb + u] = d8[u];
      run += d8[u] * Ah;
      sc[L::ROWF + 8 * tb + u] = expf(run);
    }
    sc[L::E + tb] = expf(run);
    run = 0.f;  // a over (r, end of the block]
#pragma unroll
    for (int u = 7; u >= 0; --u) {
      sc[L::COLF + 8 * tb + u] = d8[u] * expf(run);
      run += d8[u] * Ah;
    }
  }
  __syncthreads();

  // P1: C B^T's lower 8 x 8 tiles by halves of 4 rows, packed (over B,
  // once B is read): at most two halves a thread, every warp busy
  {
    constexpr int kRounds = (2 * S::Tiles + S::Threads - 1) / S::Threads;
    static_assert(kRounds <= 2, "two halves a thread at most");
    float cb[kRounds][4][8] = {};
    int i0[kRounds], tj[kRounds];
#pragma unroll
    for (int n0 = 0; n0 < kRounds; ++n0) {
      const int task = tid + n0 * S::Threads;
      i0[n0] = -1;
      tj[n0] = 0;
      if (task >= 2 * S::Tiles) continue;
      int k = task / 2, j = 0;
      while (k >= S::NB - j) {
        k -= S::NB - j;
        ++j;
      }
      tj[n0] = j;
      i0[n0] = 8 * (j + k) + 4 * (task % 2);
#pragma unroll 2
      for (int n = 0; n < S::N; ++n) {
        float c4[4], b0[4], b1[4];
        ld(Ct + n * L::CP + i0[n0], c4);
        ld(Bt + n * L::CP + 8 * j, b0);
        ld(Bt + n * L::CP + 8 * j + 4, b1);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            cb[n0][u][v] = fmaf(c4[u], b0[v], cb[n0][u][v]);
            cb[n0][u][4 + v] = fmaf(c4[u], b1[v], cb[n0][u][4 + v]);
          }
        }
      }
    }
    __syncthreads();  // B's tile is no longer read
#pragma unroll
    for (int n0 = 0; n0 < kRounds; ++n0) {
      if (i0[n0] < 0) continue;
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const float c4[4] = {cb[n0][0][v], cb[n0][1][v], cb[n0][2][v],
                             cb[n0][3][v]};
        st(CBp + L::row(8 * tj[n0] + v) + i0[n0] - 8 * tj[n0], c4);
      }
    }
    __syncthreads();
  }
  if (entering) fetch_state<S>(Ss, p, b, h0, chunk);

  // P2: per head, x (plain and scaled), the diagonal blocks' M and the
  // entering state staged; then each thread 4 rows of block I and 4 of
  // block NB-1-I by 4 columns
  const int slot = tid / (S::P / 4), p0 = 4 * (tid % (S::P / 4));
  const int I = slot / 2, IB = S::NB - 1 - I;
  const int rA = 8 * I + 4 * (slot % 2), rB = 8 * IB + 4 * (slot % 2);
  for (int hh = 0; hh < S::R; ++hh) {
    const int h = h0 + hh;
    const float* sc = sm + L::Sc + hh * L::ScPer;
    put_x<S, K>(Xs, Xq, rx, p.sx, valid, sc + L::COLF);
    stage_diag<S>(Md, CBp, sc, p.A[h]);
    dhr::cp_async_wait_all();
    __syncthreads();
    if (hh + 1 < S::R) {
      fetch_quads<S, S::P, K>(rx, p.x, p.sx, b, t0, h + 1, valid);
    }
    float accA[4][4] = {}, accB[4][4] = {};
    if (entering) {  // C S, then the next head's state in flight
#pragma unroll 4
      for (int n = 0; n < S::N; ++n) {
        float ca[4], cb4[4], s4[4];
        ld(Ct + n * L::CP + rA, ca);
        ld(Ct + n * L::CP + rB, cb4);
        ld(Ss + n * L::SP + p0, s4);
        outer(accA, ca, s4);
        outer(accB, cb4, s4);
      }
      __syncthreads();
      if (hh + 1 < S::R) fetch_state<S>(Ss, p, b, h + 1, chunk);
    }
    // Horner over the whole blocks before each row's own: times the
    // block's factor, plus its terms C B^T (x times the column factors);
    // both row groups up to block I, then the late one alone
    for (int k = 0; k < IB; ++k) {
      const float e = sc[L::E + k];
      const float* m0 = CBp + L::row(8 * k) - 8 * k;
      const int stride = S::C - 8 * k;
      scale(accB, e);
      if (k < I) {
        scale(accA, e);
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          float x4[4], ma[4], mb[4];
          ld(Xq + (8 * k + v) * L::SP + p0, x4);
          ld(m0 + v * stride + rA, ma);
          ld(m0 + v * stride + rB, mb);
          outer(accA, ma, x4);
          outer(accB, mb, x4);
        }
      } else {
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          float x4[4], mb[4];
          ld(Xq + (8 * k + v) * L::SP + p0, x4);
          ld(m0 + v * stride + rB, mb);
          outer(accB, mb, x4);
        }
      }
    }
    // the rows' own factors, their blocks' diagonal terms, the skip
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float fa = sc[L::ROWF + rA + u], fb = sc[L::ROWF + rB + u];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        accA[u][c] *= fa;
        accB[u][c] *= fb;
      }
    }
    diag_terms<S>(accA, Md, Xs, I, rA, p0);
    diag_terms<S>(accB, Md, Xs, IB, rB, p0);
    const float Dh = p.D[h];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float xa[4], xb[4];
      ld(Xs + (rA + u) * L::SP + p0, xa);
      ld(Xs + (rB + u) * L::SP + p0, xb);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        accA[u][c] = fmaf(Dh, xa[c], accA[u][c]);
        accB[u][c] = fmaf(Dh, xb[c], accB[u][c]);
      }
    }
    store_y<S, K>(p, accA, b, t0, rA, valid, h, p0);
    store_y<S, K>(p, accB, b, t0, rB, valid, h, p0);
    __syncthreads();  // x and M's diagonal are no longer read
  }
}

template <class S, int K>
cudaError_t launch(const Params& p, long long bg, long long bh,
                   cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      chunk_states<S, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      States<S>::Smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(chunk_out<S, K>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Out<S>::Smem);
  if (e != cudaSuccess) return e;
  // one grid dim each (chunks fastest), so no passage count meets the
  // 65,535 of a second one
  constexpr long long kPass =
      (S::N * S::P / 4 + kPassThreads - 1) / kPassThreads;
  if (p.chunks * bg > 0x7fffffffLL || kPass * bh > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  if (p.chunks > 1) {
    chunk_states<S, K><<<static_cast<unsigned>((p.chunks - 1) * bg),
                         S::Threads, States<S>::Smem, stream>>>(p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    pass_states<S><<<static_cast<unsigned>(kPass * bh), kPassThreads, 0,
                     stream>>>(p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  chunk_out<S, K><<<static_cast<unsigned>(p.chunks * bg), S::Threads,
                    Out<S>::Smem, stream>>>(p);
  return cudaGetLastError();
}

template <class S>
cudaError_t launch_kind(int kind, const Params& p, long long bg, long long bh,
                        cudaStream_t stream) {
  switch (kind) {
    case dhr::kBF16: return launch<S, dhr::kBF16>(p, bg, bh, stream);
    case dhr::kF32: return launch<S, dhr::kF32>(p, bg, bh, stream);
    default: return cudaErrorInvalidValue;
  }
}

// 1: Nano, 2: Tiny, 0: a shape the kernel does not take.
int which(int head_dim, int state, int chunk, int per_group) {
  if (head_dim == Nano::P && state == Nano::N && chunk == Nano::C &&
      per_group == Nano::R) {
    return 1;
  }
  if (head_dim == Tiny::P && state == Tiny::N && chunk == Tiny::C &&
      per_group == Tiny::R) {
    return 2;
  }
  return 0;
}

}  // namespace

// Floats of scratch a passage-head of `length` positions needs (the states
// of every chunk but the last and their decays), or -1 for a shape the
// kernel does not take.
extern "C" long long ssd_scan_work_floats(int head_dim, int state, int chunk,
                                          int per_group, long long length) {
  if (!which(head_dim, state, chunk, per_group) || chunk < 1) return -1;
  const long long chunks = (length + chunk - 1) / chunk;
  return chunks > 1 ? (chunks - 1) * (1LL * state * head_dim + 1) : 0;
}

// C entry, bound with ctypes.  Device pointers: x (B, L, h, P), B and C
// (B, L, g, N) of `kind` (bf16 or f32) at the element strides
// strides[0..3], [4..7], [8..11] (b, t, head or group, channel); dt f32 (B,
// L, h) at strides[12..14]; A and D f32 (h,), contiguous; work f32 of B h
// ssd_scan_work_floats(...) floats; y of `kind`, (B, L, h, P) contiguous.
// strides is a host array.  (P, N, chunk, h / g) is (64, 128, 128, 8) or
// (8, 16, 16, 2).  Launches up to three kernels on `stream`, allocates
// nothing, does not synchronise, and returns cudaGetLastError() after the
// launches.
extern "C" int ssd_scan_launch(const void* x, const void* B, const void* C,
                               const void* dt, const void* A, const void* D,
                               void* work, void* y,
                               const long long* strides, long long batch,
                               long long length, int heads, int groups,
                               int head_dim, int state, int chunk, int kind,
                               void* stream) {
  if (batch < 1 || length < 1 || groups < 1 || heads % groups != 0) {
    return cudaErrorInvalidValue;
  }
  const int shape = which(head_dim, state, chunk, heads / groups);
  const long long chunks = (length + chunk - 1) / chunk;
  if (!shape || chunks > 0x7fffffffLL) return cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.B = B;
  p.C = C;
  p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.D = static_cast<const float*>(D);
  Strides* all[3] = {&p.sx, &p.sB, &p.sC};
  for (int n = 0; n < 3; ++n) {
    *all[n] = Strides{strides[4 * n], strides[4 * n + 1], strides[4 * n + 2],
                      strides[4 * n + 3]};
  }
  p.sdt = Strides{strides[12], strides[13], strides[14], 0};
  const long long bh = batch * heads;
  p.states = static_cast<float*>(work);
  p.decay = p.states + bh * (chunks - 1) * (1LL * state * head_dim);
  p.y = y;
  p.length = static_cast<int>(length);
  p.heads = heads;
  p.groups = groups;
  p.chunks = static_cast<int>(chunks);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long bg = batch * groups;
  return shape == 1 ? launch_kind<Nano>(kind, p, bg, bh, st)
                    : launch_kind<Tiny>(kind, p, bg, bh, st);
}
