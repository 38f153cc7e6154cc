// K4: the lexical head's pool over the vocabulary plane, for sm_90a.
//
// Replaces no Pallas kernel.  It does the work that XLA fuses in the
// reference's lexical head (dhr_tpu/models/retrievers.py:165-171: the f32
// softmax over the vocabulary, the term weighting and the max over
// positions), which the port ran as separate eager passes over the
// (B, L-1, V) logits plane.  For passage b, position t and vocabulary
// entry v, with x the projection (the MLM head's output before its bias):
//
//   y[b, t, v]    = round_to_kind(x[b, t, v] + bias[v])       (f32 sum)
//   m[b, t]       = max_v y[b, t, v]
//   s[b, t]       = sum_v exp(y[b, t, v] - m[b, t])           (f32)
//   out[b, v]     = max_t exp(y[b, t, v] - m[b, t]) * (w[b, t] / s[b, t])
//
// which is max_t softmax(y)[b, t, v] * w[b, t] (w = term weight * mask).
// y rounds to the projection's kind as the port's bias add does, so the
// logits are bit for bit the ones the eager passes see; the softmax and
// the weighting are f32.  A position whose weight is zero (a masked one)
// contributes exp(...) * w = w (+0 or -0) to every entry: it is never
// read, and w is folded into the max.  Sums are taken in the kernel's own
// order: within 3e-5 relative of the plain version.
//
// What bounds it: bytes.  The plane is bf16, ~1.2 GB for 256 passages of
// ~78 positions (0.36 ms a read at 3.35 TB/s), against ~0.6 G exponentials
// and ~6 GFLOP of f32 work a pass (~0.1 ms at 67 TFLOP/s); the eager
// passes wrote and read an f32 copy of it four more times.  Design against
// that: two passes, each a kernel that reads the bf16 plane once, and no
// f32 plane anywhere:
// - stats: one warp a position, its row streamed in pairs of elements
//   (4-byte loads for 16-bit kinds: a row pitch of 30,522 elements is not
//   a multiple of 8, so rows are not 16-byte aligned, but they are 4-byte
//   aligned), an online max and sum of exponentials per lane, rescaled once
//   per group of 2 x kStatUnroll elements, then a warp reduction; it writes
//   m and c = w / s per position;
// - pool: one block a (vocabulary strip of 1,024 entries, passage); the
//   block lists the passage's positions of nonzero weight in shared memory
//   (a ballot a 32 positions), each thread holds its entries' bias and
//   running max in registers, and walks the listed positions kPoolUnroll
//   at a time, each row's strip read once, coalesced; it writes its strip
//   of out once.
// Loads of the plane are evict-first (__ldcs): it is read once a pass and
// is far larger than L2.  Any B, positions and V; pairs where the pointers,
// both strides and V are even, single elements otherwise.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kStatThreads = 256;  // 8 warps: 8 positions a block
constexpr int kStatUnroll = 8;     // pairs a lane loads before it reduces
constexpr int kPoolThreads = 256;
constexpr int kPoolPer = 2;        // pairs (or elements) a thread owns
constexpr int kPoolUnroll = 4;     // rows in flight a thread
constexpr int kChunk = 512;        // positions listed at a time

__device__ __forceinline__ float neg_inf() {
  return __uint_as_float(0xff800000u);
}

// f32 of the projection's kind K after a sum taken in f32 (round to
// nearest even), as PyTorch's add of two tensors of that kind rounds.
template <int K> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<dhr::kBF16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
template <> __device__ __forceinline__ float round_to<dhr::kF16>(float x) {
  return __half2float(__float2half_rn(x));
}
template <> __device__ __forceinline__ float round_to<dhr::kF32>(float x) {
  return x;
}

// VEC consecutive elements of kind K at p (aligned to VEC elements) as
// f32, with one load; STREAM: evict-first (the plane), else read-only
// cached (the bias).
template <int K, int VEC, bool STREAM>
__device__ __forceinline__ void load_f32(const typename dhr::Elem<K>::T* p,
                                         float (&x)[VEC]) {
  using T = typename dhr::Elem<K>::T;
  if constexpr (VEC == 1) {
    const T v = STREAM ? __ldcs(p) : __ldg(p);
    x[0] = dhr::to_f32<K>(v);
  } else if constexpr (K == dhr::kF32) {
    const float2* q = reinterpret_cast<const float2*>(p);
    const float2 v = STREAM ? __ldcs(q) : __ldg(q);
    x[0] = v.x;
    x[1] = v.y;
  } else {
    const unsigned int* q = reinterpret_cast<const unsigned int*>(p);
    const unsigned int v = STREAM ? __ldcs(q) : __ldg(q);
    x[0] = dhr::to_f32<K>(static_cast<uint16_t>(v & 0xffffu));
    x[1] = dhr::to_f32<K>(static_cast<uint16_t>(v >> 16));
  }
}

// Pass 1: m and c = w / s of each position (row = b * n_pos + t).
template <int K, int VEC>
__global__ void __launch_bounds__(kStatThreads)
stats_kernel(const typename dhr::Elem<K>::T* __restrict__ proj,
             const typename dhr::Elem<K>::T* __restrict__ bias,
             const float* __restrict__ weight, float* __restrict__ row_max,
             float* __restrict__ row_scale, int64_t n_rows, int n_pos,
             int vocab, int64_t stride_b, int64_t stride_t) {
  const int lane = threadIdx.x % 32;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kStatThreads / 32) +
                      threadIdx.x / 32;
  if (row >= n_rows) return;
  const float w = weight[row];
  if (w == 0.f) {  // every product is w's zero: nothing to read
    if (lane == 0) {
      row_max[row] = 0.f;
      row_scale[row] = w;
    }
    return;
  }
  const auto* x = proj + (row / n_pos) * stride_b + (row % n_pos) * stride_t;
  constexpr int kStep = 32 * VEC;  // elements a warp covers per load
  float m = neg_inf(), s = 0.f;
  for (int c0 = VEC * lane; c0 < vocab; c0 += kStep * kStatUnroll) {
    float y[kStatUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kStatUnroll; ++u) {
      const int c = c0 + u * kStep;
      if (c < vocab) {
        float b[VEC];
        load_f32<K, VEC, true>(x + c, y[u]);
        load_f32<K, VEC, false>(bias + c, b);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          y[u][e] = round_to<K>(__fadd_rn(y[u][e], b[e]));
        }
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) y[u][e] = neg_inf();
      }
    }
    float top = m;
#pragma unroll
    for (int u = 0; u < kStatUnroll; ++u) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) top = fmaxf(top, y[u][e]);
    }
    if (top == neg_inf()) continue;  // nothing read yet (or all -inf)
    // the group's own sum first, so that a lane's error grows with its
    // groups (~V / 512), not its elements
    float g = 0.f;
#pragma unroll
    for (int u = 0; u < kStatUnroll; ++u) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) g += expf(y[u][e] - top);
    }
    s = s * expf(m - top) + g;  // s is 0 while m is -inf
    m = top;
  }
  float top = m;
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, off));
  }
  s = m == neg_inf() ? 0.f : s * expf(m - top);
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
  }
  if (lane == 0) {
    row_max[row] = top;
    row_scale[row] = w / s;
  }
}

// Pass 2: out[b, strip] = max over positions of exp(y - m) * c.
template <int K, int VEC>
__global__ void __launch_bounds__(kPoolThreads)
pool_kernel(const typename dhr::Elem<K>::T* __restrict__ proj,
            const typename dhr::Elem<K>::T* __restrict__ bias,
            const float* __restrict__ row_max,
            const float* __restrict__ row_scale, float* __restrict__ out,
            int n_pos, int vocab, int64_t stride_b, int64_t stride_t) {
  __shared__ int s_t[kChunk];
  __shared__ float s_m[kChunk];
  __shared__ float s_c[kChunk];
  __shared__ int s_n;
  __shared__ float s_zero;

  const int64_t b = blockIdx.y;
  const int lane = threadIdx.x % 32;
  constexpr int kStrip = kPoolThreads * kPoolPer * VEC;
  const int strip0 = blockIdx.x * kStrip;
  const auto* xb = proj + b * stride_b;

  // this thread's entries: pair p at column col[p]
  int col[kPoolPer];
  float bb[kPoolPer][VEC];
  float acc[kPoolPer][VEC];
#pragma unroll
  for (int p = 0; p < kPoolPer; ++p) {
    col[p] = strip0 + VEC * (threadIdx.x + kPoolThreads * p);
    if (col[p] < vocab) {
      load_f32<K, VEC, false>(bias + col[p], bb[p]);
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[p][e] = neg_inf();
  }

  float zero = neg_inf();  // the zero weights' own products, their max
  for (int t0 = 0; t0 < n_pos; t0 += kChunk) {
    const int n_here = min(kChunk, n_pos - t0);
    __syncthreads();  // the previous chunk's list is no longer read
    if (threadIdx.x < 32) {
      int n = 0;
      for (int i = lane; i - lane < n_here; i += 32) {
        const int t = t0 + i;
        const float c = i < n_here ? row_scale[b * n_pos + t] : 0.f;
        const bool live = i < n_here && c != 0.f;
        const unsigned mask = __ballot_sync(0xffffffffu, live);
        if (live) {
          const int k = n + __popc(mask & ((1u << lane) - 1u));
          s_t[k] = t;
          s_c[k] = c;
          s_m[k] = row_max[b * n_pos + t];
        } else if (i < n_here) {
          zero = fmaxf(zero, c);
        }
        n += __popc(mask);
      }
      if (lane == 0) s_n = n;
    }
    __syncthreads();
    const int n = s_n;
    for (int k0 = 0; k0 < n; k0 += kPoolUnroll) {
      float y[kPoolUnroll][kPoolPer][VEC];
#pragma unroll
      for (int u = 0; u < kPoolUnroll; ++u) {
        const int k = k0 + u;
        const auto* xr = xb + s_t[k < n ? k : 0] * stride_t;
#pragma unroll
        for (int p = 0; p < kPoolPer; ++p) {
          if (k < n && col[p] < vocab) {
            load_f32<K, VEC, true>(xr + col[p], y[u][p]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kPoolUnroll; ++u) {
        const int k = k0 + u;
        if (k >= n) break;
        const float m = s_m[k], c = s_c[k];
#pragma unroll
        for (int p = 0; p < kPoolPer; ++p) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float v = round_to<K>(__fadd_rn(y[u][p][e], bb[p][e]));
            acc[p][e] = fmaxf(acc[p][e], __fmul_rn(expf(v - m), c));
          }
        }
      }
    }
  }
  // the zero weights' max, over the 32 lanes of warp 0, for every thread
  if (threadIdx.x < 32) {
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      zero = fmaxf(zero, __shfl_xor_sync(0xffffffffu, zero, off));
    }
    if (lane == 0) s_zero = zero;
  }
  __syncthreads();
  zero = s_zero;
  float* ob = out + b * vocab;
#pragma unroll
  for (int p = 0; p < kPoolPer; ++p) {
    if (col[p] >= vocab) continue;
    float r[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) r[e] = fmaxf(acc[p][e], zero);
    if constexpr (VEC == 2) {
      *reinterpret_cast<float2*>(ob + col[p]) = make_float2(r[0], r[1]);
    } else {
      ob[col[p]] = r[0];
    }
  }
}

template <int K, int VEC>
cudaError_t launch(const void* proj, const void* bias, const void* weight,
                   float* stats, float* out, int batch, int n_pos, int vocab,
                   int64_t stride_b, int64_t stride_t, cudaStream_t stream) {
  using T = typename dhr::Elem<K>::T;
  const int64_t n_rows = static_cast<int64_t>(batch) * n_pos;
  float* row_max = stats;
  float* row_scale = stats + n_rows;
  constexpr int kRowsPerBlock = kStatThreads / 32;
  stats_kernel<K, VEC><<<static_cast<unsigned>((n_rows + kRowsPerBlock - 1) /
                                               kRowsPerBlock),
                         kStatThreads, 0, stream>>>(
      static_cast<const T*>(proj), static_cast<const T*>(bias),
      static_cast<const float*>(weight), row_max, row_scale, n_rows, n_pos,
      vocab, stride_b, stride_t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int kStrip = kPoolThreads * kPoolPer * VEC;
  const dim3 grid((vocab + kStrip - 1) / kStrip, batch);
  pool_kernel<K, VEC><<<grid, kPoolThreads, 0, stream>>>(
      static_cast<const T*>(proj), static_cast<const T*>(bias), row_max,
      row_scale, out, n_pos, vocab, stride_b, stride_t);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_kind(const void* proj, const void* bias,
                        const void* weight, float* stats, float* out,
                        int batch, int n_pos, int vocab, int64_t stride_b,
                        int64_t stride_t, cudaStream_t stream) {
  constexpr uintptr_t kPair = 2 * sizeof(typename dhr::Elem<K>::T);
  const bool pairs = vocab % 2 == 0 && stride_b % 2 == 0 &&
                     stride_t % 2 == 0 &&
                     reinterpret_cast<uintptr_t>(proj) % kPair == 0 &&
                     reinterpret_cast<uintptr_t>(bias) % kPair == 0;
  return pairs ? launch<K, 2>(proj, bias, weight, stats, out, batch, n_pos,
                              vocab, stride_b, stride_t, stream)
               : launch<K, 1>(proj, bias, weight, stats, out, batch, n_pos,
                              vocab, stride_b, stride_t, stream);
}

}  // namespace

// C entry, bound with ctypes.  Device pointers: proj (batch, n_pos, vocab)
// of `kind` (bf16 / f16 / f32) with element strides stride_b, stride_t
// and 1; bias (vocab) of the same kind, contiguous; weight f32
// (batch, n_pos) contiguous; stats f32 scratch of 2 * batch * n_pos; out
// f32 (batch, vocab) contiguous.  batch >= 1, n_pos >= 1, vocab >= 1.
// Launches the two passes on `stream`, allocates nothing, does not
// synchronise, and returns cudaGetLastError() of the launches.
extern "C" int lexical_pool_launch(const void* proj, const void* bias,
                                   const void* weight, void* stats, void* out,
                                   int batch, int n_pos, int vocab,
                                   long long stride_b, long long stride_t,
                                   int kind, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  float* o = static_cast<float*>(out);
  switch (kind) {
    case dhr::kBF16:
      return launch_kind<dhr::kBF16>(proj, bias, weight, st, o, batch, n_pos,
                                     vocab, stride_b, stride_t, s);
    case dhr::kF16:
      return launch_kind<dhr::kF16>(proj, bias, weight, st, o, batch, n_pos,
                                    vocab, stride_b, stride_t, s);
    case dhr::kF32:
      return launch_kind<dhr::kF32>(proj, bias, weight, st, o, batch, n_pos,
                                    vocab, stride_b, stride_t, s);
    default:
      return cudaErrorInvalidValue;
  }
}
