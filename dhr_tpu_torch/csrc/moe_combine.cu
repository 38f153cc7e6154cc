// K5: the MoE layer's combine, for sm_90a.
//
// Replaces no Pallas kernel: the JAX package has no mixture of experts.
// It does the combine step of the port's decoder MoE
// (dhr_tpu_torch/models/decoder.py routed_experts_grouped), which ran as
// five eager passes over an (N, k, H) f32 copy of the gathered rows: the
// gather, the cast to f32, the weighting, the sum over k and the cast
// back.  For token n of N, its k slots j and the down projection's output
// rows in expert order (M = N * k of them, H wide):
//
//   out[n, :] = round_to_kind( sum_{j < k} f32(w[n, j]) * f32(rows[slot[n, j], :]) )
//
// The products and the sum are f32, each product rounded before it is
// added (no FMA contraction, as the eager passes round), the sum taken in
// slot order from +0; the result rounds to the rows' kind (bf16, f16 or
// f32, nearest even).  Against the eager passes only the order of the f32
// sum can differ (PyTorch's reduction over k picks its own): within an ulp
// of the output kind, where the sum does not cancel.
//
// What bounds it: bytes.  Per token it reads its k rows once and writes one
// row: (k + 1) * H * 2 bytes in bf16, ~545 MB a layer for ~19,000 tokens at
// k = 6, H = 2,048 (0.16 ms at 3.35 TB/s), against ~5.5 GB the eager passes
// moved through their f32 copies.  Design against that:
// - one thread a 16-byte vector of one token's output row; a block's 256
//   threads cover 4,096 bytes: one token's row at H = 2,048 in bf16, two
//   at 1,024;
// - a thread reads its token's slot ids and weights (the same addresses
//   across the threads of a token: one broadcast load each), then issues
//   the 16-byte loads of up to kGroup = 8 rows before any arithmetic:
//   read-only and not allocated in L1 (each row is read once), so that
//   enough bytes are in flight to cover the memory's latency without TMA;
//   k above 8 (up to kMaxK = 16) takes a second group;
// - the sum stays in f32 registers and leaves as one rounded 16-byte store;
// - an H that is not a multiple of the vector (8 elements of 16 bits, 4 of
//   f32), or a base that is not 16-byte aligned, takes one element a
//   thread.
// A slot id outside [0, M) traps (as an out-of-range gather asserts).

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;  // rows a thread has in flight at once
constexpr int kMaxK = 16;

template <int K> struct Out;
template <> struct Out<dhr::kBF16> {
  static __device__ __forceinline__ uint16_t of(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};
template <> struct Out<dhr::kF16> {
  static __device__ __forceinline__ uint16_t of(float x) {
    return __half_as_ushort(__float2half_rn(x));
  }
};
template <> struct Out<dhr::kF32> {
  static __device__ __forceinline__ float of(float x) { return x; }
};

// VEC elements at p (aligned to VEC elements): one 16-byte read-only load
// that is not allocated in L1, or one read-only element load.
template <typename T, int VEC>
__device__ __forceinline__ void load_once(const T* p, T (&x)[VEC]) {
  if constexpr (VEC == 1) {
    x[0] = __ldg(p);
  } else {
    static_assert(VEC * sizeof(T) == 16, "16-byte vectors");
    uint4 v;
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
        : "l"(p));
    memcpy(&x[0], &v, sizeof(v));
  }
}

template <int K, int VEC>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const typename dhr::Elem<K>::T* __restrict__ rows,
               const int64_t* __restrict__ slot,
               const float* __restrict__ weight,
               typename dhr::Elem<K>::T* __restrict__ out, int64_t n_tokens,
               int k, int64_t hidden, int64_t n_rows) {
  using T = typename dhr::Elem<K>::T;
  const int64_t per_token = hidden / VEC;  // VEC divides hidden
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_tokens * per_token) return;
  const int64_t n = i / per_token;
  const int64_t col = (i - n * per_token) * VEC;
  const int64_t* s = slot + n * k;
  const float* w = weight + n * k;

  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  for (int j0 = 0; j0 < k; j0 += kGroup) {
    T x[kGroup][VEC];
    float wj[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (j0 + u < k) {
        const int64_t r = __ldg(s + j0 + u);
        if (static_cast<uint64_t>(r) >= static_cast<uint64_t>(n_rows)) {
          __trap();
        }
        wj[u] = __ldg(w + j0 + u);
        load_once<T, VEC>(rows + r * hidden + col, x[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (j0 + u < k) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          acc[e] = __fadd_rn(acc[e],
                             __fmul_rn(wj[u], dhr::to_f32<K>(x[u][e])));
        }
      }
    }
  }
  T y[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) y[e] = Out<K>::of(acc[e]);
  T* o = out + n * hidden + col;
  if constexpr (VEC == 1) {
    *o = y[0];
  } else {
    uint4 v;
    memcpy(&v, &y[0], sizeof(v));
    *reinterpret_cast<uint4*>(o) = v;
  }
}

template <int K, int VEC>
cudaError_t launch(const void* rows, const int64_t* slot, const float* weight,
                   void* out, int64_t n_tokens, int k, int64_t hidden,
                   int64_t n_rows, cudaStream_t stream) {
  using T = typename dhr::Elem<K>::T;
  const int64_t threads = n_tokens * (hidden / VEC);
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  combine_kernel<K, VEC><<<static_cast<unsigned>(blocks), kThreads, 0,
                           stream>>>(
      static_cast<const T*>(rows), slot, weight, static_cast<T*>(out),
      n_tokens, k, hidden, n_rows);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_kind(const void* rows, const int64_t* slot,
                        const float* weight, void* out, int64_t n_tokens,
                        int k, int64_t hidden, int64_t n_rows,
                        cudaStream_t stream) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(typename dhr::Elem<K>::T));
  const bool vectors = hidden % kVec == 0 &&
                       reinterpret_cast<uintptr_t>(rows) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return vectors ? launch<K, kVec>(rows, slot, weight, out, n_tokens, k,
                                   hidden, n_rows, stream)
                 : launch<K, 1>(rows, slot, weight, out, n_tokens, k, hidden,
                                n_rows, stream);
}

}  // namespace

// C entry, bound with ctypes.  Device pointers: rows (n_rows, hidden) of
// `kind` (bf16 / f16 / f32), contiguous; slot int64 (n_tokens, k),
// contiguous, each in [0, n_rows); weight f32 (n_tokens, k), contiguous;
// out (n_tokens, hidden) of `kind`, contiguous.  n_tokens >= 1,
// 1 <= k <= 16, hidden >= 1.  Launches one kernel on `stream`, allocates
// nothing, does not synchronise, and returns cudaGetLastError() of the
// launch.
extern "C" int moe_combine_launch(const void* rows, const void* slot,
                                  const void* weight, void* out,
                                  long long n_tokens, int k, long long hidden,
                                  long long n_rows, int kind, void* stream) {
  if (n_tokens < 1 || k < 1 || k > kMaxK || hidden < 1) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* s = static_cast<const int64_t*>(slot);
  const auto* w = static_cast<const float*>(weight);
  switch (kind) {
    case dhr::kBF16:
      return launch_kind<dhr::kBF16>(rows, s, w, out, n_tokens, k, hidden,
                                     n_rows, st);
    case dhr::kF16:
      return launch_kind<dhr::kF16>(rows, s, w, out, n_tokens, k, hidden,
                                    n_rows, st);
    case dhr::kF32:
      return launch_kind<dhr::kF32>(rows, s, w, out, n_tokens, k, hidden,
                                    n_rows, st);
    default:
      return cudaErrorInvalidValue;
  }
}
