// Shared helpers of the dhr_tpu_torch CUDA kernels: element kinds, widening
// to f32 / int32, runs of consecutive elements moved with vector accesses,
// 16-byte cp.async into shared memory, K3's gated accumulation straight
// from the dim-major planes, and the host-side dispatch from runtime kinds
// to template instances.
//
// Dim-major planes come at a padded pitch (retrieval/index.py dim_major:
// a multiple of 128 elements), and the wrappers refuse a plane whose row
// pitch or base is not 16-byte aligned, so every dim row starts 16-byte
// aligned and no dim-major read needs an element-by-element path.
#pragma once

#include <cstdint>
#include <cstring>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace dhr {

// Element kinds; the Python wrappers pass these codes (ops/_build.py KIND).
enum Kind : int {
  kI8 = 0,
  kI16 = 1,
  kBF16 = 2,
  kF16 = 3,
  kF32 = 4,
};

// Storage type of each kind.  bf16 and f16 travel as their raw 16 bits and
// are widened with bit operations / intrinsics only.
template <int K> struct Elem;
template <> struct Elem<kI8> { using T = int8_t; };
template <> struct Elem<kI16> { using T = int16_t; };
template <> struct Elem<kBF16> { using T = uint16_t; };
template <> struct Elem<kF16> { using T = uint16_t; };
template <> struct Elem<kF32> { using T = float; };

template <int K>
__device__ __forceinline__ float to_f32(typename Elem<K>::T x);
template <> __device__ __forceinline__ float to_f32<kI8>(int8_t x) {
  return static_cast<float>(x);
}
template <> __device__ __forceinline__ float to_f32<kI16>(int16_t x) {
  return static_cast<float>(x);
}
template <> __device__ __forceinline__ float to_f32<kBF16>(uint16_t x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}
template <> __device__ __forceinline__ float to_f32<kF16>(uint16_t x) {
  return __half2float(__ushort_as_half(x));
}
template <> __device__ __forceinline__ float to_f32<kF32>(float x) {
  return x;
}

// f32 -> storage of an output kind (f32 or bf16, round to nearest even).
template <int K>
__device__ __forceinline__ typename Elem<K>::T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<kF32>(float x) {
  return x;
}
template <> __device__ __forceinline__ uint16_t from_f32<kBF16>(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// A word of B bytes, for vector accesses of R elements at once.
template <int B> struct Word;
template <> struct Word<4> { using T = uint32_t; };
template <> struct Word<8> { using T = uint2; };
template <> struct Word<16> { using T = uint4; };
struct alignas(16) Word32 { uint4 lo, hi; };
template <> struct Word<32> { using T = Word32; };

// Load R consecutive elements at p (R * sizeof(T) bytes, p aligned to that)
// with one access, e.g. from shared memory.
template <typename T, int R>
__device__ __forceinline__ void load_vec(const T* p, T (&out)[R]) {
  using W = typename Word<R * static_cast<int>(sizeof(T))>::T;
  const W w = *reinterpret_cast<const W*>(p);
  memcpy(&out[0], &w, sizeof(W));
}

// Store the first n_valid (may be < R, or <= 0) of R consecutive elements
// at p: one vector store when the run is whole and p is aligned to it,
// element stores otherwise (an output row of odd length starts anywhere).
template <typename T, int R>
__device__ __forceinline__ void store_vec(T* p, int64_t n_valid,
                                          const T (&in)[R]) {
  using W = typename Word<R * static_cast<int>(sizeof(T))>::T;
  if (n_valid >= R && (reinterpret_cast<uintptr_t>(p) % sizeof(W)) == 0) {
    W w;
    memcpy(&w, &in[0], sizeof(W));
    *reinterpret_cast<W*>(p) = w;
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < n_valid) p[r] = in[r];
    }
  }
}

// Load R consecutive elements of a dim-major row at p (16-byte aligned: the
// pitch rule above), of which n_valid (may be < R) exist; missing ones read
// as 0.  16-byte loads through the read-only path for a whole run, element
// loads only for the ragged end of the row.
template <typename T, int R>
__device__ __forceinline__ void load_run(const T* __restrict__ p,
                                         int64_t n_valid, T (&out)[R]) {
  constexpr int kBytes = R * static_cast<int>(sizeof(T));
  static_assert(kBytes % 16 == 0, "a run must be whole 16-byte words");
  if (n_valid >= R) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int k = 0; k < kBytes / 16; ++k) {
      const uint4 w = __ldg(q + k);
      memcpy(&out[k * (16 / sizeof(T))], &w, 16);
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) out[r] = r < n_valid ? p[r] : T(0);
  }
}

// 16 bytes from global src to shared dst (both 16-byte aligned), of which
// the first src_bytes (0..16) are read and the rest zero-filled; async
// (cp.async.cg: cached in L2 only), completed by cp_async_wait_all.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// K3's theta pass, part 1: stage query b's important dims (w, d, g) in
// shared memory, then barrier.  A dim outside [0, dim) gets weight 0 and is
// never read.
__device__ __forceinline__ void stage_important(
    const float* __restrict__ imp_vals, const int32_t* __restrict__ imp_dims,
    const int32_t* __restrict__ imp_gates, int64_t b, int n_imp, int dim,
    float* s_val, int32_t* s_dim, int32_t* s_gate) {
  for (int i = threadIdx.x; i < n_imp; i += blockDim.x) {
    const int d = imp_dims[b * n_imp + i];
    const bool ok = d >= 0 && d < dim;
    s_val[i] = ok ? imp_vals[b * n_imp + i] : 0.f;
    s_dim[i] = ok ? d : 0;
    s_gate[i] = imp_gates[b * n_imp + i];
  }
  __syncthreads();
}

// K3's theta pass, part 2: the f32 sums of R consecutive rows n0.. (n_valid
// of them exist, n_valid >= 1; the rest read as 0)
//
//   acc[r] = sum_i  w_i * values_t[d_i, n0 + r] * gate_i(n0 + r)
//   gate_i(n) = d_i >= lex_dim  or  indices_t[d_i, n] == g_i
//
// over the staged dims in their order, each product rounded before its add
// (__fmul_rn / __fadd_rn, no contraction).  A zero weight adds nothing and
// is skipped (the weights are the same for the whole block); a CLS dim
// reads no index row.  Dim row d starts at d * v_pitch (values) and
// d * i_pitch (indices).  K1's staged kernel accumulates the same way, so
// K1's and K3's sums are the same bits.
template <int VK, int IK, int R>
__device__ __forceinline__ void gated_sums(
    const float* s_val, const int32_t* s_dim, const int32_t* s_gate,
    int n_imp, const typename Elem<VK>::T* __restrict__ values_t,
    const typename Elem<IK>::T* __restrict__ indices_t, int64_t v_pitch,
    int64_t i_pitch, int64_t n0, int64_t n_valid, int lex_dim,
    float (&acc)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  for (int i = 0; i < n_imp; ++i) {
    const float w = s_val[i];
    if (w == 0.f) continue;
    const int d = s_dim[i];
    typename Elem<VK>::T v[R];
    load_run(values_t + static_cast<int64_t>(d) * v_pitch + n0, n_valid, v);
    if (d < lex_dim) {
      typename Elem<IK>::T ix[R];
      load_run(indices_t + static_cast<int64_t>(d) * i_pitch + n0, n_valid,
               ix);
      const int g = s_gate[i];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = __fmul_rn(to_f32<VK>(v[r]), w);
        acc[r] = __fadd_rn(acc[r], static_cast<int>(ix[r]) == g ? p : 0.f);
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc[r] = __fadd_rn(acc[r], __fmul_rn(to_f32<VK>(v[r]), w));
      }
    }
  }
}

// Host side: a kind as a type, so a generic lambda can take it as a
// template argument (decltype(k)::value).
template <int K>
using KindC = std::integral_constant<int, K>;

// f(KindC<value kind>, KindC<index kind>) for the planes' runtime kinds:
// values int8 / bf16 / f16 / f32, fold indices int8 / int16.
template <typename F>
cudaError_t dispatch_planes(int value_kind, int index_kind, F&& f) {
  auto with_index = [&](auto vk) -> cudaError_t {
    switch (index_kind) {
      case kI8: return f(vk, KindC<kI8>{});
      case kI16: return f(vk, KindC<kI16>{});
      default: return cudaErrorInvalidValue;
    }
  };
  switch (value_kind) {
    case kI8: return with_index(KindC<kI8>{});
    case kBF16: return with_index(KindC<kBF16>{});
    case kF16: return with_index(KindC<kF16>{});
    case kF32: return with_index(KindC<kF32>{});
    default: return cudaErrorInvalidValue;
  }
}

// f(KindC<out kind>) for an f32 or bf16 score output.
template <typename F>
cudaError_t dispatch_out(int out_kind, F&& f) {
  switch (out_kind) {
    case kF32: return f(KindC<kF32>{});
    case kBF16: return f(KindC<kBF16>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace dhr
