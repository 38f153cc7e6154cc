// Shared helpers of the dhr_tpu_torch CUDA kernels: element kinds, widening
// to f32 / int32, and runs of consecutive elements moved with 16-byte
// vector accesses where the address allows it.
#pragma once

#include <cstdint>
#include <cstring>

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

// Load R consecutive elements at p, of which n_valid (may be < R) exist;
// missing ones read as 0.  16-byte loads through the read-only path when
// the run is whole and p is 16-byte aligned, element loads otherwise.
template <typename T, int R>
__device__ __forceinline__ void load_run(const T* __restrict__ p,
                                         int64_t n_valid, T (&out)[R]) {
  constexpr int kBytes = R * static_cast<int>(sizeof(T));
  static_assert(kBytes % 16 == 0, "a run must be whole 16-byte words");
  if (n_valid >= R && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
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

// Store R consecutive elements at p, of which only n_valid are written.
template <typename T, int R>
__device__ __forceinline__ void store_run(T* __restrict__ p, int64_t n_valid,
                                          const T (&in)[R]) {
  constexpr int kBytes = R * static_cast<int>(sizeof(T));
  static_assert(kBytes % 16 == 0, "a run must be whole 16-byte words");
  if (n_valid >= R && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    uint4* q = reinterpret_cast<uint4*>(p);
#pragma unroll
    for (int k = 0; k < kBytes / 16; ++k) {
      uint4 w;
      memcpy(&w, &in[k * (16 / sizeof(T))], 16);
      q[k] = w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < n_valid) p[r] = in[r];
    }
  }
}

}  // namespace dhr
