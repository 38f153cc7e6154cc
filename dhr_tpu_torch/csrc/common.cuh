// Shared helpers of the dhr_tpu_torch CUDA kernels: element kinds, widening
// to f32 without I2F, word-wise fold gates, runs of consecutive elements
// moved with vector accesses, 16-byte cp.async into shared memory, and the
// host-side dispatch from runtime kinds to template instances.
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

// 32-bit words that hold R elements of kind K.
template <int K, int R>
inline constexpr int kWords =
    R * static_cast<int>(sizeof(typename Elem<K>::T)) / 4;

// f32 of one value element.  int8 avoids I2F, which runs at 16 a clock an
// SM on sm_90, an eighth of the f32 rate: with u = x + 128
// (x ^ 0x80), the bits 0x4B0000uu are the f32 2^23 + u, and subtracting
// 2^23 + 128 leaves x exactly.
template <int K>
__device__ __forceinline__ float to_f32(typename Elem<K>::T x);
template <> __device__ __forceinline__ float to_f32<kI8>(int8_t x) {
  const uint32_t u = static_cast<uint8_t>(x) ^ 0x80u;
  return __fadd_rn(__uint_as_float(0x4B000000u | u), -8388736.f);
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

// f32 of the R value elements of kind VK held in the words w (element r at
// byte r * size), exact; int8 without I2F as to_f32<kI8>, four a word
// (one PRMT and one FADD each).
template <int VK, int R>
__device__ __forceinline__ void widen_words(
    const uint32_t (&w)[kWords<VK, R>], float (&x)[R]) {
  if constexpr (VK == kI8) {
    static_assert(R % 4 == 0, "int8 values widen a word at a time");
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint32_t bits =
          __byte_perm(w[r / 4] ^ 0x80808080u, 0x4B000000u, 0x7650 | (r % 4));
      x[r] = __fadd_rn(__uint_as_float(bits), -8388736.f);
    }
  } else {
    typename Elem<VK>::T v[R];
    memcpy(&v[0], &w[0], sizeof(v));
#pragma unroll
    for (int r = 0; r < R; ++r) x[r] = to_f32<VK>(v[r]);
  }
}

// widen_words of the R values at p (shared memory, aligned to R elements),
// loaded with one access.
template <int VK, int R>
__device__ __forceinline__ void widen(const typename Elem<VK>::T* p,
                                      float (&x)[R]) {
  uint32_t w[kWords<VK, R>];
  load_vec(reinterpret_cast<const uint32_t*>(p), w);
  widen_words<VK>(w, x);
}

// open[r]: fold r of the words w equals the gate at the same place of the
// words g (gates packed like the folds: their low 8 or 16 bits), compared a
// 32-bit word at a time (w ^ g is zero in the folds that match).  The
// caller guarantees each gate lies in the folds' range, so equal low bits
// mean equal values.
template <int IK, int R>
__device__ __forceinline__ void gates_words(
    const uint32_t (&w)[kWords<IK, R>], const uint32_t (&g)[kWords<IK, R>],
    bool (&open)[R]) {
  constexpr int kBits = 8 * static_cast<int>(sizeof(typename Elem<IK>::T));
  constexpr int kPer = 32 / kBits;  // folds per word
  constexpr uint32_t kMask = (1u << kBits) - 1u;
  static_assert(R % kPer == 0, "whole words of folds");
#pragma unroll
  for (int r = 0; r < R; ++r) {
    open[r] =
        ((w[r / kPer] ^ g[r / kPer]) & (kMask << (kBits * (r % kPer)))) == 0;
  }
}

// open[r]: the fold at p[r] (shared memory, aligned to R elements) equals
// the one gate g (in the folds' range), as gates_words with g repeated.
template <int IK, int R>
__device__ __forceinline__ void gates(const typename Elem<IK>::T* p, int g,
                                      bool (&open)[R]) {
  constexpr int kBits = 8 * static_cast<int>(sizeof(typename Elem<IK>::T));
  constexpr int kPer = 32 / kBits;  // folds per word
  constexpr uint32_t kMask = (1u << kBits) - 1u;
  const uint32_t rep = (static_cast<uint32_t>(g) & kMask) *
                       (kBits == 8 ? 0x01010101u : 0x00010001u);
  uint32_t w[kWords<IK, R>];
  load_vec(reinterpret_cast<const uint32_t*>(p), w);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    open[r] = ((w[r / kPer] ^ rep) & (kMask << (kBits * (r % kPer)))) == 0;
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

// Close the calling thread's group of cp.async issued since the last one.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of the calling thread's groups are still in flight
// (groups complete in the order they were committed).
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage the 16 bytes of a dim row at rows n.. (row = the dim row's start)
// into shared memory at dst; past n_rows they read as zero.
template <typename E>
__device__ __forceinline__ void stage16(E* dst, const E* __restrict__ row,
                                        int64_t n, int64_t n_rows) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(E));
  const int64_t left = n_rows - n;
  const int bytes = left >= kPer ? 16
                    : left > 0   ? static_cast<int>(left * sizeof(E))
                                 : 0;
  cp_async16(dst, bytes ? row + n : row, bytes);
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

// f(std::integral_constant<int, tile>) for a row tile of 128, 64, 32 or 16.
template <typename F>
cudaError_t dispatch_tile(int tile, F&& f) {
  switch (tile) {
    case 128: return f(std::integral_constant<int, 128>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 16: return f(std::integral_constant<int, 16>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace dhr
