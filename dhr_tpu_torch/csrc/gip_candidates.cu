// K3: the theta pass fused with a per-group (max, argmax) reduction, for
// sm_90a.
//
// Replaces the Pallas TPU kernel pallas_gip_candidates
// (dhr_tpu/ops/pallas_gip.py:346-461, kernel body _make_candidates_kernel at
// 228-318).  For each query b it forms K1's f32 sums
//
//   s[b, r] = sum_i  w_i * values_T[d_i, r] * gate_i(r)
//
// with K1's arithmetic (dhr::stage_important + dhr::gated_sums of
// common.cuh: order of the important dims, __fmul_rn / __fadd_rn, zero
// weights skipped, CLS dims gated open), so the sums are K1's bit for bit,
// then reduces every group of G rows to its best row.  The partition is the
// reference's: row r sits at reduced position p = (r / (128 G)) * 128 +
// r % 128 with local index j = (r / 128) % G, i.e. a group is the G rows
// that share a lane across G consecutive 128-row blocks.  The first maximum
// in j order wins (strict >).  Rows >= N take no part; a group without a
// valid row holds -inf, with j = 0 (packed) or row id N (two planes).
//
// Outputs, (B, P) each with P = ceil(N / (128 G)) * 128:
// - packed (G a power of two): one f32 plane, the winner's j in the low
//   log2(G) mantissa bits: int_as_float((float_as_int(best) & -G) | j);
// - two planes: the f32 maximum cast once to f32 or bf16, and the winner's
//   absolute row as int32.
//
// What bounds it: bytes, the same reads as K1 (I_eff dim rows of values and
// indices per query) but a write G times smaller: 4 B per reduced lane
// instead of 2-4 B per row.  Design:
// - grid (B, ceil(N / S)) with the query on blockIdx.x, as in K1, so
//   concurrent blocks share row tiles across queries through L2;
// - a block spans S rows, S = lcm(4096, 128 G) (4096 for G | 32), in S/4096
//   passes of per-thread runs (256 threads x 16 rows, 16-byte loads: the
//   dim rows come at a padded, 16-byte aligned pitch; element loads only
//   for the ragged end of N);
// - the f32 sums go to shared memory; after one barrier each thread reduces
//   groups in j order, reading consecutive lanes (no bank conflicts) and
//   writing consecutive reduced positions (coalesced).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;  // rows per thread per pass
constexpr int kPass = kThreads * kRows;
constexpr int kLane = 128;

template <int VK, int IK, int OK, bool PACKED>
__global__ void __launch_bounds__(kThreads)
gip_candidates_kernel(const float* __restrict__ imp_vals,
                      const int32_t* __restrict__ imp_dims,
                      const int32_t* __restrict__ imp_gates,
                      const typename dhr::Elem<VK>::T* __restrict__ values_t,
                      const typename dhr::Elem<IK>::T* __restrict__ indices_t,
                      typename dhr::Elem<OK>::T* __restrict__ out_vals,
                      int32_t* __restrict__ out_rows, int64_t n_rows,
                      int64_t v_pitch, int64_t i_pitch, int64_t n_red,
                      int n_imp, int dim, int lex_dim, int group, int span) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_sum = reinterpret_cast<float*>(smem);  // span floats
  float* s_val = s_sum + span;
  int32_t* s_dim = reinterpret_cast<int32_t*>(s_val + n_imp);
  int32_t* s_gate = s_dim + n_imp;

  const int64_t b = blockIdx.x;
  dhr::stage_important(imp_vals, imp_dims, imp_gates, b, n_imp, dim, s_val,
                       s_dim, s_gate);

  const int64_t blk0 = static_cast<int64_t>(blockIdx.y) * span;
  for (int pass = 0; pass < span; pass += kPass) {
    const int local = pass + threadIdx.x * kRows;
    const int64_t n0 = blk0 + local;
    const int64_t n_valid = n_rows - n0;
    float acc[kRows];
    if (n_valid > 0) {
      dhr::gated_sums<VK, IK>(s_val, s_dim, s_gate, n_imp, values_t,
                              indices_t, v_pitch, i_pitch, n0, n_valid,
                              lex_dim, acc);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= n_valid) acc[r] = __uint_as_float(0xff800000u);  // -inf
    }
    float4* dst = reinterpret_cast<float4*>(s_sum + local);
#pragma unroll
    for (int k = 0; k < kRows / 4; ++k) {
      dst[k] = make_float4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2],
                           acc[4 * k + 3]);
    }
  }
  __syncthreads();

  // span / G reduced lanes per block; position o -> group block o / 128,
  // lane o % 128, rows (o / 128) * 128 G + j * 128 + o % 128 of the span
  const int n_out = span / group;
  const int64_t p0 = static_cast<int64_t>(blockIdx.y) * n_out;
  for (int o = threadIdx.x; o < n_out; o += blockDim.x) {
    const int64_t p = p0 + o;
    if (p >= n_red) break;
    const int base = (o / kLane) * kLane * group + o % kLane;
    float best = s_sum[base];
    int best_j = 0;
    for (int j = 1; j < group; ++j) {
      const float v = s_sum[base + j * kLane];
      if (v > best) {  // strict: the first maximum wins
        best = v;
        best_j = j;
      }
    }
    if constexpr (PACKED) {
      out_vals[b * n_red + p] =
          __int_as_float((__float_as_int(best) & -group) | best_j);
    } else {
      const int64_t row0 = blk0 + base;
      out_vals[b * n_red + p] = dhr::from_f32<OK>(best);
      out_rows[b * n_red + p] = static_cast<int32_t>(
          row0 < n_rows ? row0 + static_cast<int64_t>(best_j) * kLane
                        : n_rows);
    }
  }
}

template <int VK, int IK, int OK, bool PACKED>
cudaError_t launch(const void* imp_vals, const void* imp_dims,
                   const void* imp_gates, const void* values_t,
                   const void* indices_t, void* out_vals, void* out_rows,
                   int64_t n_rows, int64_t v_pitch, int64_t i_pitch,
                   int64_t n_red, int batch, int n_imp, int dim, int lex_dim,
                   int group, int span, cudaStream_t stream) {
  auto* kernel = gip_candidates_kernel<VK, IK, OK, PACKED>;
  const size_t smem =
      static_cast<size_t>(span) * 4 + static_cast<size_t>(n_imp) * 12;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(batch,
                  static_cast<unsigned>((n_rows + span - 1) / span));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(imp_vals),
      static_cast<const int32_t*>(imp_dims),
      static_cast<const int32_t*>(imp_gates),
      static_cast<const typename dhr::Elem<VK>::T*>(values_t),
      static_cast<const typename dhr::Elem<IK>::T*>(indices_t),
      static_cast<typename dhr::Elem<OK>::T*>(out_vals),
      static_cast<int32_t*>(out_rows), n_rows, v_pitch, i_pitch, n_red, n_imp,
      dim, lex_dim, group, span);
  return cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes.  Pointers are device pointers: imp_vals f32
// (B, I), imp_dims / imp_gates int32 (B, I), contiguous; values_T (dim, N)
// of value_kind at row pitch v_pitch and indices_T (lex_dim, N) of
// index_kind at row pitch i_pitch (elements; each row 16-byte aligned);
// out_vals (B, n_red) f32 (packed) or out_kind, out_rows (B, n_red) int32
// (ignored when packed).  span is a multiple of 4096 and of 128 * group.
// Launches on `stream`, allocates nothing, does not synchronise, and
// returns the first CUDA error of the set-up or the launch.
extern "C" int gip_candidates_launch(
    const void* imp_vals, const void* imp_dims, const void* imp_gates,
    const void* values_t, const void* indices_t, void* out_vals,
    void* out_rows, long long n_rows, long long v_pitch, long long i_pitch,
    long long n_red, int batch, int n_imp, int dim, int lex_dim, int group,
    int span, int value_kind, int index_kind, int out_kind, int packed,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n = static_cast<int64_t>(n_rows);
  const int64_t nr = static_cast<int64_t>(n_red);
  return dhr::dispatch_planes(value_kind, index_kind, [&](auto vk, auto ik) {
    constexpr int VK = decltype(vk)::value, IK = decltype(ik)::value;
    if (packed) {
      return launch<VK, IK, dhr::kF32, true>(
          imp_vals, imp_dims, imp_gates, values_t, indices_t, out_vals,
          out_rows, n, v_pitch, i_pitch, nr, batch, n_imp, dim, lex_dim,
          group, span, s);
    }
    return dhr::dispatch_out(out_kind, [&](auto ok) {
      return launch<VK, IK, decltype(ok)::value, false>(
          imp_vals, imp_dims, imp_gates, values_t, indices_t, out_vals,
          out_rows, n, v_pitch, i_pitch, nr, batch, n_imp, dim, lex_dim,
          group, span, s);
    });
  });
}
