// K1: the theta-pass partial GIP over the dim-major planes, for sm_90a.
//
// Replaces the Pallas TPU kernel pallas_partial_gip
// (dhr_tpu/ops/pallas_gip.py:115-207, kernel body _make_kernel at 61-109).
// For each query b and corpus row n:
//
//   out[b, n] = sum_i  w_i * values_T[d_i, n] * gate_i(n)
//   gate_i(n) = d_i >= lex_dim  or  indices_T[d_i, n] == g_i
//
// over the query's I important dims (w, d, g) = (imp_vals, imp_dims,
// imp_gates), selected by the caller.  Accumulates in f32 in the order of
// the important dims (the plain version's order, and the reference scan's),
// each product rounded before its add, and writes f32 or bf16 once.
//
// What bounds it: bytes.  Per query it streams I_eff dim rows of N values and
// N indices (I_eff = dims with w != 0; a zero weight adds nothing, so its
// rows are never read) and writes N scores.  Design against that:
// - grid (B, ceil(N / 4096)) with the query on blockIdx.x, so the blocks in
//   flight at once are the same row tile for consecutive queries; queries
//   that share popular dims then read those rows from L2.
// - each thread owns 16 consecutive rows and reads each dim row's run with
//   16-byte loads (int8: one load; 2-byte kinds: two; f32: four), so a warp
//   reads 512 contiguous rows per dim; a row whose start is not 16-byte
//   aligned (odd N) falls back to element loads.
// - the block's (w, d, g) triples sit in shared memory; the ragged edge of
//   N is masked in the loads and stores, so N needs no particular multiple.
// - CLS dims (d >= lex_dim) are gated open and read no index row; a dim
//   outside [0, dim) is treated as weight 0 and never read.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;  // rows per thread

template <int VK, int IK, int OK>
__global__ void __launch_bounds__(kThreads)
partial_gip_kernel(const float* __restrict__ imp_vals,
                   const int32_t* __restrict__ imp_dims,
                   const int32_t* __restrict__ imp_gates,
                   const typename dhr::Elem<VK>::T* __restrict__ values_t,
                   const typename dhr::Elem<IK>::T* __restrict__ indices_t,
                   typename dhr::Elem<OK>::T* __restrict__ out,
                   int64_t n_rows, int n_imp, int dim, int lex_dim) {
  using VT = typename dhr::Elem<VK>::T;
  using IT = typename dhr::Elem<IK>::T;
  using OT = typename dhr::Elem<OK>::T;
  extern __shared__ unsigned char smem[];
  float* s_val = reinterpret_cast<float*>(smem);
  int32_t* s_dim = reinterpret_cast<int32_t*>(s_val + n_imp);
  int32_t* s_gate = s_dim + n_imp;

  const int64_t b = blockIdx.x;
  for (int i = threadIdx.x; i < n_imp; i += blockDim.x) {
    const int d = imp_dims[b * n_imp + i];
    const bool ok = d >= 0 && d < dim;
    s_val[i] = ok ? imp_vals[b * n_imp + i] : 0.f;
    s_dim[i] = ok ? d : 0;
    s_gate[i] = imp_gates[b * n_imp + i];
  }
  __syncthreads();

  const int64_t n0 =
      (static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x) * kRows;
  if (n0 >= n_rows) return;
  const int64_t n_valid = n_rows - n0;

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;

  for (int i = 0; i < n_imp; ++i) {
    const float w = s_val[i];
    if (w == 0.f) continue;  // uniform across the block
    const int d = s_dim[i];
    VT v[kRows];
    dhr::load_run(values_t + static_cast<int64_t>(d) * n_rows + n0, n_valid,
                  v);
    if (d < lex_dim) {
      IT ix[kRows];
      dhr::load_run(indices_t + static_cast<int64_t>(d) * n_rows + n0,
                    n_valid, ix);
      const int g = s_gate[i];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = __fmul_rn(dhr::to_f32<VK>(v[r]), w);
        acc[r] = __fadd_rn(acc[r], static_cast<int>(ix[r]) == g ? p : 0.f);
      }
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        acc[r] = __fadd_rn(acc[r], __fmul_rn(dhr::to_f32<VK>(v[r]), w));
      }
    }
  }

  OT o[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) o[r] = dhr::from_f32<OK>(acc[r]);
  dhr::store_run(out + b * n_rows + n0, n_valid, o);
}

template <int VK, int IK, int OK>
cudaError_t launch(const void* imp_vals, const void* imp_dims,
                   const void* imp_gates, const void* values_t,
                   const void* indices_t, void* out, int64_t n_rows,
                   int batch, int n_imp, int dim, int lex_dim,
                   cudaStream_t stream) {
  const int64_t rows_per_block = static_cast<int64_t>(kThreads) * kRows;
  const dim3 grid(batch, static_cast<unsigned>(
                             (n_rows + rows_per_block - 1) / rows_per_block));
  const size_t smem = static_cast<size_t>(n_imp) * 12;
  partial_gip_kernel<VK, IK, OK><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(imp_vals),
      static_cast<const int32_t*>(imp_dims),
      static_cast<const int32_t*>(imp_gates),
      static_cast<const typename dhr::Elem<VK>::T*>(values_t),
      static_cast<const typename dhr::Elem<IK>::T*>(indices_t),
      static_cast<typename dhr::Elem<OK>::T*>(out), n_rows, n_imp, dim,
      lex_dim);
  return cudaGetLastError();
}

template <int VK, int IK>
cudaError_t by_out(int out_kind, const void* a, const void* b, const void* c,
                   const void* v, const void* ix, void* out, int64_t n,
                   int batch, int n_imp, int dim, int lex,
                   cudaStream_t s) {
  switch (out_kind) {
    case dhr::kF32:
      return launch<VK, IK, dhr::kF32>(a, b, c, v, ix, out, n, batch, n_imp,
                                       dim, lex, s);
    case dhr::kBF16:
      return launch<VK, IK, dhr::kBF16>(a, b, c, v, ix, out, n, batch, n_imp,
                                        dim, lex, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int VK>
cudaError_t by_index(int index_kind, int out_kind, const void* a,
                     const void* b, const void* c, const void* v,
                     const void* ix, void* out, int64_t n, int batch,
                     int n_imp, int dim, int lex, cudaStream_t s) {
  switch (index_kind) {
    case dhr::kI8:
      return by_out<VK, dhr::kI8>(out_kind, a, b, c, v, ix, out, n, batch,
                                  n_imp, dim, lex, s);
    case dhr::kI16:
      return by_out<VK, dhr::kI16>(out_kind, a, b, c, v, ix, out, n, batch,
                                   n_imp, dim, lex, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry, bound with ctypes.  Pointers are device pointers of contiguous
// tensors: imp_vals f32 (B, I), imp_dims / imp_gates int32 (B, I),
// values_T (dim, N) of value_kind, indices_T (lex_dim, N) of index_kind,
// out (B, N) of out_kind.  Launches on `stream`, allocates nothing, does not
// synchronise, and returns cudaGetLastError() of the launch.
extern "C" int partial_gip_launch(const void* imp_vals, const void* imp_dims,
                                  const void* imp_gates, const void* values_t,
                                  const void* indices_t, void* out,
                                  long long n_rows, int batch, int n_imp,
                                  int dim, int lex_dim, int value_kind,
                                  int index_kind, int out_kind,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n = static_cast<int64_t>(n_rows);
  switch (value_kind) {
    case dhr::kI8:
      return by_index<dhr::kI8>(index_kind, out_kind, imp_vals, imp_dims,
                                imp_gates, values_t, indices_t, out, n, batch,
                                n_imp, dim, lex_dim, s);
    case dhr::kBF16:
      return by_index<dhr::kBF16>(index_kind, out_kind, imp_vals, imp_dims,
                                  imp_gates, values_t, indices_t, out, n,
                                  batch, n_imp, dim, lex_dim, s);
    case dhr::kF16:
      return by_index<dhr::kF16>(index_kind, out_kind, imp_vals, imp_dims,
                                 imp_gates, values_t, indices_t, out, n, batch,
                                 n_imp, dim, lex_dim, s);
    case dhr::kF32:
      return by_index<dhr::kF32>(index_kind, out_kind, imp_vals, imp_dims,
                                 imp_gates, values_t, indices_t, out, n, batch,
                                 n_imp, dim, lex_dim, s);
    default:
      return cudaErrorInvalidValue;
  }
}
