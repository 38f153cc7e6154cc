// K2: the exact GIP rerank of each query's candidate rows, for sm_90a.
//
// Replaces the Pallas TPU kernel pallas_rerank_gip
// (dhr_tpu/ops/pallas_rerank.py:81-163, kernel body _make_kernel at 47-75),
// with the semantics of the searcher's gather + _rerank_gip
// (dhr_tpu/retrieval/searcher.py:339-354, 706-717).  For query b and
// candidate k with row r = rows[b, k]:
//
//   out[b, k] = sum_{j < lex} [indices[r, j] == qi[b, j]] * values[r, j] * qv[b, j]
//             + sum_{j >= lex} values[r, j] * qv[b, j]
//
// Index values compare widened to int32.  A row id outside [0, N) is never
// read: its score is -inf, so it sorts last.
//
// What bounds it: bytes.  Each candidate reads one row of the row-major
// value plane (D values) and of the index plane (lex indices), which no
// (B, K, D) gathered copy ever holds.  Design against that:
// - grid (ceil(K / 64), B): a block of 8 warps serves 64 candidates of one
//   query; the query's qv (f32) and qi (widened to int32) are staged once in
//   shared memory per block;
// - one warp per candidate: lanes read consecutive elements of the row, so
//   each warp load is one contiguous run of the row; the gated products
//   accumulate in f32 per lane and reduce with warp shuffles;
// - no multiple-of-128 rule on D, lex or K.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCandPerWarp = 8;

template <int VK, int IK>
__global__ void __launch_bounds__(kThreads)
rerank_gip_kernel(const float* __restrict__ qv, const int32_t* __restrict__ qi,
                  const int64_t* __restrict__ rows,
                  const typename dhr::Elem<VK>::T* __restrict__ values,
                  const typename dhr::Elem<IK>::T* __restrict__ indices,
                  float* __restrict__ out, int64_t n_rows, int n_cand,
                  int dim, int lex_dim, int qi_stride) {
  using VT = typename dhr::Elem<VK>::T;
  using IT = typename dhr::Elem<IK>::T;
  extern __shared__ unsigned char smem[];
  float* s_qv = reinterpret_cast<float*>(smem);
  int32_t* s_qi = reinterpret_cast<int32_t*>(s_qv + dim);

  const int64_t b = blockIdx.y;
  for (int j = threadIdx.x; j < dim; j += blockDim.x) {
    s_qv[j] = qv[b * dim + j];
  }
  for (int j = threadIdx.x; j < lex_dim; j += blockDim.x) {
    s_qi[j] = qi[b * qi_stride + j];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int k_begin = (blockIdx.x * kWarps + warp) * kCandPerWarp;
  const int k_end = min(k_begin + kCandPerWarp, n_cand);
  for (int k = k_begin; k < k_end; ++k) {
    const int64_t r = rows[b * n_cand + k];
    const bool valid = r >= 0 && r < n_rows;
    float acc = 0.f;
    if (valid) {
      const VT* vrow = values + r * dim;
      const IT* irow = indices + r * lex_dim;
      for (int j = lane; j < lex_dim; j += 32) {
        const float p = dhr::to_f32<VK>(vrow[j]) * s_qv[j];
        acc += static_cast<int>(irow[j]) == s_qi[j] ? p : 0.f;
      }
      for (int j = lex_dim + lane; j < dim; j += 32) {
        acc += dhr::to_f32<VK>(vrow[j]) * s_qv[j];
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      }
    }
    if (lane == 0) {
      out[b * n_cand + k] = valid ? acc : -__int_as_float(0x7f800000);
    }
  }
}

template <int VK, int IK>
cudaError_t launch(const void* qv, const void* qi, const void* rows,
                   const void* values, const void* indices, void* out,
                   int64_t n_rows, int batch, int n_cand, int dim,
                   int lex_dim, int qi_stride, cudaStream_t stream) {
  const int per_block = kWarps * kCandPerWarp;
  const dim3 grid((n_cand + per_block - 1) / per_block, batch);
  const size_t smem = static_cast<size_t>(dim + lex_dim) * 4;
  rerank_gip_kernel<VK, IK><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(qv), static_cast<const int32_t*>(qi),
      static_cast<const int64_t*>(rows),
      static_cast<const typename dhr::Elem<VK>::T*>(values),
      static_cast<const typename dhr::Elem<IK>::T*>(indices),
      static_cast<float*>(out), n_rows, n_cand, dim, lex_dim, qi_stride);
  return cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes.  Device pointers of contiguous tensors:
// qv f32 (B, dim), qi int32 (B, qi_stride) of which the first lex_dim
// columns are read, rows int64 (B, K), values (N, dim) of value_kind,
// indices (N, lex_dim) of index_kind, out f32 (B, K).  Launches on
// `stream`, allocates nothing, does not synchronise, and returns
// cudaGetLastError() of the launch.
extern "C" int rerank_gip_launch(const void* qv, const void* qi,
                                 const void* rows, const void* values,
                                 const void* indices, void* out,
                                 long long n_rows, int batch, int n_cand,
                                 int dim, int lex_dim, int qi_stride,
                                 int value_kind, int index_kind,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n = static_cast<int64_t>(n_rows);
  return dhr::dispatch_planes(value_kind, index_kind, [&](auto vk, auto ik) {
    return launch<decltype(vk)::value, decltype(ik)::value>(
        qv, qi, rows, values, indices, out, n, batch, n_cand, dim, lex_dim,
        qi_stride, s);
  });
}
