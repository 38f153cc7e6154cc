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
// read: its score is -inf, so it sorts last.  Sums are f32 in the kernel's
// own order (fused multiply-adds, then a warp reduction), within 1e-4
// relative of the plain version.
//
// What bounds it: bytes.  Each candidate reads one row of the row-major
// value plane (D values) and of the index plane (lex indices), which no
// (B, K, D) gathered copy ever holds.  Design against that:
// - grid (ceil(K / 128), B): a block of 8 warps serves 128 candidates of
//   one query, 16 per warp; the query's qv (f32) and qi (int32) are staged
//   once in shared memory per block;
// - one warp per candidate row; rows of whole 16-byte words (the word path:
//   D = 896 int8 is 56 value and 48 fold words) are copied with 16-byte
//   cp.async into a per-warp ring of kAhead = 2 rows in shared memory, so
//   each warp loads the next row while it reduces one, and no register
//   holds a row in flight (rings of 4 and 8 rows measured slower: the
//   gather runs at the memory's rate for random 1.6 KB rows, PERF.md);
// - lane l takes the row's value words l, l + 32, ... and the fold words of
//   the same dims, and holds its 32 dims of the query in registers for all
//   its candidates: qv as f32 and the gates packed like the folds (a gate
//   outside the folds' range can open no gate: its qv is held as 0, whose
//   products leave the f32 sum as it is);
// - values widen without I2F (dhr::widen_words) and folds compare a word
//   at a time (dhr::gates_words); a product is added only where its gate
//   opens;
// - rows that are not whole 16-byte words (D, lex not multiples of the
//   elements per word, folds not 16-byte rows, more than 32 dims a lane,
//   planes not aligned) take an element path: one element a lane, the
//   query from shared memory.  No multiple-of-128 rule on D, lex or K.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCandPerWarp = 16;
constexpr int kDimsPerLane = 32;  // query dims a lane holds (word path)
constexpr int kAhead = 2;         // ring slots per warp: rows in flight + 1

// three blocks an SM: 2% faster than the two the registers would allow
template <int VK, int IK, bool WORDS>
__global__ void __launch_bounds__(kThreads, 3)
rerank_gip_kernel(const float* __restrict__ qv, const int32_t* __restrict__ qi,
                  const int64_t* __restrict__ rows,
                  const typename dhr::Elem<VK>::T* __restrict__ values,
                  const typename dhr::Elem<IK>::T* __restrict__ indices,
                  float* __restrict__ out, int64_t n_rows, int n_cand,
                  int dim, int lex_dim, int qi_stride) {
  using VT = typename dhr::Elem<VK>::T;
  using IT = typename dhr::Elem<IK>::T;
  // the query (qv f32 [dim], qi int32 [lex_dim]), then each warp's ring of
  // kAhead candidate rows (word path): values, then folds
  extern __shared__ __align__(16) unsigned char smem[];
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
  const int k0 = (blockIdx.x * kWarps + warp) * kCandPerWarp;
  const int n_mine = min(kCandPerWarp, n_cand - k0);
  if (n_mine <= 0) return;
  // lane i holds the row id of the warp's candidate i
  const int64_t my_row = lane < n_mine ? rows[b * n_cand + k0 + lane] : -1;
  const auto valid = [&](int64_t r) { return r >= 0 && r < n_rows; };
  float result = __uint_as_float(0xff800000u);  // -inf: an invalid row

  if constexpr (WORDS) {
    constexpr int E = 16 / static_cast<int>(sizeof(VT));  // dims a word
    constexpr int C = kDimsPerLane / E;                    // words a lane
    constexpr int FW = dhr::kWords<IK, E>;  // fold words of a value word
    constexpr int kBits = 8 * static_cast<int>(sizeof(IT));
    constexpr int kPer = 32 / kBits;  // folds per word
    const int n_vw = dim / E, n_lw = lex_dim / E;
    const int v_bytes = dim * static_cast<int>(sizeof(VT));
    const int f_bytes = lex_dim * static_cast<int>(sizeof(IT));
    const int row_bytes = v_bytes + f_bytes;
    unsigned char* ring =
        smem + ((dim + lex_dim) * 4 + 15) / 16 * 16 +
        static_cast<size_t>(warp) * kAhead * row_bytes;
    // the query's dims of this lane's words, in registers
    float q[C][E];
    uint32_t g[C][FW];
#pragma unroll
    for (int kc = 0; kc < C; ++kc) {
      const int c = lane + 32 * kc;
#pragma unroll
      for (int k = 0; k < FW; ++k) g[kc][k] = 0u;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int d = c * E + e;
        q[kc][e] = c < n_vw ? s_qv[d] : 0.f;
        if (c < n_lw) {
          const int gate = s_qi[d];
          if (gate < -(1 << (kBits - 1)) || gate >= (1 << (kBits - 1))) {
            q[kc][e] = 0.f;  // no fold can equal it
          }
          g[kc][e / kPer] |= (static_cast<uint32_t>(gate) &
                              ((1u << kBits) - 1u))
                             << (kBits * (e % kPer));
        }
      }
    }
    // copy candidate i's row into ring slot i % kAhead, 16 bytes a lane a
    // time, as one cp.async group (empty past the warp's candidates)
    const auto issue = [&](int i) {
      const int64_t r = __shfl_sync(0xffffffffu, my_row, i & 31);
      if (i < n_mine && valid(r)) {
        unsigned char* slot = ring + (i % kAhead) * row_bytes;
        const unsigned char* vsrc =
            reinterpret_cast<const unsigned char*>(values) + r * v_bytes;
        const unsigned char* fsrc =
            reinterpret_cast<const unsigned char*>(indices) + r * f_bytes;
        for (int c = lane; c < v_bytes / 16; c += 32) {
          dhr::cp_async16(slot + 16 * c, vsrc + 16 * c, 16);
        }
        for (int c = lane; c < f_bytes / 16; c += 32) {
          dhr::cp_async16(slot + v_bytes + 16 * c, fsrc + 16 * c, 16);
        }
      }
      dhr::cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i < kAhead - 1; ++i) issue(i);
    for (int i = 0; i < n_mine; ++i) {
      issue(i + kAhead - 1);  // into the slot candidate i - 1 left
      dhr::cp_async_wait_group<kAhead - 1>();  // candidate i has landed
      __syncwarp();
      const unsigned char* slot = ring + (i % kAhead) * row_bytes;
      float acc[C];
#pragma unroll
      for (int kc = 0; kc < C; ++kc) {
        const int c = lane + 32 * kc;
        acc[kc] = 0.f;
        if (c >= n_vw) continue;
        uint32_t vw[4];
        dhr::load_vec(reinterpret_cast<const uint32_t*>(slot + 16 * c), vw);
        float x[E];
        dhr::widen_words<VK>(vw, x);
        if (c < n_lw) {
          uint32_t fw[FW];
          dhr::load_vec(
              reinterpret_cast<const uint32_t*>(slot + v_bytes + c * 4 * FW),
              fw);
          bool open[E];
          dhr::gates_words<IK>(fw, g[kc], open);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            if (open[e]) acc[kc] = fmaf(x[e], q[kc][e], acc[kc]);
          }
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) acc[kc] = fmaf(x[e], q[kc][e], acc[kc]);
        }
      }
      float sum = acc[0];
#pragma unroll
      for (int kc = 1; kc < C; ++kc) sum += acc[kc];
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      if (lane == i && valid(my_row)) result = sum;
      __syncwarp();  // every lane is done with the slot before its refill
    }
  } else {
    for (int i = 0; i < n_mine; ++i) {
      const int64_t r = __shfl_sync(0xffffffffu, my_row, i);
      if (!valid(r)) continue;
      const VT* vrow = values + r * dim;
      const IT* irow = indices + r * lex_dim;
      float acc = 0.f;
      for (int j = lane; j < lex_dim; j += 32) {
        if (static_cast<int>(irow[j]) == s_qi[j]) {
          acc = fmaf(dhr::to_f32<VK>(vrow[j]), s_qv[j], acc);
        }
      }
      for (int j = lex_dim + lane; j < dim; j += 32) {
        acc = fmaf(dhr::to_f32<VK>(vrow[j]), s_qv[j], acc);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      }
      if (lane == i) result = acc;
    }
  }
  if (lane < n_mine) out[b * n_cand + k0 + lane] = result;
}

template <int VK, int IK>
cudaError_t launch(const void* qv, const void* qi, const void* rows,
                   const void* values, const void* indices, void* out,
                   int64_t n_rows, int batch, int n_cand, int dim,
                   int lex_dim, int qi_stride, cudaStream_t stream) {
  constexpr int E = 16 / static_cast<int>(sizeof(typename dhr::Elem<VK>::T));
  const int per_block = kWarps * kCandPerWarp;
  const dim3 grid((n_cand + per_block - 1) / per_block, batch);
  const size_t query = static_cast<size_t>(dim + lex_dim) * 4;
  const size_t rings =
      static_cast<size_t>(kWarps) * kAhead *
      (static_cast<size_t>(dim) * sizeof(typename dhr::Elem<VK>::T) +
       static_cast<size_t>(lex_dim) * sizeof(typename dhr::Elem<IK>::T));
  const size_t words_smem = (query + 15) / 16 * 16 + rings;
  const bool words =
      dim % E == 0 && lex_dim % E == 0 && dim <= 32 * kDimsPerLane &&
      lex_dim * sizeof(typename dhr::Elem<IK>::T) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(values) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(indices) % 16 == 0 &&
      words_smem <= 227 * 1024;
  const size_t smem = words ? words_smem : query;
  auto go = [&](auto kernel) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(qv), static_cast<const int32_t*>(qi),
        static_cast<const int64_t*>(rows),
        static_cast<const typename dhr::Elem<VK>::T*>(values),
        static_cast<const typename dhr::Elem<IK>::T*>(indices),
        static_cast<float*>(out), n_rows, n_cand, dim, lex_dim, qi_stride);
    return cudaGetLastError();
  };
  return words ? go(rerank_gip_kernel<VK, IK, true>)
               : go(rerank_gip_kernel<VK, IK, false>);
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
