// K1: the theta-pass partial GIP over the dim-major planes, for sm_90a.
//
// Replaces the Pallas TPU kernel pallas_partial_gip
// (dhr_tpu/ops/pallas_gip.py:115-207, kernel body _make_kernel at 61-109).
// For each query b and corpus row n:
//
//   out[b, n] = sum_i  w_i * values_T[d_i, n] * gate_i(n)
//   gate_i(n) = d_i >= lex_dim  or  indices_T[d_i, n] == g_i
//
// over the query's I important dims, selected by the caller.  Accumulates
// in f32 in the order of the important dims (the plain version's order, and
// the reference scan's), each product rounded before its add (__fmul_rn /
// __fadd_rn, no contraction), zero weights skipped, and writes f32 or bf16
// once: the sums are the plain version's bits.
//
// What bounds it: bytes, if each input is read once; as built, instruction
// issue.  A batch's queries share most of their important dims (at the
// bench operating point 128 queries name ~750 distinct dims for ~4,600
// non-zero (query, dim) pairs), so the design reads each distinct dim row
// once per row tile for the whole batch, not once per query:
// - the host (ops/partial_gip.py staging_plan) gives U, the batch's sorted
//   distinct dims with a non-zero weight; per query its used dims in their
//   order as (weight, key) entries, key = the dim's slot in U and its gate;
//   a count per query; and the queries in order of their counts;
// - a 1-D grid over row tiles of T rows (T = 128 / 64 / 32 / 16, the
//   largest whose staged rows fit; 64 when that lets two blocks share an SM,
//   so one block's copies overlap the other's arithmetic);
// - each block stages the T-row segment of every U dim's value row, and of
//   the fold row for the lexical ones (U's first n_lex slots), plus one zero
//   fold row, into shared memory with 16-byte cp.async (rows start 16-byte
//   aligned: the planes' pitch is padded; the ragged last tile zero-fills
//   past N), then waits and barriers once;
// - then every query of the batch is computed from that copy: a group of
//   L = T / R lanes per query, each lane owning R = 8 consecutive rows, so
//   a warp holds 32 / L queries at a time, of similar counts (the order).
//   The group walks its query's entries in order; they come in with one
//   coalesced 8-byte load per L dims and reach the lanes by shuffles.  A
//   lane's R values (and folds) of one dim are one shared-memory access,
//   and a group's accesses of one dim are one contiguous segment;
// - per product: int8 values widen without I2F (a quarter-rate
//   instruction; dhr::widen), folds compare a 32-bit word at a time
//   (dhr::gates), CLS dims gate
//   against the zero fold row with gate 0 (always open: no branch), and a
//   product is added only where its gate opens;
// - each group writes its query's T outputs once, R per lane.
// HBM then moves each staged row once per tile (the each-input-once
// bytes); what is left is instruction issue, ~5 per gated product plus the
// per-dim cost (shuffles, addressing, two loads) over R.  R = 8 beat 4 and
// 16 on the card, and T = 64 beat 32 and 128; a persistent variant with
// two staging buffers per block (one block an SM) measured slower: one
// barrier per tile across 32 warps of unequal work (PERF.md).

#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kRows = 8;         // rows per lane
constexpr int kNoSlot = 0xFFFF;  // key slot of an entry past a query's count

template <int VK, int IK, int OK, int T>
__global__ void __launch_bounds__(kThreads, 2)
partial_gip_kernel(const int2* __restrict__ entries,
                   const int32_t* __restrict__ counts,
                   const int32_t* __restrict__ order,
                   const int32_t* __restrict__ dims_u,
                   const typename dhr::Elem<VK>::T* __restrict__ values_t,
                   const typename dhr::Elem<IK>::T* __restrict__ indices_t,
                   typename dhr::Elem<OK>::T* __restrict__ out,
                   int64_t n_rows, int64_t v_pitch, int64_t i_pitch,
                   int batch, int n_imp, int n_u, int n_lex) {
  using VT = typename dhr::Elem<VK>::T;
  using IT = typename dhr::Elem<IK>::T;
  using OT = typename dhr::Elem<OK>::T;
  constexpr int R = kRows;
  constexpr int L = T / R;    // lanes per query: 32, 16, 8 or 4
  constexpr int QW = 32 / L;  // queries per warp at a time
  constexpr int kVPer = 16 / static_cast<int>(sizeof(VT));
  constexpr int kIPer = 16 / static_cast<int>(sizeof(IT));
  constexpr int kVChunks = T / kVPer;  // 16-byte chunks per staged row
  constexpr int kIChunks = T / kIPer;

  extern __shared__ __align__(16) unsigned char smem[];
  VT* s_v = reinterpret_cast<VT*>(smem);  // [n_u][T]
  IT* s_i = reinterpret_cast<IT*>(smem + static_cast<size_t>(n_u) * T *
                                             sizeof(VT));  // [n_lex + 1][T]
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * T;

  // fold row n_lex stays zero: CLS entries read it with gate 0 (open)
  const int n_vc = n_u * kVChunks;
  const int n_chunks = n_vc + (n_lex + 1) * kIChunks;
  for (int c = threadIdx.x; c < n_chunks; c += blockDim.x) {
    if (c < n_vc) {
      const int slot = c / kVChunks, k = c % kVChunks;
      dhr::stage16(
          s_v + slot * T + k * kVPer,
          values_t + static_cast<int64_t>(__ldg(dims_u + slot)) * v_pitch,
          n0 + k * kVPer, n_rows);
    } else {
      const int slot = (c - n_vc) / kIChunks, k = (c - n_vc) % kIChunks;
      const int d = slot < n_lex ? __ldg(dims_u + slot) : 0;
      dhr::stage16(s_i + slot * T + k * kIPer,
                   indices_t + static_cast<int64_t>(d) * i_pitch,
                   slot < n_lex ? n0 + k * kIPer : n_rows, n_rows);
    }
  }
  dhr::cp_async_wait_all();
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int sub = lane / L, ll = lane % L;
  const int r0 = ll * R;
  const int64_t n_valid = n_rows - n0 - r0;
  const VT* my_v = s_v + r0;
  const IT* my_i = s_i + r0;
  // An entry past a query's count: skipped, or for int8 values (always
  // finite) weight 0 on slot 0, whose products (+-0) leave the sums' bits
  // as they are, so the loop needs no test.
  constexpr bool kTestSkip = VK != dhr::kI8;
  const int2 past = make_int2(0, kTestSkip ? kNoSlot : 0);
  const int n_warps = blockDim.x >> 5;
  for (int qb = (threadIdx.x >> 5) * QW; qb < batch; qb += n_warps * QW) {
    const bool active = qb + sub < batch;
    const int b = active ? __ldg(order + qb + sub) : 0;
    const int count = active ? __ldg(counts + b) : 0;
    int n_dims = count;  // the most of the warp's queries: shuffles need all
#pragma unroll
    for (int o = L; o < 32; o <<= 1) {
      n_dims = max(n_dims, __shfl_xor_sync(0xffffffffu, n_dims, o));
    }
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int i0 = 0; i0 < n_dims; i0 += L) {
      int2 mine = past;
      if (i0 + ll < count) {
        mine = __ldg(entries + static_cast<int64_t>(b) * n_imp + i0 + ll);
      }
      const int m = min(L, n_dims - i0);
      for (int j = 0; j < m; ++j) {
        const float w = __int_as_float(__shfl_sync(0xffffffffu, mine.x, j, L));
        const int key = __shfl_sync(0xffffffffu, mine.y, j, L);
        const int slot = key & 0xFFFF;
        if (kTestSkip && slot == kNoSlot) continue;
        float x[R];
        dhr::widen<VK>(my_v + slot * T, x);
        bool open[R];
        dhr::gates<IK>(my_i + min(slot, n_lex) * T, key >> 16, open);
        // a closed gate adds +0.0 in the plain version, which leaves an f32
        // sum (never -0.0) as it is: add only where the gate opens
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (open[r]) acc[r] = __fadd_rn(acc[r], __fmul_rn(x[r], w));
        }
      }
    }
    if (active) {
      OT o[R];
#pragma unroll
      for (int r = 0; r < R; ++r) o[r] = dhr::from_f32<OK>(acc[r]);
      dhr::store_vec(out + static_cast<int64_t>(b) * n_rows + n0 + r0,
                     n_valid, o);
    }
  }
}

template <int VK, int IK, int OK, int T>
cudaError_t launch(const void* entries, const void* counts, const void* order,
                   const void* dims_u,
                   const void* values_t, const void* indices_t, void* out,
                   int64_t n_rows, int64_t v_pitch, int64_t i_pitch,
                   int batch, int n_imp, int n_u, int n_lex,
                   cudaStream_t stream) {
  auto* kernel = partial_gip_kernel<VK, IK, OK, T>;
  const size_t smem =
      static_cast<size_t>(T) *
      (static_cast<size_t>(n_u) * sizeof(typename dhr::Elem<VK>::T) +
       static_cast<size_t>(n_lex + 1) * sizeof(typename dhr::Elem<IK>::T));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int64_t tiles = (n_rows + T - 1) / T;
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(tiles), kThreads, smem, stream>>>(
      static_cast<const int2*>(entries), static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(order), static_cast<const int32_t*>(dims_u),
      static_cast<const typename dhr::Elem<VK>::T*>(values_t),
      static_cast<const typename dhr::Elem<IK>::T*>(indices_t),
      static_cast<typename dhr::Elem<OK>::T*>(out), n_rows, v_pitch, i_pitch,
      batch, n_imp, n_u, n_lex);
  return cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes.  Pointers are device pointers: entries int32
// (B, I, 2) contiguous, entries[b, i] = (bits of the f32 weight, slot |
// gate << 16) for i < counts[b] (a lexical dim's gate within the folds'
// range, a CLS dim's 0), counts int32 (B,), order int32 (B,) a permutation
// of the queries; dims_u int32 (n_u,), sorted, the first n_lex of them
// < lex_dim; values_T (dim, N) of value_kind at row pitch v_pitch and
// indices_T (lex_dim, N) of index_kind at row pitch i_pitch (elements; each
// row 16-byte aligned); out (B, N) of out_kind, contiguous.  tile is 128,
// 64, 32 or 16.  Launches on `stream`, allocates nothing, does not
// synchronise, and returns the first CUDA error of the set-up or the launch.
extern "C" int partial_gip_launch(const void* entries, const void* counts,
                                  const void* order,
                                  const void* dims_u, const void* values_t,
                                  const void* indices_t, void* out,
                                  long long n_rows, long long v_pitch,
                                  long long i_pitch, int batch, int n_imp,
                                  int n_u, int n_lex, int tile,
                                  int value_kind, int index_kind,
                                  int out_kind, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dhr::dispatch_planes(value_kind, index_kind, [&](auto vk, auto ik) {
    return dhr::dispatch_out(out_kind, [&](auto ok) {
      constexpr int VK = decltype(vk)::value, IK = decltype(ik)::value,
                    OK = decltype(ok)::value;
      const auto go = [&](auto t) {
        return launch<VK, IK, OK, decltype(t)::value>(
            entries, counts, order, dims_u, values_t, indices_t, out, n_rows,
            v_pitch, i_pitch, batch, n_imp, n_u, n_lex, s);
      };
      return dhr::dispatch_tile(tile, go);
    });
  });
}
