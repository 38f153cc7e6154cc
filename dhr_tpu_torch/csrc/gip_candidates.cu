// K3: the theta pass fused with a per-group (max, argmax) reduction, for
// sm_90a.
//
// Replaces the Pallas TPU kernel pallas_gip_candidates
// (dhr_tpu/ops/pallas_gip.py:346-461, kernel body _make_candidates_kernel at
// 228-318).  For each query b it forms K1's f32 sums
//
//   s[b, r] = sum_i  w_i * values_T[d_i, r] * gate_i(r)
//
// with K1's arithmetic (order of the important dims, each product rounded
// before its add, zero weights skipped, a closed gate adding nothing), so
// the sums are K1's bit for bit, then reduces every group of G rows to its
// best row.  The partition is the reference's: row r sits at reduced
// position p = (r / (128 G)) * 128 + r % 128 with local index
// j = (r / 128) % G, i.e. a group is the G rows that share a lane across G
// consecutive 128-row blocks.  The first maximum in j order wins (strict
// >).  Rows >= N take no part; a group without a valid row holds -inf, with
// j = 0 (packed) or row id N (two planes).
//
// Outputs, (B, P) each with P = ceil(N / (128 G)) * 128:
// - packed (G a power of two): one f32 plane, the winner's j in the low
//   log2(G) mantissa bits: int_as_float((float_as_int(best) & -G) | j);
// - two planes: the f32 maximum cast once to f32 or bf16, and the winner's
//   absolute row as int32.
//
// What bounds it: bytes, if each input is read once (K1's reads, and a
// write G times smaller than K1's); as built, instruction issue, as for K1.
// The batch's queries share most of their dims (753 distinct of 4,623
// non-zero (query, dim) pairs at the bench batch), so the design is K1's,
// walked over whole groups:
// - the host plan (ops/gip_candidates.py candidates_plan: K1's
//   staging_plan with this kernel's tile picker) gives U, the batch's
//   distinct used dims, per-query entries in order, counts, the queries in
//   order of their counts, the tile T and query chunks;
// - a 1-D grid over (group block gb, lane tile l0): a block owns T lanes
//   of one group block and walks its steps j = 0..G-1 that hold a valid
//   row, at step j staging rows gb 128 G + j 128 + l0 .. + T of every U
//   dim's value row, of the lexical ones' fold rows and one zero fold row
//   (CLS dims gate against it with gate 0) into shared memory with 16-byte
//   cp.async (the pitch is padded and T is a multiple of 16 elements, so
//   every segment starts 16-byte aligned; copies past N zero-fill);
// - one staging buffer, so two blocks share an SM (T = 64 at the bench
//   batch: 93 KB each) and one block's copies overlap the other's
//   arithmetic;
// - each step computes every query of the chunk from the staged copy with
//   K1's lanes (8 rows per lane, T / 8 lanes per query, int8 widened by
//   PRMT + FADD, folds compared a word at a time, a product added only
//   where its gate opens) and folds the sums into a running (best, j) per
//   (query, row) in registers.  A warp holds two groups of queries for the
//   whole walk, a light one and a heavy one in the count order, so the
//   warps of a block reach each step's barrier together; the host keeps a
//   chunk within a block's 16 warps x 2 groups.  Rows past N take no part:
//   their zero-filled copies would otherwise compete with 0.0;
// - after the walk each lane writes its queries' 8 reduced lanes once.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;         // rows per lane
constexpr int kGroups = 2;       // query groups per warp
constexpr int kLane = 128;       // lanes of a group block
constexpr int kMaxGroup = 256;   // j travels in a byte
// (query, row) pairs whose running maxima a block holds: a launch takes
// batch * T <= kQueryRows
constexpr int kQueryRows = kThreads * kGroups * kRows;
constexpr int kNoSlot = 0xFFFF;  // key slot of an entry past a query's count

template <int VK, int IK, int OK, bool PACKED, int T>
__global__ void __launch_bounds__(kThreads, 2)
gip_candidates_kernel(const int2* __restrict__ entries,
                      const int32_t* __restrict__ counts,
                      const int32_t* __restrict__ order,
                      const int32_t* __restrict__ dims_u,
                      const typename dhr::Elem<VK>::T* __restrict__ values_t,
                      const typename dhr::Elem<IK>::T* __restrict__ indices_t,
                      typename dhr::Elem<OK>::T* __restrict__ out_vals,
                      int32_t* __restrict__ out_rows, int64_t n_rows,
                      int64_t v_pitch, int64_t i_pitch, int64_t n_red,
                      int batch, int n_imp, int n_u, int n_lex, int group) {
  using VT = typename dhr::Elem<VK>::T;
  using IT = typename dhr::Elem<IK>::T;
  using OT = typename dhr::Elem<OK>::T;
  constexpr int R = kRows;
  constexpr int L = T / R;    // lanes per query: 16, 8, 4 or 2
  constexpr int QW = 32 / L;  // queries per warp at a time
  constexpr int kVPer = 16 / static_cast<int>(sizeof(VT));
  constexpr int kIPer = 16 / static_cast<int>(sizeof(IT));
  constexpr int kVChunks = T / kVPer;  // 16-byte chunks per staged row
  constexpr int kIChunks = T / kIPer;
  constexpr int kTiles = kLane / T;    // lane tiles per group block

  // values [n_u][T], folds [n_lex + 1][T]
  extern __shared__ __align__(16) unsigned char smem[];
  VT* const s_v = reinterpret_cast<VT*>(smem);
  IT* const s_i = reinterpret_cast<IT*>(smem + static_cast<size_t>(n_u) * T *
                                                   sizeof(VT));

  const int64_t gb = blockIdx.x / kTiles;
  const int l0 = (blockIdx.x % kTiles) * T;
  const int64_t row0 = gb * kLane * group + l0;  // the tile's row at step 0
  // steps that hold a valid row; at least one, so a tile past N still
  // writes its -inf lanes
  const int64_t left = n_rows - row0;
  const int64_t steps = (left + kLane - 1) / kLane;
  const int n_steps = left <= 0      ? 1
                      : steps < group ? static_cast<int>(steps)
                                      : group;

  // fold row n_lex stays zero: CLS entries read it with gate 0 (open)
  const int n_vc = n_u * kVChunks;
  const int n_chunks = n_vc + (n_lex + 1) * kIChunks;
  const auto stage = [&](int j) {
    const int64_t n0 = row0 + static_cast<int64_t>(j) * kLane;
    for (int c = threadIdx.x; c < n_chunks; c += kThreads) {
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
  };

  const int lane = threadIdx.x & 31;
  const int sub = lane / L, ll = lane % L;
  const int r0 = ll * R;
  const int warp = threadIdx.x >> 5;
  // An entry past a query's count: skipped, or for int8 values (always
  // finite) weight 0 on slot 0, whose products (+-0) leave the sums' bits
  // as they are, so the loop needs no test.
  constexpr bool kTestSkip = VK != dhr::kI8;
  const int2 past = make_int2(0, kTestSkip ? kNoSlot : 0);
  // The warp's kGroups groups of QW queries (positions in the count order),
  // the same at every step: groups w and 2 n_warps - 1 - w, so that a warp
  // with light queries also takes heavy ones.  The host keeps a chunk
  // within kWarps * kGroups * QW queries.
  const auto first_query = [&](int g) {
    return (g == 0 ? warp : 2 * kWarps - 1 - warp) * QW;
  };
  // running first maximum over the steps, in j order (strict >), and its
  // j, a byte per row
  float best[kGroups][R];
  uint32_t best_j[kGroups][R / 4];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
#pragma unroll
    for (int r = 0; r < R; ++r) best[g][r] = __uint_as_float(0xff800000u);
#pragma unroll
    for (int k = 0; k < R / 4; ++k) best_j[g][k] = 0u;
  }

  stage(0);
  for (int j = 0; j < n_steps; ++j) {
    dhr::cp_async_wait_all();
    __syncthreads();  // step j has landed
    const VT* my_v = s_v + r0;
    const IT* my_i = s_i + r0;
    // rows past N take no part (their copies read as 0)
    const int64_t n_valid = n_rows - row0 - static_cast<int64_t>(j) * kLane -
                            r0;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int qb = first_query(g);
      if (qb >= batch) continue;  // the whole warp: no shuffle partner waits
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
        for (int i = 0; i < m; ++i) {
          const float w =
              __int_as_float(__shfl_sync(0xffffffffu, mine.x, i, L));
          const int key = __shfl_sync(0xffffffffu, mine.y, i, L);
          const int slot = key & 0xFFFF;
          if (kTestSkip && slot == kNoSlot) continue;
          float x[R];
          dhr::widen<VK>(my_v + slot * T, x);
          bool open[R];
          dhr::gates<IK>(my_i + min(slot, n_lex) * T, key >> 16, open);
          // a closed gate adds +0.0 in the plain version, which leaves an
          // f32 sum (never -0.0) as it is: add only where the gate opens
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (open[r]) acc[r] = __fadd_rn(acc[r], __fmul_rn(x[r], w));
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < n_valid && (j == 0 || acc[r] > best[g][r])) {
          best[g][r] = acc[r];
          best_j[g][r / 4] = __byte_perm(
              best_j[g][r / 4], j,
              (0x3210 & ~(0xF << (4 * (r % 4)))) | (4 << (4 * (r % 4))));
        }
      }
    }
    if (j + 1 < n_steps) {
      __syncthreads();  // every lane is done with the buffer
      stage(j + 1);
    }
  }

  // each lane writes its queries' R reduced lanes once
  const int64_t p = gb * kLane + l0 + r0;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int q = first_query(g) + sub;
    if (q >= batch) continue;
    const size_t o = static_cast<size_t>(__ldg(order + q)) * n_red + p;
    const auto jr = [&](int r) {
      return static_cast<int>((best_j[g][r / 4] >> (8 * (r % 4))) & 0xFFu);
    };
    if constexpr (PACKED) {
      float v[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        v[r] = __int_as_float((__float_as_int(best[g][r]) & -group) | jr(r));
      }
      dhr::store_vec(out_vals + o, R, v);
    } else {
      OT v[R];
      int32_t rows[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        v[r] = dhr::from_f32<OK>(best[g][r]);
        const int64_t first = row0 + r0 + r;  // the group's row at j = 0
        rows[r] = static_cast<int32_t>(
            first < n_rows ? first + static_cast<int64_t>(jr(r)) * kLane
                           : n_rows);
      }
      dhr::store_vec(out_vals + o, R, v);
      dhr::store_vec(out_rows + o, R, rows);
    }
  }
}

template <int VK, int IK, int OK, bool PACKED, int T>
cudaError_t launch(const void* entries, const void* counts, const void* order,
                   const void* dims_u, const void* values_t,
                   const void* indices_t, void* out_vals, void* out_rows,
                   int64_t n_rows, int64_t v_pitch, int64_t i_pitch,
                   int64_t n_red, int batch, int n_imp, int n_u, int n_lex,
                   int group, cudaStream_t stream) {
  auto* kernel = gip_candidates_kernel<VK, IK, OK, PACKED, T>;
  const size_t smem =
      static_cast<size_t>(T) *
      (static_cast<size_t>(n_u) * sizeof(typename dhr::Elem<VK>::T) +
       static_cast<size_t>(n_lex + 1) * sizeof(typename dhr::Elem<IK>::T));
  if (static_cast<int64_t>(batch) * T > kQueryRows) {
    return cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int64_t blocks = n_red / kLane * (kLane / T);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const int2*>(entries), static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(order), static_cast<const int32_t*>(dims_u),
      static_cast<const typename dhr::Elem<VK>::T*>(values_t),
      static_cast<const typename dhr::Elem<IK>::T*>(indices_t),
      static_cast<typename dhr::Elem<OK>::T*>(out_vals),
      static_cast<int32_t*>(out_rows), n_rows, v_pitch, i_pitch, n_red, batch,
      n_imp, n_u, n_lex, group);
  return cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes.  Pointers are device pointers: entries,
// counts, order and dims_u as K1's (csrc/partial_gip.cu), for `batch`
// queries; values_T (dim, N) of value_kind at row pitch v_pitch and
// indices_T (lex_dim, N) of index_kind at row pitch i_pitch (elements;
// each row 16-byte aligned); out_vals (batch, n_red) f32 (packed) or
// out_kind, out_rows (batch, n_red) int32 (ignored when packed), n_red =
// ceil(N / (128 group)) * 128.  group is 1..256, tile 128, 64, 32 or 16.
// Launches on `stream`, allocates nothing, does not synchronise, and
// returns the first CUDA error of the set-up or the launch.  A launch
// takes batch * tile <= the query rows of gip_candidates_limits.
extern "C" int gip_candidates_launch(
    const void* entries, const void* counts, const void* order,
    const void* dims_u, const void* values_t, const void* indices_t,
    void* out_vals, void* out_rows, long long n_rows, long long v_pitch,
    long long i_pitch, long long n_red, int batch, int n_imp, int n_u,
    int n_lex, int group, int tile, int value_kind, int index_kind,
    int out_kind, int packed, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group < 1 || group > kMaxGroup) return cudaErrorInvalidValue;
  return dhr::dispatch_planes(value_kind, index_kind, [&](auto vk, auto ik) {
    constexpr int VK = decltype(vk)::value, IK = decltype(ik)::value;
    return dhr::dispatch_tile(tile, [&](auto t) {
      constexpr int T = decltype(t)::value;
      if (packed) {
        return launch<VK, IK, dhr::kF32, true, T>(
            entries, counts, order, dims_u, values_t, indices_t, out_vals,
            out_rows, n_rows, v_pitch, i_pitch, n_red, batch, n_imp, n_u,
            n_lex, group, s);
      }
      return dhr::dispatch_out(out_kind, [&](auto ok) {
        return launch<VK, IK, decltype(ok)::value, false, T>(
            entries, counts, order, dims_u, values_t, indices_t, out_vals,
            out_rows, n_rows, v_pitch, i_pitch, n_red, batch, n_imp, n_u,
            n_lex, group, s);
      });
    });
  });
}

// The launch limits the host's plan (ops/gip_candidates.py) is held to:
// the (query, row) pairs whose running maxima a block holds, and the
// largest group.
extern "C" void gip_candidates_limits(int* query_rows, int* max_group) {
  *query_rows = kQueryRows;
  *max_group = kMaxGroup;
}
