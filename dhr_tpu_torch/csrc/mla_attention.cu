// K6: the core of multi-head latent attention (MLA), for sm_90a.
//
// Replaces no Pallas kernel: the JAX package has no decoder.  It does all
// that the port's MLA (dhr_tpu_torch/models/decoder.py MLA.forward)
// computes between its projections' outputs and o_proj, which ran as ~30
// eager passes a layer (ops/mla_attention.py mla_attention_plain): the
// rope of q_pe and k_pe, the two cats and k_pe's expansion over the heads,
// q k^T, the scale and the causal bias, the f32 softmax and its cast, P V
// and the heads' merge.  For passage b, head h, query i and key j (n heads
// of DN + DR for q and k, DV for v):
//
//   s[i, j]   = (q_nope[i, h] . k_nope[j, h] + rope(q_pe[i, h]) . rope(k_pe[j])) * scale
//   j visible to i  iff  j <= i and mask[b, j] > 0
//   p~[i, j]  = exp(s[i, j] - max_j s[i, j]) over the visible keys
//   out[i, h] = sum_j bf16(p~[i, j]) v[j, h] / sum_j bf16(p~[i, j])
//
// The products accumulate in f32 and are scaled in f32 (the eager chain
// rounds the scores to bf16 twice: the product's output and the scaled
// score); the softmax is f32 and online over key tiles; P is rounded to
// bf16 before P V, as the eager cast of the probabilities does (here
// before the division by the sum, which is of the rounded values), and
// P V accumulates in f32.  A query with no visible key writes zeros.
//
// rope (decoder.py apply_rope) de-interleaves its d = DR values and
// rotates them.  The kernel rotates each interleaved pair (x_2m, x_2m+1)
// in place instead:
//
//   y_2m   = x_2m   * cos[m] - x_2m+1 * sin[m]
//   y_2m+1 = x_2m+1 * cos[m] + x_2m   * sin[m]
//
// each product and the sum rounded in f32 as the eager passes round them,
// then rounded to bf16.  The tables repeat their first half (cos[m + d/2]
// = cos[m], sin alike: decoder.py rotary's, whose halves are the same
// angles), so these are the eager rope's values bit for bit, in
// interleaved order instead of de-interleaved, and the kernel reads the
// first half alone.  The same permutation of q_pe and k_pe leaves every
// product q_pe . k_pe unchanged.
//
// What bounds it: bytes.  A layer reads q (T x n(DN+DR)), kv (T x
// n(DN+DV)) and k_pe (T x DR) once and writes T x n DV: ~0.38 GB at the
// dsv2 cell's ~20,500 tokens (0.11 ms at 3.35 TB/s), against ~17 GFLOP of
// products.  Design against that:
// - one block a (head, query tile of 64 rows, passage): 4 warps of 16
//   query rows; blocks of one passage and tile run side by side, so k_pe,
//   read by each of the n heads' blocks, comes from L2;
// - the query tile and each tile of 64 keys (k_nope beside k_pe) and of 64
//   values staged in shared memory by cp.async, rows padded by 16 bytes
//   (ldmatrix without bank conflicts); rope applied in place after the
//   wait, each 16-byte chunk by the thread that staged it, with cos and
//   sin loaded before the wait (half tables: 16 KB a tile of positions,
//   which stays in L1); q_pe is staged as k_pe is, so where the two
//   tiles lie at the same positions one load serves both;
// - warps whose rows all lie past the length, and key pairs past the
//   length or the warp's last row, skip their products;
// - products on the tensor cores, mma.sync m16n8k16 (bf16 in, f32 out),
//   operands by ldmatrix (FlashAttention-2's shape): the scores and P stay
//   in registers, P's operand being the scores' accumulators rounded;
// - causal tile skipping: query tile t reads key tiles 0..t alone;
// - key tile t+1 loads during tile t's softmax and P V, value tile t+1
//   during tile t+1's scores;
// - the output staged through the warp's own query rows, written with
//   16-byte stores.
// Any length: rows past it are zero-filled and never visible.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;  // query rows a block; key rows a tile

struct Params {
  const uint16_t* q;    // (B, L, heads * (DN + DR)), contiguous
  const uint16_t* kv;   // (B, L, heads * (DN + DV)), contiguous
  const uint16_t* kpe;  // token t's k_pe at kpe + t * kpe_pitch
  const float* cos;     // (L, DR)
  const float* sin;     // (L, DR)
  const uint8_t* mask;  // (B, L): nonzero where the key is real
  uint16_t* out;        // (B, L, heads * DV)
  long long kpe_pitch;
  int length, heads;
  float scale_log2;     // scale * log2(e)
};

__device__ __forceinline__ float neg_inf() {
  return __uint_as_float(0xff800000u);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const uint16_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4],
                                          const uint16_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2],
                                          const uint16_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a b: one m16n8k16 product, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

__device__ __forceinline__ float bf(uint16_t x) {
  return dhr::to_f32<dhr::kBF16>(x);
}

__device__ __forceinline__ uint16_t to_bf(float x) {
  return dhr::from_f32<dhr::kBF16>(x);
}

template <int DN, int DR, int DV>
struct Shape {
  static constexpr int QK = DN + DR;
  static constexpr int QS = QK + 8;  // row stride of the q and k tiles
  static constexpr int VS = DV + 8;  // row stride of the value tile
  static constexpr int QBytes = kTile * QS * 2;
  static constexpr int VBytes = kTile * VS * 2;
  // q tile, key tile, value tile, the key tile's visibility flags
  static constexpr int Smem = 2 * QBytes + VBytes + kTile;
  static_assert(DN % 8 == 0 && DR % 8 == 0 && DV % 8 == 0,
                "16-byte chunks of each part");
  static_assert(QK % 16 == 0, "whole k-steps of the scores' product");
};

// cp.async the C 16-byte chunks of each of a tile's kTile rows: row r is
// token tok0 + r of src (rows pitch elements apart) and lands at
// dst + r * S; rows r >= live are zero-filled.
template <int C, int S>
__device__ __forceinline__ void stage(uint16_t* dst, const uint16_t* src,
                                      int64_t pitch, int64_t tok0,
                                      int live) {
  constexpr int kIters = (kTile * C + kThreads - 1) / kThreads;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    if (kTile * C % kThreads == 0 || idx < kTile * C) {
      const int r = idx / C, c = idx - r * C;
      const bool real = r < live;
      const uint16_t* from = real ? src + (tok0 + r) * pitch + c * 8 : src;
      dhr::cp_async16(dst + r * S + c * 8, from, real ? 16 : 0);
    }
  }
}

// The rope chunks of a tile: its rows' d_rope values staged as DR / 8
// chunks of 16 bytes a row by stage<DR / 8, S>, which gives thread t the
// chunks idx = t + it * kThreads (row idx / (DR / 8)).  The query tile's
// and a key tile's rope columns are staged alike, so a thread's chunks of
// the two lie at the same positions where the tiles do.
template <int DR>
struct Rope {
  static constexpr int C = DR / 8;  // chunks a row
  static constexpr int kIters = (kTile * C + kThreads - 1) / kThreads;
  float4 cs[kIters][2];  // each chunk's cos and sin

  // Load the cos and sin of this thread's chunks of the rows below live,
  // at positions pos0 + row: chunk c holds the pairs m = 4c .. 4c + 3,
  // whose cos[m] and sin[m] the second halves repeat.
  __device__ __forceinline__ void load(const float* cos, const float* sin,
                                       int pos0, int live) {
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int idx = threadIdx.x + it * kThreads;
      const int r = idx / C, c = idx - r * C;
      if (idx < kTile * C && r < live) {
        const int64_t m0 = static_cast<int64_t>(pos0 + r) * DR + c * 4;
        cs[it][0] = __ldg(reinterpret_cast<const float4*>(cos + m0));
        cs[it][1] = __ldg(reinterpret_cast<const float4*>(sin + m0));
      }
    }
  }

  // rope in place on this thread's chunks of the rows below live (tile at
  // the rope column, rows S elements apart), whose cp.async writes its
  // wait made visible to it: each pair of the chunk rotated as
  // decoder.py apply_rope rotates it, in f32, rounded to bf16.
  template <int S>
  __device__ __forceinline__ void apply(uint16_t* tile, int live) const {
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int idx = threadIdx.x + it * kThreads;
      const int r = idx / C, c = idx - r * C;
      if (idx >= kTile * C || r >= live) continue;
      uint16_t* at = tile + r * S + c * 8;
      const float co[4] = {cs[it][0].x, cs[it][0].y, cs[it][0].z,
                           cs[it][0].w};
      const float si[4] = {cs[it][1].x, cs[it][1].y, cs[it][1].z,
                           cs[it][1].w};
      uint16_t x[8];
      dhr::load_vec<uint16_t, 8>(at, x);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float x0 = bf(x[2 * u]), x1 = bf(x[2 * u + 1]);
        x[2 * u] = to_bf(__fadd_rn(__fmul_rn(x0, co[u]),
                                   __fmul_rn(-x1, si[u])));
        x[2 * u + 1] = to_bf(__fadd_rn(__fmul_rn(x1, co[u]),
                                       __fmul_rn(x0, si[u])));
      }
      dhr::store_vec<uint16_t, 8>(at, 8, x);
    }
  }
};

// flags[r]: key row r of the tile at token tok0 is real (r < live and its
// mask entry nonzero).  Plain stores: visible after the next barrier.
__device__ __forceinline__ void key_flags(unsigned char* flags,
                                          const uint8_t* mask, int64_t tok0,
                                          int live) {
  const int r = threadIdx.x;
  if (r < kTile) flags[r] = r < live && mask[tok0 + r] != 0;
}

template <int DN, int DR, int DV>
__global__ void __launch_bounds__(kThreads, 3)
mla_kernel(const Params p) {
  using Sh = Shape<DN, DR, DV>;
  constexpr int QK = Sh::QK, QS = Sh::QS, VS = Sh::VS;
  constexpr int kNV = DV / 8;  // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* qs = reinterpret_cast<uint16_t*>(smem);
  uint16_t* ks = reinterpret_cast<uint16_t*>(smem + Sh::QBytes);
  uint16_t* vs = reinterpret_cast<uint16_t*>(smem + 2 * Sh::QBytes);
  unsigned char* flags = smem + 2 * Sh::QBytes + Sh::VBytes;

  const int h = blockIdx.x, qt = blockIdx.y;
  const int L = p.length;
  const int64_t tok = static_cast<int64_t>(blockIdx.z) * L;  // the passage
  const int q0 = qt * kTile;
  const int64_t q_pitch = static_cast<int64_t>(p.heads) * QK;
  const int64_t kv_pitch = static_cast<int64_t>(p.heads) * (DN + DV);
  const uint16_t* q_src = p.q + static_cast<int64_t>(h) * QK;
  const uint16_t* k_src = p.kv + static_cast<int64_t>(h) * (DN + DV);
  const uint16_t* v_src = k_src + DN;
  const int q_live = min(kTile, L - q0);

  // two groups: the query tile with key tile 0, then value tile 0; the
  // rope's cos and sin and tile 0's key flags load meanwhile
  const int live0 = min(kTile, L);
  stage<DN / 8, QS>(qs, q_src, q_pitch, tok + q0, q_live);
  stage<DR / 8, QS>(qs + DN, q_src + DN, q_pitch, tok + q0, q_live);
  stage<DN / 8, QS>(ks, k_src, kv_pitch, tok, live0);
  stage<DR / 8, QS>(ks + DN, p.kpe, p.kpe_pitch, tok, live0);
  dhr::cp_async_commit();
  stage<DV / 8, VS>(vs, v_src, kv_pitch, tok, live0);
  dhr::cp_async_commit();
  {
    Rope<DR> rq;
    rq.load(p.cos, p.sin, q0, q_live);
    if (qt == 0) {  // key tile 0 lies at the query tile's positions
      key_flags(flags, p.mask, tok, live0);
      dhr::cp_async_wait_group<1>();
      rq.template apply<QS>(qs + DN, q_live);
      rq.template apply<QS>(ks + DN, live0);
    } else {
      Rope<DR> rk;
      rk.load(p.cos, p.sin, 0, live0);
      key_flags(flags, p.mask, tok, live0);
      dhr::cp_async_wait_group<1>();
      rq.template apply<QS>(qs + DN, q_live);
      rk.template apply<QS>(ks + DN, live0);
    }
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int w0 = q0 + warp * 16;     // the warp's first query row
  const bool busy = w0 < L;          // the warp has a row to compute
  const int row = w0 + g;            // this thread's rows: row, row + 8
  float o[kNV][4];
#pragma unroll
  for (int v = 0; v < kNV; ++v) o[v][0] = o[v][1] = o[v][2] = o[v][3] = 0.f;
  float m_run[2] = {neg_inf(), neg_inf()}, l_run[2] = {0.f, 0.f};

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    const int k_live = min(kTile, L - k0);
    // key pairs of 16 the warp reads: real keys up to its last row
    const int pairs = (min(k_live, w0 + 16 - k0) + 15) / 16;
    if (kt > 0) {  // (tile 0: the prologue)
      Rope<DR> rk;
      rk.load(p.cos, p.sin, k0, k_live);
      key_flags(flags, p.mask, tok + k0, k_live);
      dhr::cp_async_wait_group<1>();  // this key tile
      rk.template apply<QS>(ks + DN, k_live);
    }
    __syncthreads();

    // scores: the warp's 16 rows x 64 keys, 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    }
    if (busy) {
#pragma unroll
      for (int kk = 0; kk < QK / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, qs + (warp * 16 + (lane & 15)) * QS + kk * 16 +
                       (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (np < pairs) {
            uint32_t b[4];
            ldsm_x4(b, ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * QS +
                           kk * 16 + ((lane >> 3) & 1) * 8);
            mma(s[2 * np], a, b[0], b[1]);
            mma(s[2 * np + 1], a, b[2], b[3]);
          }
        }
      }
    }
    // online softmax in f32 (base 2: s * scale * log2(e))
    float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = nt * 8 + 2 * t4 + (e & 1);
        const bool seen = flags[j] && k0 + j <= row + (e >> 1) * 8;
        s[nt][e] = seen ? s[nt][e] * p.scale_log2 : neg_inf();
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
    __syncthreads();  // every warp is done with this key tile and its flags
    if (kt < qt) {
      const int n0 = k0 + kTile, n_live = min(kTile, L - n0);
      stage<DN / 8, QS>(ks, k_src, kv_pitch, tok + n0, n_live);
      stage<DR / 8, QS>(ks + DN, p.kpe, p.kpe_pitch, tok + n0, n_live);
    }
    dhr::cp_async_commit();

    float base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      base[r] = m_new == neg_inf() ? 0.f : m_new;
      const float alpha = exp2f(m_run[r] - base[r]);
      m_run[r] = m_new;
      l_run[r] *= alpha;
#pragma unroll
      for (int v = 0; v < kNV; ++v) {
        o[v][2 * r] *= alpha;
        o[v][2 * r + 1] *= alpha;
      }
    }

    dhr::cp_async_wait_group<1>();  // this value tile
    __syncthreads();
    // P, rounded to bf16, as the A operand of P V, 16 keys a step
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2) {
      uint32_t pa[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint16_t e[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          e[u] = to_bf(exp2f(s[2 * k2 + half][u] - base[u >> 1]));
          l_run[u >> 1] += bf(e[u]);
        }
        pa[2 * half] = pack(e[0], e[1]);
        pa[2 * half + 1] = pack(e[2], e[3]);
      }
      if (busy && k2 < pairs) {
        const uint16_t* vrow = vs + (k2 * 16 + (lane & 15)) * VS;
        if constexpr (DV % 16 == 0) {
#pragma unroll
          for (int np = 0; np < DV / 16; ++np) {
            uint32_t b[4];
            ldsm_x4_t(b, vrow + np * 16 + (lane >> 4) * 8);
            mma(o[2 * np], pa, b[0], b[1]);
            mma(o[2 * np + 1], pa, b[2], b[3]);
          }
        } else {
          uint32_t b[2];
          ldsm_x2_t(b, vrow);
          mma(o[0], pa, b[0], b[1]);
        }
      }
    }
    __syncthreads();  // every warp is done with this value tile
    if (kt < qt) {
      const int n0 = k0 + kTile;
      stage<DV / 8, VS>(vs, v_src, kv_pitch, tok + n0, min(kTile, L - n0));
    }
    dhr::cp_async_commit();
  }
  if (!busy) return;

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = l > 0.f ? 1.f / l : 0.f;
  }
  // stage the warp's 16 x DV outputs in its own query rows (only this
  // warp reads them), then 16-byte stores of whole rows
  uint16_t* mine = qs + warp * 16 * QS;
  __syncwarp();
#pragma unroll
  for (int v = 0; v < kNV; ++v) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      *reinterpret_cast<uint32_t*>(mine + (g + 8 * r) * QS + v * 8 +
                                   2 * t4) =
          pack(to_bf(o[v][2 * r] * inv[r]), to_bf(o[v][2 * r + 1] * inv[r]));
    }
  }
  __syncwarp();
  constexpr int kC = DV / 8;  // 16-byte chunks an output row
#pragma unroll
  for (int idx = lane; idx < 16 * kC; idx += 32) {
    const int r = idx / kC, c = idx - r * kC;
    const int i = w0 + r;
    if (i < L) {
      const uint4 val = *reinterpret_cast<const uint4*>(mine + r * QS + c * 8);
      *reinterpret_cast<uint4*>(
          p.out + ((tok + i) * p.heads + h) * DV + c * 8) = val;
    }
  }
}

template <int DN, int DR, int DV>
cudaError_t launch(const Params& p, long long batch, cudaStream_t stream) {
  using Sh = Shape<DN, DR, DV>;
  const cudaError_t e = cudaFuncSetAttribute(
      mla_kernel<DN, DR, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Sh::Smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.heads, (p.length + kTile - 1) / kTile,
                  static_cast<unsigned>(batch));
  mla_kernel<DN, DR, DV><<<grid, kThreads, Sh::Smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes.  Device pointers: q bf16 (B, L, heads *
// (d_nope + d_rope)) and kv bf16 (B, L, heads * (d_nope + d_v)),
// contiguous; k_pe bf16, token t's d_rope values at k_pe + t * kpe_pitch;
// cos, sin f32 (L, d_rope), contiguous, each row's second half repeating
// its first (read alone); mask uint8 (B, L), nonzero where the key is
// real, contiguous; out bf16 (B, L, heads * d_v).  Every pointer and pitch
// 16-byte aligned.  (d_nope, d_rope, d_v) is (128, 64, 128) or (8, 8, 8).
// Launches one kernel on `stream`, allocates nothing, does not
// synchronise, and returns cudaGetLastError() of the launch.
extern "C" int mla_attention_launch(const void* q, const void* kv,
                                    const void* k_pe, const void* cos,
                                    const void* sin, const void* mask,
                                    void* out, long long batch,
                                    long long length, int heads,
                                    long long kpe_pitch, int d_nope,
                                    int d_rope, int d_v, double scale,
                                    void* stream) {
  if (batch < 1 || batch > 65535 || length < 1 ||
      (length + kTile - 1) / kTile > 65535 || heads < 1 ||
      kpe_pitch < d_rope) {
    return cudaErrorInvalidValue;
  }
  Params p;
  p.q = static_cast<const uint16_t*>(q);
  p.kv = static_cast<const uint16_t*>(kv);
  p.kpe = static_cast<const uint16_t*>(k_pe);
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  p.mask = static_cast<const uint8_t*>(mask);
  p.out = static_cast<uint16_t*>(out);
  p.kpe_pitch = kpe_pitch;
  p.length = static_cast<int>(length);
  p.heads = heads;
  p.scale_log2 = static_cast<float>(scale * 1.4426950408889634);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d_nope == 128 && d_rope == 64 && d_v == 128) {
    return launch<128, 64, 128>(p, batch, st);
  }
  if (d_nope == 8 && d_rope == 8 && d_v == 8) {
    return launch<8, 8, 8>(p, batch, st);
  }
  return cudaErrorInvalidValue;
}
