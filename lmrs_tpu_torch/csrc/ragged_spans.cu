// Ragged-span paged attention for Hopper (sm_90a), bf16 or int8 pools.
//
// Replaces the TPU kernel lmrs_tpu/ops/paged_attention.py
// `ragged_spans_pallas` (pallas_call at :1137).  Same function: one
// dispatch of (row, query-span) pairs over the paged pool — decode rows
// (span 1), a mixed step's prefill slice, continuation chunks.  Token j of
// row b is flat token q_starts[b] + j at absolute position kv_lens[b] + j;
// its K/V is written into the row's pages, then it attends every column
// col <= its position with col < cap = min(W * ps, max_pos), f32 online
// softmax.  Contract differences from the TPU kernel (both invisible to
// the consumer): only in-span tokens at positions < cap are written (the
// TPU kernel also writes tile padding at future positions), and a flat
// token of no span gets a zero output row (the TPU kernel leaves it).
//
// `lmrs_ragged_spans_int8` is the same TPU kernel's int8-pool body (its
// `kscale`/`vscale` operands, :1097-1102): both passes compiled with
// QUANT = true over int8 pools and per-row f32 scales [B, K, hd].  The
// write pass quantizes each flat token with ITS OWN row's scales (the
// reference's kv_scales[rf], ragged_spans_xla), rintf(__fdiv_rn(x, s))
// clamped to +-127 — bit for bit torch.round(x / s) (never build with
// --use_fast_math).  The attention pass widens each staged int8 K/V value
// to bf16 (exact) in the same shared-memory tiles, folds K's dequant into
// q before the walk (q⊙s rounded to bf16 for the mma A operand: one more
// rounding than the reference's f32 product) and V's into the output, and
// attends in-span tokens from the pool — their quantized values, as the
// reference does.
//
// Layout: q [Tp, H, hd]; k_new/v_new [Tp, K, hd]; pools [P_total, K, ps, hd]
// (page-major, layer-flattened: callers pass GLOBAL page ids); tables
// [B, W], kv_lens / q_starts / q_lens [B] int32; out [Tp, H, hd].  All
// contiguous.
//
// Design.  The TPU kernel walks one row's query tiles IN ORDER, writing a
// tile's tokens before walking that tile's prefix.  Blocks on the card run
// in no order, so a block for a later tile would read K/V an earlier
// tile's block had not yet written.  The op is therefore two launches on
// one stream: (1) a write pass, one block per flat token, that also zeroes
// the output rows of tokens outside every span; (2) an attention pass,
// one block per (query tile, row, kv head).  A tile is 64 query rows =
// (64 / n_rep) span tokens x the n_rep query heads of one kv head (16
// tokens at n_rep = 4), so each K/V tile staged in shared memory serves
// every query head that reads it.  The block walks the row's pages up to
// its last token's position in 64-column tiles, through the flash prefill
// kernel's schedule (csrc/flash_prefill.cu): K row-major and V transposed
// in padded shared memory, Q·K^T and P·V on mma.sync.m16n8k16 bf16 -> f32,
// P kept in registers.  64 span tokens x n_rep heads (256 rows) per block
// would need ~4x the flash kernel's registers per thread: it does not fit
// at hd = 128.  A decode row has one token, so its tile is n_rep of 64
// rows: accepted in this version.
//
// Bound on the H100: the bytes are the live K/V of every row (each read
// once per kv head), q, out, the new K/V read and written into the pool;
// the operations are ~4·H·hd per (query token, attended column).  A mixed
// step (7 decode rows + a 249-token slice) and a 1,300-token continuation
// over a 384-token prefix are bound by bytes at the step's small total
// (a few MB, a few µs at 3.35 TB/s) and approach the compute line only for
// long spans.  This version loads tiles synchronously (no cp.async/TMA, no
// wgmma) and re-reads a row's K/V once per query tile of that row, so a
// long span pays (span / 16) walks of its prefix from L2; decode rows get
// no split over the sequence.  Measured times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_int8.cuh"

namespace {

constexpr int QROWS = 64;     // query rows per block (16 per warp)
constexpr int BK = 64;        // kv columns per tile
constexpr int NWARPS = 4;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Pass 1: one block per flat token t.  The owning row is found by a scan
// over the B spans (B is the slot count, a handful); a token of no span
// zeroes its output row, an in-span token at a position < cap writes its
// K/V for every kv head.
template <int HD, bool QUANT>
__global__ void span_write_kernel(const __nv_bfloat16* __restrict__ k_new,
                                  const __nv_bfloat16* __restrict__ v_new,
                                  pool_t<QUANT>* __restrict__ k_pages,
                                  pool_t<QUANT>* __restrict__ v_pages,
                                  const float* __restrict__ kscale,
                                  const float* __restrict__ vscale,
                                  __nv_bfloat16* __restrict__ out,
                                  const int* __restrict__ tables,
                                  const int* __restrict__ kv_lens,
                                  const int* __restrict__ q_starts,
                                  const int* __restrict__ q_lens,
                                  int B, int H, int KH, int ps, int W,
                                  int cap) {
  const int t = blockIdx.x;
  int row = -1;
  for (int r = 0; r < B; ++r) {
    const int s = q_starts[r];
    if (q_lens[r] > 0 && t >= s && t < s + q_lens[r]) row = r;
  }
  if (row < 0) {
    uint4* o = reinterpret_cast<uint4*>(out + (long long)t * H * HD);
    for (int i = threadIdx.x; i < H * HD / 8; i += blockDim.x)
      o[i] = make_uint4(0, 0, 0, 0);
    return;
  }
  const int pos = kv_lens[row] + (t - q_starts[row]);
  if (pos >= cap) return;
  const long long page = tables[(long long)row * W + pos / ps];
  const long long dst0 = (page * KH * ps + pos % ps) * HD;
  for (int i = threadIdx.x; i < KH * HD / 8; i += blockDim.x) {
    const int kvh = i / (HD / 8), c = (i % (HD / 8)) * 8;
    const long long dst = dst0 + (long long)kvh * ps * HD + c;
    const long long src = ((long long)t * KH + kvh) * HD + c;
    const long long sc = ((long long)row * KH + kvh) * HD + c;  // row's scales
    store8(k_pages + dst, k_new + src, QUANT ? kscale + sc : nullptr);
    store8(v_pages + dst, v_new + src, QUANT ? vscale + sc : nullptr);
  }
}

// Pass 2: one block per (query tile, row, kv head).  Query row r of the
// tile is span token j0 + r / NREP, query head kvh * NREP + r % NREP.
template <int HD, int NREP, bool QUANT>
__global__ void __launch_bounds__(NWARPS * 32)
span_attn_kernel(const __nv_bfloat16* __restrict__ q,
                 const pool_t<QUANT>* __restrict__ k_pages,
                 const pool_t<QUANT>* __restrict__ v_pages,
                 const float* __restrict__ kscale,
                 const float* __restrict__ vscale,
                 __nv_bfloat16* __restrict__ out,
                 const int* __restrict__ tables,
                 const int* __restrict__ kv_lens,
                 const int* __restrict__ q_starts,
                 const int* __restrict__ q_lens,
                 int Tp, int KH, int ps, int W, int cap, float scale_log2) {
  constexpr int TOK = QROWS / NREP;  // span tokens per tile
  constexpr int KSTR = HD + 8;       // padded K row (bf16 elements)
  constexpr int VSTR = BK + 8;       // padded transposed-V row
  __shared__ __align__(16) __nv_bfloat16 Ks[BK * KSTR];
  __shared__ __align__(16) __nv_bfloat16 Vt[HD * VSTR];

  const int b = blockIdx.y, kvh = blockIdx.z;
  const int j0 = blockIdx.x * TOK;
  const int ql = q_lens[b];
  if (j0 >= ql) return;
  const int H = KH * NREP;
  const int base = kv_lens[b], qs = q_starts[b];
  const int* tab = tables + (long long)b * W;
  const long long page_stride = (long long)KH * ps * HD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  // int8: this row's K scales (folded into q) and V scales (into out)
  const long long srow = ((long long)b * KH + kvh) * HD;
  const float* krow_s = QUANT ? kscale + srow : nullptr;
  const float* vrow_s = QUANT ? vscale + srow : nullptr;

  // this thread's two query rows: flat token, head, causal limit
  long long qoff[2];
  int lim[2];
  bool valid[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = warp * 16 + g + half * 8;
    const int j = j0 + r / NREP;
    valid[half] = j < ql && qs + j < Tp;
    lim[half] = min(base + j, cap - 1);  // attend col <= lim
    qoff[half] = ((long long)(qs + j) * H + kvh * NREP + r % NREP) * HD;
  }
  // columns this tile needs: up to its last real token's limit
  const int kv_hi = min(base + min(j0 + TOK, ql), cap);

  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c0 = ks * 16 + tig * 2;
      uint32_t lo = 0, hi = 0;
      if (valid[half]) {
        lo = q_pair(q + qoff[half] + c0, QUANT ? krow_s + c0 : nullptr);
        hi = q_pair(q + qoff[half] + c0 + 8, QUANT ? krow_s + c0 + 8 : nullptr);
      }
      qf[ks][half] = lo;
      qf[ks][2 + half] = hi;
    }
  }

  float o_acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    o_acc[n][0] = o_acc[n][1] = o_acc[n][2] = o_acc[n][3] = 0.f;
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f};

  for (int kv0 = 0; kv0 < kv_hi; kv0 += BK) {
    __syncthreads();  // previous tile fully consumed
    // stage K (row-major) and V (transposed) through the page table;
    // columns at or past kv_hi read as 0 (masked below)
    for (int idx = tid; idx < BK * (HD / 8); idx += NWARPS * 32) {
      const int r = idx / (HD / 8), c = (idx % (HD / 8)) * 8;
      const int col = kv0 + r;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (col < kv_hi) {
        const long long off = tab[col / ps] * page_stride +
                              ((long long)kvh * ps + col % ps) * HD + c;
        kv4 = load8(k_pages + off);
        vv4 = load8(v_pages + off);
      }
      *reinterpret_cast<uint4*>(&Ks[r * KSTR + c]) = kv4;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv4);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[(c + e) * VSTR + r] = ve[e];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 columns
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const __nv_bfloat16* kp = &Ks[(j * 8 + g) * KSTR + ks * 16 + tig * 2];
        mma_bf16(s[j], qf[ks], *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }

    // per-token causal mask + online softmax (log2 domain)
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const int col = kv0 + j * 8 + tig * 2 + (e & 1);
        const bool ok = valid[half] && col <= lim[half];
        const float val = ok ? s[j][e] * scale_log2 : NEG;
        s[j][e] = val;
        mx[half] = fmaxf(mx[half], val);
      }
    }
    float alpha[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffff, mx[half], 1));
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffff, mx[half], 2));
      const float m_new = fmaxf(m_run[half], mx[half]);
      alpha[half] = exp2f(m_run[half] - m_new);
      m_run[half] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        // a row masked so far has m == NEG: its p must be 0, not exp(0)
        const float p = m_run[half] > 0.5f * NEG ? exp2f(s[j][e] - m_run[half]) : 0.f;
        s[j][e] = p;
        rs[half] += p;
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      rs[half] += __shfl_xor_sync(0xffffffff, rs[half], 1);
      rs[half] += __shfl_xor_sync(0xffffffff, rs[half], 2);
      l_run[half] = l_run[half] * alpha[half] + rs[half];
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o_acc[n][0] *= alpha[0]; o_acc[n][1] *= alpha[0];
      o_acc[n][2] *= alpha[1]; o_acc[n][3] *= alpha[1];
    }

    // O += P V: the S accumulators re-packed as bf16 A fragments
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const __nv_bfloat16* vp = &Vt[(n * 8 + g) * VSTR + kk * 16 + tig * 2];
        mma_bf16(o_acc[n], a, *reinterpret_cast<const uint32_t*>(vp),
                 *reinterpret_cast<const uint32_t*>(vp + 8));
      }
    }
  }

  // finalize: out = acc / l (0 where nothing was attended)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (!valid[half]) continue;
    const float inv = l_run[half] > 0.f ? 1.f / l_run[half] : 0.f;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int col = n * 8 + tig * 2;
      float o0 = o_acc[n][half * 2] * inv, o1 = o_acc[n][half * 2 + 1] * inv;
      if constexpr (QUANT) {
        o0 *= vrow_s[col];
        o1 *= vrow_s[col + 1];
      }
      *reinterpret_cast<uint32_t*>(out + qoff[half] + col) = pack_bf16(o0, o1);
    }
  }
}

template <int HD, bool QUANT>
int launch_hd(int nrep, const __nv_bfloat16* q, const __nv_bfloat16* kn,
              const __nv_bfloat16* vn, pool_t<QUANT>* kp, pool_t<QUANT>* vp,
              const float* ks, const float* vs, const int* tab,
              const int* lens, const int* qs, const int* ql,
              __nv_bfloat16* out, int Tp, int B, int KH, int ps, int W,
              int cap, float sl2, cudaStream_t st) {
  const int H = KH * nrep;
  span_write_kernel<HD, QUANT><<<Tp, 128, 0, st>>>(
      kn, vn, kp, vp, ks, vs, out, tab, lens, qs, ql, B, H, KH, ps, W, cap);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(NWARPS * 32);
#define LMRS_SPAN_ATTN(NR)                                                   \
  span_attn_kernel<HD, NR, QUANT><<<dim3((Tp + QROWS / NR - 1) / (QROWS / NR), \
                                         B, KH), block, 0, st>>>(            \
      q, kp, vp, ks, vs, out, tab, lens, qs, ql, Tp, KH, ps, W, cap, sl2)
  switch (nrep) {
    case 1: LMRS_SPAN_ATTN(1); break;
    case 2: LMRS_SPAN_ATTN(2); break;
    case 4: LMRS_SPAN_ATTN(4); break;
    case 8: LMRS_SPAN_ATTN(8); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LMRS_SPAN_ATTN
  return static_cast<int>(cudaGetLastError());
}

template <bool QUANT>
int launch(const void* q, const void* k_new, const void* v_new, void* k_pages,
           void* v_pages, const void* kscale, const void* vscale,
           const void* tables, const void* kv_lens, const void* q_starts,
           const void* q_lens, void* out, int Tp, int B, int H, int KH,
           int hd, int ps, int W, int max_pos, float sm_scale, void* stream) {
  if (Tp <= 0 || B <= 0) return 0;
  const int cap = min(W * ps, max_pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float sl2 = sm_scale * LOG2E;
#define LMRS_SPAN_ARGS                                                         \
  H / KH, static_cast<const __nv_bfloat16*>(q),                                \
      static_cast<const __nv_bfloat16*>(k_new),                                \
      static_cast<const __nv_bfloat16*>(v_new),                                \
      static_cast<pool_t<QUANT>*>(k_pages), static_cast<pool_t<QUANT>*>(v_pages), \
      static_cast<const float*>(kscale), static_cast<const float*>(vscale),    \
      static_cast<const int*>(tables), static_cast<const int*>(kv_lens),       \
      static_cast<const int*>(q_starts), static_cast<const int*>(q_lens),      \
      static_cast<__nv_bfloat16*>(out), Tp, B, KH, ps, W, cap, sl2, st
  int rc;
  if (hd == 128) {
    rc = launch_hd<128, QUANT>(LMRS_SPAN_ARGS);
  } else if (hd == 64) {
    rc = launch_hd<64, QUANT>(LMRS_SPAN_ARGS);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
#undef LMRS_SPAN_ARGS
  return rc;
}

}  // namespace

extern "C" int lmrs_ragged_spans_bf16(
    const void* q, const void* k_new, const void* v_new, void* k_pages,
    void* v_pages, const void* tables, const void* kv_lens,
    const void* q_starts, const void* q_lens, void* out, int Tp, int B,
    int H, int KH, int hd, int ps, int W, int max_pos, float sm_scale,
    void* stream) {
  return launch<false>(q, k_new, v_new, k_pages, v_pages, nullptr, nullptr,
                       tables, kv_lens, q_starts, q_lens, out, Tp, B, H, KH,
                       hd, ps, W, max_pos, sm_scale, stream);
}

// int8 pools; kscale/vscale are the table rows' f32 scales [B, K, hd].
extern "C" int lmrs_ragged_spans_int8(
    const void* q, const void* k_new, const void* v_new, void* k_pages,
    void* v_pages, const void* kscale, const void* vscale, const void* tables,
    const void* kv_lens, const void* q_starts, const void* q_lens, void* out,
    int Tp, int B, int H, int KH, int hd, int ps, int W, int max_pos,
    float sm_scale, void* stream) {
  return launch<true>(q, k_new, v_new, k_pages, v_pages, kscale, vscale,
                      tables, kv_lens, q_starts, q_lens, out, Tp, B, H, KH,
                      hd, ps, W, max_pos, sm_scale, stream);
}
