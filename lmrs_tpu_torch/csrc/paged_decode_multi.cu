// Multi-token verify paged attention for Hopper (sm_90a), bf16 or int8
// pools: the speculative-decoding step.
//
// Replaces the TPU kernel lmrs_tpu/ops/paged_attention.py
// `paged_decode_pallas_multi` (per-row grid, pallas_call at :852; its
// row-group grid at :774 computes the same function).  Same function: row b
// carries T consecutive tokens at positions base + j, base =
// max(kv_lens[b] - T, 0) (kv_lens counts the T tokens and is NOT clamped by
// the caller, so base is the true first position).  Each token's K/V is
// written into the row's pages IN PLACE when its position is < cap =
// min(W * ps, max_pos); then query token j attends every column
// col <= base + j with col < cap, f32 online softmax.  Contract difference
// from the TPU kernel's XLA twin: an out-of-span token is SKIPPED, where
// the twin parks it on the null page; the pools agree everywhere else.
//
// `lmrs_paged_decode_multi_int8` is the same TPU kernel's int8-pool body
// (its `kscale`/`vscale` operands, :771-772): compiled with QUANT = true
// over int8 pools and the rows' f32 scales [B, K, hd].  The write
// quantizes the T new rows with the row's frozen scales,
// rintf(__fdiv_rn(x, s)) clamped to +-127 (bit for bit torch.round(x / s);
// never build with --use_fast_math); the walk widens staged int8 K/V to
// bf16 (exact), folds K's dequant into q (q⊙s rounded to bf16 for the mma
// A operand, one rounding more than the reference's f32 product) and V's
// into the output, and attends the T tokens' quantized rows from the pool,
// as the reference does.
//
// Layout: q [B, T, H, hd]; k_new/v_new [B, T, K, hd]; pools
// [P_total, K, ps, hd] (page-major, layer-flattened: callers pass GLOBAL
// page ids); tables [B, W] int32; kv_lens [B] int32; out [B, T, H, hd].
// All contiguous.
//
// Design.  One block per (row, kv head), 4 warps.  The block first writes
// its kv head's T new K/V rows, then __syncthreads(), then walks the row's
// live pages once for all T x n_rep query rows.  The write-then-read order
// inside one block is enough because a block reads only its own kv head's
// writes: a row owns the pages it writes (prefix-cache pages are shared but
// only read — every write lands at a position >= kv_lens - T, past any
// donated full page), so no other block writes what this one reads.  The
// pools are therefore not __restrict__: the compiler must not route their
// reads through the non-coherent read-only path.  The TPU kernel's 8-row
// read-modify-write windows, its 0/1 select matmul and its row grouping
// exist for Mosaic's DMA and sublane rules and are not carried over.
//
// The T x n_rep query rows (20 at T = 5, n_rep = 4) sit in the 64-row tile
// of the span kernel (csrc/ragged_spans.cu) — warps whose 16 rows are all
// padding skip the products but help stage — and the walk is that kernel's
// schedule: 64-column K/V tiles staged through the page table into padded
// shared memory (K row-major, V transposed), Q·K^T and P·V on
// mma.sync.m16n8k16 bf16 -> f32, P kept in registers.  That takes the
// tensor cores instead of the write-fused decode kernel's per-lane
// layout, whose per-warp accumulators for 20 rows (qs[20][128] +
// acc_w[4][20][128] f32, ~50 KB) would not fit the 48 KB of static shared
// memory; here the block needs 35 KB static.  T x n_rep <= 64 (T <= 16 at n_rep = 4); the wrapper
// refuses more.
//
// Rows whose table is the null page (empty slots: the scheduler passes
// kv_lens = T for them, as the reference does) all write page 0 at the same
// offsets, concurrently; their outputs are discarded by the caller.  Every
// kernel-vs-plain comparison therefore excludes the null page and
// null-table rows.
//
// Bound on the H100: the bytes are each row's live K/V (read once per kv
// head), q and out, the new K/V read and written into the pool; the
// operations are ~4·hd per (query head, token, attended column).  At the
// verify step's shape (8 rows, T = 5, ~6k live tokens, bench-8b widths) the
// bytes are ~24 MB, ~7 µs at 3.35 TB/s, against well under 1 µs of
// operations: memory bound.  This version has one block per (row, kv head)
// — B·K blocks, fewer than the 132 SMs at B = 8, K = 8 — no split over the
// sequence and synchronous tile loads (no cp.async/TMA, no wgmma), so the
// longest row's serial walk sets its time; the measured time is in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_int8.cuh"

namespace {

constexpr int QROWS = 64;     // query rows per block (16 per warp): T * n_rep
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

// Query row r of the block is token r / NREP, query head kvh * NREP +
// r % NREP; rows r >= T * NREP are padding.
template <int HD, int NREP, bool QUANT>
__global__ void __launch_bounds__(NWARPS * 32)
paged_decode_multi_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k_new,
                          const __nv_bfloat16* __restrict__ v_new,
                          pool_t<QUANT>* k_pages, pool_t<QUANT>* v_pages,
                          const float* __restrict__ kscale,
                          const float* __restrict__ vscale,
                          const int* __restrict__ tables,
                          const int* __restrict__ kv_lens,
                          __nv_bfloat16* __restrict__ out, int T, int KH,
                          int ps, int W, int cap, float scale_log2) {
  constexpr int KSTR = HD + 8;  // padded K row (bf16 elements)
  constexpr int VSTR = BK + 8;  // padded transposed-V row
  __shared__ __align__(16) __nv_bfloat16 Ks[BK * KSTR];
  __shared__ __align__(16) __nv_bfloat16 Vt[HD * VSTR];

  const int b = blockIdx.x, kvh = blockIdx.y;
  const int H = KH * NREP;
  const int base = max(kv_lens[b] - T, 0);
  const int* tab = tables + (long long)b * W;
  const long long page_stride = (long long)KH * ps * HD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  // int8: this row's scales (K's quantize the writes and fold into q, V's
  // quantize the writes and fold into out)
  const long long srow = ((long long)b * KH + kvh) * HD;
  const float* krow_s = QUANT ? kscale + srow : nullptr;
  const float* vrow_s = QUANT ? vscale + srow : nullptr;

  // 1. write this kv head's T new K/V rows (positions < cap only)
  for (int i = tid; i < T * (HD / 8); i += NWARPS * 32) {
    const int j = i / (HD / 8), c = (i % (HD / 8)) * 8;
    const int pos = base + j;
    if (pos >= cap) continue;
    const long long dst = tab[pos / ps] * page_stride +
                          ((long long)kvh * ps + pos % ps) * HD + c;
    const long long src = (((long long)b * T + j) * KH + kvh) * HD + c;
    store8(k_pages + dst, k_new + src, QUANT ? krow_s + c : nullptr);
    store8(v_pages + dst, v_new + src, QUANT ? vrow_s + c : nullptr);
  }
  __syncthreads();  // the writes are visible to every warp's tile loads

  // 2. this thread's two query rows: offset, causal limit
  const bool warp_rows = warp * 16 < T * NREP;  // warp-uniform
  long long qoff[2];
  int lim[2];
  bool valid[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = warp * 16 + g + half * 8;
    const int j = r / NREP;
    valid[half] = r < T * NREP;
    lim[half] = min(base + j, cap - 1);  // attend col <= lim
    qoff[half] = (((long long)b * T + j) * H + kvh * NREP + r % NREP) * HD;
  }
  // columns the block needs: up to its last token's limit
  const int kv_hi = min(base + T, cap);

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
    if (!warp_rows) continue;  // all-padding warp: staging only

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

  // finalize: out = acc / l
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
              const int* lens, __nv_bfloat16* out, int B, int T, int KH,
              int ps, int W, int cap, float sl2, cudaStream_t st) {
  const dim3 grid(B, KH), block(NWARPS * 32);
#define LMRS_MULTI(NR)                                                \
  paged_decode_multi_kernel<HD, NR, QUANT><<<grid, block, 0, st>>>( \
      q, kn, vn, kp, vp, ks, vs, tab, lens, out, T, KH, ps, W, cap, sl2)
  switch (nrep) {
    case 1: LMRS_MULTI(1); break;
    case 2: LMRS_MULTI(2); break;
    case 4: LMRS_MULTI(4); break;
    case 8: LMRS_MULTI(8); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LMRS_MULTI
  return static_cast<int>(cudaGetLastError());
}

template <bool QUANT>
int launch(const void* q, const void* k_new, const void* v_new, void* k_pages,
           void* v_pages, const void* kscale, const void* vscale,
           const void* tables, const void* kv_lens, void* out, int B, int T,
           int H, int KH, int hd, int ps, int W, int max_pos, float sm_scale,
           void* stream) {
  if (B <= 0) return 0;
  if (T < 1 || T * (H / KH) > QROWS) return static_cast<int>(cudaErrorInvalidValue);
  const int cap = min(W * ps, max_pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float sl2 = sm_scale * LOG2E;
#define LMRS_MULTI_ARGS                                                        \
  H / KH, static_cast<const __nv_bfloat16*>(q),                                \
      static_cast<const __nv_bfloat16*>(k_new),                                \
      static_cast<const __nv_bfloat16*>(v_new),                                \
      static_cast<pool_t<QUANT>*>(k_pages), static_cast<pool_t<QUANT>*>(v_pages), \
      static_cast<const float*>(kscale), static_cast<const float*>(vscale),    \
      static_cast<const int*>(tables), static_cast<const int*>(kv_lens),       \
      static_cast<__nv_bfloat16*>(out), B, T, KH, ps, W, cap, sl2, st
  int rc;
  if (hd == 128) {
    rc = launch_hd<128, QUANT>(LMRS_MULTI_ARGS);
  } else if (hd == 64) {
    rc = launch_hd<64, QUANT>(LMRS_MULTI_ARGS);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
#undef LMRS_MULTI_ARGS
  return rc;
}

}  // namespace

extern "C" int lmrs_paged_decode_multi_bf16(
    const void* q, const void* k_new, const void* v_new, void* k_pages,
    void* v_pages, const void* tables, const void* kv_lens, void* out, int B,
    int T, int H, int KH, int hd, int ps, int W, int max_pos, float sm_scale,
    void* stream) {
  return launch<false>(q, k_new, v_new, k_pages, v_pages, nullptr, nullptr,
                       tables, kv_lens, out, B, T, H, KH, hd, ps, W, max_pos,
                       sm_scale, stream);
}

// int8 pools; kscale/vscale are the rows' f32 scales [B, K, hd].
extern "C" int lmrs_paged_decode_multi_int8(
    const void* q, const void* k_new, const void* v_new, void* k_pages,
    void* v_pages, const void* kscale, const void* vscale, const void* tables,
    const void* kv_lens, void* out, int B, int T, int H, int KH, int hd,
    int ps, int W, int max_pos, float sm_scale, void* stream) {
  return launch<true>(q, k_new, v_new, k_pages, v_pages, kscale, vscale,
                      tables, kv_lens, out, B, T, H, KH, hd, ps, W, max_pos,
                      sm_scale, stream);
}
