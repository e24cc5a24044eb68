// Paged decode attention for Hopper (sm_90a): write-fused (bf16 or int8
// pools) and walk-only (bf16).
//
// `lmrs_paged_decode_fused_bf16` replaces the TPU kernel
// lmrs_tpu/ops/paged_attention.py `paged_decode_pallas_fused` (per-row
// grid, pallas_call at :1495; its row-group grid at :1361 computes the same
// function).  Same function: write the current token's K/V into its page of
// the pool IN PLACE, then attend each query head over the row's live pages
// (kv_lens includes the current token) with an online softmax.  Live pages
// are clamped to the table width, so a stale length beyond the table never
// reads past it, and a position past the table span is not written.  Rows
// with kv_len == 0 write nothing and output zeros.
//
// `lmrs_paged_decode_bf16` replaces the walk-only `paged_decode_pallas`
// (per-row grid, pallas_call at :1687; row-group grid at :1650): the same
// kernel compiled with WRITE = false, which drops the write (the sync after
// it stays: it also publishes q in shared memory).  Same clamp to W·ps;
// kv_len == 0 gives a zero row, as the TPU kernel's acc / where(l > 0, l, 1).
//
// `lmrs_paged_decode_fused_int8` is the same TPU kernel's int8-pool body
// (its `kscale`/`vscale` operands, :1358-1359): the kernel compiled with
// QUANT = true over int8 pools and the dispatch rows' per-(kv head,
// channel) f32 scales [B, K, hd].  The write quantizes the new row,
// rintf(__fdiv_rn(x, s)) clamped to +-127 — round half to even and an
// IEEE division, bit for bit what torch.round(x / s) gives (never build
// with --use_fast_math: the division would turn approximate).  The walk
// folds K's dequant into q (q·(s⊙k8) = (q⊙s)·k8, in f32 in shared memory)
// and V's into the output after normalizing; int8 K/V rows load as 16
// values per 16-byte load and widen to f32 exactly.
//
// Layout: q [B, H, hd]; k_new/v_new [B, K, hd]; pools [P_total, K, ps, hd]
// (page-major, layer-flattened: callers pass GLOBAL page ids); tables
// [B, W] int32; kv_lens [B] int32; out [B, H, hd].  All contiguous.
//
// Design.  One block per (row, kv head), 4 warps.  The block holds all
// n_rep query heads of its kv head, so each K/V row is read once for all of
// them (no 8-row sublane padding of the query group, no RMW windows: the
// write is one row per kv head).  The block first writes k_new/v_new, syncs,
// then its warps take 32-token chunks in turn: a lane scores one token for
// every query head (q pre-scaled in shared memory), the warp folds the
// chunk into its running max/sum, and the P·V pass gives each lane hd/32
// output channels.  A final pass merges the 4 warps' partial softmax states
// through shared memory.
//
// Bound on the H100: decode attention moves the live K/V bytes once and does
// ~4·n_rep·hd FLOPs per token, far below the 295 FLOP/byte ridge: it is
// bound by device memory (3.35 TB/s).  This first version uses one block per
// (row, kv head) — B·K blocks, fewer than the 132 SMs at B=8, K=8 — and no
// split over the sequence, so it reaches a fraction of that rate at short
// contexts; the measured time is in PERF.md.  Int8 pools halve the live
// K/V bytes (1 byte per value); the serial walk of the longest row, not the
// bytes, sets this version's time, so the int8 build runs near the bf16
// one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_int8.cuh"

namespace {

constexpr int NWARPS = 4;
constexpr int CHUNK = 32;  // tokens per warp step (one per lane)
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

// QUANT: int8 pools with per-(row, kv head, channel) scales kscale/vscale
// [B, K, hd]; otherwise bf16 pools and the scale pointers are unused.
template <int HD, int NREP, bool WRITE, bool QUANT>
__global__ void __launch_bounds__(NWARPS * 32)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k_new,
                    const __nv_bfloat16* __restrict__ v_new,
                    pool_t<QUANT>* __restrict__ k_pages,
                    pool_t<QUANT>* __restrict__ v_pages,
                    const float* __restrict__ kscale,
                    const float* __restrict__ vscale,
                    const int* __restrict__ tables,
                    const int* __restrict__ kv_lens,
                    __nv_bfloat16* __restrict__ out,
                    int KH, int ps, int W, float scale_log2) {
  using PT = pool_t<QUANT>;
  constexpr int DPL = HD / 32;  // output channels per lane
  constexpr int VEC = 16 / sizeof(PT);  // pool values per 16-byte load
  __shared__ float qs[NREP][HD];
  __shared__ float m_w[NWARPS][NREP], l_w[NWARPS][NREP];
  __shared__ float acc_w[NWARPS][NREP][HD];

  const int b = blockIdx.x, kvh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = KH * NREP;
  const int len = kv_lens[b];
  const int* tab = tables + (long long)b * W;
  const long long page_stride = (long long)KH * ps * HD;

  // 1. write the current token's K/V into its page (position len - 1)
  if (WRITE && len > 0 && len <= W * ps) {
    const int pos = len - 1;
    const long long off = tab[pos / ps] * page_stride +
                          ((long long)kvh * ps + pos % ps) * HD;
    const long long src = ((long long)b * KH + kvh) * HD;
    for (int d = tid; d < HD; d += NWARPS * 32) {
      if constexpr (QUANT) {
        k_pages[off + d] = quant8(__bfloat162float(k_new[src + d]), kscale[src + d]);
        v_pages[off + d] = quant8(__bfloat162float(v_new[src + d]), vscale[src + d]);
      } else {
        k_pages[off + d] = k_new[src + d];
        v_pages[off + d] = v_new[src + d];
      }
    }
  }
  const long long srow = ((long long)b * KH + kvh) * HD;  // this row's scales
  for (int i = tid; i < NREP * HD; i += NWARPS * 32) {
    const int r = i / HD, d = i % HD;
    float qv = __bfloat162float(q[((long long)b * H + kvh * NREP + r) * HD + d]) *
               scale_log2;
    if constexpr (QUANT) qv *= kscale[srow + d];  // K's dequant, folded into q
    qs[r][d] = qv;
  }
  __syncthreads();  // the write and q are visible to every warp

  // 2. online softmax over the live tokens, clamped to the table width
  const int n_tok = min(len, W * ps);
  float m_run[NREP], l_run[NREP], acc[NREP][DPL];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    m_run[r] = NEG;
    l_run[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[r][j] = 0.f;
  }
  const int n_chunks = (n_tok + CHUNK - 1) / CHUNK;
  for (int c = warp; c < n_chunks; c += NWARPS) {
    const int t0 = c * CHUNK;  // chunk lies inside one page (ps % 32 == 0)
    const long long base = tab[t0 / ps] * page_stride +
                           ((long long)kvh * ps + t0 % ps) * HD;
    const int n_valid = min(CHUNK, n_tok - t0);
    // scores: lane -> token t0 + lane, every query head
    float s[NREP];
#pragma unroll
    for (int r = 0; r < NREP; ++r) s[r] = NEG;
    if (lane < n_valid) {
#pragma unroll
      for (int r = 0; r < NREP; ++r) s[r] = 0.f;
      const uint4* krow = reinterpret_cast<const uint4*>(k_pages + base + lane * HD);
#pragma unroll
      for (int vi = 0; vi < HD / VEC; ++vi) {
        const uint4 raw = krow[vi];
        const PT* kv = reinterpret_cast<const PT*>(&raw);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float kf = to_f(kv[j]);
#pragma unroll
          for (int r = 0; r < NREP; ++r) s[r] += qs[r][vi * VEC + j] * kf;
        }
      }
    }
    // fold the chunk into the running state (log2 domain)
    float p[NREP];
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      float mx = s[r];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, o));
      const float m_new = fmaxf(m_run[r], mx);
      const float alpha = exp2f(m_run[r] - m_new);
      p[r] = lane < n_valid ? exp2f(s[r] - m_new) : 0.f;
      float ps_sum = p[r];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ps_sum += __shfl_xor_sync(0xffffffff, ps_sum, o);
      l_run[r] = l_run[r] * alpha + ps_sum;
      m_run[r] = m_new;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[r][j] *= alpha;
    }
    // P·V: lane owns channels lane*DPL .. +DPL-1
    for (int t = 0; t < n_valid; ++t) {
      const PT* vrow = v_pages + base + (long long)t * HD + lane * DPL;
      float vf[DPL];
#pragma unroll
      for (int j = 0; j < DPL; ++j) vf[j] = to_f(vrow[j]);
#pragma unroll
      for (int r = 0; r < NREP; ++r) {
        const float pt = __shfl_sync(0xffffffff, p[r], t);
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[r][j] += pt * vf[j];
      }
    }
  }

  // 3. merge the warps' partial states
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    if (lane == 0) {
      m_w[warp][r] = m_run[r];
      l_w[warp][r] = l_run[r];
    }
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc_w[warp][r][lane * DPL + j] = acc[r][j];
  }
  __syncthreads();
  for (int i = tid; i < NREP * HD; i += NWARPS * 32) {
    const int r = i / HD, d = i % HD;
    float m = NEG;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) m = fmaxf(m, m_w[w][r]);
    float l = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float f = l_w[w][r] > 0.f ? exp2f(m_w[w][r] - m) : 0.f;
      l += l_w[w][r] * f;
      o += acc_w[w][r][d] * f;
    }
    float res = l > 0.f ? o / l : 0.f;
    if constexpr (QUANT) res *= vscale[srow + d];  // V's dequant
    out[((long long)b * H + kvh * NREP + r) * HD + d] = __float2bfloat16(res);
  }
}

template <int HD, bool WRITE, bool QUANT, typename PT>
int launch_hd(int nrep, dim3 grid, dim3 block, cudaStream_t st,
              const __nv_bfloat16* q, const __nv_bfloat16* kn,
              const __nv_bfloat16* vn, PT* kp, PT* vp, const float* ks,
              const float* vs, const int* tab, const int* lens,
              __nv_bfloat16* out, int KH, int ps, int W, float sl2) {
#define LMRS_DECODE(NR)                                                \
  paged_decode_kernel<HD, NR, WRITE, QUANT><<<grid, block, 0, st>>>(   \
      q, kn, vn, kp, vp, ks, vs, tab, lens, out, KH, ps, W, sl2)
  switch (nrep) {
    case 1: LMRS_DECODE(1); break;
    case 2: LMRS_DECODE(2); break;
    case 4: LMRS_DECODE(4); break;
    case 8: LMRS_DECODE(8); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LMRS_DECODE
  return static_cast<int>(cudaGetLastError());
}

template <bool WRITE, bool QUANT>
int launch(const void* q, const void* k_new, const void* v_new, void* k_pages,
           void* v_pages, const void* kscale, const void* vscale,
           const void* tables, const void* kv_lens, void* out, int B, int H,
           int KH, int hd, int ps, int W, float sm_scale, void* stream) {
  using PT = pool_t<QUANT>;
  dim3 grid(B, KH);
  dim3 block(NWARPS * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float sl2 = sm_scale * LOG2E;
  const int nrep = H / KH;
#define LMRS_DECODE_ARGS                                                        \
  nrep, grid, block, st, static_cast<const __nv_bfloat16*>(q),                  \
      static_cast<const __nv_bfloat16*>(k_new),                                 \
      static_cast<const __nv_bfloat16*>(v_new), static_cast<PT*>(k_pages),      \
      static_cast<PT*>(v_pages), static_cast<const float*>(kscale),             \
      static_cast<const float*>(vscale), static_cast<const int*>(tables),       \
      static_cast<const int*>(kv_lens), static_cast<__nv_bfloat16*>(out), KH,   \
      ps, W, sl2
  int rc;
  if (hd == 128) {
    rc = launch_hd<128, WRITE, QUANT>(LMRS_DECODE_ARGS);
  } else if (hd == 64) {
    rc = launch_hd<64, WRITE, QUANT>(LMRS_DECODE_ARGS);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
#undef LMRS_DECODE_ARGS
  return rc;
}

}  // namespace

extern "C" int lmrs_paged_decode_fused_bf16(
    const void* q, const void* k_new, const void* v_new, void* k_pages,
    void* v_pages, const void* tables, const void* kv_lens, void* out,
    int B, int H, int KH, int hd, int ps, int W, float sm_scale,
    void* stream) {
  return launch<true, false>(q, k_new, v_new, k_pages, v_pages, nullptr,
                             nullptr, tables, kv_lens, out, B, H, KH, hd, ps,
                             W, sm_scale, stream);
}

// int8 pools; kscale/vscale are the dispatch rows' f32 scales [B, K, hd].
extern "C" int lmrs_paged_decode_fused_int8(
    const void* q, const void* k_new, const void* v_new, void* k_pages,
    void* v_pages, const void* kscale, const void* vscale, const void* tables,
    const void* kv_lens, void* out, int B, int H, int KH, int hd, int ps,
    int W, float sm_scale, void* stream) {
  return launch<true, true>(q, k_new, v_new, k_pages, v_pages, kscale, vscale,
                            tables, kv_lens, out, B, H, KH, hd, ps, W,
                            sm_scale, stream);
}

// Walk-only: the pools are only read (the WRITE = false kernel never
// stores through them), and k_new / v_new are unused.
extern "C" int lmrs_paged_decode_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* kv_lens, void* out, int B, int H, int KH,
    int hd, int ps, int W, float sm_scale, void* stream) {
  return launch<false, false>(q, nullptr, nullptr, const_cast<void*>(k_pages),
                              const_cast<void*>(v_pages), nullptr, nullptr,
                              tables, kv_lens, out, B, H, KH, hd, ps, W,
                              sm_scale, stream);
}
