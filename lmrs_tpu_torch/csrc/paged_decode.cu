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
// kernel compiled with WRITE = false, which drops the write.  Same clamp to
// W·ps; kv_len == 0 gives a zero row, as the TPU kernel's
// acc / where(l > 0, l, 1).
//
// `lmrs_paged_decode_fused_int8` is the same TPU kernel's int8-pool body
// (its `kscale`/`vscale` operands, :1358-1359): the kernel compiled with
// QUANT = true over int8 pools and the dispatch rows' per-(kv head,
// channel) f32 scales [B, K, hd].  The write quantizes the new row,
// rintf(__fdiv_rn(x, s)) clamped to +-127 — round half to even and an
// IEEE division, bit for bit what torch.round(x / s) gives (never build
// with --use_fast_math: the division would turn approximate).  The walk
// stages the int8 bytes, folds K's dequant into q (q·(s⊙k8) = (q⊙s)·k8, in
// f32 in shared memory), widens each value to f32 exactly when it reads it,
// and applies V's dequant after the splits are merged.
//
// Layout: q [B, H, hd]; k_new/v_new [B, K, hd]; pools [P_total, K, ps, hd]
// (page-major, layer-flattened: callers pass GLOBAL page ids); tables
// [B, W] int32; kv_lens [B] int32; out [B, H, hd]; part: f32 scratch of
// B·K·S·n_rep·(hd + 2) values; counters: B·K ints, zero between launches.
// All contiguous.
//
// Bound on the H100: decode attention moves the live K/V bytes once and
// does ~4·n_rep·hd FLOPs per token, ~4 FLOP per byte against the card's
// 295 FLOP/byte ridge: it is bound by device memory (3.35 TB/s).  Reaching
// that rate needs many bytes in flight on every SM, so the design splits
// each row's walk over the sequence and keeps copies ahead of the
// arithmetic:
//
// * Grid (B, K, S), S = ceil(W·ps / split) from shapes alone (kv_lens stays
//   on the device).  Block (b, kvh, s) walks tokens [s·split, (s+1)·split)
//   of row b clamped to n_tok = min(len, W·ps); a block whose split starts
//   at or past n_tok exits at once.  split (a multiple of 32, 256 in the
//   wrapper) gives 8·8·8 = 512 blocks at B = 8, K = 8, W·ps = 2048; the
//   wrapper halves it for a launch of fewer than 16 (row, kv head) groups
//   (gemma-2b's one kv head: 8·1·16 blocks).
// * The write is done by the one block whose split holds position len - 1,
//   before its walk and a __syncthreads; no other block reads that
//   position, so blocks need no ordering.
// * Staging: 32-token K and V tiles (inside one page, ps % 32 == 0) go
//   through the page table into a two-stage shared-memory ring with
//   cp.async, 16 bytes a thread on neighbouring addresses; tile i + 1 is in
//   flight while tile i is scored (deeper rings, 3 to 6 stages, measured no
//   faster on the card: several blocks share each SM).  Int8 pools stage
//   the int8 bytes (half the copy).
// * Arithmetic on CUDA cores from shared memory: the n_rep query heads are
//   dealt to the 4 warps (warp w takes heads w, w + 4, ...); a lane scores
//   one token for its warp's heads (q in f32 shared memory, K rows padded
//   by 16 bytes: conflict-free 16-byte reads) and owns hd/32 output
//   channels of P·V.  At ~4 FLOP per byte the tensor cores would buy
//   nothing, and f32 scores keep the int8 build's q⊙s unrounded.
// * Merge: each split stores its (m, l, acc) per query head in `part`; the
//   last block of the (row, kv head) to arrive (split_arrive in
//   split_merge.cuh) merges the live splits in split order, so repeated
//   launches are bit-identical.  A row with one live split writes `out`
//   directly.  One launch per call: no second merge launch from the host.
// * hd 256 (the Gemma presets): 8 output channels a lane (one 16-byte V
//   read), q in f32 and the two-stage ring take ~74 KB of shared memory at
//   8 query heads a kv head (gemma-2b), above the 48 KB default: the launch
//   sets the opt-in limit, as for every build.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_int8.cuh"
#include "split_merge.cuh"

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int TILE = 32;   // tokens per staged tile (one per lane)
constexpr int STAGES = 2;  // tiles in the shared-memory ring (1 in flight)
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

// N consecutive pool values at p (aligned to their size) widened to f32
template <int N, typename PT>
__device__ __forceinline__ void load_vals(const PT* p, float (&f)[N]) {
  constexpr int BYTES = N * sizeof(PT);
  if constexpr (BYTES == 16) {  // hd 256, bf16: 8 channels a lane
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const PT* e = reinterpret_cast<const PT*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) f[j] = to_f(e[j]);
  } else if constexpr (BYTES == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const PT* e = reinterpret_cast<const PT*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) f[j] = to_f(e[j]);
  } else if constexpr (BYTES == 4 && N == 4) {  // int8
    i8x4(*reinterpret_cast<const uint32_t*>(p), f);
  } else if constexpr (BYTES == 4) {
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
    const PT* e = reinterpret_cast<const PT*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) f[j] = to_f(e[j]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) f[j] = to_f(p[j]);
  }
}

// QUANT: int8 pools with per-(row, kv head, channel) scales kscale/vscale
// [B, K, hd]; otherwise bf16 pools and the scale pointers are unused.
template <int HD, int NREP, bool WRITE, bool QUANT>
__global__ void __launch_bounds__(NTHREADS)
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
                    float* __restrict__ part, int* __restrict__ counters,
                    int KH, int ps, int W, int split, float scale_log2) {
  using PT = pool_t<QUANT>;
  constexpr int VEC = 16 / sizeof(PT);      // pool values per 16 bytes
  constexpr int KSTR = HD + VEC;            // K row padded by 16 bytes
  constexpr int ROWC = HD / VEC;            // 16-byte chunks per row
  constexpr int DPL = HD / 32;              // output channels per lane
  constexpr int HPW = (NREP + NWARPS - 1) / NWARPS;  // heads per warp
  // dynamic shared memory: q [NREP][HD] f32, then the K and V rings
  extern __shared__ __align__(16) unsigned char smem[];
  float (*qs)[HD] = reinterpret_cast<float (*)[HD]>(smem);
  PT* Ks = reinterpret_cast<PT*>(smem + NREP * HD * sizeof(float));  // [STAGES][TILE * KSTR]
  PT* Vs = Ks + STAGES * TILE * KSTR;                                // [STAGES][TILE * HD]

  const int b = blockIdx.x, kvh = blockIdx.y, sp = blockIdx.z;
  const int S = gridDim.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = KH * NREP;
  const int len = kv_lens[b];
  const int n_tok = max(min(len, W * ps), 0);
  const long long orow = ((long long)b * H + kvh * NREP) * HD;  // out rows
  if (n_tok == 0) {  // an empty row: zeros, from split 0 alone
    if (sp == 0)
      for (int i = tid; i < NREP * HD; i += NTHREADS)
        out[orow + i] = __float2bfloat16(0.f);
    return;
  }
  const int t_lo = sp * split;
  if (t_lo >= n_tok) return;
  const int t_hi = min(t_lo + split, n_tok);
  const int live = (n_tok + split - 1) / split;
  const int* tab = tables + (long long)b * W;
  const long long page_stride = (long long)KH * ps * HD;
  const long long srow = ((long long)b * KH + kvh) * HD;  // this row's scales

  // 1. the split that holds position len - 1 writes the current token
  if (WRITE && len <= W * ps) {
    const int pos = len - 1;
    if (pos >= t_lo && pos < t_hi) {
      const long long off = tab[pos / ps] * page_stride +
                            ((long long)kvh * ps + pos % ps) * HD;
      for (int d = tid; d < HD; d += NTHREADS) {
        if constexpr (QUANT) {
          k_pages[off + d] = quant8(__bfloat162float(k_new[srow + d]), kscale[srow + d]);
          v_pages[off + d] = quant8(__bfloat162float(v_new[srow + d]), vscale[srow + d]);
        } else {
          k_pages[off + d] = k_new[srow + d];
          v_pages[off + d] = v_new[srow + d];
        }
      }
      __threadfence();  // before this block's cp.async reads the row
    }
  }
  for (int i = tid; i < NREP * HD; i += NTHREADS) {
    const int r = i / HD, d = i % HD;
    float qv = __bfloat162float(q[orow + i]) * scale_log2;
    if constexpr (QUANT) qv *= kscale[srow + d];  // K's dequant, folded into q
    qs[r][d] = qv;
  }
  __syncthreads();  // the write and q are visible to every thread

  // 2. stage 32-token tiles through the page table into the ring
  const int n_tiles = (t_hi - t_lo + TILE - 1) / TILE;
  auto issue = [&](int i) {
    const int t0 = t_lo + i * TILE;  // the tile lies inside one page
    const long long base = tab[t0 / ps] * page_stride +
                           ((long long)kvh * ps + t0 % ps) * HD;
    PT* kd = Ks + (i % STAGES) * TILE * KSTR;
    PT* vd = Vs + (i % STAGES) * TILE * HD;
    for (int c = tid; c < TILE * ROWC; c += NTHREADS) {
      const int row = c / ROWC, col = (c % ROWC) * VEC;
      const bool ok = t0 + row < t_hi;  // rows past the split: zero-filled
      const long long src = ok ? base + (long long)row * HD + col : 0;
      cp_async16(kd + row * KSTR + col, k_pages + src, ok ? 16 : 0);
      cp_async16(vd + row * HD + col, v_pages + src, ok ? 16 : 0);
    }
  };

  float m_run[HPW], l_run[HPW], acc[HPW][DPL];
#pragma unroll
  for (int h = 0; h < HPW; ++h) {
    m_run[h] = NEG;
    l_run[h] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[h][j] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {  // prologue: STAGES - 1 tiles in flight
    if (i < n_tiles) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    if (i + STAGES - 1 < n_tiles) issue(i + STAGES - 1);
    cp_async_commit();  // (empty groups past the last tile keep the count)
    cp_async_wait<STAGES - 1>();
    __syncthreads();  // tile i has landed for every thread
    const PT* kt = Ks + (i % STAGES) * TILE * KSTR;
    const PT* vt = Vs + (i % STAGES) * TILE * HD;
    const int n_valid = min(TILE, t_hi - (t_lo + i * TILE));
    // scores: lane -> token, this warp's heads (warp-uniform branches)
    float s[HPW];
#pragma unroll
    for (int h = 0; h < HPW; ++h) s[h] = 0.f;
#pragma unroll 4
    for (int vi = 0; vi < ROWC; ++vi) {
      const uint4 raw = *reinterpret_cast<const uint4*>(kt + lane * KSTR + vi * VEC);
      float kf[VEC];
      if constexpr (QUANT) {
        i8x4(raw.x, kf);
        i8x4(raw.y, kf + 4);
        i8x4(raw.z, kf + 8);
        i8x4(raw.w, kf + 12);
      } else {
        const PT* kv = reinterpret_cast<const PT*>(&raw);
#pragma unroll
        for (int j = 0; j < VEC; ++j) kf[j] = to_f(kv[j]);
      }
#pragma unroll
      for (int h = 0; h < HPW; ++h) {
        const int r = warp + h * NWARPS;
        if (r < NREP) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) s[h] += qs[r][vi * VEC + j] * kf[j];
        }
      }
    }
    // fold the tile into the running state (log2 domain)
    float p[HPW];
#pragma unroll
    for (int h = 0; h < HPW; ++h) {
      p[h] = 0.f;
      if (warp + h * NWARPS >= NREP) continue;
      const float sv = lane < n_valid ? s[h] : NEG;
      float mx = sv;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, o));
      const float m_new = fmaxf(m_run[h], mx);
      const float alpha = exp2f(m_run[h] - m_new);
      p[h] = lane < n_valid ? exp2f(sv - m_new) : 0.f;
      float psum = p[h];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffff, psum, o);
      l_run[h] = l_run[h] * alpha + psum;
      m_run[h] = m_new;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[h][j] *= alpha;
    }
    // P·V: lane owns channels lane*DPL .. +DPL-1
    // (rows past n_valid are zero-filled and their p is 0: the full tile
    // unrolls with constant shuffle lanes)
#pragma unroll
    for (int t = 0; t < TILE; ++t) {
      float vf[DPL];
      load_vals<DPL>(vt + t * HD + lane * DPL, vf);
#pragma unroll
      for (int h = 0; h < HPW; ++h) {
        const float pt = __shfl_sync(0xffffffff, p[h], t);
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[h][j] += pt * vf[j];
      }
    }
    __syncthreads();  // tile i consumed before its stage is refilled
  }

  // 3. one live split: write out; else store the partial and merge last
  if (live == 1) {
#pragma unroll
    for (int h = 0; h < HPW; ++h) {
      const int r = warp + h * NWARPS;
      if (r >= NREP) continue;
      const float inv = l_run[h] > 0.f ? 1.f / l_run[h] : 0.f;
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int d = lane * DPL + j;
        float res = acc[h][j] * inv;
        if constexpr (QUANT) res *= vscale[srow + d];  // V's dequant
        out[orow + r * HD + d] = __float2bfloat16(res);
      }
    }
    return;
  }
  const long long group = (long long)b * KH + kvh;
  const long long n_acc = (long long)gridDim.x * KH * S * NREP * HD;
  float* p_acc = part + (group * S) * NREP * HD;      // split 0, head 0
  float* p_ml = part + n_acc + (group * S) * NREP * 2;
#pragma unroll
  for (int h = 0; h < HPW; ++h) {
    const int r = warp + h * NWARPS;
    if (r >= NREP) continue;
#pragma unroll
    for (int j = 0; j < DPL; ++j)
      p_acc[((long long)sp * NREP + r) * HD + lane * DPL + j] = acc[h][j];
    if (lane == 0) {
      p_ml[((long long)sp * NREP + r) * 2] = m_run[h];
      p_ml[((long long)sp * NREP + r) * 2 + 1] = l_run[h];
    }
  }
  if (!split_arrive(counters + group, live)) return;
#pragma unroll
  for (int h = 0; h < HPW; ++h) {
    const int r = warp + h * NWARPS;
    if (r >= NREP) continue;
    float o[DPL];
    split_merge_row<DPL>(p_ml + r * 2, p_acc + (long long)r * HD, live,
                         NREP * 2, (long long)NREP * HD, lane * DPL, o);
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane * DPL + j;
      float res = o[j];
      if constexpr (QUANT) res *= vscale[srow + d];  // V's dequant
      out[orow + r * HD + d] = __float2bfloat16(res);
    }
  }
}

template <int HD, bool WRITE, bool QUANT, typename PT>
int launch_hd(int nrep, dim3 grid, cudaStream_t st, const __nv_bfloat16* q,
              const __nv_bfloat16* kn, const __nv_bfloat16* vn, PT* kp,
              PT* vp, const float* ks, const float* vs, const int* tab,
              const int* lens, __nv_bfloat16* out, float* part, int* cnt,
              int KH, int ps, int W, int split, float sl2) {
#define LMRS_DECODE(NR)                                                     \
  {                                                                         \
    auto kern = paged_decode_kernel<HD, NR, WRITE, QUANT>;                  \
    const int smem = NR * HD * (int)sizeof(float) +                         \
                     STAGES * TILE * (2 * HD + 16 / (int)sizeof(PT)) *      \
                         (int)sizeof(PT);                                   \
    const cudaError_t e = cudaFuncSetAttribute(                             \
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);           \
    if (e != cudaSuccess) return static_cast<int>(e);                       \
    kern<<<grid, NTHREADS, smem, st>>>(q, kn, vn, kp, vp, ks, vs, tab,      \
                                       lens, out, part, cnt, KH, ps, W,     \
                                       split, sl2);                         \
  }
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
           const void* tables, const void* kv_lens, void* out, void* part,
           void* counters, int B, int H, int KH, int hd, int ps, int W,
           int split, float sm_scale, void* stream) {
  using PT = pool_t<QUANT>;
  if (B <= 0) return 0;
  if (split <= 0 || split % TILE) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(B, KH, (W * ps + split - 1) / split);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float sl2 = sm_scale * LOG2E;
  const int nrep = H / KH;
#define LMRS_DECODE_ARGS                                                        \
  nrep, grid, st, static_cast<const __nv_bfloat16*>(q),                         \
      static_cast<const __nv_bfloat16*>(k_new),                                 \
      static_cast<const __nv_bfloat16*>(v_new), static_cast<PT*>(k_pages),      \
      static_cast<PT*>(v_pages), static_cast<const float*>(kscale),             \
      static_cast<const float*>(vscale), static_cast<const int*>(tables),       \
      static_cast<const int*>(kv_lens), static_cast<__nv_bfloat16*>(out),       \
      static_cast<float*>(part), static_cast<int*>(counters), KH, ps, W, split, \
      sl2
  int rc;
  if (hd == 256) {
    rc = launch_hd<256, WRITE, QUANT>(LMRS_DECODE_ARGS);
  } else if (hd == 128) {
    rc = launch_hd<128, WRITE, QUANT>(LMRS_DECODE_ARGS);
  } else if (hd == 64) {
    rc = launch_hd<64, WRITE, QUANT>(LMRS_DECODE_ARGS);
  } else if (hd == 32) {
    rc = launch_hd<32, WRITE, QUANT>(LMRS_DECODE_ARGS);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
#undef LMRS_DECODE_ARGS
  return rc;
}

}  // namespace

// part: f32 scratch of B·K·S·(H/K)·(hd + 2) values, S = ceil(W·ps / split);
// counters: B·K ints, zero (the kernel leaves them zero).
extern "C" int lmrs_paged_decode_fused_bf16(
    const void* q, const void* k_new, const void* v_new, void* k_pages,
    void* v_pages, const void* tables, const void* kv_lens, void* out,
    void* part, void* counters, int B, int H, int KH, int hd, int ps, int W,
    int split, float sm_scale, void* stream) {
  return launch<true, false>(q, k_new, v_new, k_pages, v_pages, nullptr,
                             nullptr, tables, kv_lens, out, part, counters, B,
                             H, KH, hd, ps, W, split, sm_scale, stream);
}

// int8 pools; kscale/vscale are the dispatch rows' f32 scales [B, K, hd].
extern "C" int lmrs_paged_decode_fused_int8(
    const void* q, const void* k_new, const void* v_new, void* k_pages,
    void* v_pages, const void* kscale, const void* vscale, const void* tables,
    const void* kv_lens, void* out, void* part, void* counters, int B, int H,
    int KH, int hd, int ps, int W, int split, float sm_scale, void* stream) {
  return launch<true, true>(q, k_new, v_new, k_pages, v_pages, kscale, vscale,
                            tables, kv_lens, out, part, counters, B, H, KH, hd,
                            ps, W, split, sm_scale, stream);
}

// Walk-only: the pools are only read (the WRITE = false kernel never
// stores through them), and k_new / v_new are unused.
extern "C" int lmrs_paged_decode_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* kv_lens, void* out, void* part,
    void* counters, int B, int H, int KH, int hd, int ps, int W, int split,
    float sm_scale, void* stream) {
  return launch<false, false>(q, nullptr, nullptr, const_cast<void*>(k_pages),
                              const_cast<void*>(v_pages), nullptr, nullptr,
                              tables, kv_lens, out, part, counters, B, H, KH,
                              hd, ps, W, split, sm_scale, stream);
}
