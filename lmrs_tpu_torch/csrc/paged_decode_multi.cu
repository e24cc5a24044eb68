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
// page ids); tables [B, W] int32; kv_lens [B] int32; out [B, T, H, hd];
// part: f32 scratch of B·K·S·T·(H/K)·(hd + 2) values and counters: B·K
// ints, zero between launches (S = ceil(min(W·ps, max_pos) / split)).
// All contiguous.
//
// Design.  One (row, kv head) block walking a whole row would give B·K = 64
// blocks on 132 SMs at the verify step's shape, and the longest row's
// serial walk would set the time.  The kernel therefore splits each row
// over the sequence, as the decode and span kernels do:
//
// * Grid (B, K, S), all from shapes: S = ceil(min(W·ps, max_pos) / split)
//   (kv_lens stays on the device).  Block (b, kvh, s) owns columns
//   [s·split, (s+1)·split) of the row's range [0, kv_hi), kv_hi =
//   min(base + T, cap); a block whose split starts at or past kv_hi
//   exits, and split 0 alone handles a row with no columns.
// * The write: each block first writes the new tokens whose positions lie
//   in its own split's column range (and < cap), fences, then reads.  The T
//   tokens may straddle a split boundary; each lands in the split that
//   reads it, so no block ever reads a column another block writes.  The
//   pools are not __restrict__: they are written and read in one kernel.
// * The walk (csrc/tile_attn.cuh, shared with the span kernel): the T x
//   n_rep query rows (20 at T = 5, n_rep = 4) in one 64-row tile — warps
//   whose 16 rows are all padding skip the products but help stage — and a
//   two-stage cp.async ring of 64-column K/V tiles, both row-major, V fed to
//   P·V through ldmatrix.trans; Q·K^T and P·V on mma.sync.m16n8k16 bf16 ->
//   f32, P kept in registers.  T x n_rep <= 64 (T <= 16 at n_rep = 4); the
//   wrapper refuses more.  hd 256 (gemma-2b's verify step: 5 x 8 = 40 rows
//   over one kv head) keeps q in shared memory and walks 32-column tiles
//   (tile_attn.cuh).
// * The merge: a row with one live split writes `out` directly; otherwise
//   each split stores the f32 (m, l, acc) of its T x n_rep real query rows
//   (padding rows store nothing) and the last block of the (row, kv head)
//   to arrive, elected by its counter, merges the splits in index order
//   (split_merge.cuh), so a repeat launch gives the same bits.  Under a
//   straddle, a query row can attend nothing in the last split (token j
//   sees only col <= base + j): its partial is m = -1e30, l = 0, acc = 0
//   and the merge drops it.
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
// operations: memory bound.  The measured time is in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_int8.cuh"
#include "split_merge.cuh"
#include "tile_attn.cuh"

namespace {

// Query row r of the block is token r / NREP, query head kvh * NREP +
// r % NREP; rows r >= T * NREP are padding.  Three blocks an SM (at most
// 170 registers a thread): the hd-128 bf16 build would take 193 and fit
// two, which puts the speculative step's 384 blocks (8 rows x 8 kv heads x
// 6 splits) in two waves.  hd 256: two (its ~100 KB of shared memory fits
// two an SM anyway; 255 registers hold the 128 output accumulators with q
// in shared memory, csrc/tile_attn.cuh).
template <int HD, int NREP, bool QUANT>
__global__ void __launch_bounds__(NTHREADS, HD > 128 ? 2 : 3)
paged_decode_multi_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k_new,
                          const __nv_bfloat16* __restrict__ v_new,
                          pool_t<QUANT>* k_pages, pool_t<QUANT>* v_pages,
                          const float* __restrict__ kscale,
                          const float* __restrict__ vscale,
                          const int* __restrict__ tables,
                          const int* __restrict__ kv_lens,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ part, int* __restrict__ counters,
                          int T, int KH, int ps, int W, int cap, int split,
                          float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.x, kvh = blockIdx.y, sp = blockIdx.z;
  const int H = KH * NREP, nrows = T * NREP;
  const int base = max(kv_lens[b] - T, 0);
  // columns the row needs: up to its last token's limit
  const int kv_hi = min(base + T, cap);
  const int live = kv_hi > 0 ? (kv_hi + split - 1) / split : 0;
  const int c_lo = sp * split;
  // no column at all: split 0 alone writes the row's zeros
  if (live == 0 ? sp != 0 : c_lo >= kv_hi) return;
  const int c_hi = min(c_lo + split, kv_hi);
  const int* tab = tables + (long long)b * W;
  const long long page_stride = (long long)KH * ps * HD;
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2;
  // int8: this row's scales (K's quantize the writes and fold into q, V's
  // quantize the writes and fold into out)
  const long long srow = ((long long)b * KH + kvh) * HD;
  const float* krow_s = QUANT ? kscale + srow : nullptr;
  const float* vrow_s = QUANT ? vscale + srow : nullptr;

  // 1. write this kv head's new tokens at positions in [c_lo, c_hi)
  const int j_lo = max(c_lo - base, 0), j_hi = min(c_hi - base, T);
  if (j_hi > j_lo) {
    for (int i = tid; i < (j_hi - j_lo) * (HD / 8); i += NTHREADS) {
      const int j = j_lo + i / (HD / 8), c = (i % (HD / 8)) * 8;
      const int pos = base + j;
      const long long dst = tab[pos / ps] * page_stride +
                            ((long long)kvh * ps + pos % ps) * HD + c;
      const long long src = (((long long)b * T + j) * KH + kvh) * HD + c;
      store8(k_pages + dst, k_new + src, QUANT ? krow_s + c : nullptr);
      store8(v_pages + dst, v_new + src, QUANT ? vrow_s + c : nullptr);
    }
    __threadfence();  // before this block's cp.async reads the rows
  }
  __syncthreads();

  // 2. this thread's two query rows: offset, causal limit
  TileRows<HD> rows;
  long long qoff[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = warp * 16 + g + half * 8;
    const int j = r / NREP;
    rows.valid[half] = r < nrows;
    rows.lim[half] = min(base + j, cap - 1);  // attend col <= lim
    qoff[half] = (((long long)b * T + j) * H + kvh * NREP + r % NREP) * HD;
  }
  tile_load_q<HD, QUANT>(rows, q, qoff, krow_s, smem);
  tile_walk<HD, QUANT>(rows, k_pages, v_pages, tab, page_stride, kvh, ps,
                       c_lo, c_hi, warp * 16 < nrows, scale_log2, smem);

  // 3. one live split (or none): out directly; else the partial, merged
  //    by the last block of the (row, kv head)
  if (live <= 1) {
    tile_store_out<HD, QUANT>(rows, qoff, vrow_s, out);
    return;
  }
  const int NS = gridDim.z;
  const long long group = (long long)b * KH + kvh;
  const long long n_acc = (long long)gridDim.x * KH * NS * nrows * HD;
  float* p_acc = part + group * NS * nrows * HD;  // split 0, row 0
  float* p_ml = part + n_acc + group * NS * nrows * 2;
  tile_store_partial<HD>(rows, p_acc + (long long)sp * nrows * HD,
                         p_ml + (long long)sp * nrows * 2, nrows);
  if (!split_arrive(counters + group, live)) return;
  tile_merge<HD, QUANT>(p_acc, p_ml, live, nrows, vrow_s, out,
                        [&](int r) -> long long {
                          return (((long long)b * T + r / NREP) * H + kvh * NREP +
                                  r % NREP) * HD;
                        });
}

template <int HD, bool QUANT>
int launch_hd(int nrep, const __nv_bfloat16* q, const __nv_bfloat16* kn,
              const __nv_bfloat16* vn, pool_t<QUANT>* kp, pool_t<QUANT>* vp,
              const float* ks, const float* vs, const int* tab,
              const int* lens, __nv_bfloat16* out, float* part, int* cnt,
              int B, int T, int KH, int ps, int W, int cap, int split,
              float sl2, cudaStream_t st) {
  const dim3 grid(B, KH, cap > 0 ? (cap + split - 1) / split : 1);
  constexpr int smem = tile_smem_bytes<HD, QUANT>();
#define LMRS_MULTI(NR)                                                         \
  {                                                                            \
    auto kern = paged_decode_multi_kernel<HD, NR, QUANT>;                      \
    const cudaError_t e = cudaFuncSetAttribute(                                \
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);              \
    if (e != cudaSuccess) return static_cast<int>(e);                          \
    kern<<<grid, NTHREADS, smem, st>>>(q, kn, vn, kp, vp, ks, vs, tab, lens,   \
                                       out, part, cnt, T, KH, ps, W, cap,      \
                                       split, sl2);                            \
  }
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
           const void* tables, const void* kv_lens, void* out, void* part,
           void* counters, int B, int T, int H, int KH, int hd, int ps, int W,
           int max_pos, int split, float sm_scale, void* stream) {
  if (B <= 0) return 0;
  if (T < 1 || T * (H / KH) > QROWS || split <= 0 || split % BK)
    return static_cast<int>(cudaErrorInvalidValue);
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
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(part),             \
      static_cast<int*>(counters), B, T, KH, ps, W, cap, split, sl2, st
  int rc;
  if (hd == 256) {
    rc = launch_hd<256, QUANT>(LMRS_MULTI_ARGS);
  } else if (hd == 128) {
    rc = launch_hd<128, QUANT>(LMRS_MULTI_ARGS);
  } else if (hd == 64) {
    rc = launch_hd<64, QUANT>(LMRS_MULTI_ARGS);
  } else if (hd == 32) {
    rc = launch_hd<32, QUANT>(LMRS_MULTI_ARGS);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
#undef LMRS_MULTI_ARGS
  return rc;
}

}  // namespace

// part: f32 scratch of B·K·S·T·(H/K)·(hd + 2) values, S = ceil(min(W·ps,
// max_pos) / split); counters: B·K ints, zero (the kernel leaves them zero).
extern "C" int lmrs_paged_decode_multi_bf16(
    const void* q, const void* k_new, const void* v_new, void* k_pages,
    void* v_pages, const void* tables, const void* kv_lens, void* out,
    void* part, void* counters, int B, int T, int H, int KH, int hd, int ps,
    int W, int max_pos, int split, float sm_scale, void* stream) {
  return launch<false>(q, k_new, v_new, k_pages, v_pages, nullptr, nullptr,
                       tables, kv_lens, out, part, counters, B, T, H, KH, hd,
                       ps, W, max_pos, split, sm_scale, stream);
}

// int8 pools; kscale/vscale are the rows' f32 scales [B, K, hd].
extern "C" int lmrs_paged_decode_multi_int8(
    const void* q, const void* k_new, const void* v_new, void* k_pages,
    void* v_pages, const void* kscale, const void* vscale, const void* tables,
    const void* kv_lens, void* out, void* part, void* counters, int B, int T,
    int H, int KH, int hd, int ps, int W, int max_pos, int split,
    float sm_scale, void* stream) {
  return launch<true>(q, k_new, v_new, k_pages, v_pages, kscale, vscale,
                      tables, kv_lens, out, part, counters, B, T, H, KH, hd,
                      ps, W, max_pos, split, sm_scale, stream);
}
