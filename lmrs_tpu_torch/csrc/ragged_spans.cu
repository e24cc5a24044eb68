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
// --use_fast_math).  The attention pass stages the int8 bytes (half the
// copy) and widens each staged tile once into bf16 shared-memory tiles
// (exact, on the FP32 pipe: csrc/kv_int8.cuh i8x4), folds K's
// dequant into q before the walk (q⊙s rounded to bf16 for the mma A
// operand: one more rounding than the reference's f32 product) and V's
// into the output, and attends in-span tokens from the pool — their
// quantized values, as the reference does.
//
// Layout: q [Tp, H, hd]; k_new/v_new [Tp, K, hd]; pools [P_total, K, ps, hd]
// (page-major, layer-flattened: callers pass GLOBAL page ids); tables
// [B, W], kv_lens / q_starts / q_lens [B] int32; out [Tp, H, hd]; part: f32
// scratch of K·B·split_tiles·NS·64·(hd + 2) values and counters:
// K·B·split_tiles ints, zero between launches (NS = ceil(cap / split)
// splits).  Spans are disjoint inside [0, Tp), as pack_spans lays them out.
// All contiguous.
//
// Design.  The TPU kernel walks one row's query tiles IN ORDER, writing a
// tile's tokens before walking that tile's prefix.  Blocks on the card run
// in no order, so a block for a later tile would read K/V an earlier
// tile's block had not yet written.  The op is therefore two launches on
// one stream: (1) a write pass, one block per flat token, that also zeroes
// the output rows of tokens outside every span; (2) an attention pass.  A
// query tile is 64 query rows = (64 / n_rep) span tokens x the n_rep query
// heads of one kv head (16 tokens at n_rep = 4), so each K/V tile staged in
// shared memory serves every query head that reads it; Q·K^T and P·V run on
// mma.sync.m16n8k16 bf16 -> f32 with P kept in registers (the flash prefill
// kernel's schedule, csrc/flash_prefill.cu).  64 span tokens x n_rep heads
// per block would need ~4x the registers per thread: it does not fit at
// hd = 128.
//
// Bound on the H100: the bytes are the live K/V of every row (each read
// once per kv head), q, out, the new K/V read and written into the pool;
// the operations are ~4·H·hd per (query token, attended column).  A mixed
// step (7 decode rows + a 249-token slice) is bound by bytes, a
// 1,300-token continuation over a 384-token prefix by operations; both are
// a few µs to a few tens of µs of work.  The time is set by the longest
// serial walk, so the attention pass splits and pipelines it:
//
// * Grid (NT, NS, K), all from shapes (kv_lens stays on the device).  The
//   rows' query tiles are numbered in row order: block x finds its row and
//   tile by a scan over the B spans; x past the last tile exits.  Block
//   (x, s, kvh) walks columns [s·split, (s+1)·split) of its tile's range
//   [0, kv_hi), kv_hi = min(base + the tile's last token + 1, cap); a
//   block whose split starts at or past kv_hi exits.  split = 512 in the
//   wrapper (8 column tiles).  Only rows of at most split_tiles (4 in the
//   wrapper) query tiles
//   split (decode rows, short spans: few blocks, long walks); a longer
//   span's tiles are parallel already and walk whole in split 0, which
//   keeps the scratch at B·split_tiles groups whatever Tp is.
// * Staging and the walk (csrc/tile_attn.cuh, shared with the verify
//   kernel): 64-column K and V tiles, both ROW-MAJOR (rows padded by 16
//   bytes), through the page table into a two-stage shared-memory ring
//   with cp.async, 16 bytes a thread on neighbouring addresses; tile i + 1
//   is in flight while tile i is multiplied (a third stage measured no
//   faster on the card).  Columns past the split are
//   zero-filled and masked.  The P·V B fragment comes from the row-major V
//   tile through ldmatrix.trans.  The int8 build stages the bytes and
//   widens each tile once per block (not once per warp fragment: the four
//   warps read the same tile) into bf16 tiles that the same fragment code
//   reads.
// * Merge: a tile with one live split writes `out` directly; otherwise each
//   split stores its rows' (m, l, acc) in `part` and the last block of the
//   (tile, kv head) to arrive merges the live splits in split order
//   (split_merge.cuh), so repeated launches are bit-identical.
// * A decode row's tile holds n_rep real rows of 64 (its one token): the
//   mma does 64 rows of work for n_rep, which costs operations the mixed
//   step has to spare, not bytes.
// * hd 256 (the Gemma presets): the same walk with q in shared memory and
//   32-column tiles (tile_attn.cuh), ~100 KB of shared memory, two blocks
//   an SM.
//
// The ancestor-mask build (compiled with -DLMRS_SPAN_ANC into a library of
// its own, `lmrs_ragged_spans_anc_bf16` / `_int8`) is the attention of the
// reference's tree speculation, which it runs through XLA
// (`ragged_spans_xla(anc_masks=)`, lmrs_tpu/ops/paged_attention.py:1154,
// mask rule :1229-1234).  It takes anc_masks [Tp] int32 more: flat token t
// with a nonzero mask attends its row's columns < kv_lens[row] (the context
// before the dispatch) plus exactly the span offsets col - kv_lens[row] in
// [0, 32) whose bit is set (bit 31 included: masks are uint32 words viewed
// as int32); a token with mask 0 keeps the causal rule, so one dispatch
// mixes tree spans with prefill slices of any length.  Bits above a token's
// own offset name columns outside its query tile's walk (the tile walks up
// to its last token's column) and are not read; the scheduler's trees set
// only ancestors, which come first.  Writes are unchanged (span-offset
// columns), and the two launches keep them ahead of every read, heal tokens
// that rewrite columns other tokens read included.  Only the mask changes,
// in tile_attn.cuh's walk under ANC; the grid, splits and merge are these.
// A template flag keeps the unmasked builds' code as it was, and the define
// keeps their library's build time (the masked instantiations compile in a
// parallel nvcc).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_int8.cuh"
#include "split_merge.cuh"
#include "tile_attn.cuh"

namespace {

#ifdef LMRS_SPAN_ANC
constexpr bool kAnc = true;   // this library's attention pass: tree masks
#else
constexpr bool kAnc = false;
#endif

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

// Pass 2: one block per (query tile, split, kv head).  Query row r of the
// tile is span token j0 + r / NREP, query head kvh * NREP + r % NREP.  ANC:
// each token's ancestor mask anc_masks[t] (see the header).
template <int HD, int NREP, bool QUANT, bool ANC>
__global__ void __launch_bounds__(NTHREADS)
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
                 const int* __restrict__ anc_masks,
                 float* __restrict__ part, int* __restrict__ counters,
                 int Tp, int B, int KH, int ps, int W, int cap, int split,
                 int split_tiles, float scale_log2) {
  constexpr int TOK = QROWS / NREP;  // span tokens per tile
  extern __shared__ __align__(128) unsigned char smem[];

  const int x = blockIdx.x, sp = blockIdx.y, kvh = blockIdx.z;
  // flat tile x -> row b and tile t of its span (rows' tiles in row order)
  int b = -1, t = 0;
  for (int r = 0, seen = 0; r < B; ++r) {
    const int n = q_lens[r];
    const int nt = n > 0 ? (n + TOK - 1) / TOK : 0;
    if (b < 0 && x < seen + nt) {
      b = r;
      t = x - seen;
    }
    seen += nt;
  }
  if (b < 0) return;
  const int ql = q_lens[b], j0 = t * TOK;
  const int base = kv_lens[b], qs = q_starts[b];
  // columns this tile needs: up to its last real token's limit
  const int kv_hi = min(base + min(j0 + TOK, ql), cap);
  // a short span (decode rows, a few tiles) splits its walk; a longer one
  // walks each tile whole in split 0
  const bool splits = (ql + TOK - 1) / TOK <= split_tiles;
  const int live = kv_hi <= 0 ? 0 : splits ? (kv_hi + split - 1) / split : 1;
  const int c_lo = splits ? sp * split : 0;
  // nothing to attend: split 0 alone writes the tile's zero rows
  if (live == 0 || !splits ? sp != 0 : c_lo >= kv_hi) return;
  const int c_hi = splits ? min(c_lo + split, kv_hi) : kv_hi;
  const int H = KH * NREP;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  // int8: this row's K scales (folded into q) and V scales (into out)
  const long long srow = ((long long)b * KH + kvh) * HD;
  const float* krow_s = QUANT ? kscale + srow : nullptr;
  const float* vrow_s = QUANT ? vscale + srow : nullptr;

  // this thread's two query rows: flat token, head, causal limit (ANC:
  // and ancestor mask)
  TileRows<HD> rows;
  TileAnc anc{};
  long long qoff[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = warp * 16 + g + half * 8;
    const int j = j0 + r / NREP;
    rows.valid[half] = j < ql && qs + j < Tp;
    rows.lim[half] = min(base + j, cap - 1);  // attend col <= lim
    qoff[half] = ((long long)(qs + j) * H + kvh * NREP + r % NREP) * HD;
    if constexpr (ANC)
      anc.mask[half] =
          rows.valid[half] ? static_cast<uint32_t>(anc_masks[qs + j]) : 0u;
  }
  anc.base = base;
  // a warp whose 16 rows hold no span token (a decode row fills n_rep
  // rows of warp 0) only stages and syncs
  const int jw = j0 + warp * 16 / NREP;  // this warp's first span token
  const bool warp_live = jw < ql && qs + jw < Tp;
  tile_load_q<HD, QUANT>(rows, q, qoff, krow_s, smem);
  tile_walk<HD, QUANT, ANC>(rows, k_pages, v_pages, tables + (long long)b * W,
                            (long long)KH * ps * HD, kvh, ps, c_lo, c_hi,
                            warp_live, scale_log2, smem, anc);

  if (live <= 1) {  // one live split (or none): out = acc / l directly
    tile_store_out<HD, QUANT>(rows, qoff, vrow_s, out);
    return;
  }
  // store this split's partial state; the last split to arrive merges
  const int NS = gridDim.y;
  // partial groups: (kv head, row, tile) over the split rows' tiles
  const long long group = ((long long)kvh * B + b) * split_tiles + t;
  const long long n_acc = (long long)gridDim.z * B * split_tiles * NS * QROWS * HD;
  float* p_acc = part + group * NS * QROWS * HD;  // split 0, row 0
  float* p_ml = part + n_acc + group * NS * QROWS * 2;
  tile_store_partial<HD>(rows, p_acc + (long long)sp * QROWS * HD,
                         p_ml + sp * QROWS * 2, QROWS);
  if (!split_arrive(counters + group, live)) return;
  tile_merge<HD, QUANT>(p_acc, p_ml, live, QROWS, vrow_s, out,
                        [&](int r) -> long long {
                          const int j = j0 + r / NREP;
                          if (!(j < ql && qs + j < Tp)) return -1;
                          return ((long long)(qs + j) * H + kvh * NREP + r % NREP) * HD;
                        });
}

template <int HD, bool QUANT>
int launch_hd(int nrep, const __nv_bfloat16* q, const __nv_bfloat16* kn,
              const __nv_bfloat16* vn, pool_t<QUANT>* kp, pool_t<QUANT>* vp,
              const float* ks, const float* vs, const int* tab,
              const int* lens, const int* qs, const int* ql,
              const int* anc, __nv_bfloat16* out, float* part, int* cnt,
              int Tp, int B,
              int KH, int ps, int W, int cap, int split, int split_tiles,
              float sl2, cudaStream_t st) {
  const int H = KH * nrep;
  span_write_kernel<HD, QUANT><<<Tp, 128, 0, st>>>(
      kn, vn, kp, vp, ks, vs, out, tab, lens, qs, ql, B, H, KH, ps, W, cap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ns = cap > 0 ? (cap + split - 1) / split : 1;
  constexpr int smem = tile_smem_bytes<HD, QUANT>();
#define LMRS_SPAN_ATTN(NR)                                                     \
  {                                                                            \
    auto kern = span_attn_kernel<HD, NR, QUANT, kAnc>;                         \
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                               smem);                                          \
    if (err != cudaSuccess) return static_cast<int>(err);                      \
    kern<<<dim3((Tp + QROWS / NR - 1) / (QROWS / NR) + B, ns, KH), NTHREADS,   \
           smem, st>>>(q, kp, vp, ks, vs, out, tab, lens, qs, ql, anc, part,   \
                       cnt, Tp, B, KH, ps, W, cap, split, split_tiles, sl2);   \
  }
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
           const void* q_lens, const void* anc_masks, void* out, void* part,
           void* counters, int Tp, int B, int H, int KH, int hd, int ps, int W,
           int max_pos, int split, int split_tiles, float sm_scale,
           void* stream) {
  if (Tp <= 0 || B <= 0) return 0;
  if (split <= 0 || split % BK || split_tiles < 0)
    return static_cast<int>(cudaErrorInvalidValue);
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
      static_cast<const int*>(anc_masks), static_cast<__nv_bfloat16*>(out),    \
      static_cast<float*>(part), static_cast<int*>(counters), Tp, B, KH, ps,   \
      W, cap, split, split_tiles, sl2, st
  int rc;
  if (hd == 256) {
    rc = launch_hd<256, QUANT>(LMRS_SPAN_ARGS);
  } else if (hd == 128) {
    rc = launch_hd<128, QUANT>(LMRS_SPAN_ARGS);
  } else if (hd == 64) {
    rc = launch_hd<64, QUANT>(LMRS_SPAN_ARGS);
  } else if (hd == 32) {
    rc = launch_hd<32, QUANT>(LMRS_SPAN_ARGS);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
#undef LMRS_SPAN_ARGS
  return rc;
}

}  // namespace

#ifndef LMRS_SPAN_ANC
// part / counters: the attention pass's split scratch (see Layout above).
extern "C" int lmrs_ragged_spans_bf16(
    const void* q, const void* k_new, const void* v_new, void* k_pages,
    void* v_pages, const void* tables, const void* kv_lens,
    const void* q_starts, const void* q_lens, void* out, void* part,
    void* counters, int Tp, int B, int H, int KH, int hd, int ps, int W,
    int max_pos, int split, int split_tiles, float sm_scale, void* stream) {
  return launch<false>(q, k_new, v_new, k_pages, v_pages, nullptr, nullptr,
                       tables, kv_lens, q_starts, q_lens, nullptr, out, part,
                       counters, Tp, B, H, KH, hd, ps, W, max_pos, split,
                       split_tiles, sm_scale, stream);
}

// int8 pools; kscale/vscale are the table rows' f32 scales [B, K, hd].
extern "C" int lmrs_ragged_spans_int8(
    const void* q, const void* k_new, const void* v_new, void* k_pages,
    void* v_pages, const void* kscale, const void* vscale, const void* tables,
    const void* kv_lens, const void* q_starts, const void* q_lens, void* out,
    void* part, void* counters, int Tp, int B, int H, int KH, int hd, int ps,
    int W, int max_pos, int split, int split_tiles, float sm_scale,
    void* stream) {
  return launch<true>(q, k_new, v_new, k_pages, v_pages, kscale, vscale,
                      tables, kv_lens, q_starts, q_lens, nullptr, out, part,
                      counters, Tp, B, H, KH, hd, ps, W, max_pos, split,
                      split_tiles, sm_scale, stream);
}
#else
// The ancestor-mask build: anc_masks [Tp] int32, one word per flat token.
extern "C" int lmrs_ragged_spans_anc_bf16(
    const void* q, const void* k_new, const void* v_new, void* k_pages,
    void* v_pages, const void* tables, const void* kv_lens,
    const void* q_starts, const void* q_lens, const void* anc_masks,
    void* out, void* part, void* counters, int Tp, int B, int H, int KH,
    int hd, int ps, int W, int max_pos, int split, int split_tiles,
    float sm_scale, void* stream) {
  return launch<false>(q, k_new, v_new, k_pages, v_pages, nullptr, nullptr,
                       tables, kv_lens, q_starts, q_lens, anc_masks, out, part,
                       counters, Tp, B, H, KH, hd, ps, W, max_pos, split,
                       split_tiles, sm_scale, stream);
}

extern "C" int lmrs_ragged_spans_anc_int8(
    const void* q, const void* k_new, const void* v_new, void* k_pages,
    void* v_pages, const void* kscale, const void* vscale, const void* tables,
    const void* kv_lens, const void* q_starts, const void* q_lens,
    const void* anc_masks, void* out, void* part, void* counters, int Tp,
    int B, int H, int KH, int hd, int ps, int W, int max_pos, int split,
    int split_tiles, float sm_scale, void* stream) {
  return launch<true>(q, k_new, v_new, k_pages, v_pages, kscale, vscale,
                      tables, kv_lens, q_starts, q_lens, anc_masks, out, part,
                      counters, Tp, B, H, KH, hd, ps, W, max_pos, split,
                      split_tiles, sm_scale, stream);
}
#endif
