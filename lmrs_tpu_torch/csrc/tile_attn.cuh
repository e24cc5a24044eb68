// The 64-row query tile's walk over one split of a row's paged K/V columns,
// shared by the span kernel's attention pass (ragged_spans.cu) and the
// multi-token verify kernel (paged_decode_multi.cu).
//
// A block of 4 warps holds 64 query rows, 16 a warp: span tokens x the
// n_rep query heads of one kv head, so each K/V tile staged in shared memory
// serves every query head that reads it.  Lane (g = lane / 4, tig = lane % 4)
// of a warp owns query rows g and g + 8 of the warp's 16, as the
// mma.sync.m16n8k16 fragments lay them out.  Q·K^T and P·V run bf16 -> f32
// with P kept in registers, and the online softmax is in the log2 domain.
//
// * tile_load_q: the thread's two rows of q as A fragments (int8 pools:
//   q⊙s with K's scales, rounded to bf16).
// * tile_walk: 64-column K and V tiles of the columns [c_lo, c_hi), both
//   ROW-MAJOR (rows padded by 16 bytes), staged through the page table into
//   a two-stage shared-memory ring with cp.async, 16 bytes a thread on
//   neighbouring addresses; tile i + 1 is in flight while tile i is
//   multiplied.  Columns past c_hi are zero-filled and masked.  The P·V B
//   fragment comes from the row-major V tile through ldmatrix.trans.  int8
//   pools stage the bytes and widen each tile once per block (the four
//   warps read the same tile) into bf16 tiles that the same fragment code
//   reads.  A warp whose 16 rows are all padding only stages and syncs.
// * The ancestor-mask build (ANC, the span kernel's tree rows): a row whose
//   mask word is nonzero attends its row's columns below base (the context
//   before the dispatch) and exactly the span offsets col - base in [0, 32)
//   whose bit is set; a row with mask 0 keeps the causal limit.  Only such a
//   build reads the masks (ANC = false compiles the walk as it was), and a
//   tile takes the unmasked fast path for a tree row only when it ends below
//   base: sibling chains' columns lie inside [base, lim].
// * tile_store_out: one live split, out = acc / l (int8: times V's scales).
// * tile_store_partial, then split_arrive and tile_merge (split_merge.cuh):
//   each split stores its rows' f32 (m, l, acc); the last block of the group
//   merges the splits in index order.  A row that attends nothing in a split
//   stores m = -1e30, l = 0, acc = 0 and drops out of the merge.
//
// hd 256 (the Gemma presets): q as A fragments (hd/16 x 4 registers) and
// the output (hd/8 x 4) would take ~196 registers a thread before the score
// tile, so that build keeps the warp's q rows in shared memory and loads
// each k-step's A fragment with ldmatrix (64 registers fewer), and walks
// 32-column tiles (tile_bk: the staged bytes a tile stay those of hd 128,
// the score fragment halves, and two blocks fit an SM).  hd <= 128 keep q
// in registers and 64-column tiles.
//
// Shared memory: tile_smem_bytes<HD, QUANT>() of dynamic shared memory, at
// least 128-byte aligned.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_int8.cuh"
#include "split_merge.cuh"

namespace {

constexpr int QROWS = 64;     // query rows per block (16 per warp)
constexpr int BK = 64;        // kv columns per tile (hd <= 128; splits are
                              // multiples of it)
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int STAGES = 2;     // tiles in the shared-memory ring (1 in flight)
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

// kv columns per staged tile, and whether q lives in shared memory
template <int HD>
__host__ __device__ constexpr int tile_bk() { return HD > 128 ? 32 : BK; }
template <int HD>
__host__ __device__ constexpr bool q_in_smem() { return HD > 128; }
constexpr int QPAD = 8;  // bf16 q row padding in shared memory (16 bytes)

// four 8x8 bf16 matrices from shared memory (lanes 8i..8i+7 give matrix
// i's row addresses)
__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t (&r)[4]) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// the same, transposed
__device__ __forceinline__ void ldsm_x4_trans(const void* p, uint32_t (&r)[4]) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// channels (c, c + 1) of a bf16 K row as an mma B register
__device__ __forceinline__ uint32_t kpair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// an int8 tile [tile_bk][HD + 16] widened into a bf16 tile
// [tile_bk][HD + 8] (exact)
template <int HD>
__device__ __forceinline__ void widen_tile(const int8_t* src,
                                           __nv_bfloat16* dst) {
  constexpr int CH = HD / 16;  // 16-byte int8 chunks per row
  for (int c = threadIdx.x; c < tile_bk<HD>() * CH; c += NTHREADS) {
    const int r = c / CH, col = (c % CH) * 16;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + r * (HD + 16) + col);
    float f[16];
    i8x4(raw.x, f);
    i8x4(raw.y, f + 4);
    i8x4(raw.z, f + 8);
    i8x4(raw.w, f + 12);
    uint4* o = reinterpret_cast<uint4*>(dst + r * (HD + 8) + col);
    o[0] = make_uint4(bf16_pair(f[0], f[1]), bf16_pair(f[2], f[3]),
                      bf16_pair(f[4], f[5]), bf16_pair(f[6], f[7]));
    o[1] = make_uint4(bf16_pair(f[8], f[9]), bf16_pair(f[10], f[11]),
                      bf16_pair(f[12], f[13]), bf16_pair(f[14], f[15]));
  }
}

// the staged ring, the widened bf16 K and V tiles for int8 pools, then
// (hd 256) the bf16 q tile [QROWS][HD + QPAD]
template <int HD, bool QUANT>
__host__ __device__ constexpr int tile_ring_bytes() {
  return STAGES * 2 * tile_bk<HD>() * (HD + 16 / (int)sizeof(pool_t<QUANT>)) *
             (int)sizeof(pool_t<QUANT>) +
         (QUANT ? 2 * tile_bk<HD>() * (HD + 8) * 2 : 0);
}
template <int HD, bool QUANT>
__host__ __device__ constexpr int tile_smem_bytes() {
  return tile_ring_bytes<HD, QUANT>() +
         (q_in_smem<HD>() ? QROWS * (HD + QPAD) * 2 : 0);
}

// One thread's two query rows (g and g + 8 of its warp's 16).
template <int HD>
struct TileRows {
  // q as mma A fragments, one per 16 channels (hd 256: in shared memory)
  uint32_t qf[q_in_smem<HD>() ? 1 : HD / 16][4];
  float o[HD / 8][4];       // unnormalized P·V, one per 8 output channels
  float m[2], l[2];         // running max (log2 domain) and sum
  int lim[2];               // the row attends columns <= lim
  bool valid[2];            // a real query row (not padding)
};

// The ancestor-mask rows of a tree span (ANC builds only): the row's base
// (its kv_lens: the span's first column) and this thread's two rows' masks.
struct TileAnc {
  int base;
  uint32_t mask[2];  // 0: the causal rule
};

// the last column a row attends in full (all columns up to it): its causal
// limit, or for a tree row the column before its span
template <bool ANC>
__device__ __forceinline__ int full_lim(int lim, const TileAnc& a, int half) {
  if constexpr (ANC) return a.mask[half] ? a.base - 1 : lim;
  return lim;
}

// ANC: may a row attend column col?  Unsigned offsets, shifted only when
// below 32 (a shift by 32 or more is undefined)
__device__ __forceinline__ bool anc_ok(int col, int lim, int base,
                                       uint32_t mask) {
  if (mask == 0u) return col <= lim;
  const uint32_t off = static_cast<uint32_t>(col - base);
  return col < base || (off < 32u && ((mask >> off) & 1u));
}

// q rows at q + qoff[half] (HD channels); int8 pools fold K's scales
// krow_s.  hd 256: into the block's q tile in shared memory (row
// warp * 16 + g + 8 * half), which tile_walk reads after its first barrier.
template <int HD, bool QUANT>
__device__ __forceinline__ void tile_load_q(TileRows<HD>& t,
                                            const __nv_bfloat16* q,
                                            const long long (&qoff)[2],
                                            const float* krow_s,
                                            unsigned char* smem) {
  const int lane = threadIdx.x & 31, tig = lane & 3;
  uint32_t* qs = reinterpret_cast<uint32_t*>(smem + tile_ring_bytes<HD, QUANT>());
  const int row0 = (threadIdx.x >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c0 = ks * 16 + tig * 2;
      uint32_t lo = 0, hi = 0;
      if (t.valid[half]) {
        lo = q_pair(q + qoff[half] + c0, QUANT ? krow_s + c0 : nullptr);
        hi = q_pair(q + qoff[half] + c0 + 8, QUANT ? krow_s + c0 + 8 : nullptr);
      }
      if constexpr (q_in_smem<HD>()) {
        uint32_t* r = qs + (row0 + half * 8) * ((HD + QPAD) / 2);
        r[c0 / 2] = lo;
        r[c0 / 2 + 4] = hi;
      } else {
        t.qf[ks][half] = lo;
        t.qf[ks][2 + half] = hi;
      }
    }
  }
}

// Walk columns [c_lo, c_hi) of the row whose page table is `tab`, kv head
// kvh (pools [P, K, ps, HD], page_stride = K·ps·HD), into t.o / t.m / t.l.
// ANC: the rows' ancestor masks `anc` replace the causal limit where nonzero.
template <int HD, bool QUANT, bool ANC = false>
__device__ __forceinline__ void tile_walk(TileRows<HD>& t,
                                          const pool_t<QUANT>* k_pages,
                                          const pool_t<QUANT>* v_pages,
                                          const int* tab, long long page_stride,
                                          int kvh, int ps, int c_lo, int c_hi,
                                          bool warp_live, float scale_log2,
                                          unsigned char* smem,
                                          const TileAnc anc = TileAnc{}) {
  using PT = pool_t<QUANT>;
  constexpr int BK = tile_bk<HD>();  // kv columns per tile (hides ::BK)
  constexpr int VEC = 16 / sizeof(PT);
  constexpr int STR = HD + VEC;      // staged row, padded by 16 bytes
  constexpr int ROWC = HD / VEC;     // 16-byte chunks per row
  constexpr int WSTR = HD + 8;       // bf16 tile row, padded by 16 bytes
  PT* Ks = reinterpret_cast<PT*>(smem);  // [STAGES][BK][STR]
  PT* Vs = Ks + STAGES * BK * STR;       // [STAGES][BK][STR]
  // int8: the staged tile widened once per block into bf16 [BK][WSTR]
  __nv_bfloat16* Kw = reinterpret_cast<__nv_bfloat16*>(Vs + STAGES * BK * STR);
  __nv_bfloat16* Vw = Kw + BK * WSTR;
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  // hd 256: this lane's ldmatrix row of the warp's q tile (rows lane & 15,
  // channels + 8 for lanes 16-31: the A fragment's four 8x8 matrices)
  const __nv_bfloat16* qrow =
      reinterpret_cast<const __nv_bfloat16*>(smem + tile_ring_bytes<HD, QUANT>()) +
      ((tid >> 5) * 16 + (lane & 15)) * (HD + QPAD) + (lane >> 4) * 8;

  // stage columns [kv0, kv0 + BK) of this split; past c_hi: zero-filled
  auto issue = [&](int i) {
    const int kv0 = c_lo + i * BK;
    const int p0 = kv0 / ps, o0 = kv0 - p0 * ps;  // the tile's first page
    PT* kd = Ks + (i % STAGES) * BK * STR;
    PT* vd = Vs + (i % STAGES) * BK * STR;
    for (int c = tid; c < BK * ROWC; c += NTHREADS) {
      const int r = c / ROWC, cc = (c % ROWC) * VEC;
      const bool ok = kv0 + r < c_hi;
      int pi = p0, o = o0 + r;  // (page, slot) of column kv0 + r
      while (o >= ps) {
        o -= ps;
        ++pi;
      }
      const long long off =
          ok ? tab[pi] * page_stride + ((long long)kvh * ps + o) * HD + cc : 0;
      cp_async16(kd + r * STR + cc, k_pages + off, ok ? 16 : 0);
      cp_async16(vd + r * STR + cc, v_pages + off, ok ? 16 : 0);
    }
  };

#pragma unroll
  for (int n = 0; n < HD / 8; ++n) t.o[n][0] = t.o[n][1] = t.o[n][2] = t.o[n][3] = 0.f;
  t.m[0] = t.m[1] = NEG;
  t.l[0] = t.l[1] = 0.f;

  const int n_tiles = c_hi > c_lo ? (c_hi - c_lo + BK - 1) / BK : 0;
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
    const __nv_bfloat16* kt;
    const __nv_bfloat16* vt;
    if constexpr (QUANT) {
      widen_tile<HD>(Ks + (i % STAGES) * BK * STR, Kw);
      widen_tile<HD>(Vs + (i % STAGES) * BK * STR, Vw);
      __syncthreads();
      kt = Kw;
      vt = Vw;
    } else {
      kt = Ks + (i % STAGES) * BK * STR;
      vt = Vs + (i % STAGES) * BK * STR;
    }
    const int kv0 = c_lo + i * BK;
    if (warp_live) {
      // S = Q K^T for this warp's 16 rows x BK columns
      float s[BK / 8][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        uint32_t qa[4];
        const uint32_t* af;
        if constexpr (q_in_smem<HD>()) {
          ldsm_x4(qrow + ks * 16, qa);
          af = qa;
        } else {
          af = t.qf[ks];
        }
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          const __nv_bfloat16* kp = kt + (j * 8 + g) * WSTR + ks * 16 + tig * 2;
          mma_bf16(s[j], af, kpair(kp), kpair(kp + 8));
        }
      }

      // per-token causal mask, split bound + online softmax (log2 domain);
      // a tile both of this thread's rows attend in full needs no mask
      float mx[2] = {NEG, NEG};
      const int last = kv0 + BK - 1;
      if (last < c_hi && t.valid[0] && t.valid[1] &&
          last <= full_lim<ANC>(t.lim[0], anc, 0) &&
          last <= full_lim<ANC>(t.lim[1], anc, 1)) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] *= scale_log2;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int half = e >> 1;
            const int col = kv0 + j * 8 + tig * 2 + (e & 1);
            bool ok;
            if constexpr (ANC)
              ok = t.valid[half] && col < c_hi &&
                   anc_ok(col, t.lim[half], anc.base, anc.mask[half]);
            else
              ok = t.valid[half] && col <= t.lim[half] && col < c_hi;
            const float val = ok ? s[j][e] * scale_log2 : NEG;
            s[j][e] = val;
            mx[half] = fmaxf(mx[half], val);
          }
        }
      }
      float alpha[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffff, mx[half], 1));
        mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffff, mx[half], 2));
        const float m_new = fmaxf(t.m[half], mx[half]);
        alpha[half] = exp2f(t.m[half] - m_new);
        t.m[half] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int half = e >> 1;
          // a row masked so far has m == NEG: its p must be 0, not exp(0)
          const float p = t.m[half] > 0.5f * NEG ? exp2f(s[j][e] - t.m[half]) : 0.f;
          s[j][e] = p;
          rs[half] += p;
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        rs[half] += __shfl_xor_sync(0xffffffff, rs[half], 1);
        rs[half] += __shfl_xor_sync(0xffffffff, rs[half], 2);
        t.l[half] = t.l[half] * alpha[half] + rs[half];
      }
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        t.o[n][0] *= alpha[0]; t.o[n][1] *= alpha[0];
        t.o[n][2] *= alpha[1]; t.o[n][3] *= alpha[1];
      }

      // O += P V: the S accumulators re-packed as bf16 A fragments; V's B
      // fragments from the row-major tile through ldmatrix.trans, two
      // 8-channel blocks at a time
      const int vrow = (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4];
        a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int n = 0; n < HD / 8; n += 2) {
          uint32_t bf[4];
          ldsm_x4_trans(vt + (kk * 16 + vrow) * WSTR + n * 8 + (lane >> 4) * 8, bf);
          mma_bf16(t.o[n], a, bf[0], bf[1]);
          mma_bf16(t.o[n + 1], a, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // tile i consumed before its stage is refilled
  }
}

// out rows at out + qoff[half]: acc / l (0 where nothing was attended);
// int8 pools: times V's scales vrow_s
template <int HD, bool QUANT>
__device__ __forceinline__ void tile_store_out(const TileRows<HD>& t,
                                               const long long (&qoff)[2],
                                               const float* vrow_s,
                                               __nv_bfloat16* out) {
  const int tig = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (!t.valid[half]) continue;
    const float inv = t.l[half] > 0.f ? 1.f / t.l[half] : 0.f;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int col = n * 8 + tig * 2;
      float o0 = t.o[n][half * 2] * inv, o1 = t.o[n][half * 2 + 1] * inv;
      if constexpr (QUANT) {
        o0 *= vrow_s[col];
        o1 *= vrow_s[col + 1];
      }
      *reinterpret_cast<uint32_t*>(out + qoff[half] + col) = pack_bf16(o0, o1);
    }
  }
}

// this split's partial state of tile rows r < nrows: acc at p_acc + r·HD,
// (m, l) at p_ml + 2r
template <int HD>
__device__ __forceinline__ void tile_store_partial(const TileRows<HD>& t,
                                                   float* p_acc, float* p_ml,
                                                   int nrows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = warp * 16 + g + half * 8;
    if (r >= nrows) continue;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<float2*>(p_acc + (long long)r * HD + n * 8 + tig * 2) =
          make_float2(t.o[n][half * 2], t.o[n][half * 2 + 1]);
    if (tig == 0)
      *reinterpret_cast<float2*>(p_ml + r * 2) = make_float2(t.m[half], t.l[half]);
  }
}

// The last block of a group: merge the tile rows over the live splits
// (p_acc / p_ml at split 0, row 0; nrows rows a split) into out +
// row_out(r), skipping rows with row_out(r) < 0; int8: times V's scales
// vrow_s.  Rows go to the warps in turn (a verify tile's 20 real rows are
// 5 a warp, not 16 on warp 0); one lane per HD / 32 output channels.
template <int HD, bool QUANT, typename RowOut>
__device__ __forceinline__ void tile_merge(const float* p_acc, const float* p_ml,
                                           int live, int nrows,
                                           const float* vrow_s,
                                           __nv_bfloat16* out, RowOut row_out) {
  constexpr int CPL = HD / 32;  // output channels per lane
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = lane * CPL;
  for (int r = warp; r < nrows; r += NWARPS) {
    const long long dst = row_out(r);
    if (dst < 0) continue;
    float o[CPL];
    split_merge_row<CPL>(p_ml + r * 2, p_acc + (long long)r * HD, live,
                         (long long)nrows * 2, (long long)nrows * HD, c0, o);
    if constexpr (QUANT) {
#pragma unroll
      for (int c = 0; c < CPL; ++c) o[c] *= vrow_s[c0 + c];
    }
    if constexpr (CPL == 1) {
      out[dst + c0] = __float2bfloat16(o[0]);
    } else {
#pragma unroll
      for (int c = 0; c < CPL; c += 2)
        *reinterpret_cast<uint32_t*>(out + dst + c0 + c) = pack_bf16(o[c], o[c + 1]);
    }
  }
}

}  // namespace
