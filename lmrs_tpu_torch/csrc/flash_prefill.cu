// Causal flash-attention prefill for Hopper (sm_90a), bf16 in, bf16 out.
//
// Replaces the TPU kernel lmrs_tpu/ops/flash_attention.py `flash_attention`
// (:132; kernel body `_flash_kernel` :42, pallas_call :208).  Same function:
// causal attention over fresh (position-0-based) sequences, GQA by
// h / (H / K), key mask k < lengths[b], optional same-segment mask for
// packed prompts (segments contiguous), f32 online softmax.
//
// Layout: q [B, S, H, hd], k/v [B, S, K, hd], out [B, S, H, hd], any
// strides with a contiguous last dimension and 16-byte strides (q, k and v
// are strided views of the qkv product).  Rows at positions >= lengths[b]
// are written as zeros; a fully masked row is zero, never NaN.
//
// What bounds it on the H100.  The main path's fresh prefill is one
// unpacked row of ~1,600 tokens (map prompts are 1,358-1,871 tokens and
// never share a 2,048-token bin): at H=32, K=8, hd=128 that is 21 GFLOP of
// causal work against 33 MB, so the tensor cores bound it (0.021 ms at
// 989 TFLOP/s).  A packed reduce bin of short segments does little work
// per byte and is bound by its 42 MB of q/k/v/out (0.0125 ms at 3.35 TB/s).
// The TPU kernel walks 1,024-row blocks held in many MB of VMEM; a Hopper
// SM has 227 KB of shared memory, so the design is Hopper's own:
//
// * Block = 128 query rows of one head (two consumer warpgroups of 64
//   rows) plus one producer warp.  Grid (H, q tiles, B) with the q tile
//   index REVERSED: the hardware hands out blocks in linear order, so the
//   causal tiles with the most kv columns start first and the light ones
//   fill the last wave (no causal tail).
// * The producer warp loads the q tile with TMA (tensor maps built on the
//   host from the strides given, 128-byte swizzle, zero fill past S) and
//   streams 64-column K and V tiles into a two-stage ring guarded by
//   mbarriers (full: TMA bytes + the producer's 32 arrivals, which also
//   publish the tile's segment ids; empty: the 256 consumer threads).  The
//   next tile is in flight while the tensor cores work on this one.
// * Both products are wgmma (bf16 -> f32).  S = Q·K^T reads Q and K from
//   shared memory (both K-major: the swizzled rows TMA wrote).  O += P·V
//   takes P from registers (the S accumulator re-packed as bf16 A
//   fragments) and V row-major as an MN-major B operand: no transpose pass.
// * The two warpgroups take turns issuing Q·K^T (named barriers 1 and 2),
//   so one's softmax runs while the other's products hold the tensor cores.
// * The kv range of a block starts at the first row of its first query's
//   segment, found by a two-step warp-parallel probe of the segment ids
//   (32 lanes a step, 64 positions apart, then exact), so a packed bin
//   costs its per-segment causal work.  Each consumer warpgroup skips the
//   tiles its rows cannot see, and masks only the tiles that cross the
//   diagonal, the length or a segment boundary.
// * hd 64 and 128 are 64-column swizzle blocks; hd 32 loads a 64-column box
//   whose upper half TMA fills with zeros, so every build shares one body
//   (the zero columns cost the tiny preset nothing it could measure).
// * hd 256 (the Gemma presets): four 64-column blocks; Q·K^T runs 16
//   k-steps and P·V is two m64n128 products over the two halves of V.
//   Each consumer thread holds a 64 x 256 f32 accumulator (128 registers)
//   beside the score tile and P.  Two consumer warpgroups and a producer
//   warp get 168 registers a thread (ptxas spilled and serialized the
//   wgmma), and ptxas allocates within that cap whatever setmaxnreg asks
//   for later (a producer warpgroup giving registers to the consumers
//   spilled as much), so this build's block is ONE consumer
//   warpgroup of 64 query rows plus the producer warp (160 threads, up to
//   255 registers) walking 32-column K/V tiles (S = m64n32): the Q tile
//   (32 KB) and a two-stage ring (2 x 32 KB) take ~99 KB, so two blocks
//   share an SM and their warpgroups take turns at the tensor cores as
//   the ping-pong pair does at hd <= 128 (Tile<HD>).
//
// Variants built and timed on the card while this design was chosen, each
// no faster at the main shapes, so left out: 128-column kv tiles (the
// hd-128 build spills at the 168 registers a 288-thread block gets), more
// ring stages, a producer warpgroup with setmaxnreg, Q held in registers,
// overlapping one tile's softmax with the previous tile's P·V (ptxas
// serialises the wgmma unless both warpgroups walk the same tiles, and
// then it gained nothing), a persistent grid with a static heaviest-first
// deal (it loses the hardware's dynamic balancing), and clusters of the
// n_rep blocks of a kv head sharing each K/V tile by TMA multicast
// (correct, slower: the cluster moves in lock step).  ex2.approx.ftz in
// place of exp2f was kept.  What bounds it now is each warpgroup's serial
// chain per tile (Q·K^T, softmax, P·V): the tensor cores sit idle for much
// of it.  Times and bounds: PERF.md.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int STAGES = 2;             // K/V tiles in the ring
constexpr int ROWB = 128;             // bytes of one swizzled 64-column row

// A block's tiles: hd <= 128, 128 query rows (two consumer warpgroups
// that ping-pong) and 64-column K/V tiles; hd 256, 64 query rows (one
// warpgroup) and 32-column tiles (see the note above).  Plus one producer
// warp.
template <int HD>
struct Tile {
  static constexpr int NWG = HD > 128 ? 1 : 2;     // consumer warpgroups
  static constexpr int BQ = 64 * NWG;              // query rows per block
  static constexpr int BK = HD > 128 ? 32 : 64;    // kv columns per tile
  static constexpr int NCONSUMER = 128 * NWG;
  static constexpr int PRODUCER_WARP = NCONSUMER / 32;
  static constexpr int NTHREADS = NCONSUMER + 32;
};
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle's
// atom is 8 rows x 128 bytes and must start aligned).
template <int HD>
struct Smem {
  static constexpr int BQ = Tile<HD>::BQ, BK = Tile<HD>::BK;
  static constexpr int HDP = HD < 64 ? 64 : HD;  // columns staged
  static constexpr int NCB = HDP / 64;           // 64-column blocks
  static constexpr int Q = 0;                    // [NWG][NCB][64 rows]
  static constexpr int QBYTES = BQ * NCB * ROWB;
  static constexpr int K = Q + QBYTES;           // [STAGES][NCB][BK rows]
  static constexpr int KVBYTES = BK * NCB * ROWB;  // one K (or V) tile
  static constexpr int V = K + STAGES * KVBYTES;
  static constexpr int SEG = V + STAGES * KVBYTES;  // int [STAGES][BK]
  static constexpr int BAR = SEG + STAGES * BK * 4;  // full[], empty[], q
  static constexpr int BYTES = BAR + 8 * (2 * STAGES + 1) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2^x on the special-function unit, denormals flushed (the repo builds
// without --use_fast_math, under which exp2f takes a longer path)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Wait for the phase of parity `parity` to complete.  A barrier that never
// completes (a lost copy) traps after ~8 s of clock instead of hanging the
// card: the launch then fails and the wrapper's next sync reports it.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) break;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// Named barriers 1 and 2 (0 is __syncthreads): warpgroup w syncs on 1 + w
// before it issues its Q K^T and arrives on the other's after, so the two
// take turns at the tensor cores and one's softmax runs under the other's
// products.  256 threads each: 128 that sync, 128 that arrive.
__device__ __forceinline__ void turn_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void turn_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

// ---------------------------------------------------------------- TMA

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor, 128-byte swizzle.  K-major operands (Q,
// K): SBO = 1024 (next 8 rows), LBO unused.  MN-major V: LBO = the next
// 64-column block, SBO = 1024 (next 8 kv rows).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(lbo >> 4) << 16)
         | (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of wgmma operands across the
// fence / wait instructions
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

#define LMRS_D8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[32] += A[64x16] (shared, K-major) x B[16x64] (shared, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, 1, 1, 1, 0, 0;\n"
      : LMRS_D8(0), LMRS_D8(8), LMRS_D8(16), LMRS_D8(24)
      : "l"(da), "l"(db));
}

// d[16] += A[64x16] (shared, K-major) x B[16x32] (shared, K-major)
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, 1, 1, 1, 0, 0;\n"
      : LMRS_D8(0), LMRS_D8(8)
      : "l"(da), "l"(db));
}

// d[64] += A[64x16] (registers) x B[16x128] (shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : LMRS_D8(0), LMRS_D8(8), LMRS_D8(16), LMRS_D8(24), LMRS_D8(32),
        LMRS_D8(40), LMRS_D8(48), LMRS_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d[32] += A[64x16] (registers) x B[16x64] (shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : LMRS_D8(0), LMRS_D8(8), LMRS_D8(16), LMRS_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

#undef LMRS_D8

// ---------------------------------------------------------------- segments

// First position of the run of equal segment ids that ends at `pos`
// (segments are contiguous).  Warp-collective: every lane returns it.
// Step 1 probes 32 positions 64 apart going back from pos; step 2 reads the
// 64 positions where the first differing probe says the run starts.
__device__ __forceinline__ int run_start(const int* segb, int pos) {
  const int lane = threadIdx.x & 31;
  const int s0 = segb[pos];
  int hi = pos;  // segb[hi .. pos] == s0
  while (true) {
    const int p = hi - 64 * (lane + 1);
    const bool differs = p < 0 || segb[p] != s0;
    const unsigned m = __ballot_sync(0xffffffffu, differs);
    if (m == 0) {
      hi -= 64 * 32;
      continue;
    }
    // segb[base] != s0 (or base < 0), segb[base + 64] == s0
    const int base = hi - 64 * __ffs(m);
    const int p0 = base + 1 + lane, p1 = base + 33 + lane;
    const unsigned m0 = __ballot_sync(0xffffffffu, p0 >= 0 && segb[p0] == s0);
    const unsigned m1 = __ballot_sync(0xffffffffu, p1 >= 0 && segb[p1] == s0);
    return m0 ? base + __ffs(m0) : base + 32 + __ffs(m1);
  }
}

// ---------------------------------------------------------------- kernel

template <int HD>
__global__ void __launch_bounds__(Tile<HD>::NTHREADS, 1)
flash_prefill_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     __nv_bfloat16* __restrict__ out,
                     const int* __restrict__ lengths,
                     const int* __restrict__ seg,  // [B, S] or nullptr
                     int S, int H, int KH,
                     long long o_sb, long long o_ss, long long o_sh,
                     long long seg_sb, float scale_log2) {
  using L = Smem<HD>;
  constexpr int HDP = L::HDP, NCB = L::NCB;
  constexpr int BQ = Tile<HD>::BQ, BK = Tile<HD>::BK, NWG = Tile<HD>::NWG;
  constexpr int NCONSUMER = Tile<HD>::NCONSUMER, NTHREADS = Tile<HD>::NTHREADS;
  constexpr int PRODUCER_WARP = Tile<HD>::PRODUCER_WARP;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sbase = smem_u32(sm);
  int* seg_s = reinterpret_cast<int*>(sm + L::SEG);
  const uint32_t full_bar = sbase + L::BAR;                // + 8 * stage
  const uint32_t empty_bar = full_bar + 8 * STAGES;        // + 8 * stage
  const uint32_t q_bar = empty_bar + 8 * STAGES;

  const int h = blockIdx.x, b = blockIdx.z;
  const int q_start = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest first
  const int length = min(lengths[b], S);
  __nv_bfloat16* ob = out + b * o_sb + h * o_sh;

  if (q_start >= length) {  // the whole tile is past the valid prefix
    const int rows = min(BQ, S - q_start);
    for (int i = threadIdx.x; i < rows * (HD / 8); i += NTHREADS) {
      const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
      *reinterpret_cast<uint4*>(ob + (q_start + r) * o_ss + c) =
          make_uint4(0, 0, 0, 0);
    }
    return;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 32);           // the producer's lanes
      mbar_init(empty_bar + 8 * s, NCONSUMER);  // every consumer thread
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the q tile does not depend on the segment probe: start it now
    mbar_arrive_tx(q_bar, L::QBYTES);
    for (int w = 0; w < NWG; ++w)
      for (int cb = 0; cb < NCB; ++cb)
        tma_load_4d(sbase + L::Q + (w * NCB + cb) * 64 * ROWB, &tm_q, q_bar,
                    cb * 64, h, q_start + 64 * w, b);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int* segb = seg ? seg + b * seg_sb : nullptr;
  // kv tiles [blk_lo + i*BK) for i < n_tiles: from the start of the first
  // query's segment to the block's last visible column
  const int blk_lo = segb ? run_start(segb, q_start) : 0;
  const int kv_hi = min(q_start + BQ, length);
  const int n_tiles = (kv_hi - blk_lo + BK - 1) / BK;
  const int kvh = h / (H / KH);

  if (warp >= PRODUCER_WARP) {
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % STAGES;
      if (it >= STAGES) mbar_wait(empty_bar + 8 * s, ((it / STAGES) + 1) & 1);
      const int kv0 = blk_lo + it * BK;
      if (segb)
        for (int j = lane; j < BK; j += 32)
          seg_s[s * BK + j] = kv0 + j < S ? segb[kv0 + j] : -2;
      if (lane == 0) {
        mbar_arrive_tx(full_bar + 8 * s, 2 * L::KVBYTES);
        for (int cb = 0; cb < NCB; ++cb) {
          tma_load_4d(sbase + L::K + (s * NCB + cb) * BK * ROWB, &tm_k,
                      full_bar + 8 * s, cb * 64, kvh, kv0, b);
          tma_load_4d(sbase + L::V + (s * NCB + cb) * BK * ROWB, &tm_v,
                      full_bar + 8 * s, cb * 64, kvh, kv0, b);
        }
      } else {
        mbar_arrive(full_bar + 8 * s);
      }
    }
    return;
  }

  // ------------------------------------------ consumers: NWG x 64 rows
  const int wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q_start + 64 * wg;  // this warpgroup's first row
  const bool wg_live = r0 < length;
  const int r_last = min(r0 + 63, length - 1);
  const int qpos[2] = {r0 + 16 * wq + g, r0 + 16 * wq + g + 8};
  int wg_lo = 0, seg_last = 0, segq[2] = {0, 0};
  if (segb && wg_live) {
    wg_lo = run_start(segb, r0);  // no row here sees a column before it
    seg_last = segb[r_last];
    segq[0] = qpos[0] < S ? segb[qpos[0]] : -1;
    segq[1] = qpos[1] < S ? segb[qpos[1]] : -1;
  }

  float o[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f};

  if (NWG == 2 && wg == 1) turn_arrive(1);  // warpgroup 0 goes first
  mbar_wait(q_bar, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const int kv0 = blk_lo + it * BK;
    mbar_wait(full_bar + 8 * s, (it / STAGES) & 1);
    __syncwarp();
    if constexpr (NWG == 2) turn_sync(1 + wg);
    if (!(wg_live && kv0 <= r_last && kv0 + BK > wg_lo)) {
      if constexpr (NWG == 2) turn_arrive(2 - wg);
    } else {
      // S = Q K^T: 64 rows x BK columns, f32
      float sc[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < HDP / 16; ++ks) {
        const uint32_t koff = (ks & 3) * 32;  // 16 columns in the block
        const uint64_t dq = desc_sw128(
            sbase + L::Q + (wg * NCB + (ks >> 2)) * 64 * ROWB + koff, 16, 1024);
        const uint64_t dk = desc_sw128(
            sbase + L::K + (s * NCB + (ks >> 2)) * BK * ROWB + koff, 16, 1024);
        if constexpr (BK == 64) {
          wgmma_ss_n64(sc, dq, dk);
        } else {
          wgmma_ss_n32(sc, dq, dk);
        }
      }
      wgmma_commit();
      if constexpr (NWG == 2) turn_arrive(2 - wg);
      wgmma_wait_all();
      fence_regs(sc);

      // mask (only where the tile crosses the diagonal, the length or a
      // segment boundary) and the online softmax, log2 domain.  Thread
      // holds rows g, g+8 of its warp's 16: sc[4j + e], column 8j + 2t +
      // (e & 1), row half e >> 1.
      const bool unmasked = kv0 + BK - 1 <= r0 && kv0 + BK <= length &&
                            (!segb || seg_s[s * BK] == seg_last);
      float mx[2] = {NEG, NEG};
      if (unmasked) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      } else {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int half = (i >> 1) & 1;
          const int col = 8 * (i >> 2) + 2 * t + (i & 1);
          const int kpos = kv0 + col;
          bool ok = kpos <= qpos[half] && kpos < length;
          if (segb) ok = ok && seg_s[s * BK + col] == segq[half];
          sc[i] = ok ? sc[i] : NEG;
          mx[half] = fmaxf(mx[half], sc[i]);
        }
      }
      float mref[2], alpha[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
        mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
        const float m_new = fmaxf(m_run[half], mx[half]);
        alpha[half] = ex2((m_run[half] - m_new) * scale_log2);
        m_run[half] = m_new;
        // a row with nothing visible so far keeps p = exp2(-huge) = 0
        mref[half] = (m_new == NEG ? 0.f : m_new) * scale_log2;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int half = (i >> 1) & 1;
        sc[i] = ex2(fmaf(sc[i], scale_log2, -mref[half]));
        rs[half] += sc[i];
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        rs[half] += __shfl_xor_sync(0xffffffffu, rs[half], 1);
        rs[half] += __shfl_xor_sync(0xffffffffu, rs[half], 2);
        l_run[half] = l_run[half] * alpha[half] + rs[half];
      }
#pragma unroll
      for (int i = 0; i < HDP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

      // O += P V: P as bf16 A fragments (k-step kk = columns 16kk..16kk+15)
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
      fence_regs(pa);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv = desc_sw128(
            sbase + L::V + s * NCB * BK * ROWB + kk * 16 * ROWB, BK * ROWB, 1024);
        if constexpr (HDP == 256) {  // the two 128-channel halves of V
          wgmma_rs_n128(reinterpret_cast<float (&)[64]>(o[0]), pa[kk], dv);
          wgmma_rs_n128(reinterpret_cast<float (&)[64]>(o[64]), pa[kk],
                        desc_sw128(sbase + L::V + (s * NCB + 2) * BK * ROWB +
                                       kk * 16 * ROWB,
                                   BK * ROWB, 1024));
        } else if constexpr (HDP == 128) {
          wgmma_rs_n128(o, pa[kk], dv);
        } else {
          wgmma_rs_n64(o, pa[kk], dv);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
    }
    mbar_arrive(empty_bar + 8 * s);
  }

  // out = acc / l; rows past the length (and rows that saw nothing) zero
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = qpos[half];
    if (row >= S) continue;
    const float inv =
        row < length && l_run[half] > 0.f ? 1.f / l_run[half] : 0.f;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      *reinterpret_cast<uint32_t*>(ob + row * o_ss + 8 * n + 2 * t) =
          pack_bf16(o[4 * n + 2 * half] * inv, o[4 * n + 2 * half + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [B, S, heads, hd] bf16 view as a 4-d tensor map (hd innermost) whose
// box is 64 columns x 1 head x `rows` positions x 1 batch row, 128-byte
// swizzle, zeros past every edge.  Strides of size-1 dimensions do not
// matter to torch and are replaced by packed ones.
bool encode_view(EncodeTiled enc, CUtensorMap* map, const void* base, int B,
                 int S, int heads, int hd, long long sb, long long ss,
                 long long sh, int rows) {
  if (heads == 1) sh = hd;
  if (S == 1) ss = sh * heads;
  if (B == 1) sb = ss * S;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                        static_cast<cuuint64_t>(heads),
                        static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                           static_cast<cuuint64_t>(ss) * 2,
                           static_cast<cuuint64_t>(sb) * 2};
  cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The operands' strides, in elements: [B, S, heads, hd] views.
struct Views {
  const void *q, *k, *v;
  void* out;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
};

// Tensor maps (boxes of 64 q rows, Tile<HD>::BK k/v rows) and the launch
// of the hd-HD build.
template <int HD>
cudaError_t launch(EncodeTiled enc, const Views& a, const void* lengths,
                   const void* seg, int B, int S, int H, int KH,
                   long long seg_sb, float scale_log2, cudaStream_t st) {
  constexpr int BK = Tile<HD>::BK, BQ = Tile<HD>::BQ;
  CUtensorMap tq, tk, tv;
  if (!encode_view(enc, &tq, a.q, B, S, H, HD, a.q_sb, a.q_ss, a.q_sh, 64) ||
      !encode_view(enc, &tk, a.k, B, S, KH, HD, a.k_sb, a.k_ss, a.k_sh, BK) ||
      !encode_view(enc, &tv, a.v, B, S, KH, HD, a.v_sb, a.v_ss, a.v_sh, BK))
    return cudaErrorInvalidValue;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_prefill_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Smem<HD>::BYTES);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  const dim3 grid(H, (S + BQ - 1) / BQ, B);
  flash_prefill_kernel<HD><<<grid, Tile<HD>::NTHREADS, Smem<HD>::BYTES, st>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(a.out),
      static_cast<const int*>(lengths), static_cast<const int*>(seg), S, H, KH,
      a.o_sb, a.o_ss, a.o_sh, seg_sb, scale_log2);
  return cudaGetLastError();
}

}  // namespace

extern "C" int lmrs_flash_prefill_bf16(
    const void* q, const void* k, const void* v, void* out,
    const void* lengths, const void* seg,
    int B, int S, int H, int KH, int hd,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    long long seg_sb, float sm_scale, void* stream) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  const Views a{q, k, v, out, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float sl2 = sm_scale * LOG2E;
  cudaError_t e;
  if (hd == 256) {
    e = launch<256>(enc, a, lengths, seg, B, S, H, KH, seg_sb, sl2, st);
  } else if (hd == 128) {
    e = launch<128>(enc, a, lengths, seg, B, S, H, KH, seg_sb, sl2, st);
  } else if (hd == 64) {
    e = launch<64>(enc, a, lengths, seg, B, S, H, KH, seg_sb, sl2, st);
  } else if (hd == 32) {
    e = launch<32>(enc, a, lengths, seg, B, S, H, KH, seg_sb, sl2, st);
  } else {  // no build: never hand a head dim to another one's kernel
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
