// Causal flash-attention prefill for Hopper (sm_90a), bf16 in, bf16 out.
//
// Replaces the TPU kernel lmrs_tpu/ops/flash_attention.py `_flash_kernel`
// (called by `flash_attention`, pallas_call at :208).  Same function:
// causal attention over fresh (position-0-based) sequences, GQA by
// h / n_rep, key mask k < lengths[b], optional same-segment mask for packed
// prompts, f32 running max / sum / accumulator (FlashAttention-2 schedule).
//
// Layout: q [B, S, H, hd], k/v [B, S, K, hd], out [B, S, H, hd], any
// strides with a contiguous last dimension (the JAX layout, no transposes).
// Rows at positions >= lengths[b] are written as zeros; fully masked rows
// are zeros, never NaN.
//
// Design.  One block per (q tile of 64 rows, q head, batch row); 4 warps,
// each owning 16 query rows.  A loop over 64-row kv tiles takes the place
// of the TPU's sequential grid axis.  Each kv tile is staged in shared
// memory (K row-major, V transposed, both padded against bank conflicts)
// and the two products run on the tensor cores with
// mma.sync.m16n8k16 bf16 -> f32; P never leaves registers (the S
// accumulator fragments are re-packed as the A operand of P·V).  Tiles
// above the diagonal, past lengths[b], or ending before the first segment
// the q tile touches are skipped (segments are contiguous, so a packed
// row costs its per-segment causal work, not the full causal triangle).
//
// Bound on the H100: the packed 2048-row prefill is compute-bound
// (~4·S²/2·H·hd useful FLOPs vs a few MB of q/k/v).  This first version
// loads tiles synchronously (no cp.async/TMA pipelining, no wgmma), so it
// reaches a fraction of the 989 TFLOP/s bf16 peak; the measured time is in
// PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block (16 per warp)
constexpr int BK = 64;        // kv rows per tile
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

template <int HD>
__global__ void __launch_bounds__(NWARPS * 32)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out,
                     const int* __restrict__ lengths,
                     const int* __restrict__ seg,  // [B, S] or nullptr
                     int S, int H, int KH,
                     long long q_sb, long long q_ss, long long q_sh,
                     long long k_sb, long long k_ss, long long k_sh,
                     long long v_sb, long long v_ss, long long v_sh,
                     long long o_sb, long long o_ss, long long o_sh,
                     long long seg_sb, float scale_log2) {
  constexpr int KSTR = HD + 8;   // padded K row (bf16 elements)
  constexpr int VSTR = BK + 8;   // padded transposed-V row
  __shared__ __align__(16) __nv_bfloat16 Ks[BK * KSTR];
  __shared__ __align__(16) __nv_bfloat16 Vt[HD * VSTR];
  __shared__ int seg_k[BK];
  __shared__ int seg_lo_found;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KH);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q_start = qt * BQ;
  const int length = min(lengths[b], S);
  const int* segb = seg ? seg + b * seg_sb : nullptr;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  __nv_bfloat16* ob = out + b * o_sb + h * o_sh;
  const int row0 = q_start + warp * 16 + g;  // this thread's rows: row0, row0+8

  if (q_start >= length) {  // q tile entirely past the valid prefix: zeros
    for (int r = warp * 16; r < warp * 16 + 16; ++r) {
      const int row = q_start + r;
      if (row < S)
        for (int d = lane; d < HD; d += 32)
          ob[row * o_ss + d] = __float2bfloat16(0.f);
    }
    return;
  }

  // kv range: [kv_lo, kv_hi).  kv_lo = start of the segment of the tile's
  // first row (rounded down to a tile): earlier tiles only hold earlier
  // segments, which no row of this tile can see.
  int kv_lo = 0;
  if (segb) {
    const int s0 = segb[q_start];
    if (tid == 0) seg_lo_found = -1;
    __syncthreads();
    for (int base = q_start - 1; base >= 0; base -= NWARPS * 32) {
      const int i = base - tid;
      if (i >= 0 && segb[i] != s0) atomicMax(&seg_lo_found, i);
      __syncthreads();
      const int found = seg_lo_found;
      __syncthreads();  // every thread has read it before the next atomics
      if (found >= 0) break;
    }
    kv_lo = ((seg_lo_found + 1) / BK) * BK;
  }
  const int kv_hi = min(q_start + BQ, length);

  // Q fragments (A operand, row-major 16x16 per k-step), kept in registers
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + half * 8;
      const int c0 = ks * 16 + tig * 2;
      uint32_t lo = 0, hi = 0;
      if (row < S) {
        lo = *reinterpret_cast<const uint32_t*>(qb + row * q_ss + c0);
        hi = *reinterpret_cast<const uint32_t*>(qb + row * q_ss + c0 + 8);
      }
      qf[ks][half] = lo;       // a0 (row g) / a1 (row g+8)
      qf[ks][2 + half] = hi;   // a2 / a3
    }
  }
  int segq[2] = {0, 0};
  if (segb) {
    segq[0] = row0 < S ? segb[row0] : -1;
    segq[1] = row0 + 8 < S ? segb[row0 + 8] : -1;
  }

  float o_acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    o_acc[n][0] = o_acc[n][1] = o_acc[n][2] = o_acc[n][3] = 0.f;
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f};

  const __nv_bfloat16* kb = k + b * k_sb + kvh * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + kvh * v_sh;

  for (int kv0 = kv_lo; kv0 < kv_hi; kv0 += BK) {
    __syncthreads();  // previous tile fully consumed
    // stage K (row-major) and V (transposed) tiles; rows past S read as 0
    for (int idx = tid; idx < BK * (HD / 8); idx += NWARPS * 32) {
      const int r = idx / (HD / 8), c = (idx % (HD / 8)) * 8;
      const int row = kv0 + r;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (row < S) {
        kv4 = *reinterpret_cast<const uint4*>(kb + row * k_ss + c);
        vv4 = *reinterpret_cast<const uint4*>(vb + row * v_ss + c);
      }
      *reinterpret_cast<uint4*>(&Ks[r * KSTR + c]) = kv4;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv4);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[(c + j) * VSTR + r] = ve[j];
    }
    if (segb && tid < BK) seg_k[tid] = (kv0 + tid < S) ? segb[kv0 + tid] : -2;
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 kv columns
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

    // mask + online softmax (log2 domain); each thread holds 2 rows
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const int qpos = row0 + half * 8;
        const int kcol = j * 8 + tig * 2 + (e & 1);
        const int kpos = kv0 + kcol;
        bool ok = kpos <= qpos && qpos < length;
        if (segb) ok = ok && seg_k[kcol] == segq[half];
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
    const int row = row0 + half * 8;
    if (row >= S) continue;
    const float inv = l_run[half] > 0.f ? 1.f / l_run[half] : 0.f;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int col = n * 8 + tig * 2;
      *reinterpret_cast<uint32_t*>(ob + row * o_ss + col) =
          pack_bf16(o_acc[n][half * 2] * inv, o_acc[n][half * 2 + 1] * inv);
    }
  }
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
  dim3 grid((S + BQ - 1) / BQ, H, B);
  dim3 block(NWARPS * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale_log2 = sm_scale * LOG2E;
#define LMRS_FLASH_ARGS                                                      \
  static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k), \
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), \
      static_cast<const int*>(lengths), static_cast<const int*>(seg), S, H,  \
      KH, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss,  \
      o_sh, seg_sb, scale_log2
  if (hd == 128) {
    flash_prefill_kernel<128><<<grid, block, 0, st>>>(LMRS_FLASH_ARGS);
  } else if (hd == 64) {
    flash_prefill_kernel<64><<<grid, block, 0, st>>>(LMRS_FLASH_ARGS);
  } else if (hd == 32) {
    flash_prefill_kernel<32><<<grid, block, 0, st>>>(LMRS_FLASH_ARGS);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LMRS_FLASH_ARGS
  return static_cast<int>(cudaGetLastError());
}
