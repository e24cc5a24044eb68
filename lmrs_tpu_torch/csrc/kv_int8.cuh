// Int8 KV-pool helpers shared by the int8 builds of the paged kernels
// (paged_decode.cu, ragged_spans.cu, paged_decode_multi.cu).
//
// The quantization rule is the port's kv_quant_tokens
// (lmrs_tpu_torch/ops/quant.py): clip(round(x / s), -127, 127) with round
// half to even.  rintf(__fdiv_rn(x, s)) gives it bit for bit: rintf rounds
// half to even (roundf would round half away from zero), and __fdiv_rn is
// the IEEE division torch's x / s computes (a multiply by a precomputed
// 1 / s differs by an ulp often enough to flip a tie).  Never build these
// sources with --use_fast_math: it would turn the division approximate.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

template <bool QUANT>
using pool_t = typename std::conditional<QUANT, int8_t, __nv_bfloat16>::type;

__device__ __forceinline__ int8_t quant8(float x, float s) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.f), 127.f);
  return static_cast<int8_t>(r);
}

// the four int8 values of a 32-bit word, low byte first, as f32 — exactly,
// on the FP32 pipe instead of the slower conversion unit: the float
// 2^23 + (x + 128) holds x + 128 in its low mantissa bits
__device__ __forceinline__ void i8x4(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;  // each byte now x + 128
  f[0] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 8 int8 values -> 8 bf16 (exact: |v| <= 127 fits bf16's mantissa)
__device__ __forceinline__ uint4 widen8(uint2 raw) {
  const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
  return make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]),
                    bf16_pair(v[4], v[5]), bf16_pair(v[6], v[7]));
}

// 8 pool values at `p` as 8 bf16 in one uint4
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ uint4 load8(const int8_t* p) {
  return widen8(*reinterpret_cast<const uint2*>(p));
}

// 8 bf16 values of `src` into the pool at `dst` (int8: quantized with the
// 8 matching scales at `sc`)
__device__ __forceinline__ void store8(__nv_bfloat16* dst,
                                       const __nv_bfloat16* src, const float*) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}
__device__ __forceinline__ void store8(int8_t* dst, const __nv_bfloat16* src,
                                       const float* sc) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&raw);
  uint2 packed;
  int8_t* o = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
  for (int e = 0; e < 8; ++e) o[e] = quant8(__bfloat162float(x[e]), sc[e]);
  *reinterpret_cast<uint2*>(dst) = packed;
}

// q channels (c, c + 1) as a bf16 pair for an mma A fragment; with K's
// scales `ks` (int8 pools) the pair is q⊙s, rounded to bf16
__device__ __forceinline__ uint32_t q_pair(const __nv_bfloat16* q,
                                           const float* ks) {
  if (ks == nullptr) return *reinterpret_cast<const uint32_t*>(q);
  return bf16_pair(__bfloat162float(q[0]) * ks[0],
                   __bfloat162float(q[1]) * ks[1]);
}

}  // namespace
