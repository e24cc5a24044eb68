// Split-sequence helpers shared by the paged-attention kernels that split a
// row's walk over the sequence across blocks (paged_decode.cu,
// ragged_spans.cu): cp.async staging, the arrival counter that elects the
// last block of a split group, and the fixed-order merge of the splits'
// partial softmax states.
//
// Partial state of one query row in one split, f32, log2 domain: m (running
// max of the scaled scores), l (sum of exp2(score - m)) and acc[hd] (the
// unnormalized P·V sum).  A row that attended nothing in a split has
// m = -1e30, l = 0, acc = 0 and drops out of the merge.  The merge reads
// the splits in index order 0, 1, ..., live - 1, whatever order the blocks
// finished in, so two launches on the same inputs give the same bits.
//
// Counters: one int per split group, zero before a launch; the last block of
// a group to arrive resets its counter to zero, so the next launch on the
// stream finds it zero again.  Launches that share a counter buffer must be
// ordered (one stream).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float SPLIT_NEG = -1e30f;

// 16 bytes global -> shared, bypassing L1; src_bytes == 0 zero-fills the
// destination without reading the source.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Called by every thread of a block after it stored its partial state.
// True in every thread of the block that arrives last among the `live`
// blocks of its group (that block then merges); the counter is reset.
__device__ __forceinline__ bool split_arrive(int* counter, int live) {
  __shared__ int last;
  __threadfence();  // this block's partials are visible device-wide
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1) == live - 1;
    if (last) *counter = 0;  // every other block of the group has arrived
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// Merge one query row's partials over splits 0..live-1 for NV consecutive
// output channels starting at c0: ml points at split 0's (m, l) pair, acc at
// split 0's channel 0; ml_stride / acc_stride step from one split to the
// next.  o = sum_s acc_s * 2^(m_s - M) / sum_s l_s * 2^(m_s - M), 0 where
// nothing was attended.  L2 loads (__ldcg): the partials were written by
// other blocks.
template <int NV>
__device__ __forceinline__ void split_merge_row(const float* ml,
                                                const float* acc, int live,
                                                long long ml_stride,
                                                long long acc_stride, int c0,
                                                float (&o)[NV]) {
  // (unrolled: the loads of four splits are in flight together; the sums
  // still run in split order)
  float m = SPLIT_NEG;
#pragma unroll 4
  for (int s = 0; s < live; ++s) m = fmaxf(m, __ldcg(ml + s * ml_stride));
  float l = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) o[j] = 0.f;
#pragma unroll 4
  for (int s = 0; s < live; ++s) {
    const float ms = __ldcg(ml + s * ml_stride);
    const float ls = __ldcg(ml + s * ml_stride + 1);
    const float f = ls > 0.f ? exp2f(ms - m) : 0.f;
    l += ls * f;
    const float* a = acc + s * acc_stride + c0;
#pragma unroll
    for (int j = 0; j < NV; ++j) o[j] += __ldcg(a + j) * f;
  }
  const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) o[j] *= inv;
}

}  // namespace
