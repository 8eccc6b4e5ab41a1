// Order-independent scatter-add for the sampler's grid gradients (K2 in
// trilerp.cu, K5 in packed_table.cu).
//
// Every value is added into an int64 accumulator as a fixed-point number.
// Integer addition is associative, so the sums are the same bit for bit
// whatever order the atomics land in, and the same inputs give the same
// gradient on every run. With fp32 atomics they did not: the order of the
// additions changed from run to run, and the 1500 Adam iterations of the
// first frame's map carried that rounding into maps, and trajectories, that
// differed from run to run on one seed.
//
// A gradient takes three launches on the caller's stream:
//   1. a bound pass: the largest |value| that will be added goes into
//      slot[0] (as float bits: non-negative floats order like their bits, so
//      an integer atomicMax on the bits is exact);
//   2. the scatter: each value v is added as llrint(v * 2^e), one 64-bit
//      atomicAdd each, with e = 62 - ceil(log2(terms * max)), so no sum of
//      at most `terms` values leaves (-2^63, 2^63);
//   3. the finish pass: out = acc * 2^-e, as float.
// The caller zero-fills `acc` and its two slots. A non-finite value sets
// slot[1], and the finish pass then writes NaN everywhere.
//
// Precision: the step 2^-e is at most 2 * terms * max * 2^-62; at 8 x 48,000
// terms (the mapping batch) that is 1.7e-13 of the largest value, and each
// sum is off by at most half a step per value added. Entries larger than
// ~3e-6 of the largest value keep at least fp32's 24 significant bits.

#pragma once

#include <cuda_runtime.h>

namespace fixed_sum {

constexpr int kBoundThreads = 256;
constexpr int kBoundBlocks = 132 * 8;  // grid-stride: one atomicMax per block
constexpr float kFloatMax = 3.402823466e38f;

// Block-wide max of the threads' non-negative `m` into slot[0]; a thread
// that saw a non-finite value (`finite` false) sets slot[1]. Every thread of
// the block must call it.
__device__ __forceinline__ void block_max_into(float m, bool finite,
                                               unsigned int* slot) {
  __shared__ float warp_max[kBoundThreads / 32];
  if (!finite) atomicOr(slot + 1, 1u);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < (int)(blockDim.x >> 5) ? warp_max[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0 && m > 0.f) atomicMax(slot, __float_as_uint(m));
  }
}

// Bound pass over a plain array: max |x[i]| for i < n.
__global__ void __launch_bounds__(kBoundThreads) absmax_kernel(
    const float* __restrict__ x, long long n, unsigned int* slot) {
  float m = 0.f;
  bool finite = true;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float a = fabsf(__ldg(x + i));
    finite &= a <= kFloatMax;  // false for NaN and inf
    m = fmaxf(m, a);
  }
  block_max_into(m, finite, slot);
}

// 2^e for the bound in slot[0] and at most `terms` values per sum.
__device__ __forceinline__ double scale_of(const unsigned int* slot,
                                           double terms) {
  const float m = __uint_as_float(slot[0]);
  if (!(m > 0.f)) return 1.0;  // nothing but zeros to add
  int k;
  frexp((double)m * terms, &k);  // terms * m < 2^k
  return ldexp(1.0, 62 - k);
}

__device__ __forceinline__ void add(unsigned long long* acc, float v,
                                    double scale, unsigned int* slot) {
  if (!(fabsf(v) <= kFloatMax)) {
    atomicOr(slot + 1, 1u);
    return;
  }
  const long long q = __double2ll_rn((double)v * scale);
  if (q != 0) atomicAdd(acc, (unsigned long long)q);
}

__global__ void __launch_bounds__(kBoundThreads) finish_kernel(
    const unsigned long long* __restrict__ acc, float* __restrict__ out,
    long long n, const unsigned int* slot, double terms) {
  const double inv = 1.0 / scale_of(slot, terms);  // a power of two: exact
  const bool bad = slot[1] != 0u;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = bad ? __int_as_float(0x7fc00000)
                 : (float)((double)(long long)acc[i] * inv);
  }
}

// Blocks of kBoundThreads for a grid-stride pass over n entries, at most cap.
inline int blocks(long long n, long long cap) {
  const long long want = (n + kBoundThreads - 1) / kBoundThreads;
  return (int)(want < cap ? want : cap);
}

// The finish pass of a sum of `n` entries; acc[n] holds the two slots.
inline void finish(const unsigned long long* acc, float* out, long long n,
                   double terms, cudaStream_t s) {
  finish_kernel<<<blocks(n, 132LL * 64), kBoundThreads, 0, s>>>(
      acc, out, n, reinterpret_cast<const unsigned int*>(acc + n), terms);
}

}  // namespace fixed_sum
