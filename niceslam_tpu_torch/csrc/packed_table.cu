// The packed corner-table sampler route for Hopper (sm_90a): table build
// (K3), row gather (K4) and the grid gradient as a pair scatter-add (K5),
// with a plain C interface bound through ctypes by
// niceslam_tpu_torch/ops/packed_kernels.py.
//
// Conventions (shared with the plain PyTorch versions in packed_kernels.py
// and with the JAX reference, ops/trilinear.corner_table / trilerp_packed):
//   grid   [R = Z*Y*X, C] float32, channel-last rows, row = (z*Y + y)*X + x
//   table  [R, 8C]: row (z, y, x) holds its 8 corners in [x][y][z] block
//          order, block b = x1*4 + y1*2 + z1 = grid[z+z1, y+y1, x+x1], the +1
//          neighbours edge-replicated on all three axes
//   ct8    [N, 8, C] corner cotangents in k = z1*4 + y1*2 + x1 order, so the
//          x-adjacent corners k = 2j, 2j+1 form the pair j = z1*2 + y1
//
// K3 corner_table replaces corner_table_pallas / _corner_table_kernel
// (niceslam_tpu/ops/pallas_trilerp.py:72-140). The TPU kernel held the grid
// in VMEM and wrote one Z-slab of the table per grid step, with a zb == 1
// special case for a prime Z. Here one thread writes one output vector
// (float4 when C is a multiple of 4): consecutive threads write consecutive
// vectors of a table row, so every write is coalesced, and each source row
// (128 B at C = 32) is read by 8 neighbouring threads. The grid (6.2 MB at
// the fine level) stays in the 50 MB L2 while the table streams out, so no
// tiling in Z is needed and any Z >= 1 takes the same path.
// Bound (fine level 38x24x53x32): reads the grid once (6.2 MB) and writes
// the table once (49.5 MB): 55.7 MB at 3.35 TB/s = 16.6 us. It does no
// arithmetic: it is bound by bytes.
//
// K4 gather_rows replaces gather_rows_pallas / _gather_kernel
// (pallas_trilerp.py:144-176), which could not lower on the TPU (no
// arbitrary-row gather in Mosaic). Here a group of W/4 threads copies one
// row: at W = 8C = 256 that is 64 threads, one float4 each, so a 1 KB row is
// read and written as coalesced 16-byte accesses; offsets are 64-bit.
// Bound (N = 48,000, W = 256): 49.2 MB of rows read, 49.2 MB written and
// 0.2 MB of indices: 98.5 MB at 3.35 TB/s = 29.4 us.
//
// K5 scatter_corners replaces scatter_corners_pallas / _scatter_pairs_kernel
// (pallas_trilerp.py:262-320). The TPU kernel accumulated into a VMEM-resident
// grid with `+=` and relied on its grid steps running in order; blocks on the
// GPU run in no order. So the sum is a row-owner reduction in int64 fixed
// point (fixed_sum.cuh), the same bits whatever order the points come in, as
// for K2 in trilerp.cu: a pass over ct8 (16-byte loads) takes the bound of
// its values while counting each in-range pair j of point n in the bucket of
// its start row idx4[n, j]; after the scan and the fill, the owner of grid
// row r walks bucket r, whose pairs give it ct8[n, 2j, :] (their left row),
// and bucket r - 1, whose pairs give it ct8[n, 2j + 1, :] (their right row).
// Bound (fine level, N = 48,000): reads ct8 (49.2 MB) and idx4 (0.8 MB),
// writes the grid (6.2 MB): 56.1 MB at 3.35 TB/s = 16.8 us. Beyond it: the
// bound pass and the owners each read ct8 (the owners one 128-byte row per
// entry, at C = 32, in the order of the buckets), plus ~1 MB of counts,
// offsets and ids.
//
// Indices are int32 and in range by construction (the route's starts are
// clipped to dim-2); K4 clamps a row index and K5 skips a pair that would
// leave [0, R) so that a bad index cannot touch memory outside the tensors.
// Each entry point returns cudaGetLastError() after the launch; launches go
// on the caller's stream and never synchronize.

#include <cuda_runtime.h>

#include "fixed_sum.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int clampi(int a, int lo, int hi) {
  return a < lo ? lo : (a > hi ? hi : a);
}

// V is float4 (C % 4 == 0, 16-byte aligned pointers) or float; Cv = C / lanes.
template <typename V>
__global__ void __launch_bounds__(kThreads) corner_table_kernel(
    const V* __restrict__ grid, V* __restrict__ table, long long total,
    int Z, int Y, int X, int Cv) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long row = t / (8 * Cv);
    const int rem = (int)(t - row * 8 * Cv);
    const int b = rem / Cv;
    const int c = rem - b * Cv;
    const int x = (int)(row % X);
    const long long zy = row / X;
    const int y = (int)(zy % Y);
    const int z = (int)(zy / Y);
    const int x1 = b >> 2, y1 = (b >> 1) & 1, z1 = b & 1;
    const long long src =
        ((long long)min(z + z1, Z - 1) * Y + min(y + y1, Y - 1)) * X +
        min(x + x1, X - 1);
    table[t] = __ldg(grid + src * Cv + c);
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads) gather_rows_kernel(
    const V* __restrict__ table, const int* __restrict__ idx,
    V* __restrict__ out, long long total, int R, int Wv) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long n = t / Wv;
    const int w = (int)(t - n * Wv);
    const long long r = clampi(__ldg(idx + n), 0, R - 1);
    out[t] = __ldg(table + r * Wv + w);
  }
}

// The bound of ct8 (max |value|, and whether one is non-finite) over all of
// it, `n4` float4s then the rest, and the bucket count of every in-range pair.
__global__ void __launch_bounds__(kThreads) scatter_corners_count_kernel(
    const int* __restrict__ idx4, const float* __restrict__ ct8, long long n4,
    long long total, long long pairs, int R, int* __restrict__ counts,
    unsigned int* slot) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float m = 0.f;
  bool finite = true;
  auto see = [&](float x) {
    const float a = fabsf(x);
    finite &= a <= fixed_sum::kFloatMax;  // false for NaN and inf
    m = fmaxf(m, a);
  };
  const float4* c4 = reinterpret_cast<const float4*>(ct8);
  long long i = tid;
  for (; i + 3 * stride < n4; i += 4 * stride) {  // four loads in flight
    float4 x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) x[u] = __ldg(c4 + i + u * stride);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      see(x[u].x);
      see(x[u].y);
      see(x[u].z);
      see(x[u].w);
    }
  }
  for (; i < n4; i += stride) {
    const float4 x = __ldg(c4 + i);
    see(x.x);
    see(x.y);
    see(x.z);
    see(x.w);
  }
  for (long long t = 4 * n4 + tid; t < total; t += stride) see(__ldg(ct8 + t));
  // Warp-uniform trips, so that a warp adds its pairs of one start at once.
  const int lane = threadIdx.x & 31;
  for (long long p0 = tid - lane; p0 < pairs; p0 += stride) {
    const long long p = p0 + lane;
    const int r = p < pairs ? __ldg(idx4 + p) : -1;
    const bool live = r >= 0 && r <= R - 2;
    const unsigned int active = __ballot_sync(0xffffffffu, live);
    if (live) fixed_sum::claim(counts, r, active);
  }
  fixed_sum::block_max_into(m, finite, slot);
}

// The pairs' terms for the row owners (fixed_sum::row_sum_kernel): source
// s of row r is bucket r - s, and a pair p = n*4 + j there adds its x1 = s
// row, ct8[n, 2j + s, :] = ct8 row 2p + s, as it is.
struct PairTerms {
  static constexpr int kSources = 2;
  const float* values;  // ct8 [N, 8, C]
  long long R;
  int C;

  // Buckets [lo, hi) that source s of rows [r0, r1) can read (bucket R - 1
  // holds no pair).
  __device__ __forceinline__ void bucket_range(long long r0, long long r1, int s,
                                               long long R_, long long* lo,
                                               long long* hi) const {
    *lo = r0 - s > 0 ? r0 - s : 0;
    *hi = r1 - s < R_ ? r1 - s : R_;
  }

  __device__ __forceinline__ bool source(long long r, int s,
                                         long long* b) const {
    const long long key = r - s;
    if (key < 0 || key > R - 2) return false;
    *b = key;
    return true;
  }

  __device__ __forceinline__ int item(int p, int s, float* w) const {
    *w = 1.f;
    return (2 * p + s) * C;
  }

  __device__ __forceinline__ float term(float, float x) const { return x; }
};

// The fill: in-range pair p = n*4 + j goes into the bucket of its start
// row. Blocks from `fill_blocks` on size the row groups instead.
__global__ void __launch_bounds__(kThreads) scatter_corners_fill_kernel(
    const int* __restrict__ idx4, const PairTerms terms, const fixed_sum::Scratch sc,
    long long pairs, long long G, int fill_blocks) {
  const int R = (int)terms.R;
  if ((int)blockIdx.x >= fill_blocks) {
    const long long g = (long long)(blockIdx.x - fill_blocks) * kThreads + threadIdx.x;
    if (g < G) fixed_sum::size_group(terms, sc, R, g);
    return;
  }
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int r = p < pairs ? __ldg(idx4 + p) : -1;
  const bool live = r >= 0 && r <= R - 2;
  const unsigned int active = __ballot_sync(0xffffffffu, live);
  if (live) fixed_sum::ids_at(sc, r, active) = (int)p;
}

int blocks_for(long long total) {
  // Enough blocks to fill the card several times over; the kernels loop
  // over whatever is left.
  const long long want = (total + kThreads - 1) / kThreads;
  return (int)(want < 132LL * 64 ? want : 132LL * 64);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ULL) == 0;
}

}  // namespace

extern "C" {

int corner_table(const float* grid, float* table, int Z, int Y, int X, int C,
                 void* stream) {
  const long long rows = (long long)Z * Y * X;
  if (rows <= 0 || C <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (C % 4 == 0 && aligned16(grid) && aligned16(table)) {
    const long long total = rows * 8 * (C / 4);
    corner_table_kernel<float4><<<blocks_for(total), kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(grid), reinterpret_cast<float4*>(table),
        total, Z, Y, X, C / 4);
  } else {
    const long long total = rows * 8 * C;
    corner_table_kernel<float><<<blocks_for(total), kThreads, 0, s>>>(
        grid, table, total, Z, Y, X, C);
  }
  return (int)cudaGetLastError();
}

int gather_rows(const float* table, const int* idx, float* out, int N, int R,
                int W, void* stream) {
  if (N <= 0 || W <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (W % 4 == 0 && aligned16(table) && aligned16(out)) {
    const long long total = (long long)N * (W / 4);
    gather_rows_kernel<float4><<<blocks_for(total), kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(table), idx,
        reinterpret_cast<float4*>(out), total, R, W / 4);
  } else {
    const long long total = (long long)N * W;
    gather_rows_kernel<float><<<blocks_for(total), kThreads, 0, s>>>(
        table, idx, out, total, R, W);
  }
  return (int)cudaGetLastError();
}

// int32 words of scatter_corners' scratch for R rows and N points.
int scatter_corners_scratch(int R, int N, int C) {
  return (int)fixed_sum::layout(R, 8LL * N, 4LL * N, C).total;
}

// `scratch` (scatter_corners_scratch ints, any contents) holds the counts,
// offsets and ids of the sum into `out`.
int scatter_corners(const int* idx4, const float* ct8, int* scratch,
                    float* out, int N, int R, int C, void* stream) {
  if (N <= 0 || C <= 0) return 0;
  const long long total = (long long)N * 8 * C;
  // Element offsets of ct8 rows, and counts, are int32.
  if (total >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long pairs = 4LL * N;
  const fixed_sum::Layout L = fixed_sum::layout(R, 8LL * N, pairs, C);
  const fixed_sum::Scratch sc = fixed_sum::carve(scratch, L);
  const cudaError_t e = fixed_sum::zero(scratch, L, s);
  if (e != cudaSuccess) return (int)e;
  const long long n4 = aligned16(ct8) ? total / 4 : 0;
  scatter_corners_count_kernel<<<fixed_sum::blocks(
                                     n4 > 0 ? n4 : total, fixed_sum::kBoundBlocks),
                                 kThreads, 0, s>>>(idx4, ct8, n4, total, pairs, R,
                                                   sc.B, sc.slot);
  const PairTerms terms{ct8, R, C};
  fixed_sum::scan(sc, R, s);
  const int fill_blocks = (int)((pairs + kThreads - 1) / kThreads);
  scatter_corners_fill_kernel<<<fill_blocks + fixed_sum::group_blocks(L), kThreads, 0, s>>>(
      idx4, terms, sc, pairs, L.G, fill_blocks);
  fixed_sum::row_sum(terms, sc, L, 8.0 * N, out, R, C, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
