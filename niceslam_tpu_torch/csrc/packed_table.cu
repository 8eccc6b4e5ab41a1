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
// GPU run in no order, so each thread adds one value with a 64-bit integer
// atomicAdd into a fixed-point accumulator (fixed_sum.cuh), which the caller
// zero-fills: the sum is the same bit for bit whatever order the atomics
// land in, as for K2 in trilerp.cu. A bound pass over |ct8| comes first and
// a pass that converts the accumulator into `out` last. A pair (rows r and
// r+1, 2C contiguous floats) receives the 2C contiguous floats
// ct8[n, 2j:2j+2, :], so the reads and the atomics of a warp fall on
// contiguous addresses.
// Bound (fine level, N = 48,000): reads ct8 (49.2 MB) and idx4 (0.8 MB),
// writes the grid (6.2 MB): 56.1 MB at 3.35 TB/s = 16.8 us. (The bound pass
// reads ct8 a second time, and the accumulator is twice the grid's size.)
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

__global__ void __launch_bounds__(kThreads) scatter_corners_kernel(
    const int* __restrict__ idx4, const float* __restrict__ ct8,
    unsigned long long* __restrict__ acc, long long total, int R, int C) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int pair = 2 * C;
  // The accumulator's two slots follow its R*C entries; at most one value
  // per point and corner lands on an entry.
  unsigned int* slot = reinterpret_cast<unsigned int*>(acc + (long long)R * C);
  const double scale = fixed_sum::scale_of(slot, (double)(total / C));
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long n = t / (4 * pair);
    const int rem = (int)(t - n * 4 * pair);
    const int j = rem / pair;  // pair j = z1*2 + y1: corners k = 2j, 2j + 1
    const int off = rem - j * pair;
    const int r = __ldg(idx4 + 4 * n + j);
    if (r < 0 || r > R - 2) continue;
    fixed_sum::add(acc + (long long)r * C + off, __ldg(ct8 + t), scale, slot);
  }
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

// `acc` (int64, R*C entries and then the two slots, all zero) is the
// fixed-point accumulator of `out`.
int scatter_corners(const int* idx4, const float* ct8, unsigned long long* acc,
                    float* out, int N, int R, int C, void* stream) {
  if (N <= 0 || C <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const long long total = (long long)N * 8 * C;
  const long long entries = (long long)R * C;
  fixed_sum::absmax_kernel<<<fixed_sum::blocks(total, fixed_sum::kBoundBlocks),
                             fixed_sum::kBoundThreads, 0, s>>>(
      ct8, total, reinterpret_cast<unsigned int*>(acc + entries));
  scatter_corners_kernel<<<blocks_for(total), kThreads, 0, s>>>(
      idx4, ct8, acc, total, R, C);
  fixed_sum::finish(acc, out, entries, 8.0 * N, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
