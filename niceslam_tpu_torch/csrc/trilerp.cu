// Trilinear feature-grid sampler for Hopper (sm_90a): forward (K1) and
// fused backward (K2), with a plain C interface bound through ctypes by
// niceslam_tpu_torch/ops/trilerp_kernels.py.
//
// Conventions (shared with the plain PyTorch versions in trilerp_kernels.py
// and with the JAX reference's packed sampler, ops/trilinear.trilerp_packed):
//   grid  [R = Z*Y*X, C] float32, channel-last rows, row = (z*Y + y)*X + x
//   v     [N, 3] float32 voxel coordinates in (z, y, x) order
//   start = clamp(floor(v), 0, dim-2), weight = v - start
//   corner k = z1*4 + y1*2 + x1 reads row start + (z1, y1, x1)
//
// Both kernels compute each point's start and weights in registers (no
// host-side index or weight arrays).
//
// K1 trilerp_fwd replaces the TPU kernel trilerp_vmem / _trilerp_kernel
// (niceslam_tpu/ops/pallas_trilerp.py:180-258). With `dout` non-null it also
// writes the spatial derivative dV/dv [N, 3, C] (the axial differences of
// _trilerp_bwd_kernel, pallas_trilerp.py:363-373, before they meet the
// cotangent), which forward-mode differentiation needs.
// Design: a group of G lanes per point (G = 8 at C = 32: four points per
// warp). Where C % 4 == 0 and the rows and outputs are 16-byte aligned,
// lane j of the group holds channels 4j..4j+3 (and loops over further
// quads at C > 32), and each corner is one float4 load: a load instruction
// moves 512 B, where one warp per point moved 128 B. Otherwise a scalar
// variant of the same kernel holds single channels (up to 32 lanes per
// point). The wrapper picks the variant and G (trilerp_kernels.fwd_variant)
// and the entry point refuses a float4 variant that the pointers do not
// fit. The setup (coordinates, start, weights, one 64-bit base pointer)
// is done once per point, a warp instruction serving four points, and each
// lane loads its next point's coordinates before its current point's
// corners. Each block takes a contiguous run of points (a ray's samples, a
// lattice line of the mesher), so corners shared by neighbouring points
// are met in one SM's L1. The lerp of each channel keeps the expressions
// and the order of the earlier one-warp-per-point kernel: the same bits.
// Bound on an H100 at the main path's largest call (fine level, 38x24x53x32
// = 6.2 MB, N = 48,000 uniform points): counting each grid row that the
// points touch once, the coordinates (0.6 MB) and the output (6.1 MB) it
// moves ~13 MB, ~4 us at 3.35 TB/s; 21 flops per point and channel are far
// below the fp32 peak. Beyond that bound it reads 8 x 128 B of corner rows
// per point (49 MB per call) from L2 and L1 (the whole grid hierarchy,
// ~13 MB, fits the 50 MB L2). What bounds it in practice (H100, PERF.md):
// on uniform points the L2 gather of those rows; where L1 serves the
// corners (a ray's samples, the mesher's lattice), a floor of launch and
// instruction throughput, about what a call with every point in one voxel
// takes.
//
// K2 trilerp_bwd replaces trilerp_bwd_pallas / _trilerp_bwd_kernel
// (pallas_trilerp.py:334-438). It writes dgrid [R, C], the scatter of
// w8 (x) g, and dv [N, 3], the axial differences times g reduced over C
// with warp shuffles. The TPU kernel relied on grid steps running in order
// for a safe `+=`; blocks on the GPU run in no order. So dgrid is a
// row-owner reduction in int64 fixed point (fixed_sum.cuh): the same bits
// whatever order the points come in, with no atomics on data. A per-point
// pass (one warp per point, lane = channel) computes dv, the bound of the
// terms (max|pz| * max|py| * max|px| * |g|) and counts each point in the
// bucket of its start row; after the scan and the fill, the owner of grid
// row r = (z, y, x) walks the buckets of the up to 8 starts
// r - (z1*Y*X + y1*X + x1) with z >= z1, y >= y1, x >= x1 and adds corner
// (z1, y1, x1) of each point there, pz[z1] * py[y1] * px[x1] * g.
// Bound (fine level, N = 48,000): reads the grid (6.2 MB), coordinates and
// g (6.1 MB), writes dgrid (6.2 MB) and dv; ~19 MB at 3.35 TB/s = ~6 us.
// Beyond it: each g row is read again by up to 8 owners (from L2), plus
// the ~0.4 MB of counts, offsets and ids.
//
// Either output of K2 may be skipped by passing a null pointer; K1 skips the
// derivative the same way. Each entry point returns cudaGetLastError() after
// its launches; launches go on the caller's stream and never synchronize.

#include <cuda_runtime.h>

#include "fixed_sum.cuh"

namespace {

constexpr int kThreads = 256;            // K2: 8 warps = 8 points per block
constexpr int kPointsPerBlock = kThreads / 32;

struct PointCorners {
  long long r000;  // flat row of corner (0, 0, 0)
  long long sy;    // row stride of y
  long long sz;    // row stride of z
  float wz, wy, wx;
};

__device__ __forceinline__ int clampi(int a, int lo, int hi) {
  return a < lo ? lo : (a > hi ? hi : a);
}

__device__ __forceinline__ PointCorners point_corners(
    const float* __restrict__ v, long long n, int Z, int Y, int X) {
  const float vz = __ldg(v + 3 * n + 0);
  const float vy = __ldg(v + 3 * n + 1);
  const float vx = __ldg(v + 3 * n + 2);
  // floorf of a NaN converts to 0 and the clamp keeps every read in bounds.
  const int z0 = clampi((int)floorf(vz), 0, Z - 2);
  const int y0 = clampi((int)floorf(vy), 0, Y - 2);
  const int x0 = clampi((int)floorf(vx), 0, X - 2);
  PointCorners p;
  p.sy = X;
  p.sz = (long long)Y * X;
  p.r000 = (long long)z0 * p.sz + (long long)y0 * X + x0;
  p.wz = vz - (float)z0;
  p.wy = vy - (float)y0;
  p.wx = vx - (float)x0;
  return p;
}

struct Corners8 {
  float c000, c001, c010, c011, c100, c101, c110, c111;
};

__device__ __forceinline__ Corners8 load_corners(
    const float* __restrict__ grid, const PointCorners& p, int C, int c) {
  const float* g = grid + c;
  const long long r = p.r000;
  Corners8 k;
  k.c000 = __ldg(g + (r) * C);
  k.c001 = __ldg(g + (r + 1) * C);
  k.c010 = __ldg(g + (r + p.sy) * C);
  k.c011 = __ldg(g + (r + p.sy + 1) * C);
  k.c100 = __ldg(g + (r + p.sz) * C);
  k.c101 = __ldg(g + (r + p.sz + 1) * C);
  k.c110 = __ldg(g + (r + p.sz + p.sy) * C);
  k.c111 = __ldg(g + (r + p.sz + p.sy + 1) * C);
  return k;
}

// ------------------------------------------------------------------- K1
// A unit is what one lane loads from a corner row at a time: a float4 of
// four channels (the vector variant) or one channel (the scalar variant).
template <typename T>
struct Unit;

template <>
struct Unit<float> {
  static constexpr int kFloats = 1;
  __device__ static __forceinline__ float load(const float* p) { return __ldg(p); }
  __device__ static __forceinline__ float& at(float& u, int) { return u; }
};

template <>
struct Unit<float4> {
  static constexpr int kFloats = 4;
  __device__ static __forceinline__ float4 load(const float4* p) { return __ldg(p); }
  __device__ static __forceinline__ float& at(float4& u, int i) {
    return i == 0 ? u.x : (i == 1 ? u.y : (i == 2 ? u.z : u.w));
  }
};

// One channel of K1: the nested x -> y -> z lerp and, with kDeriv, its
// three axial derivatives, in the expressions and the order of the earlier
// one-warp-per-point kernel. The bits depend on how nvcc contracts them
// into FMAs, so the vector and scalar variants both run exactly this code
// on each channel.
template <bool kDeriv>
__device__ __forceinline__ void lerp_channel(
    float c000, float c001, float c010, float c011, float c100, float c101,
    float c110, float c111, float wz, float wy, float wx, float& o, float& dz,
    float& dy, float& dx) {
  const float c00 = c000 * (1 - wx) + c001 * wx;
  const float c01 = c010 * (1 - wx) + c011 * wx;
  const float c10 = c100 * (1 - wx) + c101 * wx;
  const float c11 = c110 * (1 - wx) + c111 * wx;
  const float c0 = c00 * (1 - wy) + c01 * wy;
  const float c1 = c10 * (1 - wy) + c11 * wy;
  o = c0 * (1 - wz) + c1 * wz;
  if (kDeriv) {
    dz = c1 - c0;
    dy = (c01 - c00) * (1 - wz) + (c11 - c10) * wz;
    const float dx0 = (c001 - c000) * (1 - wy) + (c011 - c010) * wy;
    const float dx1 = (c101 - c100) * (1 - wy) + (c111 - c110) * wy;
    dx = dx0 * (1 - wz) + dx1 * wz;
  }
}

constexpr int kFwdThreads = 256;  // K1's block, chosen on an H100 (PERF.md)

// Block b takes points [b * chunk, (b + 1) * chunk) in steps of
// blockDim.x >> shift points; lane j of a point's group of 1 << shift lanes
// takes units j, j + G, ... of each row (U units per row: kU where it is
// known when compiling, the main path's C = 32, so that the x + 1 corner is
// an immediate offset of the load). Each lane reads
// its point's coordinates itself (the group's lanes read one address, so a
// warp's load instruction serves 32 >> shift points) and those of its next
// point before this point's corners, so the two latencies overlap. The
// start row is int32 (R < 2^31), and the corners are one 64-bit base
// pointer plus the strides U, X*U and Y*X*U.
template <typename T, bool kDeriv, int kU>
__global__ void __launch_bounds__(kFwdThreads) trilerp_fwd_kernel(
    const T* __restrict__ grid, const float* __restrict__ v, T* __restrict__ out,
    T* __restrict__ dout, int N, int Z, int Y, int X, int units, int shift,
    int chunk) {
  using Un = Unit<T>;
  const int U = kU ? kU : units;
  const int G = 1 << shift;
  const int j = threadIdx.x & (G - 1);
  const int step = blockDim.x >> shift;
  const long long last = (long long)(blockIdx.x + 1) * chunk;
  const int end = last < N ? (int)last : N;
  const long long sy = (long long)X * U, sz = (long long)Y * X * U;
  int n = blockIdx.x * chunk + (threadIdx.x >> shift);
  float vz = 0.f, vy = 0.f, vx = 0.f;
  if (n < end) {
    vz = __ldg(v + 3LL * n);
    vy = __ldg(v + 3LL * n + 1);
    vx = __ldg(v + 3LL * n + 2);
  }
  for (; n < end; n += step) {
    const int m = n + step;
    float mz = 0.f, my = 0.f, mx = 0.f;
    if (m < end) {
      mz = __ldg(v + 3LL * m);
      my = __ldg(v + 3LL * m + 1);
      mx = __ldg(v + 3LL * m + 2);
    }
    // floorf of a NaN converts to 0 and the clamp keeps every read in bounds.
    const int z0 = clampi((int)floorf(vz), 0, Z - 2);
    const int y0 = clampi((int)floorf(vy), 0, Y - 2);
    const int x0 = clampi((int)floorf(vx), 0, X - 2);
    const float wz = vz - (float)z0, wy = vy - (float)y0, wx = vx - (float)x0;
    const T* b = grid + (long long)((z0 * Y + y0) * X + x0) * U;
    T* o = out + (long long)n * U;
    T* d = kDeriv ? dout + 3LL * n * U : nullptr;
    for (int q = j; q < U; q += G) {
      const T* p = b + q;
      // Corner k = z1*4 + y1*2 + x1, all eight loads in flight at once.
      T k[8] = {Un::load(p), Un::load(p + U), Un::load(p + sy),
                Un::load(p + sy + U), Un::load(p + sz), Un::load(p + sz + U),
                Un::load(p + sz + sy), Un::load(p + sz + sy + U)};
      T r, rz, ry, rx;
#pragma unroll
      for (int i = 0; i < Un::kFloats; ++i) {
        lerp_channel<kDeriv>(
            Un::at(k[0], i), Un::at(k[1], i), Un::at(k[2], i), Un::at(k[3], i),
            Un::at(k[4], i), Un::at(k[5], i), Un::at(k[6], i), Un::at(k[7], i),
            wz, wy, wx, Un::at(r, i), Un::at(rz, i), Un::at(ry, i), Un::at(rx, i));
      }
      o[q] = r;
      if (kDeriv) {
        d[q] = rz;
        d[U + q] = ry;
        d[2 * U + q] = rx;
      }
    }
    vz = mz;
    vy = my;
    vx = mx;
  }
}

template <typename T, int kU = 0>
int launch_fwd(const float* grid, const float* v, float* out, float* dout,
               int N, int Z, int Y, int X, int C, int shift, cudaStream_t s) {
  const bool deriv = dout != nullptr;
  const auto kernel = deriv ? trilerp_fwd_kernel<T, true, kU>
                            : trilerp_fwd_kernel<T, false, kU>;
  // Blocks resident on the card (one model of card per process), queried
  // once per kernel.
  static int resident[2] = {};
  int& cap = resident[deriv];
  if (cap == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kFwdThreads, 0);
    if (e != cudaSuccess) return (int)e;
    cap = per_sm * sms > 0 ? per_sm * sms : 1;
  }
  // Each block takes `steps` steps of `step` consecutive points: as few
  // steps as fill the resident blocks once.
  const int step = kFwdThreads >> shift;
  const long long tiles = (N + (long long)step - 1) / step;
  const long long steps = (tiles + cap - 1) / cap;
  const long long chunk = steps * step;
  const int blocks = (int)((N + chunk - 1) / chunk);
  constexpr int kFloats = sizeof(T) / sizeof(float);
  kernel<<<blocks, kFwdThreads, 0, s>>>(
      reinterpret_cast<const T*>(grid), v, reinterpret_cast<T*>(out),
      reinterpret_cast<T*>(dout), N, Z, Y, X, C / kFloats, shift, (int)chunk);
  return (int)cudaGetLastError();
}

// The per-point pass: dv; with `counts` non-null also the bucket count of
// the point's start row and the bound of the dgrid terms, max over points
// and channels of max|pz| * max|py| * max|px| * |g|, which bounds every
// |w8[k] * g| (a weight leaves [0, 1] where a point lies outside the grid;
// rounding is monotonic, so the float products keep the bound).
__global__ void __launch_bounds__(kThreads) trilerp_bwd_points_kernel(
    const float* __restrict__ grid, const float* __restrict__ v,
    const float* __restrict__ gout, int* __restrict__ counts,
    unsigned int* slot, float* __restrict__ dv, int N, int Z, int Y, int X,
    int C) {
  const long long n =
      (long long)blockIdx.x * kPointsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  float m = 0.f;
  bool finite = true;
  if (n < N) {  // uniform per warp: the shuffles below see 32 lanes
    const PointCorners p = point_corners(v, n, Z, Y, X);
    const float wx = p.wx, wy = p.wy, wz = p.wz;
    const float wmax = fmaxf(fabsf(1 - p.wz), fabsf(p.wz)) *
                       fmaxf(fabsf(1 - p.wy), fabsf(p.wy)) *
                       fmaxf(fabsf(1 - p.wx), fabsf(p.wx));
    if (counts != nullptr && lane == 0) atomicAdd(counts + p.r000, 1);
    float az = 0.f, ay = 0.f, ax = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float g = __ldg(gout + n * C + c);
      if (counts != nullptr) {
        const float a = wmax * fabsf(g);
        finite &= a <= fixed_sum::kFloatMax;
        m = fmaxf(m, a);
      }
      if (dv != nullptr) {
        const Corners8 k = load_corners(grid, p, C, c);
        const float c00 = k.c000 * (1 - wx) + k.c001 * wx;
        const float c01 = k.c010 * (1 - wx) + k.c011 * wx;
        const float c10 = k.c100 * (1 - wx) + k.c101 * wx;
        const float c11 = k.c110 * (1 - wx) + k.c111 * wx;
        const float c0 = c00 * (1 - wy) + c01 * wy;
        const float c1 = c10 * (1 - wy) + c11 * wy;
        const float dx0 = (k.c001 - k.c000) * (1 - wy) + (k.c011 - k.c010) * wy;
        const float dx1 = (k.c101 - k.c100) * (1 - wy) + (k.c111 - k.c110) * wy;
        az += (c1 - c0) * g;
        ay += ((c01 - c00) * (1 - wz) + (c11 - c10) * wz) * g;
        ax += (dx0 * (1 - wz) + dx1 * wz) * g;
      }
    }
    if (dv != nullptr) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        az += __shfl_xor_sync(0xffffffffu, az, off);
        ay += __shfl_xor_sync(0xffffffffu, ay, off);
        ax += __shfl_xor_sync(0xffffffffu, ax, off);
      }
      if (lane == 0) {
        dv[3 * n + 0] = az;
        dv[3 * n + 1] = ay;
        dv[3 * n + 2] = ax;
      }
    }
  }
  if (counts != nullptr) fixed_sum::block_max_into(m, finite, slot);
}

// dgrid's terms for the row owners (fixed_sum::row_sum_kernel): source
// k = z1*4 + y1*2 + x1 of row r is the bucket of start r - (z1, y1, x1),
// and an entry n there adds pz[z1] * py[y1] * px[x1] * g[n].
struct CornerTerms {
  static constexpr int kSources = 8;
  const float* values;  // g [N, C]
  const float* v;
  int Z, Y, X, C;

  __device__ __forceinline__ long long offset(int k) const {
    return (long long)(k >> 2) * Y * X + (long long)((k >> 1) & 1) * X + (k & 1);
  }

  // Buckets [lo, hi) that source k of rows [r0, r1) can read; those the
  // z >= z1, y >= y1, x >= x1 rule skips hold no start (one of their
  // coordinates is dim - 1), so the range's entries are the rows' entries.
  __device__ __forceinline__ void bucket_range(long long r0, long long r1, int k,
                                               long long R, long long* lo,
                                               long long* hi) const {
    const long long o = offset(k);
    *lo = r0 - o > 0 ? r0 - o : 0;
    *hi = r1 - o < R ? r1 - o : R;
  }

  __device__ __forceinline__ bool source(long long r, int k,
                                         long long* b) const {
    const int z1 = k >> 2, y1 = (k >> 1) & 1, x1 = k & 1;
    const int ri = (int)r, zy = ri / X;  // rows fit int32 (R < 2^31)
    const int x = ri - zy * X, z = zy / Y, y = zy - z * Y;
    if (z < z1 || y < y1 || x < x1) return false;
    *b = r - offset(k);
    return true;
  }

  __device__ __forceinline__ int item(int n, int k, float* w) const {
    const PointCorners p = point_corners(v, n, Z, Y, X);
    const float pz = (k >> 2) ? p.wz : 1 - p.wz;
    const float py = ((k >> 1) & 1) ? p.wy : 1 - p.wy;
    const float px = (k & 1) ? p.wx : 1 - p.wx;
    *w = pz * py * px;
    return n * C;
  }

  __device__ __forceinline__ float term(float w, float g) const {
    return w * g;
  }
};

// The fill: point n goes into the bucket of its start row. Blocks from
// `fill_blocks` on size the row groups instead.
__global__ void __launch_bounds__(kThreads) trilerp_bwd_fill_kernel(
    const CornerTerms terms, const fixed_sum::Scratch sc, int N, long long R,
    long long G, int fill_blocks) {
  if ((int)blockIdx.x >= fill_blocks) {
    const long long g = (long long)(blockIdx.x - fill_blocks) * kThreads + threadIdx.x;
    if (g < G) fixed_sum::size_group(terms, sc, R, g);
    return;
  }
  const long long n = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool live = n < N;
  const int key = live ? (int)point_corners(terms.v, n, terms.Z, terms.Y, terms.X).r000 : 0;
  const unsigned int active = __ballot_sync(0xffffffffu, live);
  if (live) fixed_sum::ids_at(sc, key, active) = (int)n;
}

int blocks_for(int N) { return (N + kPointsPerBlock - 1) / kPointsPerBlock; }

}  // namespace

extern "C" {

// K1 with the variant the caller chose (trilerp_kernels.fwd_variant, the
// one place of the rule): `vec` non-zero for the float4 kernel, which
// needs C % 4 == 0 and grid, out and dout (if any) 16-byte aligned, else
// the float kernel; G lanes per point, a power of two up to 32. Anything
// else returns cudaErrorInvalidValue and launches nothing.
int trilerp_fwd(const float* grid, const float* v, float* out, float* dout,
                int N, int Z, int Y, int X, int C, int vec, int G,
                void* stream) {
  if (N <= 0) return 0;
  const auto aligned = [](const void* p) {
    return ((unsigned long long)p & 15ULL) == 0;
  };
  int shift = 0;
  while (shift < 5 && (1 << shift) < G) ++shift;
  if ((1 << shift) != G || (long long)Z * Y * X >= (1LL << 31) ||
      N > (1 << 30) ||
      (vec && !(C % 4 == 0 && aligned(grid) && aligned(out) &&
                (dout == nullptr || aligned(dout)))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (!vec)
    return launch_fwd<float>(grid, v, out, dout, N, Z, Y, X, C, shift, s);
  if (C == 32)
    return launch_fwd<float4, 8>(grid, v, out, dout, N, Z, Y, X, C, shift, s);
  return launch_fwd<float4>(grid, v, out, dout, N, Z, Y, X, C, shift, s);
}

// int32 words of trilerp_bwd's scratch for a grid of R rows and N points.
int trilerp_bwd_scratch(int R, int N, int C) {
  return (int)fixed_sum::layout(R, 8LL * N, N, C).total;
}

// `scratch` (trilerp_bwd_scratch ints, any contents) holds dgrid's counts,
// offsets and ids; it and dgrid are null when dgrid is skipped.
int trilerp_bwd(const float* grid, const float* v, const float* gout,
                int* scratch, float* dgrid, float* dv, int N, int Z, int Y,
                int X, int C, void* stream) {
  if (N <= 0) return 0;
  // Element offsets of g rows, and counts, are int32.
  if ((long long)N * 8 * C >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long R = (long long)Z * Y * X;
  const fixed_sum::Layout L = fixed_sum::layout(R, 8LL * N, N, C);
  fixed_sum::Scratch sc{};
  if (dgrid != nullptr) {
    sc = fixed_sum::carve(scratch, L);
    const cudaError_t e = fixed_sum::zero(scratch, L, s);
    if (e != cudaSuccess) return (int)e;
  }
  trilerp_bwd_points_kernel<<<blocks_for(N), kThreads, 0, s>>>(
      grid, v, gout, dgrid != nullptr ? sc.B : nullptr, sc.slot, dv, N, Z, Y,
      X, C);
  if (dgrid != nullptr) {
    const CornerTerms terms{gout, v, Z, Y, X, C};
    fixed_sum::scan(sc, R, s);
    const int fill_blocks = (N + kThreads - 1) / kThreads;
    trilerp_bwd_fill_kernel<<<fill_blocks + fixed_sum::group_blocks(L), kThreads, 0, s>>>(
        terms, sc, N, R, L.G, fill_blocks);
    fixed_sum::row_sum(terms, sc, L, 8.0 * N, dgrid, R, C, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
