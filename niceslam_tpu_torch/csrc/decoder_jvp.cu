// K6: one decoder MLP's value and T forward-mode tangents (the Gauss-Newton
// tracker's Jacobian of the render in its points), every layer kept on chip.
//
// It replaces no Pallas kernel: XLA fused the JAX package's decoders
// (niceslam_tpu/models/decoders.py) on the TPU. Under torch.func.jacfwd the
// port's plain MLP wrote every layer's [T, N, 32] tangent to device memory
// and read it back (~8 GB a linearization at N = 48,000, T = 6). Here a tile
// of points carries its value row and T tangent rows through all five
// layers in shared memory and registers, and only raw [N, O] and raw_dot
// [T, N, O] are written. The bound is fp32 FFMA: ~31 GFLOP for the three
// MLPs of one linearization, 0.47 ms at 67 TFLOP/s, against ~0.05 ms of
// bytes. Arithmetic is fp32 throughout (fmaf; no TF32, no lower precision).
//
// The MLP (models/decoders.py:_mlp_forward): e = sin(p @ B) (93 wide), five
// layers h = relu(h @ W_i + b_i) + (f @ F_i + c_i), cat(e, h) after layer 2,
// out = h @ Wo + bo. Tangents: e' = cos(p @ B) * (p' @ B); a dense layer
// without its bias; relu' = the value row's pre-activation > 0 (torch.relu's
// jvp rule); the feature term f' @ F_i. `det`, the fine decoder's detached
// middle feature, enters the value rows only (its tangent is zero).
//
// Design. One block per SM, persistent: it copies the MLP's weights once
// into shared memory (84 KB for the fine decoder), then each warp walks its
// own tiles of 8 slabs. A slab is 8 rows: one point's value and its T = 6
// tangents (7 rows used), or for T = 0 eight points' values. A launch takes
// 0 or 6 tangents, two instantiations of one template: the build stays
// short. Four lanes share a slab, each
// owning 8 of the 32 output columns, so a lane keeps its slab's rows x 8
// columns in registers (acc[R][8]) and each k step is 4 LDS.128 (two of
// activations, broadcast to the slab's lanes; two of weights) for R * 8
// FFMA. The ReLU mask of a tangent row comes from its value row in the
// same lane's registers. A layer's input and output share one buffer per
// slab (read, __syncwarp, write): only the slab's four lanes touch it. The
// Fourier embedding is written into that buffer 32 columns at a time for
// layers 0 and 3 (recomputed for the skip rather than stored). A warp loads
// its next tile's inputs into registers while it computes the current one
// (Staged). The value rows are computed by the same instructions whatever T
// is, so a launch with T tangents writes the same value bits as one with
// T = 0.
#include <cuda_runtime.h>

namespace {

constexpr int kE = 93;     // Fourier embedding width
constexpr int kH = 32;     // hidden width
constexpr int kC = 32;     // width of the feature that carries a tangent
constexpr int kT = 6;      // tangents of a launch: 0 (the value) or kT
constexpr int kWarps = 8;  // at most, per block
// Per-warp shared memory, in floats: the layer buffer and the feature rows
// ([2 halves][32 k][8 slabs][4 rows] each), then the points with their
// tangents (8 slabs x 24), then the detached feature's value rows.
constexpr int kBuf = 2 * 32 * 8 * 4;
constexpr int kPts = 8 * 24;

template <int T>
struct Geo {
  static constexpr int PS = 8 / (T + 1);  // points of a slab
  static constexpr int NR = T + 1;   // rows of a point
  static constexpr int R = PS * NR;  // rows of a slab in use, <= 8
};

// Offsets (floats) into the packed weights; ops/decoder_kernels.py:layout
// computes the same.
struct Layout {
  int W[5], b[5], F[5], c[5], Wo, bo, B, total;
};

__host__ __device__ inline Layout layout(int c_in, int O) {
  Layout L;
  int o = 0;
  for (int i = 0; i < 5; ++i) {
    const int k = i == 0 ? kE : (i == 3 ? kE + kH : kH);
    L.W[i] = o;
    o += k * kH;
    L.b[i] = o;
    o += kH;
  }
  for (int i = 0; i < 5; ++i) {
    L.F[i] = o;
    o += c_in * kH;
    L.c[i] = o;
    o += kH;
  }
  L.Wo = o;
  o += kH * O;
  L.bo = o;
  o += O;
  L.B = o;
  o += 3 * kE;
  L.total = o;
  return L;
}

__host__ __device__ constexpr int warp_floats(int PS, bool det) {
  return 2 * kBuf + kPts + (det ? 32 * 8 * PS : 0);
}

// A slab's row r at column k of a [2][32][8][4] buffer.
__device__ __forceinline__ int at(int r, int k, int slab) {
  return (r >> 2) * 1024 + k * 32 + slab * 4 + (r & 3);
}

// acc[r][c] += sum over K rows of the buffer (rows of the slab) times the
// weight rows W[k][8g .. 8g + 8).
template <int R>
__device__ __forceinline__ void mma(float (&acc)[R][8], const float* buf,
                                    const float* W, int K, int slab, int g) {
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const float4 lo = *reinterpret_cast<const float4*>(buf + k * 32 + slab * 4);
    const float4 hi =
        *reinterpret_cast<const float4*>(buf + 1024 + k * 32 + slab * 4);
    const float4 w0 = *reinterpret_cast<const float4*>(W + k * kH + g * 8);
    const float4 w1 = *reinterpret_cast<const float4*>(W + k * kH + g * 8 + 4);
    const float a[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], w[c], acc[r][c]);
  }
}

// The detached feature (value rows only): acc[value rows] += det @ W.
template <int T>
__device__ __forceinline__ void mma_det(float (&acc)[Geo<T>::R][8],
                                        const float* db, const float* W,
                                        int slab, int g) {
  constexpr int PS = Geo<T>::PS, NR = Geo<T>::NR;
#pragma unroll 2
  for (int k = 0; k < 32; ++k) {
    const float4 w0 = *reinterpret_cast<const float4*>(W + k * kH + g * 8);
    const float4 w1 = *reinterpret_cast<const float4*>(W + k * kH + g * 8 + 4);
    const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int q = 0; q < PS; ++q) {
      const float a = db[(k * 8 + slab) * PS + q];
#pragma unroll
      for (int c = 0; c < 8; ++c)
        acc[q * NR][c] = fmaf(a, w[c], acc[q * NR][c]);
    }
  }
}

// Embedding columns [k0, k0 + K) of the slab's rows into the buffer: the
// value row sin(p @ B), tangent row t cos(p @ B) * (p_t' @ B). Each of the
// slab's four lanes writes 8 columns.
template <int T>
__device__ __forceinline__ void embed(float* hb, const float* pb,
                                      const float* Bs, int k0, int K,
                                      int slab, int g) {
  constexpr int PS = Geo<T>::PS, NR = Geo<T>::NR;
  const float* ps = pb + slab * 24;
#pragma unroll 2  // 8 copies of sincosf's slow path double the build
  for (int j = 0; j < 8; ++j) {
    const int kk = g * 8 + j;
    if (kk < K) {
      const int k = k0 + kk;
      const float b0 = Bs[k], b1 = Bs[kE + k], b2 = Bs[2 * kE + k];
#pragma unroll
      for (int q = 0; q < PS; ++q) {
        const float* p = ps + q * 3;
        const float z = fmaf(p[2], b2, fmaf(p[1], b1, p[0] * b0));
        float sn, cs;
        sincosf(z, &sn, &cs);
        hb[at(q * NR, kk, slab)] = sn;
#pragma unroll
        for (int t = 1; t <= T; ++t) {
          const float* d = ps + (t * PS + q) * 3;
          const float zd = fmaf(d[2], b2, fmaf(d[1], b1, d[0] * b0));
          hb[at(q * NR + t, kk, slab)] = cs * zd;
        }
      }
    }
  }
}

// Bias and ReLU on the value rows (NaN stays NaN, as torch.relu), the value
// row's mask on its tangent rows, then the feature term's bias on the value
// rows.
template <int T>
__device__ __forceinline__ void relu_rows(float (&acc)[Geo<T>::R][8],
                                          const float* b, const float* cb,
                                          int g) {
  constexpr int PS = Geo<T>::PS, NR = Geo<T>::NR;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float bb = b[g * 8 + c], cc = cb[g * 8 + c];
#pragma unroll
    for (int q = 0; q < PS; ++q) {
      const float v = acc[q * NR][c] + bb;
      const bool m = v > 0.f;
      acc[q * NR][c] = (m ? v : (v != v ? v : 0.f)) + cc;
#pragma unroll
      for (int t = 1; t <= T; ++t)
        acc[q * NR + t][c] = m ? acc[q * NR + t][c] : 0.f;
    }
  }
}

template <int R>
__device__ __forceinline__ void zero(float (&acc)[R][8]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
}

template <int R>
__device__ __forceinline__ void store(const float (&acc)[R][8], float* hb,
                                      int slab, int g) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int k = g * 8 + c;
    float v[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) v[r] = r < R ? acc[r][c] : 0.f;
    *reinterpret_cast<float4*>(hb + k * 32 + slab * 4) =
        make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(hb + 1024 + k * 32 + slab * 4) =
        make_float4(v[4], v[5], v[6], v[7]);
  }
}

// A tile's inputs, loaded into registers one tile ahead: the points and
// their tangents (pb[slab][(t * PS + q) * 3 + d]), the feature rows (row
// r = q * NR + t of each slab, 16 bytes a load) and the detached feature's
// value rows; stash() writes them into the warp's shared buffers.
template <int T, bool DET>
struct Staged {
  static constexpr int PS = Geo<T>::PS, NR = Geo<T>::NR, R = Geo<T>::R;
  static constexpr int NP = (8 * R * 3 + 31) / 32, NF = 2 * R, ND = DET ? 2 * PS : 0;
  float p[NP];
  float4 f[NF];
  float4 d[ND > 0 ? ND : 1];

  __device__ __forceinline__ void fetch(long long base, const float* __restrict__ pts,
                                        const float* __restrict__ pts_dot,
                                        const float* __restrict__ feat,
                                        const float* __restrict__ feat_dot,
                                        const float* __restrict__ det, int N, int lane) {
#pragma unroll
    for (int u = 0; u < NP; ++u) {
      const int i = lane + 32 * u;
      const int s = i / (R * 3), rem = i - s * R * 3;
      const int j = rem / 3, dd = rem - j * 3;
      const int t = j / PS, q = j - t * PS;
      const long long n = base + s * PS + q;
      p[u] = 0.f;
      if (i < 8 * R * 3 && n < N)
        p[u] = t == 0 ? pts[n * 3 + dd] : pts_dot[((t - 1) * (long long)N + n) * 3 + dd];
    }
#pragma unroll
    for (int u = 0; u < NF; ++u) {
      const int i = lane + 32 * u;
      const int s = i / (R * 8), rem = i - s * R * 8;
      const int r = rem >> 3, k4 = (rem & 7) * 4;
      const int q = r / NR, t = r - q * NR;
      const long long n = base + s * PS + q;
      f[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n < N)
        f[u] = *reinterpret_cast<const float4*>(
            t == 0 ? feat + n * kC + k4 : feat_dot + ((t - 1) * (long long)N + n) * kC + k4);
    }
#pragma unroll
    for (int u = 0; u < ND; ++u) {
      const int i = lane + 32 * u;
      const int s = i / (PS * 8), rem = i - s * PS * 8;
      const int q = rem >> 3, k4 = (rem & 7) * 4;
      const long long n = base + s * PS + q;
      d[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n < N) d[u] = *reinterpret_cast<const float4*>(det + n * kC + k4);
    }
  }

  __device__ __forceinline__ void stash(float* pb, float* fb, float* db, int lane) const {
#pragma unroll
    for (int u = 0; u < NP; ++u) {
      const int i = lane + 32 * u;
      const int s = i / (R * 3), rem = i - s * R * 3;
      if (i < 8 * R * 3) pb[s * 24 + rem] = p[u];
    }
#pragma unroll
    for (int u = 0; u < NF; ++u) {
      const int i = lane + 32 * u;
      const int s = i / (R * 8), rem = i - s * R * 8;
      const int r = rem >> 3, k4 = (rem & 7) * 4;
      fb[at(r, k4, s)] = f[u].x;
      fb[at(r, k4 + 1, s)] = f[u].y;
      fb[at(r, k4 + 2, s)] = f[u].z;
      fb[at(r, k4 + 3, s)] = f[u].w;
    }
#pragma unroll
    for (int u = 0; u < ND; ++u) {
      const int i = lane + 32 * u;
      const int s = i / (PS * 8), rem = i - s * PS * 8;
      const int q = rem >> 3, k4 = (rem & 7) * 4;
      db[(k4 * 8 + s) * PS + q] = d[u].x;
      db[((k4 + 1) * 8 + s) * PS + q] = d[u].y;
      db[((k4 + 2) * 8 + s) * PS + q] = d[u].z;
      db[((k4 + 3) * 8 + s) * PS + q] = d[u].w;
    }
  }
};

template <int T, bool DET>
__global__ void __launch_bounds__(kWarps * 32, 1) decoder_jvp_kernel(
    const float* __restrict__ wts, const float* __restrict__ pts,
    const float* __restrict__ pts_dot, const float* __restrict__ feat,
    const float* __restrict__ feat_dot, const float* __restrict__ det,
    float* __restrict__ out, float* __restrict__ out_dot, int N, int O) {
  constexpr int PS = Geo<T>::PS, NR = Geo<T>::NR, R = Geo<T>::R;
  extern __shared__ __align__(16) float sm[];
  const Layout L = layout(DET ? 2 * kC : kC, O);
  // The weights, 16 bytes a load (the launcher checks the alignment).
  const int n4 = L.total >> 2;
#pragma unroll 4
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    reinterpret_cast<float4*>(sm)[i] = reinterpret_cast<const float4*>(wts)[i];
  for (int i = 4 * n4 + threadIdx.x; i < L.total; i += blockDim.x) sm[i] = wts[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slab = lane >> 2, g = lane & 3;
  float* hb = sm + ((L.total + 3) & ~3) + warp * warp_floats(PS, DET);
  float* fb = hb + kBuf;
  float* pb = fb + kBuf;
  float* db = pb + kPts;
  const float* Bs = sm + L.B;
  const int warps = blockDim.x >> 5;
  const long long n_tiles = ((long long)N + 8 * PS - 1) / (8 * PS);
  float acc[R][8];
  Staged<T, DET> st;
  if ((long long)blockIdx.x * warps + warp < n_tiles)
    st.fetch(((long long)blockIdx.x * warps + warp) * 8 * PS, pts, pts_dot, feat, feat_dot,
             det, N, lane);

  for (long long tile = (long long)blockIdx.x * warps + warp; tile < n_tiles;
       tile += (long long)gridDim.x * warps) {
    const long long base = tile * 8 * PS;
    st.stash(pb, fb, db, lane);
    __syncwarp();
    // The next tile's loads are in flight while this one is computed.
    const long long next = tile + (long long)gridDim.x * warps;
    if (next < n_tiles) st.fetch(next * 8 * PS, pts, pts_dot, feat, feat_dot, det, N, lane);

#pragma unroll 1
    for (int i = 0; i < 5; ++i) {
      const float* W = sm + L.W[i];
      zero(acc);
      if (i > 0) {  // h; for layer 3 the rows of W3 after the embedding's
        mma<R>(acc, hb, W + (i == 3 ? kE * kH : 0), kH, slab, g);
        __syncwarp();
      }
      if (i == 0 || i == 3) {  // the embedding, 32 columns at a time
#pragma unroll 1
        for (int k0 = 0; k0 < kE; k0 += 32) {
          const int K = kE - k0 < 32 ? kE - k0 : 32;
          embed<T>(hb, pb, Bs, k0, K, slab, g);
          __syncwarp();
          mma<R>(acc, hb, W + k0 * kH, K, slab, g);
          __syncwarp();
        }
      }
      relu_rows<T>(acc, sm + L.b[i], sm + L.c[i], g);
      mma<R>(acc, fb, sm + L.F[i], kC, slab, g);
      if (DET) mma_det<T>(acc, db, sm + L.F[i] + kC * kH, slab, g);
      store(acc, hb, slab, g);  // every lane's reads of hb ended at a __syncwarp
      __syncwarp();
    }

    // Output layer: the slab's R x O dot products over the four lanes.
    const float* Wo = sm + L.Wo;
    for (int idx = g; idx < R * O; idx += 4) {
      const int r = idx / O, o = idx - r * O;
      float s = 0.f;
#pragma unroll 8
      for (int k = 0; k < kH; ++k) s = fmaf(hb[at(r, k, slab)], Wo[k * O + o], s);
      const int q = r / NR, t = r - q * NR;
      const long long n = base + slab * PS + q;
      if (n < N) {
        if (t == 0)
          out[n * O + o] = s + sm[L.bo + o];
        else
          out_dot[((t - 1) * (long long)N + n) * O + o] = s;
      }
    }
    __syncwarp();
  }
}

constexpr int kMaxDevices = 16;

// The current device and its properties, queried once per device.
struct Props {
  int dev = 0, sms = 0, smem = 0;
};

cudaError_t props(Props* out) {
  static Props cache[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  Props& p = cache[dev];
  p.dev = dev;
  if (p.sms == 0) {
    e = cudaDeviceGetAttribute(&p.smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&p.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) {
      p.sms = 0;
      return e;
    }
  }
  *out = p;
  return cudaSuccess;
}

template <int T, bool DET>
int launch(const float* wts, const float* pts, const float* pts_dot,
           const float* feat, const float* feat_dot, const float* det,
           float* out, float* out_dot, int N, int O, cudaStream_t s) {
  constexpr int PS = Geo<T>::PS;
  const auto kernel = decoder_jvp_kernel<T, DET>;
  Props p;
  cudaError_t e = props(&p);
  if (e != cudaSuccess) return (int)e;
  const Layout L = layout(DET ? 2 * kC : kC, O);
  const long long wbytes = 4LL * ((L.total + 3) & ~3);
  const long long per_warp = 4LL * warp_floats(PS, DET);
  long long warps = (p.smem - wbytes) / per_warp;
  if (warps > kWarps) warps = kWarps;
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const long long smem = wbytes + warps * per_warp;
  // The attribute belongs to the device's context: set per instantiation
  // and device.
  static bool attr[kMaxDevices] = {};
  if (!attr[p.dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return (int)e;
    attr[p.dev] = true;
  }
  const long long tiles = ((long long)N + 8 * PS - 1) / (8 * PS);
  long long blocks = (tiles + warps - 1) / warps;
  if (blocks > p.sms) blocks = p.sms;
  kernel<<<(int)blocks, (int)warps * 32, (size_t)smem, s>>>(
      wts, pts, pts_dot, feat, feat_dot, det, out, out_dot, N, O);
  return (int)cudaGetLastError();
}

template <bool DET>
int dispatch(int T, const float* wts, const float* pts, const float* pts_dot,
             const float* feat, const float* feat_dot, const float* det,
             float* out, float* out_dot, int N, int O, cudaStream_t s) {
#define DECODER_JVP_CASE(t) \
  case t:                   \
    return launch<t, DET>(wts, pts, pts_dot, feat, feat_dot, det, out, out_dot, N, O, s);
  switch (T) {
    DECODER_JVP_CASE(0)
    DECODER_JVP_CASE(6)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DECODER_JVP_CASE
}

}  // namespace

extern "C" {

// Floats of the packed weights for a feature of c_in channels (32, or 64
// with the detached half) and O outputs.
int decoder_jvp_weights(int c_in, int O) { return layout(c_in, O).total; }

// raw [N, O] and, for T = 6, raw_dot [T, N, O] of the MLP packed in
// `wts` at pts [N, 3] with tangents pts_dot [T, N, 3], feature feat [N, 32]
// with tangents feat_dot [T, N, 32], and `det` [N, 32] (the detached half
// of a 64-channel feature) or null. wts, feat, feat_dot and det must be
// 16-byte aligned; anything else returns cudaErrorInvalidValue and launches
// nothing.
int decoder_jvp(const float* wts, const float* pts, const float* pts_dot,
                const float* feat, const float* feat_dot, const float* det,
                float* out, float* out_dot, int N, int T, int O,
                void* stream) {
  const auto aligned = [](const void* p) {
    return ((unsigned long long)p & 15ULL) == 0;
  };
  if (N < 0 || (T != 0 && T != kT) || O < 1 || O > 4 ||
      (long long)N * kT * kC >= (1LL << 40) || !aligned(wts) || !aligned(feat) ||
      (T > 0 && !aligned(feat_dot)) || (det != nullptr && !aligned(det)))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (det != nullptr)
    return dispatch<true>(T, wts, pts, pts_dot, feat, feat_dot, det, out, out_dot, N, O, s);
  return dispatch<false>(T, wts, pts, pts_dot, feat, feat_dot, det, out, out_dot, N, O, s);
}

}  // extern "C"
