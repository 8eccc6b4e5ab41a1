// Order-independent sums for the sampler's grid gradients (K2 in trilerp.cu,
// K5 in packed_table.cu): row-owner reductions in int64 fixed point.
//
// Every term is added as an int64 fixed-point number. Integer addition does
// not depend on order, so a gradient is the same bit for bit whatever order
// the points come in and however the work is split, and the same inputs give
// the same gradient on every run. (With fp32 atomics they did not: the order
// of the additions changed from run to run, and the 1500 Adam iterations of
// the first frame's map carried that rounding into maps, and trajectories,
// that differed from run to run on one seed.)
//
// Each contribution has a key, the grid row that locates it: K2's is the
// point's start row, K5's the start row of an x-pair. A gradient is one
// memset and four launches on the caller's stream, from one C entry point:
//   1. count + bound (in the caller's .cu, fused with its own per-point
//      work): count[key] += 1 with int32 atomics, exact in any order; the
//      largest |term| goes into slot[0] (as float bits: non-negative floats
//      order like their bits, so an integer atomicMax on the bits is exact),
//      and a non-finite value sets slot[1];
//   2. scan_kernel: the counts become bucket offsets (an exclusive prefix
//      sum, one pass, tiles chained by decoupled look-back);
//   3. fill (in the caller's .cu): each contribution writes its id at
//      B[key] + atomicAdd(&cursor[key], 1), so bucket b is [B[b], B[b+1]);
//      the order inside a bucket varies from run to run and does not matter.
//      The same launch sizes the row groups (size_group): grid rows form
//      groups of kGroupRows, and a group's owner blocks get kItemsPerBlock
//      of its entries each, so a group of hot rows (rays converge at the
//      camera, surface samples crowd) is split across as many blocks as it
//      needs;
//   4. row_sum_kernel: every grid row is summed by its owners, which walk
//      the buckets feeding it (`Terms::source`, the inverse of the scatter),
//      quantize each term as llrint(t * 2^e) into int64 registers, and
//      write the row once: out = sum * 2^-e as float, or NaN everywhere when
//      slot[1] is set.
// e = 62 - ceil(log2(terms * max)), so no sum of at most `terms` values
// leaves (-2^63, 2^63). No accumulator the size of the grid is formed and no
// 64-bit atomic is taken; the int32 scratch (`Layout`) holds the scan's tile
// words, counters, the two slots, the R + 1 bucket bounds and R cursors, the
// ids, the groups' block assignments and the int64 partial sums of rows that
// span blocks.
//
// Precision: the step 2^-e is at most 2 * terms * max * 2^-62; at 8 x 48,000
// terms (the mapping batch) that is 1.7e-13 of the largest value, and each
// sum is off by at most half a step per value added. Entries larger than
// ~3e-6 of the largest value keep at least fp32's 24 significant bits.
//
// The plain model of the whole sum, bit for bit, and of the row-owner
// enumeration is niceslam_tpu_torch/ops/fixed_point.py.

#pragma once

#include <cuda_runtime.h>

namespace fixed_sum {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBoundBlocks = 132 * 8;  // grid-stride: one atomicMax per block
constexpr unsigned int kFull = 0xffffffffu;
constexpr float kFloatMax = 3.402823466e38f;

// ------------------------------------------------------------- scratch
constexpr int kScanItems = 16;  // counts per scan thread
constexpr int kScanTile = kThreads * kScanItems;
constexpr int kGroupRows = 32;        // grid rows per group
constexpr int kItemsPerBlock = 512;   // entries per owner block, at most

// Offsets, in int32 words, of the scratch of a sum into R rows of C
// channels from at most `n_terms` terms (8 per point) and `n_ids` keyed
// contributions. The first `zeroed` words are zeroed by one memset.
struct Layout {
  long long G;        // row groups, each with its first owner block
  long long helpers;  // further owner blocks launched: at least those assigned
  long long slots;    // partial-sum slot pairs: at least those assigned
  long long status, done, B, cur, zeroed, HB, NB, PB, owner, ids, part, total;
};

inline Layout layout(long long R, long long n_terms, long long n_ids, int C) {
  Layout L;
  L.G = (R + kGroupRows - 1) / kGroupRows;
  const long long extra = (n_terms + kItemsPerBlock - 1) / kItemsPerBlock;
  L.helpers = extra;    // sum over groups of ceil(W / kItems) - 1
  L.slots = 2 * extra;  // groups of more than one block: nb < 2W / kItems
  L.status = 8;            // after the counters: 64-bit aligned
  L.done = L.status + 2 * ((R + kScanTile) / kScanTile);  // R + 1 counts
  L.B = (L.done + L.G + 3) & ~3LL;  // 16-byte aligned
  L.cur = L.B + R + 1;
  L.zeroed = L.cur + R;
  L.HB = L.zeroed;
  L.NB = L.HB + L.G;
  L.PB = L.NB + L.G;
  L.owner = L.PB + L.G;
  L.ids = L.owner + L.helpers;
  L.part = (L.ids + n_ids + 1) & ~1LL;  // int64 [slots][2][C]
  L.total = L.part + 2 * L.slots * 2 * C;
  return L;
}

struct Scratch {
  unsigned int* tile_counter;   // hands out scan tiles in launch order
  unsigned int* slot;           // [0] bound as float bits, [1] non-finite flag
  int* helper_counter;          // further owner blocks assigned
  int* slot_counter;            // partial-sum slots assigned
  unsigned long long* status;   // per scan tile: flag << 32 | value
  int* done;                    // per group: owner blocks finished
  int* B;                       // R + 1: the counts, then the bucket starts
  int* cur;                     // R cursors of the fill
  int* HB;                      // per group: its first further block
  int* NB;                      // per group: its owner blocks
  int* PB;                      // per group: its first partial-sum slot
  int* owner;                   // per further block: its group
  int* ids;                     // contributions, grouped by bucket
  long long* part;              // partial sums of rows that span blocks
};

inline Scratch carve(int* base, const Layout& L) {
  Scratch s;
  s.tile_counter = reinterpret_cast<unsigned int*>(base);
  s.slot = reinterpret_cast<unsigned int*>(base + 1);
  s.helper_counter = base + 3;
  s.slot_counter = base + 4;
  s.status = reinterpret_cast<unsigned long long*>(base + L.status);
  s.done = base + L.done;
  s.B = base + L.B;
  s.cur = base + L.cur;
  s.HB = base + L.HB;
  s.NB = base + L.NB;
  s.PB = base + L.PB;
  s.owner = base + L.owner;
  s.ids = base + L.ids;
  s.part = reinterpret_cast<long long*>(base + L.part);
  return s;
}

inline cudaError_t zero(int* base, const Layout& L, cudaStream_t s) {
  return cudaMemsetAsync(base, 0, L.zeroed * sizeof(int), s);
}

// Blocks of kThreads for a grid-stride pass over n entries, at most cap.
inline int blocks(long long n, long long cap) {
  const long long want = (n + kThreads - 1) / kThreads;
  return (int)(want < cap ? want : cap);
}

// This lane's place in bucket `key`, from offsets[key] + atomicAdd: one
// atomic per distinct key among the lanes of `active` (a hot bucket takes
// a whole warp's entries at once).
__device__ __forceinline__ int claim(int* offsets, int key, unsigned int active) {
  const int lane = threadIdx.x & 31;
  const unsigned int peers = __match_any_sync(active, key);
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(offsets + key, __popc(peers));
  return __shfl_sync(peers, base, leader) + __popc(peers & ((1u << lane) - 1));
}

// The fill's slot for a contribution in bucket `key`.
__device__ __forceinline__ int& ids_at(const Scratch& sc, int key, unsigned int active) {
  return sc.ids[sc.B[key] + claim(sc.cur, key, active)];
}

// --------------------------------------------------------------- bound
// Block-wide max of the threads' non-negative `m` into slot[0]; a thread
// that saw a non-finite value (`finite` false) sets slot[1]. Every thread of
// the block must call it.
__device__ __forceinline__ void block_max_into(float m, bool finite,
                                               unsigned int* slot) {
  __shared__ float warp_max[kWarps];
  if (!finite) atomicOr(slot + 1, 1u);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < (int)(blockDim.x >> 5) ? warp_max[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    // Only a block that can raise the bound takes the atomic.
    if (lane == 0 && m > __uint_as_float(*(volatile unsigned int*)slot))
      atomicMax(slot, __float_as_uint(m));
  }
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

// ---------------------------------------------------------------- scan
// Exclusive scan of one int per thread over the block; *total gets the sum.
// `s_warp` ([kWarps] shared ints) may be reused after a __syncthreads().
__device__ __forceinline__ int block_exclusive_scan(int x, int* total,
                                                    int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int s = s_warp[w];
    before += w < warp ? s : 0;
    all += s;
  }
  *total = all;
  return before + incl - x;
}

constexpr unsigned long long kAggregate = 1ULL << 32;  // the tile's own sum
constexpr unsigned long long kInclusive = 2ULL << 32;  // sum of tiles 0..t
constexpr unsigned int kMaxSpins = 1u << 22;

__device__ __forceinline__ void publish(unsigned long long* w,
                                        unsigned long long flag, int value) {
  *reinterpret_cast<volatile unsigned long long*>(w) =
      flag | (unsigned int)value;
}

// Warp 0 of tile `tile` > 0: publishes the tile's aggregate and returns the
// sum of all earlier tiles, reading 32 predecessors at a time back to the
// nearest one that has published its inclusive sum. Tile numbers are handed
// out in the order blocks start, so every predecessor is running or done
// and the wait ends; were it ever to last kMaxSpins reads, slot[1] is set
// and the gradient comes out as NaN instead of hanging the card.
__device__ __forceinline__ int look_back(unsigned long long* status,
                                         long long tile, int aggregate,
                                         unsigned int* slot) {
  const int lane = threadIdx.x & 31;
  if (lane == 0) publish(status + tile, kAggregate, aggregate);
  int prefix = 0;
  long long end = tile;  // this round reads tiles [end - 32, end)
  unsigned int spins = 0;
  while (true) {
    const long long i = end - 1 - lane;  // lane 0: the nearest predecessor
    unsigned long long w = kInclusive;  // before tile 0: a sum of nothing
    if (i >= 0) w = *reinterpret_cast<volatile unsigned long long*>(status + i);
    const unsigned long long flag = w & ~0xffffffffULL;
    if (__any_sync(kFull, flag == 0)) {
      if (++spins == kMaxSpins) {
        if (lane == 0) atomicOr(slot + 1, 1u);
        return prefix;
      }
      continue;
    }
    const unsigned int incl = __ballot_sync(kFull, flag == kInclusive);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    int x = lane <= stop ? (int)(unsigned int)w : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_xor_sync(kFull, x, off);
    prefix += x;
    if (incl) return prefix;
    end -= 32;
  }
}

// In place: counts[0..R) -> their exclusive prefix sums. One block per tile
// of kScanTile counts, 16 per thread (four 16-byte loads); `counts` is
// 16-byte aligned (carve).
__global__ void __launch_bounds__(kThreads) scan_kernel(
    int* __restrict__ counts, long long R, unsigned long long* status,
    unsigned int* tile_counter, unsigned int* slot) {
  __shared__ int s_warp[kWarps];
  __shared__ int s_tile;
  __shared__ int s_prefix;
  if (threadIdx.x == 0) s_tile = (int)atomicAdd(tile_counter, 1u);
  __syncthreads();
  const long long tile = s_tile;
  const long long base = tile * kScanTile + (long long)threadIdx.x * kScanItems;
  const bool whole = base + kScanItems <= R;
  int v[kScanItems];
  if (whole) {
    const int4* p = reinterpret_cast<const int4*>(counts + base);
#pragma unroll
    for (int q = 0; q < kScanItems / 4; ++q) {
      const int4 x = p[q];
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kScanItems; ++k)
      v[k] = base + k < R ? counts[base + k] : 0;
  }
  int sum = 0;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    const int x = v[k];
    v[k] = sum;
    sum += x;
  }
  int aggregate;
  const int before = block_exclusive_scan(sum, &aggregate, s_warp);
  if (threadIdx.x < 32) {
    const int prefix =
        tile == 0 ? 0 : look_back(status, tile, aggregate, slot);
    if (threadIdx.x == 0) {
      publish(status + tile, kInclusive, prefix + aggregate);
      s_prefix = prefix;
    }
  }
  __syncthreads();
  const int off = s_prefix + before;
  if (whole) {
    int4* p = reinterpret_cast<int4*>(counts + base);
#pragma unroll
    for (int q = 0; q < kScanItems / 4; ++q)
      p[q] = make_int4(v[4 * q] + off, v[4 * q + 1] + off, v[4 * q + 2] + off,
                       v[4 * q + 3] + off);
  } else {
#pragma unroll
    for (int k = 0; k < kScanItems; ++k)
      if (base + k < R) counts[base + k] = v[k] + off;
  }
}

// The bucket starts of R buckets, from their counts in B[0..R) (B[R] = 0
// becomes the total).
inline void scan(const Scratch& sc, long long R, cudaStream_t s) {
  scan_kernel<<<(unsigned int)((R + kScanTile) / kScanTile), kThreads, 0, s>>>(
      sc.B, R + 1, sc.status, sc.tile_counter, sc.slot);
}

// -------------------------------------------------------------- row sum
// Sizes group g (its entries, from the bucket bounds of the source ranges,
// `Terms::bucket_range`): nb = max(1, ceil(W / kItemsPerBlock)) owner
// blocks, its own first block and nb - 1 further ones, and slots for
// partial sums if nb > 1. The order of the assignments varies from run to
// run; the sums do not. The fill's launch runs it, one thread per group,
// in blocks after the fill's own.
template <class Terms>
__device__ __forceinline__ void size_group(const Terms& terms, const Scratch& sc,
                                           long long R, long long g) {
  const long long r0 = g * kGroupRows;
  const long long r1 = r0 + kGroupRows < R ? r0 + kGroupRows : R;
  int W = 0;
#pragma unroll
  for (int s = 0; s < Terms::kSources; ++s) {
    long long lo, hi;
    terms.bucket_range(r0, r1, s, R, &lo, &hi);
    if (hi > lo) W += sc.B[hi] - sc.B[lo];
  }
  const int nb = W > kItemsPerBlock ? (W + kItemsPerBlock - 1) / kItemsPerBlock : 1;
  sc.NB[g] = nb;
  if (nb == 1) return;
  const int base = atomicAdd(sc.helper_counter, nb - 1);
  sc.HB[g] = base;
  sc.PB[g] = atomicAdd(sc.slot_counter, nb);
  for (int p = 1; p < nb; ++p) sc.owner[base + p - 1] = (int)g;
}

// Blocks of the fill's launch that size the groups.
inline unsigned int group_blocks(const Layout& L) {
  return (unsigned int)((L.G + kThreads - 1) / kThreads);
}

// The fixed-point number of term t: llrint(t * 2^e). With 2^e a normal
// float the product in float is exact (a power-of-two scaling of a float
// whose result stays above the normal range, or rounds to 0 anyway), so
// one float-to-int64 conversion gives the same bits as the double path.
struct Quantizer {
  double scale;
  float scale_f;
  bool in_float;

  __device__ __forceinline__ explicit Quantizer(double s)
      : scale(s), scale_f((float)s), in_float(s >= 0x1p-126 && s <= 0x1p127) {}

  template <bool kFloat>
  __device__ __forceinline__ long long q(float t) const {
    return kFloat ? __float2ll_rn(t * scale_f) : __double2ll_rn((double)t * scale);
  }
};

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// Four channels of a value row from `values + idx`: one 16-byte load when
// the rows are 16-byte aligned (kVec4), else `nc` loads, the rest 0.
template <bool kVec4>
__device__ __forceinline__ float4 load4(const float* __restrict__ values, int idx,
                                        int nc) {
  if (kVec4) return __ldg(reinterpret_cast<const float4*>(values + idx));
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (nc > 0) x.x = __ldg(values + idx);
  if (nc > 1) x.y = __ldg(values + idx + 1);
  if (nc > 2) x.z = __ldg(values + idx + 2);
  if (nc > 3) x.w = __ldg(values + idx + 3);
  return x;
}

// One owner block: part p of the nb of its group of kGroupRows rows. Each
// thread takes one of the group's S sources per row (`Terms::source(r, s,
// &b)`: source s of row r is bucket b, or nothing), and the block lists the
// group's W entries in (row, source, entry) order. Part p takes an equal,
// contiguous run of them and resolves each entry (its id, through
// `Terms::item`, to the element offset of its value row and its weight) into
// shared memory. Then units of kUnitLanes lanes, four channels per lane
// (one 16-byte load of the value row each), take equal, contiguous runs of
// the block's entries, four entries in flight at a time, quantize each term
// (Quantizer on Terms::term(w, x)) and add it into int64 registers per row.
// A row inside one unit's run is written by that unit; a row split across
// the block's units is added up from shared memory and written by the
// block; a row split across blocks leaves the block's int64 sum in a slot,
// and the group's last block to finish adds the slots (integers: any order)
// and writes it. Part 0 writes the rows nothing feeds. Every entry of `out`
// is written once. Block g is the first owner of group g; block G + h is
// further owner h.
constexpr int kUnitLanes = 8;
constexpr int kUnits = kThreads / kUnitLanes;
constexpr int kChan = 4 * kUnitLanes;  // channels per pass

template <class Terms, bool kVec4>
__global__ void __launch_bounds__(kThreads) row_sum_kernel(
    const Terms terms, const Scratch sc, double n_terms,
    float* __restrict__ out, long long R, long long G, int C) {
  constexpr int S = Terms::kSources;
  constexpr int kBatch = 4;
  static_assert(kGroupRows * S <= kThreads, "one source per thread");
  static_assert(kChan == 32, "a pass covers one warp's lanes as channels");
  __shared__ int s_start[kThreads];     // first entry of each source's bucket
  __shared__ int s_pre[kThreads + 1];   // entries listed before each source
  __shared__ int s_warp[kWarps];
  __shared__ int s_off[kItemsPerBlock];  // the block's entries: value rows,
  __shared__ float s_w[kItemsPerBlock];  // weights
  __shared__ int s_row[kItemsPerBlock];  // and rows in the group
  __shared__ long long s_part[kUnits][2][kChan];  // [first row, last row]
  __shared__ int s_last;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int g = blockIdx.x, p = 0;
  if (g >= G) {  // a further owner block
    const int h = g - (int)G;
    if (h >= *sc.helper_counter) return;
    g = sc.owner[h];
    p = h - sc.HB[g] + 1;
  }
  const int nb = sc.NB[g];
  const long long r0 = (long long)g * kGroupRows;
  int cnt = 0, start = 0;
  {
    const long long r = r0 + t / S;
    long long b;
    if (t < kGroupRows * S && r < R && terms.source(r, t % S, &b)) {
      start = sc.B[b];
      cnt = sc.B[b + 1] - start;
    }
  }
  int W;
  s_pre[t] = block_exclusive_scan(cnt, &W, s_warp);
  s_start[t] = start;
  if (t == 0) s_pre[kThreads] = W;
  __syncthreads();

  const int per_b = (W + nb * 32 - 1) / (nb * 32) * 32;  // entries per block
  const int lo_b = min(W, p * per_b), hi_b = min(W, lo_b + per_b);
  const int n = hi_b - lo_b;  // at most kItemsPerBlock
  for (int k = t; k < n; k += kThreads) {
    const int item = lo_b + k;
    int a = 0, z = kThreads;  // s_pre[a] <= item < s_pre[z]
    while (z - a > 1) {
      const int m = (a + z) >> 1;
      if (s_pre[m] <= item) a = m; else z = m;
    }
    s_off[k] = terms.item(__ldg(sc.ids + s_start[a] + (item - s_pre[a])), a % S, &s_w[k]);
    s_row[k] = a / S;
  }
  const int unit = t / kUnitLanes, ul = t % kUnitLanes;
  const int per_u = (n + kUnits - 1) / kUnits;  // entries per unit
  const int lo_u = min(n, unit * per_u), hi_u = min(n, lo_u + per_u);
  long long* part = sc.part + (long long)(sc.PB[g] + p) * 2 * C;
  const Quantizer quant(scale_of(sc.slot, n_terms));
  const double inv = 1.0 / quant.scale;  // a power of two: exact
  const bool bad = sc.slot[1] != 0u;
  const float nan = __int_as_float(0x7fc00000);
  auto value = [&](long long sum) {
    return bad ? nan : (float)((double)sum * inv);
  };
  __syncthreads();

  for (int cg = 0; cg < C; cg += kChan) {
    const int c = cg + 4 * ul;               // this lane's four channels
    const int nc = max(0, min(4, C - c));
    long long run[4] = {0, 0, 0, 0};
    int cur = -1;
    // The row's sum over this unit's run: written, or left for the block
    // (slot 0 if the row holds the run's first entry, else slot 1).
    auto emit = [&](int i) {
      const int ps = s_pre[i * S] - lo_b, pe = s_pre[(i + 1) * S] - lo_b;
      if (ps >= lo_u && pe <= hi_u) {
        float* o = out + (r0 + i) * C + c;
#pragma unroll
        for (int ch = 0; ch < 4; ++ch)
          if (ch < nc) o[ch] = value(run[ch]);
      } else {
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) s_part[unit][ps <= lo_u ? 0 : 1][4 * ul + ch] = run[ch];
      }
    };
    const int cs = nc > 0 ? c : 0;
    // Two copies of the loop, for the two quantizer paths (a uniform branch).
    auto accumulate = [&](auto in_float) {
    for (int k0 = lo_u; k0 < hi_u; k0 += kBatch) {
      float4 x[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        x[u] = load4<kVec4>(terms.values, s_off[min(k0 + u, hi_u - 1)] + cs, nc);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (k0 + u < hi_u) {
          const int rj = s_row[k0 + u];
          if (rj != cur) {
            if (cur >= 0) emit(cur);
            cur = rj;
            run[0] = run[1] = run[2] = run[3] = 0;
          }
          constexpr bool kF = decltype(in_float)::value;
          const float w = s_w[k0 + u];
          run[0] += quant.template q<kF>(terms.term(w, x[u].x));
          run[1] += quant.template q<kF>(terms.term(w, x[u].y));
          run[2] += quant.template q<kF>(terms.term(w, x[u].z));
          run[3] += quant.template q<kF>(terms.term(w, x[u].w));
        }
      }
    }
    };
    if (quant.in_float) accumulate(Flag<true>()); else accumulate(Flag<false>());
    if (cur >= 0) emit(cur);
    __syncthreads();
    // Rows nothing feeds (part 0), and the block's rows split across units
    // or blocks; lane = channel.
    const int cc = cg + lane;
    for (int i = warp; i < kGroupRows && r0 + i < R; i += kWarps) {
      const int ps = s_pre[i * S], pe = s_pre[(i + 1) * S];
      if (pe == ps) {
        if (p == 0 && cc < C) out[(r0 + i) * C + cc] = value(0);
        continue;
      }
      const int a = max(ps, lo_b) - lo_b, z = min(pe, hi_b) - lo_b;
      if (a >= z) continue;  // not in this block's run
      const int u0 = a / per_u, u1 = (z - 1) / per_u;
      const bool inside = ps >= lo_b && pe <= hi_b;
      if (inside && u0 == u1) continue;  // its unit wrote it
      long long sum = 0;
      for (int u = u0; u <= u1; ++u)
        sum += s_part[u][ps - lo_b <= u * per_u ? 0 : 1][lane];
      if (cc >= C) continue;
      if (inside) out[(r0 + i) * C + cc] = value(sum);
      else part[(ps <= lo_b ? 0 : C) + cc] = sum;
    }
    __syncthreads();
  }
  if (nb == 1) return;
  // The group's last block to finish adds the slots of the rows split
  // across blocks.
  __threadfence();
  __syncthreads();
  if (t == 0) s_last = atomicAdd(sc.done + g, 1) == nb - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const long long* slots = sc.part + (long long)sc.PB[g] * 2 * C;
  for (int cg = 0; cg < C; cg += 32) {
    const int c = cg + lane;
    if (c >= C) continue;
    for (int i = warp; i < kGroupRows && r0 + i < R; i += kWarps) {
      const int ps = s_pre[i * S], pe = s_pre[(i + 1) * S];
      if (pe == ps) continue;
      const int p0 = ps / per_b, p1 = (pe - 1) / per_b;
      if (p0 == p1) continue;
      long long sum = 0;
      for (int q = p0; q <= p1; ++q)
        sum += __ldcg(slots + (long long)q * 2 * C + (ps <= q * per_b ? 0 : C) + c);
      out[(r0 + i) * C + c] = value(sum);
    }
  }
}

// Step 4, once the buckets are filled and the groups sized.
template <class Terms>
inline void row_sum(const Terms& terms, const Scratch& sc, const Layout& L,
                    double n_terms, float* out, long long R, int C,
                    cudaStream_t s) {
  // 16-byte loads need 16-byte aligned value rows and channel quads.
  const bool vec4 = C % 4 == 0 &&
                    (reinterpret_cast<unsigned long long>(terms.values) & 15) == 0;
  const unsigned int blocks = (unsigned int)(L.G + L.helpers);
  if (vec4)
    row_sum_kernel<Terms, true><<<blocks, kThreads, 0, s>>>(terms, sc, n_terms, out, R, L.G, C);
  else
    row_sum_kernel<Terms, false><<<blocks, kThreads, 0, s>>>(terms, sc, n_terms, out, R, L.G, C);
}

}  // namespace fixed_sum
