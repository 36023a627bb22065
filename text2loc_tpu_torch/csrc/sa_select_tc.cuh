// The inference set-abstraction level on the tensor cores, one kernel
// template for every selection, each instantiated in a source of its own
// with its C entries (T2L_SA_TILE_ENTRY): "first" (sa_select.cu, which
// holds the design note), "bisect" (sa_select_bisect.cu), "gather"
// (sa_gather.cu), "exact" (sa_exact.cu) and "all" (sa_all.cu).
//
// A block of 256 threads (8 warps) walks whole clouds (n = blockIdx.x, +
// gridDim.x, ...). Per cloud:
//   1. u for the P points on mma.sync (Mma of sa_train_tiles.cuh), rows in
//      chunks of 64, columns in slices of kSlice, the weight streamed
//      through the cp.async ring (its rows past C zero-filled):
//      first, bisect, gather: u = feat @ W1 rounded to T, kept in shared
//        memory [P][H1 + pad] in T;
//      exact, all: u = x @ Wx + pos @ Wp, the second term as three f32 FMAs
//        per element, not rounded, kept [P][H1 + 4] in f32.
//   2. Rows: a row is an edge (center, point), the row map holds a group's
//      rows in center order.
//      first, bisect, gather, exact: the centers in groups of up to kGroup.
//        Every warp selects centers w, w + 8, ... of the group into a list
//        of at most K points: "first" the first <= K in-radius points in
//        index order by ballot and popcount; "gather" the valid slots of
//        the center's idx/mask row in slot order (one lane a slot; no point
//        positions); "bisect" and "exact" hold the center's in-radius d2 in
//        registers (8 points a lane, P <= 256): "bisect" takes `iters`
//        rounds of threshold bisection, count(d2 <= mid) <= K by a warp
//        reduction, then the TPU kernel's tie expansion, then the first
//        <= K points with d2 <= thr in index order; "exact" the K nearest,
//        ties to the lowest index (the K-th least d2 by bisection over its
//        bits, then the points below it and the lowest-index ones at it).
//        Both take every in-radius point where at most K are, without
//        rounds.
//        Then each warp scans the counts (the rows' exclusive prefix) and
//        writes the row map of its own centers, and warp 0 cuts the rows
//        into tiles of at most R rows at center boundaries (a center's
//        edges never straddle two tiles, an empty center takes no row). Two
//        barriers a group.
//      all: every in-radius point is an edge, up to P a center. Every warp
//        counts its centers of the whole cloud (ballot popcounts over
//        32-point chunks; an empty center's output row is written 0 here),
//        warp 0 takes the exclusive prefix, and the cloud's centers fall
//        into groups: the most consecutive centers whose rows fit the row
//        map's budget (>= P, so one center always does). Per group every
//        warp writes its centers' rows on a second pass over the distances,
//        and the rows are cut into tiles of R rows across center
//        boundaries: a center with more rows than the tile (or straddling
//        one's end) is split, its partial max carried from one tile to the
//        next through its own output row (every y >= 0 after the ReLU and
//        rounding is monotone, so the max of the partial maxima is exact).
//   3. Per tile: h1 = round(relu((u[j] + sv) * a1 + b1)), sv = -ctr @ Wp
//      (f32; Wp and the BN1 constants of a thread's columns in registers),
//      straight into the padded A layout [R][H1k + pad] that
//      Mma::load_a_row reads (zeros past the used rows' last m16 tile and
//      past H1).
//   4. z = h1 @ W2 on mma.sync over the used rows' m16 tiles only, per
//      slice of kSlice output columns, W2 resident in shared memory or
//      streamed through the ring (the host's plan); f32 sums.
//   5. y = relu(z * a2 + b2) rounded to T into [R][slice + pad] over h1 (a
//      slice apart where H2 > kSlice), then one thread per (center, column
//      pair) takes the max over the center's rows (rounding is monotone, so
//      the max of rounded values is the rounded max); an empty center
//      gives 0. out[n, s, :] in T. Four barriers a tile, besides the ring's.
//
// The distance is computed with the _rn intrinsics in the same order as the
// plain PyTorch version (separate tensor ops), and the bisection with
// __fadd_rn / __fmul_rn, so the in-radius sets and the thresholds agree bit
// for bit on boundary points.
#pragma once

#include <type_traits>

#include "sa_train_tiles.cuh"  // Mma, product, stage_rows, Pad, take, launch

namespace t2l {
namespace sas {

using sat::kKC;
using sat::kThreads;
using sat::kWarps;

enum Sel : int { kFirst = 0, kGather = 1, kAll = 2, kBisect = 3, kExact = 4 };

constexpr int kMaxNbr = 32;                       // K <= 32: a lane per slot
constexpr int kLanePts = 8;                       // bisect, exact: d2 a lane holds
constexpr int kMaxRegP = 32 * kLanePts;           // bisect, exact: P <= 256
constexpr float kInf = 3.0e38f;                   // bisect, exact: d2 out of radius
constexpr int kSlice = kWarps * 8 * sat::kMaxNQ;  // output columns of one product
constexpr int kGroup = 128;                       // centers selected at once (first, gather)
constexpr int kMaxAllCenters = 32767;             // "all": a row's center in 15 bits
constexpr size_t kSmemLimit = 232448;             // bytes of shared memory a block may use

struct Args {
  const void* feat;   // [n, p, c] T: concat(x, pos); "exact", "all": x
  const float* pos;   // [n, p, 3] ("gather": unused)
  const float* ctr;   // [n, s, 3]
  const void* w1;     // [c, h1] T ("exact", "all": Wx)
  const void* wp;     // [3, h1] T: the position rows of W1
  const float* ab1;   // [2, h1] folded BN: scale, shift
  const void* w2;     // [h1, h2] T
  const float* ab2;   // [2, h2]
  void* out;          // [n, s, h2] T
  int n, p, s, c, h1, h2, k;
  float r2;
  int rows, resident;
  const int* idx;         // "gather": [n, s, k] the neighbours
  const uint8_t* mask;    // "gather": [n, s, k] their validity
  int budget;             // "all": rows of the row map
  int iters;              // "bisect": rounds of threshold bisection
};

// u in f32, x @ Wx + pos @ Wp not rounded ("exact", "all"); else feat @
// W1 rounded to T.
__host__ __device__ constexpr bool u_f32(int sel) { return sel == kAll || sel == kExact; }

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// d2 of point j from a center (cx, cy, cz) with |c|^2 = sc, clamped at 0.
__device__ __forceinline__ float dist2(float sc, float cx, float cy, float cz,
                                       const float* pos_s, int j) {
  const float px = pos_s[3 * j], py = pos_s[3 * j + 1], pz = pos_s[3 * j + 2];
  const float cross = __fadd_rn(__fadd_rn(__fmul_rn(cx, px), __fmul_rn(cy, py)),
                                __fmul_rn(cz, pz));
  const float d2 = __fadd_rn(__fsub_rn(sc, __fmul_rn(2.0f, cross)), sq_norm(px, py, pz));
  return fmaxf(d2, 0.0f);
}

// The order of a d2 >= 0 (or -0) as an unsigned key: its bits without the
// sign.
__device__ __forceinline__ unsigned d2_key(float v) { return __float_as_uint(v) & 0x7fffffffu; }

// Points of the warp's registers d (point i * 32 + lane in d[i]) with d2 <= t
// (or key <= t).
template <typename V>
__device__ __forceinline__ int warp_count_le(const V (&d)[kLanePts], V t) {
  unsigned n = 0;
#pragma unroll
  for (int i = 0; i < kLanePts; ++i) n += d[i] <= t;
  return (int)__reduce_add_sync(0xffffffffu, n);
}

// Appends the points i * 32 + lane with take[i] set to `list`, in index
// order, keeping at most `cap`; returns the number of points set.
__device__ __forceinline__ int warp_compact(const bool (&take)[kLanePts], uint16_t* list,
                                            int cap, unsigned lt_mask) {
  int count = 0;
#pragma unroll
  for (int i = 0; i < kLanePts; ++i) {
    const unsigned ball = __ballot_sync(0xffffffffu, take[i]);
    const int rank = count + __popc(ball & lt_mask);
    if (take[i] && rank < cap) list[rank] = (uint16_t)(i * 32 + (threadIdx.x & 31));
    count += __popc(ball);
  }
  return count;
}

// "bisect": the first <= K points with d2 <= thr in index order, thr the
// largest of `iters` bisection midpoints in [0, r2] with count(d2 <= thr)
// <= K, expanded to the next distance where that count falls short of K
// (the TPU kernel's tie expansion), or r2 where at most K are in radius.
// d: the in-radius d2, kInf elsewhere. Returns the count before the cap.
__device__ __forceinline__ int select_bisect(const float (&d)[kLanePts], float r2, int k,
                                             int iters, uint16_t* list, unsigned lt_mask) {
  bool take[kLanePts];
  if (warp_count_le(d, r2) <= k) {  // thr = r2 whatever the rounds find
#pragma unroll
    for (int i = 0; i < kLanePts; ++i) take[i] = d[i] < kInf;
    return warp_compact(take, list, k, lt_mask);
  }
  float lo = 0.f, hi = r2;
  for (int it = 0; it < iters; ++it) {
    const float mid = __fmul_rn(__fadd_rn(lo, hi), 0.5f);
    if (warp_count_le(d, mid) <= k) lo = mid; else hi = mid;
  }
  unsigned nx = d2_key(kInf);
#pragma unroll
  for (int i = 0; i < kLanePts; ++i)
    if (d[i] > lo && d[i] < kInf) nx = min(nx, d2_key(d[i]));
  nx = __reduce_min_sync(0xffffffffu, nx);
  const float thr = warp_count_le(d, lo) < k ? __uint_as_float(nx) : lo;
#pragma unroll
  for (int i = 0; i < kLanePts; ++i) take[i] = d[i] <= thr;
  return warp_compact(take, list, k, lt_mask);
}

// "exact": the K nearest in-radius points, ties to the lowest index (the
// set of the TPU kernel's K masked-argmin rounds); every in-radius point
// where at most K are. Else T, the K-th least key, by bisection over the
// integer keys [0, key(r2)] (about 30 rounds of a count), then every point
// below T (fewer than K) and the lowest-index points at T up to K. d: as
// select_bisect's. The list is in index order per pass (a max pools it).
// Returns the count, at most K.
__device__ __forceinline__ int select_exact(const float (&d)[kLanePts], float r2, int k,
                                            uint16_t* list, unsigned lt_mask) {
  bool take[kLanePts];
  if (warp_count_le(d, r2) <= k) {
#pragma unroll
    for (int i = 0; i < kLanePts; ++i) take[i] = d[i] < kInf;
    return warp_compact(take, list, k, lt_mask);
  }
  unsigned key[kLanePts];
#pragma unroll
  for (int i = 0; i < kLanePts; ++i) key[i] = d2_key(d[i]);
  unsigned lo = 0, hi = d2_key(r2);  // count(key <= hi) > K
  while (lo < hi) {
    const unsigned mid = lo + ((hi - lo) >> 1);
    if (warp_count_le(key, mid) >= k) hi = mid; else lo = mid + 1;
  }
#pragma unroll
  for (int i = 0; i < kLanePts; ++i) take[i] = key[i] < lo;
  const int below = warp_compact(take, list, k, lt_mask);
#pragma unroll
  for (int i = 0; i < kLanePts; ++i) take[i] = key[i] == lo;
  warp_compact(take, list + below, k - below, lt_mask);
  return k;
}

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The width class NQ (n8 tiles a warp owns) of a level: its widest product
// slice, <= 64, 128 or kSlice columns for NQ = 1, 2, 4.
__host__ __device__ inline int width_class(int h1, int h2) {
  const int a = h1 < kSlice ? h1 : kSlice, b = h2 < kSlice ? h2 : kSlice;
  const int hm = a > b ? a : b;
  return hm <= 64 ? 1 : (hm <= 128 ? 2 : 4);
}

// m16 row tiles a tile holds: sat::Width<NQ>::MTR.
__host__ __device__ inline int row_tiles(int nq) { return nq == 4 ? 4 : 8; }

constexpr int kUTiles = 4;  // m16 row tiles of a u pass chunk: 64 points

// Centers of a group (first, gather): all of the cloud's up to kGroup.
__host__ __device__ inline int group_size(int s) {
  return s < 1 ? 1 : (s < kGroup ? s : kGroup);
}

struct Smem {
  unsigned char* w2;   // resident: W2 [h1k][h2 + pad], rows past h1 zero
  unsigned char* u;    // u [p][h1 + pad] T; "all": [p][h1 + 4] f32
  float* pos;          // [p][3] (none for "gather")
  float* cst;          // [5][h1]: BN1 scale, shift; the rows of Wp (f32)
  float* gctr;         // [G][4] the group's centers ("all": the cloud's)
  uint16_t* list;      // [G][k] their selected points (none for "all")
  int* cnt;            // [G] their counts
  int* grow;           // [G + 1] their first rows (exclusive prefix of cnt)
  int* tile;           // [G + 1] the tiles' first centers, then G (none for "all")
  int* rowmap;         // [G k] ("all": [budget]) a row's (center << 16 | point)
  int* num;            // [2] tiles of the group (none for "all")
  // Scratch, per phase: the u pass's feat rows [64][ck + pad] and W1
  // ring; a tile's h1 [rows][h1k + pad] with y over it (y apart where H2 >
  // kSlice), and the W2 ring.
  unsigned char* fs;
  unsigned char* ring1;
  unsigned char* hs;
  unsigned char* ys;
  unsigned char* ring2;
};

// The carve-up of one block's dynamic shared memory for selection sel (es
// = sizeof(T)); the host sizes a plan with the same function
// (ops/cuda_pointconv.select_smem mirrors it). Returns the bytes.
__host__ __device__ inline size_t layout(int sel, int p, int s, int c, int h1, int h2, int k,
                                         int rows, int resident, int budget, int es,
                                         unsigned char* base, Smem* out) {
  using sat::take;
  const int pad = es == 4 ? 4 : 8;
  const bool all = sel == kAll;  // rows by the budget, no lists
  const int h1k = round_up(h1, kKC), ck = round_up(c, kKC);
  const int w1n = h1 < kSlice ? h1 : kSlice, w2n = h2 < kSlice ? h2 : kSlice;
  const int g = all ? (s < 1 ? 1 : s) : group_size(s);
  size_t off = 0;
  Smem sm;
  sm.w2 = take(base, &off, resident ? (size_t)es * h1k * (h2 + pad) : 0);
  sm.u = take(base, &off,
              u_f32(sel) ? sizeof(float) * p * (h1 + 4) : (size_t)es * p * (h1 + pad));
  sm.pos = reinterpret_cast<float*>(
      take(base, &off, sel == kGather ? 0 : sizeof(float) * 3 * p));
  sm.cst = reinterpret_cast<float*>(take(base, &off, sizeof(float) * 5 * h1));
  sm.gctr = reinterpret_cast<float*>(take(base, &off, sizeof(float) * 4 * g));
  sm.list = reinterpret_cast<uint16_t*>(
      take(base, &off, all ? 0 : sizeof(uint16_t) * g * k));
  sm.cnt = reinterpret_cast<int*>(take(base, &off, sizeof(int) * g));
  sm.grow = reinterpret_cast<int*>(take(base, &off, sizeof(int) * (g + 1)));
  sm.tile = reinterpret_cast<int*>(take(base, &off, all ? 0 : sizeof(int) * (g + 1)));
  sm.rowmap = reinterpret_cast<int*>(
      take(base, &off, sizeof(int) * (all ? (size_t)budget : (size_t)g * k)));
  sm.num = reinterpret_cast<int*>(take(base, &off, all ? 0 : sizeof(int) * 2));
  size_t u_end = off, t_end = off;
  sm.fs = take(base, &u_end, (size_t)es * 16 * kUTiles * (ck + pad));
  sm.ring1 = take(base, &u_end, (size_t)es * 2 * kKC * (w1n + pad));
  const size_t hs_bytes = (size_t)es * rows * (h1k + pad);
  const size_t ys_bytes = (size_t)es * rows * (w2n + pad);
  const bool apart = h2 > kSlice;
  sm.hs = take(base, &t_end, apart || hs_bytes >= ys_bytes ? hs_bytes : ys_bytes);
  sm.ys = apart ? take(base, &t_end, ys_bytes) : sm.hs;
  sm.ring2 = take(base, &t_end, resident ? 0 : (size_t)es * 2 * kKC * (w2n + pad));
  if (out != nullptr) *out = sm;
  return u_end > t_end ? u_end : t_end;
}

// What the kernel of selection sel relies on; 0 where it holds. P <= 65535
// (a row's point in 16 bits); H1 and H2 multiples of 8, H1 <= 1024 (a
// thread owns one column chunk of h1); R a multiple of 16 in [16, 16 MTR].
// first, bisect, gather, exact: K in [1, 32] and R >= K (a center in one
// tile); bisect, exact: P <= kMaxRegP (d2 in registers). all: the row
// budget >= P (a center in one group), S <= kMaxAllCenters.
__host__ __device__ inline int check_args(int sel, const Args& a) {
  if (a.p < 1 || a.p > 65535 || a.c < 1) return 1;
  if (a.h1 < 8 || a.h1 % 8 || a.h1 > 1024 || a.h2 < 8 || a.h2 % 8) return 1;
  if (a.rows % 16 || a.rows < 16 || a.rows > 16 * row_tiles(width_class(a.h1, a.h2)))
    return 1;
  if (sel == kAll) {
    if (a.budget < a.p || a.s > kMaxAllCenters) return 1;
  } else if (a.k < 1 || a.k > kMaxNbr || a.rows < a.k) {
    return 1;
  }
  if ((sel == kBisect || sel == kExact) && a.p > kMaxRegP) return 1;  // d2 in registers
  return a.resident == 0 || a.resident == 1 ? 0 : 1;
}

// 16 bytes of T at p (16-byte aligned) as floats, and back (rounded to T).
template <typename T>
__device__ __forceinline__ void load16(const T* p, float (&v)[16 / sizeof(T)]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      v[i] = __uint_as_float(w[i]);
    } else {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const float (&v)[16 / sizeof(T)]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      w[i] = __float_as_uint(v[i]);
    } else {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T>
__device__ __forceinline__ void load2(const T* p, float& a, float& b) {
  if constexpr (sizeof(T) == 4) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    a = v.x;
    b = v.y;
  } else {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    a = v.x;
    b = v.y;
  }
}

// Blocks per SM the register budget aims at: two, but one for the f32
// products at the wider classes, whose hi / lo fragments beside 64
// accumulators take more than half of an SM's registers (their plans hold
// one block an SM by shared memory at the gallery's levels anyway).
template <typename T, int NQ>
struct MinBlocks {
  static constexpr int v = sizeof(T) == 4 && NQ >= 2 ? 1 : 2;
};

// The level of selection SEL (steps 1-5 above): the other selections
// branch off "first"'s statements at compile time where they differ.
template <int SEL, typename T, int NQ>
__device__ __forceinline__ void sa_level_tc(const Args& a) {
  using U = std::conditional_t<u_f32(SEL), float, T>;  // u in shared memory
  constexpr int MTR = sat::Width<NQ>::MTR;
  constexpr int pad = sat::Pad<T>::v;
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem sm;
  layout(SEL, a.p, a.s, a.c, a.h1, a.h2, a.k, a.rows, a.resident, a.budget, (int)sizeof(T),
         smem_raw, &sm);
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int p = a.p, s = a.s, c = a.c, h1 = a.h1, h2 = a.h2, k = a.k;
  const int h1k = round_up(h1, kKC), ck = round_up(c, kKC);
  const int ldu = h1 + sat::Pad<U>::v, ldh = h1k + pad, ldf = ck + pad;
  const int w1n = h1 < kSlice ? h1 : kSlice, w2n = h2 < kSlice ? h2 : kSlice;
  const int ldy = w2n + pad;
  const int gmax = group_size(s);
  U* u_s = reinterpret_cast<U*>(sm.u);
  T* fs = reinterpret_cast<T*>(sm.fs);
  T* ring1 = reinterpret_cast<T*>(sm.ring1);
  T* hs = reinterpret_cast<T*>(sm.hs);
  T* ys = reinterpret_cast<T*>(sm.ys);
  T* ring2 = reinterpret_cast<T*>(sm.ring2);
  const T* w1g = static_cast<const T*>(a.w1);
  const T* wpg = static_cast<const T*>(a.wp);
  const T* w2g = static_cast<const T*>(a.w2);
  T* out = static_cast<T*>(a.out);
  const T* w2s = nullptr;
  if (a.resident) {
    T* ws = reinterpret_cast<T*>(sm.w2);
    sat::stage_rows<T, true>(ws, h2 + pad, w2g, h2, 0, h1k, h2, h1);
    gemm::cp_async_commit();
    gemm::cp_async_wait<0>();
    w2s = ws;
  }
  for (int i = tid; i < 2 * h1; i += kThreads) sm.cst[i] = a.ab1[i];
  for (int i = tid; i < 3 * h1; i += kThreads) sm.cst[2 * h1 + i] = to_f(wpg[i]);
  const unsigned lt_mask = (1u << lane) - 1u;

  for (int n = blockIdx.x; n < a.n; n += gridDim.x) {
    const T* feat_n = static_cast<const T*>(a.feat) + (size_t)n * p * c;
    const float* pos_n = a.pos + (size_t)n * p * 3;  // gather: not read
    const float* ctr_n = a.ctr + (size_t)n * s * 3;
    if constexpr (SEL != kGather)
      for (int i = tid; i < p * 3; i += kThreads) sm.pos[i] = pos_n[i];

    // 1. u in row chunks of 64 points.
    for (int r0 = 0; r0 < p; r0 += 16 * kUTiles) {
      const int rn = p - r0 < 16 * kUTiles ? p - r0 : 16 * kUTiles;
      for (int r = w; r < 16 * kUTiles; r += kWarps)
#pragma unroll 4
        for (int cc = lane; cc < ck; cc += 32)
          fs[r * ldf + cc] = r < rn && cc < c ? feat_n[(size_t)(r0 + r) * c + cc]
                                              : from_f<T>(0.f);
      __syncthreads();
      for (int col0 = 0; col0 < h1; col0 += kSlice) {
        const int wn = h1 - col0 < kSlice ? h1 - col0 : kSlice;
        const int nq = sat::warp_nq(wn, w), mts = (rn + 15) / 16;
        float acc[kUTiles][NQ][4];
        sat::product<T, kUTiles, NQ, true>(acc, fs, ldf, ck, nullptr, w1g + col0, wn, ring1,
                                           w1n + pad, mts, nq, h1, c);
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          if (q >= nq) continue;
          const int col = col0 + (w + kWarps * q) * 8 + 2 * t4;
#pragma unroll
          for (int mt = 0; mt < kUTiles; ++mt)
#pragma unroll
            for (int eh = 0; eh < 2; ++eh) {
              const int r = mt * 16 + 8 * eh + g;
              if (mt < mts && r < rn) {
                if constexpr (u_f32(SEL)) {
                  // x @ Wx + pos @ Wp in f32: three FMAs with Wp's rows.
                  const float* pr = sm.pos + 3 * (r0 + r);
                  const float* wp0 = sm.cst + 2 * h1 + col;
                  const float p0 = fmaf(pr[2], wp0[2 * h1],
                                        fmaf(pr[1], wp0[h1], pr[0] * wp0[0]));
                  const float p1 = fmaf(pr[2], wp0[2 * h1 + 1],
                                        fmaf(pr[1], wp0[h1 + 1], pr[0] * wp0[1]));
                  *reinterpret_cast<float2*>(u_s + (r0 + r) * ldu + col) =
                      make_float2(acc[mt][q][2 * eh] + p0, acc[mt][q][2 * eh + 1] + p1);
                } else {
                  gemm::store2<T>(u_s + (r0 + r) * ldu + col, acc[mt][q][2 * eh],
                                  acc[mt][q][2 * eh + 1]);
                }
              }
            }
        }
      }
      __syncthreads();  // fs is refilled, u complete
    }

    if constexpr (SEL == kAll) {
      // 2. Every center's count; an empty center's output row is 0.
      for (int t = w; t < s; t += kWarps) {
        const float cx = ctr_n[3 * t], cy = ctr_n[3 * t + 1], cz = ctr_n[3 * t + 2];
        const float sc = sq_norm(cx, cy, cz);
        int count = 0;
        for (int base = 0; base < p; base += 32) {
          const int j = base + lane;
          count += __popc(
              __ballot_sync(0xffffffffu, j < p && dist2(sc, cx, cy, cz, sm.pos, j) <= a.r2));
        }
        if (lane == 0) {
          sm.cnt[t] = count;
          sm.gctr[4 * t] = cx;
          sm.gctr[4 * t + 1] = cy;
          sm.gctr[4 * t + 2] = cz;
        }
        if (count == 0)
          for (int col = 2 * lane; col < h2; col += 64)
            gemm::store2<T>(out + ((size_t)n * s + t) * h2 + col, 0.f, 0.f);
      }
      __syncthreads();
      // The centers' first rows in the cloud (warp 0).
      if (w == 0) {
        int base = 0;
        for (int c0 = 0; c0 < s; c0 += 32) {
          const int t = c0 + lane;
          const int v = t < s ? sm.cnt[t] : 0;
          int incl = v;
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const int o = __shfl_up_sync(0xffffffffu, incl, off);
            if (lane >= off) incl += o;
          }
          if (t < s) sm.grow[t] = base + incl - v;
          base += __shfl_sync(0xffffffffu, incl, 31);
        }
        if (lane == 0) sm.grow[s] = base;
      }
      __syncthreads();
    }

    int gstep = gmax;  // "all": the group's centers
    for (int g0 = 0; g0 < s; g0 += gstep) {
      int gn = s - g0 < gmax ? s - g0 : gmax;
      int gb = 0;  // "all": the group's first row in the cloud
      if constexpr (SEL == kAll) {
        // The group: centers [g0, g0 + gn), the most whose rows fit the
        // budget; every warp writes its centers' rows, the in-radius points
        // in index order.
        gb = sm.grow[g0];
        int g1 = g0 + 1, hi = s;
        while (g1 < hi) {
          const int mid = (g1 + hi + 1) >> 1;
          if (sm.grow[mid] - gb <= a.budget) g1 = mid; else hi = mid - 1;
        }
        gn = gstep = g1 - g0;
        for (int t = g0 + w; t < g1; t += kWarps) {
          if (sm.cnt[t] == 0) continue;
          const float cx = sm.gctr[4 * t], cy = sm.gctr[4 * t + 1], cz = sm.gctr[4 * t + 2];
          const float sc = sq_norm(cx, cy, cz);
          int* rows = sm.rowmap + (sm.grow[t] - gb);
          int count = 0;
          for (int base = 0; base < p; base += 32) {
            const int j = base + lane;
            const bool in = j < p && dist2(sc, cx, cy, cz, sm.pos, j) <= a.r2;
            const unsigned ball = __ballot_sync(0xffffffffu, in);
            if (in) rows[count + __popc(ball & lt_mask)] = t << 16 | j;
            count += __popc(ball);
          }
        }
        __syncthreads();
      } else {
        // 2. Select every center of the group.
        for (int t = w; t < gn; t += kWarps) {
          const int si = g0 + t;
          const float cx = ctr_n[3 * si], cy = ctr_n[3 * si + 1], cz = ctr_n[3 * si + 2];
          const float sc = sq_norm(cx, cy, cz);
          uint16_t* list = sm.list + t * k;
          int count = 0;
          if constexpr (SEL == kGather) {
            // The valid slots of the center's idx/mask row, in slot order.
            const size_t row = ((size_t)n * s + si) * k;
            const bool valid = lane < k && a.mask[row + lane] != 0;
            const unsigned ball = __ballot_sync(0xffffffffu, valid);
            if (valid) list[__popc(ball & lt_mask)] = (uint16_t)a.idx[row + lane];
            count = __popc(ball);
          } else if constexpr (SEL == kFirst) {
            for (int base = 0; base < p && count < k; base += 32) {
              const int j = base + lane;
              const bool in = j < p && dist2(sc, cx, cy, cz, sm.pos, j) <= a.r2;
              const unsigned ball = __ballot_sync(0xffffffffu, in);
              const int rank = count + __popc(ball & lt_mask);
              if (in && rank < k) list[rank] = (uint16_t)j;
              count += __popc(ball);
            }
          } else {
            // The in-radius d2 of this lane's points; kInf elsewhere.
            float d[kLanePts];
#pragma unroll
            for (int i = 0; i < kLanePts; ++i) {
              const int j = i * 32 + lane;
              float v = kInf;
              if (j < p) {
                const float dd = dist2(sc, cx, cy, cz, sm.pos, j);
                if (dd <= a.r2) v = dd;
              }
              d[i] = v;
            }
            if constexpr (SEL == kBisect)
              count = select_bisect(d, a.r2, k, a.iters, list, lt_mask);
            else
              count = select_exact(d, a.r2, k, list, lt_mask);
          }
          if (lane == 0) {
            sm.cnt[t] = count < k ? count : k;
            sm.gctr[4 * t] = cx;
            sm.gctr[4 * t + 1] = cy;
            sm.gctr[4 * t + 2] = cz;
          }
        }
        __syncthreads();
        // The rows: every warp scans the counts and writes the row map of its
        // own centers; warp 0 keeps the prefix and cuts the tiles.
        int base = 0;
        for (int c0 = 0; c0 < gn; c0 += 32) {
          const int t = c0 + lane;
          const int v = t < gn ? sm.cnt[t] : 0;
          int incl = v;
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const int o = __shfl_up_sync(0xffffffffu, incl, off);
            if (lane >= off) incl += o;
          }
          if (w == 0 && t < gn) sm.grow[t] = base + incl - v;
          for (int q = w; q < 32 && c0 + q < gn; q += kWarps) {
            const int tq = c0 + q;
            const int rq = base + __shfl_sync(0xffffffffu, incl - v, q);
            const int cq = __shfl_sync(0xffffffffu, v, q);
            if (lane < cq) sm.rowmap[rq + lane] = tq << 16 | sm.list[tq * k + lane];
          }
          base += __shfl_sync(0xffffffffu, incl, 31);
        }
        if (w == 0) {
          if (lane == 0) sm.grow[gn] = base;
          __syncwarp();
          // Tiles: from center t0, the centers before the first t whose rows
          // end past grow[t0] + R.
          int nt = 0;
          for (int t0 = 0; t0 < gn; ++nt) {
            const int limit = sm.grow[t0] + a.rows;
            int t1 = gn;
            for (int cb = t0 + 1; cb < gn; cb += 32) {
              const unsigned over =
                  __ballot_sync(0xffffffffu, cb + lane < gn && sm.grow[cb + lane + 1] > limit);
              if (over) {
                t1 = cb + __ffs(over) - 1;
                break;
              }
            }
            if (lane == 0) sm.tile[nt] = t0;
            t0 = t1;
          }
          if (lane == 0) {
            sm.tile[nt] = gn;
            sm.num[0] = nt;
          }
        }
        __syncthreads();
      }

      // "all": tiles of R rows across center boundaries; a row's center,
      // and the output row, are the cloud's (g0 + t for the others).
      const int total = SEL == kAll ? sm.grow[g0 + gn] - gb : 0;
      const int ntiles = SEL == kAll ? (total + a.rows - 1) / a.rows : sm.num[0];
      const int og = SEL == kAll ? 0 : g0;
      for (int ti = 0; ti < ntiles; ++ti) {
        int c0, c1, row0, used;
        if constexpr (SEL == kAll) {
          row0 = ti * a.rows;
          used = total - row0 < a.rows ? total - row0 : a.rows;
          c0 = sm.rowmap[row0] >> 16;
          c1 = (sm.rowmap[row0 + used - 1] >> 16) + 1;
        } else {
          c0 = sm.tile[ti];
          c1 = sm.tile[ti + 1];
          row0 = sm.grow[c0];
          used = sm.grow[c1] - row0;
        }
        const int mts = (used + 15) / 16;
        // 3. h1 rows, zero past the used rows and past H1: a thread owns the
        // V columns cc of every kThreads / qv-th row.
        const int qv = h1k / V, rpp = kThreads / qv, cc = (tid % qv) * V;
        if (tid < rpp * qv) {
          // BN1 scale and shift, the three rows of Wp: this thread's columns.
          float cst[5][V];
#pragma unroll
          for (int q5 = 0; q5 < 5; ++q5)
#pragma unroll
            for (int e0 = 0; e0 < V; e0 += 4) {
              float v4[4] = {0.f, 0.f, 0.f, 0.f};
              if (cc < h1) load16<float>(sm.cst + q5 * h1 + cc + e0, v4);
#pragma unroll
              for (int e = 0; e < 4; ++e) cst[q5][e0 + e] = v4[e];
            }
#pragma unroll 2
          for (int r = tid / qv; r < mts * 16; r += rpp) {
            float hv[V];
#pragma unroll
            for (int e = 0; e < V; ++e) hv[e] = 0.f;
            if (r < used && cc < h1) {
              const int m = sm.rowmap[row0 + r];
              const float* ct = sm.gctr + 4 * (m >> 16);
              const float cx = ct[0], cy = ct[1], cz = ct[2];
              float uv[V];
              if constexpr (std::is_same_v<U, T>) {
                load16<T>(u_s + (m & 0xffff) * ldu + cc, uv);
              } else {  // f32 u, bf16 h1: two 16-byte loads
#pragma unroll
                for (int e0 = 0; e0 < V; e0 += 4) {
                  float v4[4];
                  load16<float>(u_s + (m & 0xffff) * ldu + cc + e0, v4);
#pragma unroll
                  for (int e = 0; e < 4; ++e) uv[e0 + e] = v4[e];
                }
              }
#pragma unroll
              for (int e = 0; e < V; ++e) {
                const float sv = -(cx * cst[2][e] + cy * cst[3][e] + cz * cst[4][e]);
                hv[e] = fmaxf(fmaf(uv[e] + sv, cst[0][e], cst[1][e]), 0.f);
              }
            }
            store16<T>(hs + r * ldh + cc, hv);
          }
        }
        __syncthreads();  // h1 complete
        // 4-5. Per slice of output columns: z, y, the max of each center.
        for (int col0 = 0; col0 < h2; col0 += kSlice) {
          const int wn = h2 - col0 < kSlice ? h2 - col0 : kSlice;
          if (mts > 0) {
            const int nq = sat::warp_nq(wn, w);
            float acc[MTR][NQ][4];
            sat::product<T, MTR, NQ, true>(acc, hs, ldh, h1k, w2s ? w2s + col0 : nullptr,
                                           w2g + col0, wn, ring2, w2s ? h2 + pad : wn + pad,
                                           mts, nq, h2, h1);
            __syncthreads();  // every warp is done reading h1: y goes over it
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
              if (q >= nq) continue;
              const int col = (w + kWarps * q) * 8 + 2 * t4;
              const float* ab2 = a.ab2 + col0 + col;
              const float a20 = ab2[0], a21 = ab2[1], b20 = ab2[h2], b21 = ab2[h2 + 1];
#pragma unroll
              for (int mt = 0; mt < MTR; ++mt)
#pragma unroll
                for (int eh = 0; eh < 2; ++eh) {
                  const int r = mt * 16 + 8 * eh + g;
                  if (mt < mts && r < used)
                    gemm::store2<T>(ys + r * ldy + col,
                                    fmaxf(fmaf(acc[mt][q][2 * eh], a20, b20), 0.f),
                                    fmaxf(fmaf(acc[mt][q][2 * eh + 1], a21, b21), 0.f));
                }
            }
            __syncthreads();  // y complete
          }
          const int pairs = wn / 2;
          for (int i = tid; i < (c1 - c0) * pairs; i += kThreads) {
            const int t = c0 + i / pairs, col = (i % pairs) * 2;
            float m0 = 0.f, m1 = 0.f;
            if constexpr (SEL == kAll) {
              // The center's rows in this tile; where it began in a tile
              // before, the max so far from its output row.
              const int st = sm.grow[t] - gb - row0, en = sm.grow[t + 1] - gb - row0;
              for (int r = st > 0 ? st : 0; r < (en < used ? en : used); ++r) {
                float v0, v1;
                load2<T>(ys + r * ldy + col, v0, v1);
                m0 = fmaxf(m0, v0);
                m1 = fmaxf(m1, v1);
              }
              if (st < 0) {
                float v0, v1;
                load2<T>(out + ((size_t)n * s + t) * h2 + col0 + col, v0, v1);
                m0 = fmaxf(m0, v0);
                m1 = fmaxf(m1, v1);
              }
            } else {
              const int ra = sm.grow[t] - row0, rb = ra + sm.cnt[t];
              for (int r = ra; r < rb; ++r) {
                float v0, v1;
                load2<T>(ys + r * ldy + col, v0, v1);
                m0 = fmaxf(m0, v0);
                m1 = fmaxf(m1, v1);
              }
            }
            gemm::store2<T>(out + ((size_t)n * s + og + t) * h2 + col0 + col, m0, m1);
          }
          __syncthreads();  // the next slice's y, the next tile's h1, the next group
        }
      }
    }
  }
}

template <typename T, int NQ>
__global__ void __launch_bounds__(kThreads, MinBlocks<T, NQ>::v)
    sa_select_first_kernel(Args a) {
  sa_level_tc<kFirst, T, NQ>(a);
}

template <typename T, int NQ>
__global__ void __launch_bounds__(kThreads, MinBlocks<T, NQ>::v) sa_gather_kernel(Args a) {
  sa_level_tc<kGather, T, NQ>(a);
}

template <typename T, int NQ>
__global__ void __launch_bounds__(kThreads, MinBlocks<T, NQ>::v) sa_all_kernel(Args a) {
  sa_level_tc<kAll, T, NQ>(a);
}

template <typename T, int NQ>
__global__ void __launch_bounds__(kThreads, MinBlocks<T, NQ>::v)
    sa_select_bisect_kernel(Args a) {
  sa_level_tc<kBisect, T, NQ>(a);
}

template <typename T, int NQ>
__global__ void __launch_bounds__(kThreads, MinBlocks<T, NQ>::v) sa_exact_kernel(Args a) {
  sa_level_tc<kExact, T, NQ>(a);
}

using Fn = void (*)(Args);

template <int SEL, typename T, int NQ>
Fn kernel_fn() {
  if constexpr (SEL == kFirst) return sa_select_first_kernel<T, NQ>;
  else if constexpr (SEL == kGather) return sa_gather_kernel<T, NQ>;
  else if constexpr (SEL == kBisect) return sa_select_bisect_kernel<T, NQ>;
  else if constexpr (SEL == kExact) return sa_exact_kernel<T, NQ>;
  else return sa_all_kernel<T, NQ>;
}

template <int SEL, typename T>
Fn kernel_of(int h1, int h2) {
  const int nq = width_class(h1, h2);
  if (nq == 1) return kernel_fn<SEL, T, 1>();
  if (nq == 2) return kernel_fn<SEL, T, 2>();
  return kernel_fn<SEL, T, 4>();
}

// The launch (occ null) or the occupancy query (-> *occ) of the plan (rows,
// resident, budget) on `blocks` blocks; cudaErrorInvalidValue where the
// kernel does not take the shape or the plan.
template <int SEL>
int entry(const Args& a, int blocks, int dtype, cudaStream_t st, int* occ) {
  if (check_args(SEL, a)) return (int)cudaErrorInvalidValue;
  const int es = dtype == kBF16 ? 2 : 4;
  const size_t smem = layout(SEL, a.p, a.s, a.c, a.h1, a.h2, a.k, a.rows, a.resident,
                             a.budget, es, nullptr, nullptr);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  if (dtype == kBF16)
    return sat::launch(kernel_of<SEL, __nv_bfloat16>(a.h1, a.h2), smem, blocks, st, occ, a);
  return sat::launch(kernel_of<SEL, float>(a.h1, a.h2), smem, blocks, st, occ, a);
}

inline Args args_of(const void* feat, const void* pos, const void* ctr, const void* idx,
                    const void* mask, const void* w1, const void* wp, const void* ab1,
                    const void* w2, const void* ab2, void* out, int n, int p, int s, int c,
                    int h1, int h2, int k, float r2, int iters, int rows, int resident,
                    int budget) {
  return Args{feat, static_cast<const float*>(pos), static_cast<const float*>(ctr), w1, wp,
              static_cast<const float*>(ab1), w2, static_cast<const float*>(ab2), out,
              n, p, s, c, h1, h2, k, r2, rows, resident, static_cast<const int*>(idx),
              static_cast<const uint8_t*>(mask), budget, iters};
}

}  // namespace sas
}  // namespace t2l

// The C entries of selection SEL (kFirst, kBisect, kGather, kExact, kAll),
// NAME its name:
//   t2l_sa_NAME_layout: dynamic shared memory of one block of the plan
//     (rows, resident, budget) for a level of P points, S centers, C input
//     channels, H1, H2, K; dtype 0 f32, 1 bf16. The largest size_t where the
//     kernel does not take the shape or the plan.
//   t2l_sa_NAME_occupancy: blocks of the plan's kernel one SM holds -> *out.
//   t2l_sa_NAME: feat [n,p,c] T (concat(x, pos) for first, bisect and
//     gather with w1 [c,h1]; x for exact and all with w1 = Wx [c,h1]); pos
//     [n,p,3] f32 (null for gather); ctr [n,s,3] f32; idx [n,s,k] int32 and
//     mask [n,s,k] bool (gather only, else null); wp [3,h1] T; ab1 [2,h1]
//     f32; w2 [h1,h2] T; ab2 [2,h2] f32 -> out [n,s,h2] T. r2: the squared
//     radius as the caller rounds it to f32; iters: the bisection's rounds
//     (bisect only); rows, resident, budget: the plan; blocks: the
//     persistent grid. Returns cudaGetLastError() after the launch.
#define T2L_SA_TILE_ENTRY(NAME, SEL)                                                        \
  extern "C" size_t t2l_sa_##NAME##_layout(int p, int s, int c, int h1, int h2, int k,      \
                                          int rows, int resident, int budget, int dtype) {  \
    const t2l::sas::Args a = t2l::sas::args_of(nullptr, nullptr, nullptr, nullptr, nullptr, \
                                               nullptr, nullptr, nullptr, nullptr, nullptr, \
                                               nullptr, 0, p, s, c, h1, h2, k, 0.f, 0,      \
                                               rows, resident, budget);                     \
    if (t2l::sas::check_args(SEL, a)) return ~static_cast<size_t>(0);                      \
    return t2l::sas::layout(SEL, p, s, c, h1, h2, k, rows, resident, budget,                \
                            dtype == t2l::kBF16 ? 2 : 4, nullptr, nullptr);                 \
  }                                                                                         \
  extern "C" int t2l_sa_##NAME##_occupancy(int p, int s, int c, int h1, int h2, int k,      \
                                           int rows, int resident, int budget, int dtype,   \
                                           void* out) {                                     \
    const t2l::sas::Args a = t2l::sas::args_of(nullptr, nullptr, nullptr, nullptr, nullptr, \
                                               nullptr, nullptr, nullptr, nullptr, nullptr, \
                                               nullptr, 0, p, s, c, h1, h2, k, 0.f, 0,      \
                                               rows, resident, budget);                     \
    return t2l::sas::entry<SEL>(a, 0, dtype, nullptr, static_cast<int*>(out));              \
  }                                                                                         \
  extern "C" int t2l_sa_##NAME(const void* feat, const void* pos, const void* ctr,          \
                               const void* idx, const void* mask, const void* w1,           \
                               const void* wp, const void* ab1, const void* w2,             \
                               const void* ab2, void* out, int n, int p, int s, int c,      \
                               int h1, int h2, int k, float r2, int iters, int rows,        \
                               int resident, int budget, int blocks, int dtype,             \
                               void* stream) {                                              \
    const t2l::sas::Args a = t2l::sas::args_of(feat, pos, ctr, idx, mask, w1, wp, ab1, w2,  \
                                               ab2, out, n, p, s, c, h1, h2, k, r2, iters,  \
                                               rows, resident, budget);                     \
    return t2l::sas::entry<SEL>(a, blocks, dtype, static_cast<cudaStream_t>(stream),        \
                                nullptr);                                                   \
  }
