// The inference set-abstraction level with "first" selection on the tensor
// cores (sa_select.cu holds the C entries and the design note).
//
// A block of 256 threads (8 warps) walks whole clouds (n = blockIdx.x, +
// gridDim.x, ...). Per cloud:
//   1. u = feat @ W1 for the P points on mma.sync (Mma of
//      sa_train_tiles.cuh), rows in chunks of 64, columns in slices of
//      kSlice, W1 streamed through the cp.async ring (its rows past C+3
//      zero-filled); u is rounded to T and kept in shared memory [P][H1 +
//      pad] in T.
//   2. The centers in groups of up to kGroup: every warp selects centers
//      w, w + 8, ... of the group (the first <= K in-radius points in index
//      order by ballot and popcount, dist2 of sa_level.cuh); then each warp
//      scans the counts (the rows' exclusive prefix) and writes the row map
//      (center, point) of its own centers, and warp 0 cuts the rows into
//      tiles of at most R rows at center boundaries (a center's edges never
//      straddle two tiles, an empty center takes no row). Two barriers a
//      group.
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
#pragma once

#include "sa_level.cuh"        // dist2, sq_norm: the selections' shared distance
#include "sa_train_tiles.cuh"  // Mma, product, stage_rows, Pad, take, launch

namespace t2l {
namespace sas {

using sat::kKC;
using sat::kThreads;
using sat::kWarps;

constexpr int kMaxNbr = 32;                       // K <= 32: a lane per slot
constexpr int kSlice = kWarps * 8 * sat::kMaxNQ;  // output columns of one product
constexpr int kGroup = 128;                       // centers selected at once
constexpr size_t kSmemLimit = 232448;             // bytes of shared memory a block may use

struct Args {
  const void* feat;   // [n, p, c] T: concat(x, pos)
  const float* pos;   // [n, p, 3]
  const float* ctr;   // [n, s, 3]
  const void* w1;     // [c, h1] T
  const void* wp;     // [3, h1] T: the position rows of W1
  const float* ab1;   // [2, h1] folded BN: scale, shift
  const void* w2;     // [h1, h2] T
  const float* ab2;   // [2, h2]
  void* out;          // [n, s, h2] T
  int n, p, s, c, h1, h2, k;
  float r2;
  int rows, resident;
};

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

// Centers of a group: all of the cloud's up to kGroup.
__host__ __device__ inline int group_size(int s) {
  return s < 1 ? 1 : (s < kGroup ? s : kGroup);
}

struct Smem {
  unsigned char* w2;   // resident: W2 [h1k][h2 + pad], rows past h1 zero
  unsigned char* u;    // u [p][h1 + pad] T
  float* pos;          // [p][3]
  float* cst;          // [5][h1]: BN1 scale, shift; the rows of Wp (f32)
  float* gctr;         // [G][4] the group's centers
  uint16_t* list;      // [G][k] their selected points
  int* cnt;            // [G] their counts
  int* grow;           // [G + 1] their first rows (exclusive prefix of cnt)
  int* tile;           // [G + 1] the tiles' first centers, then G
  int* rowmap;         // [G k] a row's (center << 16 | point)
  int* num;            // [2] tiles of the group
  // Scratch, per phase: the u pass's feat rows [64][ck + pad] and W1
  // ring; a tile's h1 [rows][h1k + pad] with y over it (y apart where H2 >
  // kSlice), and the W2 ring.
  unsigned char* fs;
  unsigned char* ring1;
  unsigned char* hs;
  unsigned char* ys;
  unsigned char* ring2;
};

// The carve-up of one block's dynamic shared memory (es = sizeof(T)); the
// host sizes a plan with the same function (ops/cuda_pointconv.select_smem
// mirrors it). Returns the bytes.
__host__ __device__ inline size_t layout(int p, int s, int c, int h1, int h2, int k,
                                         int rows, int resident, int es,
                                         unsigned char* base, Smem* out) {
  using sat::take;
  const int pad = es == 4 ? 4 : 8;
  const int h1k = round_up(h1, kKC), ck = round_up(c, kKC);
  const int w1n = h1 < kSlice ? h1 : kSlice, w2n = h2 < kSlice ? h2 : kSlice;
  const int g = group_size(s);
  size_t off = 0;
  Smem sm;
  sm.w2 = take(base, &off, resident ? (size_t)es * h1k * (h2 + pad) : 0);
  sm.u = take(base, &off, (size_t)es * p * (h1 + pad));
  sm.pos = reinterpret_cast<float*>(take(base, &off, sizeof(float) * 3 * p));
  sm.cst = reinterpret_cast<float*>(take(base, &off, sizeof(float) * 5 * h1));
  sm.gctr = reinterpret_cast<float*>(take(base, &off, sizeof(float) * 4 * g));
  sm.list = reinterpret_cast<uint16_t*>(take(base, &off, sizeof(uint16_t) * g * k));
  sm.cnt = reinterpret_cast<int*>(take(base, &off, sizeof(int) * g));
  sm.grow = reinterpret_cast<int*>(take(base, &off, sizeof(int) * (g + 1)));
  sm.tile = reinterpret_cast<int*>(take(base, &off, sizeof(int) * (g + 1)));
  sm.rowmap = reinterpret_cast<int*>(take(base, &off, sizeof(int) * g * k));
  sm.num = reinterpret_cast<int*>(take(base, &off, sizeof(int) * 2));
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

// What the kernel relies on; 0 where it holds. K in [1, 32]; P <= 65535
// (a row's point in 16 bits); H1 and H2 multiples of 8, H1 <= 1024 (a
// thread owns one column chunk of h1); R a multiple of 16 in [K, 16 MTR].
__host__ __device__ inline int check_args(const Args& a) {
  if (a.k < 1 || a.k > kMaxNbr || a.p < 1 || a.p > 65535 || a.c < 1) return 1;
  if (a.h1 < 8 || a.h1 % 8 || a.h1 > 1024 || a.h2 < 8 || a.h2 % 8) return 1;
  if (a.rows % 16 || a.rows < a.k || a.rows > 16 * row_tiles(width_class(a.h1, a.h2)))
    return 1;
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

template <typename T, int NQ>
__global__ void __launch_bounds__(kThreads, MinBlocks<T, NQ>::v)
    sa_select_first_kernel(Args a) {
  constexpr int MTR = sat::Width<NQ>::MTR;
  constexpr int pad = sat::Pad<T>::v;
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem sm;
  layout(a.p, a.s, a.c, a.h1, a.h2, a.k, a.rows, a.resident, (int)sizeof(T), smem_raw, &sm);
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int p = a.p, s = a.s, c = a.c, h1 = a.h1, h2 = a.h2, k = a.k;
  const int h1k = round_up(h1, kKC), ck = round_up(c, kKC);
  const int ldu = h1 + pad, ldh = h1k + pad, ldf = ck + pad;
  const int w1n = h1 < kSlice ? h1 : kSlice, w2n = h2 < kSlice ? h2 : kSlice;
  const int ldy = w2n + pad;
  const int gmax = group_size(s);
  T* u_s = reinterpret_cast<T*>(sm.u);
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
    const float* pos_n = a.pos + (size_t)n * p * 3;
    const float* ctr_n = a.ctr + (size_t)n * s * 3;
    for (int i = tid; i < p * 3; i += kThreads) sm.pos[i] = pos_n[i];

    // 1. u = feat @ W1, rounded to T, in row chunks of 64 points.
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
              if (mt < mts && r < rn)
                gemm::store2<T>(u_s + (r0 + r) * ldu + col, acc[mt][q][2 * eh],
                                acc[mt][q][2 * eh + 1]);
            }
        }
      }
      __syncthreads();  // fs is refilled, u complete
    }

    for (int g0 = 0; g0 < s; g0 += gmax) {
      const int gn = s - g0 < gmax ? s - g0 : gmax;
      // 2. Select every center of the group.
      for (int t = w; t < gn; t += kWarps) {
        const int si = g0 + t;
        const float cx = ctr_n[3 * si], cy = ctr_n[3 * si + 1], cz = ctr_n[3 * si + 2];
        const float sc = sq_norm(cx, cy, cz);
        uint16_t* list = sm.list + t * k;
        int count = 0;
        for (int base = 0; base < p && count < k; base += 32) {
          const int j = base + lane;
          const bool in = j < p && dist2(sc, cx, cy, cz, sm.pos, j) <= a.r2;
          const unsigned ball = __ballot_sync(0xffffffffu, in);
          const int rank = count + __popc(ball & lt_mask);
          if (in && rank < k) list[rank] = (uint16_t)j;
          count += __popc(ball);
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

      const int ntiles = sm.num[0];
      for (int ti = 0; ti < ntiles; ++ti) {
        const int c0 = sm.tile[ti], c1 = sm.tile[ti + 1];
        const int row0 = sm.grow[c0], used = sm.grow[c1] - row0;
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
              load16<T>(u_s + (m & 0xffff) * ldu + cc, uv);
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
            const int ra = sm.grow[t] - row0, rb = ra + sm.cnt[t];
            float m0 = 0.f, m1 = 0.f;
            for (int r = ra; r < rb; ++r) {
              float v0, v1;
              load2<T>(ys + r * ldy + col, v0, v1);
              m0 = fmaxf(m0, v0);
              m1 = fmaxf(m1, v1);
            }
            gemm::store2<T>(out + ((size_t)n * s + g0 + t) * h2 + col0 + col, m0, m1);
          }
          __syncthreads();  // the next slice's y, the next tile's h1, the next group
        }
      }
    }
  }
}

using Fn = void (*)(Args);

template <typename T>
Fn kernel_of(int h1, int h2) {
  const int nq = width_class(h1, h2);
  if (nq == 1) return sa_select_first_kernel<T, 1>;
  if (nq == 2) return sa_select_first_kernel<T, 2>;
  return sa_select_first_kernel<T, 4>;
}

// The launch (occ null) or the occupancy query (-> *occ) of the plan (rows,
// resident) on `blocks` blocks; cudaErrorInvalidValue where the kernel does
// not take the shape or the plan.
inline int entry(const Args& a, int blocks, int dtype, cudaStream_t st, int* occ) {
  if (check_args(a)) return (int)cudaErrorInvalidValue;
  const int es = dtype == kBF16 ? 2 : 4;
  const size_t smem = layout(a.p, a.s, a.c, a.h1, a.h2, a.k, a.rows, a.resident, es,
                             nullptr, nullptr);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  if (dtype == kBF16)
    return sat::launch(kernel_of<__nv_bfloat16>(a.h1, a.h2), smem, blocks, st, occ, a);
  return sat::launch(kernel_of<float>(a.h1, a.h2), smem, blocks, st, occ, a);
}

}  // namespace sas
}  // namespace t2l
