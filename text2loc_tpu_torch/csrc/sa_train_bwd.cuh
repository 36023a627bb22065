// Backward passes of the training set-abstraction level on the tensor
// cores (the design note is in sa_train_bwd.cu), each templated on the
// compute dtype T and on ROUND_E: false takes e as recomputed from u and sv
// (sa_train_bwd.cu), true rounds it to bf16 as the forward did, the token
// "e" (sa_train_e_bwd.cu). Tiles, products and the W2 ring are those of
// sa_train_tiles.cuh. The three products of a tile:
//   z   [R, H2] = round(h1) [R, H1] . round(W2) [H1, H2]
//   dh1 [R, H1] = round(dz) [R, H2] . round(W2)^T [H2, H1]
//   dW2 [H1, H2] += round(h1)^T [H1, R] . round(dz) [R, H2]
// For dW2 warp w owns the n8 column tiles w + 8 q of [H1, H2] (its own dz
// columns) over every row.
// Shared memory holds round(h1) and round(dz) of the tile in T, the
// neighbour max's f32 values, and W2 and W2^T in T, either whole for the
// whole kernel ("resident") or streamed through a two-stage cp.async ring
// per product (bwd_layout sizes it). e is recomputed from u and sv where
// dh1's ReLU needs it.
#pragma once

#include "sa_train_tiles.cuh"

namespace t2l {
namespace sat {

__host__ __device__ inline size_t bwd_layout(int pass, int p, int h1, int h2, int rows,
                                             int resident, int es, unsigned char* base,
                                             Smem* out) {
  const int pad = es == 4 ? 4 : 8;
  const int hm = h1 > h2 ? h1 : h2;
  size_t off = 0;
  Smem sm;
  const size_t w_elems = resident ? (size_t)h1 * (h2 + pad) + (size_t)h2 * (h1 + pad)
                                  : (size_t)2 * kKC * (hm + pad);
  sm.w = take(base, &off, (size_t)es * w_elems);
  // Pass 1: h1, then the pool's values over it. Pass 2: h1 (kept for dW2);
  // the pool's values, then dz over them. Pass 3: h1, the pool's values,
  // dz and de in turn over one region.
  const size_t hs_bytes = (size_t)es * rows * (h1 + pad);
  const size_t ys_bytes = (size_t)4 * rows * (h2 + 8);
  const size_t dz_bytes = (size_t)es * rows * (h2 + pad);
  const size_t de_bytes = (size_t)4 * rows * (h1 + 4);
  size_t first = hs_bytes, second = 0;
  if (pass == 1) first = hs_bytes > ys_bytes ? hs_bytes : ys_bytes;
  if (pass == 2) second = ys_bytes > dz_bytes ? ys_bytes : dz_bytes;
  if (pass == 3) {
    const size_t a = hs_bytes > ys_bytes ? hs_bytes : ys_bytes;
    const size_t b = dz_bytes > de_bytes ? dz_bytes : de_bytes;
    first = a > b ? a : b;
  }
  sm.hs = take(base, &off, first);
  sm.dz = take(base, &off, second);
  sm.du = reinterpret_cast<float*>(take(base, &off, pass == 3 ? sizeof(float) * p * h1 : 0));
  sm.dsc = reinterpret_cast<float*>(take(base, &off, sizeof(float) * kMaxCenters * h2));
  sm.tl = take_tile(base, &off, rows);
  if (out != nullptr) *out = sm;
  return off;
}

// After the z product of a tile (acc = h1 . W2, no bias yet): the neighbour
// max and its backward. acc becomes z = acc + b2; each thread writes the
// filled values (mm ? relu(y2) : kNeg, y2 = fmaf(z, a2, c2)) of its
// fragments to ys [rows][h2 + 8] f32; then one thread per (center, column)
// takes mx = the max over the center's rows, cnt = max(#rows with mm and
// filled >= mx, 1) (ties share evenly) and writes each row's dh2 = dout *
// eq / cnt back in place; then each thread forms dy2 = dh2 * [y2 > 0] of
// its fragments. PASS 1 sums dy2 and dy2 * yhat2 into (sa, sb); PASS 2-3
// put dz = a2 * (dy2 - mf * (A2/n + yhat2 * B2/n)) in place of acc (0 on
// padding rows), PASS 2 summing dz into sa (db2). dsc: the tile's dout rows
// [kMaxCenters][h2]. ys aliases h1 in passes 1 and 3 (dead after z; hence
// the first barrier) and dz in pass 2 (hence the last).
template <int PASS, int MTR, int NQ>
__device__ __forceinline__ void pool_dz(const Args& a, const Tile& tl, const float* dsc,
                                        float* ys, float (&acc)[MTR][NQ][4],
                                        float (&sa)[NQ][2], float (&sb)[NQ][2]) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nq = warp_nq(a.h2, w), mts = a.rows / 16, taken = *tl.num;
  const int ldy = a.h2 + 8;
  const float* x2 = a.aux2;
  if (PASS != 2) __syncthreads();  // every warp is done reading h1
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    if (q >= nq) continue;
    const int c = (w + kWarps * q) * 8 + 2 * t;
    const float b0 = x2[kBias * a.h2 + c], b1 = x2[kBias * a.h2 + c + 1];
    const float a20 = x2[kA * a.h2 + c], a21 = x2[kA * a.h2 + c + 1];
    const float c20 = x2[kC * a.h2 + c], c21 = x2[kC * a.h2 + c + 1];
#pragma unroll
    for (int mt = 0; mt < MTR; ++mt) {
      if (mt >= mts) continue;
#pragma unroll
      for (int eh = 0; eh < 2; ++eh) {
        const int r = mt * 16 + 8 * eh + g;
        const float z0 = acc[mt][q][2 * eh] += b0;
        const float z1 = acc[mt][q][2 * eh + 1] += b1;
        const bool m = tl.mm[r] > 0.f;
        *reinterpret_cast<float2*>(ys + (size_t)r * ldy + c) =
            make_float2(m ? fmaxf(fmaf(z0, a20, c20), 0.f) : kNeg,
                        m ? fmaxf(fmaf(z1, a21, c21), 0.f) : kNeg);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < taken * a.h2; i += kThreads) {
    const int ct = i / a.h2, c = i - ct * a.h2;
    const int r0 = tl.start[ct], r1 = r0 + tl.count[ct];
    float mx = kNeg;
    for (int r = r0; r < r1; ++r) mx = fmaxf(mx, ys[(size_t)r * ldy + c]);
    float cnt = 0.f;
    for (int r = r0; r < r1; ++r)
      if (tl.mm[r] > 0.f && ys[(size_t)r * ldy + c] >= mx) cnt += 1.f;
    const float share = dsc[i] / fmaxf(cnt, 1.f);
    for (int r = r0; r < r1; ++r) {
      float* y = ys + (size_t)r * ldy + c;
      *y = tl.mm[r] > 0.f && *y >= mx ? share : 0.f;
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    if (q >= nq) continue;
    const int c = (w + kWarps * q) * 8 + 2 * t;  // the columns c, c + 1 go together
    const float2 a2 = *reinterpret_cast<const float2*>(x2 + kA * a.h2 + c);
    const float2 c2 = *reinterpret_cast<const float2*>(x2 + kC * a.h2 + c);
    const float2 m2 = *reinterpret_cast<const float2*>(x2 + kMean * a.h2 + c);
    const float2 inv2 = *reinterpret_cast<const float2*>(x2 + kInv * a.h2 + c);
    const float2 ca = *reinterpret_cast<const float2*>(x2 + kCorrA * a.h2 + c);
    const float2 cb = *reinterpret_cast<const float2*>(x2 + kCorrB * a.h2 + c);
#pragma unroll
    for (int mt = 0; mt < MTR; ++mt) {
      if (mt >= mts) continue;
#pragma unroll
      for (int eh = 0; eh < 2; ++eh) {
        const int r = mt * 16 + 8 * eh + g;
        float& v0 = acc[mt][q][2 * eh];
        float& v1 = acc[mt][q][2 * eh + 1];
        if (!tl.ok[r]) {
          if (PASS != 1) v0 = v1 = 0.f;
          continue;
        }
        const float2 dh2 = *reinterpret_cast<const float2*>(ys + (size_t)r * ldy + c);
        const float z0 = v0, z1 = v1;
        const float dy0 = fmaf(z0, a2.x, c2.x) > 0.f ? dh2.x : 0.f;
        const float dy1 = fmaf(z1, a2.y, c2.y) > 0.f ? dh2.y : 0.f;
        const float yh0 = (z0 - m2.x) * inv2.x, yh1 = (z1 - m2.y) * inv2.y;
        if (PASS == 1) {
          sa[q][0] += dy0;
          sb[q][0] += dy0 * yh0;
          sa[q][1] += dy1;
          sb[q][1] += dy1 * yh1;
        } else {
          const float mf = tl.mf[r];
          const float d0 = a2.x * (dy0 - mf * (ca.x + yh0 * cb.x));
          const float d1 = a2.y * (dy1 - mf * (ca.y + yh1 * cb.y));
          if (PASS == 2) {
            sa[q][0] += d0;
            sa[q][1] += d1;
          }
          v0 = d0;
          v1 = d1;
        }
      }
    }
  }
  if (PASS != 1) __syncthreads();  // every thread is done reading ys: dz goes over it
}

// Store a warp's [rows, h] fragments, rounded to T, to a [rows][ld] buffer.
template <typename T, int MTR, int NQ>
__device__ __forceinline__ void store_frags(const float (&acc)[MTR][NQ][4], int h, T* out,
                                            int ld, int mts) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nq = warp_nq(h, w);
#pragma unroll
  for (int mt = 0; mt < MTR; ++mt)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      if (mt < mts && q < nq) {
        const int c = (w + kWarps * q) * 8 + 2 * t;
        const int r = mt * 16 + g;
        gemm::store2<T>(out + (size_t)r * ld + c, acc[mt][q][0], acc[mt][q][1]);
        gemm::store2<T>(out + (size_t)(r + 8) * ld + c, acc[mt][q][2], acc[mt][q][3]);
      }
}

// acc[mt][q] += round(h1)^T round(dz) over the tile's rows at dW2's m16 row
// tiles mi0 + mt, mt < mtn, and the warp's n8 column tiles w + 8 q, q < nq:
// A = h1 read transposed from [rows][h1] (load_a_col), B = the warp's dz
// columns.
template <typename T, int MT, int NQ>
__device__ __forceinline__ void dw2_tiles(float (&acc)[MT][NQ][4], const T* hs, int ldh,
                                          const T* dz, int ldz, int rows, int mi0, int mtn,
                                          int nq) {
  const int w = threadIdx.x >> 5;
  for (int k = 0; k < rows; k += 16) {
    typename Mma<T>::B bf[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      if (q < nq) Mma<T>::load_b(bf[q], dz, ldz, k, (w + kWarps * q) * 8);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (mt < mtn) {
        typename Mma<T>::A af;
        Mma<T>::load_a_col(af, hs, ldh, (mi0 + mt) * 16, k);
        mma_step<T>(acc[mt], af, bf, nq);
      }
    }
  }
}

// The block's dW2 partial out [h1, h2] at those tiles: = acc, or += acc with
// `add`.
template <int MT, int NQ>
__device__ __forceinline__ void dw2_store(const float (&acc)[MT][NQ][4], float* out, int h2,
                                          int mi0, int mtn, int nq, bool add) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      if (mt < mtn && q < nq) {
        float2* p0 = reinterpret_cast<float2*>(out + (size_t)((mi0 + mt) * 16 + g) * h2 +
                                               (w + kWarps * q) * 8 + 2 * t);
        float2* p1 = reinterpret_cast<float2*>(reinterpret_cast<float*>(p0) + (size_t)8 * h2);
        float2 v0 = make_float2(acc[mt][q][0], acc[mt][q][1]);
        float2 v1 = make_float2(acc[mt][q][2], acc[mt][q][3]);
        if (add) {
          const float2 o0 = *p0, o1 = *p1;
          v0 = make_float2(o0.x + v0.x, o0.y + v0.y);
          v1 = make_float2(o1.x + v1.x, o1.y + v1.y);
        }
        *p0 = v0;
        *p1 = v1;
      }
    }
}

template <int MT, int NQ>
__device__ __forceinline__ void zero_dw2(float (&acc)[MT][NQ][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][q][e] = 0.f;
}

// ----------------------------------------------------------- the kernel

// PASS 1: part0 [blocks, 2, h2] (sum dy2, sum dy2 * yhat2).
// PASS 2: part0 [blocks, 2, h1] (sum dy1, sum dy1 * yhat1), part1 [blocks,
//         h1, h2] dW2, part2 [blocks, h2] db2.
// PASS 3: part0 du [n, p, h1], part1 dsv [n, s, h1].
// Sums over the block's rows are per-thread partials in a fixed order,
// reduced across lanes by a fixed butterfly; every output element has one
// owning thread. No atomics: two runs give bit-equal results.
// Blocks per SM the register budget aims at: a narrow level's kernels hold
// fewer accumulators, so more of its blocks hide each other's latency.
template <int PASS, int NQ>
struct MinBlocks {
  static constexpr int v = NQ == 1 ? 2 : (NQ == 2 && PASS != 2) ? 2 : 1;
};

template <typename T, bool ROUND_E, int PASS, int NQ>
__global__ void __launch_bounds__(kThreads, MinBlocks<PASS, NQ>::v)
    sa_bwd_kernel(Args a, float* part0, float* part1, float* part2) {
  using W = Width<NQ>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem sm;
  bwd_layout(PASS, a.p, a.h1, a.h2, a.rows, a.resident, (int)sizeof(T), smem_raw, &sm);
  constexpr int pad = Pad<T>::v;
  const int ldh = a.h1 + pad, ldz = a.h2 + pad, ldd = a.h1 + 4;
  const int hm = a.h1 > a.h2 ? a.h1 : a.h2;
  T* hs = reinterpret_cast<T*>(sm.hs);
  T* dzs = reinterpret_cast<T*>(PASS == 3 ? sm.hs : sm.dz);  // pass 3: over the pool's values
  float* des = reinterpret_cast<float*>(sm.hs);  // pass 3: de in place of h1
  // The pool's filled values: over h1 (dead after z) in passes 1 and 3,
  // over dz (written after the pool) in pass 2.
  float* ys = reinterpret_cast<float*>(PASS == 2 ? sm.dz : sm.hs);
  const T* w2g = static_cast<const T*>(a.w2);
  const T* w2tg = static_cast<const T*>(a.w2t);
  T* ring = reinterpret_cast<T*>(sm.w);
  const T* w2s = nullptr;   // resident W2 [h1][h2 + pad]
  const T* w2ts = nullptr;  // resident W2^T [h2][h1 + pad]
  if (a.resident) {
    T* ws = reinterpret_cast<T*>(sm.w);
    T* wts = ws + (size_t)a.h1 * (a.h2 + pad);
    stage_rows(ws, a.h2 + pad, w2g, a.h2, 0, a.h1);
    stage_rows(wts, a.h1 + pad, w2tg, a.h1, 0, a.h2);
    gemm::cp_async_commit();
    gemm::cp_async_wait<0>();
    __syncthreads();
    w2s = ws;
    w2ts = wts;
  }
  const int ldb_z = a.resident ? a.h2 + pad : hm + pad;
  const int ldb_d = a.resident ? a.h1 + pad : hm + pad;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int mts = a.rows / 16;
  const int nq2 = warp_nq(a.h2, w), nq1 = warp_nq(a.h1, w);
  // dW2: held in registers over all of the block's tiles (W::hold), else
  // added into the block's partial in chunks of W::MT row tiles after every
  // tile.
  const int mi_all = a.h1 / 16;
  float* pw = PASS == 2 ? part1 + (size_t)blockIdx.x * a.h1 * a.h2 : nullptr;
  float wacc[W::MT][NQ][4];
  zero_dw2(wacc);
  if (PASS == 2 && !W::hold)
    for (int mi0 = 0; mi0 < mi_all; mi0 += W::MT)
      dw2_store(wacc, pw, a.h2, mi0, min(W::MT, mi_all - mi0), nq2, false);
  float sa2[NQ][2], sb2[NQ][2], sa1[NQ][2], sb1[NQ][2];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int hc = 0; hc < 2; ++hc) sa2[q][hc] = sb2[q][hc] = sa1[q][hc] = sb1[q][hc] = 0.f;
  const float* x1 = a.aux1;

  for (int n = blockIdx.x; n < a.n; n += gridDim.x) {
    if (PASS == 3) {
      for (int i = threadIdx.x; i < a.p * a.h1; i += kThreads) sm.du[i] = 0.f;
      __syncthreads();
    }
    for (int s0 = 0; s0 < a.s;) {
      const int taken = load_tile<T, ROUND_E, true>(a, n, s0, sm.tl, hs, ldh, sm.dsc);
      float acc[W::MTR][NQ][4];
      product(acc, hs, ldh, a.h1, w2s, w2g, a.h2, ring, ldb_z, mts, nq2);
      pool_dz<PASS>(a, sm.tl, sm.dsc, ys, acc, sa2, sb2);
      if (PASS >= 2) {
        store_frags(acc, a.h2, dzs, ldz, mts);
        __syncthreads();  // dz complete; every warp is done with h1 . W2
        product(acc, dzs, ldz, a.h2, w2ts, w2tg, a.h1, ring, ldb_d, mts, nq1);
        if (PASS == 3) __syncthreads();  // every warp is done reading dz: de goes over it
        // dy1 = dh1 * [e * a1 + c1 > 0] on kept rows; PASS 2 sums it, PASS 3
        // forms de = a1 * (dy1 - mf * (A1/n + yhat1 * B1/n)). A thread's two
        // adjacent columns c, c + 1 go together (e from u and sv as float2).
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          if (q >= nq1) continue;
          const int c = (w + kWarps * q) * 8 + 2 * t;
          const float2 a1 = *reinterpret_cast<const float2*>(x1 + kA * a.h1 + c);
          const float2 c1 = *reinterpret_cast<const float2*>(x1 + kC * a.h1 + c);
          const float2 m1 = *reinterpret_cast<const float2*>(x1 + kMean * a.h1 + c);
          const float2 inv1 = *reinterpret_cast<const float2*>(x1 + kInv * a.h1 + c);
          const float2 ca = *reinterpret_cast<const float2*>(x1 + kCorrA * a.h1 + c);
          const float2 cb = *reinterpret_cast<const float2*>(x1 + kCorrB * a.h1 + c);
#pragma unroll
          for (int mt = 0; mt < W::MTR; ++mt)
#pragma unroll
            for (int eh = 0; eh < 2; ++eh) {
              const int r = mt * 16 + g + 8 * eh;
              if (mt >= mts) continue;
              float de0 = 0.f, de1 = 0.f;
              if (sm.tl.ok[r]) {
                const float2 uv = *reinterpret_cast<const float2*>(
                    a.u + ((size_t)n * a.p + sm.tl.idx[r]) * a.h1 + c);
                const float2 sv = *reinterpret_cast<const float2*>(
                    a.sv + ((size_t)n * a.s + sm.tl.sid[sm.tl.ctr[r]]) * a.h1 + c);
                float e0 = round_to<T>(uv.x) - sv.x, e1 = round_to<T>(uv.y) - sv.y;
                if (ROUND_E) {
                  e0 = bf16_round(e0);
                  e1 = bf16_round(e1);
                }
                const float d0 = fmaf(e0, a1.x, c1.x) > 0.f ? acc[mt][q][2 * eh] : 0.f;
                const float d1 = fmaf(e1, a1.y, c1.y) > 0.f ? acc[mt][q][2 * eh + 1] : 0.f;
                const float y0 = (e0 - m1.x) * inv1.x, y1 = (e1 - m1.y) * inv1.y;
                if (PASS == 2) {
                  sa1[q][0] += d0;
                  sb1[q][0] += d0 * y0;
                  sa1[q][1] += d1;
                  sb1[q][1] += d1 * y1;
                } else {
                  const float mf = sm.tl.mf[r];
                  de0 = a1.x * (d0 - mf * (ca.x + y0 * cb.x));
                  de1 = a1.y * (d1 - mf * (ca.y + y1 * cb.y));
                }
              }
              if (PASS == 3)
                *reinterpret_cast<float2*>(des + (size_t)r * ldd + c) = make_float2(de0, de1);
            }
        }
      }
      if (PASS == 2) {
        if (W::hold) {
          dw2_tiles(wacc, hs, ldh, dzs, ldz, a.rows, 0, mi_all, nq2);
        } else {
          for (int mi0 = 0; mi0 < mi_all; mi0 += W::MT) {
            const int mtn = min(W::MT, mi_all - mi0);
            zero_dw2(wacc);
            dw2_tiles(wacc, hs, ldh, dzs, ldz, a.rows, mi0, mtn, nq2);
            dw2_store(wacc, pw, a.h2, mi0, mtn, nq2, true);
          }
        }
      }
      if (PASS == 3) {
        __syncthreads();  // de complete
        // du[idx[r]] += round(de[r]) in row order: thread (slot, c) owns the
        // points i with i mod slots == slot (tl.slot[r]) in column c.
        const int slots = kThreads / a.h1;
        if (threadIdx.x < slots * a.h1) {
          const int c = threadIdx.x % a.h1, slot = threadIdx.x / a.h1;
          for (int r = 0; r < a.rows; ++r)
            if (sm.tl.slot[r] == slot)
              sm.du[(size_t)sm.tl.idx[r] * a.h1 + c] += round_to<T>(des[(size_t)r * ldd + c]);
        }
        for (int q = threadIdx.x; q < taken * a.h1; q += kThreads) {
          const int ct = q / a.h1, c = q - ct * a.h1;
          const int r0 = sm.tl.start[ct], r1 = r0 + sm.tl.count[ct];
          float sum = 0.f;
          for (int r = r0; r < r1; ++r) sum += des[(size_t)r * ldd + c];
          part1[((size_t)n * a.s + sm.tl.sid[ct]) * a.h1 + c] = -sum;
        }
      }
      s0 += taken;
      __syncthreads();  // the next tile overwrites the row data, h1 and dz
    }
    if (PASS == 3) {
      for (int i = threadIdx.x; i < a.p * a.h1; i += kThreads)
        part0[(size_t)n * a.p * a.h1 + i] = sm.du[i];
      __syncthreads();
    }
  }
  if (PASS == 1)
    write_column_sums(sa2, sb2, a.h2, part0 + (size_t)blockIdx.x * 2 * a.h2,
                      part0 + (size_t)blockIdx.x * 2 * a.h2 + a.h2);
  if (PASS == 2) {
    write_column_sums(sa1, sb1, a.h1, part0 + (size_t)blockIdx.x * 2 * a.h1,
                      part0 + (size_t)blockIdx.x * 2 * a.h1 + a.h1);
    write_column_sums(sa2, sb2, a.h2, part2 + (size_t)blockIdx.x * a.h2, nullptr);
    if (W::hold) dw2_store(wacc, pw, a.h2, 0, mi_all, nq2, false);
  }
}

using KernelFn = void (*)(Args, float*, float*, float*);

template <typename T, bool ROUND_E, int NQ>
KernelFn kernel_of_nq(int pass) {
  if (pass == 1) return sa_bwd_kernel<T, ROUND_E, 1, NQ>;
  if (pass == 2) return sa_bwd_kernel<T, ROUND_E, 2, NQ>;
  if (pass == 3) return sa_bwd_kernel<T, ROUND_E, 3, NQ>;
  return nullptr;
}

// The pass's kernel of the level's width class.
template <typename T, bool ROUND_E>
KernelFn kernel_of(int pass, int h1, int h2) {
  const int hm = h1 > h2 ? h1 : h2;
  if (hm <= 64) return kernel_of_nq<T, ROUND_E, 1>(pass);
  if (hm <= 128) return kernel_of_nq<T, ROUND_E, 2>(pass);
  return kernel_of_nq<T, ROUND_E, 4>(pass);
}

// The launch (occ null) or the occupancy query (blocks of the pass's kernel
// one SM holds -> *occ) of one pass.
template <typename T, bool ROUND_E>
int run(int pass, const Args& a, float* o0, float* o1, float* o2, int blocks,
        cudaStream_t st, int* occ) {
  const KernelFn kern = kernel_of<T, ROUND_E>(pass, a.h1, a.h2);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_layout(pass, a.p, a.h1, a.h2, a.rows, a.resident, (int)sizeof(T),
                                 nullptr, nullptr);
  return launch(kern, smem, blocks, st, occ, a, o0, o1, o2);
}

// The C entry of one instantiation (sa_train_bwd.cu, sa_train_e_bwd.cu).
template <bool ROUND_E>
int entry(int pass, const void* u, const void* sv, const void* idx, const void* mm,
          const void* mf, const void* w2, const void* w2t, const void* aux1,
          const void* aux2, const void* dout, void* out0, void* out1, void* out2, int n,
          int p, int s, int k, int h1, int h2, int rows, int resident, int blocks, int dtype,
          void* stream, int* occ) {
  const Args a{static_cast<const float*>(u), static_cast<const float*>(sv),
               static_cast<const int*>(idx), static_cast<const uint8_t*>(mm),
               static_cast<const uint8_t*>(mf), w2, w2t,
               static_cast<const float*>(aux1), static_cast<const float*>(aux2),
               static_cast<const float*>(dout), n, p, s, k, h1, h2, rows, resident};
  if (check_args(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o0 = static_cast<float*>(out0);
  float* o1 = static_cast<float*>(out1);
  float* o2 = static_cast<float*>(out2);
  if (dtype == kBF16) return run<__nv_bfloat16, ROUND_E>(pass, a, o0, o1, o2, blocks, st, occ);
  return run<float, ROUND_E>(pass, a, o0, o1, o2, blocks, st, occ);
}

}  // namespace sat
}  // namespace t2l