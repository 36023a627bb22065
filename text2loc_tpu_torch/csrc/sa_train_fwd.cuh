// Training forward passes of one PointConv set-abstraction level with
// batch-statistic BatchNorm (the design note is in sa_train_fwd.cu), each
// templated on the compute dtype T and on ROUND_E: false takes e as
// recomputed from u and sv (sa_train_fwd.cu), true rounds it to bf16 in
// every pass, the token "e" (sa_train_e_fwd.cu).
//
// Edge pipeline (text2loc_tpu/ops/pallas_sa_train.py, module docstring):
//   e[r]  = round(u[n, idx[r]]) - sv[n, s(r)]           [H1]
//   h1[r] = round(relu(e * a1 + c1))                    [H1]
//   z[r]  = h1 . round(W2) + b2                         [H2]
//   y2    = z * a2 + c2,  out = max over maskm edges of relu(y2)
// where round() goes through T (the identity for f32) at the places the
// TPU kernel rounds, and every sum is taken in f32.
//
// Pass 1 (the BN1 sums of e over the maskf edges) has no product and walks
// each cloud's edges directly. Passes 2 (the BN2 sums of z) and 3 (the
// neighbour max) form z on the tensor cores on the tiles of
// sa_train_tiles.cuh, with the backward's products: the same rows give the
// same z bit for bit in both directions.
#pragma once

#include "sa_train_tiles.cuh"

namespace t2l {
namespace sat {

// Dynamic shared memory of a forward pass (pass 1: none, its sums sit in
// static shared memory): W2 [h1][h2 + pad] resident or the ring's two
// chunks, round(h1) [rows][h1 + pad] (pass 3: then the pool's f32 values
// [rows][h2 + 8] over it), and the tile's row data.
__host__ __device__ inline size_t fwd_layout(int pass, int h1, int h2, int rows,
                                             int resident, int es, unsigned char* base,
                                             Smem* out) {
  if (pass == 1) return 0;
  const int pad = es == 4 ? 4 : 8;
  size_t off = 0;
  Smem sm;
  const size_t w_elems = resident ? (size_t)h1 * (h2 + pad) : (size_t)2 * kKC * (h2 + pad);
  sm.w = take(base, &off, (size_t)es * w_elems);
  const size_t hs_bytes = (size_t)es * rows * (h1 + pad);
  const size_t ys_bytes = (size_t)4 * rows * (h2 + 8);
  sm.hs = take(base, &off, pass == 3 && ys_bytes > hs_bytes ? ys_bytes : hs_bytes);
  sm.dz = nullptr;
  sm.du = nullptr;
  sm.dsc = nullptr;
  sm.tl = take_tile(base, &off, rows);
  if (out != nullptr) *out = sm;
  return off;
}

// Pass 1: part [blocks, 2, h1] (sum e, sum e^2 over the block's maskf
// edges). Thread (slot, c) owns columns c .. c + 3 (float4 loads of u and
// sv) and the edges j = slot, slot + slots, ... of each of the block's
// clouds; the block sums its slots in order.
template <typename T, bool ROUND_E>
__global__ void __launch_bounds__(kThreads) sa_stats1_kernel(Args a, float* part) {
  __shared__ float red[2][kThreads * 4];
  const int q4 = a.h1 / 4, slots = kThreads / q4;
  const int slot = threadIdx.x / q4, c = (threadIdx.x - slot * q4) * 4;
  const int edges = a.s * a.k;
  float sum[4] = {0.f, 0.f, 0.f, 0.f}, sq[4] = {0.f, 0.f, 0.f, 0.f};
  if (slot < slots) {
    for (int n = blockIdx.x; n < a.n; n += gridDim.x) {
      const size_t e0 = (size_t)n * edges;
      for (int j = slot; j < edges; j += slots) {
        if (!a.mf[e0 + j]) continue;
        const float4 uv = *reinterpret_cast<const float4*>(
            a.u + ((size_t)n * a.p + a.idx[e0 + j]) * a.h1 + c);
        const float4 sv = *reinterpret_cast<const float4*>(
            a.sv + ((size_t)n * a.s + j / a.k) * a.h1 + c);
        const float uu[4] = {uv.x, uv.y, uv.z, uv.w}, ss[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float e = round_to<T>(uu[i]) - ss[i];
          if (ROUND_E) e = bf16_round(e);
          sum[i] += e;
          sq[i] += e * e;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    red[0][threadIdx.x * 4 + i] = sum[i];
    red[1][threadIdx.x * 4 + i] = sq[i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * a.h1; i += kThreads) {
    const int which = i / a.h1, col = i - which * a.h1;
    float v = 0.f;
    for (int sl = 0; sl < slots; ++sl) v += red[which][sl * q4 * 4 + col];
    part[(size_t)blockIdx.x * 2 * a.h1 + i] = v;
  }
}

// Blocks per SM the register budget aims at: the widest class holds 64 f32
// accumulators a thread, and its f32 product's hi / lo fragments beside
// them.
template <int NQ>
struct FwdMinBlocks {
  static constexpr int v = NQ == 4 ? 1 : 2;
};

// PASS 2: part [blocks, 2, h2] (sum z, sum z^2 over the block's maskf
// edges): per-thread sums over its fragments' rows in tile order, reduced
// across a warp's lanes by a fixed butterfly (write_column_sums).
// PASS 3: out [n, s, h2], the neighbour max of relu(y2) over each center's
// maskm edges, 0 on a center without one: each thread writes the filled
// values (mm ? relu(fmaf(z, a2, c2)) : kNeg) of its fragments to ys [rows][h2
// + 8] f32 over h1 (dead after z), then one thread per (center, column)
// takes the max over the center's rows.
template <typename T, bool ROUND_E, int PASS, int NQ>
__global__ void __launch_bounds__(kThreads, FwdMinBlocks<NQ>::v)
    sa_fwd_kernel(Args a, float* out) {
  using W = Width<NQ>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem sm;
  fwd_layout(PASS, a.h1, a.h2, a.rows, a.resident, (int)sizeof(T), smem_raw, &sm);
  constexpr int pad = Pad<T>::v;
  const int ldh = a.h1 + pad, ldb = a.h2 + pad, ldy = a.h2 + 8;
  T* hs = reinterpret_cast<T*>(sm.hs);
  float* ys = reinterpret_cast<float*>(sm.hs);
  const T* w2g = static_cast<const T*>(a.w2);
  T* ring = reinterpret_cast<T*>(sm.w);
  const T* w2s = nullptr;  // resident W2 [h1][h2 + pad]
  if (a.resident) {
    T* ws = reinterpret_cast<T*>(sm.w);
    stage_rows(ws, ldb, w2g, a.h2, 0, a.h1);
    gemm::cp_async_commit();
    gemm::cp_async_wait<0>();
    __syncthreads();
    w2s = ws;
  }
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int mts = a.rows / 16, nq = warp_nq(a.h2, w);
  const float* x2 = a.aux2;
  float sa[NQ][2], sb[NQ][2];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int hc = 0; hc < 2; ++hc) sa[q][hc] = sb[q][hc] = 0.f;

  for (int n = blockIdx.x; n < a.n; n += gridDim.x) {
    for (int s0 = 0; s0 < a.s;) {
      const int taken = load_tile<T, ROUND_E, false>(a, n, s0, sm.tl, hs, ldh, nullptr);
      float acc[W::MTR][NQ][4];
      product(acc, hs, ldh, a.h1, w2s, w2g, a.h2, ring, ldb, mts, nq);
      if (PASS == 3) __syncthreads();  // every warp is done reading h1: ys goes over it
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        if (q >= nq) continue;
        const int c = (w + kWarps * q) * 8 + 2 * t;  // the columns c, c + 1 go together
        const float2 b2 = *reinterpret_cast<const float2*>(x2 + kBias * a.h2 + c);
        const float2 a2 = *reinterpret_cast<const float2*>(x2 + kA * a.h2 + c);
        const float2 c2 = *reinterpret_cast<const float2*>(x2 + kC * a.h2 + c);
#pragma unroll
        for (int mt = 0; mt < W::MTR; ++mt) {
          if (mt >= mts) continue;
#pragma unroll
          for (int eh = 0; eh < 2; ++eh) {
            const int r = mt * 16 + 8 * eh + g;
            const float z0 = acc[mt][q][2 * eh] + b2.x;
            const float z1 = acc[mt][q][2 * eh + 1] + b2.y;
            if (PASS == 2) {
              if (sm.tl.mf[r] > 0.f) {
                sa[q][0] += z0;
                sb[q][0] += z0 * z0;
                sa[q][1] += z1;
                sb[q][1] += z1 * z1;
              }
            } else {
              const bool m = sm.tl.mm[r] > 0.f;
              *reinterpret_cast<float2*>(ys + (size_t)r * ldy + c) =
                  make_float2(m ? fmaxf(fmaf(z0, a2.x, c2.x), 0.f) : kNeg,
                              m ? fmaxf(fmaf(z1, a2.y, c2.y), 0.f) : kNeg);
            }
          }
        }
      }
      if (PASS == 3) {
        __syncthreads();  // the tile's filled values are complete
        for (int i = threadIdx.x; i < taken * a.h2; i += kThreads) {
          const int ct = i / a.h2, c = i - ct * a.h2;
          const int r0 = sm.tl.start[ct], r1 = r0 + sm.tl.count[ct];
          float mx = kNeg;
          for (int r = r0; r < r1; ++r) mx = fmaxf(mx, ys[(size_t)r * ldy + c]);
          out[((size_t)n * a.s + sm.tl.sid[ct]) * a.h2 + c] = fmaxf(mx, 0.f);
        }
      }
      s0 += taken;
      __syncthreads();  // the next tile overwrites the row data and h1
    }
  }
  if (PASS == 2)
    write_column_sums(sa, sb, a.h2, out + (size_t)blockIdx.x * 2 * a.h2,
                      out + (size_t)blockIdx.x * 2 * a.h2 + a.h2);
}

using FwdFn = void (*)(Args, float*);

template <typename T, bool ROUND_E, int NQ>
FwdFn fwd_kernel_of_nq(int pass) {
  if (pass == 1) return sa_stats1_kernel<T, ROUND_E>;
  if (pass == 2) return sa_fwd_kernel<T, ROUND_E, 2, NQ>;
  if (pass == 3) return sa_fwd_kernel<T, ROUND_E, 3, NQ>;
  return nullptr;
}

// The pass's kernel of the level's width class.
template <typename T, bool ROUND_E>
FwdFn fwd_kernel_of(int pass, int h1, int h2) {
  const int hm = h1 > h2 ? h1 : h2;
  if (hm <= 64) return fwd_kernel_of_nq<T, ROUND_E, 1>(pass);
  if (hm <= 128) return fwd_kernel_of_nq<T, ROUND_E, 2>(pass);
  return fwd_kernel_of_nq<T, ROUND_E, 4>(pass);
}

// The C entry of one instantiation (sa_train_fwd.cu, sa_train_e_fwd.cu):
// the launch of one pass, or with occ the occupancy query of its kernel.
template <bool ROUND_E>
int fwd_entry(int pass, const void* u, const void* sv, const void* idx, const void* mm,
              const void* mf, const void* w2, const void* aux1, const void* aux2, void* out,
              int n, int p, int s, int k, int h1, int h2, int rows, int resident, int blocks,
              int dtype, void* stream, int* occ) {
  const Args a{static_cast<const float*>(u), static_cast<const float*>(sv),
               static_cast<const int*>(idx), static_cast<const uint8_t*>(mm),
               static_cast<const uint8_t*>(mf), w2, nullptr,
               static_cast<const float*>(aux1), static_cast<const float*>(aux2), nullptr,
               n, p, s, k, h1, h2, rows, resident};
  if (pass < 1 || pass > 3 || (pass == 1 ? check_widths(a) : check_args(a)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const int es = dtype == kBF16 ? 2 : 4;
  const size_t smem = fwd_layout(pass, h1, h2, rows, resident, es, nullptr, nullptr);
  if (dtype == kBF16)
    return launch(fwd_kernel_of<__nv_bfloat16, ROUND_E>(pass, h1, h2), smem, blocks, st, occ,
                  a, o);
  return launch(fwd_kernel_of<float, ROUND_E>(pass, h1, h2), smem, blocks, st, occ, a, o);
}

}  // namespace sat
}  // namespace t2l
