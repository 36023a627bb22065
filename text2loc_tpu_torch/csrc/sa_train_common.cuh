// Tile machinery of the training set-abstraction forward (sa_train_fwd.cu,
// sa_train_e_fwd.cu): one SA level's edge pipeline, recomputed per tile of
// edges in shared memory. (The backward has its own tensor-core tiles in
// sa_train_bwd.cuh.)
//
// Edge pipeline (text2loc_tpu/ops/pallas_sa_train.py, module docstring):
//   e[r]  = round(u[n, idx[r]]) - sv[n, s(r)]           [H1]
//   h1[r] = round(relu(e * a1 + c1))                    [H1]
//   z[r]  = h1 @ round(W2) + b2                         [H2]
//   y2    = z * a2 + c2,  h2 = relu(y2)
// where round() goes through the compute dtype T (the identity for f32) at
// the places the TPU kernel rounds, and every sum is taken in f32.
//
// A block owns whole point clouds (n = blockIdx.x, + gridDim.x, ...) and
// walks each cloud's centers in tiles of rows = 8 x rpt edge rows (rpt <=
// 8). A tile holds the edges of up to kMaxCenters consecutive centers that
// are valid in either mask, packed; an edge valid in neither contributes
// nothing to any output or gradient (it is outside the statistics and the
// neighbour max, so its dz, dh1 and de are 0), and is skipped. A center's
// edges never straddle two tiles (rows >= K). The 256 threads are 8 warps;
// warp g owns rows [g*rpt, (g+1)*rpt) of a tile and lane l owns columns l,
// l+32, ... (at most CW <= 8), so a [rows, H] result sits in registers as
// acc[rpt][CW].
// Sums over edges are per-block partials, reduced by a second kernel in a
// fixed order: two runs give bit-equal results (no float atomics).
//
// The bf16 edge cache of the JAX kernel (cache_dtype=bfloat16, token "e")
// rounds e to bf16 where it is formed and takes everything after of the
// rounded value. Here every pass recomputes e and rounds it the same way
// (load_tile's ROUND_E), so the six passes see the same e as through a
// cache, and no [N, S*K, H1] tensor is written to device memory.
#pragma once

#include "common.cuh"

namespace t2l {
namespace sa {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // row groups of a tile
constexpr int kMaxRpt = 8;             // rows per thread: tile rows <= 64
constexpr int kMaxCw = 8;              // columns per lane: H <= 256
// Kernels are instantiated for CW = 2, 4, 8 columns per lane (the
// level's wider layer, H <= 64, 128, 256): the accumulators are
// [rpt][CW] registers, so narrow levels keep more blocks per SM.
constexpr float kNeg = -1.0e30f;       // fill of masked-out neighbour slots
constexpr int kMaxCenters = 8;         // centers per tile

// Rows of aux1 [8, H1] / aux2 [8, H2] (the TPU kernel's layout).
enum Aux : int { kA = 0, kC = 1, kMean = 2, kInv = 3, kCorrA = 4, kCorrB = 5, kBias = 6 };

struct Args {
  const float* u;       // [n, p, h1] f32
  const float* sv;      // [n, s, h1] f32
  const int* idx;       // [n, s, k] int32
  const uint8_t* mm;    // [n, s, k] bool: neighbour-max validity
  const uint8_t* mf;    // [n, s, k] bool: BN-statistics validity
  const void* w2;       // [h1, h2] compute dtype
  const void* w2t;      // [h2, h1] compute dtype (W2 transposed)
  const float* aux1;    // [8, h1]
  const float* aux2;    // [8, h2]
  const float* dout;    // [n, s, h2] f32
  int n, p, s, k, h1, h2, rpt;
};

// Per-tile row data in shared memory.
struct Rows {
  int* idx;     // [rows] neighbour index
  float* mm;    // [rows] 0/1
  float* mf;    // [rows] 0/1
  int* ok;      // [rows] 1 = a real edge of this tile (else padding)
  int* ctr;     // [rows] the row's center in the tile (index into Centers)
};

// The tile's centers: center t < *num is center sid[t] of the cloud, its
// packed edges are rows start[t] .. start[t] + count[t] - 1, and mask[2t],
// mask[2t + 1] flag its kept slots (K <= 64).
struct Centers {
  int* sid;
  int* start;
  int* count;
  unsigned* mask;
  int* num;
};

__device__ __forceinline__ int tile_rows(const Args& a) { return kWarps * a.rpt; }

// Pack the kept edges of the centers s0, s0 + 1, ... of cloud n into a tile
// (warp 0 takes whole centers while their edges fit), then fill the row
// data, and e (and h1 when hs != nullptr) into [rows][h1] row-major
// buffers; ROUND_E rounds e to bf16 (the token "e"). Returns the number of
// centers taken (at least one).
template <typename T, bool ROUND_E>
__device__ __forceinline__ int load_tile(const Args& a, int n, int s0, Rows rw, Centers cs,
                                         float* es, float* hs) {
  const int rows = tile_rows(a);
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int used = 0, taken = 0;
    for (int s = s0; s < a.s && taken < kMaxCenters; ++s) {
      const size_t base = ((size_t)n * a.s + s) * a.k;
      const bool k0 = lane < a.k && (a.mm[base + lane] | a.mf[base + lane]);
      const bool k1 = lane + 32 < a.k && (a.mm[base + lane + 32] | a.mf[base + lane + 32]);
      const unsigned lo = __ballot_sync(0xffffffffu, k0);
      const unsigned hi = __ballot_sync(0xffffffffu, k1);
      const int cnt = __popc(lo) + __popc(hi);
      if (used + cnt > rows) break;
      if (lane == 0) {
        cs.sid[taken] = s;
        cs.start[taken] = used;
        cs.count[taken] = cnt;
        cs.mask[2 * taken] = lo;
        cs.mask[2 * taken + 1] = hi;
      }
      used += cnt;
      ++taken;
    }
    if (lane == 0) *cs.num = taken;
  }
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    rw.ok[r] = 0;
    rw.idx[r] = 0;
    rw.mm[r] = 0.f;
    rw.mf[r] = 0.f;
    rw.ctr[r] = 0;
  }
  __syncthreads();
  const int taken = *cs.num;
  for (int q = threadIdx.x; q < taken * a.k; q += kThreads) {
    const int t = q / a.k, kk = q - t * a.k;
    const unsigned lo = cs.mask[2 * t], hi = cs.mask[2 * t + 1];
    const bool kept = kk < 32 ? (lo >> kk) & 1u : (hi >> (kk - 32)) & 1u;
    if (!kept) continue;
    const int before = kk < 32 ? __popc(lo & ((1u << kk) - 1u))
                               : __popc(lo) + __popc(hi & ((1u << (kk - 32)) - 1u));
    const int r = cs.start[t] + before;
    const size_t e_off = ((size_t)n * a.s + cs.sid[t]) * a.k + kk;
    rw.ok[r] = 1;
    rw.ctr[r] = t;
    rw.idx[r] = a.idx[e_off];
    rw.mm[r] = a.mm[e_off] ? 1.f : 0.f;
    rw.mf[r] = a.mf[e_off] ? 1.f : 0.f;
  }
  __syncthreads();
  const float* a1 = a.aux1 + kA * a.h1;
  const float* c1 = a.aux1 + kC * a.h1;
  for (int i = threadIdx.x; i < rows * a.h1; i += kThreads) {
    const int r = i / a.h1, c = i - r * a.h1;
    float e = 0.f;
    if (rw.ok[r]) {
      const int s = cs.sid[rw.ctr[r]];
      e = round_to<T>(a.u[((size_t)n * a.p + rw.idx[r]) * a.h1 + c]) -
          a.sv[((size_t)n * a.s + s) * a.h1 + c];
      if (ROUND_E) e = __bfloat162float(__float2bfloat16_rn(e));
    }
    es[i] = e;
    if (hs != nullptr) hs[i] = round_to<T>(fmaxf(fmaf(e, a1[c], c1[c]), 0.f));
  }
  __syncthreads();
  return taken;
}

// acc[i][j] = sum_k A[row0 + i][k] * B[k][lane + 32 j] for i < rpt, j < cw:
// A is a [rows][lda] f32 buffer in shared memory (broadcast float4 loads:
// the warp shares its rows), B a [kdim][ldb] row-major matrix in device
// memory in the compute dtype (coalesced across the warp's lanes, cached in
// L1/L2). kdim is a multiple of 4. FP32 FMAs in a fixed order.
template <int CW, typename Tw>
__device__ __forceinline__ void tile_gemm(float (&acc)[kMaxRpt][CW], const float* A,
                                          int lda, int kdim, const Tw* __restrict__ B,
                                          int ldb, int row0, int rpt, int cw) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kMaxRpt; ++i)
#pragma unroll
    for (int j = 0; j < CW; ++j) acc[i][j] = 0.f;
  for (int k = 0; k < kdim; k += 4) {
    float b[4][CW];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < CW; ++j)
        b[kk][j] = j < cw ? to_f(B[(size_t)(k + kk) * ldb + lane + 32 * j]) : 0.f;
#pragma unroll
    for (int i = 0; i < kMaxRpt; ++i) {
      if (i < rpt) {
        const float4 av = *reinterpret_cast<const float4*>(A + (size_t)(row0 + i) * lda + k);
#pragma unroll
        for (int j = 0; j < CW; ++j) {
          if (j < cw) {
            float v = acc[i][j];
            v = fmaf(av.x, b[0][j], v);
            v = fmaf(av.y, b[1][j], v);
            v = fmaf(av.z, b[2][j], v);
            v = fmaf(av.w, b[3][j], v);
            acc[i][j] = v;
          }
        }
      }
    }
  }
}

// z = h1 @ W2 + b2 for the thread's rows and columns.
template <typename T, int CW>
__device__ __forceinline__ void tile_z(const Args& a, const float* hs,
                                       float (&acc)[kMaxRpt][CW]) {
  const int g = threadIdx.x >> 5, lane = threadIdx.x & 31;
  tile_gemm(acc, hs, a.h1, a.h1, static_cast<const T*>(a.w2), a.h2, g * a.rpt, a.rpt,
            a.h2 / 32);
  const float* b2 = a.aux2 + kBias * a.h2;
#pragma unroll
  for (int i = 0; i < kMaxRpt; ++i)
#pragma unroll
    for (int j = 0; j < CW; ++j)
      if (i < a.rpt && j < a.h2 / 32) acc[i][j] += b2[lane + 32 * j];
}

// Neighbour max of one tile: ys [rows][h2] holds the filled values
// (mm ? relu(y2) : kNeg). For each center t of the tile and column c: mx =
// the max over its edges, cnt = max(#edges with mm and filled >= mx, 1)
// (ties share the gradient evenly), any = whether an edge is valid.
__device__ __forceinline__ void tile_pool(const Args& a, const Rows& rw, const Centers& cs,
                                          const float* ys, float* mx_s, float* cnt_s,
                                          float* any_s) {
  const int taken = *cs.num;
  for (int q = threadIdx.x; q < taken * a.h2; q += kThreads) {
    const int t = q / a.h2, c = q - t * a.h2;
    const int r0 = cs.start[t], r1 = r0 + cs.count[t];
    float m = kNeg, any = 0.f;
    for (int r = r0; r < r1; ++r) {
      m = fmaxf(m, ys[(size_t)r * a.h2 + c]);
      any = fmaxf(any, rw.mm[r]);
    }
    float cnt = 0.f;
    for (int r = r0; r < r1; ++r)
      if (rw.mm[r] > 0.f && ys[(size_t)r * a.h2 + c] >= m) cnt += 1.f;
    mx_s[q] = m;
    cnt_s[q] = fmaxf(cnt, 1.f);
    if (any_s != nullptr) any_s[q] = any;
  }
  __syncthreads();
}

// Write the block's per-column sums (each lane's columns l + 32 j, summed
// over the 8 warps in order) to out[0 .. h): red is an 8 x h scratch.
template <int CW>
__device__ __forceinline__ void block_column_sums(const float (&v)[CW], int h, float* red,
                                                  float* out) {
  const int g = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < CW; ++j)
    if (j < h / 32) red[g * h + lane + 32 * j] = v[j];
  __syncthreads();
  for (int c = threadIdx.x; c < h; c += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w * h + c];
    out[c] = s;
  }
  __syncthreads();
}

// Shared-memory carve-up common to every pass (the host mirrors it in the
// t2l_sa_train_smem functions). Buffers are 16-byte aligned.
struct Smem {
  float* es;    // [rows][h1]
  float* hs;    // [rows][h1]
  float* ys;    // [rows][h2]
  float* mx;    // [ts][h2]
  float* cnt;   // [ts][h2]
  float* any;   // [ts][h2]
  float* red;   // [8][max(h1, h2)]
  float* du;    // [p][h1] (input-gradient pass only)
  Rows rw;
  Centers cs;
};

__host__ __device__ inline unsigned char* take(unsigned char* base, size_t* off,
                                                size_t bytes) {
  unsigned char* ptr = base ? base + *off : nullptr;
  *off = align16(*off + bytes);
  return ptr;
}

__host__ __device__ inline size_t smem_layout(int pass_du, int p, int k, int h1, int h2,
                                              int rpt, unsigned char* base, Smem* out) {
  const int rows = kWarps * rpt;
  const int ts = kMaxCenters;
  const int hm = h1 > h2 ? h1 : h2;
  size_t off = 0;
  Smem sm;
  sm.es = reinterpret_cast<float*>(take(base, &off, sizeof(float) * rows * h1));
  sm.hs = reinterpret_cast<float*>(take(base, &off, sizeof(float) * rows * h1));
  sm.ys = reinterpret_cast<float*>(take(base, &off, sizeof(float) * rows * h2));
  sm.mx = reinterpret_cast<float*>(take(base, &off, sizeof(float) * ts * h2));
  sm.cnt = reinterpret_cast<float*>(take(base, &off, sizeof(float) * ts * h2));
  sm.any = reinterpret_cast<float*>(take(base, &off, sizeof(float) * ts * h2));
  sm.red = reinterpret_cast<float*>(take(base, &off, sizeof(float) * kWarps * hm));
  sm.du = reinterpret_cast<float*>(take(base, &off, pass_du ? sizeof(float) * p * h1 : 0));
  sm.rw.idx = reinterpret_cast<int*>(take(base, &off, sizeof(int) * rows));
  sm.rw.mm = reinterpret_cast<float*>(take(base, &off, sizeof(float) * rows));
  sm.rw.mf = reinterpret_cast<float*>(take(base, &off, sizeof(float) * rows));
  sm.rw.ok = reinterpret_cast<int*>(take(base, &off, sizeof(int) * rows));
  sm.rw.ctr = reinterpret_cast<int*>(take(base, &off, sizeof(int) * rows));
  sm.cs.sid = reinterpret_cast<int*>(take(base, &off, sizeof(int) * kMaxCenters));
  sm.cs.start = reinterpret_cast<int*>(take(base, &off, sizeof(int) * kMaxCenters));
  sm.cs.count = reinterpret_cast<int*>(take(base, &off, sizeof(int) * kMaxCenters));
  sm.cs.mask =
      reinterpret_cast<unsigned*>(take(base, &off, sizeof(unsigned) * 2 * kMaxCenters));
  sm.cs.num = reinterpret_cast<int*>(take(base, &off, sizeof(int)));
  if (out != nullptr) *out = sm;
  return off;
}

__device__ __forceinline__ Smem carve(const Args& a, int pass_du) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem sm;
  smem_layout(pass_du, a.p, a.k, a.h1, a.h2, a.rpt, smem_raw, &sm);
  return sm;
}

// Launch helper: raise the dynamic shared-memory cap when needed.
template <typename... Ps>
inline int launch_pass(void (*kern)(Ps...), int blocks, size_t smem, cudaStream_t stream,
                       Ps... args) {
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<blocks, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace sa
}  // namespace t2l
