// Backward passes of the training set-abstraction level on the tensor
// cores (the design note is in sa_train_bwd.cu), each templated on the
// compute dtype T and on ROUND_E: false takes e as recomputed from u and sv
// (sa_train_bwd.cu), true rounds it to bf16 as the forward did, the token
// "e" (sa_train_e_bwd.cu).
//
// A block of 256 threads (8 warps) walks whole clouds (n = blockIdx.x, +
// gridDim.x, ...) and each cloud's centers in tiles of R edge rows (R a
// multiple of 16, K <= R <= 128, <= 64 where a width exceeds 128): the
// kept edges of up to kMaxCenters consecutive centers, packed; a center's
// edges never straddle two tiles. The three products of a tile are
// mma.sync products with f32 sums:
//   z   [R, H2] = round(h1) [R, H1] . round(W2) [H1, H2]
//   dh1 [R, H1] = round(dz) [R, H2] . round(W2)^T [H2, H1]
//   dW2 [H1, H2] += round(h1)^T [H1, R] . round(dz) [R, H2]
// bf16: m16n8k16 on the bf16 operands. f32: three m16n8k8 TF32 products
// per step on the hi / lo split of each operand (hi = the operand rounded
// to TF32, lo = the remainder rounded to TF32; lo.hi + hi.lo + hi.hi), so
// no f32 operand is rounded to TF32 alone.
// For z and dh1 warp w owns every row of the tile and the n8 column tiles
// w, w + 8, w + 16, w + 24 of the output: all of a column sits in one warp,
// so the column sums reduce across its lanes. For dW2 warp w owns the same
// n8 column tiles of [H1, H2] (its own dz columns) over every row.
// Shared memory holds round(h1) and round(dz) of the tile in T, the
// neighbour max's f32 values, and W2 and W2^T in T, either whole for the
// whole kernel ("resident") or streamed in chunks of kKC k-rows through a
// two-stage cp.async ring per product; the host picks the layout
// (bwd_layout sizes it). e is recomputed from u and sv where dh1's ReLU
// needs it.
#pragma once

#include "common.cuh"
#include "gemm_tc.cuh"

namespace t2l {
namespace sab {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxNQ = 4;                // n8 tiles of a warp: widths <= 8 x 8 x 4
constexpr int kMaxCenters = 16;          // centers of a tile
constexpr int kKC = 32;                  // k rows of a streamed W2 chunk
// The kernels are instantiated per width class NQ (the n8 tiles a warp owns
// in the level's wider layer: widths <= 64, 128, 256 for NQ = 1, 2, 4), so
// that a narrow level's accumulators take fewer registers. dW2 [H1, H2]: a
// warp owns its dz columns (n8 tiles w + 8 q) over every row; it holds MT
// m16 row tiles at once. NQ <= 2 holds all rows (H1 <= 128) over all of
// the block's tiles; NQ = 4 adds chunks of MT = 4 row tiles into the
// block's partial after each tile.
template <int NQ>
struct Width {
  static constexpr int MTR = NQ == 4 ? 4 : 8;  // m16 row tiles of a tile: R <= 16 MTR
  static constexpr int MT = NQ == 2 ? 8 : 4;   // dW2 m16 row tiles a warp holds
  static constexpr bool hold = NQ <= 2;
};

// The largest tile height of a level (its width class's 16 MTR).
__host__ __device__ inline int max_rows(int h1, int h2) {
  return (h1 > h2 ? h1 : h2) > 128 ? 64 : 128;
}

constexpr float kNeg = -1.0e30f;         // fill of masked-out neighbour slots

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
  int n, p, s, k, h1, h2, rows, resident;
};

// Row padding of the shared buffers in elements: f32 rows 4 words off a
// multiple of 32 (fragment loads fall on distinct banks), bf16 rows 16
// bytes off (ldmatrix's eight rows on distinct banks).
template <typename T>
struct Pad;
template <>
struct Pad<float> { static constexpr int v = 4; };
template <>
struct Pad<__nv_bfloat16> { static constexpr int v = 8; };

// ---------------------------------------------------------- mma fragments

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(gemm::smem_u32(p)));
}

// x rounded to TF32 (10 mantissa bits, ties away from zero), as
// cvt.rna.tf32.f32 rounds a finite value, in two integer operations (the
// conversion instruction issues at a fraction of their rate).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// d += a (16x8, row) . b (8x8, col), TF32 operands, f32 sums. Not volatile:
// the compiler may interleave the products of independent accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x16, row) . b (16x8, col), bf16 operands, f32 sums (as
// gemm::mma_bf16, not volatile).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k16 step of a product: the A fragments of an m16 x k16 block and the
// B fragments of a k16 x n8 block, from shared memory. A is row-major
// [m][k] (load_a_row) or stored transposed, [k][m] (load_a_col); B is
// [k][n].
template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  using E = __nv_bfloat16;
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };
  __device__ static void load_a_row(A& f, const E* a, int lda, int m0, int k0) {
    const int lane = threadIdx.x & 31;
    gemm::ldmatrix_x4(f.r, a + (size_t)(m0 + (lane & 15)) * lda + k0 + (lane >> 4) * 8);
  }
  __device__ static void load_a_col(A& f, const E* s, int lds, int m0, int k0) {
    const int lane = threadIdx.x & 31;
    gemm::ldmatrix_x4_trans(
        f.r, s + (size_t)(k0 + (lane & 7) + ((lane >> 4) & 1) * 8) * lds + m0 +
                 ((lane >> 3) & 1) * 8);
  }
  __device__ static void load_b(B& f, const E* b, int ldb, int k0, int n0) {
    const int lane = threadIdx.x & 31;
    ldmatrix_x2_trans(f.r, b + (size_t)(k0 + (lane & 15)) * ldb + n0);
  }
  static constexpr int kSteps = 1, kTerms = 1;
  __device__ static void mma(float (&d)[4], const A& a, const B& b, int, int) {
    mma_bf16(d, a.r, b.r[0], b.r[1]);
  }
};

template <>
struct Mma<float> {
  // Two k8 halves; per half a0..a3 (b0, b1), each split into hi and lo.
  struct A { uint32_t hi[8], lo[8]; };
  struct B { uint32_t hi[4], lo[4]; };
  __device__ static void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = tf32_rna(x);
    lo = tf32_rna(x - __uint_as_float(hi));
  }
  __device__ static void load_a_row(A& f, const float* a, int lda, int m0, int k0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const float* r0 = a + (size_t)(m0 + g) * lda + k0 + t;
    const float* r1 = r0 + (size_t)8 * lda;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      split(r0[8 * h], f.hi[4 * h + 0], f.lo[4 * h + 0]);
      split(r1[8 * h], f.hi[4 * h + 1], f.lo[4 * h + 1]);
      split(r0[8 * h + 4], f.hi[4 * h + 2], f.lo[4 * h + 2]);
      split(r1[8 * h + 4], f.hi[4 * h + 3], f.lo[4 * h + 3]);
    }
  }
  __device__ static void load_a_col(A& f, const float* s, int lds, int m0, int k0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* c0 = s + (size_t)(k0 + 8 * h + t) * lds + m0 + g;
      const float* c1 = c0 + (size_t)4 * lds;
      split(c0[0], f.hi[4 * h + 0], f.lo[4 * h + 0]);
      split(c0[8], f.hi[4 * h + 1], f.lo[4 * h + 1]);
      split(c1[0], f.hi[4 * h + 2], f.lo[4 * h + 2]);
      split(c1[8], f.hi[4 * h + 3], f.lo[4 * h + 3]);
    }
  }
  __device__ static void load_b(B& f, const float* b, int ldb, int k0, int n0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* p = b + (size_t)(k0 + 8 * h + t) * ldb + n0 + g;
      split(p[0], f.hi[2 * h], f.lo[2 * h]);
      split(p[(size_t)4 * ldb], f.hi[2 * h + 1], f.lo[2 * h + 1]);
    }
  }
  // Step h (a k8 half), term i: lo.hi, hi.lo, hi.hi (the small terms
  // first). The callers sum a step's three terms into a zeroed f32 partial
  // and add that to the accumulator: the tensor core's additions truncate,
  // so a long sum kept in its accumulator drifts by far more than one of
  // FP32 FMAs; a step's partial does not. The callers run each term over
  // every accumulator before the next, so consecutive products are
  // independent.
  static constexpr int kSteps = 2, kTerms = 3;
  __device__ static void mma(float (&d)[4], const A& a, const B& b, int h, int term) {
    const uint32_t* av = term == 0 ? a.lo + 4 * h : a.hi + 4 * h;
    const uint32_t* bv = term == 1 ? b.lo + 2 * h : b.hi + 2 * h;
    mma_tf32(d, av, bv[0], bv[1]);
  }
};

// acc[q] += A . B[q] for q < nq over one k16 step: bf16 into the
// accumulators, f32 by steps through zeroed partials (Mma<float>).
template <typename T, int NQ>
__device__ __forceinline__ void mma_step(float (&acc)[NQ][4], const typename Mma<T>::A& af,
                                         const typename Mma<T>::B (&bf)[NQ], int nq) {
  if (Mma<T>::kSteps == 1) {
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      if (q < nq) Mma<T>::mma(acc[q], af, bf[q], 0, 0);
    return;
  }
#pragma unroll
  for (int h = 0; h < Mma<T>::kSteps; ++h) {
    float part[NQ][4];
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[q][e] = 0.f;
#pragma unroll
    for (int term = 0; term < Mma<T>::kTerms; ++term)
#pragma unroll
      for (int q = 0; q < NQ; ++q)
        if (q < nq) Mma<T>::mma(part[q], af, bf[q], h, term);
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] += part[q][e];
  }
}

// The n8 column tiles of a width-h output that warp w owns (w, w + 8, ...).
__device__ __forceinline__ int warp_nq(int h, int w) {
  const int tiles = h / 8;
  return w < tiles ? (tiles - w + kWarps - 1) / kWarps : 0;
}

template <int MTR, int NQ>
__device__ __forceinline__ void zero(float (&acc)[MTR][NQ][4]) {
#pragma unroll
  for (int mt = 0; mt < MTR; ++mt)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][q][e] = 0.f;
}

// acc[mt][q] += A[rows of m16 tile mt][ka0 .. ka0 + kc) . B[0 .. kc)[n8 tile
// w + 8 q]: A row-major in shared memory, B a [kc][ldb] block in shared
// memory.
template <typename T, int MTR, int NQ>
__device__ __forceinline__ void warp_gemm(float (&acc)[MTR][NQ][4], const T* a, int lda,
                                          int ka0, const T* b, int ldb, int kc, int mts,
                                          int nq) {
  const int w = threadIdx.x >> 5;
  for (int k = 0; k < kc; k += 16) {
    typename Mma<T>::B bf[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      if (q < nq) Mma<T>::load_b(bf[q], b, ldb, k, (w + kWarps * q) * 8);
#pragma unroll
    for (int mt = 0; mt < MTR; ++mt) {
      if (mt < mts) {
        typename Mma<T>::A af;
        Mma<T>::load_a_row(af, a, lda, mt * 16, ka0 + k);
        mma_step<T>(acc[mt], af, bf, nq);
      }
    }
  }
}

// Copy rows [k0, k0 + kc) of a [kdim][n] matrix in device memory to a
// [kc][ld] buffer in shared memory (cp.async, 16 bytes a thread a step).
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src, int n, int k0,
                                           int kc) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = n / V;
  for (int i = threadIdx.x; i < kc * per_row; i += kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * V;
    gemm::cp_async16(dst + (size_t)r * ld + c, src + (size_t)(k0 + r) * n + c, 16);
  }
}

// acc = A [rows, kdim] . B [kdim, n]: B from `res` (resident in shared
// memory, row stride ldb) or, where res is null, streamed from `src` in
// device memory through the two-stage ring (row stride ldb). Every thread
// of the block calls it (the ring's barriers).
template <typename T, int MTR, int NQ>
__device__ __forceinline__ void product(float (&acc)[MTR][NQ][4], const T* a, int lda,
                                        int kdim, const T* res, const T* src, int n,
                                        T* ring, int ldb, int mts, int nq) {
  zero(acc);
  if (res != nullptr) {
    warp_gemm(acc, a, lda, 0, res, ldb, kdim, mts, nq);
    return;
  }
  const int chunks = kdim / kKC;
  const size_t stage = (size_t)kKC * ldb;
  stage_rows(ring, ldb, src, n, 0, kKC);
  gemm::cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) stage_rows(ring + ((c + 1) & 1) * stage, ldb, src, n, (c + 1) * kKC, kKC);
    gemm::cp_async_commit();
    gemm::cp_async_wait<1>();
    __syncthreads();  // chunk c has landed, from every thread's copies
    warp_gemm(acc, a, lda, c * kKC, ring + (c & 1) * stage, ldb, kKC, mts, nq);
    __syncthreads();  // every warp is done with stage c & 1 before it is refilled
  }
}

// ------------------------------------------------------------ the tile

struct Tile {
  int* idx;       // [rows] neighbour index
  float* mm;      // [rows] 0/1
  float* mf;      // [rows] 0/1
  int* ok;        // [rows] 1 = a kept edge (else padding)
  int* ctr;       // [rows] the row's center in the tile
  int* slot;      // [rows] idx mod (256 / h1) on kept rows, else -1 (the du scatter)
  int* sid;       // [kMaxCenters] the center's index in the cloud
  int* start;     // [kMaxCenters] its first row
  int* count;     // [kMaxCenters] its rows
  int* cidx;      // [kMaxCenters][64] the candidates' neighbour indices
  unsigned* mmask;  // [2 kMaxCenters] the candidates' mm slots (K <= 64)
  unsigned* fmask;  // [2 kMaxCenters] the candidates' mf slots
  int* num;       // centers in the tile
};

// Shared-memory carve-up of a pass; es is sizeof(T). Buffers are 16-byte
// aligned. The host sizes a launch through the same function.
struct Smem {
  unsigned char* w;   // resident: W2 [h1][h2 + pad], W2^T [h2][h1 + pad]; else the ring
  unsigned char* hs;  // round(h1) [rows][h1 + pad]; passes 1, 3: then the pool's f32
                      // [rows][h2 + 8]; pass 3: then round(dz), then de f32 [rows][h1 + 4]
  unsigned char* dz;  // pass 2: the pool's f32 [rows][h2 + 8], then round(dz)
                      // [rows][h2 + pad]
  float* du;          // [p][h1] (pass 3)
  float* dsc;         // [kMaxCenters][h2] the tile's dout rows
  Tile tl;
};

__host__ __device__ inline unsigned char* take(unsigned char* base, size_t* off,
                                                size_t bytes) {
  unsigned char* ptr = base ? base + *off : nullptr;
  *off = align16(*off + bytes);
  return ptr;
}

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
  sm.tl.idx = reinterpret_cast<int*>(take(base, &off, sizeof(int) * rows));
  sm.tl.mm = reinterpret_cast<float*>(take(base, &off, sizeof(float) * rows));
  sm.tl.mf = reinterpret_cast<float*>(take(base, &off, sizeof(float) * rows));
  sm.tl.ok = reinterpret_cast<int*>(take(base, &off, sizeof(int) * rows));
  sm.tl.ctr = reinterpret_cast<int*>(take(base, &off, sizeof(int) * rows));
  sm.tl.slot = reinterpret_cast<int*>(take(base, &off, sizeof(int) * rows));
  sm.tl.sid = reinterpret_cast<int*>(take(base, &off, sizeof(int) * kMaxCenters));
  sm.tl.start = reinterpret_cast<int*>(take(base, &off, sizeof(int) * kMaxCenters));
  sm.tl.count = reinterpret_cast<int*>(take(base, &off, sizeof(int) * kMaxCenters));
  sm.tl.cidx = reinterpret_cast<int*>(take(base, &off, sizeof(int) * kMaxCenters * 64));
  sm.tl.mmask =
      reinterpret_cast<unsigned*>(take(base, &off, sizeof(unsigned) * 2 * kMaxCenters));
  sm.tl.fmask =
      reinterpret_cast<unsigned*>(take(base, &off, sizeof(unsigned) * 2 * kMaxCenters));
  sm.tl.num = reinterpret_cast<int*>(take(base, &off, sizeof(int)));
  if (out != nullptr) *out = sm;
  return off;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const float (&v)[4]);
template <>
__device__ __forceinline__ void store4<float>(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v[0], v[1]);
  q[1] = __floats2bfloat162_rn(v[2], v[3]);
}

// Pack the kept edges (valid in either mask) of the centers s0, s0 + 1, ...
// of cloud n into a tile. One round of loads from device memory takes the
// kMaxCenters candidate centers: each warp ballots two candidates' mm and mf
// slots into bit masks and keeps their neighbour indices, and the block
// copies their dout rows (dsc [kMaxCenters][h2]). Thread 0 then takes whole
// centers while their edges fit, the row data follow from shared memory,
// and hs = round(relu(e * a1 + c1)) in T (0 on padding rows) from u and sv;
// ROUND_E rounds e to bf16 (the token "e"). Returns the centers taken (at
// least one).
template <typename T, bool ROUND_E>
__device__ int load_tile(const Args& a, int n, int s0, const Tile& tl, T* hs, int ldh,
                         float* dsc) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cand = min(kMaxCenters, a.s - s0);
  for (int i = threadIdx.x; i < cand * a.h2; i += kThreads)
    dsc[i] = a.dout[((size_t)n * a.s + s0) * a.h2 + i];
#pragma unroll
  for (int j = 0; j < kMaxCenters / kWarps; ++j) {
    const int t = w * (kMaxCenters / kWarps) + j;
    bool m0 = false, m1 = false, f0 = false, f1 = false;
    if (t < cand) {
      const size_t base = ((size_t)n * a.s + s0 + t) * a.k;
      if (lane < a.k) {
        m0 = a.mm[base + lane];
        f0 = a.mf[base + lane];
        tl.cidx[t * 64 + lane] = a.idx[base + lane];
      }
      if (lane + 32 < a.k) {
        m1 = a.mm[base + lane + 32];
        f1 = a.mf[base + lane + 32];
        tl.cidx[t * 64 + lane + 32] = a.idx[base + lane + 32];
      }
    }
    const unsigned mlo = __ballot_sync(0xffffffffu, m0), mhi = __ballot_sync(0xffffffffu, m1);
    const unsigned flo = __ballot_sync(0xffffffffu, f0), fhi = __ballot_sync(0xffffffffu, f1);
    if (lane == 0) {
      tl.mmask[2 * t] = mlo;
      tl.mmask[2 * t + 1] = mhi;
      tl.fmask[2 * t] = flo;
      tl.fmask[2 * t + 1] = fhi;
    }
  }
  for (int r = threadIdx.x; r < a.rows; r += kThreads) {
    tl.ok[r] = 0;
    tl.idx[r] = 0;
    tl.mm[r] = 0.f;
    tl.mf[r] = 0.f;
    tl.ctr[r] = 0;
    tl.slot[r] = -1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int used = 0, taken = 0;
    for (int t = 0; t < cand; ++t) {
      const int cnt = __popc(tl.mmask[2 * t] | tl.fmask[2 * t]) +
                      __popc(tl.mmask[2 * t + 1] | tl.fmask[2 * t + 1]);
      if (used + cnt > a.rows) break;
      tl.sid[t] = s0 + t;
      tl.start[t] = used;
      tl.count[t] = cnt;
      used += cnt;
      ++taken;
    }
    *tl.num = taken;
  }
  __syncthreads();
  const int taken = *tl.num;
  const int slots = kThreads / a.h1;
  for (int q = threadIdx.x; q < taken * a.k; q += kThreads) {
    const int t = q / a.k, kk = q - t * a.k;
    const int word = 2 * t + (kk >> 5), bit = kk & 31;
    const unsigned mw = tl.mmask[word], fw = tl.fmask[word];
    if (!(((mw | fw) >> bit) & 1u)) continue;
    const unsigned below = (1u << bit) - 1u;
    int before = __popc((mw | fw) & below);
    if (kk >= 32) before += __popc(tl.mmask[2 * t] | tl.fmask[2 * t]);
    const int r = tl.start[t] + before;
    const int pi = tl.cidx[t * 64 + kk];
    tl.ok[r] = 1;
    tl.ctr[r] = t;
    tl.idx[r] = pi;
    tl.slot[r] = pi % slots;
    tl.mm[r] = (mw >> bit) & 1u ? 1.f : 0.f;
    tl.mf[r] = (fw >> bit) & 1u ? 1.f : 0.f;
  }
  __syncthreads();
  const float* a1 = a.aux1 + kA * a.h1;
  const float* c1 = a.aux1 + kC * a.h1;
  const int q4 = a.h1 / 4;
  for (int i = threadIdx.x; i < a.rows * q4; i += kThreads) {
    const int r = i / q4, c = (i - r * q4) * 4;
    float h[4] = {0.f, 0.f, 0.f, 0.f};
    if (tl.ok[r]) {
      const float4 uv = *reinterpret_cast<const float4*>(
          a.u + ((size_t)n * a.p + tl.idx[r]) * a.h1 + c);
      const float4 sv = *reinterpret_cast<const float4*>(
          a.sv + ((size_t)n * a.s + tl.sid[tl.ctr[r]]) * a.h1 + c);
      const float uu[4] = {uv.x, uv.y, uv.z, uv.w}, ss[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float e = round_to<T>(uu[j]) - ss[j];
        if (ROUND_E) e = bf16_round(e);
        h[j] = round_to<T>(fmaxf(fmaf(e, a1[c + j], c1[c + j]), 0.f));
      }
    }
    store4<T>(hs + (size_t)r * ldh + c, h);
  }
  __syncthreads();
  return taken;
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

// The warp's column sums of (sa, sb) over its lanes' rows, written by the
// lanes of row group 0 to out_a[c] and out_b[c] (out_b may be null).
template <int NQ>
__device__ __forceinline__ void write_column_sums(const float (&sa)[NQ][2],
                                                  const float (&sb)[NQ][2], int h,
                                                  float* out_a, float* out_b) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int nq = warp_nq(h, w);
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int hc = 0; hc < 2; ++hc) {
      float x = sa[q][hc], y = sb[q][hc];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        x += __shfl_xor_sync(0xffffffffu, x, off);
        y += __shfl_xor_sync(0xffffffffu, y, off);
      }
      if (q < nq && lane < 4) {
        const int c = (w + kWarps * q) * 8 + 2 * t + hc;
        out_a[c] = x;
        if (out_b != nullptr) out_b[c] = y;
      }
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
      const int taken = load_tile<T, ROUND_E>(a, n, s0, sm.tl, hs, ldh, sm.dsc);
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
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (occ != nullptr)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, kern, kThreads, smem);
  kern<<<blocks, kThreads, smem, st>>>(a, o0, o1, o2);
  return (int)cudaGetLastError();
}

// What the kernels rely on: R a multiple of 16 in [K, max_rows], K in [1, 64],
// widths multiples of 32 in [32, 256]. 0 where it holds.
inline int check_args(const Args& a) {
  if (a.rows % 16 || a.rows < a.k || a.rows > max_rows(a.h1, a.h2) || a.k < 1 || a.k > 64)
    return 1;
  const int hmax = kWarps * 8 * kMaxNQ;
  if (a.h1 % 32 || a.h1 < 32 || a.h1 > hmax) return 1;
  if (a.h2 % 32 || a.h2 < 32 || a.h2 > hmax) return 1;
  return 0;
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

}  // namespace sab
}  // namespace t2l
