// Tile machinery of the training set-abstraction level's tensor-core
// kernels, shared by the forward (sa_train_fwd.cuh) and the backward
// (sa_train_bwd.cuh).
//
// A block of 256 threads (8 warps) walks whole clouds (n = blockIdx.x, +
// gridDim.x, ...) and each cloud's centers in tiles of R edge rows (R a
// multiple of 16, K <= R <= 128, <= 64 where a width exceeds 128): the
// edges valid in either mask of up to kMaxCenters consecutive centers,
// packed; a center's edges never straddle two tiles (load_tile). The
// products of a tile are mma.sync products with f32 sums (Mma, warp_gemm,
// product): bf16 m16n8k16 on the bf16 operands; f32 as three m16n8k8 TF32
// products per step on the hi / lo split of each operand (hi = the operand
// rounded to TF32, lo = the remainder rounded to TF32; lo.hi + hi.lo +
// hi.hi), so no f32 operand is rounded to TF32 alone. A warp w owns every
// row of a tile and the n8 column tiles w, w + 8, w + 16, w + 24 of an
// output: all of a column sits in one warp, so column sums reduce across
// its lanes (write_column_sums). W2 sits in shared memory for the whole
// kernel ("resident") or streams in chunks of kKC k-rows through a
// two-stage cp.async ring; the host picks the layout.
#pragma once

#include "common.cuh"
#include "gemm_tc.cuh"

namespace t2l {
namespace sat {

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
// BOUNDED: the matrix's rows are lds apart (n columns of a wider matrix),
// and rows at or past kvalid are filled with zeros.
template <typename T, bool BOUNDED = false>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src, int n, int k0,
                                           int kc, int lds = 0, int kvalid = 0) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = n / V;
  const int stride = BOUNDED ? lds : n;
  for (int i = threadIdx.x; i < kc * per_row; i += kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * V;
    const bool in = !BOUNDED || k0 + r < kvalid;
    gemm::cp_async16(dst + (size_t)r * ld + c, src + (size_t)(in ? k0 + r : 0) * stride + c,
                     in ? 16 : 0);
  }
}

// acc = A [rows, kdim] . B [kdim, n]: B from `res` (resident in shared
// memory, row stride ldb) or, where res is null, streamed from `src` in
// device memory through the two-stage ring (row stride ldb). Every thread
// of the block calls it (the ring's barriers). BOUNDED: src's rows are lds
// apart and its rows at or past kvalid read as zeros (stage_rows).
template <typename T, int MTR, int NQ, bool BOUNDED = false>
__device__ __forceinline__ void product(float (&acc)[MTR][NQ][4], const T* a, int lda,
                                        int kdim, const T* res, const T* src, int n,
                                        T* ring, int ldb, int mts, int nq, int lds = 0,
                                        int kvalid = 0) {
  zero(acc);
  if (res != nullptr) {
    warp_gemm(acc, a, lda, 0, res, ldb, kdim, mts, nq);
    return;
  }
  const int chunks = kdim / kKC;
  const size_t stage = (size_t)kKC * ldb;
  stage_rows<T, BOUNDED>(ring, ldb, src, n, 0, kKC, lds, kvalid);
  gemm::cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks)
      stage_rows<T, BOUNDED>(ring + ((c + 1) & 1) * stage, ldb, src, n, (c + 1) * kKC, kKC,
                             lds, kvalid);
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

// Shared-memory carve-up of a pass (fwd_layout, sa_train_fwd.cuh; bwd_layout,
// sa_train_bwd.cuh); es is sizeof(T). Buffers are 16-byte aligned. The host
// sizes a launch through the same functions. The forward takes w, hs and tl.
struct Smem {
  unsigned char* w;   // resident: W2 [h1][h2 + pad] (the backward: and W2^T [h2][h1 +
                      // pad]); else the ring
  unsigned char* hs;  // round(h1) [rows][h1 + pad]; backward passes 1, 3 and the forward's
                      // out pass: then the pool's f32 [rows][h2 + 8]; backward pass 3:
                      // then round(dz), then de f32 [rows][h1 + 4]
  unsigned char* dz;  // backward pass 2: the pool's f32 [rows][h2 + 8], then round(dz)
                      // [rows][h2 + pad]
  float* du;          // [p][h1] (backward pass 3)
  float* dsc;         // [kMaxCenters][h2] the tile's dout rows (backward)
  Tile tl;
};

__host__ __device__ inline unsigned char* take(unsigned char* base, size_t* off,
                                                size_t bytes) {
  unsigned char* ptr = base ? base + *off : nullptr;
  *off = align16(*off + bytes);
  return ptr;
}

// The tile's row and center data, carved after a pass's own buffers.
__host__ __device__ inline Tile take_tile(unsigned char* base, size_t* off, int rows) {
  Tile tl;
  tl.idx = reinterpret_cast<int*>(take(base, off, sizeof(int) * rows));
  tl.mm = reinterpret_cast<float*>(take(base, off, sizeof(float) * rows));
  tl.mf = reinterpret_cast<float*>(take(base, off, sizeof(float) * rows));
  tl.ok = reinterpret_cast<int*>(take(base, off, sizeof(int) * rows));
  tl.ctr = reinterpret_cast<int*>(take(base, off, sizeof(int) * rows));
  tl.slot = reinterpret_cast<int*>(take(base, off, sizeof(int) * rows));
  tl.sid = reinterpret_cast<int*>(take(base, off, sizeof(int) * kMaxCenters));
  tl.start = reinterpret_cast<int*>(take(base, off, sizeof(int) * kMaxCenters));
  tl.count = reinterpret_cast<int*>(take(base, off, sizeof(int) * kMaxCenters));
  tl.cidx = reinterpret_cast<int*>(take(base, off, sizeof(int) * kMaxCenters * 64));
  tl.mmask = reinterpret_cast<unsigned*>(take(base, off, sizeof(unsigned) * 2 * kMaxCenters));
  tl.fmask = reinterpret_cast<unsigned*>(take(base, off, sizeof(unsigned) * 2 * kMaxCenters));
  tl.num = reinterpret_cast<int*>(take(base, off, sizeof(int)));
  return tl;
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
// slots into bit masks and keeps their neighbour indices, and with DOUT (the
// backward) the block copies their dout rows (dsc [kMaxCenters][h2]).
// Thread 0 then takes whole centers while their edges fit, the row data
// follow from shared memory, and hs = round(relu(e * a1 + c1)) in T (0 on
// padding rows) from u and sv; ROUND_E rounds e to bf16 (the token "e").
// Returns the centers taken (at least one).
template <typename T, bool ROUND_E, bool DOUT>
__device__ int load_tile(const Args& a, int n, int s0, const Tile& tl, T* hs, int ldh,
                         float* dsc) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cand = min(kMaxCenters, a.s - s0);
  if (DOUT)
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

// The launch (occ null) or the occupancy query (blocks of the kernel one SM
// holds -> *occ) of a kernel with `smem` bytes of dynamic shared memory.
template <typename... Ps>
int launch(void (*kern)(Ps...), size_t smem, int blocks, cudaStream_t st, int* occ,
           Ps... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (occ != nullptr)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, kern, kThreads, smem);
  kern<<<blocks, kThreads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

// What the kernels rely on: K in [1, 64], widths multiples of 32 in [32,
// 256]; with tiles also R a multiple of 16 in [K, max_rows]. 0 where it
// holds.
inline int check_widths(const Args& a) {
  if (a.k < 1 || a.k > 64) return 1;
  const int hmax = kWarps * 8 * kMaxNQ;
  if (a.h1 % 32 || a.h1 < 32 || a.h1 > hmax) return 1;
  if (a.h2 % 32 || a.h2 < 32 || a.h2 > hmax) return 1;
  return 0;
}

inline int check_args(const Args& a) {
  if (a.rows % 16 || a.rows < a.k || a.rows > max_rows(a.h1, a.h2)) return 1;
  return check_widths(a);
}

}  // namespace sat
}  // namespace t2l
