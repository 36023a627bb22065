// The GEMMs of the tiled transformer-block chains on Hopper's warpgroup
// tensor cores: the attention chain's projections and out-projection
// (mha_tiled.cu) and the feed-forward chain's two products (ffn_tiled.cu):
//   C[M, N] = epilogue(A[M, K] . B[K, N]),
// A row-major (the activations), f32 sums, in two mainloops:
// - bf16: each B_j a row-major [K, width] weight (the port keeps weights
//   [in, out]) read through a TMA descriptor of its own, so that
//   self-attention's [Wq|Wk|Wv] is one product over N = 3D without packing
//   the weights; wgmma's transposed-B form reads them as they lie.
// - f32 (3xTF32): wgmma takes TF32 operands K-major only (no transposed B
//   below 16 bits), so B comes as B^T [N, K] in two copies, hi = B rounded
//   to TF32 and lo = (B - hi) rounded to TF32, which tf32_split.cu writes
//   per call from the weights as the caller holds them. A is split the same
//   way in registers: each thread loads its wgmma A fragments from the
//   swizzled tile and rounds them. Per k slice of 32 the products
//   lo.hi, hi.lo, hi.hi (small terms first, each over the slice's four k8
//   steps) sum into a partial that the first of them zeroes, and the
//   partial is added to the f32 accumulators by FP32 adds: the tensor
//   core's accumulation truncates, so a sum over all of K kept in its
//   accumulator drifts far more than one of FP32 adds (sa_train_tiles.cuh's
//   Mma<float> does the same per k8 step). No f32 operand is rounded to
//   TF32 alone.
//
// Design: a persistent grid of one block per SM walks the 128 x 128 output
// tiles row tile by row tile with the column tiles innermost, so that the
// blocks in flight share A's rows in L2 and every weight stays there. A
// block is three warpgroups: one producer thread keeps a ring of k-slices
// in flight by TMA against full / empty mbarriers (bf16: 6 stages of A 128
// x 64 and B 64 x 128; f32: 4 stages of A 128 x 32, B^T hi and lo 128 x
// 32, or 6 with tiles of 128 x 64 where those take fewer waves over the
// SMs, as at the wide chains' few hundred rows); two consumer warpgroups
// each own 64 rows of the tile and run wgmma.mma_async (bf16: m64n128k16
// from shared memory; f32: m64n128k8 or m64n64k8 with A from registers)
// from the ring, f32 accumulators in registers
// (setmaxnreg moves the producer's registers to them). The epilogue runs
// while the producer already fills the ring for the block's next tile: it
// passes each warp's accumulators through shared memory in 32-column
// chunks, so that consecutive lanes store consecutive columns (a warp
// storing bf16 pairs straight from the fragments writes half of each
// 32-byte sector it touches), with its inputs loaded a chunk ahead.
//
// Hazards:
// - bf16: B is row-major (N contiguous, "MN-major"), so the product takes
//   wgmma's transposed-B form (imm-trans-b = 1, 16-bit types only), and B's
//   shared descriptor is the MN-major one: 64 columns (128 bytes) per
//   swizzle atom, the 8-row k groups 1024 bytes apart (SBO), the 64-column
//   atoms one TMA box (64 x 64, 8 KB) apart (LBO).
// - f32: every tile is K-major with 32 f32 (128 bytes) a row; B^T's
//   descriptor is A's (8-row groups 1024 bytes apart), its k8 steps 32
//   bytes along the swizzled row. The A fragment of a k8 step (rows g,
//   g + 8 of the warp's 16, columns t, t + 4: mma.sync's m16n8k8 layout)
//   is read from the swizzled tile, 16-byte chunk c of row r at c ^ (r % 8):
//   the eight rows of a load hit eight distinct chunks, no bank conflict.
// - Every tile is loaded with 128-byte swizzling (CU_TENSOR_MAP_SWIZZLE_128B)
//   into 1024-byte aligned buffers, and every descriptor says the same
//   swizzle (layout type 1); A's k steps move the descriptor's start 32
//   bytes along the swizzled row, bf16 B's 2048 bytes (16 k rows).
// - M is ragged (a serve call has a few hundred rows): TMA fills rows of A
//   at or past M with zeros, and the epilogue stores none of them.
// - N is 3D, 2D or D (the attention chain), F or D (the feed-forward
//   chain, K = D or F): width must be a multiple of the column tile (128),
//   K of the slice (64 in bf16, 32 in f32); the blocks' D and F are
//   multiples of 128, as check_tiled asks. One bf16 B of width F = 4096 is
//   one tensor map over [K, F] (row stride F), whose 64 x 64 boxes the
//   producer takes at column n0 and n0 + 64.
//
// The accumulator fragment of wgmma m64n128 is mma.sync's m16n8 one per
// warp (rows 16 w + lane / 4 and + 8, columns 8 j + 2 (lane % 4) + {0, 1}).
// The epilogues compute their functions on pairs of columns.
//
// What bounds it on the H100 (published peaks, a 700 W power limit): at
// the intra stack's shape (25,344 rows, D = 1024) the self-attention
// projection is 159 GFLOP against 58 MB of activations in and out: 0.161
// ms at the bf16 tensor-core peak, operations; each feed-forward product
// (F = 4096) 213 GFLOP, 0.215 ms. In f32 the three TF32 products triple
// the work: 1.29 ms a feed-forward product at the TF32 peak of 495
// TFLOP/s (3.2 ms at the FP32 FMA peak of 67).
#pragma once

#include <cuda.h>
#include <dlfcn.h>
#include <stdint.h>

#include "common.cuh"
#include "gemm_tc.cuh"

// tf32_split.cu's entry: w0..w3 [k_j, n_j] f32 (nmat of them) -> hi, lo,
// the split of each W_j^T [n_j, k_j], one after another.
extern "C" int t2l_tf32_split_t(const void* w0, int k0, int n0, const void* w1, int k1, int n1,
                                const void* w2, int k2, int n2, const void* w3, int k3, int n3,
                                int nmat, void* hi, void* lo, void* stream);

namespace t2l {
namespace wg {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;         // rows of an output tile: two consumer warpgroups of 64
constexpr int kBN = 128;         // columns of an output tile
constexpr int kBK = 64;          // k of a ring slice: one 128-byte swizzle row of bf16
constexpr int kThreads = 384;    // producer warpgroup + two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kMaxB = 3;         // weights side by side: [Wq|Wk|Wv]
constexpr int kEpiCols = 32;     // columns of an epilogue chunk
constexpr int kEpiLd = 40;       // its f32 row stride: a half-warp's float2 stores, distinct banks
// B's MN-major descriptor: the 64-column swizzle atoms one 64 x 64 TMA box
// apart (leading byte offset), the 8-row k groups 1024 bytes apart (stride).
constexpr uint32_t kBLbo = kBK * 128, kBSbo = 1024;

constexpr int kStages = 6;
constexpr int kABytes = kBM * kBK * 2;   // 16 KB
constexpr int kBBytes = kBK * kBN * 2;   // one 8 KB box per 64 columns
constexpr int kStageBytes = kABytes + kBBytes;
// Each consumer warp's staging rows for the epilogue: 16 x kEpiCols f32.
constexpr int kEpiBytes = kConsumerWarps * 16 * kEpiLd * 4;
// 1024 bytes of slack to align the ring (TMA's 128-byte swizzle repeats
// every 1024 bytes), the ring, the staging rows, then the full and empty
// barriers.
constexpr size_t kSmem = 1024 + (size_t)kStages * kStageBytes + kEpiBytes + 2 * kStages * 8;

// The f32 (3xTF32) mainloop's ring for output tiles of 128 x BN (BN = 128
// or 64): stages of A [128][32] and B^T's hi and lo [BN][32] (one 128-byte
// swizzle row of f32 a tile row), as many as 192 KB hold (4 or 6).
namespace tf32 {
constexpr int kBK = 32;
constexpr int kABytes = kBM * kBK * 4;   // 16 KB
template <int BN>
struct Ring {
  static constexpr int kBBytes = BN * kBK * 4;
  static constexpr int kStageBytes = kABytes + 2 * kBBytes;
  static constexpr int kStages = 4 * (kABytes + 2 * kBM * kBK * 4) / kStageBytes;
  static constexpr size_t kSmem =
      1024 + (size_t)kStages * kStageBytes + kEpiBytes + 2 * kStages * 8;
};
}  // namespace tf32

struct BMaps {
  CUtensorMap b[kMaxB];
};

// ------------------------------------------------------------ PTX wrappers

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// A box of a 2-D tensor map (c0 the inner coordinate) into shared memory,
// completing `bytes` of the barrier's transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Shared-memory matrix descriptor with 128-byte swizzling: the start, the
// leading and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// The accumulators are written by the asynchronous products: keep the
// compiler from moving their reads (or writes) across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The A fragments of the f32 products are read by them: keep the compiler
// from computing them after the wgmma fence.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d[0 .. 64) = A (64x16, K-major, desc a) . B (16x128, N-major, desc b) + (scale_d ? d : 0).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[0 .. 64) = A (64x8, TF32 in registers: a[0..3] at rows g, g + 8 and
// columns t, t + 4 of each warp's 16 rows) . B (8x128, K-major, desc b) +
// (scale_d ? d : 0).
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// The same, m64n64k8: B 8x64 (d[0 .. 32)).
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// The epilogues, in two steps: load(r, col) reads what the pair of
// columns col, col + 1 of row r needs, store(r, col, v0, v1, in) writes the
// result from the f32 sums. The kernel loads a chunk's pairs (and the next
// chunk's) before it stores any: called pair by pair, as gemm_tc.cuh's
// functors are, each load waited behind the store before it (the compiler
// cannot tell the output from the inputs): a memory latency per pair.

// C = round_T((acc + bias_j[c - j width]) * (c < nscale ? scale : 1)) with
// j = c / width: the projection's epilogue over weights side by side, each
// with its own bias ([Wq|Wk|Wv] without packing them in bf16; their packed
// split in f32). The block is found by comparisons and the bias by
// selection, not by a division and an array indexed at run time.
template <typename T>
struct EpiBiasScaleBlocks {
  T* c;
  int ldc;
  const float* bias0;
  const float* bias1;
  const float* bias2;
  int width;
  int nscale;
  float scale;
  struct In {
    float b0, b1;
  };
  __device__ __forceinline__ In load(int, int col) const {
    const float* b = col >= 2 * width ? bias2 + (col - 2 * width)
                     : col >= width   ? bias1 + (col - width)
                                      : bias0 + col;
    return In{b[0], b[1]};
  }
  __device__ __forceinline__ void store(int r, int col, float v0, float v1, In in) const {
    const float s0 = col < nscale ? scale : 1.f, s1 = col + 1 < nscale ? scale : 1.f;
    gemm::store2<T>(c + (size_t)r * ldc + col, (v0 + in.b0) * s0, (v1 + in.b1) * s1);
  }
};

// C = round_T(relu(acc + bias[c])): the feed-forward hidden, relu'd in f32
// and then rounded (a NaN stays NaN, as jnp.maximum keeps it), as the
// fused block's gemm::EpiBiasRelu.
template <typename T>
struct EpiBiasRelu {
  T* c;
  int ldc;
  const float* bias;
  struct In {
    float b0, b1;
  };
  __device__ __forceinline__ In load(int, int col) const { return In{bias[col], bias[col + 1]}; }
  __device__ __forceinline__ void store(int r, int col, float v0, float v1, In in) const {
    v0 += in.b0;
    v1 += in.b1;
    gemm::store2<T>(c + (size_t)r * ldc + col, v0 < 0.f ? 0.f : v0, v1 < 0.f ? 0.f : v1);
  }
};

// C (f32) = (f32(res) + acc) + bias[c]: the residual sum before a
// LayerNorm, as the fused block's gemm::EpiResidual.
template <typename T>
struct EpiResidual {
  float* c;
  int ldc;
  const float* bias;
  const T* res;
  int ldr;
  struct In {
    float b0, b1, r0, r1;
  };
  __device__ __forceinline__ In load(int r, int col) const {
    const T* rr = res + (size_t)r * ldr + col;
    return In{bias[col], bias[col + 1], to_f(rr[0]), to_f(rr[1])};
  }
  __device__ __forceinline__ void store(int r, int col, float v0, float v1, In in) const {
    gemm::store2<float>(c + (size_t)r * ldc + col, (in.r0 + v0) + in.b0,
                        (in.r1 + v1) + in.b1);
  }
};

// ------------------------------------------------------------------ kernels

// A warp's 16 x BN outputs of a tile (rows row0.., columns n0..) from its
// accumulators: each 32-column chunk goes to the warp's staging rows stg as
// it lies in the fragments, then back a row segment per half-warp, so that
// consecutive lanes store consecutive columns; a lane loads the epilogue's
// inputs for the next chunk before it stores this one.
template <int BN, class Epi>
__device__ __forceinline__ void epilogue(const float (&acc)[BN / 2], float* stg, int row0,
                                         int n0, int M, int lane, const Epi& epi) {
  const int rr = lane >> 4, cc = 2 * (lane & 15);  // + 2 i rows
  typename Epi::In in[8], next[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (row0 + rr + 2 * i < M) in[i] = epi.load(row0 + rr + 2 * i, n0 + cc);
#pragma unroll
  for (int c0 = 0; c0 < BN / 8; c0 += kEpiCols / 8) {
    if (c0 + kEpiCols / 8 < BN / 8) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (row0 + rr + 2 * i < M)
          next[i] = epi.load(row0 + rr + 2 * i, n0 + 8 * c0 + kEpiCols + cc);
    }
#pragma unroll
    for (int j = 0; j < kEpiCols / 8; ++j) {
      float* p = stg + (lane >> 2) * kEpiLd + 8 * j + 2 * (lane & 3);
      *reinterpret_cast<float2*>(p) = make_float2(acc[4 * (c0 + j)], acc[4 * (c0 + j) + 1]);
      *reinterpret_cast<float2*>(p + 8 * kEpiLd) =
          make_float2(acc[4 * (c0 + j) + 2], acc[4 * (c0 + j) + 3]);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 v = *reinterpret_cast<const float2*>(stg + (rr + 2 * i) * kEpiLd + cc);
      if (row0 + rr + 2 * i < M) epi.store(row0 + rr + 2 * i, n0 + 8 * c0 + cc, v.x, v.y, in[i]);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 8; ++i) in[i] = next[i];
  }
}

template <class Epi>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                      const __grid_constant__ BMaps bmaps, int M, int K, int width, int ntn,
                      int tiles, Epi epi) {
  extern __shared__ __align__(1024) unsigned char wgmma_smem[];
  const uint32_t raw = gemm::smem_u32(wgmma_smem);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint32_t stage_out = ring + kStages * kStageBytes;
  const uint32_t full = stage_out + kEpiBytes, empty = full + kStages * 8;
  const int kts = K / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 0) {
    // Producer: one thread walks the block's tiles and their k slices.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / ntn) * kBM, n0 = (t % ntn) * kBN;
        const int j = n0 / width;
        const CUtensorMap* bmap = &bmaps.b[j];
        const int nb = n0 - j * width;
        for (int kt = 0; kt < kts; ++kt) {
          mbar_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t bar = full + 8 * stage;
          const uint32_t sa = ring + stage * kStageBytes, sb = sa + kABytes;
          mbar_expect_tx(bar, kStageBytes);
          tma_load(sa, &amap, bar, kt * kBK, m0);
#pragma unroll
          for (int c = 0; c < kBN / 64; ++c)
            tma_load(sb + c * 8192, bmap, bar, nb + 64 * c, kt * kBK);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // Consumers: warpgroup cw owns rows 64 cw .. 64 cw + 63 of each tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wgi - 1, lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
    float* stg = reinterpret_cast<float*>(wgmma_smem + (stage_out - raw)) +
                 (threadIdx.x / 32 - 4) * 16 * kEpiLd;
    float acc[kBN / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / ntn) * kBM, n0 = (t % ntn) * kBN;
      for (int kt = 0; kt < kts; ++kt) {
        mbar_wait(full + 8 * stage, phase);
        const uint32_t sa = ring + stage * kStageBytes + cw * (64 * 128);
        const uint32_t sb = ring + stage * kStageBytes + kABytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_m64n128k16(acc, desc_sw128(sa + 32 * kk, 16, 1024),
                           desc_sw128(sb + 2048 * kk, kBLbo, kBSbo), kt > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(empty + 8 * stage);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      epilogue<kBN>(acc, stg, m0 + cw * 64 + wq * 16, n0, M, lane, epi);
    }
  }
}

// C = epi(A . B) in f32 as 3xTF32 on output tiles of 128 x BN: A [M, K]
// f32 through amap (boxes 32 x 128), B^T's hi and lo [N, K] through bhi and
// blo (boxes 32 x BN), all K-major. The walk of the tiles, the ring's
// barriers and the epilogue are gemm_wgmma_kernel's.
template <int BN, class Epi>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_tf32x3_kernel(const __grid_constant__ CUtensorMap amap,
                       const __grid_constant__ CUtensorMap bhi,
                       const __grid_constant__ CUtensorMap blo, int M, int K, int ntn,
                       int tiles, Epi epi) {
  using R = tf32::Ring<BN>;
  constexpr int kStages32 = R::kStages, kBK32 = tf32::kBK;
  constexpr int kA = tf32::kABytes, kB = R::kBBytes, kStage = R::kStageBytes;
  extern __shared__ __align__(1024) unsigned char wgmma_smem[];
  const uint32_t raw = gemm::smem_u32(wgmma_smem);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint32_t stage_out = ring + kStages32 * kStage;
  const uint32_t full = stage_out + kEpiBytes, empty = full + kStages32 * 8;
  const int kts = K / kBK32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages32; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 0) {
    // Producer: one thread walks the block's tiles and their k slices.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / ntn) * kBM, n0 = (t % ntn) * BN;
        for (int kt = 0; kt < kts; ++kt) {
          mbar_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t bar = full + 8 * stage;
          const uint32_t sa = ring + stage * kStage;
          mbar_expect_tx(bar, kStage);
          tma_load(sa, &amap, bar, kt * kBK32, m0);
          tma_load(sa + kA, &bhi, bar, kt * kBK32, n0);
          tma_load(sa + kA + kB, &blo, bar, kt * kBK32, n0);
          if (++stage == kStages32) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // Consumers: warpgroup cw owns rows 64 cw .. 64 cw + 63 of each tile; a
    // thread's A fragment rows are 64 cw + 16 wq + g and + 8, both g modulo
    // 8: their 16-byte chunk c lies at c ^ g.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wgi - 1, lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2;
    float* stg = reinterpret_cast<float*>(wgmma_smem + (stage_out - raw)) +
                 (threadIdx.x / 32 - 4) * 16 * kEpiLd;
    const float* afrag = reinterpret_cast<const float*>(wgmma_smem + (ring - raw)) +
                         (64 * cw + 16 * wq + g) * kBK32 + (lane & 3);
    float acc[BN / 2], part[BN / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / ntn) * kBM, n0 = (t % ntn) * BN;
      for (int kt = 0; kt < kts; ++kt) {
        mbar_wait(full + 8 * stage, phase);
        // The slice's four k8 steps: A at columns 8 kk + t (chunk 2 kk) and
        // 8 kk + t + 4 (chunk 2 kk + 1), rows g and g + 8, split in
        // registers.
        const float* as = afrag + stage * (kStage / 4);
        uint32_t hi[kBK32 / 8][4], lo[kBK32 / 8][4];
#pragma unroll
        for (int kk = 0; kk < kBK32 / 8; ++kk) {
          const int c0 = ((2 * kk) ^ g) * 4, c1 = ((2 * kk + 1) ^ g) * 4;
          const float v[4] = {as[c0], as[8 * kBK32 + c0], as[c1], as[8 * kBK32 + c1]};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            hi[kk][e] = tf32_rna(v[e]);
            lo[kk][e] = tf32_rna(v[e] - __uint_as_float(hi[kk][e]));
          }
          fence_regs(hi[kk]);
          fence_regs(lo[kk]);
        }
        const uint32_t sb = ring + stage * kStage + kA, sl = sb + kB;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK32 / 8; ++kk)
          wgmma_tf32(part, lo[kk], desc_sw128(sb + 32 * kk, 16, 1024), kk > 0);
#pragma unroll
        for (int kk = 0; kk < kBK32 / 8; ++kk)
          wgmma_tf32(part, hi[kk], desc_sw128(sl + 32 * kk, 16, 1024), 1);
#pragma unroll
        for (int kk = 0; kk < kBK32 / 8; ++kk)
          wgmma_tf32(part, hi[kk], desc_sw128(sb + 32 * kk, 16, 1024), 1);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(part);
        if (lane == 0) mbar_arrive(empty + 8 * stage);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = kt > 0 ? acc[i] + part[i] : part[i];
        if (++stage == kStages32) {
          stage = 0;
          phase ^= 1;
        }
      }
      epilogue<BN>(acc, stg, m0 + cw * 64 + wq * 16, n0, M, lane, epi);
    }
  }
}

// ------------------------------------------------------------------ launch

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once in the libcuda.so.1
// that the CUDA runtime has loaded (nothing links against libcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = []() -> EncodeTiled {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h == nullptr ? nullptr
                        : reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A [rows, cols] bf16 row-major matrix (row stride ld elements) read in
// boxes of box_rows x 64 with 128-byte swizzling; reads past the matrix
// are zeros.
inline bool make_map(CUtensorMap* map, const bf16* p, int rows, int cols, int ld,
                     int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(p), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A [rows, cols] f32 row-major (row stride ld elements) read in boxes of
// box_rows x 32 (128 bytes) with 128-byte swizzling; reads past the matrix
// are zeros.
inline bool make_map(CUtensorMap* map, const float* p, int rows, int cols, int ld,
                     int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)tf32::kBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// C = epi(A . [B_0 | .. | B_{nb-1}]): A [M, K] (row stride lda), each B_j
// [K, width] (row stride ldb). Pointers 16-byte aligned, row strides
// multiples of 8 elements; K a multiple of 64 and width of 128.
template <class Epi>
cudaError_t run(const bf16* A, int lda, int M, int K, const bf16* const* B, int ldb, int nb,
                int width, const Epi& epi, cudaStream_t st) {
  if (M <= 0) return cudaSuccess;
  if (K % kBK || width % 128 || nb < 1 || nb > kMaxB || lda % 8 || ldb % 8 ||
      reinterpret_cast<uintptr_t>(A) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap amap;
  BMaps bmaps;
  if (!make_map(&amap, A, M, K, lda, kBM)) return cudaErrorInvalidValue;
  for (int j = 0; j < nb; ++j) {
    if (reinterpret_cast<uintptr_t>(B[j]) % 16 || !make_map(&bmaps.b[j], B[j], K, width, ldb, kBK))
      return cudaErrorInvalidValue;
  }
  for (int j = nb; j < kMaxB; ++j) bmaps.b[j] = bmaps.b[0];
  auto kern = gemm_wgmma_kernel<Epi>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (e != cudaSuccess) return e;
  const int ntn = nb * width / kBN, tiles = (M + kBM - 1) / kBM * ntn;
  const int grid = tiles < gemm::sm_count() ? tiles : gemm::sm_count();
  kern<<<grid, kThreads, kSmem, st>>>(amap, bmaps, M, K, width, ntn, tiles, epi);
  return cudaGetLastError();
}

template <int BN, class Epi>
cudaError_t launch_f32(const CUtensorMap& amap, const CUtensorMap& bhi, const CUtensorMap& blo,
                       int M, int K, int N, int sms, const Epi& epi, cudaStream_t st) {
  auto kern = gemm_tf32x3_kernel<BN, Epi>;
  constexpr size_t smem = tf32::Ring<BN>::kSmem;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int ntn = N / BN, tiles = (M + kBM - 1) / kBM * ntn;
  kern<<<tiles < sms ? tiles : sms, kThreads, smem, st>>>(amap, bhi, blo, M, K, ntn, tiles,
                                                          epi);
  return cudaGetLastError();
}

// C = epi(A . B) in f32 as 3xTF32: A [M, K] (row stride lda), B [K, N]
// given as its transposed split, bt_hi and bt_lo [N, K] (row stride ldbt,
// written by tf32_split.cu). Pointers 16-byte aligned, row strides
// multiples of 4 elements; K a multiple of 32 and N of 128. Output tiles of
// 128 x 64 where they take fewer tile-times than 128 x 128 (waves of
// tiles over the SMs, each as long as its width; the wide chains' few row
// tiles), else 128 x 128.
template <class Epi>
cudaError_t run_f32(const float* A, int lda, int M, int K, const float* bt_hi,
                    const float* bt_lo, int ldbt, int N, const Epi& epi, cudaStream_t st) {
  if (M <= 0) return cudaSuccess;
  if (K % tf32::kBK || N % kBN || lda % 4 || ldbt % 4 ||
      reinterpret_cast<uintptr_t>(A) % 16 || reinterpret_cast<uintptr_t>(bt_hi) % 16 ||
      reinterpret_cast<uintptr_t>(bt_lo) % 16)
    return cudaErrorInvalidValue;
  const int sms = gemm::sm_count(), mt = (M + kBM - 1) / kBM;
  const long waves128 = ((long)mt * (N / 128) + sms - 1) / sms;
  const long waves64 = ((long)mt * (N / 64) + sms - 1) / sms;
  const int bn = waves64 < 2 * waves128 ? 64 : 128;
  CUtensorMap amap, bhi, blo;
  if (!make_map(&amap, A, M, K, lda, kBM) || !make_map(&bhi, bt_hi, N, K, ldbt, bn) ||
      !make_map(&blo, bt_lo, N, K, ldbt, bn))
    return cudaErrorInvalidValue;
  if (bn == 64) return launch_f32<64>(amap, bhi, blo, M, K, N, sms, epi, st);
  return launch_f32<128>(amap, bhi, blo, M, K, N, sms, epi, st);
}

}  // namespace wg
}  // namespace t2l
