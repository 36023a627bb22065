// Device code shared by the fused transformer blocks to d = 256
// (mha_addln.cu, ffn_addln.cu): the product of a shared-memory tile with a
// weight matrix streamed through a cp.async ring of chunks in shared
// memory.
//
// A product runs on 8 warps (256 threads). The weights are read as the
// caller holds them (f32, or the compute dtype) and rounded to the compute
// dtype (round to nearest even, as Tensor.to) as they are used. bf16 runs as
// mma.sync.m16n8k16 with f32 sums; f32 as 3xTF32 m16n8k8 products with
// per-k8 partials (t2l::sat::Mma<float> of sa_train_tiles.cuh), never TF32
// alone.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "gemm_tc.cuh"
#include "sa_train_tiles.cuh"

namespace t2l {
namespace fused {

constexpr int kWarps = 8;     // the warps of a product
constexpr int kThreads = kWarps * 32;
constexpr int kChunkK = 16;   // k rows of a weight chunk

// Columns of one pass of a product: NJ n8 tiles a warp.
__host__ __device__ constexpr int pass_cols(int nj) { return nj * 8 * kWarps; }
// Bytes of one weight chunk in shared memory: kChunkK rows of
// pass_cols(nj) columns, f32 rows padded by 4 floats (conflict-free
// fragment loads), the compute dtype's by 16 bytes (in the same room).
__host__ __device__ constexpr size_t stage_bytes(int nj) {
  return (size_t)kChunkK * (pass_cols(nj) + 4) * 4;
}
// The row stride (elements) of a chunk of TW.
template <typename TW, int NJ>
__host__ __device__ constexpr int chunk_ld() {
  return pass_cols(NJ) + 16 / (int)sizeof(TW);
}

// The weight columns a product reads: up to three segments of `seg`
// columns side by side, segment i starting at col[i] of a matrix with row
// stride ldw.
template <typename TW>
struct Cols {
  const TW* col[3];
  int seg;
};

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// acc[i][j] += a[m16 tile i, k0:k0+16] . ws[0:16, n8 tile warp + 8 j] for
// i < mtiles (a row-major in shared memory, stride lda) and the pass's
// ntiles n8 tiles of the chunk ws (row stride chunk_ld<TW, NJ>()): warp w
// owns the tiles w, w + 8, ..., w + 8 (NJ - 1) over every m16 tile. bf16
// from f32 weights: each B fragment is read as f32 pairs and rounded as it
// is packed.
template <int MT, int NJ, typename T, typename TW>
__device__ __forceinline__ void mma_chunk(float (&acc)[MT][NJ][4], const T* a, int lda,
                                          int mtiles, int k0, const TW* ws, int ntiles) {
  using F32Mma = t2l::sat::Mma<float>;
  constexpr int WLD = chunk_ld<TW, NJ>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    uint32_t af[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
      if (i < mtiles && warp < ntiles)
        t2l::gemm::ldmatrix_x4(af[i], a + (i * 16 + (lane & 15)) * lda + k0 + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int nt = warp + j * kWarps;
      if (nt < ntiles) {
        uint32_t b[2];
        if constexpr (std::is_same<TW, __nv_bfloat16>::value) {
          t2l::sat::ldmatrix_x2_trans(b, ws + (lane & 15) * WLD + nt * 8);
        } else {
          // b0: k = 2t, 2t + 1; b1: k + 8; column lane / 4 of the tile.
          const TW* wc = ws + 2 * (lane & 3) * WLD + nt * 8 + (lane >> 2);
          b[0] = pack_bf16(wc[0], wc[WLD]);
          b[1] = pack_bf16(wc[8 * WLD], wc[9 * WLD]);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
          if (i < mtiles) t2l::gemm::mma_bf16(acc[i][j], af[i], b[0], b[1]);
      }
    }
  } else if (warp < ntiles) {
    // f32 on the tensor cores as 3xTF32, each k8 half summed into a zeroed
    // partial (t2l::sat::mma_step): never TF32 alone.
    const int nq = (ntiles - warp + kWarps - 1) / kWarps;
    F32Mma::B bf[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (j < nq) F32Mma::load_b(bf[j], ws, WLD, 0, (warp + j * kWarps) * 8);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i < mtiles) {
        F32Mma::A af;
        F32Mma::load_a_row(af, a, lda, i * 16, k0);
        t2l::sat::mma_step<float, NJ>(acc[i], af, bf, nq);
      }
    }
  }
}

// The end of a pass starting at column p0: epi(row, col, v0, v1) for the
// warp's tiles (c0, c1: row lane / 4, columns 2 (lane % 4) + {0, 1}; c2,
// c3: row + 8), then acc zeroed for the next pass.
template <int MT, int NJ, class Epi>
__device__ __forceinline__ void flush(float (&acc)[MT][NJ][4], int mtiles, int ntiles, int p0,
                                      const Epi& epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int nt = warp + j * kWarps;
      if (i < mtiles && nt < ntiles) {
        const int r = i * 16 + (lane >> 2), col = p0 + nt * 8 + 2 * (lane & 3);
        epi(r, col, acc[i][j][0], acc[i][j][1]);
        epi(r + 8, col, acc[i][j][2], acc[i][j][3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }
}

// epi(a . W) for rows [0, rows) of a (a multiple of 16, at most 16 MT) and
// the n columns of `w`, k in [0, k) (a multiple of kChunkK), in passes of
// pass_cols(NJ) columns. The chunks of every pass form one sequence
// through the cp.async ring of STAGES chunks (stage_bytes(NJ) each),
// STAGES - 1 in flight; a thread's 16-byte pieces of a chunk keep their
// place from chunk to chunk, so their addresses are computed once a pass.
// The first wait takes every cp.async group the caller committed before
// the call with the first chunk. Ends on a block barrier.
template <int MT, int NJ, int STAGES, typename T, typename TW, class Epi>
__device__ void project(const T* a, int lda, int rows, const Cols<TW> w, int k, int ldw, int n,
                        unsigned char* ring, const Epi& epi) {
  constexpr int KC = kChunkK;
  constexpr int PC = pass_cols(NJ);
  constexpr size_t SB = stage_bytes(NJ);
  constexpr int E = 16 / sizeof(TW);       // elements of a 16-byte piece
  constexpr int WLD = chunk_ld<TW, NJ>();  // ring row stride (elements)
  constexpr int PPT = (KC * PC / E + kThreads - 1) / kThreads;  // pieces a thread
  const int tid = threadIdx.x;
  const int mtiles = rows / 16;
  const int kchunks = k / KC;
  const int chunks = (n + PC - 1) / PC * kchunks;

  // The issuing side runs STAGES - 1 chunks ahead of the multiplying side.
  int issue_pass = -1, npieces = 0;
  const TW* src[PPT];
  int dst[PPT];
  auto issue = [&](int c) {
    if (c < chunks) {
      const int pass = c / kchunks;
      if (pass != issue_pass) {
        issue_pass = pass;
        const int p0 = pass * PC;
        const int per_row = (n - p0 < PC ? n - p0 : PC) / E;
        npieces = 0;
#pragma unroll
        for (int q = 0; q < PPT; ++q) {
          const int i = tid + q * kThreads;
          if (i < KC * per_row) {
            const int r = i / per_row, cc = (i - r * per_row) * E;
            const int s = (p0 + cc) / w.seg;
            src[q] = w.col[s] + (size_t)r * ldw + (p0 + cc - s * w.seg);
            dst[q] = r * WLD + cc;
            npieces = q + 1;
          }
        }
      }
      TW* st = reinterpret_cast<TW*>(ring + (size_t)(c % STAGES) * SB);
      const size_t koff = (size_t)(c % kchunks) * KC * ldw;
#pragma unroll
      for (int q = 0; q < PPT; ++q)
        if (q < npieces) t2l::gemm::cp_async16(st + dst[q], src[q] + koff, 16);
    }
    t2l::gemm::cp_async_commit();
  };

  float acc[MT][NJ][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);
  for (int c = 0; c < chunks; ++c) {
    t2l::gemm::cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk c landed; every warp is done with chunk c - 1
    issue(c + STAGES - 1);
    const int p0 = c / kchunks * PC, k0 = c % kchunks * KC;
    const int ntiles = (n - p0 < PC ? n - p0 : PC) / 8;
    mma_chunk<MT, NJ>(acc, a, lda, mtiles, k0,
                      reinterpret_cast<const TW*>(ring + (size_t)(c % STAGES) * SB), ntiles);
    if (c % kchunks == kchunks - 1) flush(acc, mtiles, ntiles, p0, epi);
  }
  t2l::gemm::cp_async_wait<0>();
  __syncthreads();  // every epilogue's stores are visible to the block
}

}  // namespace fused
}  // namespace t2l
