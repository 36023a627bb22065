// Post-LN multi-head attention block above d = 256, as a chain of tiled
// kernels over all rows of the batch:
//   out = LayerNorm(x + MHA(x, kv) @ Wo + bo) * gamma + beta
//
// Replaces the TPU kernel text2loc_tpu/ops/pallas_mha.py
// (_mha_block_kernel :44 / fused_mha_addlayernorm :137) where the
// one-block-per-sample kernel (mha_addln.cu) does not pay or does not fit:
// d > 256, or a sample that needs more shared memory than a block has.
//
// Numerics follow the TPU kernel and mha_addln.cu: projections sum in f32;
// q = (x Wq + bq) / sqrt(dh), k, v rounded to the compute dtype T; the key
// mask as an additive -1e9 bias, added to the f32 score as mha_addln.cu
// adds it (so an all-masked sample attends uniformly over its own keys);
// softmax in f32, normalised and then rounded to T; the attention output
// rounded to T; the residual sum and the LayerNorm statistics in f32.
//
// What bounds it on the H100: at the intra stack's shape (1584 sentences x
// 16 tokens = 25,344 rows, D = 1024, 4 heads) the block is four D x D
// products over every row, about 214 GFLOP: 0.217 ms at the bf16
// tensor-core peak of 989 TFLOP/s, against about 0.03 ms to read x and write
// the output once. It is bound by operations.
// What the design does about it: the products run over all rows at once,
// so each weight tile is reused by every row tile instead of being streamed
// through L2 once per sample, on wgmma (gemm_wgmma.cuh: TMA-fed rings,
// persistent 128 x 128 tiles): in bf16 on the weights as the caller holds
// them; in f32 as 3xTF32, on the transposed split of the four weights that
// the block's entry writes first, per call, by tf32_split.cu's kernel
// ([Wq; Wk; Wv; Wo]^T, hi and lo, [4D, D] each: the wrapper's scratch), A
// split in registers, never TF32 alone.
// The price is HBM traffic for q/k/v, the attention output and the
// pre-norm sum s2 between the kernels, about 0.1 ms at E=1024 in bf16, and
// in f32 the split (48 MB written at D = 1024). The chain, all on the
// caller's stream:
//   (a) q, k, v = round_T((x W + b) * colscale), the q columns scaled by
//       1/sqrt(dh): for self-attention one product over [Wq|Wk|Wv] (three
//       TMA descriptors in bf16, the packed split's first 3D rows in f32);
//       for cross-attention x Wq and kv [Wk|Wv];
//   (b) the attention core (below), on tensor cores;
//   (c) s2 = (f32(x) + o Wo) + bo, f32, the product with a residual
//       epilogue;
//   (d) out = LayerNorm(s2) in T, one warp per row (layernorm_rows.cuh).
// Fusing (c) with (d) needs a whole D-wide row per tile: later work.
//
// The attention core: blocks of four warps, a persistent grid walking the
// (sample, head, 16-row query tile) items, the rows past Lq padded with
// zeros and not stored. What bounds it: at the intra shape it moves 208 MB
// (q, k, v read once, o written once), 0.062 ms at 3.35 TB/s, for 1.7
// GFLOP; so a block keeps the next item's copies in flight while it
// computes one (two buffers, where the plan has one sweep and the head one
// pass of columns). q, k, v
// are staged in shared memory by 16-byte cp.async rows, a head width that
// is not a multiple of 16 padded with zero columns (which leave the dot
// products exact). The keys are taken in chunks of CK = 16, 32 or 64 rows
// (the plan's chunk); keys past Lk in the last chunk are excluded from the
// softmax (-inf), not biased -1e9, so an all-masked sample attends over its
// own Lk keys only. Every warp forms the whole 16 x CK score tile
// S = Q K^T (mma.sync m16n8k16 from ldmatrix fragments in bf16; three TF32
// products on hi / lo splits in f32, sa_train_tiles.cuh's Mma<float>, never
// TF32 alone), adds the f32 key bias and takes the softmax in registers
// across each quad (every warp computes the same values in the same
// order); p = round_T(exp(s - m) / l) is normalised before it is rounded
// and goes straight into the A fragment of P V, whose n8 output column
// tiles are split over the warps (up to 256 columns a pass; a wider head
// takes one pass per 256 columns), with f32 sums.
//   One sweep where a chunk holds every key (every Config() shape): the
// chunk's row max and sum of exp, then p and P V.
//   Two sweeps beyond: the rows' running max and rescaled sum of exp over
// the chunks, then p = round_T(exp(s - m) / l) and P V chunk by chunk. The
// function is the one-sweep core's (online softmax would round the
// unnormalised p, a different function); only the order of the f32 sum's
// terms differs.
#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "gemm_tc.cuh"
#include "gemm_wgmma.cuh"
#include "layernorm_rows.cuh"
#include "sa_train_tiles.cuh"

namespace {

using bf16 = __nv_bfloat16;
using t2l::sat::Mma;

namespace core {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;                 // query rows of a block: one m16 tile
constexpr int kCols = 256;                // output columns of a pass
constexpr int kNQ = kCols / 8 / kWarps;   // n8 output tiles of a warp in a pass
constexpr size_t kSmemLimit = 232448;     // bytes of shared memory one block may use

__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }

// The block's shared memory for key chunks of `chunk` rows: q [16][ldqk]
// and a chunk of k [chunk][ldqk] over the padded head width, a chunk of v
// [chunk][ldv] over one pass's columns. Rows are padded (bf16 by 16 bytes:
// ldmatrix's eight rows fall on distinct banks; f32 q / k rows by 4 words
// and v rows by 8, the fragment loads' banks).
struct Layout {
  int ldqk, ldv, vcols;
  size_t k, v, total;
};
__host__ __device__ inline Layout layout(int chunk, int dh, size_t tsize) {
  Layout s;
  const int dhp = pad16(dh);
  s.vcols = dhp < kCols ? dhp : kCols;
  s.ldqk = dhp + (tsize == 2 ? 8 : 4);
  s.ldv = s.vcols + 8;
  s.k = t2l::align16(tsize * (size_t)kRows * s.ldqk);
  s.v = s.k + t2l::align16(tsize * (size_t)chunk * s.ldqk);
  s.total = s.v + t2l::align16(tsize * (size_t)chunk * s.ldv);
  return s;
}

// Pipelined: one sweep over a head of at most one pass's columns, two
// buffers (the next item's q, k, v land while this one's are used) where
// they fit a block.
inline bool pipelined(int sweeps, int dh, size_t tsize, int chunk) {
  return sweeps == 1 && pad16(dh) <= kCols && 2 * layout(chunk, dh, tsize).total <= kSmemLimit;
}

// Shared bytes of the plan (rows, chunk, sweeps) the caller made
// (ops/cuda_mha.py core_layout); 0 where the kernel refuses it: rows other
// than one m16 tile, a chunk it is not built for, one sweep over more keys
// than a chunk holds, or more shared memory than a block has.
inline size_t smem(int rows, int chunk, int sweeps, int lk, int dh, size_t tsize) {
  if (rows != kRows || (chunk != 16 && chunk != 32 && chunk != 64) ||
      (sweeps != 1 && sweeps != 2) || (sweeps == 1 && lk > chunk) || dh < 1)
    return 0;
  const size_t need = layout(chunk, dh, tsize).total;
  if (need > kSmemLimit) return 0;
  return pipelined(sweeps, dh, tsize, chunk) ? 2 * need : need;
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(t2l::gemm::smem_u32(p)));
}

// The B fragments of an n8 tile of K^T at keys n0.., depth k0..: k is
// [key][depth] in shared memory, B[depth][key].
__device__ __forceinline__ void load_bt(Mma<bf16>::B& f, const bf16* k, int ld, int k0,
                                        int n0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x2(f.r, k + (size_t)(n0 + (lane & 7)) * ld + k0 + ((lane >> 3) & 1) * 8);
}
__device__ __forceinline__ void load_bt(Mma<float>::B& f, const float* k, int ld, int k0,
                                        int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float* p = k + (size_t)(n0 + g) * ld + k0 + 8 * h + t;
    Mma<float>::split(p[0], f.hi[2 * h], f.lo[2 * h]);
    Mma<float>::split(p[4], f.hi[2 * h + 1], f.lo[2 * h + 1]);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The A fragment of P for keys 16 kc .. 16 kc + 15 of the chunk from the
// probabilities p[j][e] of the score tiles j = 2 kc, 2 kc + 1 (the m16n8
// accumulator layout: rows g, g + 8, keys 2 t, 2 t + 1).
__device__ __forceinline__ void p_fragment(Mma<bf16>::A& a, const float (&p)[2][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const __nv_bfloat162 r0 = __floats2bfloat162_rn(p[h][0], p[h][1]);
    const __nv_bfloat162 r1 = __floats2bfloat162_rn(p[h][2], p[h][3]);
    a.r[2 * h] = *reinterpret_cast<const uint32_t*>(&r0);
    a.r[2 * h + 1] = *reinterpret_cast<const uint32_t*>(&r1);
  }
}
// f32: the m16n8k8 A layout (rows g, g + 8, keys t, t + 4) differs from
// the accumulator's, so each value comes from the lane holding it.
__device__ __forceinline__ void p_fragment(Mma<float>::A& a, const float (&p)[2][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int src0 = 4 * g + (t >> 1), src1 = src0 + 2;
  const bool odd = t & 1;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v[4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // i = 0: keys t, i = 1: keys t + 4
      const int src = i ? src1 : src0;
      const float x0 = __shfl_sync(0xffffffffu, p[h][0], src);
      const float x1 = __shfl_sync(0xffffffffu, p[h][1], src);
      const float y0 = __shfl_sync(0xffffffffu, p[h][2], src);
      const float y1 = __shfl_sync(0xffffffffu, p[h][3], src);
      v[2 * i] = odd ? x1 : x0;      // row g
      v[2 * i + 1] = odd ? y1 : y0;  // row g + 8
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) Mma<float>::split(v[i], a.hi[4 * h + i], a.lo[4 * h + i]);
  }
}

// Copy `rows` rows of a matrix in device memory (row stride ld, the first
// `cols` columns valid, rows at or past `valid` absent) into a [rows][lds]
// buffer's first `width` columns, zeros where absent. vec: 16-byte cp.async
// (cols, width and the rows 16-byte aligned), else element by element.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int lds, const T* src, int ld, int rows,
                                      int valid, int cols, int width, bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int per = width / V;
    for (int i = threadIdx.x; i < rows * per; i += kThreads) {
      const int r = i / per, c = (i - r * per) * V;
      const bool in = r < valid && c < cols;
      t2l::gemm::cp_async16(dst + (size_t)r * lds + c, in ? src + (size_t)r * ld + c : src,
                            in ? 16 : 0);
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * width; i += kThreads) {
    const int r = i / width, c = i - r * width;
    dst[(size_t)r * lds + c] =
        r < valid && c < cols ? src[(size_t)r * ld + c] : t2l::from_f<T>(0.f);
  }
}

// S = Q K^T over a chunk in shared memory (keys c0.. of the sample), plus
// the key bias; keys past Lk are -inf.
template <typename T, int NJ>
__device__ __forceinline__ void scores(float (&s)[NJ][4], const T* qs, const T* ks, int ld,
                                       int dhp, int c0, int lk, const float* bias) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  for (int kk = 0; kk < dhp; kk += 16) {
    typename Mma<T>::A qa;
    typename Mma<T>::B kf[NJ];
    Mma<T>::load_a_row(qa, qs, ld, 0, kk);
#pragma unroll
    for (int j = 0; j < NJ; ++j) load_bt(kf[j], ks, ld, kk, 8 * j);
    t2l::sat::mma_step<T, NJ>(s, qa, kf, NJ);
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = c0 + 8 * j + 2 * t4 + (e & 1);
      s[j][e] = key < lk ? s[j][e] + __ldg(bias + key) : -INFINITY;
    }
}

// Row r (g, g + 8) of the chunk's scores: max over the quad's keys, and
// the sum of exp(s - mx).
template <int NJ>
__device__ __forceinline__ float chunk_max(const float (&s)[NJ][4], int r) {
  float mc = -INFINITY;
#pragma unroll
  for (int j = 0; j < NJ; ++j) mc = fmaxf(mc, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
  return quad_max(mc);
}
template <int NJ>
__device__ __forceinline__ float chunk_sum(const float (&s)[NJ][4], int r, float mx) {
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) sum += expf(s[j][2 * r] - mx) + expf(s[j][2 * r + 1] - mx);
  return quad_sum(sum);
}

// acc += round_T(exp(s - m) / l) V over the chunk: V [CK][ldv] in shared
// memory, the warp's n8 output tiles warp, warp + 4, ... (nq of them).
template <typename T, int NJ>
__device__ __forceinline__ void pv(float (&acc)[kNQ][4], const float (&s)[NJ][4],
                                   const float (&m)[2], const float (&l)[2], const T* vs,
                                   int ldv, int nq) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int kc = 0; kc < NJ / 2; ++kc) {
    float p[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[h][e] = t2l::round_to<T>(expf(s[2 * kc + h][e] - m[e >> 1]) / l[e >> 1]);
    typename Mma<T>::A pa;
    p_fragment(pa, p);
    typename Mma<T>::B vf[kNQ];
#pragma unroll
    for (int i = 0; i < kNQ; ++i)
      if (i < nq) Mma<T>::load_b(vf[i], vs, ldv, 16 * kc, (warp + kWarps * i) * 8);
    t2l::sat::mma_step<T, kNQ>(acc, pa, vf, nq);
  }
}

// The tile's output columns [0, cols) of this pass from the accumulators
// (rows past `rows` dropped), through the [16][ld] buffer os; every thread
// of the block calls it.
template <typename T>
__device__ __forceinline__ void store_o(const float (&acc)[kNQ][4], int nq, T* os, int ld,
                                        T* ob, int ldo, int rows, int cols, bool vec) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2;
  __syncthreads();  // every warp is done reading the buffer os overlays
#pragma unroll
  for (int i = 0; i < kNQ; ++i) {
    if (i < nq) {
      const int col = (warp + kWarps * i) * 8 + 2 * (lane & 3);
      t2l::gemm::store2<T>(os + (size_t)g * ld + col, acc[i][0], acc[i][1]);
      t2l::gemm::store2<T>(os + (size_t)(g + 8) * ld + col, acc[i][2], acc[i][3]);
    }
  }
  __syncthreads();
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int per = cols / V;
    for (int i = threadIdx.x; i < rows * per; i += kThreads) {
      const int r = i / per, c = (i - r * per) * V;
      *reinterpret_cast<uint4*>(ob + (size_t)r * ldo + c) =
          *reinterpret_cast<const uint4*>(os + (size_t)r * ld + c);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
      const int r = i / cols, c = i - r * cols;
      ob[(size_t)r * ldo + c] = os[(size_t)r * ld + c];
    }
  }
  __syncthreads();  // the buffer is free again
}

// A persistent grid walks the (sample, head, query tile) items. Pipelined
// (one sweep, one column pass, two buffers in shared memory): the next
// item's q, k and v are in flight while the block computes this one's.
// Otherwise one item at a time: in two sweeps over the key chunks, and one
// column pass per 256 output columns. q rows of stride ldq, k and v rows
// of stride ldkv, o rows of stride ldo; the head's columns start at h * dh.
template <typename T, int CK>
__global__ void __launch_bounds__(kThreads)
    attention_core_kernel(const T* __restrict__ q, int ldq, const T* __restrict__ k,
                          const T* __restrict__ v, int ldkv,
                          const float* __restrict__ kbias, T* __restrict__ o, int ldo, int b,
                          int lq, int lk, int dh, int heads, int sweeps, int pipelined,
                          int vec) {
  constexpr int NJ = CK / 8;  // n8 score tiles of a chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout lay = layout(CK, dh, sizeof(T));
  const int qtiles = (lq + kRows - 1) / kRows;
  const int items = b * heads * qtiles;
  const int warp = threadIdx.x >> 5;
  const int dhp = pad16(dh);

  struct Item {
    int b, h, q0;
  };
  auto item = [&](int it) {
    const int bh = it / qtiles;
    return Item{bh / heads, bh % heads, (it - bh * qtiles) * kRows};
  };
  auto qs_of = [&](int bi) { return reinterpret_cast<T*>(smem_raw + bi * lay.total); };
  auto ks_of = [&](int bi) { return reinterpret_cast<T*>(smem_raw + bi * lay.total + lay.k); };
  auto vs_of = [&](int bi) { return reinterpret_cast<T*>(smem_raw + bi * lay.total + lay.v); };
  auto stage_q = [&](const Item& w, int bi) {
    stage(qs_of(bi), lay.ldqk, q + ((size_t)w.b * lq + w.q0) * ldq + w.h * dh, ldq, kRows,
          lq - w.q0, dh, dhp, vec);
  };
  // Keys c0.. of the item's sample; with v, v's columns cg .. cg + vw.
  auto stage_kv = [&](const Item& w, int bi, int c0, int cg, int vw) {
    const size_t base = ((size_t)w.b * lk + c0) * ldkv + w.h * dh;
    stage(ks_of(bi), lay.ldqk, k + base, ldkv, CK, lk - c0, dh, dhp, vec);
    if (vw > 0)
      stage(vs_of(bi), lay.ldv, v + base + cg, ldkv, CK, lk - c0, dh - cg < vw ? dh - cg : vw,
            vw, vec);
  };
  auto out_of = [&](const Item& w, int cg) {
    return o + ((size_t)w.b * lq + w.q0) * ldo + w.h * dh + cg;
  };

  float s[NJ][4], acc[kNQ][4];
  float m[2], l[2];  // rows g and g + 8: the max and the sum of exp(s - max)
  if (pipelined) {
    const int tiles = dhp / 8;
    const int nq = warp < tiles ? (tiles - warp + kWarps - 1) / kWarps : 0;
    int it = blockIdx.x, bi = 0;
    if (it < items) {
      stage_q(item(it), 0);
      stage_kv(item(it), 0, 0, 0, dhp);
    }
    t2l::gemm::cp_async_commit();
    for (; it < items; it += gridDim.x, bi ^= 1) {
      const Item w = item(it);
      if (it + gridDim.x < items) {
        const Item nx = item(it + gridDim.x);
        stage_q(nx, bi ^ 1);
        stage_kv(nx, bi ^ 1, 0, 0, dhp);
      }
      t2l::gemm::cp_async_commit();
      t2l::gemm::cp_async_wait<1>();  // this item's copies have landed
      __syncthreads();
      scores<T, NJ>(s, qs_of(bi), ks_of(bi), lay.ldqk, dhp, 0, lk, kbias + (size_t)w.b * lk);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m[r] = chunk_max(s, r);
        l[r] = chunk_sum(s, r, m[r]);
      }
#pragma unroll
      for (int i = 0; i < kNQ; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
      pv<T, NJ>(acc, s, m, l, vs_of(bi), lay.ldv, nq);
      store_o(acc, nq, ks_of(bi), lay.ldqk, out_of(w, 0), ldo,
              lq - w.q0 < kRows ? lq - w.q0 : kRows, dh, vec);
    }
    return;
  }

  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const Item w = item(it);
    const float* bias = kbias + (size_t)w.b * lk;
    stage_q(w, 0);
    auto load = [&](int c0, int cg, int vw) {
      __syncthreads();  // every warp is done with the chunk before
      stage_kv(w, 0, c0, cg, vw);
      t2l::gemm::cp_async_commit();
      t2l::gemm::cp_async_wait<0>();
      __syncthreads();
    };
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
    if (sweeps == 2) {
      for (int c0 = 0; c0 < lk; c0 += CK) {
        load(c0, 0, 0);
        scores<T, NJ>(s, qs_of(0), ks_of(0), lay.ldqk, dhp, c0, lk, bias);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mn = fmaxf(m[r], chunk_max(s, r));
          l[r] = l[r] * expf(m[r] - mn) + chunk_sum(s, r, mn);
          m[r] = mn;
        }
      }
    }
    for (int cg = 0; cg < dhp; cg += kCols) {
      const int vw = dhp - cg < kCols ? dhp - cg : kCols;  // columns of this pass
      const int tiles = vw / 8;
      const int nq = warp < tiles ? (tiles - warp + kWarps - 1) / kWarps : 0;
#pragma unroll
      for (int i = 0; i < kNQ; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
      for (int c0 = 0; c0 < lk; c0 += CK) {
        load(c0, cg, vw);
        scores<T, NJ>(s, qs_of(0), ks_of(0), lay.ldqk, dhp, c0, lk, bias);
        if (sweeps == 1) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            m[r] = chunk_max(s, r);
            l[r] = chunk_sum(s, r, m[r]);
          }
        }
        pv<T, NJ>(acc, s, m, l, vs_of(0), lay.ldv, nq);
      }
      store_o(acc, nq, ks_of(0), lay.ldqk, out_of(w, cg), ldo,
              lq - w.q0 < kRows ? lq - w.q0 : kRows, dh - cg < vw ? dh - cg : vw, vec);
    }
  }
}

template <typename T, int CK>
cudaError_t launch(const T* q, int ldq, const T* k, const T* v, int ldkv, const float* kbias,
                   T* o, int ldo, int b, int lq, int lk, int dh, int heads, int sweeps,
                   int pipelined, int vec, size_t smem, cudaStream_t st) {
  auto kern = attention_core_kernel<T, CK>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const long items = (long)b * heads * ((lq + kRows - 1) / kRows);
  if (items > 0x7fffffffL) return cudaErrorInvalidValue;
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
  if (e != cudaSuccess) return e;
  const long cap = (long)(per_sm > 0 ? per_sm : 1) * t2l::gemm::sm_count();
  kern<<<(unsigned)(items < cap ? items : cap), kThreads, smem, st>>>(
      q, ldq, k, v, ldkv, kbias, o, ldo, b, lq, lk, dh, heads, sweeps, pipelined, vec);
  return cudaGetLastError();
}

}  // namespace core

template <typename T>
cudaError_t attention_core(const void* q, int ldq, const void* k, const void* v, int ldkv,
                           const void* kbias, void* o, int b, int lq, int lk, int d, int heads,
                           int rows, int chunk, int sweeps, cudaStream_t st) {
  const int dh = d / heads;
  const size_t smem = core::smem(rows, chunk, sweeps, lk, dh, sizeof(T));
  if (smem == 0) return cudaErrorInvalidValue;
  if (b <= 0 || lq <= 0) return cudaSuccess;
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = (dh * sizeof(T)) % 16 == 0 && (ldq * sizeof(T)) % 16 == 0 &&
                  (ldkv * sizeof(T)) % 16 == 0 && (d * sizeof(T)) % 16 == 0 && aligned(q) &&
                  aligned(k) && aligned(v) && aligned(o);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const float* kb = static_cast<const float*>(kbias);
  T* op = static_cast<T*>(o);
  const int pipe = core::pipelined(sweeps, dh, sizeof(T), chunk);
  if (chunk == 16)
    return core::launch<T, 16>(qp, ldq, kp, vp, ldkv, kb, op, d, b, lq, lk, dh, heads, sweeps,
                               pipe, vec, smem, st);
  if (chunk == 32)
    return core::launch<T, 32>(qp, ldq, kp, vp, ldkv, kb, op, d, b, lq, lk, dh, heads, sweeps,
                               pipe, vec, smem, st);
  return core::launch<T, 64>(qp, ldq, kp, vp, ldkv, kb, op, d, b, lq, lk, dh, heads, sweeps,
                             pipe, vec, smem, st);
}

// (a): q, k, v into the scratch qkv: [m, 3d] for self-attention (q, k, v
// side by side), else q [m, d] then k|v [mk, 2d]. w / bias: Wq, Wk, Wv
// [d, d] in T and bq, bk, bv [d] f32, as the caller holds them; in f32 the
// products read wt_hi / wt_lo instead, the split of [Wq; Wk; Wv]^T (rows
// 0 .. 3d of tf32_split.cu's output, [3d, d]).
template <typename T>
cudaError_t project(const void* x, const void* kv, const void* const* w,
                    const void* const* bias, const void* wt_hi, const void* wt_lo, void* qkv,
                    int b, int lq, int lk, int d, float scale, int self_attn, cudaStream_t st) {
  const int m = b * lq, mk = b * lk;
  const T* X = static_cast<const T*>(x);
  const T* KV = static_cast<const T*>(kv);
  const float* B[3] = {static_cast<const float*>(bias[0]), static_cast<const float*>(bias[1]),
                       static_cast<const float*>(bias[2])};
  T* buf = static_cast<T*>(qkv);
  T* kvp = buf + (size_t)m * d;
  using Epi = t2l::wg::EpiBiasScaleBlocks<T>;
  const Epi eq{buf, self_attn ? 3 * d : d, B[0], B[1], B[2], d, d, scale};
  const Epi ekv{kvp, 2 * d, B[1], B[2], B[2], d, 0, 1.f};
  if constexpr (std::is_same<T, bf16>::value) {
    const T* W[3] = {static_cast<const T*>(w[0]), static_cast<const T*>(w[1]),
                     static_cast<const T*>(w[2])};
    if (self_attn) return t2l::wg::run(X, d, m, d, W, d, 3, d, eq, st);
    cudaError_t e = t2l::wg::run(X, d, m, d, W, d, 1, d, eq, st);
    if (e == cudaSuccess) e = t2l::wg::run(KV, d, mk, d, W + 1, d, 2, d, ekv, st);
    return e;
  } else {
    const float* hi = static_cast<const float*>(wt_hi);
    const float* lo = static_cast<const float*>(wt_lo);
    if (self_attn) return t2l::wg::run_f32(X, d, m, d, hi, lo, d, 3 * d, eq, st);
    cudaError_t e = t2l::wg::run_f32(X, d, m, d, hi, lo, d, d, eq, st);
    const size_t dd = (size_t)d * d;
    if (e == cudaSuccess) e = t2l::wg::run_f32(KV, d, mk, d, hi + dd, lo + dd, d, 2 * d, ekv, st);
    return e;
  }
}

// c = round_T((a b + bias) * colscale) (the first nscale columns scaled), or
// with res: c (f32) = (f32(res) + a b) + bias. a [m, k], b [k, n] (row
// strides lda, ldb), c row stride ldc, res row stride ldr; in f32 the
// product reads bt_hi / bt_lo, b's transposed split [n, k] (row stride k).
template <typename T>
cudaError_t gemm(const void* a, int lda, const void* b, int ldb, const void* bt_hi,
                 const void* bt_lo, const void* bias, void* c, int ldc, const void* res,
                 int ldr, int m, int n, int k, int nscale, float scale, cudaStream_t st) {
  const T* A = static_cast<const T*>(a);
  const float* bs = static_cast<const float*>(bias);
  const t2l::wg::EpiBiasScaleBlocks<T> ep{static_cast<T*>(c), ldc, bs, bs, bs, n, nscale, scale};
  const t2l::wg::EpiResidual<T> er{static_cast<float*>(c), ldc, bs, static_cast<const T*>(res),
                                   ldr};
  if constexpr (std::is_same<T, bf16>::value) {
    const T* B = static_cast<const T*>(b);
    if (res == nullptr) return t2l::wg::run(A, lda, m, k, &B, ldb, 1, n, ep, st);
    return t2l::wg::run(A, lda, m, k, &B, ldb, 1, n, er, st);
  } else {
    const float* hi = static_cast<const float*>(bt_hi);
    const float* lo = static_cast<const float*>(bt_lo);
    if (res == nullptr) return t2l::wg::run_f32(A, lda, m, k, hi, lo, k, n, ep, st);
    return t2l::wg::run_f32(A, lda, m, k, hi, lo, k, n, er, st);
  }
}

template <typename T>
cudaError_t block(const void* x, const void* kv, const void* kbias, const void* const* w,
                  const void* const* bias, const void* wo, const void* bo, const void* wt_hi,
                  const void* wt_lo, const void* gamma, const void* beta, void* out, void* qkv,
                  void* o, void* s2, int b, int lq, int lk, int d, int heads, int rows,
                  int chunk, int sweeps, float scale, float eps, int self_attn,
                  cudaStream_t st) {
  const int m = b * lq;
  T* buf = static_cast<T*>(qkv);
  cudaError_t e =
      project<T>(x, kv, w, bias, wt_hi, wt_lo, qkv, b, lq, lk, d, scale, self_attn, st);
  const T *qp = buf, *kp, *vp;
  int ldq, ldkv;
  if (self_attn) {
    kp = buf + d, vp = buf + 2 * d, ldq = ldkv = 3 * d;
  } else {
    kp = buf + (size_t)m * d, vp = kp + d, ldq = d, ldkv = 2 * d;
  }
  if (e == cudaSuccess)
    e = attention_core<T>(qp, ldq, kp, vp, ldkv, kbias, o, b, lq, lk, d, heads, rows, chunk,
                          sweeps, st);
  // Wo's split: rows 3d .. 4d of the split buffers.
  const size_t wo_at = (size_t)3 * d * d;
  const float* hi = static_cast<const float*>(wt_hi);
  const float* lo = static_cast<const float*>(wt_lo);
  if (e == cudaSuccess)
    e = gemm<T>(o, d, wo, d, hi ? hi + wo_at : nullptr, lo ? lo + wo_at : nullptr, bo, s2, d,
                x, d, m, d, d, 0, 1.f, st);
  if (e == cudaSuccess) e = t2l::rows::layernorm<T>(s2, gamma, beta, out, m, d, eps, st);
  return e;
}

}  // namespace

extern "C" {

// Shared bytes of the attention core's plan: query rows a block (16),
// keys a chunk (16, 32 or 64), sweeps (1 where a chunk holds every key,
// else 2); 0 where the kernel refuses it.
size_t t2l_mha_tiled_core_smem(int lq, int lk, int d, int heads, int rows, int chunk,
                               int sweeps, int dtype) {
  (void)lq;
  if (heads < 1 || d % heads) return 0;
  return core::smem(rows, chunk, sweeps, lk, d / heads, dtype == t2l::kBF16 ? 2 : 4);
}

// The whole block. x [b,lq,d] T, kv [b,lk,d] T (ignored when self_attn),
// kbias [b,lk] f32, wq/wk/wv/wo [d,d] T ([in, out]), bq/bk/bv/bo/gamma/beta
// [d] f32 -> out [b,lq,d] T. Scratch: qkv (b*lq*3d T when self_attn, else
// b*lq*d + b*lk*2d), o [b*lq, d] T, s2 [b*lq, d] f32; in f32 wt_hi and
// wt_lo [4d, d] f32 each (NULL in bf16), into which the block first writes
// the split of (wq, wk, wv, wo) (t2l_tf32_split_t, its one launch of that
// kernel) for its products to read. (rows, chunk, sweeps): the attention
// core's plan, as t2l_mha_tiled_core_smem takes it.
int t2l_mha_addln_tiled(const void* x, const void* kv, const void* kbias, const void* wq,
                        const void* wk, const void* wv, const void* bq, const void* bk,
                        const void* bv, const void* wo, const void* bo, void* wt_hi,
                        void* wt_lo, const void* gamma, const void* beta, void* out, void* qkv,
                        void* o, void* s2, int b, int lq, int lk, int d, int heads,
                        int rows, int chunk, int sweeps, float scale, float eps, int self_attn,
                        int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* w[3] = {wq, wk, wv};
  const void* bias[3] = {bq, bk, bv};
  if (dtype == t2l::kBF16)
    return (int)block<bf16>(x, kv, kbias, w, bias, wo, bo, nullptr, nullptr, gamma, beta, out,
                            qkv, o, s2, b, lq, lk, d, heads, rows, chunk, sweeps, scale, eps,
                            self_attn, st);
  if (wt_hi == nullptr || wt_lo == nullptr) return (int)cudaErrorInvalidValue;
  const int e = t2l_tf32_split_t(wq, d, d, wk, d, d, wv, d, d, wo, d, d, 4, wt_hi, wt_lo, stream);
  if (e != 0) return e;
  return (int)block<float>(x, kv, kbias, w, bias, wo, bo, wt_hi, wt_lo, gamma, beta, out, qkv,
                           o, s2, b, lq, lk, d, heads, rows, chunk, sweeps, scale, eps,
                           self_attn, st);
}

// The stages one at a time, for the tests that hold each against its plain
// version. (a): the block's projection into qkv (its layout above); in f32
// wt_hi / wt_lo as the block takes them (their first 3d rows are read).
int t2l_mha_tiled_project(const void* x, const void* kv, const void* wq, const void* wk,
                          const void* wv, const void* bq, const void* bk, const void* bv,
                          const void* wt_hi, const void* wt_lo, void* qkv, int b, int lq,
                          int lk, int d, float scale, int self_attn, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* w[3] = {wq, wk, wv};
  const void* bias[3] = {bq, bk, bv};
  if (dtype == t2l::kBF16)
    return (int)project<bf16>(x, kv, w, bias, nullptr, nullptr, qkv, b, lq, lk, d, scale,
                              self_attn, st);
  if (wt_hi == nullptr || wt_lo == nullptr) return (int)cudaErrorInvalidValue;
  return (int)project<float>(x, kv, w, bias, wt_hi, wt_lo, qkv, b, lq, lk, d, scale, self_attn,
                             st);
}

// One product of the chain's: res NULL gives c = round_T((a b + bias) *
// colscale), else c (f32) = (f32(res) + a b) + bias ((c) with K = D; the
// feed-forward chain's residual product has the same form with K = F). In
// f32 the product reads bt_hi / bt_lo, b's split [n, k], instead of b.
int t2l_mha_tiled_gemm(const void* a, int lda, const void* b, int ldb, const void* bt_hi,
                       const void* bt_lo, const void* bias, void* c, int ldc, const void* res,
                       int ldr, int m, int n, int k, int nscale, float scale, int dtype,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == t2l::kBF16)
    return (int)gemm<bf16>(a, lda, b, ldb, nullptr, nullptr, bias, c, ldc, res, ldr, m, n, k,
                           nscale, scale, st);
  if (bt_hi == nullptr || bt_lo == nullptr) return (int)cudaErrorInvalidValue;
  return (int)gemm<float>(a, lda, b, ldb, bt_hi, bt_lo, bias, c, ldc, res, ldr, m, n, k, nscale,
                          scale, st);
}

// (b): q rows of stride ldq, k and v rows of stride ldkv -> o [b*lq, d],
// with the core's plan (rows, chunk, sweeps).
int t2l_mha_tiled_core(const void* q, int ldq, const void* k, const void* v, int ldkv,
                       const void* kbias, void* o, int b, int lq, int lk, int d, int heads,
                       int rows, int chunk, int sweeps, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == t2l::kBF16)
    return (int)attention_core<bf16>(q, ldq, k, v, ldkv, kbias, o, b, lq, lk, d, heads, rows,
                                     chunk, sweeps, st);
  return (int)attention_core<float>(q, ldq, k, v, ldkv, kbias, o, b, lq, lk, d, heads, rows,
                                    chunk, sweeps, st);
}

// (d): out [m, d] T = LayerNorm(s2 [m, d] f32).
int t2l_mha_tiled_ln(const void* s2, const void* gamma, const void* beta, void* out, int m,
                     int d, float eps, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == t2l::kBF16)
    return (int)t2l::rows::layernorm<bf16>(s2, gamma, beta, out, m, d, eps, st);
  return (int)t2l::rows::layernorm<float>(s2, gamma, beta, out, m, d, eps, st);
}

}  // extern "C"
