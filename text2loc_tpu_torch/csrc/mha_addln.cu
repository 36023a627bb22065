// Post-LN multi-head attention block to d = 256:
//   out = LayerNorm(x + MHA(x, kv) @ Wo + bo) * gamma + beta
// with the q/k/v and output projections inside the kernel.
//
// Replaces the TPU kernel text2loc_tpu/ops/pallas_mha.py
// (_mha_block_kernel :44 / fused_mha_addlayernorm :137).
//
// Numerics follow the TPU kernel: projections sum in f32; q = (x Wq + bq) /
// sqrt(dh), k, v rounded to the compute dtype before the score and AV
// products; key mask as an additive -1e9 bias; softmax in f32 and rounded
// before AV; the attention output rounded before the out-projection; the
// residual sum and the LayerNorm statistics in f32. The weights are read as
// the caller holds them (f32 or the compute dtype) and rounded to the
// compute dtype (round to nearest even, as Tensor.to) as they are used.
//
// What bounds it on the H100: at the serve's shapes (D = 128 or 256, 6-28
// rows a sample) a sample is a few hundred thousand multiply-adds against
// 256 KB-1 MB of f32 weights. One SM reads L2 at a few tens of GB/s, so a
// block that reads every weight for its samples is bound by that read and
// by its chain of steps, not by the products. What the design does about it:
// - A group of G samples (G x Lq and G x Lk rows up to 80) shares one read
//   of the weights. The caller plans G and the cluster
//   (ops/cuda_mha.fused_plan: G = ceil(B / SMs), one wave of blocks); the
//   kernel checks the plan against its layout. Where H blocks a group fit
//   the SMs, a thread-block cluster of H blocks (one per head) takes each
//   group: block h reads only its head's columns of Wq, Wk, Wv and its
//   D / H columns of Wo, so H SMs share a sample's weight reads at B = 1.
//   Else one block takes a group (B = 640 on 132 SMs: 128 blocks of 5).
// - Projections on the tensor cores: bf16 as mma.sync.m16n8k16 with f32
//   sums; f32 as 3xTF32 m16n8k8 products with per-k8 partials
//   (t2l::sat::Mma<float> of sa_train_tiles.cuh), never TF32 alone. The
//   weights stream through a cp.async ring in chunks of 16 rows of k.
// - The core per (sample, head) on one warp from shared memory: the scores
//   (mma in bf16), the softmax on the score fragments (each row on a quad of
//   lanes, max and sum by shuffles), p . v with p taken from the score
//   registers. Padding rows and keys of the 16 x 8 tiles are clamped to a
//   real row on load and get weight exactly 0.
// - In a cluster the heads' outputs meet through distributed shared
//   memory: each block gathers o of every head, projects its D / H output
//   columns, and the LayerNorm's row sums are added across the cluster (two
//   passes, as the plain version: the mean, then the centred squares).
// - One device op per call: the mask is read as bool, the bias added here.
#include <cooperative_groups.h>
#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "fused_block.cuh"
#include "gemm_tc.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using t2l::gemm::ldmatrix_x4;
using t2l::gemm::ldmatrix_x4_trans;
using t2l::gemm::mma_bf16;
using t2l::gemm::store2;
using t2l::fused::Cols;
using t2l::fused::pack_bf16;

constexpr int kThreads = t2l::fused::kThreads, kWarps = t2l::fused::kWarps;
constexpr int kMaxRows = 80;    // query rows (and key rows) of a block
constexpr int kMaxKeys = 32;    // keys of a sample: four n8 score tiles
constexpr int kMaxDh = 64;      // head width: eight n8 output tiles
constexpr int kMaxD = 256;
constexpr int kMaxHeads = 8;    // the portable cluster size
constexpr int kPassTiles = 3;   // n8 tiles a warp per pass: 3 x kMaxDh, q, k, v of a head
constexpr size_t kSmemLimit = 232448;
constexpr float kMasked = -1e9f;
// The weight ring: kStages chunks of 16 rows (k) by up to 3 x kMaxDh
// columns as the caller holds them (t2l::fused::stage_bytes).
constexpr int kStages = 3;
constexpr size_t kStageBytes = t2l::fused::stage_bytes(kPassTiles);

// Shared rows are padded by 16 bytes: conflict-free ldmatrix rows and
// fragment loads.
__host__ __device__ constexpr int row_pad(int tsize) { return tsize == 2 ? 8 : 4; }

struct Plan {
  int samples, rows, krows, cluster, ldx, ldw, lds;
  size_t xs, os, qh, kh, vh, s2, stats, ring, total;
};

__host__ __device__ inline int round16(int n) { return (n + 15) & ~15; }

// Shared layout of one block of a cluster of c blocks (1, or one per head)
// taking g samples, w = d / c columns a block: x rows; in a cluster the o
// of every head (before it, the kv rows of cross-attention); the block's
// q (later its o; with c = 1 first the kv rows), k, v; the f32 pre-norm
// rows of its columns over the k, v region; the LayerNorm's row sums and
// centred squares; the weight ring.
__host__ __device__ inline Plan layout(int g, int c, int lq, int lk, int d, int self_attn,
                                       int tsize) {
  Plan p;
  p.samples = g;
  p.cluster = c;
  p.rows = round16(g * lq);
  p.krows = self_attn ? p.rows : round16(g * lk);
  const int w = d / c, orows = p.krows > p.rows ? p.krows : p.rows;
  p.ldx = d + row_pad(tsize);
  p.ldw = w + row_pad(tsize);
  p.lds = w + 4;
  size_t off = 0;
  p.xs = off;
  off = t2l::align16(off + (size_t)tsize * p.rows * p.ldx);
  p.os = off;
  if (c > 1) off = t2l::align16(off + (size_t)tsize * orows * p.ldx);
  p.qh = off;
  off = t2l::align16(off + (size_t)tsize * (c > 1 ? p.rows : orows) * p.ldw);
  p.kh = off;
  p.s2 = off;
  const size_t kbytes = t2l::align16((size_t)tsize * p.krows * p.ldw);
  const size_t s2bytes = t2l::align16(sizeof(float) * (size_t)p.rows * p.lds);
  p.vh = off + kbytes;
  off += 2 * kbytes > s2bytes ? 2 * kbytes : s2bytes;
  p.stats = off;
  off = t2l::align16(off + 2 * sizeof(float) * (size_t)p.rows);
  p.ring = off;
  p.total = off + kStages * kStageBytes;
  return p;
}

// The layout of a call taking g samples a group on a cluster of c blocks,
// as the caller planned it (ops/cuda_mha.fused_plan); total = 0 where the
// kernel does not take it: the shape past the limits above, c neither 1
// nor one block per head, g x Lq or g x Lk rows past kMaxRows, or the
// layout past a block's shared memory.
__host__ __device__ inline Plan checked(int g, int c, int lq, int lk, int d, int heads,
                                        int self_attn, int tsize) {
  Plan none{};
  none.total = 0;
  if (lq < 1 || lk < 1 || lq > kMaxRows || lk > kMaxKeys || d < 32 || d > kMaxD ||
      heads < 1 || heads > kMaxHeads || d % heads || (self_attn && lq != lk))
    return none;
  const int dh = d / heads;
  if (dh % 16 || dh > kMaxDh || (c != 1 && c != heads) || g < 1 ||
      g * (lq > lk ? lq : lk) > kMaxRows)
    return none;
  const Plan p = layout(g, c, lq, lk, d, self_attn, tsize);
  return p.total <= kSmemLimit ? p : none;
}

template <typename T, typename TW>
struct Args {
  const T* x;
  const T* kv;
  const unsigned char* mask;  // [B, Lk] bool, or null
  const TW* w[4];             // wq, wk, wv, wo [D, D] ([in, out])
  const float* bias[4];       // bq, bk, bv, bo [D]
  const float* gamma;
  const float* beta;
  T* out;
  int batch, lq, lk, d, heads;
  float scale, eps;
  int self_attn;
};

// Rows [0, m) of a [.., d] global tensor into shared rows of stride ld;
// rows [m, rows) zero.
template <typename T>
__device__ void load_rows(T* dst, int ld, const T* src, int m, int rows, int d) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = d / V;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * V;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < m) v = *reinterpret_cast<const uint4*>(src + (size_t)r * d + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
  }
}

// The block's products: a . W over k = d for rows [0, rows) and the n
// columns of `w` (rows of the [d, d] weights at stride d) on the weight
// ring (t2l::fused::project).
template <typename T, typename TW, class Epi>
__device__ void project(const T* a, int lda, int rows, const Cols<TW> w, int d, int n,
                        unsigned char* ring, const Epi& epi) {
  t2l::fused::project<kMaxRows / 16, kPassTiles, kStages>(a, lda, rows, w, d, d, n, ring, epi);
}

// The block's w columns of each of [q|k|v] (from `off` on: cross-attention's
// kv pass starts at w): q = round((v + bq) * scale), k, v = round(v + b);
// the biases at the block's first column.
template <typename T>
struct EpiQKV {
  T* q;
  T* k;
  T* v;
  int ld, w, off;
  const float* bq;
  const float* bk;
  const float* bv;
  float scale;
  __device__ void operator()(int r, int col, float v0, float v1) const {
    const int c = col + off;
    if (c < w) {
      store2<T>(q + r * ld + c, (v0 + bq[c]) * scale, (v1 + bq[c + 1]) * scale);
    } else if (c < 2 * w) {
      const int cc = c - w;
      store2<T>(k + r * ld + cc, v0 + bk[cc], v1 + bk[cc + 1]);
    } else {
      const int cc = c - 2 * w;
      store2<T>(v + r * ld + cc, v0 + bv[cc], v1 + bv[cc + 1]);
    }
  }
};

// s2 (f32) = (f32(x) + o Wo) + bo over the block's columns (x and bo at
// the block's first column).
template <typename T>
struct EpiResidual {
  float* s2;
  int lds;
  const T* x;
  int ldx;
  const float* bo;
  __device__ void operator()(int r, int col, float v0, float v1) const {
    const T* xr = x + r * ldx + col;
    store2<float>(s2 + r * lds + col, (t2l::to_f(xr[0]) + v0) + bo[col],
                  (t2l::to_f(xr[1]) + v1) + bo[col + 1]);
  }
};


// One (sample, head) on one warp: q, k, v of the sample's rows (strides
// ld, the head's columns), o written over q. Query rows in m16 tiles;
// s[j]: the scores of keys 8j..8j+7 in the mma accumulator layout.
template <typename T>
__device__ void attend(T* q, const T* k, const T* v, const unsigned char* mask, int lq,
                       int lk, int dh, int ld) {
  const int lane = threadIdx.x & 31, quad = lane & 3;
  for (int m0 = 0; m0 < lq; m0 += 16) {
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const int ra = m0 + (lane >> 2), rb = ra + 8;
    if constexpr (std::is_same<T, bf16>::value) {
      const int qrow = min(m0 + (lane & 15), lq - 1);
      const int mat = lane >> 3;
      for (int e0 = 0; e0 < dh; e0 += 16) {
        uint32_t af[4];
        ldmatrix_x4(af, q + qrow * ld + e0 + (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          if (j * 8 < lk) {
            const int key = min(j * 8 + (mat >> 1) * 8 + (lane & 7), lk - 1);
            uint32_t r[4];
            ldmatrix_x4(r, k + key * ld + e0 + (mat & 1) * 8);
            mma_bf16(s[j], af, r[0], r[1]);
            mma_bf16(s[j + 1], af, r[2], r[3]);
          }
        }
      }
    } else {
      const T* qa = q + min(ra, lq - 1) * ld;
      const T* qb = q + min(rb, lq - 1) * ld;
      for (int e = 0; e < dh; ++e) {
        const float a0 = qa[e], a1 = qb[e];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j * 8 < lk) {
            const int k0 = min(j * 8 + 2 * quad, lk - 1), k1 = min(j * 8 + 2 * quad + 1, lk - 1);
            const float b0 = k[k0 * ld + e], b1 = k[k1 * ld + e];
            s[j][0] = fmaf(a0, b0, s[j][0]);
            s[j][1] = fmaf(a0, b1, s[j][1]);
            s[j][2] = fmaf(a1, b0, s[j][2]);
            s[j][3] = fmaf(a1, b1, s[j][3]);
          }
        }
      }
    }

    // Softmax over the real keys of rows ra (s[.][0..1]) and rb
    // (s[.][2..3]): the key bias, the max and the sum across the quad.
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = j * 8 + 2 * quad + e;
        if (key < lk) {
          const float kb = mask != nullptr && !mask[key] ? kMasked : 0.f;
          s[j][e] += kb;
          s[j][2 + e] += kb;
          mx_a = fmaxf(mx_a, s[j][e]);
          mx_b = fmaxf(mx_b, s[j][2 + e]);
        }
      }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o));
    }
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool real = j * 8 + 2 * quad + e < lk;
        s[j][e] = real ? expf(s[j][e] - mx_a) : 0.f;
        s[j][2 + e] = real ? expf(s[j][2 + e] - mx_b) : 0.f;
        sum_a += s[j][e];
        sum_b += s[j][2 + e];
      }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, o);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, o);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = t2l::round_to<T>(s[j][e] / sum_a);
        s[j][2 + e] = t2l::round_to<T>(s[j][2 + e] / sum_b);
      }

    // o = p v over the keys; dh / 8 output tiles.
    float o[kMaxDh / 8][4];
#pragma unroll
    for (int t = 0; t < kMaxDh / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
    if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
      for (int kt = 0; kt < kMaxKeys / 16; ++kt) {
        if (kt * 16 >= lk) break;
        uint32_t af[4] = {pack_bf16(s[2 * kt][0], s[2 * kt][1]),
                          pack_bf16(s[2 * kt][2], s[2 * kt][3]),
                          pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
                          pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3])};
        const int key = min(kt * 16 + (lane & 15), lk - 1);
#pragma unroll
        for (int t = 0; t < kMaxDh / 8; t += 2) {
          if (t * 8 < dh) {
            uint32_t r[4];
            ldmatrix_x4_trans(r, v + key * ld + t * 8 + (lane >> 4) * 8);
            mma_bf16(o[t], af, r[0], r[1]);
            mma_bf16(o[t + 1], af, r[2], r[3]);
          }
        }
      }
    } else {
      const int src = lane & ~3;
#pragma unroll
      for (int key = 0; key < kMaxKeys; ++key) {
        if (key >= lk) break;
        const int j = key >> 3, owner = src | ((key & 7) >> 1), e = key & 1;
        const float pa = __shfl_sync(0xffffffffu, s[j][e], owner);
        const float pb = __shfl_sync(0xffffffffu, s[j][2 + e], owner);
#pragma unroll
        for (int t = 0; t < kMaxDh / 8; ++t) {
          if (t * 8 < dh) {
            const float2 vv = *reinterpret_cast<const float2*>(v + key * ld + t * 8 + 2 * quad);
            o[t][0] = fmaf(pa, vv.x, o[t][0]);
            o[t][1] = fmaf(pa, vv.y, o[t][1]);
            o[t][2] = fmaf(pb, vv.x, o[t][2]);
            o[t][3] = fmaf(pb, vv.y, o[t][3]);
          }
        }
      }
    }
    __syncwarp();  // every lane's reads of these q rows are done
#pragma unroll
    for (int t = 0; t < kMaxDh / 8; ++t) {
      if (t * 8 < dh) {
        const int col = t * 8 + 2 * quad;
        if (ra < lq) store2<T>(q + ra * ld + col, o[t][0], o[t][1]);
        if (rb < lq) store2<T>(q + rb * ld + col, o[t][2], o[t][3]);
      }
    }
    __syncwarp();
  }
}

template <typename T, typename TW>
__global__ void __launch_bounds__(kThreads)
    mha_addln_kernel(const Args<T, TW> A, const Plan L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  T* xs = reinterpret_cast<T*>(smem_raw + L.xs);
  T* os = reinterpret_cast<T*>(smem_raw + L.os);  // cluster: o of every head
  T* qh = reinterpret_cast<T*>(smem_raw + L.qh);  // the block's q, later its o
  T* kh = reinterpret_cast<T*>(smem_raw + L.kh);
  T* vh = reinterpret_cast<T*>(smem_raw + L.vh);
  T* kvs = L.cluster > 1 ? os : qh;               // cross: kv rows until projected
  float* s2 = reinterpret_cast<float*>(smem_raw + L.s2);       // over k, v after the core
  float* part = reinterpret_cast<float*>(smem_raw + L.stats);  // [rows] partial sums
  float* stat = part + L.rows;                                 // [rows] cluster means
  unsigned char* ring = smem_raw + L.ring;

  const int d = A.d, lq = A.lq, lk = A.lk, nc = L.cluster;
  const int dh = d / A.heads, w = d / nc, hpb = A.heads / nc;
  const int rank = (int)cluster.block_rank();
  const int g0 = (blockIdx.x / nc) * L.samples;
  const int ns = min(L.samples, A.batch - g0);
  const int m = ns * lq;

  load_rows<T>(xs, L.ldx, A.x + (size_t)g0 * lq * d, m, L.rows, d);
  if (!A.self_attn) load_rows<T>(kvs, L.ldx, A.kv + (size_t)g0 * lk * d, ns * lk, L.krows, d);
  __syncthreads();

  const int c0 = rank * w;  // the block's first column (its heads, its out columns)
  const float* const* bias = A.bias;
  if (A.self_attn) {
    const EpiQKV<T> epi{qh, kh, vh, L.ldw, w, 0, bias[0] + c0, bias[1] + c0, bias[2] + c0,
                        A.scale};
    project<T, TW>(xs, L.ldx, L.rows, Cols<TW>{{A.w[0] + c0, A.w[1] + c0, A.w[2] + c0}, w},
                   d, 3 * w, ring, epi);
  } else {
    const EpiQKV<T> ekv{qh, kh, vh, L.ldw, w, w, bias[0] + c0, bias[1] + c0, bias[2] + c0,
                        A.scale};
    project<T, TW>(kvs, L.ldx, L.krows, Cols<TW>{{A.w[1] + c0, A.w[2] + c0, A.w[2] + c0}, w},
                   d, 2 * w, ring, ekv);
    const EpiQKV<T> eq{qh, kh, vh, L.ldw, w, 0, bias[0] + c0, bias[1] + c0, bias[2] + c0,
                       A.scale};
    project<T, TW>(xs, L.ldx, L.rows, Cols<TW>{{A.w[0] + c0, A.w[0] + c0, A.w[0] + c0}, w},
                   d, w, ring, eq);
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = warp; t < ns * hpb; t += kWarps) {
    const int sm = t / hpb, hc = (t - sm * hpb) * dh;
    attend<T>(qh + sm * lq * L.ldw + hc, kh + sm * lk * L.ldw + hc, vh + sm * lk * L.ldw + hc,
              A.mask != nullptr ? A.mask + (size_t)(g0 + sm) * lk : nullptr, lq, lk, dh, L.ldw);
  }
  const T* o = qh;
  int ldo = L.ldw;
  if (nc > 1) {
    cluster.sync();  // every block's o is in place
    // Gather o of every block into os [rows, d]: 16-byte pieces of rows
    // [0, m) from each block's qh.
    constexpr int V = 16 / sizeof(T);
    const int per = w / V;
    for (int p = 0; p < nc; ++p) {
      const T* src = cluster.map_shared_rank(qh, p);
      for (int i = threadIdx.x; i < m * per; i += kThreads) {
        const int r = i / per, c = (i - r * per) * V;
        *reinterpret_cast<uint4*>(os + r * L.ldx + p * w + c) =
            *reinterpret_cast<const uint4*>(src + r * L.ldw + c);
      }
    }
    cluster.sync();  // every block has read every qh
    o = os;
    ldo = L.ldx;
  } else {
    __syncthreads();
  }

  const EpiResidual<T> er{s2, L.lds, xs + c0, L.ldx, bias[3] + c0};
  project<T, TW>(o, ldo, L.rows, Cols<TW>{{A.w[3] + c0, A.w[3] + c0, A.w[3] + c0}, w}, d, w,
                 ring, er);

  // LayerNorm over the cluster's columns: the row sums, then the centred
  // squares, each a partial per block summed over the cluster in rank order.
  for (int r = warp; r < m; r += kWarps) {
    float s = 0.f;
    for (int c = lane; c < w; c += 32) s += s2[r * L.lds + c];
    s = t2l::warp_sum(s);
    if (lane == 0) part[r] = s;
  }
  cluster.sync();
  for (int r = threadIdx.x; r < m; r += kThreads) {
    float s = 0.f;
    for (int p = 0; p < nc; ++p) s += cluster.map_shared_rank(part, p)[r];
    stat[r] = s / (float)d;
  }
  cluster.sync();  // every block has read every part; stat holds the means
  for (int r = warp; r < m; r += kWarps) {
    const float mu = stat[r];
    float q = 0.f;
    for (int c = lane; c < w; c += 32) {
      const float t = s2[r * L.lds + c] - mu;
      q += t * t;
    }
    q = t2l::warp_sum(q);
    if (lane == 0) part[r] = q;
  }
  cluster.sync();
  for (int r = warp; r < m; r += kWarps) {
    float q = 0.f;
    for (int p = 0; p < nc; ++p) q += cluster.map_shared_rank(part, p)[r];
    const float mu = stat[r], inv = 1.0f / sqrtf(q / (float)d + A.eps);
    T* orow = A.out + (size_t)(g0 * lq + r) * d + c0;
    for (int c = lane; c < w; c += 32)
      orow[c] = t2l::from_f<T>((s2[r * L.lds + c] - mu) * inv * A.gamma[c0 + c] +
                               A.beta[c0 + c]);
  }
  if (nc > 1) cluster.sync();  // no block leaves while another reads its part
}

template <typename T, typename TW>
int launch(const void* x, const void* kv, const void* mask, const void* const* w,
           const void* const* bias, const void* gamma, const void* beta, void* out, int b,
           int lq, int lk, int d, int heads, float scale, float eps, int self_attn,
           int samples, int cluster_blocks, cudaStream_t stream) {
  const Plan L = checked(samples, cluster_blocks, lq, lk, d, heads, self_attn, (int)sizeof(T));
  if (L.total == 0) return (int)cudaErrorInvalidValue;
  if (b == 0) return (int)cudaSuccess;
  auto kern = mha_addln_kernel<T, TW>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemLimit);
  if (attr != cudaSuccess) return (int)attr;
  Args<T, TW> A;
  A.x = static_cast<const T*>(x);
  A.kv = static_cast<const T*>(kv);
  A.mask = static_cast<const unsigned char*>(mask);
  for (int i = 0; i < 4; ++i) {
    A.w[i] = static_cast<const TW*>(w[i]);
    A.bias[i] = static_cast<const float*>(bias[i]);
  }
  A.gamma = static_cast<const float*>(gamma);
  A.beta = static_cast<const float*>(beta);
  A.out = static_cast<T*>(out);
  A.batch = b;
  A.lq = lq;
  A.lk = lk;
  A.d = d;
  A.heads = heads;
  A.scale = scale;
  A.eps = eps;
  A.self_attn = self_attn;
  const int groups = (b + L.samples - 1) / L.samples;
  const int nc = L.cluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(groups * nc));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = (unsigned)nc;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, A, L);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The dynamic shared bytes of a block taking `samples` samples a group on
// a cluster of `cluster` blocks, 0 where the kernel refuses that plan.
size_t t2l_mha_addln_layout(int samples, int cluster, int lq, int lk, int d, int heads,
                            int self_attn, int dtype) {
  return checked(samples, cluster, lq, lk, d, heads, self_attn, dtype == t2l::kBF16 ? 2 : 4)
      .total;
}

// x [b,lq,d] T, kv [b,lk,d] T (ignored when self_attn: kv is x), mask
// [b,lk] bool (true: a real key) or null, wq/wk/wv/wo [d,d] ([in, out]) in
// wdtype (f32, or T), biases/gamma/beta [d] f32 -> out [b,lq,d] T; groups
// of `samples` samples, each on a cluster of `cluster` blocks (1 or heads).
int t2l_mha_addln(const void* x, const void* kv, const void* mask, const void* wq,
                  const void* bq, const void* wk, const void* bk, const void* wv,
                  const void* bv, const void* wo, const void* bo, const void* gamma,
                  const void* beta, void* out, int b, int lq, int lk, int d, int heads,
                  float scale, float eps, int self_attn, int dtype, int wdtype,
                  int samples, int cluster, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* w[4] = {wq, wk, wv, wo};
  const void* bias[4] = {bq, bk, bv, bo};
  if (dtype == t2l::kBF16 && wdtype == t2l::kF32)
    return launch<bf16, float>(x, kv, mask, w, bias, gamma, beta, out, b, lq, lk, d, heads,
                               scale, eps, self_attn, samples, cluster, st);
  if (dtype == t2l::kBF16 && wdtype == t2l::kBF16)
    return launch<bf16, bf16>(x, kv, mask, w, bias, gamma, beta, out, b, lq, lk, d, heads,
                              scale, eps, self_attn, samples, cluster, st);
  if (dtype == t2l::kF32 && wdtype == t2l::kF32)
    return launch<float, float>(x, kv, mask, w, bias, gamma, beta, out, b, lq, lk, d, heads,
                                scale, eps, self_attn, samples, cluster, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
