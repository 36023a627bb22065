// The transposed TF32 split of the tiled chains' f32 weights: for each
// weight W [K, N] (row-major, as the caller holds it, [in, out])
//   hi = tf32_rna(W^T), lo = tf32_rna(W^T - hi), both [N, K] f32,
// the B operand of gemm_wgmma.cuh's 3xTF32 products, which wgmma takes
// K-major only. Up to four weights a call, their splits one after another
// in two flat buffers (the attention chain: Wq, Wk, Wv, Wo, so that rows
// 0 .. 3D are the packed [Wq|Wk|Wv]^T; the feed-forward chain: W1, W2).
//
// It replaces no TPU kernel of its own: it is the first stage of the tiled
// chains that port text2loc_tpu/ops/pallas_mha.py:137 and
// text2loc_tpu/ops/pallas_ffn.py:47 (the TPU's MXU takes f32 operands as
// they are). Its plain version is ops/cuda_split.split_t_plain, which it
// equals bit for bit.
//
// What bounds it on the H100 (3.35 TB/s, a 700 W power limit): bytes.
// Each weight element is read once (4 bytes) and written twice (8 bytes),
// no arithmetic to speak of: a 16 MB weight (D = 1024, F = 4096) takes
// 14.3 us. What the design does about it: 64 x 64 tiles through shared
// memory (a row padded by one word), read a W row segment and written a
// W^T row segment at a time in 16-byte vectors where every K and N is a
// multiple of 4 and every pointer 16-byte aligned (the chains' weights),
// else element by element; a grid of resident blocks walking every
// weight's tiles.
#include "common.cuh"
#include "gemm_tc.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr int kMaxMats = 4;

struct Mats {
  const float* w[kMaxMats];
  int k[kMaxMats], n[kMaxMats];
  long long out[kMaxMats];   // offset of the weight's split in the outputs
  int tiles[kMaxMats + 1];   // first tile of each weight, then the total
};

// V values a access: 4 (16-byte vectors) or 1.
template <int V>
__device__ __forceinline__ void load(float (&v)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    v[0] = *p;
  }
}
template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *p = v[0];
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    split_t_kernel(const __grid_constant__ Mats m, float* __restrict__ hi,
                   float* __restrict__ lo) {
  constexpr int kPer = kTile / V;               // accesses a tile row
  constexpr int kRows = kThreads / kPer;        // tile rows a pass
  __shared__ float tile[kTile][kTile + 1];
  const int tc = threadIdx.x % kPer, tr = threadIdx.x / kPer;
  for (int b = blockIdx.x; b < m.tiles[kMaxMats]; b += gridDim.x) {
    int j = 0;
#pragma unroll
    for (int i = 1; i < kMaxMats; ++i) j += b >= m.tiles[i];
    const int k = m.k[j], n = m.n[j], tn = (n + kTile - 1) / kTile;
    const int t = b - m.tiles[j], k0 = (t / tn) * kTile, n0 = (t % tn) * kTile;
    const float* w = m.w[j];
    // W rows k0.. (columns n0 + V tc ..) into tile[k][n].
#pragma unroll
    for (int r = tr; r < kTile; r += kRows) {
      if (k0 + r < k && n0 + V * tc < n) {
        float v[V];
        load<V>(v, w + (size_t)(k0 + r) * n + n0 + V * tc);
#pragma unroll
        for (int e = 0; e < V; ++e) tile[r][V * tc + e] = v[e];
      }
    }
    __syncthreads();
    // W^T rows n0.. (columns k0 + V tc ..) from tile[k][n], split.
    float* h = hi + m.out[j];
    float* l = lo + m.out[j];
#pragma unroll
    for (int r = tr; r < kTile; r += kRows) {
      if (n0 + r < n && k0 + V * tc < k) {
        float vh[V], vl[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float x = tile[V * tc + e][r];
          const uint32_t xh = t2l::tf32_rna(x);
          vh[e] = __uint_as_float(xh);
          vl[e] = __uint_as_float(t2l::tf32_rna(x - vh[e]));
        }
        const size_t o = (size_t)(n0 + r) * k + k0 + V * tc;
        store<V>(h + o, vh);
        store<V>(l + o, vl);
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// w0..w3 [k_j, n_j] f32 row-major (nmat of them, 1 to 4) -> hi, lo: the
// split of W_j^T [n_j, k_j] at offset sum_{i<j} k_i n_i elements of each.
int t2l_tf32_split_t(const void* w0, int k0, int n0, const void* w1, int k1, int n1,
                     const void* w2, int k2, int n2, const void* w3, int k3, int n3, int nmat,
                     void* hi, void* lo, void* stream) {
  if (nmat < 1 || nmat > kMaxMats) return (int)cudaErrorInvalidValue;
  const void* w[kMaxMats] = {w0, w1, w2, w3};
  const int ks[kMaxMats] = {k0, k1, k2, k3}, ns[kMaxMats] = {n0, n1, n2, n3};
  Mats m{};
  long long out = 0;
  int tiles = 0;
  for (int j = 0; j < kMaxMats; ++j) {
    m.tiles[j] = tiles;
    if (j >= nmat) continue;
    if (ks[j] < 0 || ns[j] < 0) return (int)cudaErrorInvalidValue;
    m.w[j] = static_cast<const float*>(w[j]);
    m.k[j] = ks[j];
    m.n[j] = ns[j];
    m.out[j] = out;
    out += (long long)ks[j] * ns[j];
    const long long t =
        (long long)((ks[j] + kTile - 1) / kTile) * ((ns[j] + kTile - 1) / kTile);
    if (tiles + t > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    tiles += (int)t;
  }
  m.tiles[kMaxMats] = tiles;
  if (tiles == 0) return (int)cudaSuccess;
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  bool vec = aligned(hi) && aligned(lo);
  for (int j = 0; j < nmat; ++j) vec = vec && ks[j] % 4 == 0 && ns[j] % 4 == 0 && aligned(w[j]);
  // Resident blocks only (8 a SM by their threads); each walks tiles.
  const int cap = 8 * t2l::gemm::sm_count(), grid = tiles < cap ? tiles : cap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* h = static_cast<float*>(hi);
  float* l = static_cast<float*>(lo);
  if (vec)
    split_t_kernel<4><<<grid, kThreads, 0, st>>>(m, h, l);
  else
    split_t_kernel<1><<<grid, kThreads, 0, st>>>(m, h, l);
  return (int)cudaGetLastError();
}

}  // extern "C"
