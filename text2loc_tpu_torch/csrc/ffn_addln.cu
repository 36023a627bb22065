// Post-LN feed-forward block to d = 256 over tiles of rows:
//   out = LayerNorm(x + relu(x @ W1 + b1) @ W2 + b2) * gamma + beta
//
// Replaces the TPU kernel text2loc_tpu/ops/pallas_ffn.py
// (_ffn_addln_kernel :31 / fused_ffn_addlayernorm :47).
//
// Numerics follow the TPU kernel: both products sum in f32, the hidden is
// relu'd in f32 and rounded to the compute dtype, the residual sum and the
// LayerNorm statistics are f32, the output is in the compute dtype. The
// weights are read as the caller holds them (f32 or the compute dtype) and
// rounded to the compute dtype (round to nearest even, as Tensor.to and the
// TPU kernel's w.astype) as they are used.
//
// What bounds it on the H100: a row is 4 D F flops against 2 D F weights
// (2 MB in f32 at D = 256, F = 1024). A serve request's calls have 6-160
// rows: there a call is bound by how fast the SMs that take it read the
// weights from L2 (a few tens of GB/s an SM) and by its chain of steps.
// At thousands of rows the products and the weight re-reads (once per tile
// of rows) bound it.
// What the design does about it:
// - The caller plans a tile of rows and a cluster of C blocks per tile
//   (ops/cuda_ffn.fused_plan: the largest C of 8, 4, 2 whose tiles fill at
//   most one wave of the SMs, 16 for a call of one tile; else tiles of up
//   to 80 rows, one wave, on the fewest blocks whose layout takes them);
//   the kernel checks the plan against its layout. Block c of a cluster reads
//   only its F / C columns of W1 and its F / C rows of W2. Its hidden slice
//   h_c = round(relu(x W1[:, c] + b1[c])) stays in its shared memory; its
//   f32 partial p_c = h_c W2[c, :] [tile, D] goes, D / C columns to each
//   block of the cluster, through distributed shared memory. Each block
//   sums the partials of its columns in rank order and adds x and b2; the
//   LayerNorm's row sums, then its centred squares, go to every block and
//   are summed there (two passes, as the plain version). Blocks only write
//   each other's shared memory, and three cluster barriers order it. So at
//   B = 1 the weight read is spread over C SMs, and at many rows a tile of
//   up to 80 rows shares each read.
// - Products on the tensor cores (t2l::fused::project, the ring of
//   mha_addln.cu): bf16 as mma.sync.m16n8k16 with f32 sums, f32 as 3xTF32
//   with per-k8 partials, never TF32 alone. The weights stream through a
//   cp.async ring in chunks of 16 rows of k; the x tile's load is in flight
//   with the first chunk.
// - Rows past R are clamped to the last row on load and never stored.
// - One device op per call.
#include <cooperative_groups.h>

#include "common.cuh"
#include "fused_block.cuh"
#include "gemm_tc.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using t2l::fused::Cols;
using t2l::fused::kThreads;
using t2l::fused::kWarps;

constexpr int kMaxRows = 80;     // rows of a tile: five m16 tiles
constexpr int kMaxD = 256;
constexpr int kMaxCluster = 16;  // past 8, the non-portable cluster size
constexpr int kPassTiles = 4;    // n8 tiles a warp per pass: 256 columns, D in one pass
constexpr int kStages = 3;       // weight chunks of the ring
constexpr size_t kRingBytes = kStages * t2l::fused::stage_bytes(kPassTiles);
constexpr size_t kSmemLimit = 232448;

// Shared rows in the dtype are padded by 16 bytes (conflict-free ldmatrix
// rows and fragment loads), f32 rows by 4 floats.
__host__ __device__ constexpr int row_pad(int tsize) { return tsize == 2 ? 8 : 4; }

struct Plan {
  int rows, cluster, ldx, ldh, lds;
  size_t xs, hs, s2, stats, ring, total;
};

// Shared layout of one block of a cluster of c blocks taking a tile of
// `tile` rows, f / c hidden and dc = d / c output columns a block: the x
// rows and the block's hidden slice in the dtype; the f32 rows of its
// output columns from each block of the cluster [c][tile][dc] (with c = 1
// the pre-norm rows; with c > 1 the second product's partials, rank 0's
// slab then the pre-norm rows); the LayerNorm's row sums and centred
// squares from each block [2][c][tile]; the weight ring.
__host__ __device__ inline Plan layout(int tile, int c, int d, int f, int tsize) {
  Plan p;
  p.rows = tile;
  p.cluster = c;
  p.ldx = d + row_pad(tsize);
  p.ldh = f / c + row_pad(tsize);
  p.lds = d / c + 4;
  size_t off = 0;
  p.xs = off;
  off = t2l::align16(off + (size_t)tsize * tile * p.ldx);
  p.hs = off;
  off = t2l::align16(off + (size_t)tsize * tile * p.ldh);
  p.s2 = off;
  off = t2l::align16(off + sizeof(float) * (size_t)c * tile * p.lds);
  p.stats = off;
  off = t2l::align16(off + 2 * sizeof(float) * (size_t)c * tile);
  p.ring = off;
  p.total = off + kRingBytes;
  return p;
}

// The layout of a call taking tiles of `tile` rows on clusters of c blocks,
// as the caller planned it (ops/cuda_ffn.fused_plan); total = 0 where the
// kernel does not take it: D off the multiples of 16 or past kMaxD, a tile
// off the multiples of 16 or past kMaxRows, c not 1, 2, 4, 8 or 16, F not
// split by c into multiples of 16 or D into multiples of 8, or the layout
// past a block's shared memory.
__host__ __device__ inline Plan checked(int tile, int c, int d, int f, int tsize) {
  Plan none{};
  none.total = 0;
  if (d < 16 || d > kMaxD || d % 16 || f < 16 || tile < 16 || tile > kMaxRows || tile % 16 ||
      (c & (c - 1)) || c > kMaxCluster || f % (16 * c) || d % (8 * c))
    return none;
  const Plan p = layout(tile, c, d, f, tsize);
  return p.total <= kSmemLimit ? p : none;
}

template <typename T, typename TW>
struct Args {
  const T* x;
  const TW* w1;        // [d, f] ([in, out])
  const float* b1;     // [f]
  const TW* w2;        // [f, d]
  const float* b2;     // [d]
  const float* gamma;
  const float* beta;
  T* out;
  int rows, d, f;
  float eps;
};

// Rows [0, rows) of a [.., d] global tensor into shared rows of stride ld
// by cp.async, rows at or past m clamped to row m - 1; one committed group.
template <typename T>
__device__ void load_tile(T* dst, int ld, const T* src, int m, int rows, int d) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = d / V;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * V;
    t2l::gemm::cp_async16(dst + r * ld + c, src + (size_t)min(r, m - 1) * d + c, 16);
  }
  t2l::gemm::cp_async_commit();
}

// The second product's partial over the block's hidden slice, pushed into
// the shared memory of the block that owns its columns (rank col / dc):
// there at [rank][r][col % dc] of its s2 slabs.
struct EpiPush {
  float* s2;   // this block's slabs; the owner's are at the same offset
  int lds, dc, tile, rank;
  __device__ void operator()(int r, int col, float v0, float v1) const {
    const int owner = col / dc;
    float* dst = cg::this_cluster().map_shared_rank(s2, owner);
    t2l::gemm::store2<float>(dst + ((size_t)rank * tile + r) * lds + (col - owner * dc), v0, v1);
  }
};

template <typename T, typename TW>
__global__ void __launch_bounds__(kThreads)
    ffn_addln_kernel(const Args<T, TW> A, const Plan L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw + L.xs);
  T* hs = reinterpret_cast<T*>(smem_raw + L.hs);
  float* s2 = reinterpret_cast<float*>(smem_raw + L.s2);
  float* sums = reinterpret_cast<float*>(smem_raw + L.stats);  // [c][tile] row sums
  float* sqs = sums + L.cluster * L.rows;                      // [c][tile] centred squares
  unsigned char* ring = smem_raw + L.ring;

  constexpr int MT = kMaxRows / 16;
  const int d = A.d, nc = L.cluster, fc = A.f / nc, dc = d / nc, tile = L.rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rank = nc > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int row0 = (blockIdx.x / nc) * tile;
  const int m = min(tile, A.rows - row0);
  const int f0 = rank * fc, c0 = rank * dc;  // the block's first hidden and output column

  // A cluster's blocks write each other's shared memory from the second
  // product on: the arrival here, the wait before that (every block runs).
  if (nc > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  load_tile<T>(xs, L.ldx, A.x + (size_t)row0 * d, m, tile, d);
  const TW* w1 = A.w1 + f0;
  t2l::fused::project<MT, kPassTiles, kStages>(xs, L.ldx, tile, Cols<TW>{{w1, w1, w1}, fc}, d,
                                               A.f, fc, ring,
                                               t2l::gemm::EpiBiasRelu<T>{hs, L.ldh, A.b1 + f0});
  const TW* w2 = A.w2 + (size_t)f0 * d;
  const Cols<TW> w2c{{w2, w2, w2}, d};
  if (nc == 1) {
    t2l::fused::project<MT, kPassTiles, kStages>(
        hs, L.ldh, tile, w2c, fc, d, d, ring,
        t2l::gemm::EpiResidual<T>{s2, L.lds, A.b2, xs, L.ldx});
    for (int r = warp; r < m; r += kWarps)
      t2l::warp_layernorm_row<T>(s2 + (size_t)r * L.lds, d, A.gamma, A.beta, A.eps,
                                 A.out + (size_t)(row0 + r) * d);
    return;
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  t2l::fused::project<MT, kPassTiles, kStages>(hs, L.ldh, tile, w2c, fc, d, d, ring,
                                               EpiPush{s2, L.lds, dc, tile, rank});
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's partial of this block's columns is in place
  // The pre-norm rows of the block's columns, over rank 0's slab: (f32(x) +
  // the partials summed in rank order) + b2.
  for (int i = threadIdx.x; i < m * dc; i += kThreads) {
    const int r = i / dc, j = i - r * dc;
    float acc = 0.f;
    for (int p = 0; p < nc; ++p) acc += s2[((size_t)p * tile + r) * L.lds + j];
    s2[(size_t)r * L.lds + j] = (t2l::to_f(xs[r * L.ldx + c0 + j]) + acc) + A.b2[c0 + j];
  }
  __syncthreads();
  // The LayerNorm over the cluster's columns in two passes, as the plain
  // version: each block's row sums, then its centred squares about the
  // row mean, pushed to every block and summed there in rank order. After
  // the last cluster barrier no block touches another's shared memory.
  for (int r = warp; r < m; r += kWarps) {
    float v = 0.f;
    for (int c = lane; c < dc; c += 32) v += s2[(size_t)r * L.lds + c];
    v = t2l::warp_sum(v);
    if (lane < nc) cluster.map_shared_rank(sums, lane)[rank * tile + r] = v;
  }
  cluster.sync();
  for (int r = warp; r < m; r += kWarps) {
    float mu = 0.f;
    for (int p = 0; p < nc; ++p) mu += sums[p * tile + r];
    mu /= (float)d;
    float q = 0.f;
    for (int c = lane; c < dc; c += 32) {
      const float t = s2[(size_t)r * L.lds + c] - mu;
      q += t * t;
    }
    q = t2l::warp_sum(q);
    if (lane < nc) cluster.map_shared_rank(sqs, lane)[rank * tile + r] = q;
  }
  cluster.sync();
  for (int r = warp; r < m; r += kWarps) {
    float mu = 0.f, q = 0.f;
    for (int p = 0; p < nc; ++p) {
      mu += sums[p * tile + r];
      q += sqs[p * tile + r];
    }
    mu /= (float)d;
    const float inv = 1.0f / sqrtf(q / (float)d + A.eps);
    T* orow = A.out + (size_t)(row0 + r) * d + c0;
    for (int c = lane; c < dc; c += 32)
      orow[c] = t2l::from_f<T>((s2[(size_t)r * L.lds + c] - mu) * inv * A.gamma[c0 + c] +
                               A.beta[c0 + c]);
  }
}

template <typename T, typename TW>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
           const void* gamma, const void* beta, void* out, int rows, int d, int f, float eps,
           int tile, int cluster_blocks, cudaStream_t stream) {
  const Plan L = checked(tile, cluster_blocks, d, f, (int)sizeof(T));
  if (L.total == 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  auto kern = ffn_addln_kernel<T, TW>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemLimit);
  if (attr != cudaSuccess) return (int)attr;
  static const cudaError_t wide = cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (wide != cudaSuccess) return (int)wide;
  Args<T, TW> A;
  A.x = static_cast<const T*>(x);
  A.w1 = static_cast<const TW*>(w1);
  A.b1 = static_cast<const float*>(b1);
  A.w2 = static_cast<const TW*>(w2);
  A.b2 = static_cast<const float*>(b2);
  A.gamma = static_cast<const float*>(gamma);
  A.beta = static_cast<const float*>(beta);
  A.out = static_cast<T*>(out);
  A.rows = rows;
  A.d = d;
  A.f = f;
  A.eps = eps;
  const int tiles = (rows + L.rows - 1) / L.rows;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * L.cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = (unsigned)L.cluster;
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

// The dynamic shared bytes of a block taking tiles of `tile` rows on
// clusters of `cluster` blocks, 0 where the kernel refuses that plan.
size_t t2l_ffn_addln_layout(int tile, int cluster, int d, int f, int dtype) {
  return checked(tile, cluster, d, f, dtype == t2l::kBF16 ? 2 : 4).total;
}

// x [rows,d] T, w1 [d,f] and w2 [f,d] in wdtype (f32, or T), b1 [f] f32,
// b2/gamma/beta [d] f32 -> out [rows,d] T; tiles of `tile` rows, each on a
// cluster of `cluster` blocks.
int t2l_ffn_addln(const void* x, const void* w1, const void* b1, const void* w2,
                  const void* b2, const void* gamma, const void* beta, void* out, int rows,
                  int d, int f, float eps, int dtype, int wdtype, int tile, int cluster,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == t2l::kBF16 && wdtype == t2l::kF32)
    return launch<bf16, float>(x, w1, b1, w2, b2, gamma, beta, out, rows, d, f, eps, tile,
                               cluster, st);
  if (dtype == t2l::kBF16 && wdtype == t2l::kBF16)
    return launch<bf16, bf16>(x, w1, b1, w2, b2, gamma, beta, out, rows, d, f, eps, tile,
                              cluster, st);
  if (dtype == t2l::kF32 && wdtype == t2l::kF32)
    return launch<float, float>(x, w1, b1, w2, b2, gamma, beta, out, rows, d, f, eps, tile,
                                cluster, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
