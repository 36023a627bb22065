// Per-cloud row gather and its backward, the exact scatter-add:
//
//   gather:  out[n, q, :] = values[n, idx[n, q], :]
//   scatter: dvalues[n, p, :] = sum over q with idx[n, q] == p of g[n, q, :]
//
// Replaces the TPU kernels text2loc_tpu/ops/pallas_gather.py:35
// gather_rows_pallas (_gather_kernel :22) and, for the differentiable
// gather_rows_grad :181, _gather_tiled :116 (forward) and _scatter_tiled
// :139 (its custom VJP :167-178). The TPU kernels build a one-hot
// selection matrix in VMEM and multiply it on the MXU, an artifact of that
// machine; here the gather is a plain row copy and the scatter a
// per-cloud sort of the indices.
//
// What bounds them on the H100: bytes (no arithmetic in the gather; one
// add per gathered element in the scatter).
// Gather design: each thread copies words of W bytes (16, 8, 4 or 2: the
// widest that divides the row's bytes and the pointers' alignment), so
// rows whose width allows it move in 16-byte loads; a block covers a chunk
// of one cloud's output rows, the grid (cloud, chunk). The copy is
// bit-exact. An index outside [0, P) yields a zero row.
// Scatter design: one block per cloud, without float atomics, in a fixed
// order. It counts each point's hits (int atomics in shared memory), takes
// the exclusive scan as each point's start, then lists each point's q in
// increasing q (one warp walks q in steps of 32; __match_any_sync ranks the
// lanes that hit the same point), and finally sums each point's rows of g
// in that order, in f32, one thread per (point, column). Two runs give
// bit-equal results. Shared memory: (2P + 1 + Q) ints.
#include "common.cuh"

namespace {

using t2l::from_f;
using t2l::to_f;

constexpr int kThreads = 256;
constexpr int kWordsPerThread = 8;
constexpr int kChunk = kThreads * kWordsPerThread;  // words per block

struct alignas(2) Word2 { unsigned short v; };

template <typename W>
__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(const W* __restrict__ values, const int* __restrict__ idx,
                       W* __restrict__ out, int p, int q, int wpr) {
  const int n = blockIdx.x;
  const W* src = values + (size_t)n * p * wpr;
  const int* ix = idx + (size_t)n * q;
  W* dst = out + (size_t)n * q * wpr;
  const int total = q * wpr;
  const int start = blockIdx.y * kChunk + threadIdx.x;
#pragma unroll
  for (int t = 0; t < kWordsPerThread; ++t) {
    const int i = start + t * kThreads;
    if (i < total) {
      const int r = i / wpr, w = i - r * wpr;
      const int j = ix[r];
      W v{};
      if (j >= 0 && j < p) v = src[(size_t)j * wpr + w];
      dst[i] = v;
    }
  }
}

template <typename W>
int launch_gather(const void* values, const void* idx, void* out, int n, int p, int q,
                  int wpr, cudaStream_t st) {
  const int chunks = (q * wpr + kChunk - 1) / kChunk;
  dim3 grid(n, chunks);
  gather_rows_kernel<W><<<grid, kThreads, 0, st>>>(static_cast<const W*>(values),
                                                  static_cast<const int*>(idx),
                                                  static_cast<W*>(out), p, q, wpr);
  return (int)cudaGetLastError();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    scatter_rows_kernel(const T* __restrict__ g, const int* __restrict__ idx,
                        T* __restrict__ dvalues, int p, int q, int c) {
  extern __shared__ int smem[];
  int* fill = smem;            // [p]: hit counts, then each point's next free slot
  int* start = smem + p;       // [p + 1]: exclusive scan of the counts
  int* list = start + p + 1;   // [q]: the q of each point's hits, in q order
  const int n = blockIdx.x;
  const int* ix = idx + (size_t)n * q;
  const T* gn = g + (size_t)n * q * c;
  for (int i = threadIdx.x; i < p; i += kThreads) fill[i] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < q; i += kThreads) {
    const int j = ix[i];
    if (j >= 0 && j < p) atomicAdd(&fill[j], 1);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    // Exclusive scan by warp 0: lane l owns points [l * per, (l + 1) * per).
    const int per = (p + 31) / 32;
    const int lo = min(lane * per, p), hi = min(lo + per, p);
    int local = 0;
    for (int i = lo; i < hi; ++i) local += fill[i];
    int incl = local;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += t;
    }
    int run = incl - local;
    for (int i = lo; i < hi; ++i) {
      const int cnt = fill[i];
      start[i] = run;
      fill[i] = run;
      run += cnt;
    }
    if (lane == 31) start[p] = incl;
    __syncwarp();
    // Stable fill in q order: lanes of one step that hit the same point
    // take consecutive slots in lane (= q) order.
    for (int q0 = 0; q0 < q; q0 += 32) {
      const int i = q0 + lane;
      int j = i < q ? ix[i] : -1;
      if (j >= p) j = -1;
      const unsigned same = __match_any_sync(0xffffffffu, j);
      const int rank = __popc(same & ((1u << lane) - 1u));
      const int base = j >= 0 ? fill[j] : 0;
      __syncwarp();
      if (j >= 0) {
        list[base + rank] = i;
        if (rank == 0) fill[j] = base + __popc(same);
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < p * c; i += kThreads) {
    const int pt = i / c, col = i - pt * c;
    float s = 0.f;
    for (int t = start[pt]; t < start[pt + 1]; ++t) s += to_f<T>(gn[(size_t)list[t] * c + col]);
    dvalues[(size_t)n * p * c + i] = from_f<T>(s);
  }
}

size_t scatter_smem(int p, int q) { return sizeof(int) * (2 * (size_t)p + 1 + q); }

template <typename T>
int launch_scatter(const void* g, const void* idx, void* dvalues, int n, int p, int q, int c,
                   cudaStream_t st) {
  const size_t smem = scatter_smem(p, q);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(scatter_rows_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  scatter_rows_kernel<T><<<n, kThreads, smem, st>>>(
      static_cast<const T*>(g), static_cast<const int*>(idx), static_cast<T*>(dvalues), p, q,
      c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// values [n, p, wpr words], idx [n, q] int32 -> out [n, q, wpr words];
// word: the word size in bytes (16, 8, 4 or 2).
int t2l_gather_rows(const void* values, const void* idx, void* out, int n, int p, int q,
                    int wpr, int word, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (word) {
    case 16: return launch_gather<uint4>(values, idx, out, n, p, q, wpr, st);
    case 8: return launch_gather<uint2>(values, idx, out, n, p, q, wpr, st);
    case 4: return launch_gather<unsigned>(values, idx, out, n, p, q, wpr, st);
    case 2: return launch_gather<Word2>(values, idx, out, n, p, q, wpr, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Shared memory of one block of the scatter (the wrapper checks the limit).
size_t t2l_scatter_rows_smem(int p, int q) { return scatter_smem(p, q); }

// g [n, q, c], idx [n, q] int32 -> dvalues [n, p, c], in the dtype (f32 or
// bf16; sums in f32).
int t2l_scatter_rows(const void* g, const void* idx, void* dvalues, int n, int p, int q,
                     int c, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == t2l::kBF16)
    return launch_scatter<__nv_bfloat16>(g, idx, dvalues, n, p, q, c, st);
  return launch_scatter<float>(g, idx, dvalues, n, p, q, c, st);
}

}  // extern "C"
