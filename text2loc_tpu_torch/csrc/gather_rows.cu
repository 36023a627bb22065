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
// Gather design (staged variant): the output is written once, in 16-byte
// stores, and the cloud is read from device memory once. A block owns one
// cloud's span of output bytes (the grid is (cloud, chunk), chunks of one
// cloud adjacent so that their staging reads hit L2); chunk starts are
// 16-byte aligned in the output, and the ragged head and tail of a cloud's
// span (rows whose bytes are not a multiple of 16) are written in words of
// W bytes (16, 8, 4 or 2: the widest that divides the row's bytes and the
// values' address). The block stages the cloud's [P, C] block in shared
// memory with 16-byte loads, a row of zeros, and, for each output row of
// its span, the offset of its source row (the zero row for an index
// outside [0, P)), each index read once. Each thread then assembles 16-byte
// segments of the output from shared memory, W bytes at a time, stepping
// its row and byte offset incrementally (one division per thread, none per
// word). The TPU kernel kept the cloud's block in VMEM likewise.
// Direct variant, where the cloud's block does not fit the shared memory of
// one block: one warp a row, its index read once, the row copied in words
// of W bytes. Both copies are bit-exact.
// Scatter design: one block per cloud, without float atomics, in a fixed
// order. It counts each point's hits (int atomics in shared memory), takes
// the exclusive scan as each point's start, then lists each point's q in
// increasing q (one warp walks q in steps of 32; __match_any_sync ranks the
// lanes that hit the same point), and finally sums each point's rows of g
// in that order, in f32, one thread per (point, column). Two runs give
// bit-equal results. Shared memory: (2P + 1 + Q) ints.
#include <limits.h>

#include "common.cuh"

namespace {

using t2l::align16;
using t2l::from_f;
using t2l::to_f;

constexpr int kThreads = 256;

template <int W>
struct WordOf;
template <>
struct WordOf<2> { using type = unsigned short; };
template <>
struct WordOf<4> { using type = unsigned; };
template <>
struct WordOf<8> { using type = uint2; };
template <>
struct WordOf<16> { using type = uint4; };

// Shared memory of the staged variant: the cloud's block (from the 16-byte
// boundary at or below its start), a zero row, and one source offset per
// output row of a chunk of cb bytes (rows it touches, plus one past).
__host__ __device__ __forceinline__ size_t stage_bytes(int p, int rb) {
  return align16((size_t)p * rb) + 16;
}
__host__ __device__ __forceinline__ int base_slots(int rb, int cb) {
  return (cb + 16) / rb + 3;
}
__host__ __device__ __forceinline__ size_t staged_smem(int p, int rb, int cb) {
  return stage_bytes(p, rb) + align16(rb) + align16(sizeof(int) * (size_t)base_slots(rb, cb));
}

template <int W>
__global__ void __launch_bounds__(kThreads)
    gather_staged_kernel(const unsigned char* __restrict__ values, const int* __restrict__ idx,
                         unsigned char* __restrict__ out, int p, int q, int rb, int cb,
                         int chunks) {
  using Word = typename WordOf<W>::type;
  extern __shared__ uint4 stage_smem[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(stage_smem);
  const int cloud = blockIdx.x / chunks;
  const int c = blockIdx.x - cloud * chunks;
  // The cloud's output bytes [a, b); this chunk's [lo, hi).
  const long long a = (long long)cloud * q * rb;
  const long long b = a + (long long)q * rb;
  const long long a16 = (a + 15) & ~15LL;
  const long long lo = c == 0 ? a : a16 + (long long)c * cb;
  const long long hi = min(b, a16 + (long long)(c + 1) * cb);
  if (lo >= hi) return;  // the whole block, before any barrier
  const int r0 = (int)((lo - a) / rb);
  const int r1 = (int)((hi - 1 - a) / rb);

  // Stage the cloud's block, the zero row and the chunk's source offsets.
  const int zero_off = (int)stage_bytes(p, rb);
  int* s_base = reinterpret_cast<int*>(smem + zero_off + align16(rb));
  const uintptr_t va = reinterpret_cast<uintptr_t>(values + (size_t)cloud * p * rb);
  const uint4* v16 = reinterpret_cast<const uint4*>(va & ~(uintptr_t)15);
  const int shift = (int)(va & 15);
  const int nv = (shift + p * rb + 15) >> 4;
  for (int i = threadIdx.x; i < nv; i += kThreads)
    reinterpret_cast<uint4*>(smem)[i] = __ldg(v16 + i);
  for (int i = threadIdx.x; i < (int)(align16(rb) >> 4); i += kThreads)
    reinterpret_cast<uint4*>(smem + zero_off)[i] = make_uint4(0u, 0u, 0u, 0u);
  const int* ix = idx + (size_t)cloud * q;
  for (int r = threadIdx.x; r <= r1 - r0 + 1; r += kThreads) {
    const int row = r0 + r;
    const int j = row < q ? __ldg(ix + row) : -1;
    s_base[r] = (unsigned)j < (unsigned)p ? shift + j * rb : zero_off;
  }
  __syncthreads();

  // The 16-byte segments [m0, m1): thread t writes segments t, t + kThreads, ...
  const long long m0 = (lo + 15) & ~15LL;
  const long long m1 = hi & ~15LL;
  const int nseg = m1 > m0 ? (int)((m1 - m0) >> 4) : 0;
  if ((int)threadIdx.x < nseg) {
    const long long off = m0 + 16LL * threadIdx.x - a;
    int r = (int)(off / rb);
    int col = (int)(off - (long long)r * rb);
    r -= r0;
    const int step = 16 * (kThreads - 1);  // bytes from a segment's end to the next's start
    const int dr = step / rb, dc = step - dr * rb;
    for (int sg = threadIdx.x; sg < nseg; sg += kThreads) {
      int base = s_base[r];
      union {
        uint4 v;
        Word w[16 / W];
      } seg;
#pragma unroll
      for (int u = 0; u < 16 / W; ++u) {
        seg.w[u] = *reinterpret_cast<const Word*>(smem + base + col);
        col += W;
        if (col == rb) {
          col = 0;
          base = s_base[++r];
        }
      }
      __stcs(reinterpret_cast<uint4*>(out + m0 + 16LL * sg), seg.v);
      col += dc;
      r += dr;
      if (col >= rb) {
        col -= rb;
        ++r;
      }
    }
  }
  // The ragged head [lo, h1) and tail [t0, hi), in words of W bytes.
  const long long h1 = min(m0, hi);
  const long long t0 = max(m1, h1);
  const int nh = (int)((h1 - lo) / W), nt = (int)((hi - t0) / W);
  for (int k = threadIdx.x; k < nh + nt; k += kThreads) {
    const long long o = k < nh ? lo + (long long)k * W : t0 + (long long)(k - nh) * W;
    const int r = (int)((o - a) / rb);
    const int col = (int)(o - a - (long long)r * rb);
    *reinterpret_cast<Word*>(out + o) =
        *reinterpret_cast<const Word*>(smem + s_base[r - r0] + col);
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
    gather_direct_kernel(const unsigned char* __restrict__ values, const int* __restrict__ idx,
                         unsigned char* __restrict__ out, long long rows, int p, int q, int rb) {
  using Word = typename WordOf<W>::type;
  const long long row = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int j = __ldg(idx + row);
  const int wpr = rb / W;
  Word* dst = reinterpret_cast<Word*>(out + row * rb);
  if ((unsigned)j < (unsigned)p) {
    const Word* src = reinterpret_cast<const Word*>(values + ((row / q) * p + j) * rb);
    for (int w = lane; w < wpr; w += 32) dst[w] = src[w];
  } else {
    for (int w = lane; w < wpr; w += 32) dst[w] = Word{};
  }
}

template <int W>
int launch_gather(const void* values, const void* idx, void* out, int n, int p, int q, int rb,
                  int cb, int chunks, cudaStream_t st) {
  const auto* v = static_cast<const unsigned char*>(values);
  const auto* ix = static_cast<const int*>(idx);
  auto* o = static_cast<unsigned char*>(out);
  if (cb == 0) {
    const long long rows = (long long)n * q;
    const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    gather_direct_kernel<W><<<(int)blocks, kThreads, 0, st>>>(v, ix, o, rows, p, q, rb);
    return (int)cudaGetLastError();
  }
  if (cb % 16 || chunks < 1 || (long long)n * chunks > INT_MAX) return (int)cudaErrorInvalidValue;
  const size_t smem = staged_smem(p, rb, cb);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(gather_staged_kernel<W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  gather_staged_kernel<W><<<n * chunks, kThreads, smem, st>>>(v, ix, o, p, q, rb, cb, chunks);
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

// Shared memory of one block of the staged gather (the wrapper's plan checks
// the limit).
size_t t2l_gather_rows_smem(int p, int row_bytes, int chunk_bytes) {
  return staged_smem(p, row_bytes, chunk_bytes);
}

// values [n, p, row_bytes], idx [n, q] int32 -> out [n, q, row_bytes] (out
// 16-byte aligned); word: the copy word in bytes (16, 8, 4 or 2), dividing
// row_bytes and the values' address. chunk_bytes > 0: the staged variant,
// `chunks` blocks a cloud of chunk_bytes output bytes each (a multiple of
// 16); 0: the direct variant.
int t2l_gather_rows(const void* values, const void* idx, void* out, int n, int p, int q,
                    int row_bytes, int word, int chunk_bytes, int chunks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (row_bytes < 1 || row_bytes % word || reinterpret_cast<uintptr_t>(values) % word ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  switch (word) {
    case 16: return launch_gather<16>(values, idx, out, n, p, q, row_bytes, chunk_bytes, chunks, st);
    case 8: return launch_gather<8>(values, idx, out, n, p, q, row_bytes, chunk_bytes, chunks, st);
    case 4: return launch_gather<4>(values, idx, out, n, p, q, row_bytes, chunk_bytes, chunks, st);
    case 2: return launch_gather<2>(values, idx, out, n, p, q, row_bytes, chunk_bytes, chunks, st);
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
