// Farthest-point sampling: one warp per point cloud (P <= 512), or one
// block per cloud above that.
//
// Replaces the TPU kernel text2loc_tpu/ops/pallas_fps.py
// (_fps_kernel :33 / farthest_point_sampling_pallas :89).
//
// What bounds it on the H100: S - 1 dependent rounds per cloud, each a
// min-distance update over P points and an argmax over them. A round's work
// is small (P = 256 points: 9 operations a point), so the chain of rounds,
// not bytes or peak FLOPs, sets the time: a round costs the latency of its
// argmax plus the issue slots of its update, about 127 x 100-300 cycles at
// S = 128.
// What the design does about it (warp variant, P <= 32 x kMaxPerLane): one
// warp per cloud, with no block barrier in the loop. Lane l holds points
// l, l + 32, ..., l + 32 (K - 1) and their running minima in registers (K
// points a lane, a template parameter), so a lane's lowest index is its
// first. The argmax is the lane's own over its K points (a tree in which
// the higher index wins only when strictly greater), then
// __reduce_max_sync over the distances' bits (non-negative floats order as
// unsigned ints) and __reduce_min_sync over the indices of the lanes that
// hold the maximum. The chosen point's coordinates come from the warp's
// copy of the cloud in shared memory (one broadcast load each). The indices
// collect in shared memory and are written once at the end, coalesced, with
// their coordinates. Points past P copy point 0: after the first round
// their running minimum is point 0's, zero, and their indices are higher,
// so they never win. 1792 clouds are 1792 warps: one wave on 132 SMs.
// Block variant (P > 32 x kMaxPerLane, up to the shared memory of one
// block): a thread per point (strided), the minima in shared memory (4 bytes
// a point), the coordinates read through the read-only cache, the same warp
// argmax, then each warp reduces the per-warp winners itself, so a round
// costs one __syncthreads (the winners are double buffered).
//
// Rounding: the plain PyTorch version computes (x-lx)^2 + (y-ly)^2 + (z-lz)^2
// as separate tensor ops, so each product and sum is rounded on its own.
// The kernel uses the _rn intrinsics (never contracted into an FMA) in the
// same order, so distances, ties and therefore indices are bit-equal to it.
// Ties in the argmax go to the lowest index, as torch.argmax and jnp.argmax.
// Coordinates are finite.
#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxPerLane = 16;   // the warp variant's largest K: P <= 512

__device__ __forceinline__ float dist2(float x, float y, float z, float lx, float ly,
                                       float lz) {
  const float dx = __fsub_rn(x, lx);
  const float dy = __fsub_rn(y, ly);
  const float dz = __fsub_rn(z, lz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// The lowest index among the warp's lanes whose distance is the largest,
// and that distance's bits in `top`. d >= 0 (its bits order as unsigned
// ints); every lane takes part.
__device__ __forceinline__ int warp_argmax(float d, int i, unsigned& top) {
  const unsigned bits = __float_as_uint(d);
  top = __reduce_max_sync(kFull, bits);
  return (int)__reduce_min_sync(kFull, bits == top ? (unsigned)i : 0xffffffffu);
}

// Per warp in shared memory: the cloud's 3P coordinates as given, then the
// S chosen indices.
__host__ __device__ __forceinline__ size_t warp_floats(int p, int s) {
  return 3 * (size_t)p + (size_t)s;
}

template <int K>
__global__ void __launch_bounds__(32 * 4)
    fps_warp_kernel(const float* __restrict__ pts, int n, int p, int s,
                    int* __restrict__ idx_out, float* __restrict__ xyz_out) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cloud = blockIdx.x * (blockDim.x >> 5) + warp;
  if (cloud >= n) return;                 // whole warps only: no block barrier below
  float* sp = smem + warp * warp_floats(p, s);
  int* sidx = reinterpret_cast<int*>(sp + 3 * p);
  const float* src = pts + (size_t)cloud * p * 3;
  for (int e = lane; e < 3 * p; e += 32) sp[e] = src[e];
  __syncwarp();

  float x[K], y[K], z[K], md[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + 32 * k;
    const int c = j < p ? 3 * j : 0;      // points past P copy point 0
    x[k] = sp[c];
    y[k] = sp[c + 1];
    z[k] = sp[c + 2];
    md[k] = INFINITY;
  }
  float lx = sp[0], ly = sp[1], lz = sp[2];
  if (lane == 0) sidx[0] = 0;
  for (int i = 1; i < s; ++i) {
    float v[K];
    int at[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      md[k] = fminf(md[k], dist2(x[k], y[k], z[k], lx, ly, lz));
      v[k] = md[k];
      at[k] = k;
    }
    // Tree over the lane's K points: the higher k wins only when greater.
#pragma unroll
    for (int step = 1; step < K; step *= 2) {
#pragma unroll
      for (int k = 0; k + step < K; k += 2 * step) {
        if (v[k + step] > v[k]) {
          v[k] = v[k + step];
          at[k] = at[k + step];
        }
      }
    }
    unsigned top;
    const int last = warp_argmax(v[0], lane + 32 * at[0], top);
    if (lane == 0) sidx[i] = last;
    lx = sp[3 * last];
    ly = sp[3 * last + 1];
    lz = sp[3 * last + 2];
  }
  __syncwarp();
  int* idx = idx_out + (size_t)cloud * s;
  float* xyz = xyz_out + (size_t)cloud * s * 3;
  for (int t = lane; t < s; t += 32) idx[t] = sidx[t];
  for (int e = lane; e < 3 * s; e += 32) {
    const int t = e / 3;
    xyz[e] = sp[3 * sidx[t] + (e - 3 * t)];
  }
}

__global__ void __launch_bounds__(1024)
    fps_block_kernel(const float* __restrict__ pts, int p, int s, int* __restrict__ idx_out,
                     float* __restrict__ xyz_out) {
  extern __shared__ float smem[];
  float* md = smem;  // [p]: the running minima; a thread owns points t, t + T, ...
  __shared__ unsigned red_v[2][32];
  __shared__ int red_i[2][32];

  const int n = blockIdx.x;
  const float* cloud = pts + (size_t)n * p * 3;
  for (int j = threadIdx.x; j < p; j += blockDim.x) md[j] = INFINITY;

  int* idx = idx_out + (size_t)n * s;
  float* xyz = xyz_out + (size_t)n * s * 3;
  if (threadIdx.x == 0) {
    idx[0] = 0;
    xyz[0] = cloud[0];
    xyz[1] = cloud[1];
    xyz[2] = cloud[2];
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int last = 0;
  for (int i = 1; i < s; ++i) {
    const float lx = __ldg(cloud + 3 * last), ly = __ldg(cloud + 3 * last + 1),
                lz = __ldg(cloud + 3 * last + 2);
    float best = -1.f;
    int besti = INT_MAX;
    for (int j = threadIdx.x; j < p; j += blockDim.x) {
      const float m = fminf(md[j], dist2(__ldg(cloud + 3 * j), __ldg(cloud + 3 * j + 1),
                                         __ldg(cloud + 3 * j + 2), lx, ly, lz));
      md[j] = m;
      if (m > best) {  // j grows: the first maximum of this thread is kept
        best = m;
        besti = j;
      }
    }
    // A thread without points reports (0, INT_MAX): it never wins.
    unsigned top;
    const int w = warp_argmax(fmaxf(best, 0.f), besti, top);
    const int buf = i & 1;
    if (lane == 0) {
      red_v[buf][warp] = top;
      red_i[buf][warp] = w;
    }
    // One barrier a round: the next round writes the other buffer, and the
    // one after it this buffer only after every warp passed the next barrier.
    __syncthreads();
    const bool has = lane < nwarps;
    last = warp_argmax(has ? __uint_as_float(red_v[buf][lane]) : 0.f,
                       has ? red_i[buf][lane] : INT_MAX, top);
    if (threadIdx.x == 0) {
      idx[i] = last;
      xyz[3 * i] = cloud[3 * last];
      xyz[3 * i + 1] = cloud[3 * last + 1];
      xyz[3 * i + 2] = cloud[3 * last + 2];
    }
  }
}

template <int K>
int launch_warp(const float* pts, int* idx, float* xyz, int n, int p, int s, int warps,
                cudaStream_t st) {
  const size_t smem = sizeof(float) * warps * warp_floats(p, s);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(fps_warp_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fps_warp_kernel<K><<<(n + warps - 1) / warps, 32 * warps, smem, st>>>(pts, n, p, s, idx, xyz);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* t2l_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of one block: the warp variant's (per_lane = K > 0,
// `warps` clouds a block) or the block variant's (per_lane = 0; beside
// its 512 static bytes).
size_t t2l_fps_smem(int p, int s, int per_lane, int warps) {
  if (per_lane > 0) return sizeof(float) * warps * warp_floats(p, s);
  return sizeof(float) * (size_t)p;
}

// points [n, p, 3] f32 -> idx [n, s] int32, coords [n, s, 3] f32.
// per_lane: K of the warp variant (1, 2, 4, 8 or 16; 32 K >= p), `warps`
// clouds a block (1 to 4); 0: the block variant, one block a cloud.
int t2l_fps(const void* points, void* idx, void* coords, int n, int p, int s, int per_lane,
            int warps, void* stream) {
  const float* pts = static_cast<const float*>(points);
  int* ix = static_cast<int*>(idx);
  float* xyz = static_cast<float*>(coords);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p < 1 || s < 1 || s > p) return (int)cudaErrorInvalidValue;
  if (per_lane > 0) {
    if (32 * per_lane < p || warps < 1 || warps > 4) return (int)cudaErrorInvalidValue;
    switch (per_lane) {
      case 1: return launch_warp<1>(pts, ix, xyz, n, p, s, warps, st);
      case 2: return launch_warp<2>(pts, ix, xyz, n, p, s, warps, st);
      case 4: return launch_warp<4>(pts, ix, xyz, n, p, s, warps, st);
      case 8: return launch_warp<8>(pts, ix, xyz, n, p, s, warps, st);
      case kMaxPerLane: return launch_warp<kMaxPerLane>(pts, ix, xyz, n, p, s, warps, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  int threads = ((p + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = t2l_fps_smem(p, s, 0, 0);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fps_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fps_block_kernel<<<n, threads, smem, st>>>(pts, p, s, ix, xyz);
  return (int)cudaGetLastError();
}

}  // extern "C"
