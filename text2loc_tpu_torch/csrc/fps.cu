// Farthest-point sampling, one block per point cloud.
//
// Replaces the TPU kernel text2loc_tpu/ops/pallas_fps.py
// (_fps_kernel :33 / farthest_point_sampling_pallas :89).
//
// What bounds it on the H100: S - 1 dependent rounds per cloud, each a
// min-distance update over P points and a block-wide argmax. The work per
// round is tiny (P = 256 points), so the kernel is bound by the latency of
// the round's two block barriers, not by bytes or FLOPs.
// What the design does about it: the cloud's coordinates and running
// minimum distances stay in shared memory for all rounds (the cloud is read
// from device memory once), every point has its own thread, and the argmax
// is a warp shuffle reduction plus one pass over the per-warp winners, so a
// round costs two __syncthreads. Thousands of clouds fill the 132 SMs.
//
// Rounding: the plain PyTorch version computes (x-lx)^2 + (y-ly)^2 + (z-lz)^2
// as separate tensor ops, so each product and sum is rounded on its own.
// The kernel uses the _rn intrinsics (never contracted into an FMA) in the
// same order, so distances, ties and therefore indices are bit-equal to it.
// Ties in the argmax go to the lowest index, as torch.argmax and jnp.argmax.
#include <math.h>

#include "common.cuh"

namespace {

__global__ void fps_kernel(const float* __restrict__ pts, int p, int s,
                           int* __restrict__ idx_out, float* __restrict__ xyz_out) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + p;
  float* sz = sy + p;
  float* md = sz + p;
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int sel;

  const int n = blockIdx.x;
  const float* cloud = pts + (size_t)n * p * 3;
  for (int j = threadIdx.x; j < p; j += blockDim.x) {
    sx[j] = cloud[3 * j];
    sy[j] = cloud[3 * j + 1];
    sz[j] = cloud[3 * j + 2];
    md[j] = INFINITY;
  }
  __syncthreads();

  int* idx = idx_out + (size_t)n * s;
  float* xyz = xyz_out + (size_t)n * s * 3;
  if (threadIdx.x == 0) {
    idx[0] = 0;
    xyz[0] = sx[0];
    xyz[1] = sy[0];
    xyz[2] = sz[0];
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int last = 0;
  for (int i = 1; i < s; ++i) {
    const float lx = sx[last], ly = sy[last], lz = sz[last];
    float best = -INFINITY;
    int besti = 0x7fffffff;
    for (int j = threadIdx.x; j < p; j += blockDim.x) {
      const float dx = __fsub_rn(sx[j], lx);
      const float dy = __fsub_rn(sy[j], ly);
      const float dz = __fsub_rn(sz[j], lz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      const float m = fminf(md[j], d);
      md[j] = m;
      if (m > best) {  // j grows: the first maximum of this thread is kept
        best = m;
        besti = j;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, best, off);
      const int oi = __shfl_down_sync(0xffffffffu, besti, off);
      if (ov > best || (ov == best && oi < besti)) {
        best = ov;
        besti = oi;
      }
    }
    if (lane == 0) {
      red_v[warp] = best;
      red_i[warp] = besti;
    }
    __syncthreads();
    if (warp == 0) {
      best = lane < nwarps ? red_v[lane] : -INFINITY;
      besti = lane < nwarps ? red_i[lane] : 0x7fffffff;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, best, off);
        const int oi = __shfl_down_sync(0xffffffffu, besti, off);
        if (ov > best || (ov == best && oi < besti)) {
          best = ov;
          besti = oi;
        }
      }
      if (lane == 0) sel = besti;
    }
    __syncthreads();
    last = sel;
    if (threadIdx.x == 0) {
      idx[i] = last;
      xyz[3 * i] = sx[last];
      xyz[3 * i + 1] = sy[last];
      xyz[3 * i + 2] = sz[last];
    }
  }
}

}  // namespace

extern "C" {

const char* t2l_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// points [n, p, 3] f32 -> idx [n, s] int32, coords [n, s, 3] f32.
int t2l_fps(const void* points, void* idx, void* coords, int n, int p, int s,
            void* stream) {
  int threads = ((p + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = sizeof(float) * 4 * (size_t)p;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fps_kernel<<<n, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), p, s, static_cast<int*>(idx),
      static_cast<float*>(coords));
  return (int)cudaGetLastError();
}

}  // extern "C"
