// Exact greedy furthest-point sampling.
//
// Replaces the TPU kernel kd_pointcloud_tpu/ops/pallas/fps_pallas.py
// furthest_point_sample_pallas (bodies _fps_kernel_folded for N % 1024 == 0
// and _fps_kernel otherwise); one kernel here covers every N up to 32768.
// Semantics are those of the plain version, ops/fps.py fps_plain: seed at
// index 0, then M-1 rounds of "running min of the squared distance to the
// last pick, then the argmax with a first-index tie-break".
//
// What bounds it on an H100: neither bytes (12 B a point, read once) nor
// operations (~9 flops a point a round), but the serial chain of M-1
// dependent rounds, each a block-wide argmax. The design keeps everything a
// round touches on chip: one block per cloud, 1024 threads, each holding its
// N/1024 points and their running minimum in registers; a round is a
// register pass, a warp-shuffle argmax, one shared-memory exchange between
// the 32 warps and a broadcast of the winner's coordinates -- two
// __syncthreads per round and no device-memory traffic but one 4-byte index
// store. With B clouds only B SMs work; that is the price of exactness.
//
// Rounding: the squared distance is written with __fmul_rn / __fadd_rn in
// the plain version's order ((dx*dx + dy*dy) + dz*dz), so nvcc cannot
// contract it into FMAs and the indices are bit-identical to the plain
// version's.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// (v, i) beats (bv, bi): larger value, or equal value and smaller index.
__device__ __forceinline__ void take_better(float& bv, int& bi, float v,
                                            int i) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

__device__ __forceinline__ void warp_argmax(float& bv, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float v = __shfl_down_sync(0xffffffffu, bv, off);
    int i = __shfl_down_sync(0xffffffffu, bi, off);
    take_better(bv, bi, v, i);
  }
}

template <int PPT>
__global__ void __launch_bounds__(kThreads, 1)
    fps_kernel(const float* __restrict__ xyz, int n, int m,
               int* __restrict__ out) {
  const float* p = xyz + (size_t)blockIdx.x * n * 3;
  int* o = out + (size_t)blockIdx.x * m;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  __shared__ float s_val[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ float s_last[3];

  // point t + j * kThreads lives in slot j of thread t
  float px[PPT], py[PPT], pz[PPT], dmin[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int i = t + j * kThreads;
    if (i < n) {
      px[j] = p[3 * i];
      py[j] = p[3 * i + 1];
      pz[j] = p[3 * i + 2];
      dmin[j] = 1e10f;
    } else {  // padding: below every real distance, never the argmax
      px[j] = py[j] = pz[j] = 0.f;
      dmin[j] = -1.f;
    }
  }
  if (t == 0) o[0] = 0;
  float lx = p[0], ly = p[1], lz = p[2];

  for (int r = 1; r < m; ++r) {
    float bv = -2.f;
    int bi = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const float dx = __fsub_rn(px[j], lx);
      const float dy = __fsub_rn(py[j], ly);
      const float dz = __fsub_rn(pz[j], lz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      dmin[j] = fminf(dmin[j], d);
      // slots ascend in point index, so '>' keeps the first maximum
      if (dmin[j] > bv) {
        bv = dmin[j];
        bi = t + j * kThreads;
      }
    }
    warp_argmax(bv, bi);
    if (lane == 0) {
      s_val[warp] = bv;
      s_idx[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = s_val[lane];
      bi = s_idx[lane];
      warp_argmax(bv, bi);
      if (lane == 0) {
        o[r] = bi;
        s_last[0] = p[3 * bi];
        s_last[1] = p[3 * bi + 1];
        s_last[2] = p[3 * bi + 2];
      }
    }
    // s_val/s_idx are rewritten only after this barrier, and s_last only
    // after the next round's first barrier, which every reader passes after
    // reading it
    __syncthreads();
    lx = s_last[0];
    ly = s_last[1];
    lz = s_last[2];
  }
}

template <int PPT>
cudaError_t launch(const float* xyz, int b, int n, int m, int* out,
                   cudaStream_t stream) {
  fps_kernel<PPT><<<b, kThreads, 0, stream>>>(xyz, n, m, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int kdpc_fps(const float* xyz, int b, int n, int m, int* out,
                        cudaStream_t stream) {
  const int ppt = (n + kThreads - 1) / kThreads;
  if (b <= 0 || m <= 0 || m > n) return (int)cudaErrorInvalidValue;
  if (ppt <= 1) return (int)launch<1>(xyz, b, n, m, out, stream);
  if (ppt <= 2) return (int)launch<2>(xyz, b, n, m, out, stream);
  if (ppt <= 4) return (int)launch<4>(xyz, b, n, m, out, stream);
  if (ppt <= 8) return (int)launch<8>(xyz, b, n, m, out, stream);
  if (ppt <= 16) return (int)launch<16>(xyz, b, n, m, out, stream);
  if (ppt <= 32) return (int)launch<32>(xyz, b, n, m, out, stream);
  return (int)cudaErrorInvalidValue;
}
