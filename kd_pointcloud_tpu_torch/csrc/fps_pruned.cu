// Exact furthest-point sampling with bounding-sphere pruning.
//
// Replaces the TPU kernel attic/fps_pruned.py furthest_point_sample_pruned
// (_fps_kernel_pruned), a kept negative result of the JAX package: the
// same function as csrc/fps.cu (seed at index 0, then M-1 rounds of
// "running min of the squared distance to the last pick, then the argmax,
// ties to the smallest original index"), with the rounds skipping work that
// provably changes nothing. Plain version: attic/fps_pruned.py
// fps_pruned_plain, which makes the same decisions in torch.
//
// Layout (made by attic/fps_pruned.py spatial_permutation, plain torch):
// the points of a cloud are split into N/128 spatially compact sub-blocks
// of 128 (the JAX package's 2-level equal-count sort), each with a bounding
// sphere (centre, radius); planes holds the permuted coordinates as (B, 3,
// N) and pidx their original indices, ascending within each sub-block.
//
// One block per cloud. Warp w owns sub-blocks w, w + nwarps, ...; each lane
// holds 4 points of each in registers with their running minimum, and the
// block keeps per sub-block the cached max of the running minimum (bm) and
// the smallest original index attaining it (bi) in shared memory. A round:
//   1. each warp tests each of its sub-blocks against the last pick c:
//      skip when dist(c, centre) >= (r + sqrt(bm)) * 1.0001 + 1e-6 (the
//      triangle inequality puts every point at least sqrt(bm) from c, so
//      its min cannot fall; the slop covers the float32 rounding, as the
//      JAX kernel's), else update the 128 minima and refresh (bm, bi) by a
//      warp argmax;
//   2. one warp folds the cached (bm, bi) of all sub-blocks into the
//      round's pick and broadcasts its coordinates.
// Ties go to the smallest original index: within a sub-block positions
// ascend with it, and the fold compares original indices.
//
// What bounds it on an H100: as csrc/fps.cu, the serial chain of M-1
// dependent rounds with two block barriers each, not bytes or operations.
// Pruning shrinks the distance work of a round, which is not the critical
// path, and adds the sphere tests and a warp reduction per dirty
// sub-block; on the TPU it was 2x slower than the unpruned kernel.
//
// Rounding: distances use __fmul_rn / __fadd_rn in the plain versions'
// order ((dx*dx + dy*dy) + dz*dz), and the sphere test the plain version's
// operations in its order, so the indices are bit-identical to fps_plain
// and csrc/fps.cu, and the skip decisions to fps_pruned_plain's.
//
// The TPU kernel's folded (8B, N/8) layout, bit-packed dirty masks in SMEM,
// fat-window quarantine and its interpret / unroll / restrict_scan options
// are TPU mechanics and are not ported.

#include <cuda_runtime.h>

namespace {

constexpr int kSub = 128;            // points a sub-block
constexpr int kPer = kSub / 32;      // points a lane holds of a sub-block
constexpr int kMaxSub = 256;         // sub-blocks a cloud: N <= 32768
constexpr float kSlopMul = 1.0001f;
constexpr float kSlopAdd = 1e-6f;
constexpr int kNone = 0x7fffffff;

// (v, i) beats (bv, bi): larger value, or equal value and smaller index.
__device__ __forceinline__ void take_better(float& bv, int& bi, float v,
                                            int i) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

// every lane ends with the warp's best (value, index)
__device__ __forceinline__ void warp_argmax(float& bv, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_xor_sync(0xffffffffu, bv, off);
    const int i = __shfl_xor_sync(0xffffffffu, bi, off);
    take_better(bv, bi, v, i);
  }
}

template <int SPW>
__global__ void __launch_bounds__(1024, 1)
    fps_pruned_kernel(const float* __restrict__ planes,
                      const int* __restrict__ pidx,
                      const float* __restrict__ centers,
                      const float* __restrict__ radii,
                      const float* __restrict__ xyz, int n, int m,
                      int* __restrict__ out, int* __restrict__ dirty_count) {
  const int b = blockIdx.x;
  const int n_sub = n / kSub;
  const int nwarps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* px_g = planes + (size_t)b * 3 * n;
  const float* py_g = px_g + n;
  const float* pz_g = py_g + n;
  const int* pi_g = pidx + (size_t)b * n;
  const float* p = xyz + (size_t)b * n * 3;
  int* o = out + (size_t)b * m;

  extern __shared__ int s_pidx[];     // [n]: original index by position
  __shared__ float s_c[kMaxSub * 3], s_r[kMaxSub], s_bm[kMaxSub];
  __shared__ int s_bi[kMaxSub];
  __shared__ float s_last[3];

  for (int e = threadIdx.x; e < n; e += blockDim.x) s_pidx[e] = pi_g[e];
  for (int e = threadIdx.x; e < n_sub; e += blockDim.x) {
    s_c[3 * e] = centers[((size_t)b * n_sub + e) * 3];
    s_c[3 * e + 1] = centers[((size_t)b * n_sub + e) * 3 + 1];
    s_c[3 * e + 2] = centers[((size_t)b * n_sub + e) * 3 + 2];
    s_r[e] = radii[(size_t)b * n_sub + e];
    s_bm[e] = 1e10f;
    s_bi[e] = pi_g[e * kSub];        // smallest original index of the block
  }

  // point j * 32 + lane of sub-block warp + s * nwarps, in slot [s][j]
  float px[SPW][kPer], py[SPW][kPer], pz[SPW][kPer], dmin[SPW][kPer];
#pragma unroll
  for (int s = 0; s < SPW; ++s) {
    const int sb = warp + s * nwarps;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int q = sb * kSub + j * 32 + lane;
      const bool real = sb < n_sub;
      px[s][j] = real ? px_g[q] : 0.f;
      py[s][j] = real ? py_g[q] : 0.f;
      pz[s][j] = real ? pz_g[q] : 0.f;
      dmin[s][j] = 1e10f;
    }
  }
  if (threadIdx.x == 0) o[0] = 0;
  float lx = p[0], ly = p[1], lz = p[2];
  int dirty = 0;
  __syncthreads();

  for (int r = 1; r < m; ++r) {
#pragma unroll
    for (int s = 0; s < SPW; ++s) {
      const int sb = warp + s * nwarps;
      if (sb >= n_sub) break;              // warp-uniform
      // every lane reads the same shared values: a warp-uniform branch
      const float cx = __fsub_rn(s_c[3 * sb], lx);
      const float cy = __fsub_rn(s_c[3 * sb + 1], ly);
      const float cz = __fsub_rn(s_c[3 * sb + 2], lz);
      const float d2c = __fadd_rn(__fadd_rn(__fmul_rn(cx, cx),
                                            __fmul_rn(cy, cy)),
                                  __fmul_rn(cz, cz));
      const float thr = __fadd_rn(
          __fmul_rn(__fadd_rn(s_r[sb], __fsqrt_rn(s_bm[sb])), kSlopMul),
          kSlopAdd);
      if (!(d2c < __fmul_rn(thr, thr))) continue;
      ++dirty;
      float bv = -1.f;
      int bpos = kNone;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float dx = __fsub_rn(px[s][j], lx);
        const float dy = __fsub_rn(py[s][j], ly);
        const float dz = __fsub_rn(pz[s][j], lz);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                            __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        dmin[s][j] = fminf(dmin[s][j], d);
        take_better(bv, bpos, dmin[s][j], j * 32 + lane);
      }
      warp_argmax(bv, bpos);     // smallest position: smallest original
      if (lane == 0) {
        s_bm[sb] = bv;
        s_bi[sb] = s_pidx[sb * kSub + bpos];
      }
    }
    __syncthreads();
    if (warp == 0) {
      float bv = -1.f;
      int bi = kNone;
      for (int e = lane; e < n_sub; e += 32) take_better(bv, bi, s_bm[e],
                                                          s_bi[e]);
      warp_argmax(bv, bi);
      if (lane == 0) {
        o[r] = bi;
        s_last[0] = p[3 * bi];
        s_last[1] = p[3 * bi + 1];
        s_last[2] = p[3 * bi + 2];
      }
    }
    // s_bm / s_bi are rewritten only after this barrier, s_last only after
    // the next round's first barrier, which every reader passes after
    // reading it
    __syncthreads();
    lx = s_last[0];
    ly = s_last[1];
    lz = s_last[2];
  }
  if (dirty_count != nullptr && lane == 0) atomicAdd(dirty_count + b, dirty);
}

template <int SPW>
cudaError_t launch(const float* planes, const int* pidx, const float* centers,
                   const float* radii, const float* xyz, int b, int n, int m,
                   int* out, int* dirty_count, cudaStream_t stream) {
  const int n_sub = n / kSub;
  const int threads = 32 * (n_sub < 32 ? n_sub : 32);
  const int smem = n * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      fps_pruned_kernel<SPW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  fps_pruned_kernel<SPW><<<b, threads, smem, stream>>>(
      planes, pidx, centers, radii, xyz, n, m, out, dirty_count);
  return cudaGetLastError();
}

}  // namespace

extern "C" int kdpc_fps_pruned(const float* planes, const int* pidx,
                               const float* centers, const float* radii,
                               const float* xyz, int b, int n, int m,
                               int* out, int* dirty_count,
                               cudaStream_t stream) {
  if (b <= 0 || m <= 0 || m > n || n % 1024 != 0 || n / kSub > kMaxSub)
    return (int)cudaErrorInvalidValue;
  const int n_sub = n / kSub;
  const int spw = (n_sub + 31) / 32;
  if (spw <= 1)
    return (int)launch<1>(planes, pidx, centers, radii, xyz, b, n, m, out,
                          dirty_count, stream);
  if (spw <= 2)
    return (int)launch<2>(planes, pidx, centers, radii, xyz, b, n, m, out,
                          dirty_count, stream);
  if (spw <= 4)
    return (int)launch<4>(planes, pidx, centers, radii, xyz, b, n, m, out,
                          dirty_count, stream);
  return (int)launch<8>(planes, pidx, centers, radii, xyz, b, n, m, out,
                        dirty_count, stream);
}
