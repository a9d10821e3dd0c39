// Cost-volume pool, forward, with the neighbour gather fused in:
//
//   out[b, n, o] = max_k leaky(sum_i leaky(u[b, idx[b, n, k], i] + v[b, n, i])
//                                      * w[o, i] + bias[o])
//
// leaky(x) = x >= 0 ? x : 0.1 x; w is (C, C) in the port's (out, in) layout.
//
// Replaces the TPU kernel kd_pointcloud_tpu/ops/pallas/pool_fused.py
// _pool_pallas (_kernel), reached through pool_mlp_max. The TPU kernel read
// a k-major gathered (B, K, N, C) tensor that XLA wrote to device memory
// first, because the TPU could not gather rows inside a kernel
// (attic/README.md); its lane packing and block-diagonal weights were TPU
// layout devices. Here the kernel gathers the rows of u itself, so the
// grouped tensor never reaches device memory. Plain version: ops/pool_fused.py
// pool_plain.
//
// What bounds it on an H100: operations -- 2*K*C*C flops a query against
// (K + 2C) * 4 bytes of traffic, e.g. 65 kflop against 0.4 kB at C = 32,
// K = 32, in fp32 on the CUDA cores. The design keeps the weights and the
// activations in shared memory and the running max in registers: a block
// owns a panel of CO = min(C, 64) output channels, stages that panel of w
// once (transposed, C x CO, about 64 kB at C = 256 -- the full 256 kB of
// w would not fit the 227 kB a block may use), then walks its queries
// TQ = 256 / CO at a time. For each chunk of 8 neighbours the block gathers
// the u rows, adds v and applies leaky into shared memory; each thread then
// holds one (query, output channel) pair and accumulates the 8 neighbours'
// dot products in registers, reading the activations as float4 broadcasts
// and the weights without bank conflicts, and folds them into its running
// max. No wgmma or TMA yet.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8;        // neighbours staged per pass
constexpr int kTargetBlocks = 264;  // two waves of blocks on 132 SMs

__device__ __forceinline__ float leaky(float x) {
  return x >= 0.f ? x : 0.1f * x;
}

template <int C>
struct Shape {
  static constexpr int kCO = C < 64 ? C : 64;   // output channels a block
  static constexpr int kTQ = kThreads / kCO;    // queries a pass
  static constexpr int kWS = kCO + 1;           // padded row: no bank conflicts
  static constexpr int kSmemFloats = C * kWS + kTQ * kChunk * C;
};

template <int C>
__global__ void __launch_bounds__(kThreads)
    pool_kernel(const float* __restrict__ u, const int* __restrict__ idx,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ bias, int n1, int n2, int k,
                int qpb, float* __restrict__ out) {
  constexpr int CO = Shape<C>::kCO;
  constexpr int TQ = Shape<C>::kTQ;
  constexpr int WS = Shape<C>::kWS;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [C][WS], w transposed
  float* hs = ws + C * WS;                       // [TQ][kChunk][C]

  const int b = blockIdx.z;
  const int o0 = blockIdx.y * CO;
  const int o = threadIdx.x % CO;
  const int ql = threadIdx.x / CO;

  for (int e = threadIdx.x; e < C * CO; e += kThreads) {
    const int i = e % C, oo = e / C;  // coalesced reads of w's rows
    ws[i * WS + oo] = w[(size_t)(o0 + oo) * C + i];
  }
  const float bo = bias[o0 + o];
  const float* ub = u + (size_t)b * n2 * C;
  const int* ib = idx + (size_t)b * n1 * k;
  const float* vb = v + (size_t)b * n1 * C;

  const int q_end = min(n1, (blockIdx.x + 1) * qpb);
  for (int q0 = blockIdx.x * qpb; q0 < q_end; q0 += TQ) {
    float best = -__int_as_float(0x7f800000);
    for (int k0 = 0; k0 < k; k0 += kChunk) {
      __syncthreads();  // hs of the previous pass is no longer read
      for (int e = threadIdx.x; e < TQ * kChunk * C; e += kThreads) {
        const int i = e % C, r = e / C;
        const int kk = r % kChunk, qq = r / kChunk;
        const int n = q0 + qq, kn = k0 + kk;
        float h = 0.f;
        if (n < q_end && kn < k) {
          const int j = ib[(size_t)n * k + kn];
          h = leaky(__fadd_rn(ub[(size_t)j * C + i], vb[(size_t)n * C + i]));
        }
        hs[e] = h;
      }
      __syncthreads();
      float acc[kChunk];
#pragma unroll
      for (int kk = 0; kk < kChunk; ++kk) acc[kk] = 0.f;
      const float* hq = hs + ql * kChunk * C;
#pragma unroll 4
      for (int i = 0; i < C; i += 4) {
        const float w0 = ws[i * WS + o], w1 = ws[(i + 1) * WS + o];
        const float w2 = ws[(i + 2) * WS + o], w3 = ws[(i + 3) * WS + o];
#pragma unroll
        for (int kk = 0; kk < kChunk; ++kk) {
          const float4 h = *reinterpret_cast<const float4*>(hq + kk * C + i);
          acc[kk] = fmaf(h.x, w0, acc[kk]);
          acc[kk] = fmaf(h.y, w1, acc[kk]);
          acc[kk] = fmaf(h.z, w2, acc[kk]);
          acc[kk] = fmaf(h.w, w3, acc[kk]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < kChunk; ++kk) {
        if (k0 + kk < k) best = fmaxf(best, leaky(acc[kk] + bo));
      }
    }
    const int n = q0 + ql;
    if (n < q_end) out[((size_t)b * n1 + n) * C + o0 + o] = best;
  }
}

template <int C>
cudaError_t launch(const float* u, const int* idx, const float* v,
                   const float* w, const float* bias, int b, int n1, int n2,
                   int k, float* out, cudaStream_t stream) {
  using S = Shape<C>;
  const size_t smem = sizeof(float) * S::kSmemFloats;
  cudaError_t err = cudaFuncSetAttribute(
      pool_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int panels = C / S::kCO;
  const int passes = (n1 + S::kTQ - 1) / S::kTQ;
  // queries a block: enough blocks to fill the card, at most 32 queries so
  // the weight panel is staged once for many of them
  int per = passes * panels * b / kTargetBlocks;
  per = per < 1 ? 1 : (per * S::kTQ > 32 ? 32 / S::kTQ : per);
  const int qpb = per * S::kTQ;
  const dim3 grid((n1 + qpb - 1) / qpb, panels, b);
  pool_kernel<C><<<grid, kThreads, smem, stream>>>(u, idx, v, w, bias, n1, n2,
                                                   k, qpb, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int kdpc_pool(const float* u, const int* idx, const float* v,
                         const float* w, const float* bias, int b, int n1,
                         int n2, int k, int c, float* out,
                         cudaStream_t stream) {
  if (b <= 0 || n1 <= 0 || n2 <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  switch (c) {
    case 32:
      return (int)launch<32>(u, idx, v, w, bias, b, n1, n2, k, out, stream);
    case 64:
      return (int)launch<64>(u, idx, v, w, bias, b, n1, n2, k, out, stream);
    case 128:
      return (int)launch<128>(u, idx, v, w, bias, b, n1, n2, k, out, stream);
    case 256:
      return (int)launch<256>(u, idx, v, w, bias, b, n1, n2, k, out, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
