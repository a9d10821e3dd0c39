// Cost-volume pool with an L-layer MLP, forward, with the neighbour gather
// fused in:
//
//   h_0 = leaky(u[b, idx[b, n, k]] + v[b, n])
//   h_l = leaky(h_{l-1} W_l^T + bias_l),   l = 1..L, each W_l (C, C)
//   out[b, n, o] = max_k h_L[o]
//
// leaky(x) = x >= 0 ? x : 0.1 x. The wrapper hands the weights as wt
// (L, C_in, C_out), each W_l transposed, and the biases as (L, C).
//
// Replaces the TPU kernel attic/cross_pool.py cross_pool_fused (_kernel),
// a kept negative result of the JAX package: Mosaic could not gather rows
// of u inside a kernel, so it ran in interpret mode only. Plain version:
// attic/cross_pool.py cross_pool_plain. At L = 1 it is csrc/pool_fused.cu's
// function, and it keeps that kernel's operations in their order
// (__fadd_rn for u + v, one fmaf chain over the input channels from 0, one
// rounded add of the bias, fmaxf over the neighbours), so the two agree
// bit for bit; what this kernel adds is L > 1.
//
// What bounds it on an H100: operations, 2 L K C^2 flops a query in fp32 on
// the CUDA cores against (K + 2 C) * 4 bytes of traffic. Design, simple
// first: a block of 256 threads owns 4 queries and walks their neighbours 8
// at a time, so 32 (query, neighbour) rows a pass; it gathers the rows'
// h_0 into shared memory, then runs the layers one after the other between
// two shared buffers of 32 x C, each thread computing one output channel
// of 32 / (256 / C) rows (reading the activations as float4 broadcasts and
// the transposed weights coalesced through the L1 cache), and folds the
// last layer into a running max per (query, channel) in registers. Unlike
// pool_fused.cu, the weights are not staged in shared memory: a layer needs
// all C outputs of the one before it, and W at C = 256 alone is 256 kB.
// Forward only: the JAX function has no VJP either.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTQ = 4;                 // queries a block
constexpr int kChunk = 8;              // neighbours a pass
constexpr int kRows = kTQ * kChunk;    // (query, neighbour) rows a pass

__device__ __forceinline__ float leaky(float x) {
  return x >= 0.f ? x : 0.1f * x;
}

template <int C>
__global__ void __launch_bounds__(kThreads)
    cross_pool_kernel(const float* __restrict__ u, const int* __restrict__ idx,
                      const float* __restrict__ v,
                      const float* __restrict__ wt,
                      const float* __restrict__ bias, int n1, int n2, int k,
                      int n_layers, float* __restrict__ out) {
  constexpr int kGroups = kThreads / C;      // row groups: 8, 4, 2, 1
  constexpr int kRPT = kRows / kGroups;      // rows a thread: 4 .. 32
  extern __shared__ float4 smem4[];
  float* buf0 = reinterpret_cast<float*>(smem4);   // [kRows][C]
  float* buf1 = buf0 + kRows * C;                  // [kRows][C]

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kTQ;
  const int o = threadIdx.x % C;
  const int rg = threadIdx.x / C;            // rows rg, rg + kGroups, ...
  const float* ub = u + (size_t)b * n2 * C;
  const int* ib = idx + (size_t)b * n1 * k;
  const float* vb = v + (size_t)b * n1 * C;

  float best[kTQ];
#pragma unroll
  for (int q = 0; q < kTQ; ++q) best[q] = -__int_as_float(0x7f800000);

  for (int k0 = 0; k0 < k; k0 += kChunk) {
    __syncthreads();     // the buffers of the previous pass are not read
    for (int e = threadIdx.x; e < kRows * C; e += kThreads) {
      const int i = e % C, r = e / C;
      const int n = q0 + r / kChunk, kn = k0 + r % kChunk;
      float h = 0.f;
      if (n < n1 && kn < k) {
        const int j = ib[(size_t)n * k + kn];
        h = leaky(__fadd_rn(ub[(size_t)j * C + i], vb[(size_t)n * C + i]));
      }
      buf0[e] = h;
    }
    __syncthreads();
    const float* src = buf0;
    float* dst = buf1;
    for (int l = 0; l < n_layers; ++l) {
      const float* w = wt + (size_t)l * C * C;    // w[i * C + o] = W_l[o][i]
      const float bo = bias[l * C + o];
      float acc[kRPT];
#pragma unroll
      for (int t = 0; t < kRPT; ++t) acc[t] = 0.f;
#pragma unroll 2
      for (int i = 0; i < C; i += 4) {
        const float w0 = __ldg(w + i * C + o), w1 = __ldg(w + (i + 1) * C + o);
        const float w2 = __ldg(w + (i + 2) * C + o);
        const float w3 = __ldg(w + (i + 3) * C + o);
#pragma unroll
        for (int t = 0; t < kRPT; ++t) {
          const float4 h = *reinterpret_cast<const float4*>(
              src + (rg + t * kGroups) * C + i);
          acc[t] = fmaf(h.x, w0, acc[t]);
          acc[t] = fmaf(h.y, w1, acc[t]);
          acc[t] = fmaf(h.z, w2, acc[t]);
          acc[t] = fmaf(h.w, w3, acc[t]);
        }
      }
      if (l + 1 < n_layers) {
#pragma unroll
        for (int t = 0; t < kRPT; ++t)
          dst[(rg + t * kGroups) * C + o] = leaky(acc[t] + bo);
        // every thread has read src for this layer before writing dst, so
        // after the barrier the old src may take the next layer's output
        __syncthreads();
        float* tmp = const_cast<float*>(src);
        src = dst;
        dst = tmp;
      } else {
#pragma unroll
        for (int t = 0; t < kRPT; ++t) {
          // row rg + t * kGroups: query (t * kGroups) / kChunk (kGroups
          // divides kChunk), neighbour rg + (t * kGroups) % kChunk
          const int q = (t * kGroups) / kChunk;
          const int kn = k0 + rg + (t * kGroups) % kChunk;
          if (kn < k) best[q] = fmaxf(best[q], leaky(acc[t] + bo));
        }
      }
    }
  }
  // fold the row groups' maxima: buf1 is free once every thread is here
  __syncthreads();
  float* red = buf1;                         // [kGroups][kTQ][C]
#pragma unroll
  for (int q = 0; q < kTQ; ++q) red[(rg * kTQ + q) * C + o] = best[q];
  __syncthreads();
  for (int e = threadIdx.x; e < kTQ * C; e += kThreads) {
    const int q = e / C, oo = e % C, n = q0 + q;
    float m = red[q * C + oo];
    for (int g = 1; g < kGroups; ++g) m = fmaxf(m, red[(g * kTQ + q) * C + oo]);
    if (n < n1) out[((size_t)b * n1 + n) * C + oo] = m;
  }
}

template <int C>
cudaError_t launch(const float* u, const int* idx, const float* v,
                   const float* wt, const float* bias, int b, int n1, int n2,
                   int k, int n_layers, float* out, cudaStream_t stream) {
  const int smem = 2 * kRows * C * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      cross_pool_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n1 + kTQ - 1) / kTQ, b);
  cross_pool_kernel<C><<<grid, kThreads, smem, stream>>>(
      u, idx, v, wt, bias, n1, n2, k, n_layers, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int kdpc_cross_pool(const float* u, const int* idx, const float* v,
                               const float* wt, const float* bias, int b,
                               int n1, int n2, int k, int c, int n_layers,
                               float* out, cudaStream_t stream) {
  if (b <= 0 || n1 <= 0 || n2 <= 0 || k <= 0 || n_layers <= 0)
    return (int)cudaErrorInvalidValue;
  switch (c) {
    case 32:
      return (int)launch<32>(u, idx, v, wt, bias, b, n1, n2, k, n_layers, out,
                             stream);
    case 64:
      return (int)launch<64>(u, idx, v, wt, bias, b, n1, n2, k, n_layers, out,
                             stream);
    case 128:
      return (int)launch<128>(u, idx, v, wt, bias, b, n1, n2, k, n_layers,
                              out, stream);
    case 256:
      return (int)launch<256>(u, idx, v, wt, bias, b, n1, n2, k, n_layers,
                              out, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
