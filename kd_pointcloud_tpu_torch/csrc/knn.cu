// Exact k-nearest-neighbour search over 3-D points, fp32.
//
// Replaces the TPU kernel kd_pointcloud_tpu/ops/pallas/knn_fused.py
// knn_fused (_kernel, _extract_topk and the query/key embeddings). That
// kernel selects approximately, through stride-group minima of packed
// distance bits sized for the TPU's matrix unit; none of it carries over.
// This one is exact and matches the plain version, ops/knn.py knn_plain:
// the selection distance is the expansion |q|^2 - 2 q.k + |k|^2 of
// ops/distance.py square_distance, each product and sum rounded on its own
// (__fmul_rn / __fadd_rn) in the plain version's order, so both rank keys by
// the same float; ties keep the lower key index first, as lax.top_k does.
// Outputs are sorted ascending: idx (B, S, K) int32 and that distance
// (B, S, K) float32.
//
// What bounds it on an H100: operations. Every query scores every key
// (~10 instructions each, S*N per cloud), against 16 bytes a point of
// traffic. The design: one thread per query, the key cloud streamed through
// shared memory in tiles of 1024 (x, y, z, |k|^2) float4s that every thread
// of the block reads as a broadcast, and the k best kept as a sorted list in
// registers (K is a template parameter, so the insertion pass unrolls into
// register moves). Blocks of 64 queries spread the 8192-query searches over
// all SMs.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kTile = 1024;

template <int K>
__global__ void __launch_bounds__(kThreads)
    knn_kernel(const float* __restrict__ query, const float* __restrict__ keys,
               int s, int n, int* __restrict__ out_idx,
               float* __restrict__ out_d2) {
  __shared__ float4 tile[kTile];
  const int b = blockIdx.y;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const bool active = q < s;
  const float* kb = keys + (size_t)b * n * 3;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* qp = query + ((size_t)b * s + q) * 3;
    qx = qp[0];
    qy = qp[1];
    qz = qp[2];
  }
  const float s2 =
      __fadd_rn(__fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy)),
                __fmul_rn(qz, qz));

  float bd[K];
  int bi[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    bd[j] = __int_as_float(0x7f800000);  // +inf
    bi[j] = 0;
  }

  for (int base = 0; base < n; base += kTile) {
    const int cnt = min(kTile, n - base);
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < cnt; j += kThreads) {
      const float* kp = kb + (size_t)(base + j) * 3;
      const float x = kp[0], y = kp[1], z = kp[2];
      tile[j] = make_float4(
          x, y, z,
          __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                    __fmul_rn(z, z)));
    }
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < cnt; ++j) {
      const float4 kp = tile[j];
      const float cross =
          __fadd_rn(__fadd_rn(__fmul_rn(qx, kp.x), __fmul_rn(qy, kp.y)),
                    __fmul_rn(qz, kp.z));
      const float d = __fadd_rn(__fsub_rn(s2, __fmul_rn(2.f, cross)), kp.w);
      if (d < bd[K - 1]) {
        // drop the worst, then bubble the newcomer up past every strictly
        // larger entry: equal distances keep the earlier (lower) index first
        bd[K - 1] = d;
        bi[K - 1] = base + j;
#pragma unroll
        for (int t = K - 1; t > 0; --t) {
          if (bd[t] < bd[t - 1]) {
            const float td = bd[t];
            bd[t] = bd[t - 1];
            bd[t - 1] = td;
            const int ti = bi[t];
            bi[t] = bi[t - 1];
            bi[t - 1] = ti;
          }
        }
      }
    }
  }

  if (active) {
    const size_t row = ((size_t)b * s + q) * K;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      out_idx[row + j] = bi[j];
      out_d2[row + j] = bd[j];
    }
  }
}

template <int K>
cudaError_t launch(const float* query, const float* keys, int b, int s, int n,
                   int* out_idx, float* out_d2, cudaStream_t stream) {
  const dim3 grid((s + kThreads - 1) / kThreads, b);
  knn_kernel<K><<<grid, kThreads, 0, stream>>>(query, keys, s, n, out_idx,
                                               out_d2);
  return cudaGetLastError();
}

}  // namespace

extern "C" int kdpc_knn(const float* query, const float* keys, int b, int s,
                        int n, int k, int* out_idx, float* out_d2,
                        cudaStream_t stream) {
  if (b <= 0 || s <= 0 || k > n) return (int)cudaErrorInvalidValue;
  switch (k) {
    case 3:
      return (int)launch<3>(query, keys, b, s, n, out_idx, out_d2, stream);
    case 9:
      return (int)launch<9>(query, keys, b, s, n, out_idx, out_d2, stream);
    case 16:
      return (int)launch<16>(query, keys, b, s, n, out_idx, out_d2, stream);
    case 32:
      return (int)launch<32>(query, keys, b, s, n, out_idx, out_d2, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
