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
// grouped tensor never reaches device memory. Plain version:
// ops/pool_fused.py pool_plain; pool_tiled there is this file's walk in
// torch, for the tests.
//
// What bounds it on an H100: operations -- 2 K C^2 flops a query against
// (K + 2C) * 4 bytes of traffic, in fp32 on the CUDA cores (e.g. 65 kflop
// against 0.4 kB at C = 32, K = 32). Read as a matrix product, the rows are
// the (query, neighbour slot) pairs, h0 = leaky(u[idx] + v) is the left
// operand, formed on the fly, and w^T the right one; the max over a query's
// rows is the epilogue. The design:
//
// - Each gathered row is formed once. A pass is QP = 512 / C queries x 32
//   slots (64-512 rows, 64 kB of h0 at every width), and the block covers
//   all C output channels of those rows, so no block gathers a row that
//   another block also gathers. A slot past K is zero and left out of the
//   max; K > 32 takes several passes over the same queries.
// - A register tile of 8 slots x 8 output channels a thread: for every 4
//   input channels a thread reads 8 float4 of h0 (its slots s, s + 4, ...)
//   and 8 float4 of w (its channels o, o + CG, ...), 16 shared-memory loads
//   for 256 FMAs. Rows of h0 and w are padded (C + 4 and IT + 4 floats) so
//   that the lanes' float4 reads fall in distinct bank groups; lanes that
//   share slots or channels read the same address, a broadcast.
// - w stays in shared memory for the block's life at C <= 64. At C = 128 and
//   256 (64 and 256 kB) it is streamed in tiles of IT = 32 and 16 input
//   channels through two buffers by cp.async, the next tile in flight while
//   the threads multiply the current one -- a GEMM's k-loop, with every
//   output of the tile in registers from i = 0 to C - 1.
// - The gather reads a pass's neighbour indices first, then its u and v rows
//   as independent float4 loads, 8 in flight a thread, and applies
//   leaky(u + v) once as it stages the row. At C <= 64 two blocks share an
//   SM (128 registers, 80-88 kB of shared memory), so one block's gather
//   runs beside the other's product; at C >= 128, where the product is
//   most of a pass, one block an SM with up to 255 registers, the i-loop
//   of a tile unrolled (as at C = 64).
// - The grid is one wave: cudaOccupancyMaxActiveBlocksPerMultiprocessor x
//   the SMs, each block walking passes in a strided loop.
//
// Numerics, bit for bit those of the earlier panel kernel and of the
// backward's recompute (csrc/pool_fused_bwd.cu, "Ties"): fp32 on the CUDA
// cores, h0 by __fadd_rn then leaky, each p one fmaf chain from 0 over
// i = 0 .. C-1 in ascending order (a tile's chain continues the previous
// tile's), then one rounded add of the bias, leaky, and fmaxf over the
// slots (exact, so the order of the max does not matter). No TF32, mma or
// wgmma: any of them changes those bits.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 32;  // neighbour slots a pass
constexpr int kTS = 8;      // slots a thread: s, s + 4, ..., s + 28
constexpr int kTC = 8;      // output channels a thread: o, o + CG, ...
constexpr int kBatch = 8;   // gather loads in flight a thread
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float leaky(float x) {
  return x >= 0.f ? x : 0.1f * x;
}

template <int C>
struct Shape {
  static constexpr int kCG = C / kTC < 8 ? C / kTC : 8;  // channel lanes
  static constexpr int kWarpC = kCG * kTC;       // channels a warp: 32 or 64
  static constexpr int kQW = 32 / (4 * kCG);     // queries a warp: 2 or 1
  static constexpr int kWarpsQ = C / kWarpC;     // warps a query: 1, 1, 2, 4
  static constexpr int kQP = kThreads / 32 * kQW / kWarpsQ;  // queries a pass
  static constexpr int kRows = kQP * kSlots;
  static constexpr int kHS = C + 4;              // padded h0 row
  static constexpr bool kWTiled = C > 64;        // w streamed in i-tiles
  static constexpr int kIT = C == 256 ? 16 : (kWTiled ? 32 : C);
  static constexpr int kWS = kIT + 4;            // padded w row
  static constexpr int kWBufs = kWTiled ? 2 : 1;
  // blocks an SM: two at C <= 64, whose short products need the other
  // block's beside their gathers; one at C >= 128, where the product is
  // most of a pass and up to 255 registers let a tile's i-loop unroll
  static constexpr int kBlocksSM = kWTiled ? 1 : 2;
  // the i-loop unrolled where the registers allow it (not at C = 32, which
  // spills at two blocks' 128 registers)
  static constexpr bool kUnroll = C >= 64;
  static constexpr int kSmemFloats = kRows * kHS + kWBufs * C * kWS + kRows;
  static_assert(kRows * (C / 4) % (kThreads * kBatch) == 0, "gather split");
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// input channels i0 .. i0 + IT - 1 of every row of w into dst ([C][WS])
template <int C>
__device__ __forceinline__ void load_w_tile(float* dst,
                                            const float* __restrict__ w,
                                            int i0) {
  using S = Shape<C>;
  constexpr int IT4 = S::kIT / 4;
  for (int e = threadIdx.x; e < C * IT4; e += kThreads) {
    const int o = e / IT4, q = e % IT4;
    cp_async16(dst + o * S::kWS + 4 * q, w + (size_t)o * C + i0 + 4 * q);
  }
  cp_async_commit();
}

// acc[t][j] += h0 x w over input channels i .. i + 3, each accumulator's
// fmaf chain in ascending i
template <int C>
__device__ __forceinline__ void step(float (&acc)[kTS][kTC],
                                     const float* hrow, const float* wrow,
                                     int i) {
  using S = Shape<C>;
  float4 h[kTS];
#pragma unroll
  for (int t = 0; t < kTS; ++t)
    h[t] = *reinterpret_cast<const float4*>(hrow + 4 * t * S::kHS + i);
#pragma unroll
  for (int j = 0; j < kTC; ++j) {
    const float4 wv =
        *reinterpret_cast<const float4*>(wrow + S::kCG * j * S::kWS + i);
#pragma unroll
    for (int t = 0; t < kTS; ++t) {
      acc[t][j] = fmaf(h[t].x, wv.x, acc[t][j]);
      acc[t][j] = fmaf(h[t].y, wv.y, acc[t][j]);
      acc[t][j] = fmaf(h[t].z, wv.z, acc[t][j]);
      acc[t][j] = fmaf(h[t].w, wv.w, acc[t][j]);
    }
  }
}

// the tile's LEN input channels in ascending order
template <int C, int LEN>
__device__ __forceinline__ void product(float (&acc)[kTS][kTC],
                                        const float* hrow, const float* wrow) {
  if constexpr (Shape<C>::kUnroll) {
#pragma unroll
    for (int i = 0; i < LEN; i += 4) step<C>(acc, hrow, wrow, i);
  } else {
#pragma unroll 1
    for (int i = 0; i < LEN; i += 4) step<C>(acc, hrow, wrow, i);
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, Shape<C>::kBlocksSM)
    pool_kernel(const float* __restrict__ u, const int* __restrict__ idx,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ bias, int n1, int n2, int k,
                int groups, int passes, float* __restrict__ out) {
  using S = Shape<C>;
  constexpr int CG = S::kCG, QP = S::kQP, ROWS = S::kRows, HS = S::kHS;
  constexpr int C4 = C / 4;
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);        // [ROWS][HS]: h0
  float* ws = hs + ROWS * HS;                          // [bufs][C][WS]: w
  int* ids = reinterpret_cast<int*>(ws + S::kWBufs * C * S::kWS);  // [ROWS]

  // the product's thread: query ql of the pass, slots sg + 4 t, output
  // channels ob + cg + CG j
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cg = lane % CG, sg = lane / CG % 4, qw = lane / (4 * CG);
  const int ql = warp / S::kWarpsQ * S::kQW + qw;
  const int ob = warp % S::kWarpsQ * S::kWarpC;
  const float* hrow = hs + (ql * kSlots + sg) * HS;

  if constexpr (!S::kWTiled) {
    for (int e = threadIdx.x; e < C * C4; e += kThreads) {
      const int o = e / C4, i4 = e % C4;
      *reinterpret_cast<float4*>(ws + o * S::kWS + 4 * i4) =
          __ldg(reinterpret_cast<const float4*>(w + (size_t)o * C + 4 * i4));
    }
  }

  for (int p = blockIdx.x; p < passes; p += gridDim.x) {
    const int b = p / groups, q0 = p % groups * QP;
    const int nq = min(QP, n1 - q0);
    const float* ub = u + (size_t)b * n2 * C;
    const int* ib = idx + ((size_t)b * n1 + q0) * k;
    const float* vb = v + ((size_t)b * n1 + q0) * C;
    float best[kTC];
#pragma unroll
    for (int j = 0; j < kTC; ++j) best[j] = -__int_as_float(0x7f800000);

    for (int k0 = 0; k0 < k; k0 += kSlots) {
      // 1. the rows' neighbour indices (-1: no row), then h0 for the pass
      __syncthreads();  // hs, ids and the w buffers are no longer read
      if constexpr (S::kWTiled) load_w_tile<C>(ws, w, 0);
      for (int r = threadIdx.x; r < ROWS; r += kThreads) {
        const int q = r / kSlots, s = k0 + r % kSlots;
        ids[r] = q < nq && s < k ? ib[(size_t)q * k + s] : -1;
      }
      __syncthreads();
#pragma unroll 1
      for (int e0 = 0; e0 < ROWS * C4; e0 += kThreads * kBatch) {
        float4 a[kBatch], c[kBatch];
#pragma unroll
        for (int x = 0; x < kBatch; ++x) {
          const int e = e0 + x * kThreads + threadIdx.x;
          const int r = e / C4, i4 = e % C4, j = ids[r];
          a[x] = c[x] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (j >= 0) {
            a[x] = __ldg(reinterpret_cast<const float4*>(ub + (size_t)j * C) +
                         i4);
            c[x] = __ldg(reinterpret_cast<const float4*>(
                             vb + (size_t)(r / kSlots) * C) + i4);
          }
        }
#pragma unroll
        for (int x = 0; x < kBatch; ++x) {
          const int e = e0 + x * kThreads + threadIdx.x;
          *reinterpret_cast<float4*>(hs + e / C4 * HS + 4 * (e % C4)) =
              make_float4(leaky(__fadd_rn(a[x].x, c[x].x)),
                          leaky(__fadd_rn(a[x].y, c[x].y)),
                          leaky(__fadd_rn(a[x].z, c[x].z)),
                          leaky(__fadd_rn(a[x].w, c[x].w)));
        }
      }

      // 2. p = h0 . w for the thread's 8 x 8 tile
      float acc[kTS][kTC];
#pragma unroll
      for (int t = 0; t < kTS; ++t)
#pragma unroll
        for (int j = 0; j < kTC; ++j) acc[t][j] = 0.f;
      if constexpr (!S::kWTiled) {
        __syncthreads();
        product<C, C>(acc, hrow, ws + (ob + cg) * S::kWS);
      } else {
        constexpr int NT = C / S::kIT;
#pragma unroll 1
        for (int it = 0; it < NT; ++it) {
          // tile it has landed and every thread is done with tile it - 1,
          // whose buffer the next tile overwrites
          cp_async_wait_all();
          __syncthreads();
          if (it + 1 < NT)
            load_w_tile<C>(ws + (it + 1) % 2 * C * S::kWS, w,
                           (it + 1) * S::kIT);
          product<C, S::kIT>(acc, hrow + it * S::kIT,
                             ws + it % 2 * C * S::kWS + (ob + cg) * S::kWS);
        }
      }

      // 3. + bias, leaky, max over the thread's slots
#pragma unroll
      for (int j = 0; j < kTC; ++j) {
        const float bo = __ldg(bias + ob + cg + CG * j);
#pragma unroll
        for (int t = 0; t < kTS; ++t)
          if (k0 + sg + 4 * t < k)
            best[j] = fmaxf(best[j], leaky(__fadd_rn(acc[t][j], bo)));
      }
    }

    // 4. max over the 4 lanes that hold a query's slots; lane sg writes
    //    channels 2 sg and 2 sg + 1 of its 8
#pragma unroll
    for (int j = 0; j < kTC; ++j) {
      best[j] = fmaxf(best[j], __shfl_xor_sync(kFull, best[j], CG));
      best[j] = fmaxf(best[j], __shfl_xor_sync(kFull, best[j], 2 * CG));
    }
    if (ql < nq) {
      float* orow = out + ((size_t)b * n1 + q0 + ql) * C + ob + cg;
#pragma unroll
      for (int j = 0; j < kTC; ++j)
        if (j / 2 == sg) orow[CG * j] = best[j];
    }
  }
}

template <int C>
cudaError_t launch(const float* u, const int* idx, const float* v,
                   const float* w, const float* bias, int b, int n1, int n2,
                   int k, float* out, cudaStream_t stream) {
  using S = Shape<C>;
  const size_t smem = sizeof(float) * S::kSmemFloats;
  // blocks a wave, found once: the attribute and the occupancy query cost
  // host time on every call otherwise
  static int slots = 0;
  if (slots == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        pool_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    int per_sm = 0, dev = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pool_kernel<C>,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    slots = (per_sm < 1 ? 1 : per_sm) * (sms < 1 ? 1 : sms);
  }
  const int groups = (n1 + S::kQP - 1) / S::kQP;
  const int passes = groups * b;
  const int grid = passes < slots ? passes : slots;
  pool_kernel<C><<<grid, kThreads, smem, stream>>>(u, idx, v, w, bias, n1, n2,
                                                   k, groups, passes, out);
  return cudaGetLastError();
}

}  // namespace

// u, v and w are read as float4: their data must be 16-byte aligned.
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
