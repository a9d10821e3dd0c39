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
// attic/cross_pool.py cross_pool_plain; cross_pool_tiled there is this
// file's walk in torch, for the tests. At L = 1 it is csrc/pool_fused.cu's
// function and keeps that kernel's operations in their order, so the two
// agree bit for bit; what this kernel adds is L > 1.
//
// What bounds it on an H100: operations, 2 L K C^2 flops a query in fp32 on
// the CUDA cores against (K + 2 C) * 4 bytes of traffic. The design is
// csrc/pool_fused.cu's (see its header), carried over L layers:
//
// - A pass is QP = 512 / C queries x 32 neighbour slots (64-1024 rows), and
//   the block covers all C output channels of those rows, so each gathered
//   row is formed once. The gather loads a pass's neighbour indices first,
//   then its u and v rows as float4 with 8 loads in flight a thread, and
//   stages h_0 = leaky(u + v) once a row in shared memory.
// - A thread holds 8 slots x 8 output channels in registers; for every 4
//   input channels it reads 8 float4 of h and 8 float4 of W (two runs of 4
//   channels in each of 4 rows of W^T), 16 shared-memory loads for 256
//   FMAs. W^T rows are read as the wrapper lays them out, C_out floats a
//   row, so a tile copies with cp.async unchanged.
// - Each layer but the last writes leaky(acc + bias) from the registers
//   back into the rows of h, in place, between two barriers (every thread
//   has read the layer's input before any thread overwrites it). The last
//   layer's epilogue folds the max over the slots in registers.
// - W_1..W_L stay in shared memory for the block's life where they fit
//   beside the rows (C <= 64: up to 9 layers at C = 64), as pool_fused.cu
//   keeps its one W. Otherwise (C = 128, 256, or more layers) they are
//   streamed in tiles of IT input channels through two buffers by
//   cp.async, the next tile (of this layer or of the next) in flight while
//   the threads multiply the current one.
// - Launch bounds of one block an SM at every width, so up to 255
//   registers a thread: the layer loop's state beside the 8 x 8 tile and
//   the running maxima spilled at pool_fused.cu's two blocks' 128
//   registers (at C <= 64). The grid is one wave: the blocks an SM that
//   the occupancy calculator gives, times the SMs, each block walking
//   passes in a strided loop.
//
// Numerics, bit for bit those of the earlier (PR 6) kernel of this file and,
// at L = 1, of csrc/pool_fused.cu: fp32 on the CUDA cores, h_0 by __fadd_rn
// then leaky, each output one fmaf chain from 0 over i = 0 .. C-1 in
// ascending order (continued across i-tiles), then one rounded add of the
// bias and leaky, and fmaxf over the slots (exact, so its order does not
// matter). No TF32, mma or wgmma: any of them changes those bits.
// Forward only: the JAX function has no VJP either.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 32;   // neighbour slots a pass
constexpr int kTS = 8;       // slots a thread: s, s + 4, ..., s + 28
constexpr int kTC = 8;       // output channels a thread: two runs of 4
constexpr int kBatch = 8;    // gather loads in flight a thread
constexpr int kMaxSmem = 227 * 1024;   // dynamic shared memory a block
constexpr int kCachedL = 16;           // layers whose wave size is cached
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float leaky(float x) {
  return x >= 0.f ? x : 0.1f * x;
}

template <int C, bool kStream>
struct Shape {
  static constexpr int kCG = C / kTC < 8 ? C / kTC : 8;  // channel lanes
  static constexpr int kWarpC = kCG * kTC;   // channels a warp: 16, 32, 64
  static constexpr int kQW = 32 / (4 * kCG);     // queries a warp: 4, 2, 1
  static constexpr int kWarpsQ = C / kWarpC;  // warps a query: 1, 1, 1, 2, 4
  static constexpr int kQP = kThreads / 32 * kQW / kWarpsQ;  // queries a pass
  static constexpr int kRows = kQP * kSlots;
  static constexpr int kHS = C + 4;              // padded h row
  // input channels a streamed tile: a whole layer at C <= 64
  static constexpr int kIT = C == 256 ? 16 : (C > 64 ? 32 : C);
  // floats of the rows and the pass's indices; W comes after them
  static constexpr int kBaseFloats = kRows * kHS + kRows;
  // the i-loop unrolled from C = 64 on, as pool_fused.cu's
  static constexpr bool kUnroll = C >= 64;
  static_assert(kRows * (C / 4) % (kThreads * kBatch) == 0, "gather split");
  static_assert(!kStream || C % kIT == 0, "i-tiles");
};

template <int C, bool kStream>
int smem_bytes(int n_layers) {
  using S = Shape<C, kStream>;
  const int w = kStream ? 2 * S::kIT * C : n_layers * C * C;
  return (int)sizeof(float) * (S::kBaseFloats + w);
}

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

// streamed tile g of the pass (layer g / NT, input channels from
// (g % NT) * IT): IT rows of W_l^T, C floats each, into dst ([IT][C])
template <int C>
__device__ __forceinline__ void load_w_tile(float* dst,
                                            const float* __restrict__ wt,
                                            int g) {
  constexpr int IT = Shape<C, true>::kIT, NT = C / IT, C4 = C / 4;
  const float* src = wt + (size_t)(g / NT) * C * C + (size_t)(g % NT) * IT * C;
  for (int e = threadIdx.x; e < IT * C4; e += kThreads)
    cp_async16(dst + 4 * e, src + 4 * e);
  cp_async_commit();
}

// acc[t][j] += h x W over input channels i .. i + 3, each accumulator's
// fmaf chain in ascending i. hrow: the thread's first slot row at column
// 0 of the tile; wrow: row 0 of the tile's W^T at the thread's first
// output channel (its second run of 4 is 4 CG further)
template <int C, bool kStream>
__device__ __forceinline__ void step(float (&acc)[kTS][kTC],
                                     const float* hrow, const float* wrow,
                                     int i) {
  using S = Shape<C, kStream>;
  float4 h[kTS];
#pragma unroll
  for (int t = 0; t < kTS; ++t)
    h[t] = *reinterpret_cast<const float4*>(hrow + 4 * t * S::kHS + i);
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const float* w = wrow + (i + ii) * C;
    const float4 wa = *reinterpret_cast<const float4*>(w);
    const float4 wb = *reinterpret_cast<const float4*>(w + 4 * S::kCG);
#pragma unroll
    for (int t = 0; t < kTS; ++t) {
      const float x = ii == 0 ? h[t].x : ii == 1 ? h[t].y
                    : ii == 2 ? h[t].z : h[t].w;
      acc[t][0] = fmaf(x, wa.x, acc[t][0]);
      acc[t][1] = fmaf(x, wa.y, acc[t][1]);
      acc[t][2] = fmaf(x, wa.z, acc[t][2]);
      acc[t][3] = fmaf(x, wa.w, acc[t][3]);
      acc[t][4] = fmaf(x, wb.x, acc[t][4]);
      acc[t][5] = fmaf(x, wb.y, acc[t][5]);
      acc[t][6] = fmaf(x, wb.z, acc[t][6]);
      acc[t][7] = fmaf(x, wb.w, acc[t][7]);
    }
  }
}

// the tile's LEN input channels in ascending order
template <int C, bool kStream, int LEN>
__device__ __forceinline__ void product(float (&acc)[kTS][kTC],
                                        const float* hrow, const float* wrow) {
  if constexpr (Shape<C, kStream>::kUnroll) {
#pragma unroll
    for (int i = 0; i < LEN; i += 4) step<C, kStream>(acc, hrow, wrow, i);
  } else {
#pragma unroll 1
    for (int i = 0; i < LEN; i += 4) step<C, kStream>(acc, hrow, wrow, i);
  }
}

template <int C, bool kStream>
__global__ void __launch_bounds__(kThreads, 1)
    cross_pool_kernel(const float* __restrict__ u, const int* __restrict__ idx,
                      const float* __restrict__ v,
                      const float* __restrict__ wt,
                      const float* __restrict__ bias, int n1, int n2, int k,
                      int n_layers, int groups, int passes,
                      float* __restrict__ out) {
  using S = Shape<C, kStream>;
  constexpr int CG = S::kCG, QP = S::kQP, ROWS = S::kRows, HS = S::kHS;
  constexpr int C4 = C / 4, IT = S::kIT, NT = C / IT;
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);        // [ROWS][HS]: h
  int* ids = reinterpret_cast<int*>(hs + ROWS * HS);   // [ROWS]
  float* ws = hs + S::kBaseFloats;  // [L][C][C], or [2][IT][C] streamed

  // the product's thread: query ql of the pass, slots sg + 4 t, output
  // channels ob + 4 cg + (0..3) and ob + 4 CG + 4 cg + (0..3)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cg = lane % CG, sg = lane / CG % 4, qw = lane / (4 * CG);
  const int ql = warp / S::kWarpsQ * S::kQW + qw;
  const int oc = warp % S::kWarpsQ * S::kWarpC + 4 * cg;  // first channel
  float* hrow = hs + (ql * kSlots + sg) * HS;

  if constexpr (!kStream) {
    for (int e = threadIdx.x; e < n_layers * C * C4; e += kThreads)
      reinterpret_cast<float4*>(ws)[e] =
          __ldg(reinterpret_cast<const float4*>(wt) + e);
  }
  const int tiles = n_layers * NT;  // streamed tiles a chunk of slots

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
      // 1. the rows' neighbour indices (-1: no row), then h_0 for the pass
      __syncthreads();  // hs, ids and the W buffers are no longer read
      if constexpr (kStream) load_w_tile<C>(ws, wt, 0);
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

      // 2. the layers
#pragma unroll 1
      for (int l = 0; l < n_layers; ++l) {
        float acc[kTS][kTC];
#pragma unroll
        for (int t = 0; t < kTS; ++t)
#pragma unroll
          for (int j = 0; j < kTC; ++j) acc[t][j] = 0.f;
        if constexpr (!kStream) {
          __syncthreads();  // the rows of h are complete
          product<C, kStream, C>(acc, hrow, ws + (size_t)l * C * C + oc);
        } else {
#pragma unroll 1
          for (int it = 0; it < NT; ++it) {
            // tile g has landed and every thread is done with tile g - 1,
            // whose buffer the next tile overwrites (at it == 0 the rows
            // of h are complete too)
            const int g = l * NT + it;
            cp_async_wait_all();
            __syncthreads();
            if (g + 1 < tiles)
              load_w_tile<C>(ws + (g + 1) % 2 * IT * C, wt, g + 1);
            product<C, kStream, IT>(acc, hrow + it * IT,
                                    ws + g % 2 * IT * C + oc);
          }
        }
        float bo[kTC];
#pragma unroll
        for (int j = 0; j < kTC; ++j)
          bo[j] = __ldg(bias + l * C + oc + j % 4 + 4 * CG * (j / 4));
        if (l + 1 < n_layers) {
          // 3. h_l over h_{l-1}, in place: every thread has read the layer's
          //    input; the next layer's first barrier publishes the rows
          __syncthreads();
#pragma unroll
          for (int t = 0; t < kTS; ++t)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj)
              *reinterpret_cast<float4*>(hrow + 4 * t * HS + oc + 4 * CG * jj) =
                  make_float4(leaky(__fadd_rn(acc[t][4 * jj], bo[4 * jj])),
                              leaky(__fadd_rn(acc[t][4 * jj + 1],
                                              bo[4 * jj + 1])),
                              leaky(__fadd_rn(acc[t][4 * jj + 2],
                                              bo[4 * jj + 2])),
                              leaky(__fadd_rn(acc[t][4 * jj + 3],
                                              bo[4 * jj + 3])));
        } else {
          // 4. + bias, leaky, max over the thread's slots
#pragma unroll
          for (int j = 0; j < kTC; ++j)
#pragma unroll
            for (int t = 0; t < kTS; ++t)
              if (k0 + sg + 4 * t < k)
                best[j] = fmaxf(best[j], leaky(__fadd_rn(acc[t][j], bo[j])));
        }
      }
    }

    // 5. max over the 4 lanes that hold a query's slots; lane sg = 0 writes
    //    the first run of 4 channels, sg = 1 the second
#pragma unroll
    for (int j = 0; j < kTC; ++j) {
      best[j] = fmaxf(best[j], __shfl_xor_sync(kFull, best[j], CG));
      best[j] = fmaxf(best[j], __shfl_xor_sync(kFull, best[j], 2 * CG));
    }
    if (ql < nq && sg < 2) {
      float* orow = out + ((size_t)b * n1 + q0 + ql) * C + oc + 4 * CG * sg;
      *reinterpret_cast<float4*>(orow) =
          sg == 0 ? make_float4(best[0], best[1], best[2], best[3])
                  : make_float4(best[4], best[5], best[6], best[7]);
    }
  }
}

template <int C, bool kStream>
cudaError_t launch(const float* u, const int* idx, const float* v,
                   const float* wt, const float* bias, int b, int n1, int n2,
                   int k, int n_layers, float* out, cudaStream_t stream) {
  auto kernel = cross_pool_kernel<C, kStream>;
  const int smem = smem_bytes<C, kStream>(n_layers);
  // the attribute once, and the blocks a wave once a layer count: they
  // cost host time on every call otherwise
  static const cudaError_t prepared = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (prepared != cudaSuccess) return prepared;
  static int slots[kCachedL + 1] = {};
  const int key = kStream ? 0 : (n_layers <= kCachedL ? n_layers : -1);
  int wave = key >= 0 ? slots[key] : 0;
  if (wave == 0) {
    int per_sm = 0, dev = 0, sms = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    wave = (per_sm < 1 ? 1 : per_sm) * (sms < 1 ? 1 : sms);
    if (key >= 0) slots[key] = wave;
  }
  const int groups = (n1 + Shape<C, kStream>::kQP - 1) /
                     Shape<C, kStream>::kQP;
  const int passes = groups * b;
  const int grid = passes < wave ? passes : wave;
  kernel<<<grid, kThreads, smem, stream>>>(u, idx, v, wt, bias, n1, n2, k,
                                           n_layers, groups, passes, out);
  return cudaGetLastError();
}

// W resident where all L layers fit beside the rows, else streamed
template <int C>
cudaError_t launch_c(const float* u, const int* idx, const float* v,
                     const float* wt, const float* bias, int b, int n1,
                     int n2, int k, int n_layers, float* out,
                     cudaStream_t stream) {
  if constexpr (C <= 64) {
    if (smem_bytes<C, false>(n_layers) <= kMaxSmem)
      return launch<C, false>(u, idx, v, wt, bias, b, n1, n2, k, n_layers,
                              out, stream);
  }
  return launch<C, true>(u, idx, v, wt, bias, b, n1, n2, k, n_layers, out,
                         stream);
}

}  // namespace

// u, v and wt are read as float4 (wt also by cp.async): their data must be
// 16-byte aligned.
extern "C" int kdpc_cross_pool(const float* u, const int* idx, const float* v,
                               const float* wt, const float* bias, int b,
                               int n1, int n2, int k, int c, int n_layers,
                               float* out, cudaStream_t stream) {
  if (b <= 0 || n1 <= 0 || n2 <= 0 || k <= 0 || n_layers <= 0)
    return (int)cudaErrorInvalidValue;
  switch (c) {
    case 16:
      return (int)launch_c<16>(u, idx, v, wt, bias, b, n1, n2, k, n_layers,
                               out, stream);
    case 32:
      return (int)launch_c<32>(u, idx, v, wt, bias, b, n1, n2, k, n_layers,
                               out, stream);
    case 64:
      return (int)launch_c<64>(u, idx, v, wt, bias, b, n1, n2, k, n_layers,
                               out, stream);
    case 128:
      return (int)launch_c<128>(u, idx, v, wt, bias, b, n1, n2, k, n_layers,
                                out, stream);
    case 256:
      return (int)launch_c<256>(u, idx, v, wt, bias, b, n1, n2, k, n_layers,
                                out, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
