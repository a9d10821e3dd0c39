// Exact greedy furthest-point sampling.
//
// Replaces the TPU kernel kd_pointcloud_tpu/ops/pallas/fps_pallas.py
// furthest_point_sample_pallas (bodies _fps_kernel_folded for N % 1024 == 0
// and _fps_kernel otherwise); one kernel here covers every N up to 32768.
// Semantics are those of the plain version, ops/fps.py fps_plain: seed at
// index 0, then M-1 rounds of "running min of the squared distance to the
// last pick, then the argmax with a first-index tie-break". fps_cluster
// there is this file's split and reduction order in torch, for the tests.
//
// What bounds it on an H100: neither bytes (12 B a point, read once) nor
// operations (~10 flops a point a round), but the serial chain of M-1
// dependent rounds: a round's time is its distance pass plus its
// synchronisation. The earlier design (one block of 1024 threads a cloud,
// two barriers a round, ten shuffles per argmax, and the winner's
// coordinates read from device memory between the barriers) spent about
// 2,000 cycles a round on one SM per cloud. This design shortens both:
//
// - A cloud is split over a thread-block cluster of G blocks of 1024 / G
//   threads (G in 1, 2, 4, 8, 16; ops/fps.py fps_plan picks it so that the
//   B clusters run in one wave). Every thread holds PPT = ceil(N / 1024)
//   points and their running minimum in registers, so an SM's distance
//   pass shrinks with G while the cloud's 32 warps, and its 32 candidates
//   a round, stay. Warp w of the cluster holds the w-th run of 32 PPT
//   points, so candidates in slot order are in point order. One block an
//   SM: the launch asks for more than half an SM's shared memory.
// - A lane takes its first maximum by a tree of pairs (the higher slot
//   only when strictly larger); a warp's argmax is two redux.sync:
//   __reduce_max_sync on the distance's bits as an int (a squared distance
//   is >= 0, so its bits order like the float; padding is -1, below every
//   real key), then __reduce_min_sync over the indices of the lanes that
//   hold that max.
// - The warp's winner lane reads its point's coordinates from its own copy
//   in shared memory (loaded beside the reductions) and sends (x, y, z,
//   index) and the key with st.async into slot rank * W + warp of every
//   block of the cluster (distributed shared memory); each st.async counts
//   its bytes on the receiving block's mbarrier (complete_tx). A block
//   waits on its own mbarrier until the round's 32 x 20 bytes are there:
//   no cluster barrier, which measured ~1,000 cycles a round; at G = 1
//   plain shared memory and one __syncthreads. Then every warp reads the
//   32 slots, takes the largest key by one redux.sync and the first slot
//   that holds it by a ballot -- the first maximum, since slots ascend in
//   point order -- and the winner's index and coordinates by shuffles. No
//   device-memory access on the chain but the 4-byte index store.
// - Slots and mbarriers are double-buffered by round parity; round r is
//   phase (r - 1) / 2 of mbarrier r & 1, armed (one local arrival with the
//   round's byte count) two rounds ahead. Slot reuse: a block sends round
//   r + 2 only after its round r + 1 completed, which needs every warp's
//   round r + 1 candidate; a warp sends that only after it read round r's
//   slots, and a block sends its round r + 1 candidates only after its
//   round r phase completed. So no slot is overwritten while a block still
//   reads it, and no phase receives another round's bytes.
//
// Rounding: the squared distance is written with __fmul_rn / __fadd_rn in
// the plain version's order ((dx*dx + dy*dy) + dz*dz), so nvcc cannot
// contract it into FMAs and the indices are bit-identical to the plain
// version's.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCloudThreads = 1024;  // threads a cloud, over its G blocks
constexpr int kCands = kCloudThreads / 32;  // candidates a round: a warp's
constexpr unsigned kFull = 0xffffffffu;
// more than half of an SM's 228 kB of shared memory: one block an SM, so a
// cluster's blocks do not share SMs
constexpr int kOneBlockSmem = 116 * 1024;

// a block's exchange slots: candidate r of a round in entry (r & 1), and
// the two mbarriers that count their bytes
struct Slots {
  float4 pt[2][kCands];  // x, y, z and the index's bits
  int key[2][kCands];
  unsigned long long bar[2];
};
constexpr unsigned kKeyOff = 2 * kCands * 16, kBarOff = kKeyOff + 2 * kCands * 4;
constexpr unsigned kRoundBytes = kCands * 20;  // the slot bytes of a round

__device__ __forceinline__ unsigned map_rank(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// the block's one arrival of a phase, with the bytes the phase awaits
__device__ __forceinline__ void arm(unsigned bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(kRoundBytes)
               : "memory");
}

__device__ __forceinline__ void wait_parity(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], "
      "%1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

template <int G, int PPT>
__global__ void __launch_bounds__(kCloudThreads / G, 1)
    fps_kernel(const float* __restrict__ xyz, int n, int m,
               int* __restrict__ out) {
  constexpr int T = kCloudThreads / G, W = T / 32, NB = T * PPT;
  __shared__ Slots slots;
  extern __shared__ float slice[];  // [3][NB]: the block's points
  float* sx = slice;
  float* sy = slice + NB;
  float* sz = slice + 2 * NB;

  const int rank = G > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const float* p = xyz + (size_t)(blockIdx.x / G) * n * 3;
  int* o = out + (size_t)(blockIdx.x / G) * m;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // the block's points, then the warp's: warp w of the block holds points
  // wbase .. wbase + 32 PPT - 1, point wbase + 32 j + lane in slot j of
  // the lane (and in the lane's part of the slice)
  const int base = rank * NB, wbase = base + warp * 32 * PPT;

  float px[PPT], py[PPT], pz[PPT], dmin[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int i = wbase + 32 * j + lane;
    if (i < n) {
      px[j] = p[3 * i];
      py[j] = p[3 * i + 1];
      pz[j] = p[3 * i + 2];
      dmin[j] = 1e10f;
    } else {  // padding: below every real distance, never a candidate
      px[j] = py[j] = pz[j] = 0.f;
      dmin[j] = -1.f;
    }
    sx[t + j * T] = px[j];  // read back only by this thread
    sy[t + j * T] = py[j];
    sz[t + j * T] = pz[j];
  }
  if (rank == 0 && t == 0) o[0] = 0;
  float lx = p[0], ly = p[1], lz = p[2];

  // every block's slots as shared::cluster addresses; at G > 1 the
  // mbarriers take one local arrival a phase (the arm, with the round's
  // bytes) and the writers' st.async complete the bytes
  const unsigned mine = static_cast<unsigned>(__cvta_generic_to_shared(&slots));
  unsigned dst[G];
  if constexpr (G > 1) {
#pragma unroll
    for (int d = 0; d < G; ++d) dst[d] = map_rank(mine, d);
    if (t == 0) {
#pragma unroll
      for (int b = 0; b < 2; ++b)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
            mine + kBarOff + 8 * b));
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      arm(mine + kBarOff + 8);      // round 1
      if (m > 2) arm(mine + kBarOff);  // round 2
    }
    // every block has started, and armed, before a slot is written
    cg::this_cluster().sync();
  }

  for (int r = 1; r < m; ++r) {
    const int par = r & 1;
    float v[PPT];
    int vj[PPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const float dx = __fsub_rn(px[j], lx);
      const float dy = __fsub_rn(py[j], ly);
      const float dz = __fsub_rn(pz[j], lz);
      const float d = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      dmin[j] = fminf(dmin[j], d);
      v[j] = dmin[j];
      vj[j] = j;
    }
    // the thread's first maximum by a tree of pairs: the right one (the
    // higher slots, the higher indices) wins only when strictly larger
#pragma unroll
    for (int s = 1; s < PPT; s *= 2)
#pragma unroll
      for (int j = 0; j < PPT; j += 2 * s)
        if (v[j + s] > v[j]) {
          v[j] = v[j + s];
          vj[j] = vj[j + s];
        }
    const bool real = v[0] >= 0.f;  // padding alone is -1
    const int key = real ? __float_as_int(v[0]) : -1;
    const int gi = real ? wbase + 32 * vj[0] + lane : INT_MAX;
    const int own = t + vj[0] * T;  // the candidate's place in the slice
    const float cx = sx[own];
    const float cy = sy[own];
    const float cz = sz[own];
    const int wk = __reduce_max_sync(kFull, key);
    const int wi = __reduce_min_sync(kFull, key == wk ? gi : INT_MAX);
    // one writer a warp: the lane of the winner (a warp of padding alone
    // has wi == INT_MAX everywhere and lets lane 0 write its key of -1)
    if (gi == wi && (wi != INT_MAX || lane == 0)) {
      const unsigned at = par * kCands + rank * W + warp;
      if constexpr (G > 1) {
#pragma unroll
        for (int d = 0; d < G; ++d) {
          const unsigned bar = dst[d] + kBarOff + 8 * par;
          asm volatile(
              "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
              "[%0], {%1, %2, %3, %4}, [%5];" ::"r"(dst[d] + 16 * at),
              "r"(__float_as_int(cx)), "r"(__float_as_int(cy)),
              "r"(__float_as_int(cz)), "r"(wi), "r"(bar)
              : "memory");
          asm volatile(
              "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
              "[%0], %1, [%2];" ::"r"(dst[d] + kKeyOff + 4 * at),
              "r"(wk), "r"(bar)
              : "memory");
        }
      } else {
        slots.pt[par][warp] = make_float4(cx, cy, cz, __int_as_float(wi));
        slots.key[par][warp] = wk;
      }
    }
    if constexpr (G > 1) {
      // round r is phase (r - 1) / 2 of mbarrier r & 1; once it is over
      // for this block, the block arms the phase of round r + 2
      wait_parity(mine + kBarOff + 8 * par, ((r - 1) >> 1) & 1);
      if (t == 0 && r + 2 < m) arm(mine + kBarOff + 8 * par);
    } else {
      __syncthreads();
    }
    // slot s holds a candidate of points below those of slot s + 1, so the
    // first slot with the largest key holds the first maximum
    const int ck = slots.key[par][lane];
    const float4 cp = slots.pt[par][lane];
    const int bk = __reduce_max_sync(kFull, ck);
    const int src = __ffs(__ballot_sync(kFull, ck == bk)) - 1;
    const int bi = __shfl_sync(kFull, __float_as_int(cp.w), src);
    lx = __shfl_sync(kFull, cp.x, src);
    ly = __shfl_sync(kFull, cp.y, src);
    lz = __shfl_sync(kFull, cp.z, src);
    if (rank == 0 && t == 0) o[r] = bi;
  }
  // no block leaves while another may still write into its slots
  if constexpr (G > 1) cg::this_cluster().sync();
}

template <int G, int PPT>
int smem_bytes() {
  const int slice = 3 * (kCloudThreads / G) * PPT * (int)sizeof(float);
  return slice < kOneBlockSmem ? kOneBlockSmem : slice;
}

template <int G, int PPT>
cudaLaunchConfig_t config(int b, int smem, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * G);
  cfg.blockDim = dim3(kCloudThreads / G);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = G;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int G, int PPT>
cudaError_t prepare() {
  auto kernel = fps_kernel<G, PPT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<G, PPT>());
  if (err == cudaSuccess && G > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

template <int G, int PPT>
cudaError_t launch(const float* xyz, int b, int n, int m, int* out,
                   cudaStream_t stream) {
  // the function attributes, set once: they cost host time on every call
  static const cudaError_t prepared = prepare<G, PPT>();
  if (prepared != cudaSuccess) return prepared;
  const int smem = smem_bytes<G, PPT>();
  if (G == 1) {
    fps_kernel<G, PPT>
        <<<b, kCloudThreads, smem, stream>>>(xyz, n, m, out);
    return cudaGetLastError();
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      config<G, PPT>(b, smem, stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, fps_kernel<G, PPT>, xyz, n, m, out);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int G, int PPT>
cudaError_t clusters(int* count) {
  static const cudaError_t prepared = prepare<G, PPT>();
  if (prepared != cudaSuccess) return prepared;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<G, PPT>(
      1, smem_bytes<G, PPT>(), 0, &attr);
  return cudaOccupancyMaxActiveClusters(count, fps_kernel<G, PPT>,
                                        &cfg);
}

// points a thread: the smallest of 1, 2, 4, ..., 32 that covers n
int points_a_thread(int n) {
  int ppt = 1;
  while (ppt * kCloudThreads < n) ppt *= 2;
  return ppt;
}

template <int G>
cudaError_t launch_g(const float* xyz, int b, int n, int m, int* out,
                     cudaStream_t stream) {
  switch (points_a_thread(n)) {
    case 1: return launch<G, 1>(xyz, b, n, m, out, stream);
    case 2: return launch<G, 2>(xyz, b, n, m, out, stream);
    case 4: return launch<G, 4>(xyz, b, n, m, out, stream);
    case 8: return launch<G, 8>(xyz, b, n, m, out, stream);
    case 16: return launch<G, 16>(xyz, b, n, m, out, stream);
    case 32:
      // G = 1 would need 384 kB for its slice
      if constexpr (G > 1)
        return launch<G, 32>(xyz, b, n, m, out, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// g: blocks a cloud (1, 2, 4, 8 or 16; ops/fps.py fps_plan); n <= 32768,
// and n <= 16384 at g = 1.
extern "C" int kdpc_fps(const float* xyz, int b, int n, int m, int g,
                        int* out, cudaStream_t stream) {
  if (b <= 0 || m <= 0 || m > n || n > 32 * kCloudThreads)
    return (int)cudaErrorInvalidValue;
  switch (g) {
    case 1: return (int)launch_g<1>(xyz, b, n, m, out, stream);
    case 2: return (int)launch_g<2>(xyz, b, n, m, out, stream);
    case 4: return (int)launch_g<4>(xyz, b, n, m, out, stream);
    case 8: return (int)launch_g<8>(xyz, b, n, m, out, stream);
    case 16: return (int)launch_g<16>(xyz, b, n, m, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// clusters of g blocks that can be resident at once (one block an SM), by
// cudaOccupancyMaxActiveClusters, for the kernel at n <= 8192 points
extern "C" int kdpc_fps_clusters(int g, int* count) {
  switch (g) {
    case 1: return (int)clusters<1, 8>(count);
    case 2: return (int)clusters<2, 8>(count);
    case 4: return (int)clusters<4, 8>(count);
    case 8: return (int)clusters<8, 8>(count);
    case 16: return (int)clusters<16, 8>(count);
    default: return (int)cudaErrorInvalidValue;
  }
}
