// Exact furthest-point sampling with bounding-sphere pruning.
//
// Replaces the TPU kernel attic/fps_pruned.py furthest_point_sample_pruned
// (_fps_kernel_pruned), a kept negative result of the JAX package: the
// same function as csrc/fps.cu (seed at index 0, then M-1 rounds of
// "running min of the squared distance to the last pick, then the argmax,
// ties to the smallest original index"), with the rounds skipping work that
// provably changes nothing. Plain version: attic/fps_pruned.py
// fps_pruned_plain, which makes the same decisions in torch; fps_pruned_split
// there is this file's split of a cloud over blocks and its folds, in torch.
//
// Layout (made by attic/fps_pruned.py spatial_permutation, plain torch):
// the points of a cloud are split into N/128 spatially compact sub-blocks
// of 128 (the JAX package's 2-level equal-count sort), each with a bounding
// sphere (centre, radius); planes holds the permuted coordinates as (B, 3,
// N) and pidx their original indices, ascending within each sub-block.
//
// What bounds it on an H100: the serial chain of M-1 dependent rounds, not
// bytes or operations. On the TPU pruning lost because it added work to
// that chain. Here it takes work off it: at 8192 points about 3 of the 64
// sub-blocks need an update in a round (5 % of the updates at B = 16). The
// earlier design (one block of up to 1024 threads a cloud, points in
// registers, two __syncthreads a round, one warp folding all sub-blocks by
// a shuffle argmax, the winner's coordinates read from device memory
// inside the chain, sqrt(bm) recomputed for every sub-block every round)
// took 1.1 us a round whatever B was. This one:
//
// - A block of 8 warps holds up to 64 sub-blocks in shared memory: each
//   point's coordinates and running minimum as a float4 and its original
//   index, 20 B a point, 160 kB at 8192 points, so one block an SM. Above
//   8192 points a cloud is split over a thread-block cluster of G = 2 or 4
//   such blocks (attic/fps_pruned.py fps_pruned_plan; N <= 32768).
// - Lane l of warp w owns sub-block w + 8 l of its block, in registers:
//   centre, radius, the squared prune threshold ((r + sqrt(bm)) * 1.0001 +
//   1e-6)^2 in the plain version's operation order, recomputed only when bm
//   changes, and the cached winner (bm's bits as a key, the smallest
//   original index attaining it, its x, y, z).
// - A round: each warp tests its sub-blocks' spheres against the last pick
//   (skip when dist(c, centre)^2 >= threshold^2: the triangle inequality
//   puts every point at least sqrt(bm) from c, so no minimum can fall; the
//   slop covers float32 rounding, as in the JAX kernel), and a ballot gives
//   its dirty mask. The round's few dirty sub-blocks so fall to different
//   warps, which update them side by side on the SM's four schedulers: 4
//   points a lane from shared memory, each lane's first maximum as its
//   candidate, the sub-block's new winner as the fold of the candidates
//   (redux.sync max of the key, min of the original index among the lanes
//   that hold it, coordinates by shuffle), and in the same stretch of code
//   the warp's winner as the fold of every lane's best of those candidates
//   and of its clean sub-blocks' cached winners. Each warp writes its
//   winner into a slot of the round (double-buffered by round parity), one
//   __syncthreads a round, and every warp folds the 8 slots the same way
//   into the pick. At G > 1 each warp's winner goes by st.async into its
//   slot in every block of the cluster, counted on that block's mbarrier,
//   as in csrc/fps.cu, and every warp folds the 8 G slots. No device-memory
//   access on the chain but the 4-byte index store.
// - Ties go to the smallest original index: within a sub-block positions
//   ascend with it, and every fold across sub-blocks, warps or blocks
//   compares original indices.
//
// Rounding: distances use __fmul_rn / __fadd_rn in the plain versions'
// order ((dx*dx + dy*dy) + dz*dz), and the sphere test the plain version's
// operations in its order, so the indices are bit-identical to fps_plain
// and csrc/fps.cu, and the skip decisions (dirty_count) to
// fps_pruned_plain's.
//
// The TPU kernel's folded (8B, N/8) layout, bit-packed dirty masks in SMEM,
// fat-window quarantine and its interpret / unroll / restrict_scan options
// are TPU mechanics and are not ported.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSub = 128;              // points a sub-block
constexpr int kPer = kSub / 32;        // points a lane walks of a sub-block
constexpr int kBlockSub = 64;          // sub-blocks a block at most
constexpr int kWarps = 8;              // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSub = 256;           // sub-blocks a cloud: N <= 32768
constexpr int kMaxG = 4;               // blocks a cloud
constexpr int kCands = kWarps * kMaxG; // a round's slots: one a warp
constexpr float kSlopMul = 1.0001f;
constexpr float kSlopAdd = 1e-6f;
constexpr unsigned kFull = 0xffffffffu;
// a point's float4 (x, y, z, running min) and int (original index)
constexpr int kPointBytes = 20;

// the round's exchange: warp s of the cluster's winner in slot
// (round & 1) * kCands + s, and at G > 1 the two mbarriers that count the
// bytes other blocks send
struct Slots {
  float4 pt[2 * kCands];  // x, y, z and the original index's bits
  int key[2 * kCands];
  unsigned long long bar[2];
};
constexpr unsigned kKeyOff = 2 * kCands * 16, kBarOff = kKeyOff + 2 * kCands * 4;

// A candidate: a squared distance's bits as the key (>= 0, so it orders as
// an int; -1 is none), the point's original index and coordinates. The
// better of two: larger key, or equal key and smaller index.
struct Cand {
  int key, idx;
  float x, y, z;
};

__device__ __forceinline__ void take_better(Cand& a, const Cand& b) {
  if (b.key > a.key || (b.key == a.key && b.idx < a.idx)) a = b;
}

// a lane's sub-block: its sphere, threshold and cached winner
struct Held {
  float cx, cy, cz, rad, thr2;
  Cand win;
};

// the plain version's (r + sqrt(bm)) * 1.0001 + 1e-6, squared
__device__ __forceinline__ float threshold2(float r, float bm) {
  const float thr = __fadd_rn(
      __fmul_rn(__fadd_rn(r, __fsqrt_rn(bm)), kSlopMul), kSlopAdd);
  return __fmul_rn(thr, thr);
}

__device__ __forceinline__ float dist2(float ax, float ay, float az,
                                       float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// the candidate that wins over the warp, in every lane
__device__ __forceinline__ Cand fold(const Cand& c) {
  const int wk = __reduce_max_sync(kFull, c.key);
  const int wi = __reduce_min_sync(kFull, c.key == wk ? c.idx : INT_MAX);
  const int src =
      __ffs(__ballot_sync(kFull, c.key == wk && c.idx == wi)) - 1;
  return Cand{wk, wi, __shfl_sync(kFull, c.x, src),
              __shfl_sync(kFull, c.y, src), __shfl_sync(kFull, c.z, src)};
}

// the next NQ set bits of mask (the owner lanes of dirty sub-blocks),
// cleared from it
template <int NQ>
__device__ __forceinline__ void pop(unsigned& mask, int (&ln)[NQ]) {
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    ln[q] = __ffs(mask) - 1;
    mask &= mask - 1;
  }
}

// Update NQ dirty sub-blocks of this warp (owned by the lanes of the next
// NQ bits of mask) against the last pick, and return the warp's winner of
// the round. Each lane's candidate of a sub-block is the first maximum of
// its 4 points (positions j * 32 + lane); the sub-block's winner, cached by
// its owner lane with the new threshold, is the fold of those candidates,
// and the warp's winner the fold of every lane's best of them and of the
// cached winners of the warp's other sub-blocks. The two folds do not wait
// on each other, nor do the NQ sub-blocks' loads, distances and folds:
// written side by side in one block of code, their latencies overlap.
template <int NQ>
__device__ __forceinline__ Cand update(Held& h, float4* s_pt,
                                       const int* s_pidx, unsigned& mask,
                                       int warp, float lx, float ly,
                                       float lz, int lane) {
  int ln[NQ];
  pop<NQ>(mask, ln);
  float4 p[NQ][kPer];
  int pid[NQ][kPer];
  float rad[NQ];
  int base[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    base[q] = (warp + kWarps * ln[q]) * kSub;
    rad[q] = __shfl_sync(kFull, h.rad, ln[q]);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      p[q][j] = s_pt[base[q] + j * 32 + lane];
      pid[q][j] = s_pidx[base[q] + j * 32 + lane];
    }
  }
  Cand c[NQ];
  bool kept = true;  // the lane's cached winner is not being replaced
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    c[q] = Cand{-1, 0, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      p[q][j].w = fminf(p[q][j].w, dist2(p[q][j].x, p[q][j].y, p[q][j].z,
                                         lx, ly, lz));
      s_pt[base[q] + j * 32 + lane] = p[q][j];
      // a later point only when strictly larger (its index is larger too)
      if (__float_as_int(p[q][j].w) > c[q].key)
        c[q] = Cand{__float_as_int(p[q][j].w), pid[q][j], p[q][j].x,
                    p[q][j].y, p[q][j].z};
    }
    kept = kept && lane != ln[q];
  }
  Cand best = kept ? h.win : Cand{-1, INT_MAX, 0.f, 0.f, 0.f};
#pragma unroll
  for (int q = 0; q < NQ; ++q) take_better(best, c[q]);
  Cand win[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) win[q] = fold(c[q]);
  const Cand ww = fold(best);
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const float t2 = threshold2(rad[q], __int_as_float(win[q].key));
    if (lane == ln[q]) {
      h.win = win[q];
      h.thr2 = t2;
    }
  }
  return ww;
}

__device__ __forceinline__ unsigned map_rank(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// the block's one arrival of a phase, with the bytes the phase awaits
__device__ __forceinline__ void arm(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
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

template <int G>
__global__ void __launch_bounds__(kThreads, 1)
    fps_pruned_kernel(const float* __restrict__ planes,
                      const int* __restrict__ pidx,
                      const float* __restrict__ centers,
                      const float* __restrict__ radii,
                      const float* __restrict__ xyz, int n, int m,
                      int* __restrict__ out, int* __restrict__ dirty_count) {
  extern __shared__ float4 smem4[];
  __shared__ Slots slots;
  const int n_sub = n / kSub, nb = n_sub / G;   // sub-blocks: cloud, block
  float4* s_pt = smem4;                  // [nb * kSub]: x, y, z, running min
  int* s_pidx = reinterpret_cast<int*>(s_pt + nb * kSub);  // original index
  const int rank = G > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int b = blockIdx.x / G;
  const int first = rank * nb;           // the block's first sub-block
  const float* px = planes + (size_t)b * 3 * n + first * kSub;
  const int* pi = pidx + (size_t)b * n + first * kSub;
  for (int e = threadIdx.x; e < nb * kSub; e += kThreads) {
    s_pt[e] = make_float4(px[e], px[e + n], px[e + 2 * n], 1e10f);
    s_pidx[e] = pi[e];
  }
  const unsigned mine = static_cast<unsigned>(__cvta_generic_to_shared(&slots));
  constexpr unsigned kRoundBytes = kWarps * G * kPointBytes;
  if constexpr (G > 1) {
    if (threadIdx.x == 0) {
#pragma unroll
      for (int p = 0; p < 2; ++p)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
            mine + kBarOff + 8 * p));
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      arm(mine + kBarOff + 8, kRoundBytes);    // round 1
      if (m > 2) arm(mine + kBarOff, kRoundBytes);  // round 2
    }
    // every block has loaded its slice and armed before a slot is written
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int own = warp + kWarps * lane;  // the lane's sub-block, if < nb
  int* o = out + (size_t)b * m;
  Held h;
  h.win = Cand{-1, INT_MAX, 0.f, 0.f, 0.f};
  h.cx = h.cy = h.cz = h.rad = 0.f;
  h.thr2 = -1.f;                         // no sub-block: never dirty
  if (own < nb) {
    const size_t g = (size_t)b * n_sub + first + own;
    h.cx = centers[3 * g];
    h.cy = centers[3 * g + 1];
    h.cz = centers[3 * g + 2];
    h.rad = radii[g];
    h.thr2 = threshold2(h.rad, 1e10f);
    const float4 q = s_pt[own * kSub];
    h.win = Cand{__float_as_int(1e10f), s_pidx[own * kSub], q.x, q.y, q.z};
  }
  unsigned dst = 0;
  if constexpr (G > 1) dst = map_rank(mine, lane < G ? lane : 0);
  const float* p0 = xyz + (size_t)b * n * 3;
  float lx = p0[0], ly = p0[1], lz = p0[2];
  if (rank == 0 && threadIdx.x == 0) o[0] = 0;
  int dirty = 0;

  for (int r = 1; r < m; ++r) {
    // 1. the sphere tests (bit l: lane l's sub-block is dirty), then the
    //    dirty sub-blocks' minima and cached winners, up to four at a time,
    //    the last four with the warp's winner
    Cand ww;
    unsigned mask = __ballot_sync(
        kFull, dist2(h.cx, h.cy, h.cz, lx, ly, lz) < h.thr2);
    dirty += __popc(mask);
    while (__popc(mask) > 4)
      update<4>(h, s_pt, s_pidx, mask, warp, lx, ly, lz, lane);
    switch (__popc(mask)) {
      case 0: ww = fold(h.win); break;
      case 1: ww = update<1>(h, s_pt, s_pidx, mask, warp, lx, ly, lz, lane);
        break;
      case 2: ww = update<2>(h, s_pt, s_pidx, mask, warp, lx, ly, lz, lane);
        break;
      case 3: ww = update<3>(h, s_pt, s_pidx, mask, warp, lx, ly, lz, lane);
        break;
      default:
        ww = update<4>(h, s_pt, s_pidx, mask, warp, lx, ly, lz, lane);
    }
    // 2. the warp's winner into its slot of the round; the slots alternate
    //    by round parity: a warp writes round r + 2's only after round
    //    r + 1's barrier (or wait), which every warp reaches only after it
    //    read round r's
    const int par = r & 1;
    if constexpr (G > 1) {
      // lane d sends to block d; round r is phase (r - 1) / 2 of mbarrier
      // r & 1, armed two rounds ahead
      if (lane < G) {
        const unsigned at = par * kCands + rank * kWarps + warp;
        const unsigned bar = dst + kBarOff + 8 * par;
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
            "[%0], {%1, %2, %3, %4}, [%5];" ::"r"(dst + 16 * at),
            "r"(__float_as_int(ww.x)), "r"(__float_as_int(ww.y)),
            "r"(__float_as_int(ww.z)), "r"(ww.idx), "r"(bar)
            : "memory");
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
            "[%0], %1, [%2];" ::"r"(dst + kKeyOff + 4 * at),
            "r"(ww.key), "r"(bar)
            : "memory");
      }
    } else if (lane == 0) {
      slots.pt[par * kCands + warp] =
          make_float4(ww.x, ww.y, ww.z, __int_as_float(ww.idx));
      slots.key[par * kCands + warp] = ww.key;
    }
    if constexpr (G > 1) {
      wait_parity(mine + kBarOff + 8 * par, ((r - 1) >> 1) & 1);
      if (threadIdx.x == 0 && r + 2 < m)
        arm(mine + kBarOff + 8 * par, kRoundBytes);
    } else {
      __syncthreads();
    }
    // 4. the pick: every warp folds the round's slots the same way
    const bool slot = lane < kWarps * G;
    const float4 cp = slot ? slots.pt[par * kCands + lane]
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    const Cand pick = fold(Cand{slot ? slots.key[par * kCands + lane] : -1,
                                slot ? __float_as_int(cp.w) : INT_MAX, cp.x,
                                cp.y, cp.z});
    lx = pick.x;
    ly = pick.y;
    lz = pick.z;
    if (rank == 0 && threadIdx.x == 0) o[r] = pick.idx;
  }
  if (dirty_count != nullptr && lane == 0) atomicAdd(dirty_count + b, dirty);
  // no block leaves while another may still write into its slots
  if constexpr (G > 1) cg::this_cluster().sync();
}

// the dynamic shared memory of a block holding nb sub-blocks: its points
int smem_bytes(int nb) { return nb * kSub * kPointBytes; }

template <int G>
cudaError_t launch(const float* planes, const int* pidx, const float* centers,
                   const float* radii, const float* xyz, int b, int n, int m,
                   int* out, int* dirty_count, cudaStream_t stream) {
  auto kernel = fps_pruned_kernel<G>;
  // the attribute, set once: it costs host time on every call otherwise
  static const cudaError_t prepared = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes(kBlockSub));
  if (prepared != cudaSuccess) return prepared;
  const int smem = smem_bytes(n / kSub / G);
  if (G == 1) {
    kernel<<<b, kThreads, smem, stream>>>(planes, pidx, centers, radii, xyz,
                                          n, m, out, dirty_count);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * G);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = G;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, planes, pidx,
                                             centers, radii, xyz, n, m, out,
                                             dirty_count);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// blocks a cloud: the fewest of 1, 2, 4 whose share of the sub-blocks fits
// a block (attic/fps_pruned.py fps_pruned_plan)
int blocks_a_cloud(int n) {
  const int n_sub = n / kSub;
  return n_sub <= kBlockSub ? 1 : (n_sub <= 2 * kBlockSub ? 2 : 4);
}

}  // namespace

// n % 1024 == 0, n <= 32768; dirty_count (B,) int32, zeroed by the caller,
// or null
extern "C" int kdpc_fps_pruned(const float* planes, const int* pidx,
                               const float* centers, const float* radii,
                               const float* xyz, int b, int n, int m,
                               int* out, int* dirty_count,
                               cudaStream_t stream) {
  if (b <= 0 || m <= 0 || m > n || n % 1024 != 0 || n / kSub > kMaxSub)
    return (int)cudaErrorInvalidValue;
  switch (blocks_a_cloud(n)) {
    case 1:
      return (int)launch<1>(planes, pidx, centers, radii, xyz, b, n, m, out,
                            dirty_count, stream);
    case 2:
      return (int)launch<2>(planes, pidx, centers, radii, xyz, b, n, m, out,
                            dirty_count, stream);
    default:
      return (int)launch<4>(planes, pidx, centers, radii, xyz, b, n, m, out,
                            dirty_count, stream);
  }
}
