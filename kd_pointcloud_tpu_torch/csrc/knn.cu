// Exact k-nearest-neighbour search over 3-D points, fp32.
//
// Replaces the TPU kernel kd_pointcloud_tpu/ops/pallas/knn_fused.py
// knn_fused (_kernel, _extract_topk and the query/key embeddings). That
// kernel selects approximately, through stride-group minima of packed
// distance bits sized for the TPU's matrix unit; none of it carries over.
// This one is exact and matches the plain version, ops/knn.py knn_plain,
// bit for bit: the selection distance is the expansion |q|^2 - 2 q.k + |k|^2
// of ops/distance.py square_distance, each product and sum rounded on its
// own (__fmul_rn / __fadd_rn) in the plain version's order, so both rank
// keys by the same float; ties keep the lower key index first, as lax.top_k
// does. Outputs are sorted ascending: idx (B, S, K) int32 and that distance
// (B, S, K) float32.
//
// What bounds it on an H100: operations. Every query scores every key
// (~10 instructions each, S*N per cloud), against 16 bytes a point of
// traffic. The design gives each query L lanes (a group; L = 4 .. 32, a
// power of two, K <= L, or L = 32 with 32 < K <= 64) so that even a few
// hundred queries fill the card, or, for K = 3 where the queries alone fill
// it, one (L = 1: a thread a query scores every key in turn and inserts into
// its own registers):
//
// - Striped lanes. The key cloud streams through shared memory in tiles of
//   2048 (x, y, z, |k|^2) float4s. A group scans a tile L keys a step, lane
//   l taking key j0 + l, so one step covers L consecutive keys. A lane
//   scores 4 steps before the warp votes once on whether any has a
//   candidate: late in a scan almost none does.
// - One sorted list a group, R entries a lane (R = 1; 3 at L = 1; 2 at
//   L = 32 for 32 < K <= 64, the TPU kernel's largest K). Lane l holds the
//   group's entries l R .. l R + R - 1 (distance, index); the K-th entry,
//   at lane (K - 1) / R, slot (K - 1) % R, is the threshold that both the
//   vote and the insert read. A key is a
//   candidate if its distance is strictly below the threshold (an equal
//   distance at a higher index never displaces an entry).
// - Exact merge. A warp ballot finds the step's candidates; each group
//   inserts its own one at a time, lowest lane (lowest key index) first:
//   the candidate is broadcast with a shuffle, every entry strictly greater
//   moves up one position (inside a lane from slot r - 1 to slot r, across
//   lanes from the previous lane's last slot by __shfl_up_sync), and the
//   first of them takes the candidate. So the list always equals a stable sort of
//   the keys seen so far by (distance, index), whatever the lane that found
//   a key; a
//   candidate is checked again against the threshold the earlier insertions
//   of its step left. ops/knn.py knn_striped is this rule in torch.
// - The launch plan (ops/knn.py knn_plan) picks L and the queries a block
//   from (B, S, N, K): L = 1 for K = 3 when B * S alone gives 8 warps an
//   SM, else L at least min(K, 32) rounded up to a power of two, doubled
//   while B * S * L is short of filling 132 SMs; and up to 1024 threads a
//   block so the key tiles are read from L2 once for many queries.
//
// A lane keeps one or two entries, not a K-long list, so the kernel needs
// few registers whatever K is, and inserting costs one shuffle round for the
// whole group instead of a K-step register bubble in one divergent thread.
// At L = 1 every lane is its own group, so one round inserts the
// candidates of all 32 queries of a warp at once.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kTile = 2048;
constexpr int kU = 4;  // steps a lane scores before one vote
constexpr unsigned kFull = 0xffffffffu;

// The selection distance |q|^2 - 2 q.k + |k|^2 of a key (x, y, z, |k|^2),
// each product and sum rounded on its own in ops/distance.py's order.
__device__ __forceinline__ float expansion(float qx, float qy, float qz,
                                           float s2, float4 kp) {
  const float cross =
      __fadd_rn(__fadd_rn(__fmul_rn(qx, kp.x), __fmul_rn(qy, kp.y)),
                __fmul_rn(qz, kp.z));
  return __fadd_rn(__fsub_rn(s2, __fmul_rn(2.f, cross)), kp.w);
}

// Insert (cd, ci) into a lane's sorted entries ld / li: every entry
// strictly greater moves up one position, the first of them takes the
// candidate; position 0's predecessor is (ud, ui), the previous lane's last
// entry, where has_prev. Top down, so each reads its predecessor before
// that one moves.
template <int R>
__device__ __forceinline__ void insert(float (&ld)[R], int (&li)[R],
                                       float cd, int ci, float ud, int ui,
                                       bool has_prev) {
#pragma unroll
  for (int r = R - 1; r >= 0; --r) {
    if (ld[r] > cd) {
      const float pd = r > 0 ? ld[r > 0 ? r - 1 : 0] : ud;
      const int pi = r > 0 ? li[r > 0 ? r - 1 : 0] : ui;
      const bool take_up = (r > 0 || has_prev) && pd > cd;
      ld[r] = take_up ? pd : cd;
      li[r] = take_up ? pi : ci;
    }
  }
}

template <int R>
__device__ __forceinline__ float kth_entry(const float (&ld)[R], int slot) {
  float v = ld[0];
#pragma unroll
  for (int r = 1; r < R; ++r) v = r == slot ? ld[r] : v;
  return v;
}

template <int L, int R>
__global__ void __launch_bounds__(kMaxThreads)
    knn_kernel(const float* __restrict__ query, const float* __restrict__ keys,
               int s, int n, int k, int* __restrict__ out_idx,
               float* __restrict__ out_d2) {
  __shared__ float4 tile[kTile];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int gl = lane & (L - 1);        // lane within the group
  const int gbase = lane & ~(L - 1);    // the group's first lane in the warp
  const unsigned gmask =
      (L == 32 ? kFull : ((1u << L) - 1u)) << gbase;
  const int q = blockIdx.x * (blockDim.x / L) + threadIdx.x / L;
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

  // this lane's entries, positions gl * R .. gl * R + R - 1 of the
  // group's list: +inf, empty
  float ld[R];
  int li[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    ld[r] = __int_as_float(0x7f800000);
    li[r] = 0;
  }
  float thr = ld[0];  // the group's K-th distance
  const int t_lane = (k - 1) / R, t_slot = (k - 1) % R;

  for (int base = 0; base < n; base += kTile) {
    const int cnt = min(kTile, n - base);
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
      const float* kp = kb + (size_t)(base + j) * 3;
      const float x = kp[0], y = kp[1], z = kp[2];
      tile[j] = make_float4(
          x, y, z,
          __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                    __fmul_rn(z, z)));
    }
    __syncthreads();
    if constexpr (L == 1) {
      // a thread a query (k == R): every key in turn into its own
      // registers, the threshold its last entry
      if (active) {
#pragma unroll 4
        for (int j = 0; j < cnt; ++j) {
          const float d = expansion(qx, qy, qz, s2, tile[j]);
          if (d < ld[R - 1])
            insert<R>(ld, li, d, base + j, ld[0], 0, false);
        }
      }
      continue;
    }
    // kU steps at a time: their distances first (independent chains), one
    // vote, and the steps' candidates only where some lane has one
    for (int j0 = 0; j0 < cnt; j0 += kU * L) {
      float d[kU];
      bool any = false;
#pragma unroll
      for (int t = 0; t < kU; ++t) {
        const int j = j0 + t * L + gl;
        d[t] = __int_as_float(0x7f800000);
        if (j < cnt) d[t] = expansion(qx, qy, qz, s2, tile[j]);
        any = any || d[t] < thr;
      }
      if (!__any_sync(kFull, active && any)) continue;
#pragma unroll
      for (int t = 0; t < kU; ++t) {
        const int jt = base + j0 + t * L;  // the step's first key
        bool cand = active && d[t] < thr;
        unsigned m = __ballot_sync(kFull, cand);
        while (m) {  // warp-uniform: every group inserts its lowest one
          const unsigned mine = m & gmask;
          const int src = mine ? __ffs(mine) - 1 - gbase : 0;
          const float cd = __shfl_sync(kFull, d[t], src, L);
          const float ud = __shfl_up_sync(kFull, ld[R - 1], 1, L);
          const int ui = __shfl_up_sync(kFull, li[R - 1], 1, L);
          if (mine && cd < thr)
            insert<R>(ld, li, cd, jt + src, ud, ui, gl > 0);
          thr = __shfl_sync(kFull, kth_entry<R>(ld, t_slot), t_lane, L);
          cand = cand && gl != src && d[t] < thr;
          m = __ballot_sync(kFull, cand);
        }
      }
    }
  }

  if (active) {
    const size_t row = ((size_t)b * s + q) * k;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (gl * R + r < k) {
        out_idx[row + gl * R + r] = li[r];
        out_d2[row + gl * R + r] = ld[r];
      }
    }
  }
}

template <int L, int R>
cudaError_t launch(const float* query, const float* keys, int b, int s, int n,
                   int k, int qpb, int* out_idx, float* out_d2,
                   cudaStream_t stream) {
  const dim3 grid((s + qpb - 1) / qpb, b);
  knn_kernel<L, R><<<grid, L * qpb, 0, stream>>>(query, keys, s, n, k, out_idx,
                                              out_d2);
  return cudaGetLastError();
}

}  // namespace

// lanes (L) and qpb (queries a block) come from ops/knn.py knn_plan: L in
// {4, 8, 16, 32} with k <= L (one list entry a lane), L = 32 with
// 32 < k <= 64 (two entries a lane), or L = 1 with k = 3 (a thread a query,
// its 3 entries in registers); L * qpb a multiple of 32 and at most 1024.
extern "C" int kdpc_knn(const float* query, const float* keys, int b, int s,
                        int n, int k, int lanes, int qpb, int* out_idx,
                        float* out_d2, cudaStream_t stream) {
  const int entries = lanes == 1 ? 3 : lanes == 32 ? 2 * lanes : lanes;
  if (b <= 0 || s <= 0 || k <= 0 || k > n || k > entries ||
      (lanes == 1 && k != 3) || qpb <= 0 || lanes * qpb > kMaxThreads ||
      (lanes * qpb) % 32 != 0)
    return (int)cudaErrorInvalidValue;
  switch (lanes) {
    case 1:
      return (int)launch<1, 3>(query, keys, b, s, n, k, qpb, out_idx, out_d2,
                               stream);
    case 4:
      return (int)launch<4, 1>(query, keys, b, s, n, k, qpb, out_idx, out_d2,
                               stream);
    case 8:
      return (int)launch<8, 1>(query, keys, b, s, n, k, qpb, out_idx, out_d2,
                               stream);
    case 16:
      return (int)launch<16, 1>(query, keys, b, s, n, k, qpb, out_idx,
                                out_d2, stream);
    case 32:
      if (k > 32)
        return (int)launch<32, 2>(query, keys, b, s, n, k, qpb, out_idx,
                                  out_d2, stream);
      return (int)launch<32, 1>(query, keys, b, s, n, k, qpb, out_idx,
                                out_d2, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
