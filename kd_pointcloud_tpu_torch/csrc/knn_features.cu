// Exact k-nearest-neighbour search in feature space, fp32: the FG cross
// layer's feature half (ops/knn.py knn_features).
//
// Replaces no Pallas kernel: the JAX package runs this search as XLA
// (kd_pointcloud_tpu/ops/knn.py knn_point_dist on features: a float32
// matrix product, the expansion and lax.top_k), since its fused kNN kernel
// takes 3-D points only. In plain torch the search writes a (B, 2048, N)
// distance chunk to device memory and reads it again to select; this kernel
// keeps the distances in registers and reads nothing back to the host.
//
// What it computes. For query rows q (B, S, D) and key rows x (B, N, D):
// the indices (B, S, K) int32 of each query's K smallest distances
// ((-2 * sum_c q_c x_c) + |q|^2) + |x|^2, ascending, equal distances lower
// key index first (a stable sort's order), and, where out_d is given, those
// distances (B, S, K). It equals ops/knn.py knn_features_plain
// (feature_distance and a stable sort) bit for bit:
// - the cross term is a chain of float32 fused multiply-adds over channels
//   0 .. D - 1 in ascending order, from zero: the order of the float32 SIMT
//   GEMM that cuBLAS runs for feature_distance's matrix product (no split
//   of the channels, no TF32, no tensor cores);
// - |q|^2 and |x|^2 are the wrapper's, torch's own sums, as
//   feature_distance's;
// - -2 times the cross term is exact, so adding |q|^2 to it in one fused
//   multiply-add rounds as feature_distance's multiply and add do; |x|^2
//   is added last (__fadd_rn), in feature_distance's order;
// - the selection ranks (distance, index) pairs lexicographically: a key
//   enters a query's list only if its pair is below the list's K-th pair,
//   so the list is the stable sort's first K whatever order the threads
//   visit the keys in.
//
// What bounds it on an H100: operations. A (query, key) pair costs D
// multiply-adds, and a key's D floats are read once for a block of 64 or
// 128 queries: at D >= 32 the product is compute-bound on the CUDA cores
// (67 TFLOP/s float32). An fg eval pair (its four sites, both directions)
// needs 9.8 GFLOP: 0.146 ms at that peak.
//
// Design:
// - A block takes BM = 128 queries (8 rows a thread), or 64 (4 rows a
//   thread) where 128 would give fewer blocks than two an SM (ops/knn.py
//   feature_rows), and walks all N keys in tiles of 128, each tile's
//   channels in chunks of 32 through shared memory, transposed so that a
//   thread reads its rows and its 8 keys as float4s into a register tile of
//   (rows x 8) sums: the SIMT GEMM's tile. A warp stores 32 consecutive
//   rows of one float4 column, free of bank conflicts; at D = 32 the query
//   chunk is loaded once for the whole walk.
// - After a key tile each thread turns its sums into distances and tests
//   each against its query's K-th pair (shared memory): one compare a key.
//   Only candidates go on, into a queue of 32 slots a query (one shared
//   atomic a candidate). The queues are merged, one thread a query
//   inserting into the query's sorted list (K slots in shared memory), only
//   where a queue is half full, a candidate found its queue full, or the
//   walk has ended: between merges the test reads a K-th pair that may be
//   stale, which lets through more candidates, never fewer. A candidate
//   that found its queue full is tested again after the merge. After the
//   first tiles almost no key passes: about K ln(N / K) inserts a query in
//   all, against N tests. In the first tile, where every key would pass the
//   empty list, the test also takes the largest of the row's 16 threads'
//   smallest pairs (a warp shuffle), which bounds the K-th pair for
//   K <= 16.
// - Nothing of the distance matrix leaves the registers; the lists leave
//   shared memory once, at the end.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16: ty picks rows, tx keys
constexpr int kBN = 128;       // keys a tile
constexpr int kBK = 32;        // channels a chunk
constexpr int kCap = 32;       // queue slots a query
constexpr int kPad = 4;        // floats after each shared row
constexpr int kMaxK = 64;
constexpr unsigned kFull = 0xffffffffu;

// (d, i) before (td, ti) in the stable sort's order
__device__ __forceinline__ bool before(float d, int i, float td, int ti) {
  return d < td || (d == td && i < ti);
}

// a thread's r-th row of the block and c-th key of a tile: two groups of 4
// consecutive, 64 apart, so that a warp's float4 reads of shared memory are
// broadcasts (rows) and free of bank conflicts (keys)
__device__ __forceinline__ int row_of(int ty, int r) {
  return (r >> 2) * 64 + ty * 4 + (r & 3);
}
__device__ __forceinline__ int col_of(int tx, int c) {
  return (c >> 2) * 64 + tx * 4 + (c & 3);
}

// query q's queue into its sorted list (one thread a query): each entry
// still below the K-th pair moves the greater ones up one slot; the K-th
// pair after it is the next threshold. The queue is emptied.
template <int BM>
__device__ __forceinline__ void merge(int q, int k, int* cnt,
                                      const float* qd, const int* qi,
                                      float* kth_d, int* kth_i, float* ld,
                                      int* li) {
  const int m = min(cnt[q], kCap);
  float kd = kth_d[q];
  int ki = kth_i[q];
  for (int e = 0; e < m; ++e) {
    const float cd = qd[e * BM + q];
    const int ci = qi[e * BM + q];
    if (!before(cd, ci, kd, ki)) continue;
    int p = k - 1;
    for (; p > 0; --p) {
      const float pd = ld[(p - 1) * BM + q];
      const int pi = li[(p - 1) * BM + q];
      if (!before(cd, ci, pd, pi)) break;
      ld[p * BM + q] = pd;
      li[p * BM + q] = pi;
    }
    ld[p * BM + q] = cd;
    li[p * BM + q] = ci;
    kd = ld[(k - 1) * BM + q];
    ki = li[(k - 1) * BM + q];
  }
  cnt[q] = 0;
  kth_d[q] = kd;
  kth_i[q] = ki;
}

template <int MI>
size_t smem_bytes(int k) {
  constexpr int BM = 16 * MI;
  return sizeof(float) *
         ((size_t)kBK * (BM + kPad) + (size_t)kBK * (kBN + kPad) +
          2 * (size_t)kCap * BM + 3 * (size_t)BM + 2 * (size_t)k * BM);
}

// MI rows a thread: 8 (BM = 128 queries a block) or 4 (BM = 64)
template <int MI>
__global__ void __launch_bounds__(kThreads, 2)
    knn_features_kernel(const float* __restrict__ query,
                        const float* __restrict__ keys,
                        const float* __restrict__ qnorm,
                        const float* __restrict__ knorm, int s, int n,
                        int dim, int k, int* __restrict__ out_idx,
                        float* __restrict__ out_d) {
  constexpr int BM = 16 * MI;
  constexpr int LDA = BM + kPad, LDB = kBN + kPad;
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);   // [kBK][LDA] query chunk
  float* Bs = As + kBK * LDA;                     // [kBK][LDB] key chunk
  float* qd = Bs + kBK * LDB;                     // [kCap][BM] queues
  int* qi = reinterpret_cast<int*>(qd + kCap * BM);
  int* cnt = qi + kCap * BM;                      // [BM] queue fill
  float* kth_d = reinterpret_cast<float*>(cnt + BM);  // [BM] K-th pairs
  int* kth_i = reinterpret_cast<int*>(kth_d + BM);
  float* ld = reinterpret_cast<float*>(kth_i + BM);   // [k][BM] lists
  int* li = reinterpret_cast<int*>(ld + (size_t)k * BM);

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.y, q0 = blockIdx.x * BM;
  const float inf = __int_as_float(0x7f800000);
  const float* qb = query + ((size_t)b * s + q0) * dim;
  const float* kb = keys + (size_t)b * n * dim;

  for (int t = tid; t < BM; t += kThreads) {
    cnt[t] = 0;
    kth_d[t] = inf;
    kth_i[t] = INT_MAX;
  }
  for (int t = tid; t < k * BM; t += kThreads) {
    ld[t] = inf;
    li[t] = INT_MAX;
  }
  float qn[MI];
#pragma unroll
  for (int r = 0; r < MI; ++r) {
    const int q = q0 + row_of(ty, r);
    qn[r] = q < s ? qnorm[(size_t)b * s + q] : 0.f;
  }

  for (int base = 0; base < n; base += kBN) {
    float acc[MI][8];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int c0 = 0; c0 < dim; c0 += kBK) {
      __syncthreads();  // the last chunk's reads (first: the lists' init)
      if (base == 0 || dim > kBK) {
#pragma unroll
        for (int r = 0; r < MI / 2; ++r) {
          const int f = tid + kThreads * r, row = f % BM, c4 = f / BM * 4;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (q0 + row < s)
            v = __ldg(reinterpret_cast<const float4*>(
                qb + (size_t)row * dim + c0 + c4));
          As[(c4 + 0) * LDA + row] = v.x;
          As[(c4 + 1) * LDA + row] = v.y;
          As[(c4 + 2) * LDA + row] = v.z;
          As[(c4 + 3) * LDA + row] = v.w;
        }
      }
#pragma unroll
      for (int r = 0; r < kBN * kBK / 4 / kThreads; ++r) {
        const int f = tid + kThreads * r, row = f % kBN, c4 = f / kBN * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (base + row < n)
          v = __ldg(reinterpret_cast<const float4*>(
              kb + (size_t)(base + row) * dim + c0 + c4));
        Bs[(c4 + 0) * LDB + row] = v.x;
        Bs[(c4 + 1) * LDB + row] = v.y;
        Bs[(c4 + 2) * LDB + row] = v.z;
        Bs[(c4 + 3) * LDB + row] = v.w;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < kBK; ++c) {
        float a[MI], x[8];
        const float4 a0 = *reinterpret_cast<const float4*>(As + c * LDA +
                                                           ty * 4);
        a[0] = a0.x;
        a[1] = a0.y;
        a[2] = a0.z;
        a[3] = a0.w;
        if (MI == 8) {
          const float4 a1 = *reinterpret_cast<const float4*>(
              As + c * LDA + 64 + ty * 4);
          a[MI - 4] = a1.x;
          a[MI - 3] = a1.y;
          a[MI - 2] = a1.z;
          a[MI - 1] = a1.w;
        }
        const float4 b0 = *reinterpret_cast<const float4*>(Bs + c * LDB +
                                                           tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(Bs + c * LDB +
                                                           64 + tx * 4);
        x[0] = b0.x;
        x[1] = b0.y;
        x[2] = b0.z;
        x[3] = b0.w;
        x[4] = b1.x;
        x[5] = b1.y;
        x[6] = b1.z;
        x[7] = b1.w;
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = __fmaf_rn(a[i], x[j], acc[i][j]);
      }
    }

    // distances: -2 x is exact, so the fused form rounds once, as
    // feature_distance's two steps do
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = base + col_of(tx, j);
      const float kn = key < n ? knorm[(size_t)b * n + key] : 0.f;
#pragma unroll
      for (int i = 0; i < MI; ++i)
        acc[i][j] = __fadd_rn(__fmaf_rn(-2.f, acc[i][j], qn[i]), kn);
    }

    // queue each pair below its query's K-th; pend: candidates that found
    // their queue full, over: a queue half full
    unsigned long long pend = 0ull;
    bool over = false;
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int row = row_of(ty, i);
      float td = kth_d[row];
      int ti = kth_i[row];
      if (base == 0 && k <= 16) {
        // the first tile, where every key would pass the empty list: the
        // largest of the 16 smallest pairs that the row's 16 threads hold
        // (one each) bounds the K-th pair from above for K <= 16
        float md = inf;
        int mi = INT_MAX;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int key = col_of(tx, j);
          if (key < n && before(acc[i][j], key, md, mi)) {
            md = acc[i][j];
            mi = key;
          }
        }
#pragma unroll
        for (int o = 1; o < 16; o <<= 1) {
          const float od = __shfl_xor_sync(kFull, md, o);
          const int oi = __shfl_xor_sync(kFull, mi, o);
          if (before(md, mi, od, oi)) {
            md = od;
            mi = oi;
          }
        }
        // pairs up to (md, mi) stay candidates
        if (mi != INT_MAX && before(md, mi + 1, td, ti)) {
          td = md;
          ti = mi + 1;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (acc[i][j] <= td) {  // rare after the first tiles
          const int key = base + col_of(tx, j);
          if (key < n && q0 + row < s && before(acc[i][j], key, td, ti)) {
            const int p = atomicAdd(cnt + row, 1);
            if (p < kCap) {
              qd[p * BM + row] = acc[i][j];
              qi[p * BM + row] = key;
            } else {
              pend |= 1ull << (i * 8 + j);
            }
            over |= p >= kCap / 2;
          }
        }
      }
    }

    // merge where a queue is half full or a candidate waits; a waiting
    // candidate is tested again against the K-th pair the merge left
    while (__syncthreads_or(pend != 0ull || over)) {
      if (tid < BM) merge<BM>(tid, k, cnt, qd, qi, kth_d, kth_i, ld, li);
      __syncthreads();
      over = false;
      if (pend != 0ull) {
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const int row = row_of(ty, i);
          const float td = kth_d[row];
          const int ti = kth_i[row];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const unsigned long long bit = 1ull << (i * 8 + j);
            if (pend & bit) {
              pend &= ~bit;
              const int key = base + col_of(tx, j);
              if (before(acc[i][j], key, td, ti)) {
                const int p = atomicAdd(cnt + row, 1);
                if (p < kCap) {
                  qd[p * BM + row] = acc[i][j];
                  qi[p * BM + row] = key;
                } else {
                  pend |= bit;
                }
                over |= p >= kCap / 2;
              }
            }
          }
        }
      }
    }
  }

  // the queues' last candidates; then a query's list is its own thread's
  __syncthreads();
  if (tid < BM) merge<BM>(tid, k, cnt, qd, qi, kth_d, kth_i, ld, li);
  if (tid < BM && q0 + tid < s) {
    const size_t o = ((size_t)b * s + q0 + tid) * k;
    for (int p = 0; p < k; ++p) out_idx[o + p] = li[p * BM + tid];
    if (out_d != nullptr)
      for (int p = 0; p < k; ++p) out_d[o + p] = ld[p * BM + tid];
  }
}

template <int MI>
cudaError_t launch(const float* query, const float* keys, const float* qnorm,
                   const float* knorm, int b, int s, int n, int dim, int k,
                   int* out_idx, float* out_d, cudaStream_t stream) {
  constexpr int BM = 16 * MI;
  // set once, for the largest k: the attribute costs host time a call
  static bool granted = false;
  if (!granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_features_kernel<MI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<MI>(kMaxK));
    if (err != cudaSuccess) return err;
    granted = true;
  }
  const dim3 grid((s + BM - 1) / BM, b);
  knn_features_kernel<MI><<<grid, kThreads, smem_bytes<MI>(k), stream>>>(
      query, keys, qnorm, knorm, s, n, dim, k, out_idx, out_d);
  return cudaGetLastError();
}

}  // namespace

// rows (queries a block) is 128 or 64 (ops/knn.py feature_rows); dim a
// multiple of 32; 1 <= k <= min(64, n). query and keys are read as float4s:
// their data must be 16-byte aligned. out_d may be null.
extern "C" int kdpc_knn_features(const float* query, const float* keys,
                                 const float* qnorm, const float* knorm,
                                 int b, int s, int n, int dim, int k,
                                 int rows, int* out_idx, float* out_d,
                                 cudaStream_t stream) {
  if (b <= 0 || b > 65535 || s <= 0 || n <= 0 || dim <= 0 ||
      dim % kBK != 0 || k < 1 || k > kMaxK || k > n)
    return (int)cudaErrorInvalidValue;
  switch (rows) {
    case 128:
      return (int)launch<8>(query, keys, qnorm, knorm, b, s, n, dim, k,
                            out_idx, out_d, stream);
    case 64:
      return (int)launch<4>(query, keys, qnorm, knorm, b, s, n, dim, k,
                            out_idx, out_d, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
