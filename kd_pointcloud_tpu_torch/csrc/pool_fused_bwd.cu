// Cost-volume pool, backward: the gradient of csrc/pool_fused.cu's
//
//   out[b, n, o] = max_k leaky(p[b, n, k, o]),
//   p[b, n, k, o] = sum_i h0[b, n, k, i] * w[o, i] + bias[o],
//   h0[b, n, k, i] = leaky(u[b, idx[b, n, k], i] + v[b, n, i]),
//
// with the cotangent ct (B, N1, C): for each (b, n, o) the max mask
// eq_k = [leaky(p_k) == out] splits ct evenly among tied maxima (as the
// VJP of jnp.max and torch.amax do), then
//
//   d_p  = eq / count * ct * leaky'(p)      leaky'(x) = x >= 0 ? 1 : 0.1
//   d_h0 = d_p @ w,  d_g = d_h0 * leaky'(u[idx] + v)
//   d_v[b, n]        = sum_k d_g[b, n, k]
//   d_u[b, idx[..]] += d_g[b, n, k]           (scatter-add)
//   d_w             += d_p^T h0,  d_bias += sum d_p.
//
// Replaces the TPU kernel kd_pointcloud_tpu/ops/pallas/pool_fused.py
// _pool_bwd_pallas (_bwd_kernel). Like it, the activations are recomputed,
// not saved: leaky' needs only the sign of a pre-activation, which leaky
// keeps. The TPU kernel read the gathered rows and handed d_g (B, K, N, C)
// to XLA's gather VJP; here the kernel gathers u itself, so d_u is a
// scatter-add over idx. Plain version: ops/pool_fused.py pool_plain under
// torch.autograd.
//
// What bounds it on an H100: operations. The forward's p must be recomputed
// densely, 2 K C^2 flops a query; d_p is nonzero only in the max mask, one
// neighbour a (query, output channel) outside exact ties, so d_h0 = d_p w
// and d_w += d_p^T h0 need about 2 C^2 each. Against (2K + 4C) * 4 bytes a
// query, in fp32 on the CUDA cores: about 2.0 GFLOP, 0.03 ms, at K = 32,
// C = 32, B x N1 = 3 x 8192. Two kernels, one launch sequence:
//
// 1. pool_bwd_kernel: a block walks a tile of queries, TQ = 256 / C at a
//    time, each in KP = 32 neighbour slots (K <= 32; slots >= K are
//    masked). It gathers h0 into shared memory, then for each panel of CO =
//    min(C, 128) output channels (one panel up to C = 128, two at 256: the
//    whole 256 kB of w would not fit the 227 kB a block may use) it stages
//    the panel of w, recomputes p, forms the max mask and d_p per (query,
//    output channel) -- the mask of channel o needs only channel o's p over
//    the K neighbours -- and adds d_p @ w_panel into d_h0, which each
//    thread holds in registers for one (query, input channel) over the 32
//    slots. d_v is then a register sum; d_u takes atomicAdd (rows of u are
//    shared by many queries). The mask leaves for d_w a (B, N1, C) scratch:
//    per (query, output channel) the bits of its masked slots, the bits of
//    those whose p < 0 (leaky' = 0.1), and the cotangent's share ct / count
//    -- K times smaller than a dense d_p.
// 2. pool_bwd_dw_kernel: d_w = d_p^T h0 and d_bias = sums of d_p, only at
//    the masked slots: a block owns a tile of d_w (at most 64 x 64) and a
//    range of queries, stages their h0 by gathering u, adds share * leaky'
//    * h0[masked slot] per (query, output channel) in registers, and adds
//    its partial into d_w / d_bias with atomicAdd.
//
// Cross-block sums (d_u, d_w, d_bias) are float atomicAdd into buffers the
// wrapper zeroes, so their order of summation changes from run to run: the
// results agree with the plain version to float32 rounding of sums taken
// in another order, not bit for bit. d_v is summed in a fixed order.
//
// Ties: the mask compares, with ==, values recomputed exactly as the
// forward computed them: h0 by __fadd_rn then leaky, p by one fmaf chain
// from 0 over i = 0 .. C-1 in order, then + bias (the forward's `acc + bo`
// has no product to fuse with, so both are one rounded add), then leaky;
// fmaxf over k gives the forward's output. So a tie in the forward is a
// tie here. No wgmma or TMA yet.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 32;          // neighbour slots a query (K <= 32)
constexpr int kTargetBlocks = 264;  // two waves of blocks on 132 SMs

__device__ __forceinline__ float leaky(float x) {
  return x >= 0.f ? x : 0.1f * x;
}

__device__ __forceinline__ float leaky_grad(float x) {
  return x >= 0.f ? 1.f : 0.1f;
}

template <int C>
struct Shape {
  static constexpr int kTQ = kThreads / C;          // queries a pass
  static constexpr int kRows = kTQ * kSlots;        // (query, slot) rows
  static constexpr int kCO = C < 128 ? C : 128;     // output channels a panel
  static constexpr int kPanels = C / kCO;
  static constexpr int kWS = kCO + 1;               // padded: no bank conflicts
  static constexpr int kGroups = kThreads / kCO;    // row groups in step 2
  static constexpr int kRowsPT = kRows / kGroups;   // rows a thread in step 2
  static constexpr int kSmemFloats = C * kWS + kRows * C + kRows * kCO;
};

template <int C>
__global__ void __launch_bounds__(kThreads)
    pool_bwd_kernel(const float* __restrict__ u, const int* __restrict__ idx,
                    const float* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ bias,
                    const float* __restrict__ ct, int n1, int n2, int k,
                    int qpb, float* __restrict__ d_u, float* __restrict__ d_v,
                    uint2* __restrict__ sel, float* __restrict__ share_out) {
  using S = Shape<C>;
  constexpr int TQ = S::kTQ, CO = S::kCO, WS = S::kWS;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [C][WS]: w[o0 + oo][i]
  float* hs = ws + C * WS;                       // [kRows][C]: h0
  float* ps = hs + S::kRows * C;                 // [kRows][CO]: p, then d_p

  const int b = blockIdx.z;
  const float* ub = u + (size_t)b * n2 * C;
  const int* ib = idx + (size_t)b * n1 * k;
  const float* vb = v + (size_t)b * n1 * C;
  const float* cb = ct + (size_t)b * n1 * C;

  // step 2's thread: one output channel of the panel, a group of rows
  const int oo2 = threadIdx.x % CO, g2 = threadIdx.x / CO;
  // step 4's thread: one input channel of one query, all its slots
  const int i4 = threadIdx.x % C, q4 = threadIdx.x / C;

  const int q_end = min(n1, (blockIdx.x + 1) * qpb);
  for (int q0 = blockIdx.x * qpb; q0 < q_end; q0 += TQ) {
    // 1. h0 for TQ queries x 32 slots (zero in empty slots)
    __syncthreads();  // hs and ps of the previous pass are no longer read
    for (int e = threadIdx.x; e < S::kRows * C; e += kThreads) {
      const int i = e % C, r = e / C;
      const int n = q0 + r / kSlots, kn = r % kSlots;
      float h = 0.f;
      if (n < q_end && kn < k) {
        const int j = ib[(size_t)n * k + kn];
        h = leaky(__fadd_rn(ub[(size_t)j * C + i], vb[(size_t)n * C + i]));
      }
      hs[e] = h;
    }

    float dh[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) dh[s] = 0.f;

    for (int panel = 0; panel < S::kPanels; ++panel) {
      const int o0 = panel * CO;
      if (panel > 0 || S::kPanels > 1) __syncthreads();  // ws, ps free
      if (S::kPanels > 1 || q0 == blockIdx.x * qpb) {
        for (int e = threadIdx.x; e < C * CO; e += kThreads) {
          const int i = e % C, oo = e / C;  // coalesced reads of w's rows
          ws[i * WS + oo] = w[(size_t)(o0 + oo) * C + i];
        }
      }
      __syncthreads();

      // 2. p = leaky(h0 . w[o] + bias[o]), the forward's operation order
      {
        const float bo = bias[o0 + oo2];
        float acc[S::kRowsPT];
#pragma unroll
        for (int j = 0; j < S::kRowsPT; ++j) acc[j] = 0.f;
#pragma unroll 2
        for (int i = 0; i < C; i += 4) {
          const float w0 = ws[i * WS + oo2], w1 = ws[(i + 1) * WS + oo2];
          const float w2 = ws[(i + 2) * WS + oo2];
          const float w3 = ws[(i + 3) * WS + oo2];
#pragma unroll
          for (int j = 0; j < S::kRowsPT; ++j) {
            const int r = g2 + j * S::kGroups;
            const float4 h = *reinterpret_cast<const float4*>(hs + r * C + i);
            acc[j] = fmaf(h.x, w0, acc[j]);
            acc[j] = fmaf(h.y, w1, acc[j]);
            acc[j] = fmaf(h.z, w2, acc[j]);
            acc[j] = fmaf(h.w, w3, acc[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < S::kRowsPT; ++j) {
          const int r = g2 + j * S::kGroups;
          ps[r * CO + oo2] = __fadd_rn(acc[j], bo);  // pre-activation
        }
      }
      __syncthreads();

      // 3. max mask and d_p, one (query, output channel) a thread
      for (int e = threadIdx.x; e < TQ * CO; e += kThreads) {
        const int oo = e % CO, q = e / CO;
        const int n = q0 + q;
        float* pq = ps + q * kSlots * CO + oo;
        if (n < q_end) {
          float m = -__int_as_float(0x7f800000);
          for (int s = 0; s < k; ++s) m = fmaxf(m, leaky(pq[s * CO]));
          float cnt = 0.f;
          for (int s = 0; s < k; ++s) cnt += leaky(pq[s * CO]) == m ? 1.f : 0.f;
          const float share = cb[(size_t)n * C + o0 + oo] / cnt;
          unsigned hit = 0u, neg = 0u;
          for (int s = 0; s < kSlots; ++s) {
            float g = 0.f;
            if (s < k) {
              const float pre = pq[s * CO];
              if (leaky(pre) == m) {
                g = share * leaky_grad(pre);
                hit |= 1u << s;
                if (!(pre >= 0.f)) neg |= 1u << s;
              }
            }
            pq[s * CO] = g;
          }
          if (sel) {
            const size_t at = (size_t)(b * n1 + n) * C + o0 + oo;
            sel[at] = make_uint2(hit, neg);
            share_out[at] = share;
          }
        } else {
          for (int s = 0; s < kSlots; ++s) pq[s * CO] = 0.f;
        }
      }
      __syncthreads();

      // 4a. d_h0 += d_p @ w_panel, one (query, input channel) a thread
      {
        const float* pq = ps + q4 * kSlots * CO;
        const float* wi = ws + i4 * WS;
#pragma unroll 2
        for (int oo = 0; oo < CO; oo += 4) {
          const float w0 = wi[oo], w1 = wi[oo + 1];
          const float w2 = wi[oo + 2], w3 = wi[oo + 3];
#pragma unroll
          for (int s = 0; s < kSlots; ++s) {
            const float4 g =
                *reinterpret_cast<const float4*>(pq + s * CO + oo);
            dh[s] = fmaf(g.x, w0, dh[s]);
            dh[s] = fmaf(g.y, w1, dh[s]);
            dh[s] = fmaf(g.z, w2, dh[s]);
            dh[s] = fmaf(g.w, w3, dh[s]);
          }
        }
      }
    }

    // 4b. d_g = d_h0 * leaky'(pre-activation of h0); d_v; scatter into d_u
    const int n = q0 + q4;
    if (n < q_end) {
      float dv = 0.f;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {  // static indices keep dh in registers
        if (s >= k) break;
        // __fmul_rn: a product the compiler may not fuse into dv's sum, so
        // d_v has the same bits whether or not d_u is wanted
        const float g =
            __fmul_rn(dh[s], leaky_grad(hs[(q4 * kSlots + s) * C + i4]));
        dv += g;
        if (d_u) {
          const int j = ib[(size_t)n * k + s];
          atomicAdd(d_u + ((size_t)b * n2 + j) * C + i4, g);
        }
      }
      if (d_v) d_v[((size_t)b * n1 + n) * C + i4] = dv;
    }
  }
}

// d_w[o, i] += sum_q sum_(s masked for (q, o)) d_p[q, s, o] h0[q, s, i] and
// d_bias[o] += the same d_p, over the queries q of one range, with d_p =
// share * leaky' rebuilt from the mask. A block owns a T x T tile of d_w;
// a thread owns PT x PT entries of it, o = o0 + ty + 16 a and i = i0 + tx +
// 16 c, so a warp reads a row of h0 without bank conflicts.
template <int C>
__global__ void __launch_bounds__(kThreads)
    pool_bwd_dw_kernel(const float* __restrict__ u, const int* __restrict__ idx,
                       const float* __restrict__ v,
                       const uint2* __restrict__ sel,
                       const float* __restrict__ share, int n1, int n2, int k,
                       int queries, int qpb, float* __restrict__ d_w,
                       float* __restrict__ d_bias) {
  constexpr int T = C < 64 ? C : 64;
  constexpr int PT = T / 16;
  constexpr int RQ = kThreads / T;  // queries staged a step: 32 kB of h0
  __shared__ __align__(16) float hs[RQ][kSlots][T];  // h0, tile's columns i
  __shared__ uint2 ms[RQ][T];                        // masks, tile's o
  __shared__ float ss[RQ][T];                        // shares, tile's o

  const int tiles = C / T;
  const int o0 = (blockIdx.y / tiles) * T, i0 = (blockIdx.y % tiles) * T;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[PT][PT], db[PT];
#pragma unroll
  for (int a = 0; a < PT; ++a) {
    db[a] = 0.f;
#pragma unroll
    for (int c = 0; c < PT; ++c) acc[a][c] = 0.f;
  }
  const bool bias_tile = i0 == 0 && tx == 0;

  const int q_begin = blockIdx.x * qpb;
  const int q_end = min(queries, q_begin + qpb);
  for (int q0 = q_begin; q0 < q_end; q0 += RQ) {
    __syncthreads();
    for (int e = threadIdx.x; e < RQ * kSlots * T; e += kThreads) {
      const int c = e % T, s = (e / T) % kSlots, rq = e / (T * kSlots);
      const int q = q0 + rq;  // b * n1 + n
      float h = 0.f;
      if (q < q_end && s < k) {
        const int j = idx[(size_t)q * k + s];
        h = leaky(__fadd_rn(u[((size_t)(q / n1) * n2 + j) * C + i0 + c],
                            v[(size_t)q * C + i0 + c]));
      }
      hs[rq][s][c] = h;
    }
    for (int e = threadIdx.x; e < RQ * T; e += kThreads) {
      const int c = e % T, rq = e / T;
      const int q = q0 + rq;
      uint2 m = make_uint2(0u, 0u);
      float sh = 0.f;
      if (q < q_end) {
        m = sel[(size_t)q * C + o0 + c];
        sh = share[(size_t)q * C + o0 + c];
      }
      ms[rq][c] = m;
      ss[rq][c] = sh;
    }
    __syncthreads();
    for (int rq = 0; rq < RQ; ++rq) {
#pragma unroll
      for (int a = 0; a < PT; ++a) {
        const uint2 m = ms[rq][ty + 16 * a];
        const float sh = ss[rq][ty + 16 * a];
        for (unsigned bits = m.x; bits; bits &= bits - 1) {
          const int s = __ffs(bits) - 1;
          const float g = (m.y >> s) & 1u ? sh * 0.1f : sh;  // kernel 1's d_p
          if (bias_tile) db[a] += g;
#pragma unroll
          for (int c = 0; c < PT; ++c)
            acc[a][c] = fmaf(g, hs[rq][s][tx + 16 * c], acc[a][c]);
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < PT; ++a) {
    const int o = o0 + ty + 16 * a;
#pragma unroll
    for (int c = 0; c < PT; ++c)
      atomicAdd(d_w + (size_t)o * C + i0 + tx + 16 * c, acc[a][c]);
    if (bias_tile && d_bias) atomicAdd(d_bias + o, db[a]);
  }
}

template <int C>
cudaError_t launch(const float* u, const int* idx, const float* v,
                   const float* w, const float* bias, const float* ct, int b,
                   int n1, int n2, int k, float* d_u, float* d_v, float* d_w,
                   float* d_bias, uint2* sel, float* share,
                   cudaStream_t stream) {
  using S = Shape<C>;
  const size_t smem = sizeof(float) * S::kSmemFloats;
  cudaError_t err = cudaFuncSetAttribute(
      pool_bwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int passes = (n1 + S::kTQ - 1) / S::kTQ;
  int per = (passes * b + kTargetBlocks - 1) / kTargetBlocks;
  per = per < 1 ? 1 : per;
  const int qpb = per * S::kTQ;
  const dim3 grid((n1 + qpb - 1) / qpb, 1, b);
  pool_bwd_kernel<C><<<grid, kThreads, smem, stream>>>(
      u, idx, v, w, bias, ct, n1, n2, k, qpb, d_u, d_v, sel, share);
  err = cudaGetLastError();
  if (err != cudaSuccess || (!d_w && !d_bias)) return err;

  constexpr int T = C < 64 ? C : 64;
  constexpr int RQ = kThreads / T;
  const int tiles = (C / T) * (C / T);
  const int queries = b * n1;
  int blocks = 2 * kTargetBlocks / tiles;
  blocks = blocks < 1 ? 1 : blocks;
  int qpb_w = (queries + blocks - 1) / blocks;
  qpb_w = (qpb_w + RQ - 1) / RQ * RQ;
  const dim3 grid_w((queries + qpb_w - 1) / qpb_w, tiles);
  pool_bwd_dw_kernel<C><<<grid_w, kThreads, 0, stream>>>(
      u, idx, v, sel, share, n1, n2, k, queries, qpb_w, d_w, d_bias);
  return cudaGetLastError();
}

}  // namespace

// d_u, d_w and d_bias must hold zeros; sel (2 * B * N1 * C ints) and share
// (B * N1 * C floats) are scratch. d_u or d_v may be null (not wanted); with
// d_w and d_bias both null, sel and share may be null too and the second
// kernel does not run.
extern "C" int kdpc_pool_bwd(const float* u, const int* idx, const float* v,
                             const float* w, const float* bias,
                             const float* ct, int b, int n1, int n2, int k,
                             int c, float* d_u, float* d_v, float* d_w,
                             float* d_bias, unsigned* sel, float* share,
                             cudaStream_t stream) {
  if (b <= 0 || n1 <= 0 || n2 <= 0 || k <= 0 || k > kSlots)
    return (int)cudaErrorInvalidValue;
  if ((d_w || d_bias) && (!d_w || !sel || !share))
    return (int)cudaErrorInvalidValue;
  uint2* sel2 = reinterpret_cast<uint2*>(sel);
  switch (c) {
    case 32:
      return (int)launch<32>(u, idx, v, w, bias, ct, b, n1, n2, k, d_u, d_v,
                             d_w, d_bias, sel2, share, stream);
    case 64:
      return (int)launch<64>(u, idx, v, w, bias, ct, b, n1, n2, k, d_u, d_v,
                             d_w, d_bias, sel2, share, stream);
    case 128:
      return (int)launch<128>(u, idx, v, w, bias, ct, b, n1, n2, k, d_u, d_v,
                              d_w, d_bias, sel2, share, stream);
    case 256:
      return (int)launch<256>(u, idx, v, w, bias, ct, b, n1, n2, k, d_u, d_v,
                              d_w, d_bias, sel2, share, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
