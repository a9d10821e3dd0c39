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
// not saved: leaky' needs only the sign of a pre-activation. The TPU kernel
// read the gathered rows and handed d_g (B, K, N, C) to XLA's gather VJP;
// here the kernels gather u themselves, so d_u is a scatter-add over idx.
// Plain version: ops/pool_fused.py pool_plain under torch.autograd;
// pool_bwd_masked there is this file's arithmetic in torch.
//
// What bounds it on an H100: operations. The forward's p must be recomputed
// densely, 2 K C^2 flops a query. d_p is nonzero only in the max mask, one
// neighbour a (query, output channel) outside exact ties, so d_h0 = d_p w
// and d_w += d_p^T h0 take about 2 C^2 each, not 2 K C^2. Two kernels:
//
// 1. pool_bwd_mask_kernel: a block owns a panel of CO = min(C, 64) output
//    channels and a range of queries of one cloud. It stages its panel of w
//    (transposed, C x CO: 64 kB at C = 256) once, then walks the range QT =
//    256 / CO queries at a time: it gathers h0 for QT x 32 neighbour slots
//    into shared memory (slots >= K are zero and masked), recomputes p as a
//    register-tiled product -- a warp is one query x 32 output channels, a
//    thread 4 slots x 8 channels, reading h0 and w as float4s, i the outer
//    loop, so every p keeps the forward's fmaf order -- and forms the max
//    mask with warp shuffles over the 8 threads that hold a query's 32
//    slots (at C = 16 a warp is one query x 16 channels, a thread 4 slots
//    x 4 channels, so a pass is still 8 queries). Per (query, output
//    channel) it writes the mask's slot bits, the bits of those whose p < 0
//    (leaky' = 0.1) and the cotangent's share ct / count, K times smaller
//    than a dense d_p; the panel-0 blocks also write the sign bits of h0's
//    pre-activation. Then, still in the block, d_w and d_bias take d_p x
//    h0 at the masked slots only, into registers (a thread owns CO / 8
//    output channels x C / 32 input channels of its panel; at C = 32 one
//    output channel x all 32 inputs, for its warp's query; at C = 16 one
//    output channel x 8 inputs, a half-warp taking each half of the
//    inputs) for the whole range, and leave it with one atomicAdd an
//    entry (at C <= 32 after the 8 warps' partials are summed in the
//    block). The gather reads a pass's neighbour indices first, so its
//    float4 loads of u and v are independent and many are in flight:
//    with one block an SM at C = 256, a gather that waits on each index
//    in turn takes longer than the product.
// 2. pool_bwd_kernel: a thread owns one input channel i of a query (of
//    two at C = 256) and walks the output channels o in ascending order,
//    adding for each masked slot s d_p[s, o] w[o, i] into its own column of
//    d_h0 in shared memory (K floats; w from shared memory up to C = 128,
//    through L1 at C = 256, where 256 kB does not fit: there each w[o, i]
//    read serves the thread's two queries, and 8 rows are loaded at once).
//    Then d_g = d_h0 leaky'(pre-activation
//    from the sign bits), d_v its sum over the slots in slot order, and
//    d_u an atomicAdd a (slot, channel): rows of u are shared by many
//    queries. The mask is split across panel blocks at C = 256, which is
//    why d_h0 waits for this second launch.
//
// Both grids are one wave (cudaOccupancyMaxActiveBlocksPerMultiprocessor x
// the SMs): each block walks many passes, and no block waits for a second
// round while the rest of the card idles.
//
// Cross-block sums (d_u, d_w, d_bias) are float atomicAdd into buffers the
// wrapper zeroes, so their order of summation changes from run to run: the
// results agree with the plain version to float32 rounding of sums taken
// in another order, not bit for bit. d_v is summed in a fixed order (o
// ascending into d_h0, then s ascending), so it has the same bits with or
// without d_u.
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
constexpr unsigned kFull = 0xffffffffu;
constexpr int kOU = 8;  // rows of w the second kernel loads at once

__device__ __forceinline__ float leaky(float x) {
  return x >= 0.f ? x : 0.1f * x;
}

// words of h0's pre-activation sign bits a (query, slot): 32 channels a
// word, one word (16 bits used) at C = 16
__host__ __device__ constexpr int sign_words(int c) { return (c + 31) / 32; }

template <int C>
struct MaskShape {
  static constexpr int kCO = C < 64 ? C : 64;    // output channels a block
  static constexpr int kPanels = C / kCO;
  static constexpr int kTC = C < 32 ? 4 : 8;     // output channels a thread
  static constexpr int kWC = 4 * kTC;            // output channels a warp
  static constexpr int kWarpsQ = kCO / kWC;      // warps a query
  static constexpr int kTQ = kThreads / 32 / kWarpsQ;  // queries a pass
  static constexpr int kHS = C + 4;              // padded h0 row
  static constexpr int kOW = kCO / 8;            // d_w rows a warp (C > 32)
  static constexpr int kIL = C / 32;             // d_w columns a lane (C > 32)
  static constexpr int kLW = C / 4 < 8 ? C / 4 : 8;  // lanes a sign word
  static constexpr int kSmemFloats =
      kTQ * kSlots * kHS + C * kCO + 3 * kTQ * kCO + kTQ * kSlots;
  static_assert(kTQ * kWarpsQ * 32 == kThreads, "a warp a query panel");
};

template <int C>
__global__ void __launch_bounds__(kThreads, C <= 128 ? 2 : 1)
    pool_bwd_mask_kernel(const float* __restrict__ u,
                         const int* __restrict__ idx,
                         const float* __restrict__ v,
                         const float* __restrict__ w,
                         const float* __restrict__ bias,
                         const float* __restrict__ ct, int n1, int n2, int k,
                         int qpb, uint2* __restrict__ sel,
                         float* __restrict__ share,
                         unsigned* __restrict__ hsign, float* __restrict__ d_w,
                         float* __restrict__ d_bias) {
  using S = MaskShape<C>;
  constexpr int CO = S::kCO, TQ = S::kTQ, HS = S::kHS, TC = S::kTC;
  constexpr int HW = sign_words(C);
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);  // [TQ * 32][HS]: h0
  float* wt = hs + TQ * kSlots * HS;             // [C][CO]: w[o0 + oo][i]
  unsigned* mk = reinterpret_cast<unsigned*>(wt + C * CO);  // [TQ][CO]
  unsigned* ng = mk + TQ * CO;                               // [TQ][CO]
  float* sh = reinterpret_cast<float*>(ng + TQ * CO);        // [TQ][CO]
  int* ids = reinterpret_cast<int*>(sh + TQ * CO);           // [TQ * 32]
  constexpr int C4 = C / 4;

  const int b = blockIdx.z;
  const int o0 = blockIdx.y * CO;
  const float* ub = u + (size_t)b * n2 * C;
  const int* ib = idx + (size_t)b * n1 * k;
  const float* vb = v + (size_t)b * n1 * C;
  const float* cb = ct + (size_t)b * n1 * C;
  const size_t qb = (size_t)b * n1;  // this cloud's first query overall

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the product's thread: query qw of the pass, slots sg + 8 t (t < 4),
  // output channels ob + TC cg .. ob + TC cg + TC - 1 of the panel; rows 8
  // apart and a row stride of C + 4 floats put the 8 sg's float4 reads of
  // h0 in 8 different 16-byte bank groups
  const int qw = warp / S::kWarpsQ, ob = warp % S::kWarpsQ * S::kWC;
  const int sg = lane >> 2, cg = lane & 3;

  for (int e = threadIdx.x; e < C * CO; e += kThreads) {
    const int i = e % C, oo = e / C;  // coalesced reads of w's rows
    wt[i * CO + oo] = w[(size_t)(o0 + oo) * C + i];
  }
  float bo[TC];
#pragma unroll
  for (int c = 0; c < TC; ++c) bo[c] = bias[o0 + ob + cg * TC + c];

  // d_w's partial: at C <= 32 a lane owns output channel lane % C and
  // C / kSplit inputs from part * C / kSplit, for its warp's query (the
  // warps' partials are summed at the end); wider, a warp owns kOW output
  // channels, a lane inputs lane + 32 c
  constexpr bool kByRow = C <= 32;
  constexpr int kSplit = kByRow ? 32 / C : 1;   // lanes an output channel
  constexpr int kRows = kByRow ? 1 : S::kOW;
  constexpr int kCols = kByRow ? C / kSplit : S::kIL;
  const int part = kByRow ? lane / C : 0;
  float dw[kRows][kCols], db[kRows];
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    db[a] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dw[a][c] = 0.f;
  }

  const int q_end = min(n1, (blockIdx.x + 1) * qpb);
  for (int q0 = blockIdx.x * qpb; q0 < q_end; q0 += TQ) {
    // 1. h0 for TQ queries x 32 slots (zero in empty slots): the rows'
    //    indices first, then float4 loads of u and v that do not wait on
    //    each other; the sign bits of the pre-activation for the second
    //    kernel (a lane holds 4 channels, 8 lanes a word of 32)
    __syncthreads();  // hs, ids and the mask of the previous pass are free
    for (int r = threadIdx.x; r < TQ * kSlots; r += kThreads) {
      const int n = q0 + r / kSlots, kn = r % kSlots;
      ids[r] = n < q_end && kn < k ? ib[(size_t)n * k + kn] : -1;
    }
    __syncthreads();
#pragma unroll 4
    for (int e = threadIdx.x; e < TQ * kSlots * C4; e += kThreads) {
      const int i4 = e % C4, r = e / C4;
      const int n = q0 + r / kSlots, j = ids[r];
      float4 pre = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j >= 0) {
        const float4 a =
            *reinterpret_cast<const float4*>(ub + (size_t)j * C + 4 * i4);
        const float4 c =
            *reinterpret_cast<const float4*>(vb + (size_t)n * C + 4 * i4);
        pre = make_float4(__fadd_rn(a.x, c.x), __fadd_rn(a.y, c.y),
                          __fadd_rn(a.z, c.z), __fadd_rn(a.w, c.w));
      }
      *reinterpret_cast<float4*>(hs + r * HS + 4 * i4) =
          make_float4(leaky(pre.x), leaky(pre.y), leaky(pre.z),
                      leaky(pre.w));
      // kLW lanes hold a word's channels (kThreads is a multiple of C4,
      // so lane % C4 == i4)
      unsigned word = ((pre.x >= 0.f ? 1u : 0u) | (pre.y >= 0.f ? 2u : 0u) |
                       (pre.z >= 0.f ? 4u : 0u) | (pre.w >= 0.f ? 8u : 0u))
                      << (4 * (lane % S::kLW));
#pragma unroll
      for (int x = 1; x < S::kLW; x <<= 1)
        word |= __shfl_xor_sync(kFull, word, x);
      if (blockIdx.y == 0 && lane % S::kLW == 0 && n < q_end)
        hsign[((qb + n) * kSlots + r % kSlots) * HW + i4 / 8] = word;
    }
    __syncthreads();

    // 2. p = leaky(h0 . w[o] + bias[o]) in the forward's operation order,
    //    then the max mask over the query's slots and the share
    {
      float acc[4][TC];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int c = 0; c < TC; ++c) acc[t][c] = 0.f;
      const float* hrow = hs + (qw * kSlots + sg) * HS;
      const float* wcol = wt + ob + cg * TC;
#pragma unroll 2
      for (int i = 0; i < C; i += 4) {
        float4 h[4];
#pragma unroll
        for (int t = 0; t < 4; ++t)
          h[t] = *reinterpret_cast<const float4*>(hrow + 8 * t * HS + i);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          float wv[TC];
#pragma unroll
          for (int f = 0; f < TC / 4; ++f) {
            const float4 wf =
                *reinterpret_cast<const float4*>(wcol + (i + ii) * CO + 4 * f);
            wv[4 * f] = wf.x;
            wv[4 * f + 1] = wf.y;
            wv[4 * f + 2] = wf.z;
            wv[4 * f + 3] = wf.w;
          }
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const float hv = ii == 0 ? h[t].x : ii == 1 ? h[t].y
                             : ii == 2 ? h[t].z : h[t].w;
#pragma unroll
            for (int c = 0; c < TC; ++c)
              acc[t][c] = fmaf(hv, wv[c], acc[t][c]);
          }
        }
      }
      const int n = q0 + qw;
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        float val[4];
        bool neg[4];
        float m = -__int_as_float(0x7f800000);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float pre = __fadd_rn(acc[t][c], bo[c]);
          val[t] = leaky(pre);
          neg[t] = !(pre >= 0.f);
          if (sg + 8 * t < k) m = fmaxf(m, val[t]);
        }
#pragma unroll
        for (int x = 4; x < 32; x <<= 1)
          m = fmaxf(m, __shfl_xor_sync(kFull, m, x));
        unsigned hit = 0u, nb = 0u;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (sg + 8 * t < k && val[t] == m) {
            hit |= 1u << (sg + 8 * t);
            if (neg[t]) nb |= 1u << (sg + 8 * t);
          }
        }
#pragma unroll
        for (int x = 4; x < 32; x <<= 1) {
          hit |= __shfl_xor_sync(kFull, hit, x);
          nb |= __shfl_xor_sync(kFull, nb, x);
        }
        if (sg == c) {  // one thread of the 8 writes channel c
          const int oo = ob + cg * TC + c;
          unsigned h = 0u, g = 0u;
          float s = 0.f;
          if (n < q_end) {
            h = hit;
            g = nb;
            s = cb[(size_t)n * C + o0 + oo] / (float)__popc(hit);
            const size_t at = (qb + n) * C + o0 + oo;
            sel[at] = make_uint2(h, g);
            share[at] = s;
          }
          mk[qw * CO + oo] = h;
          ng[qw * CO + oo] = g;
          sh[qw * CO + oo] = s;
        }
      }
    }

    // 3. d_w += d_p^T h0 and d_bias += d_p at the masked slots
    if constexpr (kByRow) {
      if (!d_w) continue;
      __syncthreads();
      const int q = warp, oo = lane % C;  // CO = C, TQ = 8 queries = warps
      const unsigned m = mk[q * CO + oo], nm = ng[q * CO + oo];
      const float s = sh[q * CO + oo];
      for (unsigned bits = m; bits; bits &= bits - 1) {
        const int slot = __ffs(bits) - 1;
        const float g = (nm >> slot) & 1u ? s * 0.1f : s;
        db[0] += g;
        const float* hr = hs + (q * kSlots + slot) * HS + part * kCols;
#pragma unroll
        for (int i4 = 0; i4 < kCols / 4; ++i4) {
          const float4 h = *reinterpret_cast<const float4*>(hr + 4 * i4);
          dw[0][4 * i4] = fmaf(g, h.x, dw[0][4 * i4]);
          dw[0][4 * i4 + 1] = fmaf(g, h.y, dw[0][4 * i4 + 1]);
          dw[0][4 * i4 + 2] = fmaf(g, h.z, dw[0][4 * i4 + 2]);
          dw[0][4 * i4 + 3] = fmaf(g, h.w, dw[0][4 * i4 + 3]);
        }
      }
    } else {
      if (!d_w) continue;
      __syncthreads();
      for (int q = 0; q < TQ; ++q) {
#pragma unroll
        for (int a = 0; a < kRows; ++a) {
          const int oo = warp * kRows + a;
          const unsigned m = mk[q * CO + oo], nm = ng[q * CO + oo];
          const float s = sh[q * CO + oo];
          for (unsigned bits = m; bits; bits &= bits - 1) {
            const int slot = __ffs(bits) - 1;
            const float g = (nm >> slot) & 1u ? s * 0.1f : s;
            db[a] += g;
            const float* hr = hs + (q * kSlots + slot) * HS + lane;
#pragma unroll
            for (int c = 0; c < kCols; ++c)
              dw[a][c] = fmaf(g, hr[32 * c], dw[a][c]);
          }
        }
      }
    }
  }
  if (!d_w) return;
  if constexpr (kByRow) {
    // the 8 warps' partials summed through shared memory (hs is free),
    // then one atomicAdd an entry of the block's panel
    __syncthreads();
    float* red = hs;                      // [warp][i][C + 1]: padded rows
    float* red_b = hs + 8 * C * (C + 1);  // [warp][o]
    const int oo = lane % C;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      red[(warp * C + part * kCols + c) * (C + 1) + oo] = dw[0][c];
    if (part == 0) red_b[warp * C + oo] = db[0];
    __syncthreads();
    for (int e = threadIdx.x; e < C * C; e += kThreads) {
      const int i = e % C, o = e / C;
      float sum = 0.f;
      for (int w8 = 0; w8 < 8; ++w8) sum += red[(w8 * C + i) * (C + 1) + o];
      atomicAdd(d_w + (size_t)(o0 + o) * C + i, sum);
    }
    if (threadIdx.x < C && d_bias) {
      float sum = 0.f;
      for (int w8 = 0; w8 < 8; ++w8) sum += red_b[w8 * C + threadIdx.x];
      atomicAdd(d_bias + o0 + threadIdx.x, sum);
    }
  } else {
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      const int o = o0 + warp * kRows + a;
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        atomicAdd(d_w + (size_t)o * C + lane + 32 * c, dw[a][c]);
      if (lane == 0 && d_bias) atomicAdd(d_bias + o, db[a]);
    }
  }
}

template <int C>
struct GradShape {
  static constexpr int kQR = C == 256 ? 2 : 1;       // queries a thread
  static constexpr int kTQ = kThreads / C * kQR;     // queries a pass
  static constexpr bool kWShared = C <= 128;
  static constexpr int kQWords = kSlots * sign_words(C);  // sign words a query
  static constexpr int kSmemFloats = (kWShared ? C * C : 0) +
                                     kTQ * kSlots * C + 3 * kTQ * C +
                                     kTQ * kQWords;
};

// d_h0 from the mask, then d_g, d_v and d_u: a thread owns one input
// channel of kQR queries, their columns of d_h0 in shared memory; each
// w[o, i] it reads serves all kQR.
template <int C>
__global__ void __launch_bounds__(kThreads)
    pool_bwd_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                    const uint2* __restrict__ sel,
                    const float* __restrict__ share,
                    const unsigned* __restrict__ hsign, int n1, int n2, int k,
                    int qpb, float* __restrict__ d_u,
                    float* __restrict__ d_v) {
  using S = GradShape<C>;
  constexpr int TQ = S::kTQ, QR = S::kQR;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);          // [C][C]: w[o][i]
  float* dh = ws + (S::kWShared ? C * C : 0);           // [TQ][32][C]
  unsigned* mk = reinterpret_cast<unsigned*>(dh + TQ * kSlots * C);
  unsigned* ng = mk + TQ * C;                           // [TQ][C]
  float* sh = reinterpret_cast<float*>(ng + TQ * C);    // [TQ][C]
  unsigned* sg = reinterpret_cast<unsigned*>(sh + TQ * C);  // [TQ][kQWords]
  constexpr int HW = sign_words(C), QW = S::kQWords;

  const int b = blockIdx.z;
  const size_t qb = (size_t)b * n1;
  const int* ib = idx + qb * k;
  // this thread's queries of a pass: qg * QR .. qg * QR + QR - 1
  const int i = threadIdx.x % C, qg = threadIdx.x / C;
  if (S::kWShared) {
    for (int e = threadIdx.x; e < C * C; e += kThreads) ws[e] = w[e];
  }
  const float* wsrc = S::kWShared ? ws : w;

  const int q_end = min(n1, (blockIdx.x + 1) * qpb);
  for (int q0 = blockIdx.x * qpb; q0 < q_end; q0 += TQ) {
    __syncthreads();  // the mask of the previous pass is no longer read
    // TQ * C entries of the mask, then TQ * QW words of sign bits
    for (int e = threadIdx.x; e < TQ * C; e += kThreads) {
      const int n = q0 + e / C;
      uint2 m = make_uint2(0u, 0u);
      float s = 0.f;
      if (n < q_end) {
        m = sel[(qb + n) * C + e % C];
        s = share[(qb + n) * C + e % C];
      }
      mk[e] = m.x;
      ng[e] = m.y;
      sh[e] = s;
    }
    for (int e = threadIdx.x; e < TQ * QW; e += kThreads) {
      const int n = q0 + e / QW;
      sg[e] = n < q_end ? hsign[(qb + n) * QW + e % QW] : 0u;
    }
#pragma unroll
    for (int r = 0; r < QR; ++r)
#pragma unroll
      for (int s = 0; s < kSlots; ++s)
        dh[((qg * QR + r) * kSlots + s) * C + i] = 0.f;
    __syncthreads();

    for (int o0 = 0; o0 < C; o0 += kOU) {
      float wv[kOU];  // loads issued together, not one per o in turn
#pragma unroll
      for (int u = 0; u < kOU; ++u) wv[u] = wsrc[(o0 + u) * C + i];
#pragma unroll
      for (int u = 0; u < kOU; ++u) {
        const int o = o0 + u;
#pragma unroll
        for (int r = 0; r < QR; ++r) {
          const int q = qg * QR + r;
          const unsigned m = mk[q * C + o];
          const unsigned nm = ng[q * C + o];
          const float s = sh[q * C + o];
          float* col = dh + q * kSlots * C + i;
          for (unsigned bits = m; bits; bits &= bits - 1) {
            const int slot = __ffs(bits) - 1;
            const float g = (nm >> slot) & 1u ? s * 0.1f : s;
            col[slot * C] = fmaf(g, wv[u], col[slot * C]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < QR; ++r) {
      const int q = qg * QR + r, n = q0 + q;
      if (n >= q_end) continue;
      const float* col = dh + q * kSlots * C + i;
      const unsigned* bits = sg + q * QW;
      float dv = 0.f;
      for (int s = 0; s < k; ++s) {
        const bool pos = (bits[s * HW + i / 32] >> (i % 32)) & 1u;
        // __fmul_rn: a product the compiler may not fuse into dv's sum, so
        // d_v has the same bits whether or not d_u is wanted
        const float g = __fmul_rn(col[s * C], pos ? 1.f : 0.1f);
        dv += g;
        if (d_u) {
          const int j = ib[(size_t)n * k + s];
          atomicAdd(d_u + ((size_t)b * n2 + j) * C + i, g);
        }
      }
      if (d_v) d_v[(qb + n) * C + i] = dv;
    }
  }
}

// Queries a block so that the grid is one wave: every block resident at
// once, none waiting for a second round (blocks run many passes each).
template <typename Kernel>
int passes_a_block(Kernel kernel, size_t smem, int passes, int blocks_per) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                smem);
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int slots = (per_sm < 1 ? 1 : per_sm) * (sms < 1 ? 1 : sms);
  const int per = (passes * blocks_per + slots - 1) / slots;
  return per < 1 ? 1 : per;
}

template <int C>
cudaError_t launch(const float* u, const int* idx, const float* v,
                   const float* w, const float* bias, const float* ct, int b,
                   int n1, int n2, int k, float* d_u, float* d_v, float* d_w,
                   float* d_bias, uint2* sel, float* share, unsigned* hsign,
                   cudaStream_t stream) {
  using M = MaskShape<C>;
  const size_t smem = sizeof(float) * M::kSmemFloats;
  cudaError_t err = cudaFuncSetAttribute(
      pool_bwd_mask_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int passes = (n1 + M::kTQ - 1) / M::kTQ;
  const int qpb = M::kTQ * passes_a_block(pool_bwd_mask_kernel<C>, smem,
                                          passes, M::kPanels * b);
  const dim3 grid((n1 + qpb - 1) / qpb, M::kPanels, b);
  pool_bwd_mask_kernel<C><<<grid, kThreads, smem, stream>>>(
      u, idx, v, w, bias, ct, n1, n2, k, qpb, sel, share, hsign, d_w,
      d_bias);
  err = cudaGetLastError();
  if (err != cudaSuccess || (!d_u && !d_v)) return err;

  using G = GradShape<C>;
  const size_t smem_g = sizeof(float) * G::kSmemFloats;
  err = cudaFuncSetAttribute(pool_bwd_kernel<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_g);
  if (err != cudaSuccess) return err;
  const int passes_g = (n1 + G::kTQ - 1) / G::kTQ;
  const int qpb_g = G::kTQ * passes_a_block(pool_bwd_kernel<C>, smem_g,
                                            passes_g, b);
  const dim3 grid_g((n1 + qpb_g - 1) / qpb_g, 1, b);
  pool_bwd_kernel<C><<<grid_g, kThreads, smem_g, stream>>>(
      idx, w, sel, share, hsign, n1, n2, k, qpb_g, d_u, d_v);
  return cudaGetLastError();
}

}  // namespace

// d_u, d_w and d_bias must hold zeros; sel (2 * B * N1 * C ints), share
// (B * N1 * C floats) and hsign (B * N1 * max(C, 32) ints) are scratch.
// d_u, d_v, or d_w with d_bias may be null (not wanted); d_bias needs d_w.
// With d_u and d_v both null the second kernel does not run.
extern "C" int kdpc_pool_bwd(const float* u, const int* idx, const float* v,
                             const float* w, const float* bias,
                             const float* ct, int b, int n1, int n2, int k,
                             int c, float* d_u, float* d_v, float* d_w,
                             float* d_bias, unsigned* sel, float* share,
                             unsigned* hsign, cudaStream_t stream) {
  if (b <= 0 || n1 <= 0 || n2 <= 0 || k <= 0 || k > kSlots)
    return (int)cudaErrorInvalidValue;
  if ((d_bias && !d_w) || !sel || !share || !hsign)
    return (int)cudaErrorInvalidValue;
  uint2* sel2 = reinterpret_cast<uint2*>(sel);
  switch (c) {
    case 16:
      return (int)launch<16>(u, idx, v, w, bias, ct, b, n1, n2, k, d_u, d_v,
                             d_w, d_bias, sel2, share, hsign, stream);
    case 32:
      return (int)launch<32>(u, idx, v, w, bias, ct, b, n1, n2, k, d_u, d_v,
                             d_w, d_bias, sel2, share, hsign, stream);
    case 64:
      return (int)launch<64>(u, idx, v, w, bias, ct, b, n1, n2, k, d_u, d_v,
                             d_w, d_bias, sel2, share, hsign, stream);
    case 128:
      return (int)launch<128>(u, idx, v, w, bias, ct, b, n1, n2, k, d_u, d_v,
                              d_w, d_bias, sel2, share, hsign, stream);
    case 256:
      return (int)launch<256>(u, idx, v, w, bias, ct, b, n1, n2, k, d_u, d_v,
                              d_w, d_bias, sel2, share, hsign, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
