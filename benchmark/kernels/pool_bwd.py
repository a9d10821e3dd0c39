"""The cost-volume pool's backward (ops/pool_fused.py ->
csrc/pool_fused_bwd.cu) at a site (B, N1, N2, K, C) of a pool whose
weights take a gradient. It counts what the gradient needs (the max
mask's entries, one a query and output channel), not a recompute of the
forward. Among the dense count: a forward with a backward counts its
differentiable products three times (work.py model_flops)."""

IN_DENSE_COUNT = True


def work(B, N1, N2, K, C):
    """Per (query, neighbour) d_g = d_h0 leaky', d_v and d_u (3 C); per
    mask entry, one a (query, output channel), d_h0 += d_p w and d_w +=
    d_p h0 (2 C each) and d_bias (1). Reads u, idx, v, weight, bias and the
    cotangent, writes d_u, d_v, d_weight, d_bias."""
    return (B * N1 * K * 3 * C + B * N1 * C * (4 * C + 1),
            (2 * B * N2 * C + B * N1 * K + 3 * B * N1 * C + 2 * C * C
             + 2 * C) * 4)
