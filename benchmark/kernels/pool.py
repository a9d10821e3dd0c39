"""The cost-volume pool's forward (ops/pool_fused.py -> csrc/pool_fused.cu)
at a site (B, N1, N2, K, C): N1 queries, K of N2 rows each, C channels.
Its C x C products are among the dense ones that FlopCounterMode counts
(the reference forms them as a matrix product)."""

IN_DENSE_COUNT = True


def work(B, N1, N2, K, C):
    """Per (query, neighbour): C add + C leaky, C x C multiply-add, C bias,
    C leaky, C max; reads u, v, idx, weight, bias, writes the output."""
    return (B * N1 * K * (2 * C * C + 5 * C),
            (B * N2 * C + 2 * B * N1 * C + C * C + C + B * N1 * K) * 4)
