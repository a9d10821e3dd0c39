"""The fixture network's correlation (reference/nets/corrflow.py) at a
site (B, N1, N2, K, C). Its operations are outside the dense products
that FlopCounterMode counts (an elementwise product and a sum)."""

IN_DENSE_COUNT = False


def work(B, N1, N2, K, C):
    """Per (query, neighbour): C multiplies and C adds; reads both feature
    maps and the indices, writes the (B, N1, K) output."""
    return (B * N1 * K * 2 * C,
            (B * N1 * C + B * N2 * C + B * N1 * K) * 4 + B * N1 * K * 4)
