"""The 3-D kNN (ops/knn.py -> csrc/knn.cu) at a site (B, S, N, k): S
queries against N keys a cloud, k neighbours each. Its operations are
outside the dense products that FlopCounterMode counts."""

IN_DENSE_COUNT = False


def work(B, S, N, k):
    """Per (query, key) pair: 3 mul + 2 add (q.k), 1 mul, 1 sub, 1 add,
    1 compare; reads queries and keys, writes k indices and distances."""
    return B * S * N * 9, (B * S + B * N) * 12 + B * S * k * 8
