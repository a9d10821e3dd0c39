"""Furthest-point sampling (ops/fps.py -> csrc/fps.cu) at a site (B, N, m):
m of N points a cloud. Its operations are outside the dense products that
FlopCounterMode counts."""

IN_DENSE_COUNT = False


def work(B, N, m):
    """Per point and round: 3 sub, 3 mul, 2 add, 1 min, 1 compare."""
    return B * (m - 1) * N * 10, B * N * 12 + B * m * 4
