"""PointPWC's patch-to-patch cost volume (the program's nn/experimental.py
PointConvFlow, plain PyTorch, timed by its model.cost_volume span) at a
site (B, N1, N2, K, D, C): N1 first-cloud points, each with its K nearest
of N2 second-cloud points and then its K nearest of its own cloud, D
feature channels a cloud, MLP widths (C, C). Its MLP and WeightNet
products are among the dense ones that FlopCounterMode counts; the two
kNN searches inside the span are counted here too, as the span times
them (and under "knn" as well, where work.py adds them to a model's
count)."""

IN_DENSE_COUNT = True


def work(B, N1, N2, K, D, C):
    """The two kNN searches (9 per (query, key) pair, kernels/knn.py);
    per (query, neighbour) both directions (3 sub each), the MLP over
    [f1, f2, dxyz] (2 D + 3 -> C -> C: multiply-add, bias, leaky), two
    WeightNets 3 -> 8 -> 8 -> C (multiply-add, bias, ReLU) and two weighted
    sums (multiply and add, C each). Reads both clouds' points and
    features and the weights, writes the (B, N1, C) cost."""
    dims = (2 * D + 3, C, C)
    mlp = sum(2 * a * b + 2 * b for a, b in zip(dims, dims[1:]))
    wn = sum(2 * a * b + 2 * b for a, b in zip((3, 8, 8), (8, 8, C)))
    params = (sum(a * b + b for a, b in zip(dims, dims[1:]))
              + 2 * (3 * 8 + 8 + 8 * 8 + 8 + 8 * C + C))
    return (9 * B * N1 * (N2 + N1) + B * N1 * K * (6 + mlp + 2 * wn + 4 * C),
            (B * (N1 + N2) * (3 + D) + params + B * N1 * C) * 4)
