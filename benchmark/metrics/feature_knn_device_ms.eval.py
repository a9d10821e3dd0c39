"""feature_knn_device_ms.eval (ms): device time, a pair, of the kernels
launched inside the program's knn_features spans (ops/knn.py: the
feature-space kNN in plain torch, its matrix product, sums, topk and sort)
in the traced stretch of an eval cell: each launch call that starts in
such a span on the span's thread, its kernel matched by args.correlation.
Layer: kernels. Moves eval_pairs_per_s."""

from benchmark.spans import feature_knn_device_ms as read  # noqa: F401
