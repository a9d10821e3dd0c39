"""host_sync_ms.train (ms): host time, a pair, inside the program's sync
spans (names ending in .sync: ops/knn.py smallest_k's wait for its tie
flag, one a 2048-query chunk of the feature kNN) in the traced stretch of
a KD cell. The count of such spans is the count of syncs.
Layer: host dispatch. Moves train_pairs_per_s."""

from benchmark.spans import host_sync_ms as read  # noqa: F401
