"""device_idle_pct.train (%): the share of the traced stretch of a KD cell in
which no kernel, copy or set ran on the device.
Layer: device. Moves train_pairs_per_s."""

from benchmark.readers import idle_pct as read  # noqa: F401
