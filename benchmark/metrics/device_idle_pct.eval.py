"""device_idle_pct.eval (%): the share of the traced stretch of an eval cell in
which no kernel, copy or set ran on the device.
Layer: device. Moves eval_pairs_per_s."""

from benchmark.readers import idle_pct as read  # noqa: F401
