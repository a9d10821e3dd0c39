"""mfu.eval (%): the frozen operations a pair (work.py cell_work) times the
untraced window's pairs a second, by the host's clock, over the H100's
float32 peak without tensor cores (the program runs with TF32 off).
Layer: model step. Moves eval_pairs_per_s."""

from benchmark.readers import mfu as read  # noqa: F401
