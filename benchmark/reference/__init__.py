"""The benchmark's plain PyTorch reference: the scene-flow networks
(nets/<net>.py, one a file, found by a model entry's "reference"), their
KD losses and Adam. It imports torch alone, and nothing of the measured
program, so that the program is judged against an independent copy."""
