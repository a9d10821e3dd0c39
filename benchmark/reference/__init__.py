"""The benchmark's plain PyTorch reference: the scene-flow network, its
KD losses and Adam. It imports torch alone, and nothing of the measured
program, so that the program is judged against an independent copy."""
