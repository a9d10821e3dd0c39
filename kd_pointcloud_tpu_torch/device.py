"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device(device), refusing CUDA when no card is present: the
    port never moves work to the CPU on its own. Pass device="cpu" to run
    the plain versions."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain CPU versions")
    return dev


def use_full_fp32() -> None:
    """Run float32 matrix products and convolutions in full float32: no TF32
    on the card (cuBLAS or cuDNN), so the port keeps the JAX package's
    HIGHEST-precision numerics."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
