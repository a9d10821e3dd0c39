"""Analytic data-parallel cost model for H100 meshes.

Port of kd_pointcloud_tpu/parallel/cost_model.py, with its formulas and the
TPU's interconnect constants replaced by the H100's. The collective cost is
computed from first principles, as the public scaling playbooks do: the
bytes of a ring all-reduce over the interconnect's bandwidth.

Model (plain ring all-reduce over the data mesh):

    T_allreduce = 2 * (n-1)/n * grad_bytes / W_ring
    W_ring      = ring_links * one-way bandwidth a link

Constant: NVIDIA's published NVLink 4 figure for the H100 SXM5, 900 GB/s a
GPU in both directions together, so 450 GB/s each way (through the NVSwitch
fabric of an HGX board a GPU's ring neighbour gets all of it: one link of
450 GB/s). It is the data sheet's figure, not a measurement; NCCL reaches
less of it.

The per-card step time (per_chip_step_ms) is an argument, to be filled with
a measurement on the card (the benchmark's benchmark/entries/train.py
measures a train step).
"""

from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM5 data sheet: NVLink 4, 900 GB/s a GPU, both directions
H100_NVLINK_ONEWAY_BW = 4.5e11   # bytes/s a GPU, each way
H100_RING_LINKS = 1              # a ring neighbour over the NVSwitch fabric


def allreduce_ms(grad_bytes: float, n_devices: int,
                 link_bw: float = H100_NVLINK_ONEWAY_BW,
                 ring_links: int = H100_RING_LINKS) -> float:
    """Ring all-reduce wall time (ms): each card moves 2*(n-1)/n of the
    buffer through its ring bandwidth (reduce-scatter + all-gather)."""
    if n_devices <= 1:
        return 0.0
    w_ring = ring_links * link_bw
    return 2.0 * (n_devices - 1) / n_devices * grad_bytes / w_ring * 1e3


def dp_step_model(n_devices: int, param_bytes: float,
                  per_chip_step_ms: float) -> Dict[str, float]:
    """Expected data-parallel step time and scaling efficiency on n cards,
    given the measured single-card step wall.

    Returns both bounds: `overlapped` assumes the gradient all-reduce
    overlaps the backward, `serial` assumes no overlap (the port's steps
    all-reduce the gradients once, after the backward: serial). Real steps
    land between them."""
    ar = allreduce_ms(param_bytes, n_devices)
    serial = per_chip_step_ms + ar
    overlapped = max(per_chip_step_ms, ar)
    return {
        "n_devices": n_devices,
        "grad_mbytes": param_bytes / 1e6,
        "allreduce_ms": ar,
        "per_chip_step_ms": per_chip_step_ms,
        "expected_step_ms_overlapped": overlapped,
        "expected_step_ms_serial": serial,
        "scaling_efficiency_overlapped": per_chip_step_ms / overlapped,
        "scaling_efficiency_serial": per_chip_step_ms / serial,
    }


def param_bytes_of(module) -> int:
    """Gradient buffer size of a module's parameters (or an iterable of
    tensors), in bytes of their dtype (float32: 4)."""
    params = module.parameters() if hasattr(module, "parameters") else module
    return sum(p.numel() * p.element_size() for p in params)
