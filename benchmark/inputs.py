"""Seeded inputs: scene pairs from a traffic mix's parameters, and model
weights, both made on the device in a few large calls.

A seed gives the same tensors on every run on one device. Each use of the
seed (weights of the teacher, of the student, the pairs, the sample that
is checked) draws from a generator of its own, so that one use does not
shift another's numbers.
"""

from __future__ import annotations

import math

import torch

_STREAMS = {"pairs": 1, "teacher": 2, "student": 3, "model": 4, "sample": 5}


def generator(seed: int, stream: str, device) -> torch.Generator:
    """A torch.Generator on device for one use of the seed (any whole
    number below 2**61)."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * 8 + _STREAMS[stream]) % (2 ** 64))
    return g


def scene_pairs(scene: dict, count: int, points: int, seed: int, device):
    """count pairs of points-point clouds shaped like the KITTI eval
    inputs, as (count, points, 3) tensors pos1, pos2, flow: pos1 uniform in
    the box [box_lo, box_hi] (metres, camera axes), pos2 pos1 turned about
    the vertical axis by up to yaw radians, moved by up to shift metres an
    axis and jittered by Gaussian noise of noise metres; flow = pos2 - pos1
    row by row."""
    g = generator(seed, "pairs", device)
    f32 = dict(dtype=torch.float32, device=device)
    lo = torch.tensor(scene["box_lo"], **f32)
    hi = torch.tensor(scene["box_hi"], **f32)
    pos1 = lo + (hi - lo) * torch.rand(count, points, 3, generator=g, **f32)
    yaw = (2 * torch.rand(count, generator=g, **f32) - 1) * scene["yaw"]
    shift = (2 * torch.rand(count, 1, 3, generator=g, **f32) - 1) \
        * scene["shift"]
    noise = torch.randn(count, points, 3, generator=g, **f32) \
        * scene["noise"]
    c, s, z, o = torch.cos(yaw), torch.sin(yaw), torch.zeros_like(yaw), \
        torch.ones_like(yaw)
    rot = torch.stack([torch.stack([c, z, s], -1), torch.stack([z, o, z], -1),
                       torch.stack([-s, z, c], -1)], -2)    # (count, 3, 3)
    pos2 = (pos1[..., None, :] * rot[:, None]).sum(-1) + shift + noise
    return dict(pos1=pos1, pos2=pos2, flow=pos2 - pos1)


def batch_of(pairs: dict, rows) -> dict:
    """A model batch of the given pair rows: positions, the same positions
    as the colour inputs (as the data pipeline feeds them), and the flow."""
    p1, p2 = pairs["pos1"][rows].contiguous(), pairs["pos2"][rows].contiguous()
    return dict(pos1=p1, pos2=p2, norm1=p1, norm2=p2,
                flow=pairs["flow"][rows].contiguous())


def seeded_weights(model: torch.nn.Module, seed: int, stream: str,
                   device) -> dict:
    """A state dict for model's names and shapes: every 2-D weight and its
    bias U(+-1/sqrt(fan_in)) (torch's default for Linear and Conv), drawn as
    one uniform tensor and cut into leaves; BatchNorm's scale 1 and shift 0,
    its running statistics 0 and 1."""
    state = model.state_dict()
    fans = {}
    for name, t in state.items():
        if name.endswith("weight") and t.dim() == 2:
            fans[name[:-len("weight")]] = t.shape[1]
    draws = [n for n in state if n.rsplit(".", 1)[0] + "." in fans
             and n.rsplit(".", 1)[1] in ("weight", "bias")]
    total = sum(state[n].numel() for n in draws)
    u = torch.rand(total, generator=generator(seed, stream, device),
                   dtype=torch.float32, device=device)
    out, at = {}, 0
    for name, t in state.items():
        if name in draws:
            bound = 1.0 / math.sqrt(fans[name.rsplit(".", 1)[0] + "."])
            n = t.numel()
            out[name] = (u[at:at + n] * (2 * bound) - bound).view(t.shape)
            at += n
        elif name.endswith("running_var") or name.endswith("bn.weight"):
            out[name] = torch.ones(t.shape, dtype=t.dtype, device=device)
        else:
            out[name] = torch.zeros(t.shape, dtype=t.dtype, device=device)
    return out
