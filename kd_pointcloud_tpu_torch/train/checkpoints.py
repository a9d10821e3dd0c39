"""Checkpoints: save, load, resume, pick the best; and a reader for the JAX
package's flax msgpack files.

Port of kd_pointcloud_tpu/train/checkpoints.py. A checkpoint is one file,
written with torch.save and read with torch.load(weights_only=True), named
as the JAX package names its checkpoint directories,
``<model_name>_<epoch:03d>_<epe:.4f>``, so parse_epoch_from_name and
best_checkpoint read both. It holds the model's state_dict ("model": the
parameters and the BatchNorm statistics), the optimizer's state_dict
("optimizer": the Adam moments, step counts and learning rate), the epoch,
the best EPE so far, and any extra entries (bridge distillation keeps the
Bridge's and its optimizer's state_dicts there). A bare checkpoint holds
"model" alone; restore_train_state then takes the epoch from the file name
and the best EPE as inf.

load_msgpack_tree reads a flax msgpack file (flax.serialization.to_bytes,
as scripts/evidence_data.py load_msgpack_tree restores it) into nested
dicts of numpy arrays without flax; load_msgpack_checkpoint maps it onto the
port's state_dict through params_from_jax.
"""

from __future__ import annotations

import os
import os.path as osp
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch


def _ckpt_name(model_name: str, epoch: int, epe: float) -> str:
    return f"{model_name}_{epoch:03d}_{epe:.4f}"


def save_checkpoint(ckpt_dir: str, model_name: str, epoch: int, epe: float,
                    tree: Dict[str, Any]) -> str:
    """torch.save(tree) to ckpt_dir/<model_name>_<epoch>_<epe>; returns the
    absolute path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = osp.abspath(osp.join(ckpt_dir, _ckpt_name(model_name, epoch, epe)))
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(tree, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    """The saved tree; tensors only (weights_only=True), on map_location."""
    return torch.load(path, map_location=map_location, weights_only=True)


def load_weights(path: str, preset: str = "teacher"
                 ) -> Dict[str, torch.Tensor]:
    """A model's state_dict from a reference .pth (read as the preset's
    family: fg for fg and bifeat, vote for vote, else teacher), a JAX
    package .msgpack, or a checkpoint of the port, bare or full (by file
    name)."""
    if path.endswith(".pth"):
        from ..models import load_torch_checkpoint

        family = ("fg" if preset in ("fg", "bifeat")
                  else "vote" if preset == "vote" else "teacher")
        return load_torch_checkpoint(path, family=family)
    if path.endswith(".msgpack"):
        return load_msgpack_checkpoint(path)
    return load_checkpoint(path)["model"]


def full_state_tree(model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer], epoch: int,
                    best_epe: float, extra: Optional[Mapping[str, Any]] = None
                    ) -> Dict[str, Any]:
    """The resumable checkpoint: model and optimizer state, epoch and the
    best EPE; each entry of extra is a module or optimizer (its state_dict
    is stored) or a tree of tensors and numbers."""
    tree: Dict[str, Any] = {"model": model.state_dict(), "epoch": int(epoch),
                            "best_epe": float(best_epe)}
    if optimizer is not None:
        tree["optimizer"] = optimizer.state_dict()
    for key, value in (extra or {}).items():
        tree[key] = (value.state_dict() if hasattr(value, "state_dict")
                     else value)
    return tree


def restore_train_state(path: str, model: torch.nn.Module,
                        optimizer: Optional[torch.optim.Optimizer] = None,
                        extra: Optional[Mapping[str, Any]] = None
                        ) -> Tuple[int, float, Dict[str, Any]]:
    """Load a checkpoint into model (and optimizer, and the modules or
    optimizers of extra) in place; only what the file holds is restored.

    Returns (epoch, best_epe, restored): the epoch from the file, else from
    its name; the best EPE from the file, else inf; restored maps each key
    of extra that the file held to its restored object."""
    device = next(model.parameters()).device
    raw = load_checkpoint(path, map_location=device)
    model.load_state_dict(raw["model"])
    if optimizer is not None and "optimizer" in raw:
        optimizer.load_state_dict(raw["optimizer"])
    restored = {}
    for key, target in (extra or {}).items():
        if key in raw:
            target.load_state_dict(raw[key])
            restored[key] = target
    epoch = int(raw.get("epoch", parse_epoch_from_name(path)))
    best_epe = float(raw.get("best_epe", float("inf")))
    return epoch, best_epe, restored


def parse_epoch_from_name(path: str) -> int:
    """The epoch of a checkpoint named <name>_<epoch>_<epe>; 0 otherwise."""
    m = re.search(r"_(\d{3})_[\d.]+$", osp.basename(path.rstrip("/")))
    return int(m.group(1)) if m else 0


def best_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The lowest-EPE checkpoint in a directory, or None."""
    best, best_epe = None, float("inf")
    if not osp.isdir(ckpt_dir):
        return None
    for name in os.listdir(ckpt_dir):
        m = re.search(r"_\d{3}_([\d.]+)$", name)
        if m:
            epe = float(m.group(1))
            if epe < best_epe:
                best, best_epe = osp.join(ckpt_dir, name), epe
    return best


# flax.serialization's msgpack extension codes (_MsgpackExtType)
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


def _ext_hook(code: int, data: bytes):
    import msgpack

    if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
        # (shape, dtype name, C-order bytes)
        shape, dtype, buf = msgpack.unpackb(data, raw=True)
        if dtype == b"bfloat16":
            raise ValueError("bfloat16 arrays are not read (no numpy dtype)")
        arr = np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(
            shape, order="C")
        return arr[()] if code == _EXT_NPSCALAR else arr
    if code == _EXT_COMPLEX:
        real, imag = msgpack.unpackb(data)
        return complex(real, imag)
    return msgpack.ExtType(code, data)


def _unchunk(tree):
    """Undo flax's chunking of arrays above 2**30 bytes, in place."""
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        for key, value in tree.items():
            tree[key] = _unchunk(value)
    return tree


def load_msgpack_tree(path: str) -> Tuple[Dict, Dict]:
    """(params, batch_stats) of a flax msgpack checkpoint, as nested dicts
    of numpy arrays. msgpack is imported here, so only this reader needs
    it."""
    import msgpack

    with open(path, "rb") as fd:
        tree = msgpack.unpackb(fd.read(), ext_hook=_ext_hook, raw=False)
    tree = _unchunk(tree)
    return tree["params"], tree["batch_stats"]


def load_msgpack_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The port's state_dict of a flax msgpack checkpoint of the model."""
    from ..models.jax_bridge import params_from_jax

    params, batch_stats = load_msgpack_tree(path)
    return params_from_jax({"params": params, "batch_stats": batch_stats})
