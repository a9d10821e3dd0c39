"""Raw-format readers for the offline preprocessors.

The port's copy of kd_pointcloud_tpu/data/preprocess/io.py (the
reference's data_preprocess/IO.py + python_pfm.py): PFM (SceneFlow
disparity), .flo (Middlebury flow) and PNG. Where the JAX package reads
every PNG through PIL, this reads 8- and 16-bit grayscale and RGB PNGs (and
their alpha forms) with the bundled png16 codec, which decodes what PIL
writes, and imports PIL only for the formats the codec lacks (palette,
1/2/4-bit, interlaced PNGs, JPEG, PPM, PGM), raising a clear error where
PIL is not installed. Each PNG comes back as PIL gives it: PIL keeps 16
bits for grayscale only, so a 16-bit color image comes back as its 8-bit
reduction.
"""

from __future__ import annotations

import re

import numpy as np

from . import png16


def read_pfm(path: str):
    """Returns (data, scale); rows flipped to top-down like the reference
    (data_preprocess/IO.py:33-66)."""
    with open(path, "rb") as f:
        header = f.readline().rstrip().decode("ascii")
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError(f"{path}: not a PFM file")
        dims = f.readline().decode("ascii")
        m = re.match(r"^(\d+)\s(\d+)\s$", dims)
        if not m:
            raise ValueError(f"{path}: malformed PFM header")
        width, height = map(int, m.groups())
        scale = float(f.readline().decode("ascii").rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape)), abs(scale)


def write_pfm(path: str, image: np.ndarray, scale: float = 1.0):
    if image.dtype != np.float32:
        raise ValueError("PFM images must be float32")
    color = image.ndim == 3 and image.shape[2] == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode("ascii"))
        endian = image.dtype.byteorder
        if endian == "<" or (endian == "=" and np.little_endian):
            scale = -scale
        f.write(f"{scale}\n".encode("ascii"))
        np.flipud(image).tofile(f)


def read_flo(path: str) -> np.ndarray:
    """Middlebury .flo: 'PIEH' magic, int32 w/h, float32 HxWx2
    (data_preprocess/IO.py:99-114)."""
    with open(path, "rb") as f:
        if f.read(4).decode("utf-8") != "PIEH":
            raise ValueError(f"{path}: missing PIEH header")
        width = int(np.fromfile(f, np.int32, 1)[0])
        height = int(np.fromfile(f, np.int32, 1)[0])
        flow = np.fromfile(f, np.float32, width * height * 2)
    return flow.reshape(height, width, 2)


def write_flo(path: str, flow: np.ndarray):
    with open(path, "wb") as f:
        f.write(b"PIEH")
        np.array([flow.shape[1], flow.shape[0]], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)


def _read_with_pil(path: str) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            f"{path}: this image format needs Pillow, which is not "
            f"installed (8- and 16-bit grayscale and RGB PNGs need "
            f"nothing)") from e
    with Image.open(path) as img:
        return np.asarray(img)


def _as_pil_reads(img: np.ndarray) -> np.ndarray:
    """The codec's array as PIL gives it: PIL has 16 bits for grayscale
    only, so a 16-bit image with more channels keeps each sample's high
    byte, and 16-bit grayscale + alpha becomes RGBA (L, L, L, A)."""
    if img.dtype != np.uint16 or img.ndim == 2:
        return img
    img = (img >> 8).astype(np.uint8)
    return img[..., [0, 0, 0, 1]] if img.shape[-1] == 2 else img


def read_image(path: str) -> np.ndarray:
    if path.endswith((".pfm", ".PFM")):
        data, _ = read_pfm(path)
        return data[..., :3] if data.ndim == 3 else data
    if path.endswith((".png", ".PNG")) and png16.decodable(path):
        return _as_pil_reads(png16.read_png16(path))
    return _read_with_pil(path)


def read_uint16_png(path: str) -> np.ndarray:
    """16-bit PNG (KITTI encodes disparity x256 and flow x64 + 2^15 in
    these; the reference read them with pypng, kitti_utils.py:30-38)."""
    return png16.read_png16(path).astype(np.uint16)


def read(path: str):
    """Extension-dispatched reader (data_preprocess/IO.py:13-21)."""
    if path.endswith(".flo"):
        return read_flo(path)
    if path.endswith(".pfm"):
        return read_pfm(path)[0]
    if path.endswith((".png", ".jpg", ".ppm", ".pgm")):
        return read_image(path)
    raise ValueError(f"don't know how to read {path}")
