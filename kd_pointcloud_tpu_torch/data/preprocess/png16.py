"""Minimal pure-numpy PNG codec for 8- and 16-bit images.

The port's copy of kd_pointcloud_tpu/data/preprocess/png16.py. KITTI
Scene Flow encodes disparity (grayscale x256) and flow ((u, v) x64 + 2^15,
valid plane) as 16-bit PNGs, which PIL cannot read as RGB; FT3D's
occlusion masks are 8-bit PNGs. This decodes and encodes non-interlaced
8/16-bit grayscale, grayscale + alpha, RGB and RGBA PNGs (zlib and the
five standard row filters); ``decodable`` tells a caller whether a file
is one of them.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def decodable(path: str) -> bool:
    """Whether read_png16 decodes this file (read from its IHDR): 8 or 16
    bits, a colortype without a palette, not interlaced."""
    with open(path, "rb") as f:
        data = f.read(33)
    if data[:8] != _SIGNATURE or data[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG")
    _, _, bitdepth, colortype, _, _, interlace = struct.unpack(
        ">IIBBBBB", data[16:29])
    return bitdepth in (8, 16) and colortype in _CHANNELS and not interlace


def read_png16(path: str) -> np.ndarray:
    """Decode a PNG into (H, W) or (H, W, C) uint8/uint16."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG")

    pos = 8
    idat = b""
    width = height = bitdepth = colortype = None
    while pos < len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        chunk = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            width, height, bitdepth, colortype, _, _, interlace = \
                struct.unpack(">IIBBBBB", chunk)
            if interlace:
                raise ValueError("interlaced PNG unsupported")
        elif ctype == b"IDAT":
            idat += chunk
        elif ctype == b"IEND":
            break
    if bitdepth not in (8, 16):
        raise ValueError(f"bitdepth {bitdepth} unsupported")
    if colortype not in _CHANNELS:
        raise ValueError(f"colortype {colortype} (palette) unsupported")
    channels = _CHANNELS[colortype]
    raw = zlib.decompress(idat)

    bpp = channels * bitdepth // 8            # bytes per pixel
    stride = width * bpp
    img = np.empty((height, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    off = 0
    for row in range(height):
        filt = raw[off]
        line = np.frombuffer(raw, np.uint8, stride, off + 1).copy()
        off += 1 + stride
        if filt == 0:
            cur = line
        elif filt == 1:      # Sub: a byte adds the one bpp before it
            cur = (np.cumsum(line.reshape(width, bpp), axis=0,
                             dtype=np.int64) & 0xFF).astype(
                                 np.uint8).reshape(stride)
        elif filt == 2:      # Up
            cur = (line + prev) & 0xFF
        elif filt == 3:      # Average
            cur = line
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                cur[i] = (int(cur[i]) + ((int(a) + int(prev[i])) >> 1)
                          ) & 0xFF
        elif filt == 4:      # Paeth
            cur = line
            for i in range(stride):
                a = int(cur[i - bpp]) if i >= bpp else 0
                b = int(prev[i])
                c = int(prev[i - bpp]) if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[i] = (int(cur[i]) + pred) & 0xFF
        else:
            raise ValueError(f"unknown filter {filt}")
        img[row] = cur
        prev = cur

    if bitdepth == 16:
        arr = img.reshape(height, width, channels, 2)
        out = (arr[..., 0].astype(np.uint16) << 8) | arr[..., 1]
    else:
        out = img.reshape(height, width, channels)
    return out[..., 0] if channels == 1 else out


def write_png16(path: str, arr: np.ndarray):
    """Encode (H, W[, C]) uint16 (or uint8) as a PNG, filter 0."""
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    colortype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    bitdepth = 16 if arr.dtype == np.uint16 else 8

    if bitdepth == 16:
        hi = (arr >> 8).astype(np.uint8)
        lo = (arr & 0xFF).astype(np.uint8)
        rows = np.stack([hi, lo], axis=-1).reshape(h, w * c * 2)
    else:
        rows = arr.reshape(h, w * c).astype(np.uint8)

    raw = b"".join(b"\x00" + rows[i].tobytes() for i in range(h))

    def chunk(ctype: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + ctype + payload
                + struct.pack(">I", zlib.crc32(ctype + payload)))

    ihdr = struct.pack(">IIBBBBB", w, h, bitdepth, colortype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw)))
        f.write(chunk(b"IEND", b""))
