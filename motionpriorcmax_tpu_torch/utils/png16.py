"""RGB PNG codec: the DSEC flow files (16-bit; JAX: utils/png16.py, the
port's own copy) and the training image panels (8-bit).

Writes color type 2 at bit depth 16 or 8 with filter 0 and zlib level 6
(the 16-bit files the same bytes as the JAX writer); reads color type 2 at
bit depth 8 or 16 with all five scanline filters.  No PIL: it cannot
encode 16-bit RGB and narrows it on read, and the machines the port runs
on need not have it.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def _write_png_rgb(path: Path, arr: np.ndarray, dtype: str) -> None:
    """Write [H, W, 3] of `dtype` ('uint8' / 'uint16') as an RGB PNG of that
    bit depth, filter type 0."""
    if arr.dtype != np.dtype(dtype) or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] {dtype}, got {arr.dtype} "
                         f"{arr.shape}")
    h, w, _ = arr.shape
    nbytes = arr.dtype.itemsize

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8 * nbytes, 2, 0, 0, 0)
    # Each scanline: filter byte 0, then the row's big-endian samples.
    rows = np.zeros((h, 1 + w * 3 * nbytes), np.uint8)
    rows[:, 1:] = arr.astype(f">u{nbytes}").view(np.uint8).reshape(
        h, w * 3 * nbytes)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
           + chunk(b"IEND", b""))
    Path(path).write_bytes(png)


def write_png16_rgb(path: Path, arr: np.ndarray) -> None:
    """Write [H, W, 3] uint16 as a 16-bit RGB PNG (filter type 0)."""
    _write_png_rgb(path, arr, "uint16")


def write_png8_rgb(path: Path, arr: np.ndarray) -> None:
    """Write [H, W, 3] uint8 as an 8-bit RGB PNG (filter type 0)."""
    _write_png_rgb(path, arr, "uint8")


def read_png_rgb(path: Path) -> np.ndarray:
    """Read an RGB PNG (bit depth 8 or 16, color type 2) -> [H, W, 3] uint8/16."""
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos = 8
    width = height = bit_depth = color_type = None
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            width, height, bit_depth, color_type, comp, filt, interlace = \
                struct.unpack(">IIBBBBB", payload)
            if color_type != 2 or bit_depth not in (8, 16) or interlace:
                raise ValueError(
                    f"{path}: only non-interlaced RGB PNGs of bit depth 8 "
                    f"or 16 are read (color type {color_type}, depth "
                    f"{bit_depth}, interlace {interlace})")
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    raw = zlib.decompress(idat)

    bpp = 3 * (bit_depth // 8)          # bytes per pixel
    stride = width * bpp
    out = np.zeros((height, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    off = 0
    for row in range(height):
        ftype = raw[off]
        line = np.frombuffer(raw[off + 1:off + 1 + stride], dtype=np.uint8).copy()
        off += 1 + stride
        if ftype == 0:
            cur = line
        elif ftype == 2:  # Up
            cur = (line + prev).astype(np.uint8)
        elif ftype in (1, 3, 4):  # Sub / Average / Paeth need sequential scan
            cur = _defilter_sequential(ftype, line, prev, bpp)
        else:
            raise ValueError(f"bad filter type {ftype}")
        out[row] = cur
        prev = cur

    if bit_depth == 16:
        img = out.reshape(height, width, 3, 2)
        return (img[..., 0].astype(np.uint16) << 8) | img[..., 1].astype(np.uint16)
    return out.reshape(height, width, 3)


def _defilter_sequential(ftype: int, line: np.ndarray, prev: np.ndarray,
                         bpp: int) -> np.ndarray:
    cur = np.zeros_like(line)
    n = len(line)
    li = line.astype(np.int32)
    pr = prev.astype(np.int32)
    cu = np.zeros(n, dtype=np.int32)
    for i in range(n):
        a = cu[i - bpp] if i >= bpp else 0
        b = pr[i]
        if ftype == 1:
            val = li[i] + a
        elif ftype == 3:
            val = li[i] + ((a + b) >> 1)
        else:  # Paeth
            c = pr[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            val = li[i] + pred
        cu[i] = val & 0xFF
    cur[:] = cu.astype(np.uint8)
    return cur
