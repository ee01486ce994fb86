"""16-bit RGB PNG reading for the DSEC flow files (JAX: utils/png16.py,
read side only; the port's own copy).

Color type 2, bit depth 8 or 16, all five scanline filters; no PIL (PIL
narrows 16-bit RGB on read).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


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
