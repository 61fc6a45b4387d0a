"""Minimal 16-bit PNG encoder (greyscale + RGB).

Pillow (imageio's default PNG backend) cannot write 16-bit RGB PNGs;
the reference relies on imageio for its 16-bit outputs
(reference core/file_writer.py:103-104).  This encoder writes PNG
directly: big-endian 16-bit samples, filter type 0, one IDAT, zlib
default compression.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, payload: bytes) -> bytes:
    crc = zlib.crc32(tag + payload) & 0xFFFFFFFF
    return struct.pack(">I", len(payload)) + tag + payload + struct.pack(">I", crc)


def write_png16(path: str, data: np.ndarray) -> None:
    """Write (H, W) or (H, W, 3) uint16 data as a 16-bit PNG."""
    data = np.asarray(data)
    if data.dtype != np.uint16:
        raise TypeError(f"write_png16 requires uint16 data, got {data.dtype}")
    if data.ndim == 2:
        color_type = 0  # greyscale
        channels = 1
    elif data.ndim == 3 and data.shape[-1] == 3:
        color_type = 2  # truecolor
        channels = 3
    else:
        raise ValueError(f"cannot encode shape {data.shape} as PNG")
    h, w = data.shape[:2]
    ihdr = struct.pack(">IIBBBBB", w, h, 16, color_type, 0, 0, 0)
    raw = np.ascontiguousarray(data.astype(">u2")).tobytes()
    stride = w * channels * 2
    # prepend filter byte 0 to each scanline
    lines = bytearray()
    for y in range(h):
        lines.append(0)
        lines += raw[y * stride:(y + 1) * stride]
    idat = zlib.compress(bytes(lines), 6)
    with open(path, "wb") as fh:
        fh.write(_SIGNATURE)
        fh.write(_chunk(b"IHDR", ihdr))
        fh.write(_chunk(b"IDAT", idat))
        fh.write(_chunk(b"IEND", b""))
