"""8-bit RGB PNG files from ``zlib`` and ``struct`` (no PIL).

The JAX package writes the pipeline's artifact images with PIL; the port
writes the same pixels with ``write_png``: one IHDR (8-bit, colour type 2,
not interlaced), one IDAT of zlib-compressed rows, each row with filter
type 0, and an IEND.  ``read_png`` reads back what ``write_png`` writes
(filter type 0 only).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(
        ">I", zlib.crc32(kind + data) & 0xFFFFFFFF
    )


def encode_png(rgb: np.ndarray) -> bytes:
    """[H, W, 3] uint8 -> the bytes of a PNG file."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_png takes [H, W, 3] uint8, got {rgb.dtype} {rgb.shape}")
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        SIGNATURE
        + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )


def write_png(path: str, rgb: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(rgb))


def read_png(path: str) -> np.ndarray:
    """A file ``write_png`` wrote -> [H, W, 3] uint8; checks every chunk's
    CRC and raises on anything else (other colour types, bit depths,
    interlacing or row filters)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, size = len(SIGNATURE), [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in chunk {kind!r}")
        if kind == b"IHDR":
            w, h, depth, colour, _, _, interlace = struct.unpack(">IIBBBBB", body)
            if (depth, colour, interlace) != (8, 2, 0):
                raise ValueError(f"{path}: only 8-bit RGB, not interlaced, is read")
            size = (h, w)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    h, w = size
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: only row filter type 0 is read")
    return rows[:, 1:].reshape(h, w, 3).copy()
