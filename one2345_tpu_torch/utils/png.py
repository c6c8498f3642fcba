"""PNG files from ``zlib`` and ``struct`` (no PIL).

The JAX package reads and writes images with PIL; the card's machine has
none, so the port carries its own codec:

- ``encode_png`` / ``write_png``: 8-bit RGB or RGBA, one IHDR (colour type
  2 or 6, not interlaced), one IDAT of zlib-compressed rows, each row
  filtered as libpng's default heuristic does (of the five filters, the
  one whose bytes, read as signed, have the least sum of magnitudes) or
  all under one given filter, and an IEND;
- ``decode_png`` / ``read_png``: any non-interlaced PNG of bit depth 8 (or
  1, 2, 4 for gray and palette images): colour types 0 (gray), 2 (RGB), 3
  (palette; ``tRNS`` gives an alpha channel), 4 (gray + alpha) and 6
  (RGBA), all five row filters (undone by the host C++ of
  ``native/png_unfilter.cpp``), every chunk's CRC checked.  Returns
  [H, W, C] uint8 with C = 1, 2, 3 or 4 as the file holds; a palette image
  comes back RGB, or RGBA when it has a ``tRNS`` chunk.  Interlaced and
  16-bit files raise, and so do images of more than ``max_pixels`` pixels
  (by default PIL's limit) and image data that inflates past its size;
- ``row_filters``: the filter type of each row of a file;
- ``to_rgba``: any of those arrays -> [H, W, 4], as PIL's
  ``convert("RGBA")`` does (gray replicated, alpha 255 where absent).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel
COLOUR_TYPE = {3: 2, 4: 6}  # channels -> colour type of what encode_png writes
MAX_PIXELS = 2 * 89_478_485  # PIL's DecompressionBombError limit


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(
        ">I", zlib.crc32(kind + data) & 0xFFFFFFFF
    )


def _filter_rows(x: np.ndarray, bpp: int, filter_type: int | None) -> np.ndarray:
    """[h, stride] uint8 rows -> [h, 1 + stride] filtered scanlines, each
    row under ``filter_type``, or when it is None under the filter of least
    sum of |signed byte|, the lowest type on a tie."""
    x = x.astype(np.int16)
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    upleft = np.zeros_like(x)
    upleft[1:, bpp:] = x[:-1, :-bpp]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    filtered = (np.stack([x, x - left, x - up, x - ((left + up) >> 1), x - paeth]) & 0xFF)
    filtered = filtered.astype(np.uint8)
    if filter_type is None:
        kind = np.abs(filtered.view(np.int8).astype(np.int32)).sum(-1).argmin(0)
    else:
        kind = np.full(len(x), filter_type)
    rows = filtered[kind, np.arange(len(x))]
    return np.concatenate([kind.astype(np.uint8)[:, None], rows], axis=1)


def encode_png(image: np.ndarray, filter_type: int | None = None) -> bytes:
    """[H, W, 3] (RGB) or [H, W, 4] (RGBA) uint8 -> the bytes of a PNG file;
    ``filter_type`` 0-4 filters every row with that filter, None adaptively."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] not in COLOUR_TYPE:
        raise ValueError(f"encode_png takes [H, W, 3 or 4] uint8, got {image.dtype} {image.shape}")
    h, w, c = image.shape
    rows = _filter_rows(image.reshape(h, w * c), c, filter_type)
    header = struct.pack(">IIBBBBB", w, h, 8, COLOUR_TYPE[c], 0, 0, 0)
    return (
        SIGNATURE
        + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )


def write_png(path: str, image: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image))


def _scanlines(data: bytes, max_pixels: int):
    """Parse a PNG file: (IHDR fields, PLTE or None, tRNS or None, the
    inflated [h, 1 + stride] filtered scanlines, bytes per pixel)."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file")
    pos, idat, header, palette, trns = len(SIGNATURE), [], None, None, None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"bad CRC in chunk {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError("no IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if w * h > max_pixels:
        raise ValueError(f"{w}x{h} pixels: more than {max_pixels} (a decompression bomb?)")
    if interlace:
        raise ValueError("interlaced PNG files are not read")
    if colour not in CHANNELS:
        raise ValueError(f"unknown colour type {colour}")
    if depth == 16:
        raise ValueError("16-bit PNG files are not read")
    if depth != 8 and colour not in (0, 3):
        raise ValueError(f"bit depth {depth} with colour type {colour}")
    c = CHANNELS[colour]
    stride = (w * c * depth + 7) // 8
    need = h * (1 + stride)
    # inflate no more than the image holds: a small stream cannot blow up memory
    raw = zlib.decompressobj().decompress(b"".join(idat), need)
    if len(raw) < need:
        raise ValueError(f"image data holds {len(raw)} bytes, {need} expected")
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + stride)
    return header, palette, trns, rows, max(1, c * depth // 8)


def row_filters(data: bytes, max_pixels: int = MAX_PIXELS) -> np.ndarray:
    """The filter type (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth) of each
    row of a PNG file, as [H] uint8."""
    return _scanlines(data, max_pixels)[3][:, 0].copy()


def decode_png(data: bytes, max_pixels: int = MAX_PIXELS) -> np.ndarray:
    """The bytes of a PNG file -> [H, W, C] uint8 (see the module docstring)."""
    from one2345_tpu_torch.native.build import png_unfilter_native

    (w, h, depth, colour, _, _, _), palette, trns, scanlines, bpp = _scanlines(data, max_pixels)
    rows = png_unfilter_native(scanlines, bpp)
    if depth < 8:
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)[:, :w]
        samples = (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(-1)
        if colour == 0:  # scale gray to 8 bits, as PIL's "L" does
            samples = samples * (255 // ((1 << depth) - 1))
        img = samples.astype(np.uint8)[..., None]
    else:
        img = rows.reshape(h, w, CHANNELS[colour])
    if colour == 3:
        if palette is None:
            raise ValueError("palette image without a PLTE chunk")
        index = img[..., 0]
        rgb = palette[np.minimum(index, len(palette) - 1)]
        if trns is None:
            return rgb
        alpha = np.full(256, 255, np.uint8)
        alpha[: len(trns)] = np.frombuffer(trns, np.uint8)
        return np.concatenate([rgb, alpha[index][..., None]], axis=-1)
    return np.ascontiguousarray(img)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def to_rgba(image: np.ndarray) -> np.ndarray:
    """[H, W, C] uint8 with C = 1 (gray), 2 (gray + alpha), 3 or 4 ->
    [H, W, 4] (PIL ``convert("RGBA")``)."""
    c = image.shape[2]
    rgb = np.repeat(image[..., :1], 3, axis=2) if c <= 2 else image[..., :3]
    alpha = image[..., -1:] if c in (2, 4) else np.full(image.shape[:2] + (1,), 255, np.uint8)
    return np.concatenate([rgb, alpha], axis=2)
