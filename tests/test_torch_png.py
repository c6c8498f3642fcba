"""one2345_tpu_torch.utils.png against PIL: decode_png on files PIL writes
(modes L, LA, RGB, RGBA and P with transparency, PIL's adaptive filtering
mixing the five row filters; a 16-colour palette written at 4 bits), the
port's own RGB and RGBA files read back by PIL and by the port, and the
files the reader refuses."""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from one2345_tpu_torch.utils import png

SIZES = [(1, 1), (7, 13), (61, 48)]


def _image(h, w, seed=0):
    """Noise below, smooth gradients above: the gradients make PIL pick the
    Sub, Up, Average and Paeth filters, the noise filter type 0."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    yy, xx = np.mgrid[:h, :w]
    img[: h // 2] = ((xx[: h // 2, :, None] * 3 + yy[: h // 2, :, None] * 5) % 256).astype(np.uint8)
    return img


def _pil_bytes(im: Image.Image, **kwargs) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "PNG", **kwargs)
    return buf.getvalue()


def _filters(data: bytes) -> set:
    """The row filter types a PNG file uses (8-bit, not interlaced)."""
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, colour = header[:4]
    stride = (w * png.CHANNELS[colour] * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + stride)
    return set(raw[:, 0].tolist())


@pytest.mark.parametrize("shape", SIZES)
@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_decode_png_equals_pil(mode, shape):
    img = _image(*shape)
    if mode == "P":
        data = _pil_bytes(Image.fromarray(img[..., :3]).quantize(200), transparency=3)
        ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    else:
        arr = {"L": img[..., 0], "LA": img[..., :2], "RGB": img[..., :3], "RGBA": img}[mode]
        data = _pil_bytes(Image.fromarray(arr, mode))
        ref = np.asarray(Image.open(io.BytesIO(data)))
    out = png.decode_png(data)
    assert out.dtype == np.uint8
    assert np.array_equal(out.reshape(ref.shape), ref)
    rgba = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    assert np.array_equal(png.to_rgba(out), rgba)


def _filtered_png(img: np.ndarray) -> bytes:
    """An 8-bit RGBA PNG whose row y uses filter type y % 5, each filter
    applied by its definition (PNG specification, section 9)."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int64)
    rows = []
    for y in range(h):
        kind = y % 5
        up = x[y - 1] if y else np.zeros(w * c, np.int64)
        left = np.concatenate([np.zeros(c, np.int64), x[y, :-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        pred = [0, left, up, (left + up) >> 1, paeth][kind]
        rows.append(np.concatenate([[kind], (x[y] - pred) & 0xFF]).astype(np.uint8))
    header = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    return (png.SIGNATURE + png._chunk(b"IHDR", header)
            + png._chunk(b"IDAT", zlib.compress(np.concatenate(rows).tobytes()))
            + png._chunk(b"IEND", b""))


def test_every_row_filter_decodes():
    img = _image(23, 17, seed=5)
    data = _filtered_png(img)
    assert _filters(data) == {0, 1, 2, 3, 4}
    assert np.array_equal(png.decode_png(data), img)
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
    # PIL's own files: its adaptive filtering picks Sub, Up and Paeth
    assert _filters(_pil_bytes(Image.fromarray(_image(61, 48)[..., :3]))) >= {1, 2, 4}


def test_low_bit_palette_decodes():
    pal = Image.fromarray(_image(61, 48)[..., :3]).quantize(16)
    data = _pil_bytes(pal, transparency=1)
    assert data[24] == 4  # PIL writes a 16-colour palette at 4 bits
    assert np.array_equal(png.decode_png(data),
                          np.asarray(Image.open(io.BytesIO(data)).convert("RGBA")))


@pytest.mark.parametrize("channels", [3, 4])
def test_own_files_round_trip(tmp_path, channels):
    img = _image(33, 20, seed=channels)[..., :channels].copy()
    path = str(tmp_path / "x.png")
    png.write_png(path, img)
    with open(path, "rb") as f:
        data = f.read()
    # the encoder filters adaptively: the gradients take Sub, Up, Average or
    # Paeth, the noise None
    assert set(png.row_filters(data).tolist()) == _filters(data)
    assert len(_filters(data)) >= 3 and 0 in _filters(data)
    for kind in range(5):
        data = png.encode_png(img, filter_type=kind)
        assert _filters(data) == {kind} and np.array_equal(png.decode_png(data), img)
    with Image.open(path) as im:
        assert im.mode == ("RGB" if channels == 3 else "RGBA")
        assert np.array_equal(np.asarray(im), img)
    assert np.array_equal(png.read_png(path), img)


def test_interlaced_16_bit_and_oversized_files_raise():
    data16 = _pil_bytes(Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000))
    assert data16[24] == 16
    with pytest.raises(ValueError, match="16-bit"):
        png.decode_png(data16)
    data = bytearray(png.encode_png(_image(4, 4)[..., :3]))
    data[28] = 1  # IHDR interlace method, then repair the chunk's CRC
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])) & 0xFFFFFFFF)
    with pytest.raises(ValueError, match="interlaced"):
        png.decode_png(bytes(data))
    data[20] ^= 1  # a damaged chunk
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(bytes(data))
    header = struct.pack(">IIBBBBB", 20000, 20000, 8, 2, 0, 0, 0)  # 400M pixels, no IDAT
    with pytest.raises(ValueError, match="decompression bomb"):
        png.decode_png(png.SIGNATURE + png._chunk(b"IHDR", header) + png._chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="decompression bomb"):
        png.decode_png(png.encode_png(_image(4, 4)[..., :3]), max_pixels=15)


def test_short_image_data_and_unknown_filters_raise():
    img = _image(6, 5)
    header = png._chunk(b"IHDR", struct.pack(">IIBBBBB", 5, 6, 8, 6, 0, 0, 0))
    rows = np.concatenate([np.zeros((6, 1), np.uint8), img.reshape(6, 20)], axis=1)

    def file(scanlines):
        return (png.SIGNATURE + header + png._chunk(b"IDAT", zlib.compress(scanlines.tobytes()))
                + png._chunk(b"IEND", b""))

    assert np.array_equal(png.decode_png(file(rows)), img)
    with pytest.raises(ValueError, match="expected"):
        png.decode_png(file(rows[:5]))
    rows[3, 0] = 5
    with pytest.raises(ValueError, match="row 3: unknown filter type 5"):
        png.decode_png(file(rows))
