"""PNG codec (io.py): numpy + zlib, checked against PIL where PIL exists."""

import io as pyio
import struct
import zlib

import numpy as np
import pytest

from crossscalepatchmatch import io as cspm_io


def _image(shape, seed=0):
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    base = (xx * 0.7 + yy * 0.3)[..., None] + np.arange(
        shape[2] if len(shape) == 3 else 1) * 40
    noise = np.random.default_rng(seed).integers(0, 4, base.shape)
    img = ((base + noise) % 256).astype(np.uint8)
    return img if len(shape) == 3 else img[..., 0]


@pytest.mark.parametrize("kind", ["gray", "bgr"])
def test_png_roundtrip_and_pil_agreement(tmp_path, kind):
    path = str(tmp_path / "x.png")
    if kind == "gray":
        img = _image((37, 53))
        cspm_io.write_gray(path, img)
        np.testing.assert_array_equal(cspm_io.read_gray(path), img)
        np.testing.assert_array_equal(cspm_io.read_bgr(path),
                                      np.repeat(img[..., None], 3, -1))
    else:
        img = _image((41, 60, 3))
        cspm_io.write_bgr(path, img)
        np.testing.assert_array_equal(cspm_io.read_bgr(path), img)
    try:
        from PIL import Image
    except ImportError:
        return
    # PIL reads what the codec writes ...
    got = np.asarray(Image.open(path))
    want = img if kind == "gray" else img[..., ::-1]
    np.testing.assert_array_equal(got, want)
    # ... and the codec reads what PIL writes (PIL picks its own filters)
    buf = pyio.BytesIO()
    Image.fromarray(want).save(buf, format="PNG")
    np.testing.assert_array_equal(
        cspm_io.decode_png(buf.getvalue()).reshape(want.shape), want)


def _filter_row(row, prior, bpp, ftype):
    """Reference PNG filter (spec section 9) of one scanline."""
    raw = [int(v) for v in row]
    up = [int(v) for v in prior]
    out = []
    for i, x in enumerate(raw):
        a = raw[i - bpp] if i >= bpp else 0
        b = up[i]
        c = up[i - bpp] if i >= bpp else 0
        if ftype == 0:
            pred = 0
        elif ftype == 1:
            pred = a
        elif ftype == 2:
            pred = b
        elif ftype == 3:
            pred = (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out.append((x - pred) & 255)
    return bytes([ftype] + out)


def test_png_decodes_every_filter_type():
    """RGBA rows filtered with each of the five filter types in turn."""
    img = _image((10, 9, 4), seed=3)
    h, w, c = img.shape
    rows = img.reshape(h, w * c)
    prior = np.zeros(w * c, np.uint8)
    data = b""
    for y in range(h):
        data += _filter_row(rows[y], prior, c, y % 5)
        prior = rows[y]

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(data)) + chunk(b"IEND", b""))
    np.testing.assert_array_equal(cspm_io.decode_png(png), img)
    # RGBA reads as BGR with the alpha dropped
    bgr = cspm_io.decode_png(png)[..., 2::-1]
    np.testing.assert_array_equal(bgr, img[..., 2::-1])
