"""Image I/O: PNG read/write of views and uint8 disparity maps.

Replaces the reference's OpenCV imread/imwrite (main.cc:68-69,131-134).
OpenCV loads color images as BGR, so loads are returned as BGR to keep the
engine's channel convention identical to the reference (the engine only
consumes channel sums/diffs, but golden files stay comparable).

The codec is numpy + zlib and covers what the reference reads and writes:
8-bit, non-interlaced gray, gray+alpha, RGB and RGBA PNGs, with every
scanline filter on read.  Writes use filter 0 (none).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG color type -> channels (8-bit samples)
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}


def _chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def encode_png(img_u8: np.ndarray) -> bytes:
    """u8[H, W] gray or u8[H, W, C] (C in 1..4) -> PNG bytes, channels in
    file order (gray, gray+alpha, RGB, RGBA)."""
    img = np.asarray(img_u8, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    ctype = {v: k for k, v in _CHANNELS.items()}[c]
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, w * c)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters (PNG spec section 9)."""
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.int32)
    for y in range(h):
        row = data[y * (stride + 1):(y + 1) * (stride + 1)]
        ftype = row[0]
        cur = np.frombuffer(row, np.uint8, offset=1).astype(np.int32)
        if ftype == 0:
            rec = cur
        elif ftype == 1:        # Sub: running sum along each channel
            rec = np.cumsum(cur.reshape(-1, bpp), axis=0).reshape(-1) & 255
        elif ftype == 2:        # Up
            rec = (cur + prior) & 255
        elif ftype in (3, 4):   # Average, Paeth: left-to-right recurrences
            rec = cur.tolist()
            up = prior.tolist()
            for i in range(stride):
                a = rec[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                rec[i] = (rec[i] + pred) & 255
            rec = np.asarray(rec, np.int32)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = rec
        prior = rec
    return out


def decode_png(buf: bytes) -> np.ndarray:
    """PNG bytes -> u8[H, W, C] in file channel order."""
    if buf[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(buf):
        (n,) = struct.unpack(">I", buf[pos:pos + 4])
        tag = buf[pos + 4:pos + 8]
        data = buf[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or interlace != 0 or ctype not in _CHANNELS:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, color type {ctype}, "
            f"interlace {interlace}); 8-bit non-interlaced gray/RGB/RGBA "
            f"only")
    c = _CHANNELS[ctype]
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w * c, c)
    return rows.reshape(h, w, c)


def read_bgr(path: str) -> np.ndarray:
    """u8[H, W, 3] BGR image (gray is replicated, alpha dropped)."""
    with open(path, "rb") as f:
        img = decode_png(f.read())
    if img.shape[-1] <= 2:
        img = np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., 2::-1])


def read_gray(path: str) -> np.ndarray:
    """u8[H, W] of a gray PNG (e.g. a written disparity map)."""
    with open(path, "rb") as f:
        img = decode_png(f.read())
    if img.shape[-1] != 1:
        raise ValueError(f"{path} is not a gray PNG")
    return img[..., 0]


def write_gray(path: str, img_u8: np.ndarray) -> None:
    """Write a u8[H, W] (e.g. scaled disparity) map as 8-bit PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(np.asarray(img_u8, np.uint8)))


def write_bgr(path: str, img_u8: np.ndarray) -> None:
    """Write a u8[H, W, 3] BGR image as an RGB PNG."""
    write_rgb(path, np.asarray(img_u8, np.uint8)[..., ::-1])


def write_rgb(path: str, img_u8: np.ndarray) -> None:
    """Write a u8[H, W, 3] RGB image as an RGB PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(np.asarray(img_u8, np.uint8)))
