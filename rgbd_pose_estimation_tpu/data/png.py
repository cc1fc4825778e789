"""PNG reader and writer for the TUM formats, on ``zlib`` and NumPy alone.

Supports what TUM RGB-D sequences hold: 16-bit grayscale depth, 8-bit
grayscale and 8-bit RGB. Anything else (palettes, alpha, bit depths below
8, 16-bit colour, interlacing) raises ``ValueError``. The writer filters
every row with PNG's "Sub" filter, which the reader undoes with one
cumulative sum; rows written by other encoders may use any of the five
filters.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type → channels: gray (8 or 16 bit) or RGB (8 bit).
_CHANNELS = {0: 1, 2: 3}


def _chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """PNG bytes of ``img``: uint8 (H, W) gray, uint8 (H, W, 3) RGB, or
    uint16 (H, W) gray."""
    img = np.asarray(img)
    if img.dtype == np.uint16 and img.ndim == 2:
        depth, ctype, data = 16, 0, img.astype(">u2")
    elif img.dtype == np.uint8 and img.ndim == 2:
        depth, ctype, data = 8, 0, img
    elif img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        depth, ctype, data = 8, 2, img
    else:
        raise ValueError(f"unsupported image {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    bpp = data.dtype.itemsize * (1 if data.ndim == 2 else data.shape[2])
    rows = np.ascontiguousarray(data).view(np.uint8).reshape(h, w * bpp)
    sub = rows.copy()
    sub[:, bpp:] -= rows[:, :-bpp]  # wraps mod 256, as the filter defines
    raw = np.concatenate([np.ones((h, 1), np.uint8), sub], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    return (
        _SIGNATURE
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
        + _chunk(b"IEND", b"")
    )


def write_png(path: str, img: np.ndarray) -> None:
    """Write ``img`` (see :func:`encode_png`) to ``path``."""
    with open(path, "wb") as f:
        f.write(encode_png(img))


def _paeth_or_average(line: bytes, prev: bytes, bpp: int, ftype: int) -> bytes:
    cur = bytearray(line)
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        if ftype == 3:
            pred = (a + b) >> 1
        else:
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return bytes(cur)


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        start = y * (stride + 1)
        ftype = raw[start]
        line = np.frombuffer(raw, np.uint8, stride, start + 1)
        if ftype == 0:
            cur = line
        elif ftype == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint64)
            cur = (cur & 0xFF).astype(np.uint8).reshape(-1)
        elif ftype == 2:
            cur = line + prev
        elif ftype in (3, 4):
            cur = np.frombuffer(
                _paeth_or_average(line.tobytes(), prev.tobytes(), bpp, ftype),
                np.uint8,
            )
        else:
            raise ValueError(f"corrupt PNG: row filter {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def decode_png(buf: bytes) -> np.ndarray:
    """Decode PNG bytes to uint8 (H, W) or (H, W, 3), or uint16 (H, W)."""
    if buf[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(buf):
        (n,) = struct.unpack(">I", buf[pos : pos + 4])
        tag = buf[pos + 4 : pos + 8]
        data = buf[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError("corrupt PNG: no IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if interlace or ctype not in _CHANNELS or depth not in (8, 16) or (
        depth == 16 and ctype != 0
    ):
        raise ValueError(
            f"unsupported PNG: colour type {ctype}, bit depth {depth}, "
            f"interlace {interlace}"
        )
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, w)
    return rows.reshape(h, w, ch) if ch > 1 else rows.reshape(h, w)


def read_png(path: str) -> np.ndarray:
    """Read the PNG at ``path`` (see :func:`decode_png`)."""
    with open(path, "rb") as f:
        return decode_png(f.read())


def luma8(img: np.ndarray) -> np.ndarray:
    """8-bit luma of a decoded 8-bit PNG: gray as is, RGB by the integer
    BT.601 weights the native decoder uses."""
    if img.dtype != np.uint8:
        raise ValueError(f"not an 8-bit image: {img.dtype}")
    if img.ndim == 2:
        return img
    rgb = img.astype(np.uint32)
    return ((77 * rgb[..., 0] + 150 * rgb[..., 1] + 29 * rgb[..., 2]) >> 8).astype(
        np.uint8
    )
