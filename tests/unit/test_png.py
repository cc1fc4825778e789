"""The stdlib PNG codec (data/png.py): round trips, OpenCV-written files,
every row filter, and rejection of formats TUM data never uses."""

import struct
import zlib

import numpy as np
import pytest

from rgbd_pose_estimation_tpu.data.png import (
    decode_png,
    encode_png,
    luma8,
    read_png,
    write_png,
)

_RNG = np.random.default_rng(0)
IMAGES = {
    "depth16": _RNG.integers(0, 65535, (37, 53)).astype(np.uint16),
    "gray8": _RNG.integers(0, 255, (37, 53)).astype(np.uint8),
    "rgb8": _RNG.integers(0, 255, (37, 53, 3)).astype(np.uint8),
}


def _png(hdr, rows_with_filters: bytes) -> bytes:
    """Hand-built PNG from an IHDR tuple and already-filtered row bytes."""

    def chunk(tag, data):
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", *hdr))
        + chunk(b"IDAT", zlib.compress(rows_with_filters))
        + chunk(b"IEND", b"")
    )


@pytest.mark.parametrize("kind", sorted(IMAGES))
def test_round_trip(tmp_path, kind):
    img = IMAGES[kind]
    path = str(tmp_path / "x.png")
    write_png(path, img)
    out = read_png(path)
    assert out.dtype == img.dtype
    np.testing.assert_array_equal(out, img)


@pytest.mark.parametrize("kind", sorted(IMAGES))
def test_reads_opencv_files(tmp_path, kind):
    cv2 = pytest.importorskip("cv2")
    img = IMAGES[kind]
    path = str(tmp_path / "cv.png")
    # OpenCV stores colour as BGR; the PNG on disk is RGB.
    cv2.imwrite(path, img[..., ::-1] if img.ndim == 3 else img)
    np.testing.assert_array_equal(read_png(path), img)
    # ...and OpenCV reads our files back identically.
    write_png(path, img)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(back[..., ::-1] if img.ndim == 3 else back, img)


def test_all_row_filters():
    """Rows filtered with None, Sub, Up, Average and Paeth decode exactly."""
    h, w, bpp = 10, 7, 3
    img = _RNG.integers(0, 255, (h, w * bpp)).astype(np.int64)
    raw = bytearray()
    prev = np.zeros(w * bpp, np.int64)
    for y in range(h):
        ftype = y % 5
        cur = img[y]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if ftype == 0:
            pred = np.zeros_like(cur)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        raw.append(ftype)
        raw.extend(((cur - pred) % 256).astype(np.uint8).tobytes())
        prev = cur
    out = decode_png(_png((w, h, 8, 2, 0, 0, 0), bytes(raw)))
    np.testing.assert_array_equal(out.reshape(h, -1), img)


@pytest.mark.parametrize(
    "hdr",
    [
        (4, 4, 8, 3, 0, 0, 0),  # palette
        (4, 4, 16, 2, 0, 0, 0),  # 16-bit colour
        (4, 4, 4, 0, 0, 0, 0),  # 4-bit gray
        (4, 4, 8, 0, 0, 0, 1),  # interlaced
        (4, 4, 8, 6, 0, 0, 0),  # RGBA
    ],
    ids=["palette", "rgb16", "gray4", "interlaced", "rgba"],
)
def test_rejects_unsupported(hdr):
    with pytest.raises(ValueError, match="unsupported"):
        decode_png(_png(hdr, b"\x00" * 64))


def test_rejects_non_png_and_bad_arrays():
    with pytest.raises(ValueError):
        decode_png(b"GIF89a" + b"\x00" * 32)
    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4), np.float32))


def test_luma_matches_native_formula():
    rgb = IMAGES["rgb8"].astype(np.int64)
    expect = (77 * rgb[..., 0] + 150 * rgb[..., 1] + 29 * rgb[..., 2]) >> 8
    np.testing.assert_array_equal(luma8(IMAGES["rgb8"]), expect)
    np.testing.assert_array_equal(luma8(IMAGES["gray8"]), IMAGES["gray8"])


@pytest.mark.parametrize("kind", ["depth16", "rgb8"])
def test_native_loader_falls_back_to_png_codec(tmp_path, monkeypatch, kind):
    """Without the native library the loader decodes with this codec, to
    the same values the native decoder produces."""
    from rgbd_pose_estimation_tpu.data import native_loader

    img = IMAGES[kind]
    path = str(tmp_path / "f.png")
    write_png(path, img)
    native = (
        native_loader.decode_depth16(path) if kind == "depth16"
        else native_loader.decode_gray8(path)
    ) if native_loader.native_available() else None
    monkeypatch.setattr(native_loader, "_load", lambda: None)
    if kind == "depth16":
        out = native_loader.decode_depth16(path)
        np.testing.assert_array_equal(out, img)
    else:
        out = native_loader.decode_gray8(path)
        np.testing.assert_array_equal(out, luma8(img))
    if native is not None:
        np.testing.assert_array_equal(out, native)
