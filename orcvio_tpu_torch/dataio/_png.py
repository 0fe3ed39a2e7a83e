"""8-bit grayscale PNG encoder and decoder with zlib from the standard library.

The JAX package writes and reads the dataset's frames with ``cv2.imwrite``
and ``cv2.imread``; the port does not depend on OpenCV, so it keeps this
small codec. The encoder writes every row with the Sub filter (a
difference along the row, which numpy undoes with one cumulative sum over
all rows). The decoder reads any 8-bit grayscale, non-interlaced PNG,
whatever filter each row uses (libpng picks one per row): None, Sub and
Up are vectorised, Average and Paeth run along the row.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_gray8(img: np.ndarray, level: int = 1) -> bytes:
    """PNG bytes of a (H, W) uint8 image, every row Sub-filtered."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 2:
        raise ValueError(f"expected a (H, W) image, got {img.shape}")
    H, W = img.shape
    rows = np.empty((H, W + 1), np.uint8)
    rows[:, 0] = 1  # Sub
    rows[:, 1] = img[:, 0]
    rows[:, 2:] = img[:, 1:] - img[:, :-1]  # wraps mod 256, as PNG wants
    ihdr = struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_gray8(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_gray8(img))


def _unfilter_avg(line, prior):
    out = list(line)
    for x in range(len(out)):
        left = out[x - 1] if x else 0
        out[x] = (out[x] + ((left + prior[x]) >> 1)) & 0xFF
    return out


def _unfilter_paeth(line, prior):
    out = list(line)
    for x in range(len(out)):
        a = out[x - 1] if x else 0
        b = prior[x]
        c = prior[x - 1] if x else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[x] = (out[x] + pred) & 0xFF
    return out


def decode_gray8(data: bytes) -> np.ndarray:
    """(H, W) uint8 image of an 8-bit grayscale PNG."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    W, H, depth, color, _, _, interlace = header
    if depth != 8 or color != 0 or interlace:
        raise NotImplementedError(
            f"PNG bit depth {depth}, colour type {color}, interlace "
            f"{interlace}: only 8-bit grayscale, non-interlaced is read")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[:H * (W + 1)].reshape(H, W + 1)
    filters, rows = raw[:, 0], raw[:, 1:]
    out = np.empty((H, W), np.uint8)
    sub = filters == 1
    out[sub] = np.cumsum(rows[sub], axis=1, dtype=np.uint8)
    out[filters == 0] = rows[filters == 0]
    prior = np.zeros(W, np.uint8)
    for y in range(H):
        f = filters[y]
        if f == 2:
            out[y] = rows[y] + prior
        elif f == 3:
            out[y] = _unfilter_avg(rows[y].tolist(), prior.tolist())
        elif f == 4:
            out[y] = _unfilter_paeth(rows[y].tolist(), prior.tolist())
        elif f > 4:
            raise ValueError(f"PNG row {y}: unknown filter {f}")
        prior = out[y]
    return out


def read_gray8(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_gray8(f.read())
